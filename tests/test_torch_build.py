"""The port's kernel builder on the CPU: how it keys libraries, and what it
does without ``nvcc`` or after a failed launch."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402


def test_library_path_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    base = _build.library_path(FK.SOURCE)
    assert base == _build.library_path(FK.SOURCE)
    assert base.parent == _build.BUILD_DIR
    assert base.name.startswith("flash_attention-")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k.cu")
    src.write_text("// two\n")
    assert _build.library_path("k.cu") != first
    src.write_text("// one\n")
    assert _build.library_path("k.cu") == first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("k.cu") != first


def test_library_path_is_keyed_by_the_headers_a_source_includes(tmp_path,
                                                                monkeypatch):
    """An edit to a ``csrc/*.cuh`` header that a source includes builds
    that source anew; a header it does not include leaves it alone."""
    assert _build._headers((_build.CSRC / FK.BWD_SOURCE).read_text()) == [
        _build.CSRC / "hopper.cuh"]
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// one\n")
    (tmp_path / "b.cuh").write_text("// one\n")
    first = _build.library_path("k.cu")
    (tmp_path / "b.cuh").write_text("// two\n")
    assert _build.library_path("k.cu") == first
    (tmp_path / "a.cuh").write_text("// two\n")
    assert _build.library_path("k.cu") != first


def test_build_without_nvcc_raises_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(FK.SOURCE)
    assert list((tmp_path / "kernels").iterdir()) == []


def test_check_raises_on_a_cuda_error():
    _build.check(0, "flash_attention")
    with pytest.raises(RuntimeError, match="flash_attention: .* error 700"):
        _build.check(700, "flash_attention")


def test_flash_wrapper_rejects_cpu_tensors_before_building():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FK.flash_attention(q, q, q)


def test_flash_bwd_wrapper_rejects_cpu_tensors_before_building():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    stats = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        FK.flash_attention_bwd(q, q, q, q, stats)


@pytest.mark.parametrize("source,signatures", [
    (FK.SOURCE, FK._SIGNATURES), (FK.BWD_SOURCE, FK._BWD_SIGNATURES),
    (DK.SOURCE, DK._SIGNATURES)])
def test_ctypes_signatures_match_the_sources(source, signatures):
    """Each entry point's ctypes argument list has the C function's
    length, pointers where the C side takes pointers: a short list would
    pass the stream as an int on the card."""
    import ctypes
    import re
    text = (_build.CSRC / source).read_text()
    for name, argtypes in signatures:
        params = re.search(rf"int {name}\(([^)]*)\)", text).group(1)
        c_args = [a.strip() for a in params.split(",")]
        assert len(c_args) == len(argtypes), name
        for c_arg, t in zip(c_args, argtypes):
            assert ("*" in c_arg) == (t is ctypes.c_void_p), (name, c_arg)
