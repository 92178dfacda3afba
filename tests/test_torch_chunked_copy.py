"""The port's chunked-copy kernels package against the JAX reference.

The same inputs, drawn with numpy from a seed, go through
``repro.kernels.chunked_copy`` (Pallas interpret mode and the jnp arm)
and through ``repro_torch.kernels.chunked_copy`` on the CPU, where the
port takes its plain PyTorch versions.  Everything is a byte copy, so
every comparison is exact.  The CUDA kernels themselves run only on a
card: their tests are in ``test_torch_on_card.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.chunked_copy import HAS_PALLAS_TPU  # noqa: E402
from repro.kernels.chunked_copy import ops as jops  # noqa: E402
from repro.kernels.chunked_copy import pipeline as jpipe  # noqa: E402
from repro_torch.kernels.chunked_copy import kernel as K  # noqa: E402
from repro_torch.kernels.chunked_copy import ops  # noqa: E402
from repro_torch.kernels.chunked_copy import pipeline as tpipe  # noqa: E402
from repro_torch.kernels.chunked_copy.ref import (  # noqa: E402
    gather_chunks_ref,
    scatter_chunks_ref,
)

PALLAS_ARMS = [False] + ([True] if HAS_PALLAS_TPU else [])
DTYPES = ["float32", "bfloat16", "int8", "uint8"]


def _draw(rng, shape, dtype: str) -> np.ndarray:
    if dtype in ("float32", "bfloat16"):
        x = rng.standard_normal(shape).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    return rng.integers(lo, hi, shape).astype(dtype)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:      # through a 16-bit view
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy() if x.dtype != torch.uint8 \
            else x.numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.uint8)


@pytest.mark.parametrize("use_pallas", PALLAS_ARMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_match_reference(dtype, use_pallas):
    """gather/scatter plain versions are byte-equal to the reference
    ops on both of its arms, with out-of-order ids."""
    rng = np.random.default_rng(2 * DTYPES.index(dtype) + use_pallas)
    n, m, c = 16, 6, 128 if dtype != "bfloat16" else 256
    src = _draw(rng, (n, c), dtype)
    new = _draw(rng, (m, c), dtype)
    dst = _draw(rng, (n, c), dtype)
    ids = rng.permutation(n)[:m].astype(np.int32)
    tid = torch.from_numpy(ids.astype(np.int64))

    want = jops.gather(jnp.asarray(src), jnp.asarray(ids),
                       use_pallas=use_pallas)
    got = gather_chunks_ref(_to_torch(src), tid)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))

    want = jops.scatter(jnp.asarray(dst), jnp.asarray(new),
                        jnp.asarray(ids), use_pallas=use_pallas)
    tdst = _to_torch(dst)
    got = scatter_chunks_ref(tdst, _to_torch(new), tid)
    assert got is tdst                      # in place
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_cpu_take_plain_version(dtype):
    """On a CPU tensor ops.gather/scatter are the plain versions."""
    rng = np.random.default_rng(7)
    src = _to_torch(_draw(rng, (12, 128), dtype))
    dst = _to_torch(_draw(rng, (12, 128), dtype))
    ids = [9, 2, 11, 0]
    before = K.gather_chunks.launches, K.scatter_chunks.launches
    g = ops.gather(src, ids)
    np.testing.assert_array_equal(_bytes(g), _bytes(src[ids]))
    want = dst.clone()
    want[ids] = g
    assert ops.scatter(dst, g, np.asarray(ids, np.int32)) is dst
    np.testing.assert_array_equal(_bytes(dst), _bytes(want))
    # the CUDA wrappers were not involved
    assert (K.gather_chunks.launches, K.scatter_chunks.launches) == before


def test_empty_id_list():
    src = torch.arange(24, dtype=torch.uint8).view(4, 6)
    assert ops.gather(src, []).shape == (0, 6)
    dst = src.clone()
    ops.scatter(dst, torch.empty((0, 6), dtype=torch.uint8), [])
    assert torch.equal(dst, src)


def test_ids_checked_on_host():
    src = torch.zeros((8, 4), dtype=torch.uint8)
    with pytest.raises(IndexError):
        ops.gather(src, [0, 8])
    with pytest.raises(IndexError):
        ops.gather(src, [-1])
    with pytest.raises(ValueError):
        ops.scatter(src, torch.zeros((2, 4), dtype=torch.uint8), [3, 3])
    with pytest.raises(TypeError):
        ops.gather(src, np.array([0.5]))
    # host_ids hands the kernel contiguous int32
    ids = K.host_ids(torch.tensor([5, 1, 3]), 8, unique=True)
    assert ids.dtype == np.int32 and ids.flags.c_contiguous
    assert ids.tolist() == [5, 1, 3]


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel wrapper, which raises for
    anything that is not CUDA — there is no silent plain-version arm."""
    src = torch.empty((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather(src, [0])
    with pytest.raises(ValueError, match="CUDA"):
        ops.scatter(src, torch.empty((1, 8), dtype=torch.uint8,
                                     device="meta"), [0])


def test_library_is_keyed_by_source():
    path = K.library_path()
    assert path.parent == K.BUILD_DIR
    assert path.name.startswith("chunked_copy-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in K.NVCC_FLAGS


@pytest.mark.parametrize("copy_fn", ["copy_slabs_sequential",
                                     "copy_slabs_pipelined"])
def test_copy_slabs_match_reference(copy_fn):
    """Both pipeline arms move the reference's bytes and report the
    reference's landed counts: [5, 7] for 7 chunks at batch 5."""
    rng = np.random.default_rng(13)
    src = rng.integers(0, 256, (9, 128), dtype=np.uint8)
    sidx = list(range(7))
    didx = [8, 6, 4, 2, 0, 1, 3]
    kw = "on_chunk" if copy_fn == "copy_slabs_sequential" else "on_batch"
    jev, tev = [], []
    want = getattr(jpipe, copy_fn)(jnp.asarray(src), sidx,
                                   jnp.zeros((9, 128), jnp.uint8), didx,
                                   **{kw: jev.append})
    tdst = torch.zeros((9, 128), dtype=torch.uint8)
    got = getattr(tpipe, copy_fn)(torch.from_numpy(src), sidx, tdst, didx,
                                  **{kw: tev.append})
    assert got is tdst
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tev == jev
    if copy_fn == "copy_slabs_pipelined":
        assert tev == [5, 7]


def test_cuda_tensor_launches_the_kernel(monkeypatch):
    """A CUDA tensor goes to the kernel: ops builds the ids and calls the
    library, never the plain version.  The library is a stand-in that
    records its calls, since there is no card here."""
    calls = []

    class Lib:
        def cc_gather_chunks(self, *args):
            calls.append(("gather", args[2:5]))
            return 0

        def cc_scatter_chunks(self, *args):
            calls.append(("scatter", args[2:5]))
            return 1          # a refused launch must raise

    monkeypatch.setattr(K, "load_library", Lib)
    monkeypatch.setattr(K, "_rows", lambda t, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    src = torch.zeros((8, 16), dtype=torch.float32)
    before = K.gather_chunks.launches
    out = K.gather_chunks(src, [7, 2])
    assert out.shape == (2, 16) and K.gather_chunks.launches == before + 1
    assert calls[0][0] == "gather" and calls[0][1][1:] == (2, 64)
    with pytest.raises(RuntimeError, match="scatter_chunks"):
        K.scatter_chunks(src, out, [1, 3])


def test_pool_to_host_and_back_match_reference():
    rng = np.random.default_rng(17)
    pool = rng.integers(0, 256, (10, 64), dtype=np.uint8)
    rows = [7, 1, 9, 3, 0, 5, 2]
    jout, jev, tev = np.zeros((7, 64), np.uint8), [], []
    jpipe.pool_to_host(jnp.asarray(pool), rows, jout, on_batch=jev.append)
    tout = torch.zeros((7, 64), dtype=torch.uint8)
    tpipe.pool_to_host(torch.from_numpy(pool), rows, tout,
                       on_batch=tev.append)
    np.testing.assert_array_equal(tout.numpy(), jout)
    assert tev == jev == [5, 7]

    didx = [4, 8, 0, 6, 2, 9, 1]
    jev, tev = [], []
    jback = jpipe.host_to_pool(jout, jnp.zeros((10, 64), jnp.uint8), didx,
                               on_batch=jev.append)
    tback = tpipe.host_to_pool(tout, torch.zeros((10, 64), dtype=torch.uint8),
                               didx, on_batch=tev.append)
    np.testing.assert_array_equal(tback.numpy(), np.asarray(jback))
    assert tev == jev == [5, 7]

