"""The port on an NVIDIA GPU: the hand-written CUDA kernels against their
plain versions, the CUDA backend against the same backend on the CPU,
and the serving engine on the card against the same engine on the CPU.

Every test needs a card and ``nvcc``, carries the ``cuda`` marker and
skips without one.  The file imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch, without the repo's
conftest (which imports jax):

    PYTHONPATH=src python -m pytest -q --noconftest -o markers=cuda -m cuda tests/test_torch_on_card.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _flashcases import BWD_CASES  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.backend_torch import (  # noqa: E402
    TorchBackend,
    nbytes_of,
    synth_payload,
)
from repro_torch.core.linksim import LinkSim  # noqa: E402
from repro_torch.core.pathfinder import PathFinder  # noqa: E402
from repro_torch.core.pinned_buffer import CircularPinnedBuffer  # noqa: E402
from repro_torch.core.transfer import (  # noqa: E402
    CUT_THROUGH,
    STORE_FORWARD,
    TransferEngine,
)
from repro_torch.kernels.chunked_copy import kernel as K  # noqa: E402
from repro_torch.kernels.chunked_copy import pipeline as tpipe  # noqa: E402
from repro_torch.kernels.chunked_copy.ref import (  # noqa: E402
    gather_chunks_ref,
    scatter_chunks_ref,
)

DTYPES = [torch.float32, torch.bfloat16, torch.int8, torch.uint8]

# the reference conformance MATRIX (tests/test_backend_jax.py) on the
# port's topologies: case -> (topo builder, kind, src, dst, engine kwargs)
MATRIX = {
    "h2g": (ttopo.dgx_v100, "h2g", "host", "gpu1", {}),
    "g2h": (ttopo.dgx_v100, "g2h", "gpu1", "host", {}),
    "g2g_direct": (ttopo.dgx_v100, "g2g", "gpu0", "gpu1", {"g2g": "direct"}),
    "g2g_striped": (ttopo.dgx_v100, "g2g", "gpu0", "gpu5",
                    {"g2g": "multipath"}),
    "g2g_host": (ttopo.dgx_v100, "g2g", "gpu0", "gpu4", {"g2g": "host"}),
    "internode": (lambda: ttopo.cluster(2), "internode", "n0:gpu0",
                  "n1:gpu1", {}),
    "spill": (ttopo.dgx_v100, "spill", "gpu1", "host", {}),
    "reload": (ttopo.dgx_v100, "reload", "host", "gpu3", {}),
    "h2h": (lambda: ttopo.cluster(2), "h2h", "n0:host", "n1:host", {}),
}
SIZE_MB = 23.0          # 12 chunks, ragged 1 MB tail, 3 trigger batches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(n, c, dtype, gen):
    if dtype.is_floating_point:
        return torch.randn((n, c), generator=gen).to(dtype)
    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
    return torch.randint(lo, hi, (n, c), generator=gen).to(dtype)


def _same_bytes(a, b) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8).cpu(),
        b.contiguous().view(torch.uint8).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain_on_card(cuda_device, dtype):
    gen = torch.Generator().manual_seed(23)
    rng = np.random.default_rng(23)
    for n, c, m in ((96, 128, 5), (96, 256, 64), (32, 100, 7), (16, 64, 0)):
        src = _rows(n, c, dtype, gen).to(cuda_device)
        ids = rng.permutation(n)[:m].astype(np.int32)      # out of order
        idx = torch.from_numpy(ids.astype(np.int64)).to(cuda_device)
        got = K.gather_chunks(src, ids)
        assert _same_bytes(got, gather_chunks_ref(src, idx))
        dst = _rows(n, c, dtype, gen).to(cuda_device)
        want = scatter_chunks_ref(dst.clone(), got, idx)
        assert K.scatter_chunks(dst, got, ids) is dst
        assert _same_bytes(dst, want)


@pytest.mark.cuda
def test_pipelined_copy_on_card(cuda_device):
    src = torch.randint(0, 256, (9, 2 ** 21), dtype=torch.uint8,
                        device=cuda_device)
    dst = torch.zeros_like(src)
    events = []
    before = K.gather_chunks.launches, K.scatter_chunks.launches
    tpipe.copy_slabs_pipelined(src, list(range(7)), dst,
                               [8, 6, 4, 2, 0, 1, 3], on_batch=events.append)
    assert events == [5, 7]
    assert (K.gather_chunks.launches, K.scatter_chunks.launches) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(dst[[8, 6, 4, 2, 0, 1, 3]], src[:7])


@pytest.mark.cuda
@pytest.mark.parametrize("staging", [CUT_THROUGH, STORE_FORWARD])
@pytest.mark.parametrize("case", sorted(MATRIX))
def test_backend_on_card_matches_cpu(cuda_device, case, staging):
    """Each plan kind moves the same bytes on the card as on the CPU and
    reports the same chunks, batches, stripes, staging, hops and
    progress; device stores sit on the card, host stores are pinned."""
    topo_fn, kind, src, dst, kw = MATRIX[case]
    did = f"{case}-{staging}"
    reps = []
    for device in ("cuda", "cpu"):
        topo = topo_fn()
        eng = TransferEngine(LinkSim(topo), PathFinder(topo),
                             CircularPinnedBuffer(), topo, staging=staging,
                             **kw)
        be = TorchBackend(device=device)
        rep = be.execute(eng.compile(kind, "t", src, dst, SIZE_MB,
                                     data_id=did))
        for ep in (src, dst):
            np.testing.assert_array_equal(
                be.read_object(did, ep), synth_payload(did, nbytes_of(SIZE_MB)))
        reps.append(rep)
        if device == "cuda":
            for st in be.stores.values():
                assert st.slabs.is_cuda if st.device else st.slabs.is_pinned()
            assert all(r.buf.is_pinned() for r in be.rings.values())
    card, cpu = reps
    for f in ("n_chunks", "n_batches", "stripes", "peak_staging_mb",
              "hop_trace"):
        assert getattr(card, f) == getattr(cpu, f), f
    assert [mb for mb, _ in card.events] == [mb for mb, _ in cpu.events]


UPLOAD_MB = 128.0       # 64 chunks, 13 trigger batches


def upload_report(device: str, data_id: str):
    """One cut-through host -> gpu1 transfer of ``UPLOAD_MB`` on a fresh
    backend (the object put at the host first): the backend and its
    ``ExecReport``."""
    topo = ttopo.dgx_v100()
    eng = TransferEngine(LinkSim(topo), PathFinder(topo),
                         CircularPinnedBuffer(), topo, staging=CUT_THROUGH)
    be = TorchBackend(device=device)
    be.put_object(data_id, "host", size_mb=UPLOAD_MB)
    return be, be.execute(eng.compile("h2g", "t", "host", "gpu1",
                                      UPLOAD_MB, data_id=data_id))


_PROFILE_UPLOAD = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from test_torch_on_card import UPLOAD_MB, upload_report
from repro_torch.core.backend_torch import nbytes_of, synth_payload
from repro_torch.kernels.chunked_copy import kernel as K
K.load_library()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    be, rep = upload_report("cuda", "upload")
    torch.cuda.synchronize()
prof.export_chrome_trace(sys.argv[2])
ev = [e for e in json.load(open(sys.argv[2]))["traceEvents"]
      if e.get("ph") == "X"]
print(json.dumps({
    "same": bool((be.read_object("upload", "gpu1")
                  == synth_payload("upload", nbytes_of(UPLOAD_MB))).all()),
    "pinned": be.stores["host"].slabs.is_pinned(),
    "ring_written": bool(be.rings["host"].buf.any()),
    "scatters": K.scatter_chunks.launches,
    "report": {f: getattr(rep, f) for f in (
        "n_batches", "direct_batches", "peak_staging_mb", "hop_trace")},
    "events_mb": [mb for mb, _ in rep.events],
    "memcpy": sorted({e["name"] for e in ev
                      if e.get("cat") == "gpu_memcpy"}),
    "ft": sorted({e["name"] for e in ev if e.get("cat") == "user_annotation"
                  and e["name"].startswith("ft:")})}))
"""


@pytest.mark.cuda
def test_page_locked_upload_reads_the_host_store_in_place(cuda_device,
                                                          tmp_path):
    """A 128 MB cut-through host -> card transfer: the host store is
    page-locked and one run, so every trigger batch's DMA reads it in
    place (``direct_batches == n_batches``), the ring window stays
    unwritten, every batch still lands through the scatter kernel, the
    bytes are the oracle's, and the report's in-place batches, staging,
    hops and progress equal the CPU backend's, which walks the same
    path.  Under the profiler (in a process of its own: the card's
    tracer records device work in the first profiler session of a
    process only) the trace holds page-locked uploads and no
    ``ft:backend.stage`` range."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _PROFILE_UPLOAD, str(here),
                          str(tmp_path / "trace.json")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    card = json.loads(res.stdout.strip().splitlines()[-1])
    _, cpu = upload_report("cpu", "upload")
    rep = card["report"]
    assert card["same"] and card["pinned"] and not card["ring_written"]
    assert rep["n_batches"] == cpu.n_batches == 13
    assert rep["direct_batches"] == rep["n_batches"] == \
        cpu.direct_batches
    assert card["scatters"] == rep["n_batches"]
    assert rep["peak_staging_mb"] == cpu.peak_staging_mb
    assert rep["hop_trace"] == cpu.hop_trace
    assert card["events_mb"] == [mb for mb, _ in cpu.events]
    assert "Memcpy HtoD (Pinned -> Device)" in card["memcpy"], card["memcpy"]
    assert "ft:backend.execute" in card["ft"] and \
        "ft:copy.wait" in card["ft"] and \
        "ft:backend.stage" not in card["ft"], card["ft"]


RELOAD_MB = 512.0       # 256 chunks, 52 trigger batches

_PROFILE_RELOAD = """
import json, statistics, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import topology as ttopo
from repro_torch.core.backend_torch import TorchBackend, nbytes_of, synth_payload
from repro_torch.core.linksim import LinkSim
from repro_torch.core.pathfinder import PathFinder
from repro_torch.core.pinned_buffer import CircularPinnedBuffer
from repro_torch.core.transfer import CUT_THROUGH, TransferEngine
mb = float(sys.argv[2])
topo = ttopo.dgx_v100()
eng = TransferEngine(LinkSim(topo), PathFinder(topo), CircularPinnedBuffer(),
                     topo, staging=CUT_THROUGH)
be = TorchBackend(device="cuda", store_mb=2 * mb, host_mb=2 * mb)
be.put_object("ckpt", "host", size_mb=mb)
plan = eng.compile("reload", "t", "host", "gpu3", mb, data_id="ckpt")
be.execute(plan)                     # warm: kernels, allocator, store
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    rep = be.execute(plan)
    torch.cuda.synchronize()
prof.export_chrome_trace(sys.argv[1])
h2d = sorted((e["ts"], e["dur"]) for e in json.load(open(sys.argv[1]))[
    "traceEvents"] if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
    and "HtoD" in e["name"])
gaps = [b[0] - (a[0] + a[1]) for a, b in zip(h2d, h2d[1:])]
print(json.dumps({
    "same": bool((be.read_object("ckpt", "gpu3")
                  == synth_payload("ckpt", nbytes_of(mb))).all()),
    "pinned": be.stores["host"].slabs.is_pinned(),
    "report": {f: getattr(rep, f) for f in (
        "n_batches", "direct_batches", "overlapped_batches")},
    "uploads": len(h2d),
    "median_gap_ms": statistics.median(gaps) / 1e3 if gaps else None}))
"""


@pytest.mark.cuda
def test_page_locked_reload_keeps_the_copy_engine_busy(cuda_device,
                                                       tmp_path):
    """A 512 MB reload from a page-locked host store, profiled in a
    process of its own (the card's tracer records device work in the
    first profiler session of a process only): the bytes are the
    oracle's, every batch after the first is queued before the one
    ahead of it is confirmed (``overlapped_batches == n_batches - 1``),
    and the median device gap between consecutive host-to-device copies
    is under 0.05 ms, the one scatter between them, where waiting for
    each batch before queueing the next leaves the host's turnaround
    (~0.2 ms) in every gap."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _PROFILE_RELOAD,
                          str(tmp_path / "trace.json"), str(RELOAD_MB)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    card = json.loads(res.stdout.strip().splitlines()[-1])
    rep = card["report"]
    assert card["same"] and card["pinned"]
    assert rep["n_batches"] == 52 == card["uploads"]
    assert rep["direct_batches"] == rep["n_batches"]
    assert rep["overlapped_batches"] == rep["n_batches"] - 1
    assert card["median_gap_ms"] < 0.05, card


# ------------------------------------- chaos and the swap tier on the card -

def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _synth_equal(be, did, ep, mb):
    np.testing.assert_array_equal(be.read_object(did, ep),
                                  synth_payload(did, nbytes_of(mb)))


@pytest.mark.cuda
def test_chaos_run_on_card_matches_cpu(cuda_device):
    """``chip_smoke.py``'s phase 10 at a quarter of the paper's sizes
    (seed 34: every fault kind fires, one transfer re-plans): the trace
    equals the run without a backend, bytes are checked after every
    fault, at the end and after the re-plan, and the card's backend keeps
    the same objects as the CPU's."""
    C = _chip_smoke()
    plain = C.chaos_run(None, None, scale=0.25, seed=34)
    held = {}
    for device in ("cuda", "cpu"):
        be = TorchBackend(device=device, store_mb=1024.0, host_mb=2048.0)
        before = K.gather_chunks.launches, K.scatter_chunks.launches
        res = C.chaos_run(be, _synth_equal, scale=0.25, seed=34)
        for key in ("trace", "requests", "stats", "fired", "retries",
                    "n_events", "replans", "live"):
            assert res[key] == plain[key], (device, key)
        assert res["replans"] and res["checked"] > 0
        held[device] = {ep: sorted(st.objects)
                        for ep, st in be.stores.items() if st.objects}
        if device == "cuda":
            assert K.gather_chunks.launches > before[0]
            assert K.scatter_chunks.launches > before[1]
            for st in be.stores.values():
                assert st.slabs.is_cuda if st.device else st.slabs.is_pinned()
    assert held["cuda"] == held["cpu"]


@pytest.mark.cuda
def test_swap_tier_on_card(cuda_device):
    """``chip_smoke.py``'s phase 11 with the checkpoints, caps and gaps
    shrunk 64 times: both policies, every reload byte-equal on the card,
    no device copy after an eviction, stats and first-token times equal
    to the run without a backend (the phase checks all of it), host hits
    and cold reloads both timed."""
    C = _chip_smoke()
    before = K.scatter_chunks.launches
    out = C.swap_phase(lambda *a: None, scale=1 / 64)
    assert K.scatter_chunks.launches > before
    paths = {(r["policy"], r["path"]) for r in out["reloads"]}
    assert paths == {(p, k) for p in ("slo", "lru")
                     for k in ("host hit", "cold")}
    assert all(r["wall_ms"] > 0 and 0 < r["first_layer_ms"] <= r["wall_ms"]
               for r in out["reloads"])
    assert set(out["yardsticks"]) == {"minicpm-2b", "qwen2-vl-2b",
                                      "whisper-medium"}


# --------------------------------------------------------- attention ------

@pytest.mark.cuda
def test_flash_attention_launches_one_kernel_per_call(cuda_device, tmp_path):
    """One bf16 call, then one f32 call, under one profiler session (the
    card's tracer records kernels in the first session of a process
    only): exactly two kernels ran, the tensor-core one and then the
    CUDA-core one."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((3, 2, 4, 200, 64), generator=gen, device=cuda_device)
    bf = [t.to(torch.bfloat16) for t in x]
    before = FK.flash_attention.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        FK.flash_attention(*bf, causal=True)
        FK.flash_attention(*x, causal=True)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        ran = [e["name"] for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    assert FK.flash_attention.launches == before + 2
    assert len(ran) == 2, ran
    assert "flash_bf16" in ran[0] and "flash_f32" in ran[1], ran


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Lq, Lkv, D, causal, window, q_offset, kv_offset)
    (2, 4, 4, 128, 128, 64, True, 0, 0, 0),       # MHA, causal
    (2, 8, 2, 200, 200, 128, True, 64, 0, 0),     # GQA, ragged, window
    (1, 4, 2, 77, 300, 16, True, 0, 0, 0),        # Lkv > Lq, D=16
    (1, 4, 2, 100, 70, 32, True, 5, 0, 0),        # rows that see no key
    (2, 4, 4, 96, 96, 64, False, 0, 0, 0),        # not causal
    # Lq and Lkv off every tile multiple, at each head dim
    (1, 4, 2, 200, 77, 16, True, 0, 0, 0),
    (1, 4, 2, 200, 77, 32, True, 0, 0, 0),
    (1, 4, 2, 200, 77, 64, False, 0, 0, 0),
    (1, 4, 2, 200, 77, 128, True, 0, 0, 0),
    (1, 4, 4, 130, 300, 64, True, 0, 170, 0),     # queries after a prefix
    (1, 4, 4, 200, 77, 64, True, 0, 0, 40),       # kv_offset > q_offset:
                                                  # 40 blind rows
    (1, 4, 2, 100, 150, 32, True, 24, 60, 10),    # both offsets, window
    (2, 16, 2, 256, 256, 128, True, 0, 0, 0),     # GQA group 8
    (1, 4, 2, 300, 300, 64, True, 24, 0, 0),      # window < BK
    (1, 2, 2, 64, 40, 64, True, 16, 30, 0),       # the window passes every
                                                  # key of the last rows
    # many kv tiles at D=64, where P V is issued in two halves
    (1, 4, 4, 100, 1100, 64, False, 0, 30, 7),    # 18 tiles, not causal
    (1, 4, 2, 200, 1300, 64, True, 0, 1100, 5),   # after a long prefix
    (2, 4, 4, 1024, 1024, 64, True, 0, 0, 0),     # MiniCPM-2B's, narrow
    (1, 2, 2, 130, 1088, 64, True, 300, 950, 0),  # window over many tiles
    (1, 4, 1, 90, 1500, 128, False, 0, 0, 0),     # 24 tiles at D=128
    # Whisper-medium's encoder (not causal, 1500 frames), 4 queries over
    # those frames (not causal, Lq != Lkv), GQA group 6 at D=128
    # (Qwen2-VL-2B's 12/2 heads; DBRX's 48/8), causal and not
    (2, 16, 16, 1500, 1500, 64, False, 0, 0, 0),
    (2, 16, 16, 4, 1500, 64, False, 0, 0, 0),
    (2, 12, 2, 2048, 2048, 128, True, 0, 0, 0),
    (1, 48, 8, 300, 300, 128, True, 0, 0, 0),
    (1, 12, 2, 77, 1500, 128, False, 0, 0, 0),
    # DBRX-132B's (48/8) and Jamba-1.5-Large's (64/8) heads at a
    # 1024-token prefill, one request
    (1, 48, 8, 1024, 1024, 128, True, 0, 0, 0),
    (1, 64, 8, 1024, 1024, 128, True, 0, 0, 0),
])
def test_flash_attention_matches_plain_on_card(cuda_device, shape, dtype,
                                               tol):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, Hq, Hkv, Lq, Lkv, D, causal, window, q_off, kv_off = shape
    kw = dict(causal=causal, window=window, q_offset=q_off, kv_offset=kv_off)
    gen = torch.Generator(device=cuda_device).manual_seed(Lq * Lkv + D)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               for s in ((B, Hq, Lq, D), (B, Hkv, Lkv, D), (B, Hkv, Lkv, D)))
    before = FK.flash_attention.launches
    got = FK.flash_attention(q, k, v, **kw)
    assert FK.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _paged_inputs(shape, dtype, device, seed):
    """q, pages, a table with ids from -1 to P (repeated, negative and
    too large) and ragged lengths: the first 0, the second on a span
    boundary of the plan, one past it, the rest random up to NP * page + 1."""
    from repro_torch.kernels.paged_attention import kernel as PK
    B, Hkv, G, D, page, NP, P = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Hkv * G, D), generator=gen, device=device).to(dtype)
    kp, vp = (torch.randn((P, page, Hkv, D), generator=gen,
                          device=device).to(dtype) for _ in range(2))
    table = torch.randint(-1, P + 1, (B, NP), generator=gen, device=device,
                          dtype=torch.int32)
    lens = torch.randint(0, NP * page + 2, (B,), generator=gen,
                         device=device, dtype=torch.int32)
    split_len = PK.split_plan(B, Hkv, NP, page, D,
                              PK.resident_slots(D, q.device.index))[0]
    lens[0] = 0
    for i, n in enumerate((split_len, split_len + 1)[:B - 1]):
        lens[1 + i] = n
    return q, kp, vp, table, lens


def _assert_paged_close(got, want):
    """chip_smoke.py's limit: 5e-5 in f32; in bf16, in each output row the
    largest difference at most 2**-6 of the row's largest |want|."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)
        return
    assert bool(torch.isfinite(got).all())
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    rel = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)
    assert float(rel.max()) <= 2 ** -6, float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, Hkv, G, D, page, NP, P)
    (3, 4, 1, 64, 128, 4, 6),
    (2, 2, 4, 128, 128, 3, 4),
    (2, 2, 3, 16, 8, 5, 7),
    (4, 2, 2, 64, 128, 32, 40),      # many spans, ragged lengths
    (3, 2, 8, 128, 128, 16, 20),     # group 8 at D = 128, many spans
    (3, 2, 2, 64, 8, 40, 50),        # page 8: eight pages a tile
    (2, 1, 20, 32, 64, 20, 24),      # group 20: two or three head groups
    (3, 2, 5, 16, 16, 30, 32),       # group 5: idle head rows a block
])
def test_paged_attention_matches_plain_on_card(cuda_device, shape, dtype):
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    q, kp, vp, table, lens = _paged_inputs(shape, dtype, cuda_device,
                                           sum(shape))
    got = PK.paged_attention(q, kp, vp, table, lens)
    want = paged_attention_ref(q, kp, vp, table, lens)
    _assert_paged_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_is_deterministic(cuda_device, dtype):
    """Two calls give the same bits: both passes sum in a fixed order."""
    from repro_torch.kernels.paged_attention import kernel as PK
    args = _paged_inputs((4, 4, 2, 64, 128, 24, 40), dtype, cuda_device, 3)
    a = PK.paged_attention(*args)
    b = PK.paged_attention(*args)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


_PROFILE_PAGED = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from test_torch_on_card import _paged_inputs
from repro_torch.kernels.paged_attention import kernel as PK
args = _paged_inputs((2, 2, 4, 128, 128, 16, 20), torch.bfloat16,
                     torch.device("cuda"), 4)
PK.load_library()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    PK.paged_attention(*args)
    torch.cuda.synchronize()
prof.export_chrome_trace(sys.argv[2])
ran = [e["name"] for e in json.load(open(sys.argv[2]))["traceEvents"]
       if e.get("ph") == "X" and e.get("cat") == "kernel"]
print(json.dumps({"ran": ran, "launches": PK.paged_attention.launches}))
"""


@pytest.mark.cuda
def test_paged_attention_launches_split_then_merge(cuda_device, tmp_path):
    """One call with several spans runs exactly two kernels under the
    profiler, paged_split and then paged_merge, and counts one launch.
    In a process of its own: the card's tracer records kernels in the
    first profiler session of a process only."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels.paged_attention import kernel as PK
    args = _paged_inputs((2, 2, 4, 128, 128, 16, 20), torch.bfloat16,
                         cuda_device, 4)
    assert PK.split_plan(2, 2, 16, 128, 128,
                         PK.resident_slots(128, args[0].device.index))[1] > 1
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _PROFILE_PAGED, str(here),
                          str(tmp_path / "trace.json")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    ran = out["ran"]
    assert out["launches"] == 1
    assert len(ran) == 2, ran
    assert "paged_split" in ran[0] and "paged_merge" in ran[1], ran


@pytest.mark.cuda
def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK
    q = torch.zeros((1, 2, 8, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        FK.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        FK.flash_attention(q, q.half(), q.half())
    with pytest.raises(ValueError, match="stats"):
        FK.flash_attention_bwd(q, q, q, q, torch.zeros_like(q[..., 0]).double())
    with pytest.raises(ValueError, match="does not match"):
        FK.flash_attention_bwd(q, q, q, q[:, :1], torch.zeros_like(q[..., 0]))
    pages = torch.zeros((2, 8, 2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        PK.paged_attention(torch.zeros((1, 2, 64), device=cuda_device),
                           pages, pages,
                           torch.zeros((1, 2), dtype=torch.int64,
                                       device=cuda_device),
                           torch.zeros((1,), dtype=torch.int32,
                                       device=cuda_device))


def _decode_inputs(case, dtype, device, seed):
    """q (B, Hq, 1, D) and caches (B, Hkv, S, D) of one dtype."""
    B, Hkv, G, D, S = case[:5]
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((B, Hkv * G, 1, D), (B, Hkv, S, D),
                             (B, Hkv, S, D)))
    return q, k, v


# (B, Hkv, G, D, S, pos, window): the decode cell (32 sessions, MiniCPM-2B's
# 36/36 heads of 64, a 4096-position cache) at its first position and at
# the cache's end, DBRX's 48/8 heads of 128 at the same positions, then
# odd ones: D 16 and 32, groups of 3, 5 and 20 (idle head rows, three head
# groups), a live range off the 64-position tile, a sliding window
DECODE_CASES = [
    (32, 36, 1, 64, 4096, 1024, 0), (32, 36, 1, 64, 4096, 4095, 0),
    (8, 8, 6, 128, 4096, 1024, 0), (8, 8, 6, 128, 4096, 4095, 0),
    (3, 4, 1, 16, 100, 99, 0), (2, 2, 5, 32, 300, 150, 0),
    (2, 1, 20, 128, 257, 256, 0), (4, 2, 3, 64, 77, 0, 0),
    (2, 4, 2, 64, 1000, 700, 129), (1, 2, 4, 16, 5000, 4999, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_attention_matches_plain_on_card(cuda_device, case, dtype):
    """The two kernels over the live positions against the plain decode
    attention over the whole padded cache (the CPU path, run on the
    card), with the paged kernel's limits."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.attention import decode_attention
    q, k, v = _decode_inputs(case, dtype, cuda_device, sum(case))
    pos, window = case[5:]
    before = DK.decode_scores.launches, DK.decode_values.launches
    got = decode_attention(q, k, v, pos, window=window)
    assert (DK.decode_scores.launches, DK.decode_values.launches) == (
        before[0] + 1, before[1] + 1)
    want = decode_attention_ref(q, k, v, pos, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _assert_paged_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [DECODE_CASES[0], DECODE_CASES[3],
                                  DECODE_CASES[6]], ids=str)
def test_decode_attention_is_deterministic(cuda_device, case, dtype):
    """Two calls give the same bits: every sum runs in a fixed order."""
    from repro_torch.models.attention import decode_attention
    q, k, v = _decode_inputs(case, dtype, cuda_device, 5)
    a = decode_attention(q, k, v, case[5])
    b = decode_attention(q, k, v, case[5])
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [DECODE_CASES[0], DECODE_CASES[2],
                                  DECODE_CASES[8]], ids=str)
def test_decode_attention_never_reads_past_the_live_range(cuda_device, case,
                                                          dtype):
    """Slots outside the live range (past ``pos``: a previous generation's;
    before a window) filled with NaN leave the output finite and equal to
    the clean cache's."""
    from repro_torch.models.attention import decode_attention
    q, k, v = _decode_inputs(case, dtype, cuda_device, 6)
    pos, window = case[5:]
    lo = max(pos - window + 1, 0) if window else 0
    clean = decode_attention(q, k, v, pos, window=window)
    for t in (k, v):
        t[:, :, pos + 1:] = float("nan")
        t[:, :, :lo] = float("nan")
    dirty = decode_attention(q, k, v, pos, window=window)
    assert bool(torch.isfinite(dirty.float()).all())
    assert torch.equal(dirty.view(torch.uint8), clean.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 1024, 4095])
def test_sharded_decode_attention_over_one_rank_is_bit_equal(cuda_device,
                                                             pos, dtype):
    """``sharded_decode_attention`` on the 1x1 NCCL mesh, its cache whole
    on the one rank, gives ``decode_attention``'s bits at the decode
    cell's shape, as its docstring states."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.attention import (
        decode_attention, sharded_decode_attention)
    q, k, v = _decode_inputs(DECODE_CASES[0], dtype, cuda_device, pos)
    mesh = make_smoke_mesh("cuda")
    try:
        got = sharded_decode_attention(q, k, v, pos, offset=0, mesh=mesh,
                                       axes=("model",))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    want = decode_attention(q, k, v, pos)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_engine_decode_at_full_width_launches_each_kernel_once_a_layer(
        cuda_device):
    """MiniCPM-2B at full width in bf16: one ``Engine.decode`` step runs
    each decode attention kernel once in each of its 40 layers."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, extend_caches
    cfg = get_arch("minicpm-2b")
    B, L = 2, 64
    eng = Engine(cfg, ShapeSpec("serve", L + 4, B, "decode"),
                 M.init_params(cfg, 3))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, L), dtype=np.int32))
    with torch.no_grad():
        logits, caches = eng.prefill({"tokens": toks})
        caches = extend_caches(cfg, caches, L + 4)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        for pos in range(L, L + 3):
            before = DK.decode_scores.launches, DK.decode_values.launches
            logits, caches = eng.decode(caches, tok, pos)
            assert (DK.decode_scores.launches - before[0],
                    DK.decode_values.launches - before[1]) == (40, 40)
            assert bool(torch.isfinite(logits).all())
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma3-27b"])
def test_engine_on_card_matches_cpu(cuda_device, arch):
    """Reduced f32 weights made once on the CPU and copied: the card's
    prefill logits (through the flash kernel) agree with the CPU's (plain
    version) within 1e-4, and the greedy tokens are equal."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.serving.engine import Engine
    cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
    host = PM.tree_map(lambda t: t.float(), M.init_params(cfg, 7, "cpu"))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 16), dtype=np.int32))
    shape = ShapeSpec("serve", 24, 2, "decode")
    runs = []
    for device, params in (("cpu", host),
                           ("cuda", PM.tree_map(lambda t: t.cuda(), host))):
        eng = Engine(cfg, shape, params, device=device)
        logits, _ = eng.prefill({"tokens": toks})
        out, _ = eng.generate({"tokens": toks}, max_new_tokens=8)
        runs.append((logits.cpu(), out.cpu()))
    torch.testing.assert_close(runs[1][0], runs[0][0], atol=1e-4, rtol=1e-4)
    assert torch.equal(runs[1][1], runs[0][1])


def _assert_rows_close(got, want, dtype):
    """f32 within 1e-4; bf16 each row within 2**-6 of its largest |want|."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    rel = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)
    assert float(rel.max()) <= 2 ** -6, float(rel.max())


# (B, Hq, Hkv, Lq, Lkv, causal, window, q_offset, kv_offset): the CPU
# tests' gradient cases (tests/_flashcases.py) without their head dim,
# then longer causal, windowed and GQA ones
CARD_BWD_CASES = [c[:5] + c[6:] for c in BWD_CASES] + [
    (2, 4, 4, 600, 600, True, 0, 0, 0),     # causal, L off the 512-row block
    (1, 4, 4, 700, 700, True, 128, 0, 0),   # sliding window
    (1, 12, 2, 512, 512, True, 0, 0, 0),    # GQA group 6
]


def _bwd_inputs(case, D, dtype, device):
    B, Hq, Hkv, Lq, Lkv, causal, window, qo, ko = case
    kw = dict(causal=causal, window=window, q_offset=qo, kv_offset=ko)
    gen = torch.Generator(device=device).manual_seed(Lq * D + Lkv + Hq)
    q, k, v, do = (torch.randn(s, generator=gen, device=device).to(dtype)
                   for s in ((B, Hq, Lq, D), (B, Hkv, Lkv, D),
                             (B, Hkv, Lkv, D), (B, Hq, Lq, D)))
    return (q, k, v, do), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("case", CARD_BWD_CASES, ids=str)
def test_flash_backward_matches_autograd_on_card(cuda_device, case, D, dtype,
                                                 monkeypatch):
    """The kernels under ``ops.FlashAttention`` (one forward launch, one
    backward launch a call; ``attention_bwd_ref`` patched to raise)
    against autograd of ``attention_ref`` on the same card."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def plain(*a, **kw):
        raise AssertionError("attention_bwd_ref on the card")
    monkeypatch.setattr(ops, "attention_bwd_ref", plain)
    (q, k, v, do), kw = _bwd_inputs(case, D, dtype, cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = FK.flash_attention.launches, FK.flash_attention_bwd.launches
    out = ops.attention(*leaves, **kw)
    assert FK.flash_attention.launches == fwd + 1
    assert out.grad_fn is not None and out.dtype == dtype
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert FK.flash_attention.launches == fwd + 1
    assert FK.flash_attention_bwd.launches == bwd + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref, **kw), ref, do)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_rows_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("case", CARD_BWD_CASES, ids=str)
def test_flash_backward_matches_plain_on_card(cuda_device, case, D, dtype):
    """The forward's statistics against ``attention_stats_ref`` (rows that
    see no key exactly NEG_INF), and the backward kernel against
    ``attention_bwd_from_stats_ref`` on the kernel's own statistics."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        NEG_INF, attention_bwd_from_stats_ref, attention_stats_ref)
    (q, k, v, do), kw = _bwd_inputs(case, D, dtype, cuda_device)
    _, stats = FK.flash_attention(q, k, v, return_stats=True, **kw)
    want_stats = attention_stats_ref(q, k, **kw)
    blind = want_stats == NEG_INF
    assert torch.equal(stats == NEG_INF, blind)
    torch.testing.assert_close(stats[~blind], want_stats[~blind],
                               atol=1e-4, rtol=0)
    got = FK.flash_attention_bwd(q, k, v, do, stats, **kw)
    want = attention_bwd_from_stats_ref(q, k, v, do, stats, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_rows_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 12, 2, 1000, 1000, True, 0, 0, 0),
                                  (1, 8, 8, 300, 700, True, 100, 400, 0)],
                         ids=str)
def test_flash_backward_is_deterministic(cuda_device, case, dtype):
    """No atomics: two calls on the same inputs are bit-equal."""
    from repro_torch.kernels.flash_attention import kernel as FK
    for D in (64, 128):
        (q, k, v, do), kw = _bwd_inputs(case, D, dtype, cuda_device)
        _, stats = FK.flash_attention(q, k, v, return_stats=True, **kw)
        a = FK.flash_attention_bwd(q, k, v, do, stats, **kw)
        b = FK.flash_attention_bwd(q, k, v, do, stats, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_flash_backward_with_many_items_is_deterministic(cuda_device):
    """Many more key-major items than resident blocks (4 x 2048, 36 heads
    of 64, causal: 2304 items on 132 blocks), so that items wait for their
    dQ predecessors on other blocks: two calls bit-equal, and each row of
    dq, dk and dv within the bf16 limit of the plain version."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_from_stats_ref)
    (q, k, v, do), kw = _bwd_inputs((4, 36, 36, 2048, 2048, True, 0, 0, 0),
                                    64, torch.bfloat16, cuda_device)
    _, stats = FK.flash_attention(q, k, v, return_stats=True, **kw)
    a = FK.flash_attention_bwd(q, k, v, do, stats, **kw)
    b = FK.flash_attention_bwd(q, k, v, do, stats, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = attention_bwd_from_stats_ref(q, k, v, do, stats, **kw)
    for g, w in zip(a, want):
        _assert_rows_close(g, w, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_forward_stats_leave_output_bit_equal(cuda_device, D, dtype):
    """The serving path passes no statistics pointer: its output is the
    same bits as the training path's, which writes the statistics."""
    from repro_torch.kernels.flash_attention import kernel as FK
    for case in CARD_BWD_CASES:
        (q, k, v, _), kw = _bwd_inputs(case, D, dtype, cuda_device)
        plain = FK.flash_attention(q, k, v, **kw)
        out, _ = FK.flash_attention(q, k, v, return_stats=True, **kw)
        assert torch.equal(plain, out), case


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "jamba-1.5-large-398b"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One accum-2 train step of the reduced arch in f32 from the same
    weights on the card (the flash kernel under autograd) and on the
    CPU: loss within 1e-4 and every parameter within 1e-5 after the
    update; two flash launches (forward, recompute) and one backward
    launch per attention layer and microbatch."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import io
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import build_train_step
    cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
    host = PM.tree_map(lambda t: t.float(), M.init_params(cfg, 7, "cpu"))
    batch = io.synthetic_batch(cfg, ShapeSpec("t", 64, 2, "train"), 3, "cpu")
    from repro_torch.models.blocks import block_pattern, kind_meta
    n_attn = sum(kind_meta(cfg, k)["mixer"] not in ("mamba", "mlstm", "slstm")
                 for k in block_pattern(cfg))
    runs = []
    for device in ("cpu", "cuda"):
        params = PM.trainable(PM.tree_map(
                lambda t: t.to(device, copy=True), host))
        opt = init_opt_state(M.model_specs(cfg), "f32", device)
        step = build_train_step(cfg, M.build_ctx(cfg),
                                OptConfig(schedule=cfg.lr_schedule), 2)
        before = (FK.flash_attention.launches,
                  FK.flash_attention_bwd.launches)
        params, opt, m = step(params, opt, {k: v.to(device)
                                            for k, v in batch.items()})
        launched = (FK.flash_attention.launches - before[0],
                    FK.flash_attention_bwd.launches - before[1])
        runs.append((m["loss"].item(), [t.detach().cpu() for t in
                                         PM.tree_leaves(params)], launched))
    assert runs[0][2] == (0, 0) and runs[1][2] == (2 * 2 * n_attn, 2 * n_attn)
    assert abs(runs[1][0] - runs[0][0]) < 1e-4
    for a, b in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_mesh_train_step_on_card_matches_no_mesh(cuda_device):
    """One accum-2 step of reduced MiniCPM-2B in f32 on the card through
    a 1x1 NCCL mesh (the rank's rows, the gradient all-reduce, ZeRO-1
    moments, the parameter all-gather) and without a mesh, from the same
    weights and batch: the loss and every parameter and moment equal."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.mesh import make_opt_rules
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import io
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.optimizer import (
        OptConfig, init_opt_state, zero1_shardings)
    from repro_torch.training.train_step import build_train_step
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(),
                              cache_dtype="f32")
    shape = ShapeSpec("t", 64, 4, "train")
    host = PM.tree_map(lambda t: t.float(), M.init_params(cfg, 7, "cpu"))
    batch = {k: v.to(cuda_device) for k, v in
             io.synthetic_batch(cfg, shape, 3, "cpu").items()}
    pspecs = M.model_specs(cfg)
    oc = OptConfig(schedule=cfg.lr_schedule)
    mesh = make_smoke_mesh("cuda")
    try:
        assert dist.get_backend() == "nccl"
        runs = []
        for m in (None, mesh):
            params = PM.trainable(PM.tree_map(
                lambda t: t.to(cuda_device, copy=True), host))
            if m is None:
                ctx, shd = M.build_ctx(cfg), None
                opt = init_opt_state(pspecs, "f32", cuda_device)
            else:
                ctx = M.build_ctx(cfg, shape, m)
                rules = make_opt_rules(cfg, shape, m, ctx.rules)
                shd = zero1_shardings(pspecs, "f32", rules, m)
                opt = init_opt_state(pspecs, "f32", cuda_device, rules=rules,
                                     mesh=m)
            params, opt, met = build_train_step(cfg, ctx, oc, 2, shd)(
                params, opt, batch)
            runs.append((met["loss"].item(), [t.detach().cpu() for t in
                                              PM.tree_leaves((params, opt))]))
    finally:
        dist.destroy_process_group()
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b",
                                  "jamba-1.5-large-398b"])
def test_sharded_train_step_on_card_matches_no_mesh(cuda_device, arch):
    """One accum-2 step of a reduced MoE arch in f32 on the card through
    a 1x1 NCCL mesh, whose training rules name ``model`` and ``data``
    (every sharded body: experts, FSDP gathers, TP attention and vocab,
    Mamba's d_inner), and without a mesh, from the same weights and
    batch: the loss equal, every parameter and moment within 1e-6."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.mesh import make_opt_rules
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import io
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import build_train_step
    cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
    shape = ShapeSpec("t", 64, 4, "train")
    host = PM.tree_map(lambda t: t.float(), M.init_params(cfg, 7, "cpu"))
    batch = {k: v.to(cuda_device) for k, v in
             io.synthetic_batch(cfg, shape, 3, "cpu").items()}
    pspecs = M.model_specs(cfg)
    oc = OptConfig(schedule=cfg.lr_schedule)
    mesh = make_smoke_mesh("cuda")
    try:
        runs = []
        for m in (None, mesh):
            params = PM.trainable(PM.tree_map(
                lambda t: t.to(cuda_device, copy=True), host))
            if m is None:
                ctx = M.build_ctx(cfg)
                opt = init_opt_state(pspecs, "f32", cuda_device)
            else:
                ctx = M.build_ctx(cfg, shape, m)
                assert ctx.rules["experts"] == ("model",)
                opt = init_opt_state(pspecs, "f32", cuda_device, rules=(
                    make_opt_rules(cfg, shape, m, ctx.rules)), mesh=m)
            params, opt, met = build_train_step(cfg, ctx, oc, 2)(
                params, opt, batch)
            runs.append((met["loss"].item(), [t.detach().cpu() for t in
                                              PM.tree_leaves((params, opt))]))
    finally:
        dist.destroy_process_group()
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma3-27b", "dbrx-132b",
                                  "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_mesh_engine_on_card_matches_no_mesh(cuda_device, arch):
    """A reduced f32 ``Engine`` on the card through the 1x1 NCCL mesh,
    whose serving rules name ``model`` (and ``data`` for MoE decode):
    vocab-parallel embedding and logits, TP attention, the K/V handoff
    onto ``kv_seq``, the flash-decoding merge, Mamba's and xLSTM's
    sharded states; against the same engine without a mesh, from the
    same weights and prompt: the prefill logits equal, every decode
    step's within 1e-5, the tokens equal."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.serving.engine import Engine
    cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
    B = 4 if cfg.n_experts else 2
    params = PM.tree_map(lambda t: t.float().to(cuda_device),
                         M.init_params(cfg, 7, "cpu"))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, 16), dtype=np.int32))
    shape = ShapeSpec("serve", 32, B, "decode")
    mesh = make_smoke_mesh("cuda")
    try:
        runs = []
        for m in (None, mesh):
            eng = Engine(cfg, shape, params, device=cuda_device, mesh=m)
            logits = []
            for fn in ("prefill", "decode"):
                def rec(*a, _f=getattr(eng, fn)):
                    lg, c = _f(*a)
                    logits.append(lg.cpu())
                    return lg, c
                setattr(eng, fn, rec)
            with torch.no_grad():
                out, _ = eng.generate({"tokens": toks}, max_new_tokens=8,
                                      cache_len=32)
            runs.append((logits, out.cpu()))
    finally:
        dist.destroy_process_group()
    assert torch.equal(runs[1][0][0], runs[0][0][0])
    for a, b in zip(runs[1][0][1:], runs[0][0][1:]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert torch.equal(runs[1][1], runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300,), (1,), (1000, 130)])
def test_quantize_on_card_bit_equal_to_cpu(cuda_device, shape):
    from repro_torch.distributed.compression import dequantize, quantize
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    q, s, n = quantize(x.to(cuda_device))
    qh, sh, nh = quantize(x)
    assert n == nh and torch.equal(q.cpu(), qh)
    assert torch.equal(s.cpu().view(torch.int32), sh.view(torch.int32))
    assert torch.equal(dequantize(q, s, n, shape).cpu().view(torch.int32),
                       dequantize(qh, sh, nh, shape).view(torch.int32))


@pytest.mark.cuda
def test_traced_reload_waits_inside_the_walk(cuda_device, tmp_path):
    """A host-to-card reload (MATRIX's ``reload``, cut through) under a
    profiler of the host alone (the card's tracer records kernels in a
    process's first profile only): the walk is one
    ``ft:backend.execute`` range, and its blocking waits on the upload
    and the landed boundary are ``ft:copy.wait`` ranges inside it, at
    least one a trigger batch."""
    import json

    from torch.profiler import ProfilerActivity, profile
    topo_fn, kind, src, dst, kw = MATRIX["reload"]
    topo = topo_fn()
    eng = TransferEngine(LinkSim(topo), PathFinder(topo),
                         CircularPinnedBuffer(), topo, staging=CUT_THROUGH,
                         **kw)
    be = TorchBackend(device="cuda")
    plan = eng.compile(kind, "t", src, dst, SIZE_MB, data_id="traced")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = be.execute(plan)
    np.testing.assert_array_equal(be.read_object("traced", dst),
                                  synth_payload("traced", nbytes_of(SIZE_MB)))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        ft = [(e["name"], e["ts"], e["ts"] + e["dur"])
              for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("ft:")]
    walks = [r for r in ft if r[0] == "ft:backend.execute"]
    waits = [r for r in ft if r[0] == "ft:copy.wait"]
    assert len(walks) == 1 and len(waits) >= rep.n_batches == 3
    (_, w0, w1), = walks
    assert all(w0 <= a and b <= w1 for _, a, b in waits)
