#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

It imports the port (``src/repro_torch``) only, builds the hand-written
CUDA kernels from the checkout's sources, and runs seventeen phases:

1. environment: torch / CUDA versions, the card's name and power limit,
   and ``synth_payload`` against numpy's own uint8 draw;
2. build: one ``nvcc`` for sm_90a per source, all started together;
   the compiler's register and spill report, and each flash, flash
   backward, paged and decode instance's registers, local (spill)
   bytes, shared memory and resident blocks per SM as the card reports
   them, and the resident blocks the paged split plan fills; the bf16
   D=64 flash instance and every bf16 flash backward, paged and decode
   instance must not spill;
3. the chunked-copy kernels against their plain versions on the card,
   byte for byte, and their times at the main path's shapes beside their
   bound;
4. the facade ``FaaSTube(dgx_v100(), FAASTUBE, backend="torch")`` at the
   paper's object sizes (the DRIVING and TRAFFIC workflows' edges), with
   its simulated trace held against a run without a backend;
5. every plan kind x both staging modes at 128 MB through
   ``TransferEngine.compile`` and ``TorchBackend.execute``;
6. spill and reload of 128 MB objects at the default 1024 MB store cap;
7. the attention kernels against their plain versions on the card, at
   MiniCPM-2B's shapes and at odd ones (flash: not causal over Whisper's
   1500 frames, 4 queries over them, group 6 at Qwen2-VL-2B's heads;
   paged: many spans, a length on a span boundary, group 8 at D=128,
   pages of 8; decode: the decode cell's and DBRX's heads over a
   4096-position cache, groups of 5 and 20, a window; flash also at
   every shape phase 12 launches and at phases
   13's and 15's training shapes, derived from the models' configs), and their
   times beside their bound, their plain
   versions' and the library call's (flash and paged also at Qwen2-72B's
   heads, GQA at D=128, flash also at Whisper-medium's encoder and
   Qwen2-VL-2B's prefill; paged also beside SDPA over the same K/V as a
   contiguous cache, a yardstick without the gather; decode at the
   decode cell's shape at positions 1024 and 4095 and at DBRX's heads,
   each pass timed alone too); the flash
   backward (its forward's statistics, then dq, dk, dv) against its
   plain version at odd cases and at 13's and 15's training shapes, f32
   and bf16, timed at those two shapes beside its bound, its plain
   version, the plain backward it replaced and SDPA's backward;
8. the serving path, reduced, in f32: ``Engine.generate`` for MiniCPM-2B,
   Gemma3-27B (the sliding window), Qwen2-VL-2B (M-RoPE, a vision
   prefix), Whisper-medium (the encoder), DBRX-132B and Grok-1-314B
   (MoE), Jamba-1.5-Large (Mamba, MoE, attention) and xLSTM-1.3B on the
   card against the same on the CPU, with the same weights and inputs
   (Whisper's encoder output too), and one flash launch per attention
   layer in each prefill;
9. the serving path at full width: ``Engine(minicpm-2b)`` in bf16 on the
   card, 8 requests of 1024 prompt tokens, 32 new tokens each, each
   decode step launching each decode attention kernel once a layer;
   then the paged kernel over layer 0's KV cache cut into shuffled
   128-token pages, against the engine's decode attention on the
   contiguous cache;
10. chaos with real bytes: a ``WorkflowEngine`` running DRIVING and
    TRAFFIC at the paper's object sizes on ``cluster(2)`` with a
    ``TorchBackend`` on the card, under a seeded ``FaultSchedule`` of
    all four fault kinds with the recovery ladder armed: the simulated
    trace equal to the run without a backend, the bytes of every object
    the index knows equal after each fault and at the end, and of every
    transfer that failed and re-planned; what the backend still holds
    for objects the index lost;
11. the swap tier at real checkpoint sizes: ``ModelCache`` swapping
    MiniCPM-2B, Qwen2-VL-2B and Whisper-medium (``profile_from_arch``:
    5450.7, 3554.3 and 817.2 MB) through one GPU under a 7000 MB store
    cap, under the SLO and the LRU policy: stats and first-token times
    equal to the run without a backend, every reload's bytes equal on
    the card, no device copy after an eviction; each reload's wall time
    and first-layer landing beside the PCIe 5.0 bound and one plain
    page-locked copy of the same bytes;
12. the other families at full width in bf16 through ``Engine.generate``
    (8 requests, 32 new tokens each), one function per model so that
    nothing of one is held past it: Qwen2-VL-2B (28 layers, 1024
    ``vision_embeds`` positions + 1024 text tokens), Whisper-medium
    (24 + 24 layers, 1500 encoder frames, a 4-token prompt), xLSTM-1.3B
    (48 layers, 1024 tokens), DBRX-132B cut to 4 layers and
    Jamba-1.5-Large cut to its first 5 (1024 tokens each); prefill and
    decode times, tokens/s, peak memory, one flash launch per attention
    layer, for Qwen2-VL-2B and Whisper-medium 4 decode steps against
    prefills of the same tokens (teacher-forced), and Whisper's encoder
    output through the kernel against the plain attention;
13. the training path: (a) one ``build_train_step`` step with 2
    microbatches of phase 8's eight architectures reduced, in f32, card
    against CPU (loss and every leaf's gradient, flash launches: forward
    and checkpoint recompute, and one backward launch each); (b)
    MiniCPM-2B at full width in bf16, ``loss_fn`` and its whole-tree
    gradient through the kernels' autograd Function against the plain
    attention, one microbatch of 2 x 4096 tokens; (c) MiniCPM-2B trained
    at full width through ``train_loop.run_training`` (bf16 parameters,
    f32 AdamW moments, the WSD schedule; 3 steps of 4 x 4096 tokens in 2
    microbatches): ms a step, tokens/s, peak memory, model-FLOPs share,
    then one step profiled (device idle share, top kernels, the flash
    forward's and backward's device time); (d) a full-width checkpoint save and
    restore of parameters and optimizer state (27 GB) under a temporary
    directory, every leaf equal, and the reference's fault-recovery
    scenario on the card at reduced size;
14. the mesh layer on the card at world size 1: (a) ``make_smoke_mesh``
    starts an NCCL process group of one; (b) 13c's first two steps
    again through ``run_training(cfg, shape, mesh)``: the rank's rows,
    the f32 gradient all-reduce, ZeRO-1 moments and the parameter
    all-gather, the first step held against 13c's record of it (loss
    within 1e-6 relative, every parameter leaf within relnorm 1e-5), the
    second timed warm, then one more step profiled in a process of its
    own (the collectives' calls and device time, the NCCL ranges and
    device events); (c) int8 compression:
    ``quantize``/``dequantize`` of the embedding gradient's shape
    bit-equal to the CPU's, ``compressed_psum_leaf`` through the NCCL
    group, and ``cross_pod_grad_sync`` over a MiniCPM-2B gradient tree
    on a (1, 1, 1) (pod, data, model) mesh timed beside its HBM bound;
    (d) both resharding permutes on the 1x1 mesh, bytes equal;
15. weight sharding on the card at world size 1, where the training
    rules still name ``model`` and ``data``, so every sharded body runs
    and every collective is called on a group of one: (a) DBRX-132B at
    full width cut to 1 of its 40 layers (4.49 B parameters, bf16, f32
    AdamW moments, WSD) trained 3 steps of 2 x 4096 tokens through
    ``run_training`` on the 1x1 NCCL mesh (experts over ``model``, FSDP
    ``embed`` over ``data``, heads and vocab over ``model``), its first
    step held against the same step without a mesh (loss within 1e-6
    relative, every parameter leaf within relnorm 1e-5), warm ms a step,
    tokens/s, peak memory, then one step profiled in a process of its
    own (idle share, the flash launches, the device time inside the
    ``nccl:*`` ranges); (b) DBRX, Grok-1 and Jamba reduced, one accum-2
    step each in f32 on the 1x1 mesh on the card against the CPU with
    no mesh;
16. serving on the card at world size 1, where the serving rules name
    ``model`` (and ``data`` for MoE decode), so every serving body runs
    and every collective is called on a group of one: ``Engine(...,
    mesh=make_smoke_mesh("cuda"))`` in bf16 for (a) MiniCPM-2B at full
    width and depth with phase 9's workload (vocab-parallel embedding
    and logits, TP attention, the flash kernel on the rank's heads, each
    layer's K/V handed to ``kv_seq`` by ``tube_reshard``,
    ``extend_caches`` on the sharded sequence, the flash-decoding merge,
    the owner's cache write), (b) Jamba-1.5-Large at full width cut to
    its first 5 layers, 4 x 1024 tokens, 16 new (the MoE decode rules:
    the batch replicated, ``kv_seq`` over ``(data, model)``, the 2-D
    ``expert_mlp``, Mamba's state over ``state_inner``), (c) xLSTM-1.3B
    at full width cut to its first 8 layers, 2 x 1024 tokens, 16 new
    (``head_v``); each against the same engine without a mesh on the
    same weights and prompt (prefill logits and tokens equal, decode
    logits within a bf16 limit, one flash launch per attention layer in
    each prefill), prefill and decode times, tokens/s and peak memory of
    both, then each mesh generate profiled in a process of its own (idle
    share, the device time inside the ``nccl:*`` ranges);
17. the port's surface: (a) the torch twins of the JAX examples, each
    run to its end in a child process on the card, the three started
    together, with their own assertions (``examples/quickstart_torch.py``: the simulator's
    sections and the real data plane through ``backend="torch"``;
    ``serve_workflow_torch.py``: the two-model workflow through
    ``Engine``; ``train_small_torch.py --tiny``: 200 steps with a
    checkpoint and a restart), each one's wall time, its kernels'
    launches and the quickstart's measured against its simulated ms;
    (b) 13c's step traced on ``meta`` tensors by the dry-run
    (``dryrun.step_costs``) against one real step on the card under
    ``FlopCounterMode``: the trace's FLOPs equal the card's plus the
    full-square FLOPs of each flash forward, which the counter does not
    see, and for each flash backward launch what the trace counts for its
    plain stand-in on ``meta``; the trace's FLOPs over 13c's warm step
    at 989 TFLOP/s, and ``6 N D`` over them.

The data plane (phases 4-6), the serving path (phase 9), the chaos run
(10), the swap tier (11), each model of phase 12, the training runs
(13c, 14b, 15a), each mesh generate of phase 16 and each run of phase 17
are the main paths: the launch counters are set to 0 just before each
and read just after it (a child process's from its start to its end);
the reads that check landed bytes are kept out of the counts.
Float32 matrix products stay in full f32 (TF32 off).  Any failed check
raises and the script exits nonzero.  The second-to-last line is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the port beside it, the script exits nonzero
and prints no result.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import json
import re
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM HBM3 rate (NVIDIA data sheet), for the kernels' bound
HBM_BYTES_PER_S = 3.35e12
SIZE_MB = 128.0
CASE_SEED = 20241102


class SmokeFailure(RuntimeError):
    pass


def check(ok, what: str):
    if not ok:
        raise SmokeFailure(what)


def smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 3 ---
def _bitwise(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _abs_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def _pool(n, c, dtype, gen, device):
    import torch
    if dtype.is_floating_point:
        return torch.randn((n, c), generator=gen).to(dtype).to(device)
    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
    return torch.randint(lo, hi, (n, c), generator=gen,
                         dtype=torch.int64).to(dtype).to(device)


def kernel_cases(device: str) -> float:
    """Every shape of the contract, kernel against plain version, bytes
    equal.  Returns the largest absolute difference seen (0.0)."""
    import torch
    from repro_torch.core.elastic_pool import SLAB_BYTES
    from repro_torch.kernels.chunked_copy import kernel as K
    from repro_torch.kernels.chunked_copy.ref import (
        gather_chunks_ref, scatter_chunks_ref)
    gen = torch.Generator().manual_seed(CASE_SEED)
    rng = np.random.default_rng(CASE_SEED)
    cases = [(512, SLAB_BYTES, torch.uint8, (5, 64, 0))]
    for c in (128, 256):
        for dt in (torch.float32, torch.bfloat16, torch.int8, torch.uint8):
            cases.append((96, c, dt, (5, 64, 0)))
    cases.append((32, 100, torch.uint8, (5, 32, 0)))      # byte path
    cases.append((1024, 256, torch.uint8, (600,)))        # > one id block
    worst = 0.0
    for n, c, dt, ms in cases:
        src = _pool(n, c, dt, gen, device)
        for m in ms:
            ids = rng.permutation(n)[:m].astype(np.int32)   # out of order
            idx = torch.as_tensor(ids, dtype=torch.long, device=device)
            got = K.gather_chunks(src, ids)
            want = gather_chunks_ref(src, idx)
            torch.cuda.synchronize()
            check(_bitwise(got, want),
                  f"gather_chunks != plain at {(n, c, dt, m)}")
            worst = max(worst, _abs_err(got, want))
            dst = _pool(n, c, dt, gen, device)
            before = dst.clone()
            new = _pool(m, c, dt, gen, device)
            K.scatter_chunks(dst, new, ids)
            want = scatter_chunks_ref(before.clone(), new, idx)
            torch.cuda.synchronize()
            check(_bitwise(dst, want),
                  f"scatter_chunks != plain at {(n, c, dt, m)}")
            keep = np.setdiff1d(np.arange(n), ids)
            check(_bitwise(dst[keep], before[keep]),
                  f"scatter_chunks touched other rows at {(n, c, dt, m)}")
            worst = max(worst, _abs_err(dst, want))
    # a base pointer off 16-byte alignment takes the byte loop
    flat = _pool(1, 64 * 128 + 1, torch.uint8, gen, device)[0]
    src = flat[1:].view(64, 128)
    ids = rng.permutation(64)[:5].astype(np.int32)
    got = K.gather_chunks(src, ids)
    want = gather_chunks_ref(src, torch.as_tensor(ids, dtype=torch.long,
                                                  device=device))
    torch.cuda.synchronize()
    check(_bitwise(got, want), "gather_chunks != plain on a misaligned base")
    # ids are checked on the host
    for bad, err in (((0, 512), IndexError), ((-1,), IndexError)):
        try:
            K.gather_chunks(_pool(512, 16, torch.uint8, gen, device), bad)
        except err:
            continue
        raise SmokeFailure(f"gather_chunks accepted ids {bad}")
    try:
        K.scatter_chunks(_pool(8, 16, torch.uint8, gen, device),
                         _pool(2, 16, torch.uint8, gen, device), (3, 3))
    except ValueError:
        pass
    else:
        raise SmokeFailure("scatter_chunks accepted repeated ids")
    return worst


def device_ms(calls, reps: int = 4) -> float:
    """Device time of one call: ``calls`` (a list of thunks, each one
    call on its own rows) captured into one CUDA graph, replayed, timed
    with CUDA events — host launch overhead is not in the number."""
    import torch
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls[:2]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * len(calls))


def call_ms(calls) -> float:
    """Time of one eager call from the host, launch overhead included."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for fn in calls:
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / len(calls)


def kernel_times(m: int, device: str) -> dict:
    """Times at the main path's shape: M rows of 2 MiB out of a 1 GiB
    pool, each call on other rows so the 50 MB L2 does not hold them."""
    import torch
    from repro_torch.core.elastic_pool import SLAB_BYTES
    from repro_torch.kernels.chunked_copy import kernel as K
    from repro_torch.kernels.chunked_copy.ref import (
        gather_chunks_ref, scatter_chunks_ref)
    n, calls = 512, 24 if m <= 8 else 6
    rng = np.random.default_rng(CASE_SEED + m)
    pool = torch.randint(0, 256, (n, SLAB_BYTES), dtype=torch.uint8,
                         device=device)
    dst = torch.zeros_like(pool)
    src = torch.randint(0, 256, (m, SLAB_BYTES), dtype=torch.uint8,
                        device=device)
    out = torch.empty((m, SLAB_BYTES), dtype=torch.uint8, device=device)
    sets = [rng.permutation(n)[:m].astype(np.int32) for _ in range(calls)]
    dev_sets = [torch.as_tensor(s, dtype=torch.long, device=device)
                for s in sets]
    arms = {
        "gather_chunks": (
            [lambda s=s: K.gather_chunks(pool, s) for s in sets],
            [lambda i=i: gather_chunks_ref(pool, i) for i in dev_sets],
            [lambda i=i: torch.index_select(pool, 0, i, out=out)
             for i in dev_sets]),
        "scatter_chunks": (
            [lambda s=s: K.scatter_chunks(dst, src, s) for s in sets],
            [lambda i=i: scatter_chunks_ref(dst, src, i) for i in dev_sets],
            [lambda i=i: dst.index_copy_(0, i, src) for i in dev_sets]),
    }
    nbytes = 2 * m * SLAB_BYTES
    res = {}
    for name, (kern, plain, lib) in arms.items():
        res[name] = {
            "ms": device_ms(kern), "call_ms": call_ms(kern),
            "plain_ms": device_ms(plain), "library_ms": device_ms(lib),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    return res


# ------------------------------------------------------------ phase 4 ---
# Edges of the paper's DRIVING (sequence) and TRAFFIC (condition, 64 MB
# fan-out) workflows, as ``serving/workflow.py`` of the JAX package
# defines them; GPU stages placed one per card of the simulated DGX.
DRIVING = (("decode", "host"), ("denoise", "gpu0"), ("yolo_seg", "gpu1"),
           ("blur", "gpu2"))
DRIVING_MB = 128.0
TRAFFIC_IN_MB, TRAFFIC_PRE_MB, TRAFFIC_DET_MB = 96.0, 96.0, 64.0


def workflows(backend_arg, check_bytes):
    """Replay both workflows through the facade's store/fetch/put/consume.
    Returns (simulated trace, tube).  ``check_bytes(tube, data_id,
    endpoint, size_mb)`` runs after every landed edge when a backend is
    armed."""
    from repro_torch.core.api import FAASTUBE, FaaSTube
    from repro_torch.core.topology import dgx_v100
    tube = FaaSTube(dgx_v100(), FAASTUBE, backend=backend_arg)
    trace = []

    def edge(func, did, dst, mb):
        tube.fetch(func, did, dst, tube.sim.now,
                   on_ready=lambda s, t: trace.append((did, dst, t)))
        tube.sim.run()
        if tube.backend is not None:
            check_bytes(tube, did, dst, mb)

    def out(func, did, dev, mb):
        tube.store(func, did, mb, dev, tube.sim.now,
                   on_ready=lambda s, t: trace.append((did, dev, t)))
        tube.sim.run()

    # DRIVING: 128 MB input host -> denoise, two 128 MB g2g edges, and
    # blur's 128 MB result back to the host
    (_, host), (f1, g1), (f2, g2), (f3, g3) = DRIVING
    tube.store("decode", "drv_in", DRIVING_MB, host, 0.0)
    edge(f1, "drv_in", g1, DRIVING_MB)
    tube.consume("drv_in", g1, tube.sim.now)
    out(f1, "drv_denoise", g1, DRIVING_MB)
    edge(f2, "drv_denoise", g2, DRIVING_MB)
    tube.consume("drv_denoise", g2, tube.sim.now)
    out(f2, "drv_seg", g2, DRIVING_MB)
    edge(f3, "drv_seg", g3, DRIVING_MB)
    tube.consume("drv_seg", g3, tube.sim.now)
    out(f3, "drv_out", g3, DRIVING_MB)
    tube.put(f3, g3, DRIVING_MB, tube.sim.now, data_id="drv_out",
             on_done=lambda s, tr: trace.append(("drv_out", "host", s.now)))
    tube.sim.run()
    if tube.backend is not None:
        check_bytes(tube, "drv_out", "host", DRIVING_MB)

    # TRAFFIC: 96 MB input host -> preproc, 96 MB preproc -> yolo_det,
    # and yolo_det's 64 MB fanned out to both resnets
    tube.store("decode", "trf_in", TRAFFIC_IN_MB, "host", tube.sim.now)
    edge("preproc", "trf_in", "gpu3", TRAFFIC_IN_MB)
    tube.consume("trf_in", "gpu3", tube.sim.now)
    out("preproc", "trf_pre", "gpu3", TRAFFIC_PRE_MB)
    edge("yolo_det", "trf_pre", "gpu4", TRAFFIC_PRE_MB)
    tube.consume("trf_pre", "gpu4", tube.sim.now)
    out("yolo_det", "trf_det", "gpu4", TRAFFIC_DET_MB)
    edge("resnet_ped", "trf_det", "gpu5", TRAFFIC_DET_MB)
    edge("resnet_veh", "trf_det", "gpu6", TRAFFIC_DET_MB)
    tube.consume("trf_det", "gpu6", tube.sim.now)
    trace.append(("end", "", tube.sim.now))
    return trace, tube


# ------------------------------------------------------------ phase 5 ---
def plan_matrix(backend, check_bytes, say):
    """The nine plan kinds x both staging modes at SIZE_MB."""
    from repro_torch.core.linksim import LinkSim
    from repro_torch.core.pathfinder import PathFinder
    from repro_torch.core.pinned_buffer import CircularPinnedBuffer
    from repro_torch.core.topology import cluster, dgx_v100
    from repro_torch.core.transfer import (
        CUT_THROUGH, STORE_FORWARD, TransferEngine)
    matrix = {
        "h2g": (dgx_v100, "h2g", "host", "gpu1", {}),
        "g2h": (dgx_v100, "g2h", "gpu1", "host", {}),
        "g2g_direct": (dgx_v100, "g2g", "gpu0", "gpu1", {"g2g": "direct"}),
        "g2g_striped": (dgx_v100, "g2g", "gpu0", "gpu5",
                        {"g2g": "multipath"}),
        "g2g_host": (dgx_v100, "g2g", "gpu0", "gpu4", {"g2g": "host"}),
        "internode": (lambda: cluster(2), "internode", "n0:gpu0",
                      "n1:gpu1", {}),
        "spill": (dgx_v100, "spill", "gpu1", "host", {}),
        "reload": (dgx_v100, "reload", "host", "gpu3", {}),
        "h2h": (lambda: cluster(2), "h2h", "n0:host", "n1:host", {}),
    }
    window_mb = backend.batch_chunks * 2.0
    for case in sorted(matrix):
        topo_fn, kind, src, dst, kw = matrix[case]
        for staging in (CUT_THROUGH, STORE_FORWARD):
            topo = topo_fn()
            eng = TransferEngine(LinkSim(topo), PathFinder(topo),
                                 CircularPinnedBuffer(), topo,
                                 staging=staging, **kw)
            did = f"{case}-{staging}"
            plan = eng.compile(kind, "smoke", src, dst, SIZE_MB,
                               data_id=did)
            backend.put_object(did, src, size_mb=SIZE_MB)
            rep = backend.execute(plan)
            check_bytes(backend, did, dst, SIZE_MB)
            check_bytes(backend, did, src, SIZE_MB)
            mbs = [mb for mb, _ in rep.events]
            check(mbs[-1] == SIZE_MB and mbs == sorted(mbs)
                  and all(mb % window_mb == 0 for mb in mbs[:-1]),
                  f"{did}: progress {mbs}")
            if len(plan.hops) > 1 and staging == STORE_FORWARD:
                # every intermediate host holds the whole object
                check(rep.peak_staging_mb == SIZE_MB * (len(plan.hops) - 1),
                      f"{did}: store-forward staged {rep.peak_staging_mb}")
            else:
                check(rep.peak_staging_mb <= window_mb,
                      f"{did}: cut-through staged {rep.peak_staging_mb}")
            say(f"  {did:28s} hops={len(plan.hops)} "
                f"batches={rep.n_batches} stripes={rep.stripes} "
                f"peak_staging_mb={rep.peak_staging_mb} "
                f"wall_ms={rep.wall_ms:.3f} "
                f"MB/s={SIZE_MB / rep.wall_ms * 1e3:.1f}")
            backend.drop_object(did)


# ------------------------------------------------------------ phase 6 ---
def spill_reload(backend_arg, check_bytes):
    """Ten 128 MB objects on gpu0 under the default 1024 MB store cap:
    the victims spill their real bytes to the host; the first victim is
    fetched to gpu2 and must arrive intact."""
    from repro_torch.core.api import FAASTUBE, FaaSTube
    from repro_torch.core.topology import dgx_v100
    tube = FaaSTube(dgx_v100(), FAASTUBE, backend=backend_arg)
    ids = [f"sp{i}" for i in range(10)]
    for i, did in enumerate(ids):
        tube.store("prod", did, SIZE_MB, "gpu0", float(i))
    tube.sim.run()
    spilled = [d for d in ids if "host" in tube.backend.where(d)]
    check(spilled, "no object spilled at the 1024 MB store cap")
    victim = spilled[0]
    tube.fetch("cons", victim, "gpu2", tube.sim.now + 1.0)
    tube.sim.run()
    check_bytes(tube, victim, "gpu2", SIZE_MB)
    return tube, spilled


# ------------------------------------------------------------ phase 7 ---
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), for the
#: attention kernels' operation bound
BF16_FLOPS_PER_S = 989e12
#: tolerances of tests/test_kernels.py, by dtype name
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: paged in f32: tests/test_kernels.py's tolerance.  In bf16, row by row:
#: in each output row (sequence, query head) the largest |got - want| is at
#: most 2**-6 of the row's largest |want|, two to four bf16 ulps of it.  A
#: row's values shrink as 1/sqrt(live positions), so test_kernels.py's
#: 3e-2 allclose is about a typical value at 1024 positions and passes a
#: kernel that drops a 64-position tile (PERF.md)
PAGED_F32_TOL = 5e-5
PAGED_BF16_ROW_REL = 2 ** -6
# (B, Hq, Hkv, Lq, Lkv, D, causal, window, q_offset, kv_offset):
# MiniCPM-2B's prefill, a ragged length, GQA with a window, Lkv > Lq, the
# reduced configs' D=16, rows that see no key (Lkv < Lq under a window),
# queries after a cached prefix, kv_offset > q_offset (blind rows),
# GQA group 8 at D=128 with both offsets and a window under one kv tile,
# Whisper-medium's encoder self-attention over its 1500 frames (not
# causal), an attention of 4 queries over those 1500 frames (not causal,
# Lq != Lkv: the shape a cross-attention over Whisper's frames takes,
# although the reference's pattern makes no such layer, ROADMAP.md §3),
# and GQA group 6 at D=128 (Qwen2-VL-2B's 12 query and 2 kv heads).
# ``model_flash_cases`` adds every shape phase 12 launches.
FLASH_CASES = [(8, 36, 36, 1024, 1024, 64, True, 0, 0, 0),
               (8, 36, 36, 1000, 1000, 64, True, 0, 0, 0),
               (2, 8, 2, 512, 512, 128, True, 64, 0, 0),
               (2, 8, 2, 384, 640, 128, True, 0, 0, 0),
               (2, 4, 2, 16, 16, 16, True, 8, 0, 0),
               (1, 4, 2, 100, 70, 32, True, 5, 0, 0),
               (2, 8, 8, 130, 300, 64, True, 0, 170, 0),
               (1, 4, 4, 200, 77, 64, True, 0, 0, 40),
               (2, 16, 2, 300, 333, 128, True, 24, 40, 7),
               (2, 16, 16, 1500, 1500, 64, False, 0, 0, 0),
               (2, 16, 16, 4, 1500, 64, False, 0, 0, 0),
               (2, 12, 2, 2048, 2048, 128, True, 0, 0, 0)]
#: Qwen2-72B's attention heads (configs/qwen2_72b.py: 64 query heads,
#: 8 kv heads of 128) at a 2048-token causal prefill, batch 2: bound by
#: the operations; timed in phase 7, not a model path
QWEN_SHAPE = (2, 64, 8, 2048, 128)
#: the flash kernel timed at two more model shapes, in bf16 (B, Hq, Hkv,
#: L, D, causal): Whisper-medium's encoder over 1500 frames (16 heads of
#: 64, not causal) and Qwen2-VL-2B's prefill (12 query, 2 kv heads of
#: 128, 1024 vision + 1024 text positions), both at phase 12's batch of 8
FLASH_MODEL_SHAPES = {"whisper-medium-encoder": (8, 16, 16, 1500, 64, False),
                      "qwen2-vl-2b": (8, 12, 2, 2048, 128, True)}
# (B, Hkv, group, D, page, NP, P): MiniCPM-2B's decode over 8 pages of 128
# tokens, GQA group 4 at D=128, the reduced configs' D=16, many spans with
# ragged lengths, group 8 at D=128 over many spans, and pages of 8 (eight
# to a 64-position tile); every case also puts one length on a span
# boundary of its plan and one just past it
PAGED_CASES = [(8, 36, 1, 64, 128, 8, 48),
               (4, 8, 4, 128, 128, 4, 12),
               (2, 2, 2, 16, 8, 5, 7),
               (4, 2, 2, 64, 128, 32, 40),
               (3, 2, 8, 128, 128, 16, 20),
               (3, 2, 2, 64, 8, 40, 50)]
# (B, Hkv, group, D, S, pos, window): the decode cell's shape (32
# sessions, MiniCPM-2B's 36/36 heads of 64, a 4096-position cache) at its
# first decode position and at the cache's end, DBRX-132B's 48/8 heads of
# 128, the reduced configs' D=16, groups of 5 and 20 (idle head rows,
# three head groups), a live range off the 64-position tile, a window
DECODE_CASES = [(32, 36, 1, 64, 4096, 1024, 0), (32, 36, 1, 64, 4096, 4095, 0),
                (8, 8, 6, 128, 4096, 4095, 0), (3, 4, 1, 16, 100, 99, 0),
                (2, 2, 5, 32, 300, 150, 0), (2, 1, 20, 128, 257, 256, 0),
                (2, 4, 2, 64, 1000, 700, 129)]
#: decode attention timed in phase 7, bf16: (B, Hkv, group, D, S, pos):
#: the decode cell's shape at the window's first position and at the
#: cache's end, and DBRX-132B's heads at the cache's end
DECODE_TIMED = {"": (32, 36, 1, 64, 4096, 1024),
                "pos4095": (32, 36, 1, 64, 4096, 4095),
                "dbrx-132b": (8, 8, 6, 128, 4096, 4095)}
#: Qwen2-72B's heads (64 query, 8 kv heads of 128) decoding over a
#: 4096-token cache in 32 shuffled pages of 128, batch 8: timed in phase
#: 7, not a model path
QWEN_PAGED = (8, 64, 8, 128, 128, 32)
# The flash backward's odd cases, (B, Hq, Hkv, Lq, Lkv, D, causal, window,
# q_offset, kv_offset): the CPU tests' gradient cases (tests/_flashcases.py)
# spread over the head dims: a ragged Lq, GQA group 6, queries after a
# prefix, a sliding window, not causal, the first 30 rows blind, the last
# rows blind, and a long GQA case at D=128.  ``train_flash_cases()`` and
# ``moe_flash_cases()`` add the training shapes.
FLASH_BWD_CASES = [(2, 4, 4, 200, 200, 64, True, 0, 0, 0),
                   (2, 6, 1, 128, 128, 128, True, 0, 0, 0),
                   (1, 4, 2, 130, 200, 32, True, 0, 70, 0),
                   (1, 4, 2, 100, 200, 16, True, 24, 100, 0),
                   (1, 4, 4, 100, 300, 64, False, 0, 0, 0),
                   (1, 4, 4, 100, 100, 128, True, 0, 0, 30),
                   (1, 4, 4, 100, 60, 64, False, 16, 0, 0),
                   (1, 12, 2, 1000, 1000, 128, True, 0, 0, 0)]
#: the flash backward against its plain version: f32 max abs error; in
#: bf16 each row within 2**-6 of its largest value (PAGED_BF16_ROW_REL's
#: rule)
FLASH_BWD_F32_TOL = 1e-4
#: the forward's statistics against ``attention_stats_ref`` (log-sum-exp,
#: natural log), both dtypes
FLASH_STATS_TOL = 1e-4


def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _agree(got, want, tol) -> bool:
    import torch
    return bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=tol, rtol=tol)


def _row_rel_err(got, want) -> float:
    """The largest, over rows of the last dim, of max|got - want| over
    max|want|."""
    g = got.float().flatten(0, -2)
    w = want.float().flatten(0, -2)
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp_min(1e-30)).max())


def _paged_agree(got, want) -> bool:
    """The paged kernel's limit: PAGED_F32_TOL in f32, PAGED_BF16_ROW_REL
    row by row in bf16."""
    import torch
    if got.dtype == torch.float32:
        return _agree(got, want, PAGED_F32_TOL)
    return bool(torch.isfinite(got).all()) and \
        _row_rel_err(got, want) <= PAGED_BF16_ROW_REL


def _paged_errs(got, want) -> str:
    return (f"max_abs_err {_abs_err(got, want):.3g}, row-relative "
            f"{_row_rel_err(got, want):.3g} (bf16 limit "
            f"{PAGED_BF16_ROW_REL:.3g})")


def model_flash_cases() -> list:
    """The flash shapes that phase 12's generates launch, derived from
    FULL_MODELS and the configs as the prefill runs them: one case
    (B, Hq, Hkv, Lq, Lkv, D, causal, window, 0, 0) for each distinct
    shape over the decoder's attention layers (self-attention over the
    prompt, cross-attention over the encoder frames) and the encoder's."""
    from repro_torch.models.blocks import block_pattern, enc_pattern, kind_meta
    cases = {}
    for arch, n_layers, prompt, _ in FULL_MODELS:
        cfg = full_config(arch, n_layers)
        head = (FULL_BATCH, cfg.n_heads, cfg.n_kv_heads)
        D = cfg.resolved_head_dim
        runs = [(k, prompt) for k in block_pattern(cfg)]
        if cfg.enc_layers:
            runs += [(k, WHISPER_FRAMES) for k in enc_pattern(cfg)]
        for kind, L in runs:
            meta = kind_meta(cfg, kind)
            if meta["mixer"] in RECURRENT_MIXERS:
                continue
            cases[head + (L, L, D, meta["causal"], meta["window"], 0, 0)] = 1
            if meta["cross"]:
                cases[head + (L, WHISPER_FRAMES, D, False, 0, 0, 0)] = 1
    return list(cases)


def train_flash_cases() -> list:
    """The flash shapes of phase 13's full-width training, derived from
    its config as ``loss_fn`` runs them: one microbatch (TRAIN_BATCH /
    TRAIN_ACCUM rows) of TRAIN_SEQ tokens through each distinct kind of
    attention layer."""
    from repro_torch.configs import get_arch
    from repro_torch.models.blocks import block_pattern, kind_meta
    cfg = get_arch(TRAIN_ARCH)
    cases = {}
    for kind in block_pattern(cfg):
        meta = kind_meta(cfg, kind)
        if meta["mixer"] not in RECURRENT_MIXERS:
            cases[(TRAIN_BATCH // TRAIN_ACCUM, cfg.n_heads, cfg.n_kv_heads,
                   TRAIN_SEQ, TRAIN_SEQ, cfg.resolved_head_dim,
                   meta["causal"], meta["window"], 0, 0)] = 1
    return list(cases)


def moe_flash_cases() -> list:
    """The flash shapes of phase 15a's training, derived from its config
    as ``loss_fn`` runs them (``train_flash_cases``' rule)."""
    from repro_torch.models.blocks import block_pattern, kind_meta
    cfg = moe_config()
    cases = {}
    for kind in block_pattern(cfg):
        meta = kind_meta(cfg, kind)
        if meta["mixer"] not in RECURRENT_MIXERS:
            cases[(MOE_BATCH // MOE_ACCUM, cfg.n_heads, cfg.n_kv_heads,
                   MOE_SEQ, MOE_SEQ, cfg.resolved_head_dim,
                   meta["causal"], meta["window"], 0, 0)] = 1
    return list(cases)


def mesh_serve_flash_cases() -> list:
    """The flash shapes of phase 16's prefills, derived from MESH_SERVE
    and the configs: on a mesh of one rank the kernel runs every head, so
    each is the model's whole prefill shape (``model_flash_cases``'
    rule)."""
    from repro_torch.models.blocks import block_pattern, kind_meta
    cases = {}
    for _, arch, n_layers, B, L, _ in MESH_SERVE:
        cfg = full_config(arch, n_layers)
        for kind in block_pattern(cfg):
            meta = kind_meta(cfg, kind)
            if meta["mixer"] not in RECURRENT_MIXERS:
                cases[(B, cfg.n_heads, cfg.n_kv_heads, L, L,
                       cfg.resolved_head_dim, meta["causal"],
                       meta["window"], 0, 0)] = 1
    return list(cases)


def attention_cases() -> dict:
    """The attention kernels against their plain versions at every case
    (FLASH_CASES, ``model_flash_cases()``, ``train_flash_cases()``,
    ``moe_flash_cases()`` and ``mesh_serve_flash_cases()`` for flash;
    DECODE_CASES for decode attention, against the plain version over the
    whole padded cache), f32 and bf16.  Returns the largest absolute
    difference per kernel and dtype, and the paged and decode kernels'
    largest row-relative one in bf16 under (name, "bfloat16
    row-relative")."""
    import torch
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(CASE_SEED)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).removeprefix("torch.")
        for case in (FLASH_CASES + model_flash_cases() + train_flash_cases()
                     + moe_flash_cases() + mesh_serve_flash_cases()):
            B, Hq, Hkv, Lq, Lkv, D, causal, window, q_off, kv_off = case
            kw = dict(causal=causal, window=window, q_offset=q_off,
                      kv_offset=kv_off)
            q = _rand((B, Hq, Lq, D), dt, gen)
            k = _rand((B, Hkv, Lkv, D), dt, gen)
            v = _rand((B, Hkv, Lkv, D), dt, gen)
            got = FK.flash_attention(q, k, v, **kw)
            want = attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            case = case + (name,)
            check(_agree(got, want, FLASH_TOL[name]),
                  f"flash_attention != plain at {case}: "
                  f"{_abs_err(got, want)}")
            key = ("flash_attention", name)
            worst[key] = max(worst.get(key, 0.0), _abs_err(got, want))
        for B, Hkv, G, D, page, NP, P in PAGED_CASES:
            q = _rand((B, Hkv * G, D), dt, gen)
            kp = _rand((P, page, Hkv, D), dt, gen)
            vp = _rand((P, page, Hkv, D), dt, gen)
            # fewer physical pages than table entries: ids repeat
            table = torch.randint(0, P, (B, NP), generator=gen, device="cuda",
                                  dtype=torch.int32)
            lens = torch.randint(1, NP * page + 1, (B,), generator=gen,
                                 device="cuda", dtype=torch.int32)
            span = PK.split_plan(B, Hkv, NP, page, D,
                                 PK.resident_slots(D, q.device.index))[0]
            lens[0] = NP * page
            lens[1] = min(span, NP * page)     # on a span boundary
            if B > 2:
                lens[2] = min(span + 1, NP * page)
            lens[-1] = 0                       # no live position
            got = PK.paged_attention(q, kp, vp, table, lens)
            want = paged_attention_ref(q, kp, vp, table, lens)
            torch.cuda.synchronize()
            case = (B, Hkv, G, D, page, NP, P, name)
            check(_paged_agree(got, want),
                  f"paged_attention != plain at {case}: "
                  f"{_paged_errs(got, want)}")
            key = ("paged_attention", name)
            worst[key] = max(worst.get(key, 0.0), _abs_err(got, want))
            if dt == torch.bfloat16:
                key = ("paged_attention", "bfloat16 row-relative")
                worst[key] = max(worst.get(key, 0.0),
                                 _row_rel_err(got, want))
        for case in DECODE_CASES:
            B, Hkv, G, D, S, pos, window = case
            q = _rand((B, Hkv * G, 1, D), dt, gen)
            k = _rand((B, Hkv, S, D), dt, gen)
            v = _rand((B, Hkv, S, D), dt, gen)
            got = decode_ops.attention(q, k, v, pos, window=window)
            want = decode_attention_ref(q, k, v, pos, window=window)
            torch.cuda.synchronize()
            check(_paged_agree(got, want),
                  f"decode_attention != plain at {case + (name,)}: "
                  f"{_paged_errs(got, want)}")
            key = ("decode_attention", name)
            worst[key] = max(worst.get(key, 0.0), _abs_err(got, want))
            if dt == torch.bfloat16:
                key = ("decode_attention", "bfloat16 row-relative")
                worst[key] = max(worst.get(key, 0.0),
                                 _row_rel_err(got, want))
    return worst


def flash_bwd_cases() -> dict:
    """The flash backward against its plain version at FLASH_BWD_CASES
    and the training shapes (``train_flash_cases()``,
    ``moe_flash_cases()``), f32 and bf16: the forward's statistics
    against ``attention_stats_ref`` (a row that sees no key exactly
    NEG_INF), then ``flash_attention_bwd`` against
    ``attention_bwd_from_stats_ref`` on the same statistics.  Returns the
    largest absolute difference by dtype, and in bf16 the largest
    row-relative one under ("flash_attention_bwd", "bfloat16
    row-relative")."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        NEG_INF, attention_bwd_from_stats_ref, attention_stats_ref)
    gen = torch.Generator(device="cuda").manual_seed(CASE_SEED + 2)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).removeprefix("torch.")
        for case in FLASH_BWD_CASES + train_flash_cases() + moe_flash_cases():
            B, Hq, Hkv, Lq, Lkv, D, causal, window, q_off, kv_off = case
            kw = dict(causal=causal, window=window, q_offset=q_off,
                      kv_offset=kv_off)
            q, do = (_rand((B, Hq, Lq, D), dt, gen) for _ in range(2))
            k, v = (_rand((B, Hkv, Lkv, D), dt, gen) for _ in range(2))
            _, stats = FK.flash_attention(q, k, v, return_stats=True, **kw)
            want = attention_stats_ref(q, k, **kw)
            blind = want == NEG_INF
            torch.cuda.synchronize()
            err = _abs_err(stats[~blind], want[~blind])
            check(torch.equal(stats == NEG_INF, blind)
                  and err <= FLASH_STATS_TOL,
                  f"flash statistics != plain at {case + (name,)}: {err}")
            got = FK.flash_attention_bwd(q, k, v, do, stats, **kw)
            plain = attention_bwd_from_stats_ref(q, k, v, do, stats, **kw)
            torch.cuda.synchronize()
            for part, g, w in zip(("dq", "dk", "dv"), got, plain):
                ok = bool(torch.isfinite(g).all()) and (
                    _abs_err(g, w) <= FLASH_BWD_F32_TOL
                    if dt == torch.float32
                    else _row_rel_err(g, w) <= PAGED_BF16_ROW_REL)
                check(ok, f"flash_attention_bwd {part} != plain at "
                      f"{case + (name,)}: max_abs_err {_abs_err(g, w):.3g}, "
                      f"row-relative {_row_rel_err(g, w):.3g}")
                key = ("flash_attention_bwd", name)
                worst[key] = max(worst.get(key, 0.0), _abs_err(g, w))
                if dt == torch.bfloat16:
                    key = ("flash_attention_bwd", "bfloat16 row-relative")
                    worst[key] = max(worst.get(key, 0.0), _row_rel_err(g, w))
            del q, k, v, do, stats, got, plain
    return worst


def flash_work(B, Hq, Hkv, Lq, Lkv, D, causal, window, itemsize):
    """(bytes, flops) the function needs: q, k, v read once and o written
    once; 4*D flops for each (query, key) pair that the masks keep."""
    i = np.arange(Lq)
    hi = np.minimum(i, Lkv - 1) if causal else np.full(Lq, Lkv - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Lq, int)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    nbytes = (2 * B * Hq * Lq * D + 2 * B * Hkv * Lkv * D) * itemsize
    return nbytes, 4 * B * Hq * D * pairs


def paged_work(q, k_pages, table, lens):
    """(bytes, flops) the function needs for this table and these
    lengths: each physical page a live position reads, K and V, once;
    q read and o written once; 4*D flops per (query head, live position)."""
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    tab = table.cpu().numpy()
    lens = lens.cpu().numpy()
    pages, live = set(), 0
    for b in range(B):
        n = int(min(max(lens[b], 0), tab.shape[1] * page))
        live += n
        pages.update(int(x) for x in tab[b, :-(-n // page)])  # ceil(n/page)
    nbytes = (2 * len(pages) * page * Hkv * D + 2 * B * Hq * D) \
        * q.element_size() + table.numel() * 4 + B * 4
    return nbytes, 4 * Hq * D * live


def flash_times(B, Hq, Hkv, L, D, gen, causal: bool = True) -> dict:
    """The flash kernel, its plain version and SDPA (``enable_gqa``) at
    one bf16 shape, with the bytes and flops the function needs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    bf = torch.bfloat16
    q = _rand((B, Hq, L, D), bf, gen)
    k, v = (_rand((B, Hkv, L, D), bf, gen) for _ in range(2))
    nbytes, flops = flash_work(B, Hq, Hkv, L, L, D, causal, 0, 2)
    heads = f"Hq=Hkv={Hq}" if Hq == Hkv else f"Hq={Hq} Hkv={Hkv}"
    return {
        "ms": device_ms([lambda: FK.flash_attention(q, k, v,
                                                    causal=causal)] * 2),
        "plain_ms": device_ms([lambda: attention_ref(q, k, v,
                                                     causal=causal)]),
        "library_ms": device_ms([lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=Hq != Hkv)] * 2),
        "bytes": nbytes, "flops": flops,
        "shape": f"B={B} {heads} Lq=Lkv={L} D={D} "
                 f"{'causal' if causal else 'not causal'} bf16"}


#: eager calls a shape that ``bwd_profile_child`` profiles
BWD_PROFILE_CALLS = 4
#: a flash backward kernel's device event: its name and head dim
BWD_KERNEL_NAME = re.compile(r"::(bwd_\w+)<(\d+)>")


def flash_bwd_times(B, Hq, Hkv, L, D, gen, causal: bool = True) -> dict:
    """The flash backward at one bf16 shape: the call (CUDA graph replay),
    the bytes of its dQ scratch (each kernel's device time comes from
    ``bwd_profile_child``);
    its plain version (``attention_bwd_from_stats_ref``), the plain
    backward it replaces on the training path (``attention_bwd_ref``) and
    SDPA's backward alone (``enable_gqa``; one forward outside the
    timing, then ``autograd.grad`` with ``retain_graph``), the last three
    timed as eager calls with CUDA events.  The work: q, k, v, dO and the
    statistics read once, dq, dk, dv written once; five products, 10 D
    flops a (query, key) pair the masks keep."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_from_stats_ref, attention_bwd_ref)
    bf = torch.bfloat16
    q, do = (_rand((B, Hq, L, D), bf, gen) for _ in range(2))
    k, v = (_rand((B, Hkv, L, D), bf, gen) for _ in range(2))
    _, stats = FK.flash_attention(q, k, v, causal=causal, return_stats=True)
    _, fwd_flops = flash_work(B, Hq, Hkv, L, L, D, causal, 0, 2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=Hq != Hkv)

    def warm_ms(fn, n):
        fn()
        return call_ms([fn] * n)
    heads = f"Hq=Hkv={Hq}" if Hq == Hkv else f"Hq={Hq} Hkv={Hkv}"
    res = {
        "ms": device_ms([lambda: FK.flash_attention_bwd(
            q, k, v, do, stats, causal=causal)] * 2),
        "dq_scratch_bytes": FK.dq_scratch_bytes(q),
        "plain_ms": warm_ms(lambda: attention_bwd_from_stats_ref(
            q, k, v, do, stats, causal=causal), 1),
        "attention_bwd_ref_ms": warm_ms(lambda: attention_bwd_ref(
            q, k, v, do, causal=causal), 1),
        "library_ms": warm_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 3),
        "bytes": (3 * B * Hq + 4 * B * Hkv) * L * D * 2 + B * Hq * L * 4,
        "flops": fwd_flops * 5 // 2,
        "shape": f"B={B} {heads} Lq=Lkv={L} D={D} "
                 f"{'causal' if causal else 'not causal'} bf16"}
    del out, leaves
    return res


def bwd_profile_child() -> None:
    """Each kernel of the flash backward at phases 13's and 15's training
    shapes, in a process of its own (the card's tracer records kernels in
    a process's first profiler session only, and 13c's is the parent's):
    BWD_PROFILE_CALLS eager calls at each shape under ``torch.profiler``,
    the device events of each backward kernel instance by name (the two
    shapes differ in head dim, so in instance), their mean device ms a
    call; prints {shape: {kernel: ms}} as JSON on its last line."""
    import os
    import tempfile
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.profile_serve import DEVICE_CATS
    gen = torch.Generator(device="cuda").manual_seed(CASE_SEED + 2)
    shapes = {"flash_attention_bwd": train_flash_cases()[0],
              f"flash_attention_bwd/{MOE_ARCH}-train": moe_flash_cases()[0]}
    check(len({c[5] for c in shapes.values()}) == len(shapes),
          f"the backward's timed shapes share a head dim: {shapes}")
    calls = {}
    for name, (B, Hq, Hkv, L, _, D, causal, _, _, _) in shapes.items():
        q, do = (_rand((B, Hq, L, D), torch.bfloat16, gen) for _ in range(2))
        k, v = (_rand((B, Hkv, L, D), torch.bfloat16, gen) for _ in range(2))
        _, stats = FK.flash_attention(q, k, v, causal=causal,
                                      return_stats=True)
        calls[name] = (D, lambda t=(q, k, v, do, stats), c=causal:
                       FK.flash_attention_bwd(*t, causal=c))
        calls[name][1]()                              # warm
    torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _, fn in calls.values():
                for _ in range(BWD_PROFILE_CALLS):
                    fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            dev = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    finally:
        os.unlink(path)
    rep = {}
    for name, (D, _) in calls.items():
        rep[name] = {}
        for e in dev:
            m = BWD_KERNEL_NAME.search(e["name"])
            if m and int(m.group(2)) == D:
                rep[name][m.group(1)] = rep[name].get(m.group(1), 0.0) + \
                    e["dur"] / 1e3 / BWD_PROFILE_CALLS
        check(set(rep[name]) == set(FK.BWD_KERNELS[torch.bfloat16]),
              f"{name}: the profile holds {rep[name]}, not each of "
              f"{FK.BWD_KERNELS[torch.bfloat16]}")
    print(json.dumps(rep))


def paged_times(B, Hq, Hkv, D, page, NP, gen) -> dict:
    """The paged kernel and its plain version at one bf16 decode shape
    (every sequence full, its pages shuffled), with the bytes and flops
    the function needs; also with the L2 evicted before every call, and
    SDPA (``enable_gqa``) over the same K/V as a contiguous (B, Hkv, L, D)
    cache: a yardstick without the gather, not a call that computes the
    same function, so not ``library_ms``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    bf = torch.bfloat16
    L = NP * page
    kp, vp = (_rand((B * NP, page, Hkv, D), bf, gen) for _ in range(2))
    table = torch.randperm(B * NP, device="cuda", generator=gen) \
        .to(torch.int32).view(B, NP)
    lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
    q = _rand((B, Hq, D), bf, gen)
    k, v = (x[table.long()].reshape(B, L, Hkv, D).transpose(1, 2).contiguous()
            for x in (kp, vp))
    sdpa = F.scaled_dot_product_attention(q[:, :, None], k, v,
                                          enable_gqa=Hq != Hkv)[:, :, 0]
    got = PK.paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    check(_paged_agree(got, sdpa),
          f"paged_attention != SDPA on the contiguous cache at "
          f"{(B, Hq, Hkv, D, page, NP)}: {_paged_errs(got, sdpa)}")
    nbytes, flops = paged_work(q, kp, table, lens)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kern = lambda: PK.paged_attention(q, kp, vp, table, lens)  # noqa: E731
    evict = device_ms([lambda: flush.fill_(1)] * 4)
    heads = f"Hq=Hkv={Hq}" if Hq == Hkv else f"Hq={Hq} Hkv={Hkv}"
    return {
        "ms": device_ms([kern] * 4),
        "l2_evicted_ms": device_ms([lambda: flush.fill_(1), kern] * 4) * 2
        - evict,
        "plain_ms": device_ms([lambda: paged_attention_ref(
            q, kp, vp, table, lens)]),
        "library_ms": None,
        "contiguous_sdpa_ms": device_ms([lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, enable_gqa=Hq != Hkv)] * 4),
        "split_plan": PK.split_plan(B, Hkv, NP, page, D,
                                    PK.resident_slots(D, q.device.index)),
        "sdpa_row_rel_err": _row_rel_err(got, sdpa),
        "bytes": nbytes, "flops": flops,
        "shape": f"B={B} {heads} D={D} {NP} shuffled pages of {page} "
                 f"tokens, seq_len {L}, bf16"}


def decode_times(B, Hkv, G, D, S, pos, gen) -> dict:
    """Decode attention at one bf16 shape over positions ``[0, pos]`` of an
    S-position cache: the call (both kernels and the softmax between
    them), each pass alone, the plain version over the whole padded cache
    it replaced, and SDPA over the live positions (``library_ms``, a
    yardstick only: the port never calls it), with the bytes and flops
    the function needs (every live K and V byte read once)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    bf = torch.bfloat16
    Hq, n = Hkv * G, pos + 1
    q = _rand((B, Hq, 1, D), bf, gen)
    k, v = (_rand((B, Hkv, S, D), bf, gen) for _ in range(2))
    got = decode_ops.attention(q, k, v, pos)
    sdpa = F.scaled_dot_product_attention(q, k[:, :, :n], v[:, :, :n],
                                          enable_gqa=Hq != Hkv)
    torch.cuda.synchronize()
    check(_paged_agree(got, sdpa),
          f"decode_attention != SDPA over the live positions at "
          f"{(B, Hkv, G, D, S, pos)}: {_paged_errs(got, sdpa)}")
    scores = DK.decode_scores(q, k, 0, pos)
    p = torch.softmax(scores, dim=-1)
    slots = {kern: DK.resident_slots(kern, D, DK.group_block(G),
                                     q.device.index) for kern in DK.KERNELS}
    kern = lambda: decode_ops.attention(q, k, v, pos)  # noqa: E731
    heads = f"Hq=Hkv={Hq}" if Hq == Hkv else f"Hq={Hq} Hkv={Hkv}"
    return {
        "ms": device_ms([kern] * 4),
        "call_ms": call_ms([kern] * 8),
        "passes_ms": {
            "decode_scores": device_ms([lambda: DK.decode_scores(
                q, k, 0, pos)] * 4),
            "softmax": device_ms([lambda: torch.softmax(scores, -1)] * 4),
            "decode_values": device_ms([lambda: DK.decode_values(
                p, v, 0, bf)] * 4)},
        "plain_ms": device_ms([lambda: decode_attention_ref(q, k, v, pos)]),
        "library_ms": device_ms([lambda: F.scaled_dot_product_attention(
            q, k[:, :, :n], v[:, :, :n], enable_gqa=Hq != Hkv)] * 4),
        "split_plan": {kn: DK.split_plan(B * Hkv * -(-G // DK.group_block(G)),
                                         n, D, 2, slots[kn])
                       for kn in DK.KERNELS},
        "sdpa_row_rel_err": _row_rel_err(got, sdpa),
        "bytes": (2 * B * Hkv * n * D + 2 * B * Hq * D) * 2,
        "flops": 4 * B * Hq * D * n,
        "shape": f"B={B} {heads} D={D}, positions 0..{pos} of a {S}-position "
                 f"cache, bf16"}


def attention_times() -> dict:
    """Device times in bf16 (CUDA graph replay, CUDA events) at
    MiniCPM-2B's prefill and decode shapes, at Qwen2-72B's heads and
    (flash) at FLASH_MODEL_SHAPES, phases 13's and 15's training shapes
    and phase 16's prefills other than MiniCPM-2B's, beside the bound, the plain version and the library call
    (SDPA for flash and, over the live positions, for decode attention;
    paged attention has no single PyTorch call); decode attention at
    DECODE_TIMED's shapes; the
    flash backward at phases 13's and 15's training shapes
    (``flash_bwd_times``, each kernel's time from ``bwd_profile_child``)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(CASE_SEED + 1)
    B, H, L, D = 8, 36, 1024, 64
    B_q, Hq_q, Hkv_q, D_q, page_q, NP_q = QWEN_PAGED
    (B_t, Hq_t, Hkv_t, L_t, _, D_t, c_t, _, _, _), = train_flash_cases()
    (B_m, Hq_m, Hkv_m, L_m, _, D_m, c_m, _, _, _), = moe_flash_cases()
    res = {"flash_attention": flash_times(B, H, H, L, D, gen),
           f"flash_attention/{TRAIN_ARCH}-train": flash_times(
               B_t, Hq_t, Hkv_t, L_t, D_t, gen, causal=c_t),
           f"flash_attention/{MOE_ARCH}-train": flash_times(
               B_m, Hq_m, Hkv_m, L_m, D_m, gen, causal=c_m),
           "flash_attention/qwen2-72b": flash_times(*QWEN_SHAPE, gen),
           **{f"flash_attention/{name}": flash_times(
               B_m, Hq_m, Hkv_m, L_m, D_m, gen, causal=c)
              for name, (B_m, Hq_m, Hkv_m, L_m, D_m, c)
              in FLASH_MODEL_SHAPES.items()},
           **{f"flash_attention/phase16-B{B_s}-L{L_s}-H{Hq_s}-{Hkv_s}-D{D_s}":
              flash_times(B_s, Hq_s, Hkv_s, L_s, D_s, gen, causal=c_s)
              for B_s, Hq_s, Hkv_s, L_s, _, D_s, c_s, _, _, _
              in mesh_serve_flash_cases()
              if (B_s, Hq_s, Hkv_s, L_s, D_s) != (B, H, H, L, D)},
           "paged_attention": paged_times(B, H, H, D, 128, L // 128, gen),
           "paged_attention/qwen2-72b": paged_times(
               B_q, Hq_q, Hkv_q, D_q, page_q, NP_q, gen),
           **{"decode_attention" + (f"/{k}" if k else ""): decode_times(
               *shape, gen) for k, shape in DECODE_TIMED.items()},
           "flash_attention_bwd": flash_bwd_times(
               B_t, Hq_t, Hkv_t, L_t, D_t, gen, causal=c_t),
           f"flash_attention_bwd/{MOE_ARCH}-train": flash_bwd_times(
               B_m, Hq_m, Hkv_m, L_m, D_m, gen, causal=c_m)}
    for name, kernels in child_report(lambda *a: None,
                                      "bwd_profile_child").items():
        res[name]["kernels_ms"] = kernels
    for r in res.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / BF16_FLOPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


# ------------------------------------------------------------ phase 8 ---
#: reduced f32 prefill logits, card (kernels) against CPU (plain
#: versions), same weights: summation order only, logits of order 3
REDUCED_TOL = 1e-4
#: xLSTM-1.3B's bound instead: its exponential gating amplifies the
#: order of f32 sums (tests/test_consistency.py holds it LOOSE); on the
#: CPU the port differs from the JAX package by at most 1.0e-4 on its
#: logits (tests/test_torch_xlstm.py), and the card's summation order is
#: a third one
REDUCED_TOL_XLSTM = 1e-3
#: phase 8's architectures: the four attention kinds' representatives
#: and the six other families (Grok-1-314B takes DBRX's MoE path and runs
#: here only)
REDUCED_ARCHS = ("minicpm-2b", "gemma3-27b", "qwen2-vl-2b", "whisper-medium",
                 "dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b",
                 "xlstm-1.3b")


#: the mixers that run no attention
RECURRENT_MIXERS = ("mamba", "mlstm", "slstm")


def attention_layers(cfg) -> int:
    """Layers whose prefill runs the flash kernel once: every attention
    mixer of the decoder, and every encoder layer.  (The JAX package's
    ``block_pattern`` makes no decoder layer ``dec_attn``, so Whisper's
    decoder runs no cross-attention: ROADMAP.md §3.)"""
    from repro_torch.models.blocks import block_pattern, kind_meta
    return cfg.enc_layers + sum(
        kind_meta(cfg, k)["mixer"] not in RECURRENT_MIXERS
        for k in block_pattern(cfg))


def reduced_serving(say) -> float:
    """``Engine.generate`` on every family reduced, in f32, on the card
    and on the CPU with the same weights (made on the CPU, then copied)
    and the same inputs (``io.synthetic_batch``, cast to f32): prefill
    logits within REDUCED_TOL (xLSTM: REDUCED_TOL_XLSTM), greedy tokens
    equal, and one flash launch per attention layer in each prefill."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import io
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.serving.engine import Engine
    worst = 0.0
    for arch in REDUCED_ARCHS:
        cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
        host = PM.tree_map(lambda t: t.float(),
                           M.init_params(cfg, CASE_SEED, "cpu"))
        card = PM.tree_map(lambda t: t.to("cuda"), host)
        batch = io.synthetic_batch(cfg, ShapeSpec("t", 16, 2, "train"),
                                   CASE_SEED, "cpu")
        batch = {k: v.float() if v.is_floating_point() else v
                 for k, v in batch.items()}
        shape = ShapeSpec("serve", 24, 2, "decode")
        runs, enc = {}, {}
        for device, params in (("cpu", host), ("cuda", card)):
            before = FK.flash_attention.launches
            eng = Engine(cfg, shape, params, device=device)
            logits, _ = eng.prefill(batch)
            out, _ = eng.generate(batch, max_new_tokens=8)
            runs[device] = (logits.cpu(), out.cpu(),
                            FK.flash_attention.launches - before)
            if cfg.enc_layers:
                # the decoder reads no encoder output (no dec_attn layer):
                # hold the encoder itself
                enc[device] = M._run_encoder(
                    cfg, eng.ctx, params, batch["frames"].to(device)).cpu()
        err = _abs_err(runs["cuda"][0], runs["cpu"][0])
        tol = REDUCED_TOL_XLSTM if arch == "xlstm-1.3b" else REDUCED_TOL
        check(err <= tol, f"{arch} reduced: prefill logits differ by {err}")
        enc_note = ""
        if enc:
            enc_err = _abs_err(enc["cuda"], enc["cpu"])
            check(enc_err <= REDUCED_TOL, f"{arch} reduced: encoder "
                  f"outputs differ by {enc_err}")
            enc_note = (f", encoder output max_abs_err {enc_err:.3g} "
                        f"(limit {REDUCED_TOL:g})")
        check(torch.equal(runs["cuda"][1], runs["cpu"][1]),
              f"{arch} reduced: greedy tokens differ")
        n_attn = attention_layers(cfg)
        check(runs["cpu"][2] == 0 and runs["cuda"][2] == 2 * n_attn,
              f"{arch} reduced: flash launches {runs['cpu'][2]} on the CPU, "
              f"{runs['cuda'][2]} on the card, not 2 x {n_attn}")
        worst = max(worst, err)
        say(f"  {arch} reduced f32 ({cfg.n_layers} layers"
            f"{f' + {cfg.enc_layers} encoder' if cfg.enc_layers else ''}): "
            f"prefill logits max_abs_err {err:.3g} (limit {tol:g})"
            f"{enc_note}, 8 greedy tokens equal, {runs['cuda'][2]} flash launches on the card "
            f"(2 prefills x {n_attn} attention layers)")
    return worst


# ------------------------------------------------------------ phase 9 ---
FULL_BATCH, FULL_PROMPT, FULL_NEW = 8, 1024, 32


def full_width(say) -> dict:
    """``Engine(minicpm-2b)`` at full width in bf16 on the card, through
    ``generate``; prefill and every decode step timed on the host clock
    after a device synchronise.  Then the paged kernel over layer 0's
    prefill cache in shuffled pages, against ``decode_attention``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.models.attention import decode_attention
    from repro_torch.serving.engine import Engine
    cfg = get_arch("minicpm-2b")
    B, L, new = FULL_BATCH, FULL_PROMPT, FULL_NEW
    t0 = time.perf_counter()
    params = M.init_params(cfg, CASE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, ShapeSpec("serve", L + new, B, "decode"), params)
    toks = torch.from_numpy(np.random.default_rng(CASE_SEED).integers(
        0, cfg.vocab_size, (B, L), dtype=np.int32))
    times = {"prefill": [], "decode": []}
    finite = []

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = fn(*args)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            finite.append(torch.isfinite(logits).all())
            return logits, caches
        return run

    eng.prefill = timed("prefill", eng.prefill)
    eng.decode = timed("decode", eng.decode)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, caches = eng.generate({"tokens": toks}, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(tuple(out.shape) == (B, new) and out.dtype == torch.int32,
          f"full width: tokens {tuple(out.shape)} {out.dtype}")
    check(bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          "full width: token ids out of range")
    check(len(finite) == new and all(bool(f) for f in finite),
          "full width: non-finite logits")
    # the paged kernel over the engine's own cache: layer 0's prefill K/V,
    # cut into 128-token pages stored in a shuffled physical order
    H, D, page = cfg.n_kv_heads, cfg.resolved_head_dim, 128
    k0 = caches["units"][0]["k"][0, 0, :, :, :L]          # (B, H, L, D)
    v0 = caches["units"][0]["v"][0, 0, :, :, :L]
    n = B * (L // page)
    gen = torch.Generator(device="cuda").manual_seed(CASE_SEED + 9)
    perm = torch.randperm(n, device="cuda", generator=gen)
    kp = k0.permute(0, 2, 1, 3).reshape(n, page, H, D)[perm].contiguous()
    vp = v0.permute(0, 2, 1, 3).reshape(n, page, H, D)[perm].contiguous()
    table = torch.argsort(perm).to(torch.int32).view(B, L // page)
    lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
    q = _rand((B, cfg.n_heads, D), torch.bfloat16, gen)
    got = paged_ops.attention(q, kp, vp, table, lens)
    want = decode_attention(q[:, :, None], k0.contiguous(), v0.contiguous(),
                            L - 1)[:, :, 0]
    torch.cuda.synchronize()
    paged_err = _abs_err(got, want)
    check(_paged_agree(got, want),
          f"paged_attention over the engine's cache != decode_attention: "
          f"{_paged_errs(got, want)}")
    dec = sorted(times["decode"])
    res = {"params": PM.count_params(M.model_specs(cfg)),
           "init_s": init_s, "prefill_ms": times["prefill"][0] * 1e3,
           "decode_ms_median": dec[len(dec) // 2] * 1e3,
           "decode_ms_mean": sum(dec) / len(dec) * 1e3,
           "decode_tok_s": B * len(dec) / sum(dec),
           "generate_s": wall, "tok_s": B * new / wall,
           "peak_gb": peak / 1e9, "paged_err": paged_err,
           "paged_row_rel_err": _row_rel_err(got, want)}
    say(f"  minicpm-2b full width bf16: {res['params'] / 1e9:.3f} B params "
        f"(init {init_s:.2f} s), {B} x {L} prompt tokens + {new} new: "
        f"prefill {res['prefill_ms']:.2f} ms, decode step median "
        f"{res['decode_ms_median']:.3f} ms (mean {res['decode_ms_mean']:.3f}),"
        f" {res['decode_tok_s']:.1f} decode tok/s, generate {wall:.3f} s = "
        f"{res['tok_s']:.1f} tok/s, peak {res['peak_gb']:.2f} GB")
    say(f"  paged_attention over layer 0's cache in {n} shuffled pages: "
        f"{_paged_errs(got, want)} against decode_attention")
    return res


# ------------------------------------------------------------ phase 12 ---
#: the other families at full width in bf16 through ``Engine.generate``:
#: (arch, layers kept (None: the published depth), prompt tokens, whether
#: to hold 4 decode steps against a teacher-forced prefill).  8 requests,
#: 32 new tokens each.  Qwen2-VL-2B's prompt is 1024 ``vision_embeds``
#: positions then 1024 text tokens; Whisper-medium's is 1500 encoder
#: frames (its 30-s window after the conv stem, arXiv:2212.04356 §2.2)
#: and 4 decoder tokens; DBRX-132B and Jamba-1.5-Large are cut in depth
#: to fit one card (Jamba's first 5 layers: four Mamba, two of them MoE,
#: and the attention layer at index 4)
FULL_MODELS = (("qwen2-vl-2b", None, 2048, True),
               ("whisper-medium", None, 4, True),
               ("xlstm-1.3b", None, 1024, False),
               ("dbrx-132b", 4, 1024, False),
               ("jamba-1.5-large-398b", 5, 1024, False))
WHISPER_FRAMES = 1500
#: tests/test_consistency.py's bf16 production bound on decode logits
#: against a teacher-forced prefill of the same tokens
TF_RELNORM = 0.10
TF_STEPS = 4
#: the same bf16 bound on Whisper's encoder output, flash kernel against
#: the plain attention
ENC_RELNORM = TF_RELNORM


def full_batch(cfg, prompt: int) -> dict:
    """Phase 12's inputs on the card from ``io.synthetic_batch``: tokens,
    and Whisper's frames or Qwen2-VL's vision prefix, in bf16."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import io
    if cfg.enc_layers:
        batch = io.synthetic_batch(
            cfg, ShapeSpec("t", 2 * WHISPER_FRAMES, FULL_BATCH, "prefill"),
            CASE_SEED)
        return dict(batch, tokens=batch["tokens"][:, :prompt].contiguous())
    return io.synthetic_batch(
        cfg, ShapeSpec("t", prompt, FULL_BATCH, "prefill"), CASE_SEED)


def teacher_forced(cfg, eng, batch, forced) -> list:
    """Prefill the prompt, then decode the ``forced`` tokens (B, n) one
    by one; hold each step's logits against the last-position logits of
    a prefill of the prompt and the forced tokens up to that step.
    Returns each step's relnorm ||decode - prefill|| / ||prefill||."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.engine import extend_caches
    prompt = batch["tokens"].shape[1]
    n = forced.shape[1]
    _, caches = M.prefill(cfg, eng.ctx, eng.params, batch)
    caches = extend_caches(cfg, caches, prompt + n)
    rel = []
    for i in range(n):
        lg, caches = M.decode_step(cfg, eng.ctx, eng.params, caches,
                                   forced[:, i:i + 1], prompt + i)
        toks = torch.cat([batch["tokens"], forced[:, :i + 1]], dim=1)
        ref, _ = M.prefill(cfg, eng.ctx, eng.params, dict(batch, tokens=toks))
        rel.append(_relnorm(lg, ref))
    return rel


def _relnorm(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-9))


@contextlib.contextmanager
def plain_attention():
    """Within it, the port's prefill attention on the card takes the
    plain version (``attention_ref``) instead of the kernel: the
    reference side of a check, never a path of the port."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    kernel = ops.attention
    ops.attention = lambda q, k, v, **kw: attention_ref(q, k, v, **kw)
    try:
        yield
    finally:
        ops.attention = kernel


def encoder_relnorm(cfg, eng, frames) -> float:
    """The encoder's output on the card through the flash kernel against
    the same encoder with the plain attention: the decoder reads no
    encoder output (no ``dec_attn`` layer), so no logit reaches it."""
    from repro_torch.models import model as M
    got = M._run_encoder(cfg, eng.ctx, eng.params, frames)
    with plain_attention():
        want = M._run_encoder(cfg, eng.ctx, eng.params, frames)
    return _relnorm(got, want)


def full_config(arch, n_layers):
    """Phase 12's config: the published one, cut to ``n_layers``."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def full_model(arch, n_layers, prompt, teacher, say) -> dict:
    """One model of phase 12 at full width in bf16 on the card: random
    weights from CASE_SEED, ``Engine.generate`` of FULL_NEW tokens for
    FULL_BATCH requests, each prefill and decode step timed on the host
    clock after a device synchronise.  Everything it allocates is freed
    when it returns."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.serving.engine import Engine
    cfg = full_config(arch, n_layers)
    B, new = FULL_BATCH, FULL_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, CASE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    batch = full_batch(cfg, prompt)
    eng = Engine(cfg, ShapeSpec("serve", prompt + new, B, "decode"), params)
    times = {"prefill": [], "decode": []}
    finite = []

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = fn(*args)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits, caches
        return run

    eng.prefill = timed("prefill", eng.prefill)
    eng.decode = timed("decode", eng.decode)
    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention.launches = 0
    t0 = time.perf_counter()
    out, caches = eng.generate(batch, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FK.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    del caches
    check(tuple(out.shape) == (B, new) and out.dtype == torch.int32,
          f"{arch}: tokens {tuple(out.shape)} {out.dtype}")
    check(bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"{arch}: token ids out of range")
    check(len(finite) == new and all(finite), f"{arch}: non-finite logits")
    n_attn = attention_layers(cfg)
    check(launches == n_attn, f"{arch}: {launches} flash launches in the "
          f"generate, not one per attention layer ({n_attn})")
    dec = sorted(times["decode"])
    res = {"layers": cfg.n_layers, "encoder_layers": cfg.enc_layers,
           "params": PM.count_params(M.model_specs(cfg)),
           "prompt": prompt, "init_s": init_s,
           "init_peak_gb": init_peak / 1e9,
           "prefill_ms": times["prefill"][0] * 1e3,
           "decode_ms_median": dec[len(dec) // 2] * 1e3,
           "decode_tok_s": B * len(dec) / sum(dec),
           "generate_s": wall, "tok_s": B * new / wall,
           "peak_gb": peak / 1e9, "flash_launches": launches}
    extra = ""
    if teacher:
        rel = teacher_forced(cfg, eng, batch, out[:, :TF_STEPS])
        check(max(rel) < TF_RELNORM, f"{arch}: decode against the teacher-"
              f"forced prefill, relnorm {rel} (limit {TF_RELNORM})")
        res["tf_relnorm"] = rel
        extra = (f"; {TF_STEPS} decode steps against a teacher-forced "
                 f"prefill: relnorm {max(rel):.4f} (limit {TF_RELNORM})")
    if cfg.enc_layers:
        rel = encoder_relnorm(cfg, eng, batch["frames"])
        check(rel < ENC_RELNORM, f"{arch}: encoder output through the "
              f"kernel against the plain attention, relnorm {rel} (limit "
              f"{ENC_RELNORM})")
        res["encoder_relnorm"] = rel
        extra += (f"; encoder output against the plain attention: relnorm "
                  f"{rel:.4f} (limit {ENC_RELNORM})")
    inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    say(f"  {arch} full width bf16, {cfg.n_layers} layers"
        f"{f' + {cfg.enc_layers} encoder' if cfg.enc_layers else ''}, "
        f"{res['params'] / 1e9:.3f} B params (init {init_s:.2f} s, peak "
        f"{res['init_peak_gb']:.2f} GB), {inputs}, {new} new: prefill "
        f"{res['prefill_ms']:.2f} ms, decode step median "
        f"{res['decode_ms_median']:.3f} ms, {res['decode_tok_s']:.1f} decode "
        f"tok/s, generate {wall:.3f} s = {res['tok_s']:.1f} tok/s, peak "
        f"{res['peak_gb']:.2f} GB, logits finite, ids in range, "
        f"{launches} flash launches{extra}")
    return res


def full_models(say) -> dict:
    """Phase 12: each model in its own call of ``full_model``, so that
    nothing of one is held while the next is made."""
    import gc
    import torch
    out = {}
    for arch, n_layers, prompt, teacher in FULL_MODELS:
        out[arch] = full_model(arch, n_layers, prompt, teacher, say)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 13 ---
#: phase 13's full-width training: MiniCPM-2B as published at its
#: training context (arXiv:2404.06395: 4096 tokens), a global batch of 4
#: sequences in 2 interleaved microbatches, 3 steps
TRAIN_ARCH = "minicpm-2b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 4, 2, 3
#: phase 13b: the loss through the kernel against the plain attention,
#: relative, and the whole-tree gradient's relnorm (the bf16 production
#: bound of tests/test_consistency.py, as for decode in phase 12)
TRAIN_LOSS_REL = 2e-3
GRAD_RELNORM = TF_RELNORM
#: phase 13a: reduced train steps, card against CPU, in f32: 4 sequences
#: of 64 tokens (one Mamba chunk, under one mLSTM chunk) in 2 microbatches
REDUCED_TRAIN_SHAPE = (64, 4)


def _leaf_relnorms(got, want) -> dict:
    """{path: ||got - want|| / ||want||} over two trees' leaves, in f32."""
    from repro_torch.models import param as PM
    return {p: _relnorm(g, w) for (p, g), w in zip(
        PM.tree_leaves_with_paths(got), PM.tree_leaves(want))}


@contextlib.contextmanager
def captured_grads(into: list):
    """Within it, every gradient tree a train step hands to
    ``adamw_update`` is also appended to ``into`` (copied to the host)."""
    from repro_torch.models import param as PM
    from repro_torch.training import train_step as TS
    update = TS.adamw_update

    def wrapped(oc, params, grads, opt_state, *shardings):
        into.append(PM.tree_map(lambda g: g.detach().cpu(), grads))
        return update(oc, params, grads, opt_state, *shardings)
    TS.adamw_update = wrapped
    try:
        yield
    finally:
        TS.adamw_update = update


def reduced_training(say) -> float:
    """Phase 13a: one ``build_train_step`` step with TRAIN_ACCUM
    microbatches of each phase-8 architecture reduced, in f32, on the card
    and on the CPU from the same weights (made on the CPU, then copied)
    and batch: the loss within REDUCED_TOL (xLSTM REDUCED_TOL_XLSTM), each
    leaf's accumulated gradient within the same bound in relnorm, and two
    flash launches (forward, recompute) and one backward launch per
    decoder attention layer and microbatch, one forward launch per
    encoder layer (no loss reads the encoder, so its units are never
    recomputed nor differentiated)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import io
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import build_train_step
    worst = 0.0
    seq, batch_rows = REDUCED_TRAIN_SHAPE
    for arch in REDUCED_ARCHS:
        cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
        host = PM.tree_map(lambda t: t.float(),
                           M.init_params(cfg, CASE_SEED, "cpu"))
        batch = io.synthetic_batch(cfg, ShapeSpec("t", seq, batch_rows,
                                                  "train"), CASE_SEED, "cpu")
        batch = {k: v.float() if v.is_floating_point() else v
                 for k, v in batch.items()}
        runs = {}
        for device in ("cpu", "cuda"):
            params = PM.trainable(PM.tree_map(
                lambda t: t.to(device, copy=True), host))
            opt = init_opt_state(M.model_specs(cfg), "f32", device)
            step = build_train_step(cfg, M.build_ctx(cfg),
                                    OptConfig(schedule=cfg.lr_schedule),
                                    TRAIN_ACCUM)
            grads = []
            before = (FK.flash_attention.launches,
                      FK.flash_attention_bwd.launches)
            with captured_grads(grads):
                _, opt, m = step(params, opt, {k: v.to(device)
                                               for k, v in batch.items()})
            torch.cuda.synchronize()
            runs[device] = (m["loss"].item(), grads[0], int(opt["step"]),
                            FK.flash_attention.launches - before[0],
                            FK.flash_attention_bwd.launches - before[1])
        tol = REDUCED_TOL_XLSTM if arch == "xlstm-1.3b" else REDUCED_TOL
        loss_err = abs(runs["cuda"][0] - runs["cpu"][0])
        rel = _leaf_relnorms(runs["cuda"][1], runs["cpu"][1])
        leaf, grad_err = max(rel.items(), key=lambda kv: kv[1])
        check(loss_err <= tol, f"{arch} reduced train step: loss differs "
              f"by {loss_err} (limit {tol})")
        check(grad_err <= tol, f"{arch} reduced train step: gradient of "
              f"{leaf} differs by relnorm {grad_err} (limit {tol})")
        check(runs["cuda"][2] == runs["cpu"][2] == 1,
              f"{arch}: optimizer step {runs['cuda'][2]}, {runs['cpu'][2]}")
        n_dec = attention_layers(cfg) - cfg.enc_layers
        want = TRAIN_ACCUM * (2 * n_dec + cfg.enc_layers)
        check(runs["cpu"][3] == 0 and runs["cuda"][3] == want,
              f"{arch} reduced train step: flash launches {runs['cpu'][3]} "
              f"on the CPU, {runs['cuda'][3]} on the card, not {want}")
        check(runs["cpu"][4] == 0 and runs["cuda"][4] == TRAIN_ACCUM * n_dec,
              f"{arch} reduced train step: flash backward launches "
              f"{runs['cpu'][4]} on the CPU, {runs['cuda'][4]} on the card, "
              f"not {TRAIN_ACCUM * n_dec}")
        worst = max(worst, loss_err, grad_err)
        say(f"  {arch} reduced f32, {batch_rows} x {seq} tokens in "
            f"{TRAIN_ACCUM} microbatches: loss {runs['cuda'][0]:.6f}, card "
            f"against CPU {loss_err:.3g}; gradient relnorm worst "
            f"{grad_err:.3g} ({leaf}; limit {tol:g}); {runs['cuda'][3]} "
            f"flash launches on the card ({TRAIN_ACCUM} microbatches x "
            f"(2 x {n_dec} decoder attention layers + {cfg.enc_layers} "
            f"encoder)), {runs['cuda'][4]} backward")
    return worst


def _tree_relnorm(got, want) -> float:
    """||got - want|| / ||want|| over whole trees, in f32."""
    import torch
    from repro_torch.models import param as PM
    got, want = PM.tree_leaves(got), PM.tree_leaves(want)
    num = den = torch.zeros((), dtype=torch.float32, device=want[0].device)
    for g, w in zip(got, want):
        num = num + (g.float() - w.float()).square().sum()
        den = den + w.float().square().sum()
    return float(num.sqrt() / den.sqrt().clamp_min(1e-30))


def full_width_gradient(say) -> dict:
    """Phase 13b: MiniCPM-2B as published, bf16, random weights from
    CASE_SEED, one microbatch (TRAIN_BATCH / TRAIN_ACCUM rows of
    TRAIN_SEQ tokens): ``loss_fn`` and its whole-tree gradient through
    the kernel (under ``FlashAttention``), then under ``plain_attention``
    (autograd of ``attention_ref``, the full score matrix a layer); the
    losses within TRAIN_LOSS_REL, the gradients within GRAD_RELNORM; the
    kernel's run launches the flash forward twice (forward, recompute)
    and its backward once per layer, the plain run neither."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import io
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.train_step import value_and_grad
    cfg = get_arch(TRAIN_ARCH)
    mb = TRAIN_BATCH // TRAIN_ACCUM
    params = PM.trainable(M.init_params(cfg, CASE_SEED))
    batch = io.synthetic_batch(cfg, ShapeSpec("t", TRAIN_SEQ, mb, "train"),
                               CASE_SEED)
    ctx = M.build_ctx(cfg)
    out = {}
    for name in ("kernel", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (FK.flash_attention.launches,
                  FK.flash_attention_bwd.launches)
        t0 = time.perf_counter()
        with plain_attention() if name == "plain" else contextlib.nullcontext():
            loss, _, grads = value_and_grad(cfg, ctx, params, batch)
        torch.cuda.synchronize()
        out[name] = {"loss": loss.item(), "grads": grads,
                     "s": time.perf_counter() - t0,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": FK.flash_attention.launches - before[0],
                     "bwd_launches":
                         FK.flash_attention_bwd.launches - before[1]}
    k, p = out["kernel"], out["plain"]
    n_attn = attention_layers(cfg)
    check(k["launches"] == 2 * n_attn and p["launches"] == 0,
          f"13b: flash launches {k['launches']} (kernel), {p['launches']} "
          f"(plain), not 2 x {n_attn} and 0")
    check(k["bwd_launches"] == n_attn and p["bwd_launches"] == 0,
          f"13b: flash backward launches {k['bwd_launches']} (kernel), "
          f"{p['bwd_launches']} (plain), not {n_attn} and 0")
    check(all(bool(torch.isfinite(g).all()) for g in PM.tree_leaves(
        k["grads"])), "13b: non-finite gradient through the kernel")
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    rel = _tree_relnorm(k["grads"], p["grads"])
    leaf, worst = max(_leaf_relnorms(k["grads"], p["grads"]).items(),
                      key=lambda kv: kv[1])
    check(loss_rel <= TRAIN_LOSS_REL, f"13b: loss {k['loss']} through the "
          f"kernel, {p['loss']} plain: {loss_rel} relative (limit "
          f"{TRAIN_LOSS_REL})")
    check(rel < GRAD_RELNORM, f"13b: gradient through the kernel against "
          f"the plain attention, relnorm {rel} (limit {GRAD_RELNORM})")
    res = {"loss_kernel": k["loss"], "loss_plain": p["loss"],
           "loss_rel": loss_rel, "grad_relnorm": rel,
           "worst_leaf": leaf, "worst_leaf_relnorm": worst,
           "s_kernel": k["s"], "s_plain": p["s"],
           "peak_gb_kernel": k["peak_gb"], "peak_gb_plain": p["peak_gb"],
           "flash_launches": k["launches"],
           "flash_bwd_launches": k["bwd_launches"]}
    say(f"  {TRAIN_ARCH} full width bf16, {mb} x {TRAIN_SEQ} tokens: loss "
        f"{k['loss']:.6f} through the kernel, {p['loss']:.6f} plain "
        f"({loss_rel:.3g} relative, limit {TRAIN_LOSS_REL:g}); whole-tree "
        f"gradient relnorm {rel:.4f} (limit {GRAD_RELNORM}), worst leaf "
        f"{leaf} {worst:.4f}; loss and gradient {k['s']:.3f} s, peak "
        f"{k['peak_gb']:.2f} GB (plain: {p['s']:.3f} s, "
        f"{p['peak_gb']:.2f} GB); {k['launches']} flash launches, "
        f"{k['bwd_launches']} backward")
    return res


def _correlated_ms(trace, device_events, annotation: str) -> float:
    """Device time of the kernels launched from inside the CPU ranges
    named ``annotation``, or, for a name ending in ``:``, named with it
    as their prefix (matched by the launch's correlation id)."""
    if annotation.endswith(":"):      # the process group's, of any kind
        ranges = [e for e in trace if e["name"].startswith(annotation)
                  and e.get("cat") not in ("kernel", "gpu_memcpy",
                                           "gpu_memset")]
    else:
        ranges = [e for e in trace if e.get("cat") == "user_annotation"
                  and e["name"] == annotation]
    # each thread's ranges as sorted disjoint intervals (their union), so
    # that a launch is placed by bisection: a profiled generate holds
    # ~10^4 ranges and ~10^5 launches
    spans = {}
    for e in sorted(ranges, key=lambda e: e["ts"]):
        iv = spans.setdefault(e["tid"], [])
        a, b = e["ts"], e["ts"] + e["dur"]
        if iv and a <= iv[-1][1]:
            iv[-1][1] = max(iv[-1][1], b)
        else:
            iv.append([a, b])
    starts = {tid: [a for a, _ in iv] for tid, iv in spans.items()}

    def inside(e) -> bool:
        i = bisect.bisect_right(starts.get(e["tid"], []), e["ts"]) - 1
        return i >= 0 and e["ts"] < spans[e["tid"]][i][1]
    ids = {e["args"]["correlation"] for e in trace
           if e.get("cat") in ("cuda_runtime", "cuda_driver")
           and "correlation" in e.get("args", {}) and inside(e)}
    return sum(e["dur"] for e in device_events
               if e.get("args", {}).get("correlation") in ids) / 1e3


def _traced(module, name: str, label: str):
    """Swap ``module.name`` for a wrapper that runs it inside
    ``record_function(label)``; returns the function that undoes it."""
    import torch
    fn = getattr(module, name)

    def traced(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    setattr(module, name, traced)
    return lambda: setattr(module, name, fn)


def profile_train_step(state, oc, say, mesh=None, cell=None) -> dict:
    """One more train step of 13c's state (14b's or 15a's, on its mesh)
    under ``torch.profiler``, as ``launch/profile_serve.py`` profiles a
    prefill: host wall time, device busy time and idle share, the top
    kernels, and the device time of the flash forward and of the flash
    backward's kernels (``BWD_KERNEL_NAME``: ``bwd_delta_bf16`` and
    ``bwd_keymajor_bf16``), by kernel name, together and each.  ``cell`` is the run's (cfg, shape, accum), phase
    13's by default.  On a mesh also the collectives: the train step's
    ``all_reduce_axes`` and ``gather_full`` calls (ZeRO-1's) and the device
    time launched inside them, the process group's own profiler ranges
    (``nccl:*``) and the device time launched inside them, and the device
    events NCCL names (``ncclDevKernel_*``)."""
    import os
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import mesh as MESH
    from repro_torch.launch.profile_serve import DEVICE_CATS, _report
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training import train_step as TS
    from repro_torch.training.optimizer import zero1_shardings
    cfg, shape, accum = cell or (
        get_arch(TRAIN_ARCH),
        ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"), TRAIN_ACCUM)
    zshd = None
    if mesh is None:
        step = TS.build_train_step(cfg, M.build_ctx(cfg), oc, accum)
    else:
        ctx = M.build_ctx(cfg, shape, mesh)
        if MESH.use_small_dense_dp(cfg, shape, mesh):
            zshd = zero1_shardings(M.model_specs(cfg), oc.state_dtype,
                                   MESH.make_opt_rules(cfg, shape, mesh,
                                                       ctx.rules), mesh)
        step = TS.build_train_step(cfg, ctx, oc, accum, zshd)
    batch = state.pipeline.next_batch()
    undo = [_traced(TS, "all_reduce_axes", "mesh:all_reduce"),
            _traced(MESH, "gather_full", "mesh:all_gather")]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function("phase:train_step"):
                step(state.params, state.opt_state, batch)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = [e for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X"]
    finally:
        for u in undo:
            u()
        os.unlink(path)
    dev = [e for e in trace if e.get("cat") in DEVICE_CATS]
    check(len(dev) > 0, f"{cfg.name}: the profiled train step holds no "
          "device event")
    rep = _report("  profiled train step", wall, dev, 10)
    rep["flash_forward_ms"] = sum(e["dur"] for e in dev
                                  if "flash_bf16" in e["name"]) / 1e3
    rep["flash_backward_kernels_ms"] = {}
    for e in dev:
        m = BWD_KERNEL_NAME.search(e["name"])
        if m:
            k = rep["flash_backward_kernels_ms"]
            k[m.group(1)] = k.get(m.group(1), 0.0) + e["dur"] / 1e3
    rep["flash_backward_ms"] = sum(rep["flash_backward_kernels_ms"].values())
    check(rep["flash_forward_ms"] > 0 and rep["flash_backward_ms"] > 0,
          f"{cfg.name}: no flash forward or backward kernel in the "
          f"trace: {rep}")
    say(f"  flash forward {rep['flash_forward_ms']:.3f} ms, flash backward "
        f"{rep['flash_backward_ms']:.3f} ms "
        f"({rep['flash_backward_kernels_ms']}) of {rep['busy_ms']:.3f} ms "
        f"device busy ({rep['flash_backward_ms'] / rep['busy_ms']:.3f}); "
        f"idle share {rep['idle_share']:.3f}")
    if mesh is None:
        return rep
    calls = {k: sum(1 for e in trace if e.get("cat") == "user_annotation"
                    and e["name"] == f"mesh:{k}")
             for k in ("all_reduce", "all_gather")}
    nccl = [e["name"] for e in trace if e["name"].startswith("nccl:")]
    rep["collectives"] = {
        "calls": calls,
        **{f"{k}_ms": _correlated_ms(trace, dev, f"mesh:{k}") for k in calls},
        "nccl_ranges": {n: nccl.count(n) for n in sorted(set(nccl))},
        "nccl_range_count": len(nccl),
        "nccl_range_ms": _correlated_ms(trace, dev, "nccl:"),
        "nccl_device_events": sorted({e["name"] for e in dev
                                      if "nccl" in e["name"].lower()}),
        "nccl_device_ms": sum(e["dur"] for e in dev
                              if "nccl" in e["name"].lower()) / 1e3}
    c = rep["collectives"]
    if zshd is not None:
        # one all-reduce a gradient leaf and one for the loss; one gather
        # a parameter leaf whose moments' spec names a mesh axis
        n_leaves = len(PM.tree_leaves(state.params))
        n_sharded = sum(1 for sh in PM.tree_leaves(zshd)
                        if MESH.spec_axes(sh.spec))
        check(calls == {"all_reduce": n_leaves + 1, "all_gather": n_sharded},
              f"{cfg.name}: collectives {calls}, not {n_leaves + 1} "
              f"all-reduces and {n_sharded} all-gathers")
    check(c["nccl_range_count"] > 0 or c["nccl_device_events"],
          f"{cfg.name}: no NCCL range or device event in the profiled "
          f"step: {c}")
    say(f"  the train step's collectives: {calls}; device time launched "
        f"inside them: all-reduce {c['all_reduce_ms']:.3f} ms, all-gather "
        f"{c['all_gather_ms']:.3f} ms; process-group ranges "
        f"{c['nccl_ranges']}, {c['nccl_range_ms']:.3f} ms of device time "
        f"launched inside them; NCCL device events "
        f"{c['nccl_device_events']} ({c['nccl_device_ms']:.3f} ms)")
    return rep


def leaf_stats(params) -> dict:
    """{path: (f64 sum, f64 norm)} of every leaf of a parameter tree."""
    from repro_torch.models import param as PM
    return {p: (float(t.detach().double().sum()),
                float(t.detach().double().norm()))
            for p, t in PM.tree_leaves_with_paths(params)}


def timed_pipeline(starts: list, before=None):
    """``Pipeline`` whose ``next_batch`` records its start after a device
    synchronise; ``before(i)`` runs first, outside the step's time."""
    import torch
    from repro_torch.data.pipeline import Pipeline

    class TimedPipeline(Pipeline):
        def next_batch(self):
            if before is not None:
                before(len(starts))
            torch.cuda.synchronize()
            starts.append(time.perf_counter())
            return super().next_batch()
    return TimedPipeline


def step_times(starts, ends, n_params, tokens, say) -> list:
    steps = []
    for i, (a, b) in enumerate(zip(starts, ends)):
        s = b - a
        steps.append({"ms": s * 1e3, "tok_s": tokens / s,
                      "mfu": 6 * n_params * tokens / s / BF16_FLOPS_PER_S})
        say(f"  step {i}: {s * 1e3:.1f} ms, {tokens / s:.1f} tokens/s, "
            f"model-FLOPs share {steps[-1]['mfu']:.4f} (6 x "
            f"{n_params / 1e9:.3f} B x {tokens} tokens over the step, "
            f"against 989 TFLOP/s bf16)")
    return steps


@contextlib.contextmanager
def first_step_record(first: dict):
    """Within it, ``run_training``'s parameters after its first step are
    recorded into ``first`` (each leaf's f64 sum and norm, and a host
    copy) when the second step asks for its batch, out of that step's
    time.  Yields the hook for ``timed_pipeline``."""
    from repro_torch.models import param as PM
    from repro_torch.training import train_loop
    live = {}
    build = train_loop.build_train_step

    def recording_build(*args, **kw):
        step = build(*args, **kw)

        def recorded(params, opt_state, batch):
            live.setdefault("params", params)
            return step(params, opt_state, batch)
        return recorded

    def hook(i):
        if i == 1:
            first["stats"] = leaf_stats(live["params"])
            first["host"] = [t.detach().to("cpu", copy=True) for t in
                             PM.tree_leaves(live["params"])]

    train_loop.build_train_step = recording_build
    try:
        yield hook
    finally:
        train_loop.build_train_step = build


def full_width_training(say):
    """Phase 13c: MiniCPM-2B as published, bf16 parameters, f32 AdamW
    moments and the WSD schedule as ``launch/train.py`` sets them, through
    ``train_loop.run_training``: TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens in TRAIN_ACCUM microbatches.  Each step's wall time
    runs from its batch to its logged loss (both after a device
    synchronise).  After the first step (before the second's batch, out
    of its time) the parameters are recorded for phase 14b: each leaf's
    f64 sum and norm, and a host copy.  Returns (the result, the final
    state, the optimizer config, the first step's record)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import run_training
    cfg = get_arch(TRAIN_ARCH)
    n_params = PM.count_params(M.model_specs(cfg))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    oc = OptConfig(schedule=cfg.lr_schedule, total_steps=TRAIN_STEPS,
                   warmup_steps=max(TRAIN_STEPS // 10, 1))
    starts, ends, first = [], [], {}

    def log_fn(msg):
        ends.append(time.perf_counter())
        say(f"    {msg}")

    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention.launches = FK.flash_attention_bwd.launches = 0
    with first_step_record(first) as hook:
        state, losses, stats = run_training(
            cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
            steps=TRAIN_STEPS, oc=oc, accum=TRAIN_ACCUM, log_every=1,
            log_fn=log_fn, pipeline_cls=timed_pipeline(starts, hook))
    first["loss"] = losses[0]
    launches = FK.flash_attention.launches
    bwd = FK.flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_attn = attention_layers(cfg)
    want = n_attn * 2 * TRAIN_ACCUM * TRAIN_STEPS
    check(launches == want, f"13c: {launches} flash launches, not {n_attn} "
          f"layers x 2 (forward, recompute) x {TRAIN_ACCUM} microbatches x "
          f"{TRAIN_STEPS} steps = {want}")
    check(bwd == want // 2, f"13c: {bwd} flash backward launches, not "
          f"{n_attn} layers x {TRAIN_ACCUM} microbatches x {TRAIN_STEPS} "
          f"steps = {want // 2}")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"13c: losses {losses}")
    check(int(state.opt_state["step"]) == TRAIN_STEPS and stats.restarts == 0,
          f"13c: optimizer step {int(state.opt_state['step'])}")
    init = M.init_params(cfg, 0)
    same = [p for (p, a), b in zip(PM.tree_leaves_with_paths(state.params),
                                   PM.tree_leaves(init)) if torch.equal(a, b)]
    del init
    check(same == [], f"13c: parameters unchanged by training: {same}")
    steps = step_times(starts, ends, n_params, tokens, say)
    say(f"  losses {losses}; peak {peak:.2f} GB; {launches} flash launches "
        f"({n_attn} layers x 2 x {TRAIN_ACCUM} microbatches x {TRAIN_STEPS} "
        f"steps), {bwd} backward; every parameter leaf changed; optimizer "
        f"step {int(state.opt_state['step'])}")
    res = {"params": n_params, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "accum": TRAIN_ACCUM, "losses": losses, "steps": steps,
           "peak_gb": peak, "flash_launches": launches,
           "flash_bwd_launches": bwd}
    return res, state, oc, first


def checkpoint_round_trip(state, say) -> dict:
    """Phase 13d, first half: one synchronous ``checkpoint.save`` of 13c's
    {"params", "opt"} under a fresh temporary directory, then
    ``checkpoint.restore`` into the same tree on the card: every leaf
    equal; the write and read times.  The directory is removed."""
    import shutil
    import tempfile
    import torch
    from repro_torch.models import param as PM
    from repro_torch.training import checkpoint as CKPT
    tree = {"params": state.params, "opt": state.opt_state}
    nbytes = sum(t.numel() * t.element_size() for t in PM.tree_leaves(tree))
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        check(free > 1.1 * nbytes, f"13d: {free / 1e9:.1f} GB free under "
              f"{d}, the checkpoint needs {nbytes / 1e9:.1f} GB")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CKPT.save(d, state.step, tree,
                  extra={"pipeline": state.pipeline.state()})
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, manifest = CKPT.restore(d, state.step, tree)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        diff = [p for (p, a), b in zip(PM.tree_leaves_with_paths(got),
                                       PM.tree_leaves(tree))
                if a.dtype != b.dtype or a.device != b.device
                or not torch.equal(a, b)]
        check(diff == [], f"13d: leaves differ after the round trip: {diff}")
        check(manifest["extra"]["pipeline"] == state.pipeline.state(),
              f"13d: manifest extra {manifest['extra']}")
        n_leaves = len(manifest["leaves"])
        del got
    finally:
        shutil.rmtree(d, ignore_errors=True)
    say(f"  checkpoint of {n_leaves} leaves, {nbytes / 1e9:.2f} GB: write "
        f"{write_s:.2f} s ({nbytes / write_s / 1e9:.2f} GB/s), restore to "
        f"the card {read_s:.2f} s ({nbytes / read_s / 1e9:.2f} GB/s); every "
        f"leaf equal; {free / 1e9:.0f} GB were free")
    return {"gb": nbytes / 1e9, "leaves": n_leaves, "write_s": write_s,
            "read_s": read_s}


def recovery_on_card(say) -> dict:
    """Phase 13d, second half: the reference's recovery scenario
    (tests/test_system.py, test_fault_recovery_resumes_from_checkpoint)
    on the card: MiniCPM-2B reduced, 6 steps of 2 x 32 tokens, a
    checkpoint every 2 steps, host 2 failing before step 4."""
    import shutil
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.fault import FaultPolicy, NodeFailure
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.train_loop import run_training
    fired = []

    def injector(i):
        if i == 4 and not fired:
            fired.append(i)
            return NodeFailure(2)
        return None

    d = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    try:
        state, losses, stats = run_training(
            get_arch(TRAIN_ARCH).reduced(), ShapeSpec("t", 32, 2, "train"),
            steps=6, accum=1, ckpt_dir=d,
            policy=FaultPolicy(checkpoint_every=2),
            failure_injector=injector, log_every=0)
        last = CKPT.latest_step(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(state.step == 6 and stats.restarts == 1
          and stats.failed_hosts == [2] and last == 6,
          f"13d recovery: step {state.step}, restarts {stats.restarts}, "
          f"failed hosts {stats.failed_hosts}, last checkpoint {last}")
    check(state.params["ln_f"]["scale"].is_cuda and all(np.isfinite(losses)),
          "13d recovery: state not on the card or losses not finite")
    say(f"  recovery on the card: {TRAIN_ARCH} reduced, 6 steps, checkpoint "
        f"every 2, host 2 lost before step 4: step {state.step}, restarts "
        f"{stats.restarts}, failed hosts {stats.failed_hosts}, latest "
        f"checkpoint step {last}")
    return {"step": state.step, "restarts": stats.restarts,
            "failed_hosts": stats.failed_hosts}


# ------------------------------------------------------------ phase 14 ---
#: phase 14b against 13c's first step: the loss, relative, and every
#: parameter leaf's relnorm (the embedding backward's atomics are the
#: only expected difference)
MESH_LOSS_REL, MESH_LEAF_RELNORM = 1e-6, 1e-5
#: phase 14b's steps: the first is held against 13c's, the second timed
#: warm (a run's first step carries its warm-up)
MESH_STEPS = 2
#: phase 14c: MiniCPM-2B's embedding gradient (padded vocab x d_model)
EMBED_GRAD_SHAPE = (122753, 2304)
#: phase 14d: a tensor the permutes move
PERMUTE_SHAPE = (4096, 2304)


def mesh_training(first, oc, say) -> dict:
    """Phase 14b: 13c's first two steps again, through
    ``run_training(cfg, shape, mesh)`` on the smoke mesh (NCCL, world
    size 1): the rank's rows (all of them), the f32 gradient all-reduce,
    ZeRO-1 moments and the parameter all-gather.  The first step is held
    against 13c's record of its first; the second is the warm step time.
    Returns the result; the state is dropped."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.train_loop import run_training
    cfg = get_arch(TRAIN_ARCH)
    n_params = PM.count_params(M.model_specs(cfg))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mesh = make_smoke_mesh("cuda")
    starts, ends, mine = [], [], {}

    def log_fn(msg):
        ends.append(time.perf_counter())
        say(f"    {msg}")

    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention.launches = FK.flash_attention_bwd.launches = 0
    with first_step_record(mine) as hook:
        state, losses, stats = run_training(
            cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
            steps=MESH_STEPS, oc=oc, accum=TRAIN_ACCUM, log_every=1,
            log_fn=log_fn, pipeline_cls=timed_pipeline(starts, hook))
    launches = FK.flash_attention.launches
    bwd = FK.flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = attention_layers(cfg) * 2 * TRAIN_ACCUM * MESH_STEPS
    check(launches == want, f"14b: {launches} flash launches, not {want}")
    check(bwd == want // 2,
          f"14b: {bwd} flash backward launches, not {want // 2}")
    steps = step_times(starts, ends, n_params, tokens, say)
    loss_rel = abs(losses[0] - first["loss"]) / abs(first["loss"])
    stats_now = mine["stats"]
    rel = {}
    for (path, _), a, b in zip(PM.tree_leaves_with_paths(state.params),
                               mine["host"], first["host"]):
        rel[path] = _relnorm(a.to("cuda"), b.to("cuda"))
    worst = max(rel.items(), key=lambda kv: kv[1])
    sums = max(abs(stats_now[p][0] - s) / max(n, 1e-30) for p, (s, n) in
               first["stats"].items())
    norms = max(abs(stats_now[p][1] - n) / max(n, 1e-30) for p, (_, n) in
                first["stats"].items())
    say(f"  loss {losses[0]!r} against 13c's first step {first['loss']!r} "
        f"(relative {loss_rel:.3g}); worst leaf relnorm {worst[1]:.3g} "
        f"({worst[0]}); f64 sums differ by at most {sums:.3g} and norms by "
        f"{norms:.3g} of the leaf's norm; peak {peak:.2f} GB; {launches} "
        f"flash launches, {bwd} backward")
    check(loss_rel <= MESH_LOSS_REL,
          f"14b: loss {losses[0]} against {first['loss']}")
    check(worst[1] <= MESH_LEAF_RELNORM, f"14b: leaf relnorm {worst}")
    check(int(state.opt_state["step"]) == MESH_STEPS
          and stats.restarts == 0,
          f"14b: optimizer step {int(state.opt_state['step'])}")
    del state, mine
    return {"backend": "nccl", "loss": losses[0], "loss_13c": first["loss"],
            "loss_rel": loss_rel, "worst_leaf_relnorm": worst[1],
            "worst_leaf": worst[0], "sum_rel": sums, "norm_rel": norms,
            "steps": steps, "peak_gb": peak, "flash_launches": launches,
            "flash_bwd_launches": bwd}


def mesh_profile_child() -> None:
    """Phase 14b's profiled step, in a process of its own (the card's
    tracer records kernels in a process's first profiler session only,
    and 13c's is the parent's): a warm-up step through ``run_training``
    on the smoke mesh, then one step under the profiler; prints the
    report as JSON on its last line."""
    import torch
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import run_training
    FK.load_library()
    cfg = get_arch(TRAIN_ARCH)
    oc = OptConfig(schedule=cfg.lr_schedule, total_steps=TRAIN_STEPS,
                   warmup_steps=max(TRAIN_STEPS // 10, 1))
    mesh = make_smoke_mesh("cuda")
    state, _, _ = run_training(
        cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
        steps=1, oc=oc, accum=TRAIN_ACCUM, log_every=0)
    say = lambda *a: print(*a, flush=True)          # noqa: E731
    rep = profile_train_step(state, oc, say, mesh)
    dist.destroy_process_group()
    print(json.dumps(rep))


def child_report(say, child: str = "mesh_profile_child") -> dict:
    """Run ``child`` (``mesh_profile_child``, ``moe_profile_child``,
    ``mesh_serve_profile_child`` or ``bwd_profile_child``) in a fresh
    interpreter; its report."""
    res = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{child}()"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines()[:-1]:
        say(line)
    check(res.returncode == 0, f"{child}: exit {res.returncode}\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.splitlines()[-1])


def mesh_compression(say) -> dict:
    """Phase 14c: ``quantize``/``dequantize`` of a leaf of the embedding
    gradient's shape on the card, bit-equal to the CPU's;
    ``compressed_psum_leaf`` through the NCCL group (what it sent plus the
    new error is the input plus the old error, to f32 rounding); and
    ``cross_pod_grad_sync`` over a gradient tree of MiniCPM-2B's leaves
    (bf16, seeded normal draws) on a (1, 1, 1) (pod, data, model) mesh,
    timed beside its HBM bound (gradient and error read once, reduced
    gradient and new error written once)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.distributed import compression as C
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    gen = torch.Generator(device="cuda").manual_seed(CASE_SEED)
    g = torch.randn(EMBED_GRAD_SHAPE, generator=gen, device="cuda")
    q, sc, n = C.quantize(g)
    qh, sh, nh = C.quantize(g.cpu())
    same = (n == nh and torch.equal(q.cpu(), qh)
            and sc.cpu().view(torch.int32).equal(sh.view(torch.int32)))
    back = C.dequantize(q, sc, n, g.shape).cpu()
    same_back = back.view(torch.int32).equal(
        C.dequantize(qh, sh, nh, g.shape).view(torch.int32))
    check(same and same_back, "14c: quantize or dequantize on the card is "
          "not bit-equal to the CPU's")
    del qh, sh, back
    pod = init_device_mesh("cuda", (1, 1, 1),
                           mesh_dim_names=("pod", "data", "model"))
    err = 1e-3 * torch.randn(EMBED_GRAD_SHAPE, generator=gen, device="cuda")
    red, new_err = C.compressed_psum_leaf(g, err, pod.get_group("pod"))
    resid = float(((red + new_err) - (g + err)).abs().max())
    scale = float((g + err).abs().max())
    check(resid <= 2 * torch.finfo(torch.float32).eps * scale,
          f"14c: sent + new error differs from g + err by {resid}")
    del g, q, sc, err, red, new_err
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch(TRAIN_ARCH)
    grads = PM.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device="cuda").to(torch.bfloat16),
        M.model_specs(cfg))
    errs = C.init_error_feedback(grads)
    n_el = sum(t.numel() for t in PM.tree_leaves(grads))
    nbytes = n_el * (2 + 4 + 2 + 4)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C.cross_pod_grad_sync(grads, errs, pod)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms = min(times)
    say(f"  quantize/dequantize of {EMBED_GRAD_SHAPE} f32 bit-equal to the "
        f"CPU's; compressed_psum_leaf: |sent + new_err - (g + err)| "
        f"{resid:.3g} (of {scale:.3g}); cross_pod_grad_sync over "
        f"{len(PM.tree_leaves(grads))} leaves, {n_el / 1e9:.3f} B elements: "
        f"{times} ms, best {ms:.2f} ms against the bound {bound_ms:.2f} ms "
        f"({nbytes / 1e9:.2f} GB at 3.35 TB/s), {bound_ms / ms:.3f} of it")
    del grads, errs
    return {"bit_equal": True, "resid": resid, "sync_ms": times,
            "sync_best_ms": ms, "sync_bound_ms": bound_ms,
            "sync_bytes": nbytes}


def mesh_resharding(say) -> dict:
    """Phase 14d: both permutes on the 1x1 smoke mesh, whose rings have
    one member: the bytes come back equal to the input."""
    import torch
    from repro_torch.distributed.resharding import (
        multipath_permute, single_path_permute)
    from repro_torch.launch.mesh import make_smoke_mesh
    mesh = make_smoke_mesh("cuda")
    gen = torch.Generator(device="cuda").manual_seed(CASE_SEED)
    x = torch.randn(PERMUTE_SHAPE, generator=gen, device="cuda").to(
        torch.bfloat16)
    outs = {"multipath": multipath_permute(x, mesh),
            "single_path": single_path_permute(x, mesh)}
    for k, y in outs.items():
        check(y.is_cuda and torch.equal(y.view(torch.int16),
                                        x.view(torch.int16)),
              f"14d: {k}_permute changed the bytes on a 1x1 mesh")
    say(f"  multipath_permute and single_path_permute of {PERMUTE_SHAPE} "
        f"bf16 on the 1x1 mesh: bytes equal to the input")
    return {"shape": PERMUTE_SHAPE, "equal": True}


# ------------------------------------------------------------ phase 15 ---
#: phase 15a: DBRX-132B at full width (configs/dbrx_132b.py,
#: hf:databricks/dbrx-base: d_model 6144, 48 q and 8 kv heads of 128, 16
#: experts top-4 of d_ff 10752, padded vocab 100352) cut to 1 of its 40
#: layers, 4.49 B parameters: 2 x 4096 tokens a step in one microbatch,
#: 3 steps, WSD, f32 AdamW moments (the state is ~54 GB)
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 1
MOE_SEQ, MOE_BATCH, MOE_ACCUM, MOE_STEPS = 4096, 2, 1, 3
MOE_STATE = "f32"
#: phase 15b: the MoE archs reduced, one step each on the 1x1 mesh,
#: card against CPU (13a's shape, microbatches and limits)
MOE_REDUCED = ("dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b")


def moe_config():
    return full_config(MOE_ARCH, MOE_LAYERS)


def moe_cell():
    """(cfg, shape, OptConfig) of phase 15a."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.training.optimizer import OptConfig
    cfg = moe_config()
    oc = OptConfig(schedule=cfg.lr_schedule, total_steps=MOE_STEPS,
                   warmup_steps=max(MOE_STEPS // 10, 1),
                   state_dtype=MOE_STATE)
    return cfg, ShapeSpec("train", MOE_SEQ, MOE_BATCH, "train"), oc


def active_params(cfg) -> int:
    """The parameters a token's forward multiplies by: every leaf but the
    experts', and of those ``top_k / n_experts``; the embedding table
    counts where it is the head (tied)."""
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    n = 0
    for path, p in PM.tree_leaves_with_paths(M.model_specs(cfg)):
        size = int(np.prod(p.shape))
        if "/moe/w" in path:
            size = size * cfg.top_k // cfg.n_experts
        elif path == "embed/table" and not cfg.tie_embeddings:
            size = 0
        n += size
    return n


def moe_mesh_training(say) -> dict:
    """Phase 15a: ``moe_cell()`` through ``run_training``, first for one
    step without a mesh (its loss and a host copy of the parameters
    after it), then MOE_STEPS steps on the 1x1 NCCL mesh, where the MoE
    training rules name ``model`` (experts, heads, kv heads, vocab) and
    ``data`` (FSDP ``embed``): every sharded body and collective runs,
    on groups of one.  The mesh's first step is held against the
    record, the later steps timed warm."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.train_loop import run_training
    cfg, shape, oc = moe_cell()
    n_params = PM.count_params(M.model_specs(cfg))
    n_active = active_params(cfg)
    tokens = MOE_BATCH * MOE_SEQ
    torch.cuda.reset_peak_memory_stats()
    state, losses, _ = run_training(cfg, shape, steps=1, oc=oc,
                                    accum=MOE_ACCUM, log_every=0)
    plain = {"loss": losses[0], "peak_gb":
             torch.cuda.max_memory_allocated() / 1e9,
             "host": [t.detach().to("cpu", copy=True)
                      for t in PM.tree_leaves(state.params)]}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_smoke_mesh("cuda")
    starts, ends, mine = [], [], {}

    def log_fn(msg):
        ends.append(time.perf_counter())
        say(f"    {msg}")

    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats()["num_alloc_retries"]
    FK.flash_attention.launches = FK.flash_attention_bwd.launches = 0
    with first_step_record(mine) as hook:
        state, losses, stats = run_training(
            cfg, shape, mesh, steps=MOE_STEPS, oc=oc, accum=MOE_ACCUM,
            log_every=1, log_fn=log_fn,
            pipeline_cls=timed_pipeline(starts, hook))
    launches = FK.flash_attention.launches
    bwd = FK.flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.max_memory_reserved() / 1e9
    retries = torch.cuda.memory_stats()["num_alloc_retries"] - retries0
    n_attn = attention_layers(cfg)
    want = n_attn * 2 * MOE_ACCUM * MOE_STEPS
    check(launches == want, f"15a: {launches} flash launches, not {n_attn} "
          f"layers x 2 x {MOE_ACCUM} microbatches x {MOE_STEPS} steps")
    check(bwd == want // 2, f"15a: {bwd} flash backward launches, not "
          f"{n_attn} layers x {MOE_ACCUM} microbatches x {MOE_STEPS} steps")
    check(len(losses) == MOE_STEPS and all(np.isfinite(losses)),
          f"15a: losses {losses}")
    check(int(state.opt_state["step"]) == MOE_STEPS and stats.restarts == 0,
          f"15a: optimizer step {int(state.opt_state['step'])}")
    loss_rel = abs(losses[0] - plain["loss"]) / abs(plain["loss"])
    rel = {path: _relnorm(a.to("cuda"), b.to("cuda")) for (path, _), a, b
           in zip(PM.tree_leaves_with_paths(state.params), mine["host"],
                  plain["host"])}
    worst = max(rel.items(), key=lambda kv: kv[1])
    steps = step_times(starts, ends, n_active, tokens, say)
    say(f"  ({n_active / 1e9:.3f} B of the {n_params / 1e9:.3f} B "
        f"parameters active a token: the experts' top-{cfg.top_k} of "
        f"{cfg.n_experts}); loss {losses[0]!r} against {plain['loss']!r} "
        f"without a mesh (relative {loss_rel:.3g}); worst leaf relnorm "
        f"{worst[1]:.3g} ({worst[0]}); losses {losses}; peak {peak:.2f} GB "
        f"({plain['peak_gb']:.2f} GB without a mesh; reserved {reserved:.2f}"
        f" GB, {retries} allocator retries on the mesh), {MOE_STATE} "
        f"moments; "
        f"{launches} flash launches ({n_attn} layer x 2 x {MOE_ACCUM} x "
        f"{MOE_STEPS} steps), {bwd} backward")
    check(loss_rel <= MESH_LOSS_REL,
          f"15a: loss {losses[0]} against {plain['loss']}")
    check(worst[1] <= MESH_LEAF_RELNORM, f"15a: leaf relnorm {worst}")
    del state, mine, plain
    return {"arch": MOE_ARCH, "layers": MOE_LAYERS, "params": n_params,
            "active_params": n_active, "seq": MOE_SEQ, "batch": MOE_BATCH,
            "accum": MOE_ACCUM, "state_dtype": MOE_STATE, "losses": losses,
            "loss_rel": loss_rel, "worst_leaf": worst[0],
            "worst_leaf_relnorm": worst[1], "steps": steps, "peak_gb": peak,
            "reserved_gb": reserved, "alloc_retries": retries,
            "flash_launches": launches,
            "flash_launches_a_step": launches // MOE_STEPS,
            "flash_bwd_launches": bwd}


def moe_profile_child() -> None:
    """Phase 15a's profiled step, in a process of its own (as
    ``mesh_profile_child``): a warm-up step on the smoke mesh, then one
    under the profiler; prints the report as JSON on its last line."""
    import torch
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.training.train_loop import run_training
    FK.load_library()
    cfg, shape, oc = moe_cell()
    mesh = make_smoke_mesh("cuda")
    state, _, _ = run_training(cfg, shape, mesh, steps=1, oc=oc,
                               accum=MOE_ACCUM, log_every=0)
    say = lambda *a: print(*a, flush=True)          # noqa: E731
    FK.flash_attention.launches = FK.flash_attention_bwd.launches = 0
    rep = profile_train_step(state, oc, say, mesh, (cfg, shape, MOE_ACCUM))
    rep["flash_launches"] = FK.flash_attention.launches
    rep["flash_bwd_launches"] = FK.flash_attention_bwd.launches
    dist.destroy_process_group()
    print(json.dumps(rep))


def moe_reduced_on_mesh(say) -> float:
    """Phase 15b: one ``build_train_step`` step with TRAIN_ACCUM
    microbatches of each MOE_REDUCED arch reduced, in f32, on the card
    through the 1x1 NCCL mesh (the training rules, every sharded body)
    and on the CPU with no mesh, from the same weights and batch: 13a's
    limits on the loss and each leaf's gradient, and 13a's flash and
    flash backward launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.mesh import make_opt_rules
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import io
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import build_train_step
    mesh = make_smoke_mesh("cuda")
    seq, rows = REDUCED_TRAIN_SHAPE
    shape = ShapeSpec("t", seq, rows, "train")
    worst = 0.0
    for arch in MOE_REDUCED:
        cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
        pspecs = M.model_specs(cfg)
        host = PM.tree_map(lambda t: t.float(),
                           M.init_params(cfg, CASE_SEED, "cpu"))
        batch = {k: v.float() if v.is_floating_point() else v for k, v in
                 io.synthetic_batch(cfg, shape, CASE_SEED, "cpu").items()}
        runs = {}
        for device, m in (("cpu", None), ("cuda", mesh)):
            params = PM.trainable(PM.tree_map(
                lambda t: t.to(device, copy=True), host))
            if m is None:
                ctx, opt = M.build_ctx(cfg), init_opt_state(pspecs, "f32",
                                                            device)
            else:
                ctx = M.build_ctx(cfg, shape, m)
                opt = init_opt_state(pspecs, "f32", device, rules=(
                    make_opt_rules(cfg, shape, m, ctx.rules)), mesh=m)
            step = build_train_step(cfg, ctx, OptConfig(
                schedule=cfg.lr_schedule), TRAIN_ACCUM)
            grads = []
            before = (FK.flash_attention.launches,
                      FK.flash_attention_bwd.launches)
            with captured_grads(grads):
                _, opt, met = step(params, opt, {k: v.to(device)
                                                 for k, v in batch.items()})
            torch.cuda.synchronize()
            runs[device] = (met["loss"].item(), grads[0], int(opt["step"]),
                            FK.flash_attention.launches - before[0],
                            FK.flash_attention_bwd.launches - before[1])
        named = sorted({a for n in ("heads", "experts", "expert_mlp",
                                    "state_inner", "embed")
                        for a in ctx.rules[n]})
        loss_err = abs(runs["cuda"][0] - runs["cpu"][0])
        leaf, grad_err = max(_leaf_relnorms(runs["cuda"][1],
                                            runs["cpu"][1]).items(),
                             key=lambda kv: kv[1])
        want = TRAIN_ACCUM * 2 * attention_layers(cfg)
        check(loss_err <= REDUCED_TOL, f"15b {arch}: loss differs by "
              f"{loss_err} (limit {REDUCED_TOL})")
        check(grad_err <= REDUCED_TOL, f"15b {arch}: gradient of {leaf} "
              f"differs by relnorm {grad_err} (limit {REDUCED_TOL})")
        check(runs["cuda"][2] == runs["cpu"][2] == 1 and named == [
            "data", "model"], f"15b {arch}: optimizer step or rules "
              f"{named}")
        check(runs["cpu"][3] == 0 and runs["cuda"][3] == want,
              f"15b {arch}: flash launches {runs['cpu'][3]} on the CPU, "
              f"{runs['cuda'][3]} on the card, not {want}")
        check(runs["cpu"][4] == 0 and runs["cuda"][4] == want // 2,
              f"15b {arch}: flash backward launches {runs['cpu'][4]} on "
              f"the CPU, {runs['cuda'][4]} on the card, not {want // 2}")
        worst = max(worst, loss_err, grad_err)
        say(f"  {arch} reduced f32 on the 1x1 mesh (rules naming {named}), "
            f"{rows} x {seq} tokens in {TRAIN_ACCUM} microbatches: loss "
            f"{runs['cuda'][0]:.6f}, card against CPU {loss_err:.3g}; "
            f"gradient relnorm worst {grad_err:.3g} ({leaf}; limit "
            f"{REDUCED_TOL:g}); {runs['cuda'][3]} flash launches, "
            f"{runs['cuda'][4]} backward")
    return worst


# ------------------------------------------------------------ phase 16 ---
#: phase 16: serving on the 1x1 NCCL mesh under the serving rules, each
#: model against the same engine without a mesh, on the same weights and
#: prompt: (label, arch, layers kept (None: all), requests, prompt
#: tokens, new tokens).  16a is phase 9's workload; 16b Jamba-1.5-Large
#: (hf:ai21labs/AI21-Jamba-1.5-Large) cut to phase 12's first 5 layers
#: (the MoE decode rules: the batch replicated, ``kv_seq`` over
#: ``(data, model)``, the 2-D ``expert_mlp``, Mamba's state over
#: ``state_inner``); 16c xLSTM-1.3B cut to its first 8 layers (1 sLSTM,
#: 7 mLSTM: ``head_v`` and the C state's v dim over ``model``)
MESH_SERVE = (("16a", "minicpm-2b", None, FULL_BATCH, FULL_PROMPT, FULL_NEW),
              ("16b", "jamba-1.5-large-398b", 5, 4, 1024, 16),
              ("16c", "xlstm-1.3b", 8, 2, 1024, 16))
#: each decode step's bf16 logits on the mesh against the same without
#: one (PERF.md §6's prediction: bit-equal, since the merge over one rank
#: takes the same arithmetic); prefill logits and tokens must be equal
MESH_SERVE_RELNORM = 1e-2
#: the tokens of phase 16's profiled generates: the prefill and 4 decode
#: steps (the trace of a 32-step generate holds 10^5 device events)
PROFILE_NEW = 5
#: the prompt of the short generate that warms each phase-16 engine up
#: (a multiple of the Mamba chunk, within one mLSTM chunk)
WARM_PROMPT = 64
#: the rules each phase-16 model must shard over the mesh's axes
MESH_SERVE_RULES = ("heads", "vocab", "kv_seq", "experts", "expert_mlp",
                    "state_inner", "head_v")


def _mesh_serve_inputs(arch, n_layers, B, L):
    import torch
    cfg = full_config(arch, n_layers)
    toks = torch.from_numpy(np.random.default_rng(CASE_SEED + 16).integers(
        0, cfg.vocab_size, (B, L), dtype=np.int32))
    return cfg, toks


def mesh_serve_model(label, arch, n_layers, B, L, new, say) -> dict:
    """One model of phase 16 at full width in bf16: random weights from
    CASE_SEED, ``Engine.generate`` without a mesh and then on the 1x1
    NCCL smoke mesh (the same weights: a rank of one holds them whole),
    each after a short warm-up generate, each prefill and decode step
    timed on the host clock after a device synchronise and its logits
    kept; the mesh run's prefill logits and
    tokens equal to the run without one, each decode step's logits within
    MESH_SERVE_RELNORM, one flash launch per attention layer in each
    prefill.  Everything it allocates is freed when it returns."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.serving.engine import Engine
    cfg, toks = _mesh_serve_inputs(arch, n_layers, B, L)
    t0 = time.perf_counter()
    params = M.init_params(cfg, CASE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mesh = make_smoke_mesh("cuda")
    shape = ShapeSpec("serve", L + new, B, "decode")
    runs = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        eng = Engine(cfg, shape, params, mesh=m)
        with torch.no_grad():    # first calls: the communicator, handles
            eng.generate({"tokens": toks[:, :WARM_PROMPT]}, max_new_tokens=2)
        times = {"prefill": [], "decode": []}
        logits = []

        def timed(name, fn):
            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                lg, caches = fn(*args)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t)
                logits.append(lg.clone())
                return lg, caches
            return run

        eng.prefill = timed("prefill", eng.prefill)
        eng.decode = timed("decode", eng.decode)
        torch.cuda.reset_peak_memory_stats()
        FK.flash_attention.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            out, caches = eng.generate({"tokens": toks}, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del caches
        dec = sorted(times["decode"])
        runs[tag] = {"out": out, "logits": logits,
                     "prefill_ms": times["prefill"][0] * 1e3,
                     "decode_ms_median": dec[len(dec) // 2] * 1e3,
                     "decode_tok_s": B * len(dec) / sum(dec),
                     "generate_s": wall, "tok_s": B * new / wall,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "flash_launches": FK.flash_attention.launches}
        if m is not None:
            rules = eng.ctx.rules
    a, b = runs["mesh"], runs["plain"]
    logical = {n for tree in (M.model_specs(cfg), M.cache_pspecs(cfg, shape))
               for _, p in PM.tree_leaves_with_paths(tree) for n in p.logical}
    named = {n: rules[n] for n in MESH_SERVE_RULES
             if rules[n] and n in logical}
    n_attn = attention_layers(cfg)
    check(a["flash_launches"] == b["flash_launches"] == n_attn,
          f"{label} {arch}: flash launches {a['flash_launches']} on the mesh,"
          f" {b['flash_launches']} without, not one per attention layer "
          f"({n_attn})")
    check(len(a["logits"]) == new and all(
        bool(torch.isfinite(lg).all()) for lg in a["logits"]),
        f"{label} {arch}: non-finite logits on the mesh")
    check(bool(((a["out"] >= 0) & (a["out"] < cfg.padded_vocab)).all()),
          f"{label} {arch}: token ids out of range")
    check(torch.equal(a["logits"][0], b["logits"][0]),
          f"{label} {arch}: prefill logits differ on the mesh: max "
          f"{_abs_err(a['logits'][0], b['logits'][0])}")
    check(torch.equal(a["out"], b["out"]),
          f"{label} {arch}: tokens differ on the mesh")
    rel = [_relnorm(x, y) for x, y in zip(a["logits"][1:], b["logits"][1:])]
    bit = all(torch.equal(x, y) for x, y in zip(a["logits"], b["logits"]))
    check(max(rel) <= MESH_SERVE_RELNORM, f"{label} {arch}: decode logits "
          f"relnorm {max(rel)} against the run without a mesh (limit "
          f"{MESH_SERVE_RELNORM})")
    res = {"arch": arch, "layers": cfg.n_layers, "batch": B, "prompt": L,
           "new": new, "params": PM.count_params(M.model_specs(cfg)),
           "init_s": init_s, "rules": {k: list(v) for k, v in named.items()},
           "decode_relnorm_max": max(rel), "bit_equal": bit,
           **{tag: {k: v for k, v in r.items() if k not in ("out", "logits")}
              for tag, r in runs.items()}}
    for tag in ("plain", "mesh"):
        r = res[tag]
        say(f"  {label} {arch} {tag:5s}: prefill {r['prefill_ms']:.2f} ms, "
            f"decode step median {r['decode_ms_median']:.3f} ms, "
            f"{r['decode_tok_s']:.1f} decode tok/s, generate "
            f"{r['generate_s']:.3f} s = {r['tok_s']:.1f} tok/s, peak "
            f"{r['peak_gb']:.2f} GB, {r['flash_launches']} flash launches")
    say(f"  {label} {arch}: {cfg.n_layers} layers, {res['params'] / 1e9:.3f}"
        f" B params, {B} x {L} prompt tokens + {new} new; rules over the "
        f"mesh {named}; prefill logits and tokens equal, decode logits "
        f"{'bit-equal' if bit else f'relnorm {max(rel):.3g}'} (limit "
        f"{MESH_SERVE_RELNORM})")
    del params, runs, a, b
    return res


def mesh_serve_profile_child() -> None:
    """Phase 16's profiled generates, in a process of its own (the card's
    tracer records kernels in a process's first profiler session only):
    each MESH_SERVE model on the 1x1 NCCL smoke mesh, a short warm-up
    generate, then a generate of its prompt and PROFILE_NEW tokens under
    the profiler (its prefill and each decode step in the engine's own
    ``ft:engine.prefill`` and ``ft:engine.decode`` ranges): device busy
    time and idle share, the process group's ranges
    (``nccl:*``) and the device time launched inside them in the prefill
    and a decode step, NCCL's device events; prints the reports as JSON
    on its last line."""
    import gc
    import os
    import tempfile
    import torch
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.profile_serve import DEVICE_CATS, _report
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    FK.load_library()
    mesh = make_smoke_mesh("cuda")
    reps = {}
    for label, arch, n_layers, B, L, new in MESH_SERVE:
        cfg, toks = _mesh_serve_inputs(arch, n_layers, B, L)
        eng = Engine(cfg, ShapeSpec("serve", L + new, B, "decode"),
                     M.init_params(cfg, CASE_SEED), mesh=mesh)
        with torch.no_grad():
            eng.generate({"tokens": toks[:, :WARM_PROMPT]}, max_new_tokens=2)
            torch.cuda.synchronize()
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    eng.generate({"tokens": toks}, max_new_tokens=PROFILE_NEW)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                prof.export_chrome_trace(path)
                with open(path) as f:
                    trace = [e for e in json.load(f)["traceEvents"]
                             if e.get("ph") == "X"]
            finally:
                os.unlink(path)
        dev = [e for e in trace if e.get("cat") in DEVICE_CATS]
        check(len(dev) > 0, f"{label}: the profiled generate holds no "
              "device event")
        rep = _report(f"  {label} {arch} profiled generate on the mesh", wall,
                      dev, 6)
        nccl = [e["name"] for e in trace if e["name"].startswith("nccl:")]
        spans = {ph: [(e["ts"], e["ts"] + e["dur"]) for e in trace
                      if e.get("cat") == "user_annotation"
                      and e["name"] == f"ft:engine.{ph}"]
                 for ph in ("prefill", "decode")}
        host = [e for e in trace if e.get("cat") not in DEVICE_CATS]
        in_phase = {ph: _correlated_ms([e for e in host if any(
            a <= e["ts"] < b for a, b in sp)], dev, "nccl:")
            for ph, sp in spans.items()}
        rep.update({
            "profiled_new": PROFILE_NEW,
            "nccl_ranges": {n: nccl.count(n) for n in sorted(set(nccl))},
            "nccl_range_count": len(nccl),
            "nccl_range_ms": _correlated_ms(trace, dev, "nccl:"),
            "nccl_prefill_ms": in_phase["prefill"],
            "nccl_decode_ms_a_step": in_phase["decode"] / len(
                spans["decode"]),
            "nccl_device_events": sorted({e["name"] for e in dev
                                          if "nccl" in e["name"].lower()}),
            "flash_ms": sum(e["dur"] for e in dev
                            if "flash_bf16" in e["name"]) / 1e3})
        check(rep["nccl_range_count"] > 0 and len(spans["decode"]) ==
              PROFILE_NEW - 1, f"{label}: no NCCL range or not "
              f"{PROFILE_NEW - 1} decode steps in the profiled generate")
        print(f"  {label}: process-group ranges {rep['nccl_ranges']}, "
              f"{rep['nccl_range_ms']:.3f} ms of device time launched inside "
              f"them (prefill {rep['nccl_prefill_ms']:.3f} ms, a decode step "
              f"{rep['nccl_decode_ms_a_step']:.3f} ms); NCCL device events "
              f"{rep['nccl_device_events']}; flash {rep['flash_ms']:.3f} ms",
              flush=True)
        reps[label] = rep
        del eng, trace, dev
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(json.dumps(reps))


# ------------------------------------------------------- phases 10-11 ---
# ------------------------------------------------------------ phase 17 ---
#: phase 17a: the torch twins of the JAX examples, child processes on the
#: card started together: (file, arguments, time limit in seconds)
EXAMPLES = (("quickstart_torch.py", (), 300),
            ("serve_workflow_torch.py", (), 300),
            ("train_small_torch.py", ("--tiny",), 600))


def run_examples(say) -> dict:
    """Phase 17a: the twins of EXAMPLES started together on the card, each
    run to its end (its own assertions hold, exit 0); each one's wall
    time from the common start and the JSON summary it prints last,
    which holds its kernels' launch counts.  A child that outlives its
    limit is killed."""
    import threading
    t0 = time.perf_counter()
    runs = []
    for name, args, limit in EXAMPLES:
        proc = subprocess.Popen([sys.executable, str(ROOT / "examples" / name),
                                 *args], cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        runs.append({"name": name, "args": args, "limit": limit,
                     "proc": proc})

    def wait(r):
        try:
            r["out"], r["err"] = r["proc"].communicate(timeout=r["limit"])
        except subprocess.TimeoutExpired:
            r["proc"].kill()
            r["out"], r["err"] = r["proc"].communicate()
        r["wall"] = time.perf_counter() - t0
    threads = [threading.Thread(target=wait, args=(r,)) for r in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {}
    for r in runs:
        name, rc = r["name"], r["proc"].returncode
        check(rc == 0, f"17a: {name} exited {rc}:\n{r['out'][-3000:]}\n"
              f"{r['err'][-3000:]}")
        (key, rec), = json.loads(r["out"].strip().splitlines()[-1]).items()
        rec["wall_s"] = r["wall"]
        out[key] = rec
        say(f"  {name} {' '.join(r['args'])}: exit 0, {r['wall']:.2f} s "
            f"wall (the three run together); launches {rec['launches']}")
    q = out["quickstart"]["backend"]
    check(q["bytes_equal"] and q["device"].startswith("cuda"),
          f"17a: the quickstart's section 7 {q}")
    say(f"  quickstart section 7, 32 MB gpu1 -> gpu4 ({q['kind']}, "
        f"{q['n_batches']} trigger batches): ExecReport.wall_ms "
        f"{q['wall_ms']:.3f} on the card against {q['sim_ms']:.3f} "
        f"simulated ms (DGX-V100 NVLink)")
    t = out["train_small"]
    say(f"  train_small --tiny: loss {t['first_loss']:.3f} -> "
        f"{t['last_loss']:.3f}, step {t['step']}, resumed from step "
        f"{t['resumed_from']}")
    return out


def trace_against_card(say, step_ms: float) -> dict:
    """Phase 17b: 13c's step (MiniCPM-2B as published, TRAIN_BATCH x
    TRAIN_SEQ tokens in TRAIN_ACCUM microbatches, no mesh) traced on
    ``meta`` tensors by the dry-run (``dryrun.step_costs``), and one real
    step of it on the card under ``FlopCounterMode``, which does not see
    the flash kernels (``ctypes`` calls): the trace must count the card's
    FLOPs plus the full-square ``4 B Hq L L D`` of each flash launch,
    which the trace counts as the plain attention, plus, for each
    backward launch, what the trace counts for ``attention_bwd_ref``
    (``meta``'s backward) at that shape, counted here by the same
    ``FlopCounterMode`` over ``attention_bwd_ref`` on ``meta`` tensors.
    ``step_ms`` is 13c's warm step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.launch import dryrun as DRY
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import build_train_step
    cfg = get_arch(TRAIN_ARCH)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    trace = DRY.step_costs(cfg, shape, None, accum=TRAIN_ACCUM)
    trace_s = time.perf_counter() - t0

    oc = OptConfig(schedule=cfg.lr_schedule, total_steps=TRAIN_STEPS,
                   warmup_steps=max(TRAIN_STEPS // 10, 1))
    params = PM.trainable(M.init_params(cfg, 0))
    opt = init_opt_state(M.model_specs(cfg), oc.state_dtype, "cuda")
    step = build_train_step(cfg, M.build_ctx(cfg), oc, TRAIN_ACCUM)
    batch = Pipeline(cfg, shape, device="cuda").next_batch()
    FK.flash_attention.launches = FK.flash_attention_bwd.launches = 0
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    torch.cuda.synchronize()
    launches = FK.flash_attention.launches
    bwd = FK.flash_attention_bwd.launches
    del params, opt, batch
    card = fc.get_total_flops()
    mb, D = TRAIN_BATCH // TRAIN_ACCUM, cfg.resolved_head_dim
    per = 4 * mb * cfg.n_heads * TRAIN_SEQ ** 2 * D
    (*_, causal, window, _, _), = train_flash_cases()
    q = torch.empty((mb, cfg.n_heads, TRAIN_SEQ, D), dtype=torch.bfloat16,
                    device="meta")
    kv = torch.empty((mb, cfg.n_kv_heads, TRAIN_SEQ, D),
                     dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as fb:
        attention_bwd_ref(q, kv, kv, q, causal=causal, window=window)
    bwd_per = fb.get_total_flops()
    gap = trace["flops"] - (card + launches * per + bwd * bwd_per)
    if gap:                       # the difference, op by op
        from repro_torch.costs import CostCounter
        traced, args = DRY.build_step(cfg, shape, None, accum=TRAIN_ACCUM)
        with CostCounter() as c:
            traced(*args)
        got = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
        for op in sorted(set(got) | set(c.flops_by_op)):
            say(f"  {op}: trace {c.flops_by_op.get(op, 0)}, card "
                f"{got.get(op, 0)}")
    check(gap == 0, f"17b: trace {trace['flops']} FLOPs against the card's "
          f"{card} + {launches} flash launches x {per} + {bwd} backward "
          f"launches x {bwd_per} (a gap of {gap})")
    n_params = PM.count_params(M.model_specs(cfg))
    model_flops = 6 * n_params * TRAIN_BATCH * TRAIN_SEQ
    share = trace["flops"] / (step_ms * 1e-3 * BF16_FLOPS_PER_S)
    say(f"  trace ({trace_s:.2f} s on the host): {trace['flops']} FLOPs = "
        f"the card's {card} (FlopCounterMode) + {launches} flash launches x "
        f"{per} (4 B Hq L L D) + {bwd} backward launches x {bwd_per} "
        f"(attention_bwd_ref's count), equal; traffic "
        f"{trace['traffic_bytes']} B (unfused), collectives "
        f"{trace['collective_bytes']}")
    say(f"  trace FLOPs over 13c's warm step ({step_ms:.1f} ms) at 989 "
        f"TFLOP/s: {share:.4f}; model FLOPs 6 N D = {model_flops} over the "
        f"trace's: {model_flops / trace['flops']:.4f}")
    return {"trace_flops": trace["flops"], "card_flops": card,
            "flash_launches": launches, "flash_forward_flops": per,
            "flash_bwd_launches": bwd, "flash_backward_flops": bwd_per,
            "traffic_bytes": trace["traffic_bytes"],
            "collective_bytes": trace["collective_bytes"],
            "trace_s": trace_s, "step_ms": step_ms,
            "trace_flops_share": share,
            "model_over_trace": model_flops / trace["flops"]}


def port_lib():
    """The modules phases 10-11 build their runs from: the port's.  A test
    passes the JAX package's modules of the same names instead, to run
    the same scenario through the reference."""
    from types import SimpleNamespace
    from repro_torch.core import api, faults, migration, topology, transfer
    from repro_torch.serving import executor, modelcache, workflow
    return SimpleNamespace(api=api, faults=faults, migration=migration,
                           topology=topology, transfer=transfer,
                           executor=executor, modelcache=modelcache,
                           workflow=workflow)


def scaled(w, s: float):
    """A workflow with every edge, input and output ``s`` times its size."""
    import dataclasses
    if s == 1.0:
        return w
    return dataclasses.replace(
        w, stages=tuple(dataclasses.replace(
            st, deps=tuple((d, mb * s) for d, mb in st.deps))
            for st in w.stages),
        input_mb={k: v * s for k, v in w.input_mb.items()},
        output_mb={k: v * s for k, v in w.output_mb.items()})


def held_bytes(backend, tube) -> dict:
    """What the backend still holds, split by whether the index still
    knows the object: {("device"|"host", "live"|"lost"): [count, MB]}."""
    live = set(tube.index.global_table)
    out = {(k, s): [0, 0.0] for k in ("device", "host")
           for s in ("live", "lost")}
    for st in backend.stores.values():
        for did, obj in st.objects.items():
            cell = out["device" if st.device else "host",
                       "live" if did in live else "lost"]
            cell[0] += 1
            cell[1] += obj.nbytes / 2 ** 20
    return out


# ------------------------------------------------------------ phase 10 ---
#: the chaos run: DRIVING and TRAFFIC in turns, 10 ms apart, on two
#: simulated DGX nodes, under one seeded schedule of all four fault
#: kinds (seed chosen so that every kind fires, two transfers fail and
#: re-plan, and objects outlive the run in the index)
CHAOS_SEED, CHAOS_HORIZON_MS = 16, 120.0
CHAOS_FAULTS = {"n_link": 3, "n_brownout": 2, "n_node": 1, "n_host": 2}
CHAOS_FLOWS = ("driving", "traffic", "driving", "traffic")


def chaos_run(backend, check_bytes, *, scale: float = 1.0, seed: int = CHAOS_SEED,
              lib=None) -> dict:
    """A ``WorkflowEngine`` workload on ``cluster(2)`` under
    ``FaultInjector(FaultSchedule.generate(...))`` with its recovery
    ladder, the backend armed on the engine's tube (or none).  With a
    backend, ``check_bytes(backend, data_id, endpoint, size_mb)`` holds the
    bytes of every object the index knows after each fault fires and at
    the end, and of every transfer the simulator failed and re-planned
    when its last rung completes.  Returns the simulated trace and
    stats, which must not depend on the backend."""
    lib = lib or port_lib()
    topo = lib.topology.cluster(2)
    eng = lib.executor.WorkflowEngine(topo, lib.api.FAASTUBE)
    tube = eng.tube
    if backend is not None:
        tube.backend = tube.engine.backend = backend
    sched = lib.faults.FaultSchedule.generate(
        topo, seed=seed, horizon_ms=CHAOS_HORIZON_MS, **CHAOS_FAULTS)
    inj = lib.faults.FaultInjector(tube, sched,
                                   recovery=lib.transfer.RecoveryPolicy())
    checked = {"live": 0, "replans": []}

    def live_bytes():
        for did, rec in sorted(tube.index.global_table.items()):
            check_bytes(backend, did, rec.device, rec.size_mb)
            checked["live"] += 1

    fire = inj._fire

    def fired(f):
        fire(f)
        if backend is not None:
            live_bytes()

    inj._fire = fired
    inj.arm()
    attempt = tube.engine._attempt

    def rung(plan, t, on_done, on_fail, n, done_mb, handle=None):
        if n == 1 and plan.data_id and on_done is not None:
            inner = on_done

            def on_done(sim, tr, inner=inner, plan=plan):
                if tr is None or not tr.failed:
                    checked["replans"].append(
                        (plan.kind, plan.data_id, plan.src, plan.dst,
                         plan.size_mb, sim.now))
                    if backend is not None:
                        check_bytes(backend, plan.data_id, plan.dst,
                                    plan.size_mb)
                inner(sim, tr)
        return attempt(plan, t, on_done, on_fail, n, done_mb, handle)

    tube.engine._attempt = rung
    for i, name in enumerate(CHAOS_FLOWS):
        eng.submit_workflow(scaled(lib.workflow.WORKFLOWS[name], scale),
                            10.0 * i)
    eng.run()
    if backend is not None:
        live_bytes()
    return {
        "trace": sorted((tr.tid, tr.func, tr.t_submit, tr.t_done,
                         tr.failed, tr.chunks_done)
                        for tr in tube.sim.transfers.values()),
        "requests": sorted((r.rid, r.t_arrive, r.t_done, r.h2g_ms,
                            r.g2g_ms, r.compute_ms, bool(r.failed))
                           for r in eng.completed + eng.failed),
        "stats": dict(tube.stats), "fired": dict(inj.fired),
        "faults": sched.by_kind(), "retries": tube.engine.retries,
        "failures": tube.engine.failures, "n_events": tube.sim.n_events,
        "recovered_stages": eng.recovered_stages,
        "replans": checked["replans"], "checked": checked["live"],
        "live": sorted(tube.index.global_table), "tube": tube}


def chaos_phase(check_bytes, say) -> dict:
    """Phase 10: the chaos run at the paper's object sizes, on the card
    and without a backend; the two must agree exactly."""
    from repro_torch.core.backend_torch import TorchBackend
    plain = chaos_run(None, None)
    be = TorchBackend(store_mb=2048.0, host_mb=4096.0)
    t0 = time.perf_counter()
    res = chaos_run(be, check_bytes)
    wall = time.perf_counter() - t0
    for key in ("trace", "requests", "stats", "fired", "retries",
                "failures", "n_events", "replans", "live"):
        check(res[key] == plain[key],
              f"chaos: {key} changed with the backend armed")
    check(all(res["faults"][k] >= 1 for k in ("link", "brownout", "node",
                                               "host")),
          f"chaos: the schedule lacks a fault kind: {res['faults']}")
    check(all(res["fired"][k] >= 1 for k in ("link", "brownout", "node",
                                              "host")),
          f"chaos: a fault kind never fired: {res['fired']}")
    check(res["replans"], "chaos: no transfer failed and re-planned")
    check(len(res["requests"]) == len(CHAOS_FLOWS),
          f"chaos: {len(res['requests'])} requests ended")
    held = held_bytes(be, res["tube"])
    say(f"  schedule {res['faults']}, fired {res['fired']}; retries "
        f"{res['retries']}, terminal failures {res['failures']}, "
        f"recovered stages {res['recovered_stages']}, lost "
        f"{res['stats']['lost']}; {len(res['requests'])} requests "
        f"({sum(r[-1] for r in res['requests'])} failed); "
        f"{len(res['trace'])} sim transfers, {res['n_events']} events, "
        f"trace equal to the run without a backend; {wall:.2f} s")
    say(f"  bytes equal at {res['checked']} index entries (after each "
        f"fault and at the end; {len(res['live'])} live at the end) and "
        f"after {len(res['replans'])} re-planned transfers: "
        f"{[(k, d, s, t) for k, d, s, t, _mb, _t in res['replans']]}")
    say(f"  backend holds, live / lost to the index: device "
        f"{held['device', 'live'][0]} objects {held['device', 'live'][1]:.1f}"
        f" MB / {held['device', 'lost'][0]} objects "
        f"{held['device', 'lost'][1]:.1f} MB; hosts "
        f"{held['host', 'live'][0]} objects {held['host', 'live'][1]:.1f} MB"
        f" / {held['host', 'lost'][0]} objects "
        f"{held['host', 'lost'][1]:.1f} MB; {len(be.reports)} plans moved "
        f"bytes")
    res["held"] = {f"{k}/{s}": v for (k, s), v in held.items()}
    return res


# ------------------------------------------------------------ phase 11 ---
#: the swap tier: three checkpoints served from one GPU of the second
#: node, the registry on the first; MiniCPM-2B and Whisper prestaged on
#: the serving node's page-locked ring, Qwen2-VL registry-backed.  The
#: trace's seed is one under which, in both policies, MiniCPM-2B swaps in
#: from the node's ring (a host hit) and, after a demotion, from the
#: registry (cold), and the policies evict differently
SWAP_MODELS = (("minicpm-2b", True), ("qwen2-vl-2b", False),
               ("whisper-medium", True))
SWAP_GPU = "n1:gpu0"
SWAP_CAP_MB = 7000.0          # fits MiniCPM-2B + Whisper, not + Qwen2-VL
SWAP_HOST_MB = 7000.0         # the node's pinned checkpoint ring
SWAP_SEED, SWAP_REQUESTS, SWAP_IAT_MS = 32, 8, 400.0
#: PCIe 5.0 x16, one way: the host link's bound for a reload
PCIE5_BYTES_PER_S = 64e9


def swap_profiles(scale: float = 1.0, lib=None) -> list:
    """((ModelProfile, prestage), ...) of SWAP_MODELS from
    ``profile_from_arch``; ``scale`` shrinks every layer alike (tests)."""
    lib = lib or port_lib()
    M = lib.modelcache
    out = []
    for arch, prestage in SWAP_MODELS:
        p = M.profile_from_arch(arch)
        if scale != 1.0:
            p = M.make_profile(p.name, p.arch,
                               [mb * scale for mb in p.layer_mb])
        out.append((p, prestage))
    return out


def swap_trace(names, *, seed=SWAP_SEED, n=SWAP_REQUESTS, iat=SWAP_IAT_MS):
    """Seeded request trace: exponential gaps, models drawn uniformly."""
    import random
    r = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += r.expovariate(1.0 / iat)
        out.append((t, r.choice(names)))
    return out


def swap_run(backend, check_bytes, profiles, trace, *, policy: str,
             cap_mb: float = SWAP_CAP_MB, host_cache_mb: float = SWAP_HOST_MB,
             lib=None) -> dict:
    """``ModelCache`` over ``FaaSTube(cluster(2), store_cap_mb=cap_mb,
    backend=backend)``: ``profiles`` ((ModelProfile, prestage), ...)
    registered for SWAP_GPU, then ``trace`` ((t, name), ...) replayed.
    With a backend, every reload that lands is checked at SWAP_GPU with
    ``check_bytes(backend, data_id, SWAP_GPU, size_mb)``, and every eviction
    must leave no copy there.  Returns stats, ttft and what happened
    when, which must not depend on the backend."""
    import dataclasses
    lib = lib or port_lib()
    tube = lib.api.FaaSTube(
        lib.topology.cluster(2),
        dataclasses.replace(lib.api.FAASTUBE, store_cap_mb=cap_mb),
        backend=backend)
    mc = lib.modelcache.ModelCache(tube, policy=policy,
                                   host_cache_mb=host_cache_mb)
    puts = []
    if backend is not None:
        put = backend.put_object

        def timed_put(data_id, endpoint, payload=None, size_mb=None):
            t0 = time.perf_counter()
            obj = put(data_id, endpoint, payload, size_mb)
            puts.append((data_id, endpoint, obj.nbytes, tube.sim.now,
                         time.perf_counter() - t0))
            return obj
        backend.put_object = timed_put
    for p, prestage in profiles:
        mc.register(p, SWAP_GPU, 0.0, prestage=prestage)
    loads, evictions = [], []
    reload_complete = tube._reload_complete

    def landed(item, rec, dst, sim):
        reload_complete(item, rec, dst, sim)
        if item.data_id.startswith("ckpt:") \
                and item.state == lib.migration.DEVICE:
            loads.append((item.data_id, sim.now))
            if backend is not None:
                check_bytes(backend, item.data_id, dst, item.size_mb)

    tube._reload_complete = landed
    evict = mc._evict

    def evicted(e, now):
        evict(e, now)
        evictions.append((e.data_id, now))
        if backend is not None:
            check(SWAP_GPU not in backend.where(e.data_id),
                  f"{e.data_id}: a device copy outlived its eviction")

    mc._evict = evicted
    for t, name in trace:
        tube.sim.call_at(t, lambda sim, n=name, t=t: mc.request(n, t))
    tube.sim.run()
    # the reloads on the simulated clock, in submission order
    sim_loads = [(tr.func, tr.t_submit, tr.t_done)
                 for _tid, tr in sorted(tube.sim.transfers.items())
                 if tr.func in mc.entries]
    return {"stats": dict(mc.stats), "ttft": list(mc.ttft), "loads": loads,
            "evictions": evictions, "sim_loads": sim_loads, "puts": puts,
            "tube": tube, "mc": mc}


def _ckpt_check(oracles):
    """check(backend, data_id, endpoint, size_mb) that compares a
    checkpoint's rows with synth_payload on the card; the oracle is made
    once per checkpoint and kept in device memory."""
    import torch
    from repro_torch.core.backend_torch import _index, _run, nbytes_of, \
        synth_payload

    def check_ckpt(backend, did, ep, mb):
        n = nbytes_of(mb)
        want = oracles.get(did)
        if want is None:
            want = oracles[did] = torch.from_numpy(
                synth_payload(did, n)).to(backend.device)
        st = backend.stores[ep]
        rows = st.objects[did].rows
        step = 256                    # 512 MiB of rows at a time
        for s in range(0, len(rows), step):
            part = rows[s:s + step]
            run = _run(part)
            got = st.slabs[run] if run is not None else \
                st.slabs[_index(part).to(st.slabs.device)]
            lo = s * st.slabs.shape[1]
            hi = min(n, lo + got.numel())
            check(got.view(-1)[:hi - lo].equal(want[lo:hi]),
                  f"{did} at {ep}: bytes differ from synth_payload")
    return check_ckpt


def swap_yardsticks(backend, profiles) -> dict:
    """Per checkpoint: bytes, the PCIe 5.0 bound, one plain page-locked
    -> device ``copy_`` of the same bytes (from the host store that holds
    it, CUDA events, best of 3), and the host-side staging copy alone
    (the same bytes through one ring window, trigger batch by batch)."""
    import torch
    from repro_torch.core.backend_torch import _run, nbytes_of
    out = {}
    for p, _ in profiles:
        did = f"ckpt:{p.name}"
        host = next(ep for ep in backend.where(did)
                    if not backend.stores[ep].device)
        st = backend.stores[host]
        run = _run(st.objects[did].rows)
        check(run is not None and st.slabs.is_pinned(),
              f"{did} at {host}: not one run of page-locked rows")
        src = st.slabs[run]
        dst = torch.empty_like(src, device=backend.device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        copy_ms = []
        for _ in range(3):
            e0.record()
            dst.copy_(src, non_blocking=True)
            e1.record()
            e1.synchronize()
            copy_ms.append(e0.elapsed_time(e1))
        del dst
        win = backend.ring_for(host).buf[:backend.batch_chunks]
        t0 = time.perf_counter()
        for s in range(0, src.shape[0], backend.batch_chunks):
            part = src[s:s + backend.batch_chunks]
            win[:part.shape[0]].copy_(part)
        stage_ms = (time.perf_counter() - t0) * 1e3
        n = nbytes_of(p.total_mb)
        out[p.name] = {"bytes": n, "bound_ms": n / PCIE5_BYTES_PER_S * 1e3,
                       "copy_ms": min(copy_ms), "stage_ms": stage_ms}
    torch.cuda.empty_cache()
    return out


def swap_policy(policy: str, profiles, trace, check_ckpt, say, *,
                cap: float, host_cache: float) -> dict:
    """One policy of phase 11: the run without a backend, then on a fresh
    ``TorchBackend``; checks, prints and returns what phase 11 reports.
    The backend and its page-locked stores are freed on return."""
    import resource
    import torch
    from repro_torch.core.backend_torch import TorchBackend, nbytes_of
    from repro_torch.core.transfer import host_of
    byname = {p.name: p for p, _ in profiles}
    total_mb = sum(p.total_mb for p, _ in profiles)
    kw = {"policy": policy, "cap_mb": cap, "host_cache_mb": host_cache}
    plain = swap_run(None, None, profiles, trace, **kw)
    torch.cuda.reset_peak_memory_stats()
    be = TorchBackend(store_mb=cap + 64.0, host_mb=total_mb + 64.0)
    # every store at its full size and both staging rings made before the
    # run: no reload pays a store's growth or a ring's first page-locked
    # allocation, no page-locked store regrows mid-run
    hosts = (host_of(SWAP_GPU), "n0:host")       # serving node, registry
    grow = {ep: be.reserve(ep, mb) for ep, mb in (
        (SWAP_GPU, cap + 64.0), *((h, total_mb + 64.0) for h in hosts))}
    for h in hosts:
        be.ring_for(h)
    t0 = time.perf_counter()
    res = swap_run(be, check_ckpt, profiles, trace, **kw)
    wall = time.perf_counter() - t0
    for key in ("stats", "ttft", "loads", "evictions", "sim_loads"):
        check(res[key] == plain[key],
              f"swap {policy}: {key} changed with the backend armed")
    s = res["stats"]
    check(s["host_hits"] >= 1 and s["cold_misses"] >= 1
          and s["evictions"] >= 1,
          f"swap {policy}: needs a host hit, a cold miss and an eviction: "
          f"{s}")
    check(len(res["ttft"]) == len(trace) and not s["failed_requests"],
          f"swap {policy}: {len(res['ttft'])} of {len(trace)} served")
    peak = be.stores[SWAP_GPU].pool.peak_used_mb
    check(peak <= cap, f"swap {policy}: device store peaked at {peak} MB "
          f"over the {cap} MB cap")
    say(f"  policy {policy}: {s}; ttft ms "
        f"{[round(x, 3) for _a, x, _c in res['ttft']]}; "
        f"{len(res['loads'])} loads byte-equal on the card, "
        f"{len(res['evictions'])} evictions left no device copy; stats, "
        f"ttft and load times equal to the run without a backend; "
        f"{wall:.2f} s")
    for did, ep, n, t_sim, secs in res["puts"]:
        say(f"    put {did} at {ep} (sim t {t_sim:.3f} ms): {n / 1e9:.3f}"
            f" GB synthesised and written in {secs:.3f} s"
            f"{' (a reload source missing on its host)' if t_sim else ''}")
    rows = []
    sims = iter(res["sim_loads"])
    for rep in be.reports:
        if rep.dst != SWAP_GPU:
            continue
        p = byname[rep.func]
        n = nbytes_of(rep.size_mb)
        first = next(ms for mb, ms in rep.events if mb >= p.layer_mb[0])
        path = "host hit" if rep.src == host_of(SWAP_GPU) else "cold"
        _f, t_sub, t_done = next(sims)
        rows.append({"policy": policy, "model": p.name, "path": path,
                     "src": rep.src, "bytes": n, "wall_ms": rep.wall_ms,
                     "gb_s": n / rep.wall_ms / 1e6, "first_layer_ms": first,
                     "first_layer_mb": p.layer_mb[0],
                     "sim_ms": t_done - t_sub, "batches": rep.n_batches})
        say(f"    reload {p.name} {n / 1e9:.3f} GB {path} "
            f"({rep.src}->{rep.dst}): wall {rep.wall_ms:.1f} ms = "
            f"{rows[-1]['gb_s']:.2f} GB/s, first layer "
            f"({p.layer_mb[0]:.1f} MB) landed at {first:.1f} ms; "
            f"simulated {rows[-1]['sim_ms']:.1f} ms")
    for st in be.stores.values():
        say(f"    store {st.name}: {st.slabs.shape[0] * 2} MiB "
            f"{'on ' + str(st.slabs.device) if st.device else 'pinned'}, "
            f"peak {st.pool.peak_used_mb:.0f} MB used, growth "
            f"{st.grow_s:.3f} s")
    pinned = sum(st.slabs.numel() for st in be.stores.values()
                 if not st.device) + sum(r.buf.numel()
                                         for r in be.rings.values())
    device_peak = torch.cuda.max_memory_allocated()
    say(f"    page-locked {pinned / 1e9:.2f} GB (stores + rings; reserved up"
        f" front in {', '.join(f'{ep} {x:.3f} s' for ep, x in grow.items())}"
        f"), device peak {device_peak / 1e9:.2f} GB (the checks' oracles "
        f"included), host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB")
    return {"stats": s, "ttft": res["ttft"], "reloads": rows,
            "pinned_gb": pinned / 1e9, "device_peak_gb": device_peak / 1e9,
            "yardsticks": swap_yardsticks(be, profiles)
            if policy == "lru" else None}


def swap_phase(say, scale: float = 1.0) -> dict:
    """Phase 11: the swap tier at real checkpoint sizes (``scale`` < 1
    shrinks the checkpoints, the caps and the gaps alike, for a short
    test), under both policies, on the card and without a backend."""
    import gc
    import torch
    profiles = swap_profiles(scale)
    check(scale != 1.0 or ([round(p.total_mb, 1) for p, _ in profiles]
                           == [5450.7, 3554.3, 817.2]
                           and profiles[0][0].n_layers == 41),
          f"profiles: {[(p.name, p.n_layers, p.total_mb) for p, _ in profiles]}")
    trace = swap_trace([p.name for p, _ in profiles], iat=SWAP_IAT_MS * scale)
    check_ckpt = _ckpt_check({})
    out = {"reloads": []}
    for policy in ("slo", "lru"):
        res = swap_policy(policy, profiles, trace, check_ckpt, say,
                          cap=SWAP_CAP_MB * scale,
                          host_cache=SWAP_HOST_MB * scale)
        out["reloads"] += res.pop("reloads")
        out[policy] = res
        gc.collect()                  # the policy's backend, stores, rings
        torch.cuda.empty_cache()
    out["yardsticks"] = out["lru"].pop("yardsticks")
    out["slo"].pop("yardsticks")
    for name, y in out["yardsticks"].items():
        say(f"    {name}: {y['bytes'] / 1e9:.3f} GB, bound {y['bound_ms']:.1f}"
            f" ms at 64 GB/s, plain copy_ {y['copy_ms']:.1f} ms = "
            f"{y['bytes'] / y['copy_ms'] / 1e6:.2f} GB/s, host staging "
            f"copy alone {y['stage_ms']:.1f} ms = "
            f"{y['bytes'] / y['stage_ms'] / 1e6:.2f} GB/s")
    return out


# --------------------------------------------------------------- main ---
def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port at {SRC / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.backend_torch import (
        TorchBackend, nbytes_of, synth_payload)
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunked_copy import kernel as K
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK

    say = lambda *a: print(*a, flush=True)          # noqa: E731
    card = smi()
    kind = torch.cuda.get_device_name(0)
    say(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    say(card)
    probe = "synth-probe"
    check(np.array_equal(synth_payload(probe, 4099), np.random.default_rng(
        zlib.crc32(probe.encode())).integers(0, 256, 4099, dtype=np.uint8)),
        "synth_payload differs from numpy's uint8 draw")

    t0 = time.perf_counter()
    built = _build.build_all([K.SOURCE, FK.SOURCE, FK.BWD_SOURCE,
                              PK.SOURCE, DK.SOURCE])
    say(f"[2] nvcc for sm_90a, {len(built)} sources in parallel: "
        f"{time.perf_counter() - t0:.2f} s wall")
    for src, secs in built.items():
        lib = _build.library_path(src)
        regs = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                .splitlines() if "registers" in ln or "spill" in ln]
        say(f"  {lib.relative_to(ROOT)}: {secs:.2f} s; {regs}")
    for mod in (K, FK, PK, DK):
        mod.load_library()
    FK.load_bwd_library()
    for dt in (torch.bfloat16, torch.float32):
        for D in FK.HEAD_DIMS:
            inst = FK.describe(D, dt)
            say(f"  flash {str(dt).removeprefix('torch.')} D={D}: {inst}")
            if D == 64 and dt == torch.bfloat16:
                check(inst["local_bytes"] == 0,
                      f"the bf16 D=64 flash kernel spills: {inst}")
    for dt in (torch.bfloat16, torch.float32):
        for D in FK.HEAD_DIMS:
            inst = FK.bwd_describe(D, dt)
            say(f"  flash backward {str(dt).removeprefix('torch.')} D={D}: "
                f"{inst}")
            if dt == torch.bfloat16:
                check(all(k["local_bytes"] == 0 for k in inst.values()),
                      f"the bf16 D={D} flash backward spills: {inst}")
    for dt in (torch.bfloat16, torch.float32):
        for D in PK.HEAD_DIMS:
            inst = PK.describe(D, dt)
            say(f"  paged {str(dt).removeprefix('torch.')} D={D}: {inst}")
            if dt == torch.bfloat16:
                check(inst["local_bytes"] == 0,
                      f"the bf16 D={D} paged kernel spills: {inst}")
    for dt in (torch.bfloat16, torch.float32):
        for D in DK.HEAD_DIMS:
            for gb in (1, 2, 4, 8):
                for kern in DK.KERNELS:
                    inst = DK.describe(kern, D, dt, gb)
                    if gb in (1, 8):
                        say(f"  {kern} {str(dt).removeprefix('torch.')} "
                            f"D={D} GB={gb}: {inst}")
                    if dt == torch.bfloat16:
                        check(inst["local_bytes"] == 0,
                              f"the bf16 D={D} GB={gb} {kern} spills: "
                              f"{inst}")
    say(f"  paged split plan: resident blocks by head dim "
        f"{ {D: PK.resident_slots(D, 0) for D in PK.HEAD_DIMS} } "
        f"(bf16 blocks an SM x "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs)")

    worst = kernel_cases("cuda")
    say(f"[3] kernels byte-equal to their plain versions "
        f"(max_abs_err {worst})")
    times = {m: kernel_times(m, "cuda") for m in (5, 64)}
    for m, res in times.items():
        for name, r in res.items():
            say(f"  {name} M={m} x 2 MiB: kernel {r['ms']:.5f} ms "
                f"(eager call {r['call_ms']:.5f} ms), plain "
                f"{r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms,"
                f" bound {r['bound_ms']:.5f} ms ({r['bytes']} B at 3.35 "
                f"TB/s), {r['bound_ms'] / r['ms']:.3f} of the bound")

    oracles: dict = {}

    def check_bytes(owner, did, ep, mb):
        # reading an object back from a device store launches the gather;
        # those launches check the path and stay out of its counts
        counts = K.gather_chunks.launches, K.scatter_chunks.launches
        be = getattr(owner, "backend", owner)
        want = oracles.get((did, mb))
        if want is None:
            want = oracles[(did, mb)] = synth_payload(did, nbytes_of(mb))
        check(np.array_equal(be.read_object(did, ep), want),
              f"{did} at {ep}: bytes differ from synth_payload")
        K.gather_chunks.launches, K.scatter_chunks.launches = counts

    # ---- the main path, counted from here -------------------------------
    K.gather_chunks.launches = K.scatter_chunks.launches = 0
    t0 = time.perf_counter()
    plain_trace, _ = workflows(None, check_bytes)
    trace, tube = workflows("torch", check_bytes)
    check(trace == plain_trace, "simulated trace changed with the backend")
    say(f"[4] facade DRIVING + TRAFFIC at 128/96/64 MB: bytes equal, "
        f"sim trace equal ({len(trace)} events), "
        f"{time.perf_counter() - t0:.2f} s")
    for rep in tube.backend.reports:
        label = "H100, same-device g2g" if rep.kind == "g2g" else rep.kind
        say(f"  {rep.kind:9s} {rep.src}->{rep.dst} {rep.size_mb} MB "
            f"{rep.staging}: wall_ms {rep.wall_ms:.3f}, MB/s "
            f"{rep.size_mb / rep.wall_ms * 1e3:.1f} ({label})")
    g0, s0 = K.gather_chunks.launches, K.scatter_chunks.launches
    tube.store("prod", "one_g2g", SIZE_MB, "gpu0", tube.sim.now)
    tube.sim.run()
    g1, s1 = K.gather_chunks.launches, K.scatter_chunks.launches
    tube.fetch("cons", "one_g2g", "gpu1", tube.sim.now)
    tube.sim.run()
    per_fetch = (K.gather_chunks.launches - g1,
                 K.scatter_chunks.launches - s1)
    say(f"  one 128 MB g2g fetch: {per_fetch[0]} gathers + {per_fetch[1]} "
        f"scatters (the put before it: {g1 - g0} + {s1 - s0})")
    phase4 = (K.gather_chunks.launches, K.scatter_chunks.launches)

    t0 = time.perf_counter()
    say("[5] nine plan kinds x both stagings at 128 MB")
    plan_matrix(TorchBackend(), check_bytes, say)
    say(f"  {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    tube6, spilled = spill_reload("torch", check_bytes)
    be = tube6.backend
    say(f"[6] spill/reload at store cap {tube6.cfg.store_cap_mb} MB: "
        f"{len(spilled)} spilled, {spilled[0]} reloaded to gpu2 intact, "
        f"{time.perf_counter() - t0:.2f} s")
    for st in be.stores.values():
        if st.device:
            check(st.slabs.is_cuda, f"{st.name}: slabs not on the card")
        else:
            check(st.slabs.is_pinned(), f"{st.name}: host store not pinned")
        say(f"  store {st.name}: {st.slabs.shape[0] * 2} MB "
            f"{'on ' + str(st.slabs.device) if st.device else 'pinned'}, "
            f"growth {st.grow_s:.3f} s")
    for ring in be.rings.values():
        check(ring.buf.is_pinned(), f"ring {ring.host} not pinned")
    for rep in be.reports:
        say(f"  {rep.kind:9s} {rep.src}->{rep.dst} {rep.size_mb} MB: "
            f"wall_ms {rep.wall_ms:.3f}, MB/s "
            f"{rep.size_mb / rep.wall_ms * 1e3:.1f}")
    launches = {"gather_chunks": K.gather_chunks.launches,
                "scatter_chunks": K.scatter_chunks.launches}
    say(f"  launches on the main path: {launches} "
        f"(after phase 4: {phase4})")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")

    t0 = time.perf_counter()
    attn_err = attention_cases()
    attn_err.update(flash_bwd_cases())
    say(f"[7] attention kernels match their plain versions at "
        f"{len(FLASH_CASES)} + {len(model_flash_cases())} (phase 12's: "
        f"{model_flash_cases()}) flash, {len(PAGED_CASES)} paged and "
        f"{len(FLASH_BWD_CASES)} + 2 (training) flash backward shapes, "
        f"f32 and bf16; max_abs_err (paged and backward bf16 also "
        f"row-relative) "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in attn_err.items()} }")
    attn = attention_times()
    for name, r in attn.items():
        lib_ms = "-" if r["library_ms"] is None else (
            f"{r['library_ms']:.5f} (kernel / library "
            f"{r['ms'] / r['library_ms']:.3f})")
        extra = "" if "contiguous_sdpa_ms" not in r else (
            f"; split_plan {r['split_plan']}, L2 evicted "
            f"{r['l2_evicted_ms']:.5f} ms ({r['bound_ms'] / r['l2_evicted_ms']:.3f}"
            f" of the bound), SDPA on a contiguous cache "
            f"{r['contiguous_sdpa_ms']:.5f} ms (outputs differ by "
            f"{r['sdpa_row_rel_err']:.3g} row-relative)")
        if "passes_ms" in r:
            extra = (f"; split_plan {r['split_plan']}, each pass "
                     f"{r['passes_ms']}, eager call {r['call_ms']:.5f} ms, "
                     f"outputs differ from SDPA's by "
                     f"{r['sdpa_row_rel_err']:.3g} row-relative")
        if "attention_bwd_ref_ms" in r:
            extra = (f"; attention_bwd_ref (the training path's backward "
                     f"before the kernel) {r['attention_bwd_ref_ms']:.5f} ms"
                     f"; each kernel, profiled {r['kernels_ms']}; dQ scratch "
                     f"{r['dq_scratch_bytes']} B")
        say(f"  {name} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, library {lib_ms} ms, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']} B at "
            f"3.35 TB/s, {r['flops']} flop at 989 TFLOP/s), "
            f"{r['bound_ms'] / r['ms']:.3f} of the bound{extra}")
    say(f"  {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    say("[8] Engine.generate, reduced f32, card against CPU")
    reduced_serving(say)
    say(f"  {time.perf_counter() - t0:.2f} s")

    # ---- the serving path, counted from here ----------------------------
    t0 = time.perf_counter()
    say("[9] Engine(minicpm-2b) at full width on the card")
    K.gather_chunks.launches = K.scatter_chunks.launches = 0
    FK.flash_attention.launches = PK.paged_attention.launches = 0
    DK.decode_scores.launches = DK.decode_values.launches = 0
    full = full_width(say)
    serving = {"flash_attention": FK.flash_attention.launches,
               "paged_attention": PK.paged_attention.launches,
               "decode_attention": DK.decode_scores.launches}
    say(f"  launches on the serving path: {serving}, chunked copy "
        f"{K.gather_chunks.launches} + {K.scatter_chunks.launches}; "
        f"{time.perf_counter() - t0:.2f} s")
    check(serving["flash_attention"] == 40,
          f"flash_attention launched {serving['flash_attention']} times in "
          "the full-width generate, not once per layer (40)")
    check(serving["paged_attention"] > 0,
          "paged_attention never launched on the serving path")
    # each decode step once a layer, and the paged check's one call
    check(DK.decode_scores.launches == DK.decode_values.launches
          == 40 * (FULL_NEW - 1) + 1,
          f"decode attention launched {DK.decode_scores.launches} + "
          f"{DK.decode_values.launches} times in the full-width generate, "
          f"not once a layer a step ({40 * (FULL_NEW - 1) + 1})")
    launches.update(serving)

    # ---- the chaos run, counted from here ---------------------------------
    t0 = time.perf_counter()
    say("[10] chaos with real bytes: DRIVING + TRAFFIC on cluster(2) under "
        "a seeded schedule of link, brownout, node and host faults")
    K.gather_chunks.launches = K.scatter_chunks.launches = 0
    chaos = chaos_phase(check_bytes, say)
    by_phase = {"4-6": (launches["gather_chunks"], launches["scatter_chunks"]),
                "10": (K.gather_chunks.launches, K.scatter_chunks.launches)}
    say(f"  {time.perf_counter() - t0:.2f} s")
    check(all(by_phase["10"]), f"a copy kernel never launched in the chaos "
          f"run: {by_phase['10']}")

    # ---- the swap tier, counted from here ---------------------------------
    t0 = time.perf_counter()
    say(f"[11] the swap tier: {', '.join(a for a, _ in SWAP_MODELS)} "
        f"swapped through {SWAP_GPU} under a {SWAP_CAP_MB:.0f} MB cap")
    K.gather_chunks.launches = K.scatter_chunks.launches = 0
    swap = swap_phase(say)
    by_phase["11"] = (K.gather_chunks.launches, K.scatter_chunks.launches)
    say(f"  {time.perf_counter() - t0:.2f} s")
    check(by_phase["11"][1] > 0,
          "scatter_chunks never launched in the swap tier's reloads")
    for i, name in enumerate(("gather_chunks", "scatter_chunks")):
        launches[name] = sum(v[i] for v in by_phase.values())
    say(f"  copy-kernel launches by phase (gather, scatter): {by_phase}; "
        f"in all {launches['gather_chunks']}, {launches['scatter_chunks']}")
    # the data plane's stores (phases 4-6) on the card go before phase 12
    del tube, tube6, be
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the other families at full width, counted per model ------------
    t0 = time.perf_counter()
    say(f"[12] {', '.join(a for a, *_ in FULL_MODELS)} at full width "
        f"through Engine.generate, {FULL_BATCH} requests x {FULL_NEW} new "
        f"tokens each")
    K.gather_chunks.launches = K.scatter_chunks.launches = 0
    PK.paged_attention.launches = 0
    models = full_models(say)
    flash_by_phase = {"9": serving["flash_attention"],
                      "12": {a: r["flash_launches"] for a, r in models.items()}}
    launches["flash_attention"] += sum(flash_by_phase["12"].values())
    say(f"  flash_attention launches by phase: {flash_by_phase}, in all "
        f"{launches['flash_attention']}; chunked copy "
        f"{K.gather_chunks.launches} + {K.scatter_chunks.launches}, paged "
        f"{PK.paged_attention.launches}; {time.perf_counter() - t0:.2f} s")

    # ---- the training path, counted from 13c's start to its end ---------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    say(f"[13a] build_train_step, reduced f32, {TRAIN_ACCUM} microbatches, "
        f"card against CPU")
    train_reduced = reduced_training(say)
    say(f"  {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    say(f"[13b] {TRAIN_ARCH} at full width: loss and gradient through the "
        f"kernel against the plain attention")
    gradient = full_width_gradient(say)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    say(f"[13c] {TRAIN_ARCH} at full width through run_training: "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{TRAIN_ACCUM} microbatches, bf16, f32 AdamW moments, WSD")
    training, train_state, train_oc, first_step = full_width_training(say)
    flash_by_phase["13c"] = training["flash_launches"]
    launches["flash_attention"] += training["flash_launches"]
    bwd_by_phase = {"13c": training["flash_bwd_launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    training["profile"] = profile_train_step(train_state, train_oc, say)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    say("[13d] checkpoint round trip at full width, then recovery on the "
        "card")
    ckpt = checkpoint_round_trip(train_state, say)
    del train_state
    gc.collect()
    torch.cuda.empty_cache()
    recovery = recovery_on_card(say)
    say(f"  flash_attention launches by phase: {flash_by_phase}, in all "
        f"{launches['flash_attention']}; flash_attention_bwd {bwd_by_phase}; "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- the mesh training path, counted from 14b's start to its end -----
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    make_smoke_mesh("cuda")
    backend = dist.get_backend()
    say(f"[14a] make_smoke_mesh('cuda'): process group backend {backend}, "
        f"world size {dist.get_world_size()}")
    check(backend == "nccl", f"14a: the card's mesh runs on {backend}")
    say(f"[14b] {TRAIN_ARCH} at full width through run_training on the 1x1 "
        f"NCCL mesh: 13c's first {MESH_STEPS} steps again")
    mesh_train = mesh_training(first_step, train_oc, say)
    del first_step
    flash_by_phase["14b"] = mesh_train["flash_launches"]
    launches["flash_attention"] += mesh_train["flash_launches"]
    bwd_by_phase["14b"] = mesh_train["flash_bwd_launches"]
    gc.collect()
    torch.cuda.empty_cache()
    mesh_train["profile"] = child_report(say)
    say(f"  {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    say("[14c] int8 gradient compression on the card")
    mesh_comp = mesh_compression(say)
    gc.collect()
    torch.cuda.empty_cache()
    say("[14d] resharding permutes on the 1x1 mesh")
    mesh_perm = mesh_resharding(say)
    say(f"  flash_attention launches by phase: {flash_by_phase}, in all "
        f"{launches['flash_attention']}; {time.perf_counter() - t0:.2f} s")

    # ---- the weight-sharding path, counted from 15a's start to its end ---
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    say(f"[15a] {MOE_ARCH} at full width, {MOE_LAYERS} layer, through "
        f"run_training on the 1x1 NCCL mesh with the MoE training rules: "
        f"{MOE_STEPS} steps of {MOE_BATCH} x {MOE_SEQ} tokens, bf16, "
        f"{MOE_STATE} AdamW moments, WSD")
    moe_train = moe_mesh_training(say)
    flash_by_phase["15"] = moe_train["flash_launches"]
    launches["flash_attention"] += moe_train["flash_launches"]
    bwd_by_phase["15"] = moe_train["flash_bwd_launches"]
    gc.collect()
    torch.cuda.empty_cache()
    moe_train["profile"] = child_report(say, "moe_profile_child")
    say(f"  {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    say(f"[15b] {', '.join(MOE_REDUCED)} reduced, f32, one step on the 1x1 "
        f"mesh, card against CPU")
    moe_reduced = moe_reduced_on_mesh(say)
    dist.destroy_process_group()
    say(f"  flash_attention launches by phase: {flash_by_phase}, in all "
        f"{launches['flash_attention']}; {time.perf_counter() - t0:.2f} s")

    # ---- serving on the mesh, counted per model over its mesh run -------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    say(f"[16] {', '.join(f'{r[0]} {r[1]}' for r in MESH_SERVE)} at full "
        f"width through Engine on the 1x1 NCCL mesh under the serving "
        f"rules, each against the same engine without a mesh")
    mesh_serving = {}
    for row in MESH_SERVE:
        mesh_serving[row[0]] = mesh_serve_model(*row, say)
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    flash_by_phase["16"] = {k: r["mesh"]["flash_launches"]
                            for k, r in mesh_serving.items()}
    launches["flash_attention"] += sum(flash_by_phase["16"].values())
    for k, rep in child_report(say, "mesh_serve_profile_child").items():
        mesh_serving[k]["profile"] = rep
    say(f"  flash_attention launches by phase: {flash_by_phase}, in all "
        f"{launches['flash_attention']}; {time.perf_counter() - t0:.2f} s")

    # ---- the examples and the dry-run's trace, counted per run ----------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    say(f"[17a] the torch twins of the JAX examples, child processes on "
        f"the card started together: "
        f"{', '.join(' '.join((n, *a)) for n, a, _ in EXAMPLES)}")
    examples = run_examples(say)
    t1 = time.perf_counter()
    say(f"[17b] the dry-run's trace of 13c's step on meta tensors against "
        f"the same step on the card under FlopCounterMode")
    flops_check = trace_against_card(say, training["steps"][-1]["ms"])
    gc.collect()
    torch.cuda.empty_cache()
    flash_by_phase["17"] = {k: r["launches"]["flash_attention"]
                            for k, r in examples.items()}
    flash_by_phase["17"]["17b"] = flops_check["flash_launches"]
    launches["flash_attention"] += sum(flash_by_phase["17"].values())
    bwd_by_phase["17"] = {k: r["launches"].get("flash_attention_bwd", 0)
                          for k, r in examples.items()}
    bwd_by_phase["17"]["17b"] = flops_check["flash_bwd_launches"]
    check(bwd_by_phase["17"]["train_small"] > 0
          and bwd_by_phase["17"]["17b"] > 0,
          f"17: a training run launched no flash backward: "
          f"{bwd_by_phase['17']}")
    launches["flash_attention_bwd"] = sum(
        sum(v.values()) if isinstance(v, dict) else v
        for v in bwd_by_phase.values())
    for name in ("gather_chunks", "scatter_chunks"):
        n = examples["quickstart"]["launches"][name]
        check(n > 0, f"17a: {name} never launched in the quickstart")
        launches[name] += n
    check(all(flash_by_phase["17"].values()),
          f"17: a run launched no flash kernel: {flash_by_phase['17']}")
    say(f"  17a {t1 - t0:.2f} s, 17b {time.perf_counter() - t1:.2f} s; "
        f"flash_attention launches by phase: {flash_by_phase}, in all "
        f"{launches['flash_attention']}; flash_attention_bwd by phase "
        f"{bwd_by_phase}, in all {launches['flash_attention_bwd']}; chunked "
        f"copy in all {launches['gather_chunks']} + "
        f"{launches['scatter_chunks']}")

    replaces = {"gather_chunks": "src/repro/kernels/chunked_copy/kernel.py:37",
                "scatter_chunks": "src/repro/kernels/chunked_copy/kernel.py:59",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:65",
                "paged_attention":
                    "src/repro/kernels/paged_attention/kernel.py:64",
                "decode_attention": "src/repro/models/attention.py:"
                                    "decode_attention (plain jnp, no Pallas "
                                    "kernel)",
                "flash_attention_bwd": "src/repro/models/attention.py:92"}
    kernels = []
    for name in ("gather_chunks", "scatter_chunks"):
        r5, r64 = times[5][name], times[64][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/chunked_copy.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst, "byte_equal": True,
            "shape": "M=5 rows of 2 MiB uint8 from a 512-row pool",
            "ms": r5["ms"], "plain_ms": r5["plain_ms"],
            "bound_ms": r5["bound_ms"], "bound_by": "bytes",
            "library_ms": r5["library_ms"], "call_ms": r5["call_ms"],
            "m64": {k: r64[k] for k in ("ms", "call_ms", "plain_ms",
                                        "library_ms", "bound_ms")}})
    for name in ("flash_attention", "paged_attention", "decode_attention"):
        r = attn[name]
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        if name == "paged_attention":
            keys += ("l2_evicted_ms", "contiguous_sdpa_ms", "split_plan",
                     "sdpa_row_rel_err")
        if name == "decode_attention":
            keys += ("call_ms", "passes_ms", "split_plan", "sdpa_row_rel_err")
        extra = {k: r[k] for k in keys[6:]}
        if name != "flash_attention":
            extra["max_row_rel_err_bf16"] = attn_err[
                (name, "bfloat16 row-relative")]
        else:
            extra["launches_by_phase"] = flash_by_phase
        for key, sub in attn.items():
            if key.startswith(f"{name}/"):
                extra[key.split("/", 1)[1]] = {k: sub[k] for k in keys}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(attn_err[(name, "float32")],
                               attn_err[(name, "bfloat16")]),
            "max_abs_err_f32": attn_err[(name, "float32")],
            "shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], **extra})
    r = attn["flash_attention_bwd"]
    keys = ("shape", "ms", "plain_ms", "attention_bwd_ref_ms", "bound_ms",
            "bound_by", "library_ms", "kernels_ms", "dq_scratch_bytes")
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": replaces["flash_attention_bwd"],
        "launches": launches["flash_attention_bwd"],
        "max_abs_err": max(attn_err[("flash_attention_bwd", "float32")],
                           attn_err[("flash_attention_bwd", "bfloat16")]),
        "max_abs_err_f32": attn_err[("flash_attention_bwd", "float32")],
        "max_row_rel_err_bf16": attn_err[("flash_attention_bwd",
                                          "bfloat16 row-relative")],
        **{k: r[k] for k in keys},
        "replaces_what": "the gradient XLA derives for blockwise_attention "
                         "(no Pallas backward in the JAX package)",
        "library": "SDPA backward (autograd.grad, retain_graph)",
        "launches_by_phase": bwd_by_phase,
        f"{MOE_ARCH}-train": {k: attn[f"flash_attention_bwd/{MOE_ARCH}-train"][k]
                              for k in keys}})
    say(json.dumps({"serving": full, "full_models": models}))
    say(json.dumps({"training": {
        "reduced_worst_err": train_reduced, "gradient": gradient,
        "full_width": training, "checkpoint": ckpt, "recovery": recovery}}))
    say(json.dumps({"mesh": {"backend": backend, "training": mesh_train,
                             "compression": mesh_comp,
                             "resharding": mesh_perm}}))
    say(json.dumps({"weight_sharding": {"training": moe_train,
                                        "reduced_worst_err": moe_reduced}}))
    say(json.dumps({"mesh_serving": mesh_serving}))
    say(json.dumps({"examples": examples, "dry_run_trace": flops_check}))
    say(json.dumps({"chaos": {k: chaos[k] for k in (
        "faults", "fired", "retries", "failures", "recovered_stages",
        "replans", "checked", "held")}, "swap": swap}))
    say(f"chip_smoke.py wall time {time.perf_counter() - started:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
