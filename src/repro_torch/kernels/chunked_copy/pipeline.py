"""Double-buffered chunked-copy pipeline over pool slabs.

The execution counterpart of LinkSim's batched triggering: a transfer is
a list of 2 MB slab chunks, grouped into trigger batches of
``BATCH_CHUNKS``.  The sequential arm is the naive data plane — one
chunk at a time, a stream sync after every chunk — while the pipelined
arm records a CUDA event after each batch's scatter and blocks the host
only at trigger-batch boundaries: at the top of iteration k+1 it
launches gather k+1, then waits on event k, then reports batch k as
landed, then launches scatter k+1.  Progress callbacks fire exactly at
those boundaries with the REAL landed chunk count.

Scatters write the destination pool in place (the reference donated
the pool to get the same effect): every function returns the pool it
was given, updated.  On CPU tensors the same loops run on the plain
versions and need no sync.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.chunked_copy.ops import gather, scatter
from repro_torch.spans import span

#: chunks per trigger batch — mirrors core.linksim.BATCH_CHUNKS (kept
#: literal here so the kernels package stays importable standalone)
BATCH_CHUNKS = 5


def _batches(n: int, batch: int):
    """Yield (start, stop) chunk ranges, trigger-batch sized."""
    for s in range(0, n, batch):
        yield s, min(s + batch, n)


def record(t: torch.Tensor):
    """An event on the current stream of ``t``'s device (None on CPU,
    where every copy has finished when it returns)."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def wait(ev) -> None:
    """Block the host until an event from :func:`record` has passed."""
    if ev is not None:
        with span("ft:copy.wait"):
            ev.synchronize()


def copy_slabs_sequential(src_pool, src_idx, dst_pool, dst_idx, *,
                          on_chunk=None):
    """Per-chunk synchronous copy: gather -> scatter -> sync, one chunk
    at a time.  The contrast arm: every chunk pays a full launch + host
    sync round trip.  Returns ``dst_pool``."""
    n = len(src_idx)
    assert len(dst_idx) == n
    src_idx = np.asarray(src_idx, np.int32)
    dst_idx = np.asarray(dst_idx, np.int32)
    for i in range(n):
        g = gather(src_pool, src_idx[i:i + 1])
        scatter(dst_pool, g, dst_idx[i:i + 1])
        wait(record(dst_pool))
        if on_chunk is not None:
            on_chunk(i + 1)
    return dst_pool


def copy_slabs_pipelined(src_pool, src_idx, dst_pool, dst_idx, *,
                         batch: int = BATCH_CHUNKS, on_batch=None):
    """Double-buffered batch copy with boundary-only sync.

    Loop invariant (the ping-pong): at the top of iteration k the gather
    for batch k is launched FIRST, then the host waits on batch k-1's
    event — so two batches are queued on the device at any boundary.

    ``on_batch(chunks_landed)`` fires at every trigger-batch boundary
    with the number of chunks actually resident in ``dst_pool``.
    Returns ``dst_pool``.
    """
    n = len(src_idx)
    assert len(dst_idx) == n
    src_idx = np.asarray(src_idx, np.int32)
    dst_idx = np.asarray(dst_idx, np.int32)
    landed, ev = 0, None
    for s, e in _batches(n, batch):
        g = gather(src_pool, src_idx[s:e])
        wait(ev)                              # batch k-1 fully landed
        if landed and on_batch is not None:
            on_batch(landed)
        scatter(dst_pool, g, dst_idx[s:e])
        ev = record(dst_pool)
        landed = e
    wait(ev)
    if on_batch is not None and n:
        on_batch(n)
    return dst_pool


def pool_to_host(src_pool, src_idx, out, *, batch: int = BATCH_CHUNKS,
                 on_batch=None):
    """Gather slabs device->host, one trigger batch at a time.

    ``out`` is an (n, C) host tensor (a ring window, a host-store view
    or caller staging; page-locked on a CUDA backend); rows are written
    batch by batch with a non-blocking copy, and the host waits for each
    batch before reporting it, so ``out`` is readable on return.
    """
    n = len(src_idx)
    src_idx = np.asarray(src_idx, np.int32)
    for s, e in _batches(n, batch):
        g = gather(src_pool, src_idx[s:e])
        out[s:e].copy_(g, non_blocking=True)
        wait(record(g))
        if on_batch is not None:
            on_batch(e)
    return out


def host_to_pool(src, dst_pool, dst_idx, *, batch: int = BATCH_CHUNKS,
                 on_batch=None):
    """Scatter host rows into a device pool, one trigger batch at a
    time, boundary-only sync: batch k+1's upload and scatter are queued
    before the host waits on batch k's event, so the copy engine has the
    next batch while the host reports the last one (``on_batch``).  One
    wait a batch; an exception drains the queue before it leaves.

    ``src`` is an (n, C) host tensor (on a CUDA pool, page-locked for
    the upload to be asynchronous) that stays untouched until return:
    a queued upload reads it in place.  Each upload's device temporary is
    freed while the next is queued, but the caching allocator hands a
    freed block out again only in stream order, behind the scatter that
    reads it, since every copy and kernel goes on the one current
    stream.  Returns ``dst_pool``."""
    n = len(dst_idx)
    dst_idx = np.asarray(dst_idx, np.int32)
    landed, ev = 0, None
    try:
        for s, e in _batches(n, batch):
            up = src[s:e].to(dst_pool.device, non_blocking=True)
            scatter(dst_pool, up, dst_idx[s:e])
            nxt = record(dst_pool)
            wait(ev)                          # batch k-1 fully landed
            if landed and on_batch is not None:
                on_batch(landed)
            ev, landed = nxt, e
        wait(ev)
    except BaseException:
        wait(record(dst_pool))                # no queued copy reads src
        raise
    if on_batch is not None and n:
        on_batch(n)
    return dst_pool
