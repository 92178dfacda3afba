"""Plain PyTorch prefill attention: the naive full-matrix softmax.

A twin of ``src/repro/kernels/flash_attention/ref.py`` with the query
and key position offsets that ``blockwise_attention`` takes.  It is the
CPU path of ``ops.attention`` and the yardstick the CUDA kernel is held
against on the card.  Scores and softmax are f32 whatever the inputs'
dtype; the output is cast to q's dtype.  Beside it, the plain versions
of the gradient: ``attention_bwd_ref``, autograd block by block (the
backward ``ops.FlashAttention`` takes on ``meta`` tensors, the dry-run's
trace), and ``attention_stats_ref`` / ``attention_bwd_from_stats_ref``,
the forward's softmax statistics and the gradient from them, walking the
tiles of ``csrc/flash_attention_bwd.cu`` as it does (what the kernel is
held against on the card), with the key-major kernel's walk and dQ order
(``query_tiles``, ``claim_order``, ``dq_order``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(q_pos, k_pos, causal: bool, window: int):
    """(Lq, Lkv) bool: the pairs each query sees, for query positions
    ``q_pos`` (Lq, 1) and key positions ``k_pos`` (1, Lkv)."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[1]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _scores(q, k, causal, window, q_offset, kv_offset):
    """f32 scaled scores (B, Hkv, G, Lq, Lkv) and the (Lq, Lkv) mask of
    the pairs each query sees."""
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Lq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Lq, device=q.device)[:, None]
    k_pos = kv_offset + torch.arange(Lkv, device=q.device)[None, :]
    return s, _mask(q_pos, k_pos, causal, window)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, kv_offset: int = 0):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D).  Returns (B, Hq, Lq, D)."""
    B, Hq, Lq, D = q.shape
    s, mask = _scores(q, k, causal, window, q_offset, kv_offset)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Lq, D).to(q.dtype)


def _visible(qp: int, Lkv: int, causal: bool, window: int,
             kv_offset: int) -> tuple[int, int]:
    """The key indices [lo, hi) the query at position ``qp`` sees."""
    hi = min(Lkv, max(0, qp + 1 - kv_offset)) if causal else Lkv
    lo = min(Lkv, max(0, qp - window + 1 - kv_offset)) if window else 0
    return lo, hi


def attention_bwd_ref(q, k, v, do, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, kv_offset: int = 0,
                      block: int = 512):
    """The gradient of ``attention_ref`` with respect to (q, k, v) for the
    output gradient ``do`` (B, Hq, Lq, D): (dq, dk, dv) in the inputs'
    dtypes.

    It recomputes attention ``block`` query rows at a time, in f32, and
    takes autograd's gradient of ``attention_ref`` over that slice alone,
    adding into f32 dk and dv.  No step holds the (B, H, Lq, Lkv) score
    matrix: a slice's scores span only the keys its rows can see (the
    causal and window bounds), or all keys where a row sees none (where
    ``attention_ref`` averages every value)."""
    Lq, Lkv = q.shape[2], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    with torch.enable_grad():
        for i0 in range(0, Lq, block):
            i1 = min(i0 + block, Lq)
            (lo, hi0), (lo1, hi) = (_visible(q_offset + i, Lkv, **kw)
                                    for i in (i0, i1 - 1))
            if hi0 <= lo or hi <= lo1:          # a row that sees no key
                lo, hi = 0, Lkv
            qb, kb, vb = (t.detach().float().requires_grad_() for t in (
                q[:, :, i0:i1], k[:, :, lo:hi], v[:, :, lo:hi]))
            out = attention_ref(qb, kb, vb, causal=causal, window=window,
                                q_offset=q_offset + i0,
                                kv_offset=kv_offset + lo)
            gq, gk, gv = torch.autograd.grad(
                out, (qb, kb, vb), do[:, :, i0:i1].float())
            dq[:, :, i0:i1] = gq
            dk[:, :, lo:hi] += gk
            dv[:, :, lo:hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


#: the key-major kernel's tiles: query rows a tile, keys a work item (64 a
#: warpgroup)
BQ, BK = 64, 128
#: the delta kernel's tiles: query rows a block, keys a streamed tile
DELTA_BQ, DELTA_BK = 128, 64
#: the f32 kernels' tiles (dq's query rows, dk/dv's keys)
F32_BQ, F32_BK = 64, 64


def _key_range(qp_first: int, qp_last: int, Lkv: int, causal: bool,
               window: int, kv_offset: int) -> tuple[int, int, bool]:
    """The kernels' ``key_range``: keys [lo, hi) hold every key that some
    row at positions [qp_first, qp_last] sees, and ``blind`` says that
    some row of them sees none (then the range is every key)."""
    blind = bool((causal and qp_first < kv_offset) or
                 (window and qp_last - window + 1 - kv_offset > Lkv - 1))
    lo, hi = 0, Lkv
    if not blind:
        if causal:
            hi = min(hi, qp_last - kv_offset + 1)
        if window:
            lo = max(lo, qp_first - window + 1 - kv_offset)
    return lo, hi, blind


def key_tiles(qt: int, Lq: int, Lkv: int, *, causal: bool = True,
              window: int = 0, q_offset: int = 0, kv_offset: int = 0,
              bq: int = BQ, bk: int = BK) -> tuple[int, int]:
    """The key tiles [t_lo, t_hi) that query tile ``qt`` (of ``bq`` rows)
    visits: its key range by whole tiles of ``bk`` keys.  The delta kernel
    walks them for each block of DELTA_BQ rows (tiles of DELTA_BK keys);
    the key-major kernel's item of key tile ``kt`` visits query tile
    ``qt`` iff ``t_lo <= kt < t_hi`` (``query_tiles``)."""
    q0 = qt * bq
    qp = q_offset + q0
    lo, hi, _ = _key_range(qp, qp + min(bq, Lq - q0) - 1, Lkv, causal,
                           window, kv_offset)
    return lo // bk, -(-hi // bk)


def query_tiles(kt: int, Lq: int, Lkv: int, *, causal: bool = True,
                window: int = 0, q_offset: int = 0,
                kv_offset: int = 0) -> list[int]:
    """The query tiles (of BQ rows) that the key-major kernel's item of key
    tile ``kt`` (of BK keys) visits for each query head of its kv head, in
    its order, as its ``walk_of`` and ``next_tile`` find them: the range
    from the first visited tile to the last, every tile of it where none
    lies between unvisited, else those ``key_tiles`` says visit ``kt``."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)

    def visits(qt):
        t_lo, t_hi = key_tiles(qt, Lq, Lkv, **kw)
        return t_lo <= kt < t_hi
    seen = [qt for qt in range(-(-Lq // BQ)) if visits(qt)]
    if not seen:
        return []
    first, last = seen[0], seen[-1]
    gaps = len(seen) != last - first + 1
    return [qt for qt in range(first, last + 1) if not gaps or visits(qt)]


def claim_order(B: int, Hkv: int, Lkv: int) -> list[tuple[int, int, int]]:
    """The key-major kernel's work items (kt, b, g) in the order its
    persistent blocks claim them from the global counter: key tiles
    outermost (key tile 0 is the heaviest under a causal mask)."""
    return [(kt, b, g) for kt in range(-(-Lkv // BK)) for b in range(B)
            for g in range(Hkv)]


def dq_order(qt: int, Lq: int, Lkv: int, **kw) -> list[tuple[int, int]]:
    """The order in which query tile ``qt``'s dQ parts are summed: one
    chain a half ``w`` of the head dim (warpgroup ``w`` of each item takes
    that half over the item's BK keys), each over the key tiles that visit
    ``qt`` in ascending order: the chain's first part is stored, the next
    added in the L2, and the last adds the chain's sum and writes its half
    of dq.  Returns [(kt, w), ...], chain 0 then chain 1."""
    t_lo, t_hi = key_tiles(qt, Lq, Lkv, **kw)
    return [(kt, w) for w in (0, 1) for kt in range(t_lo, t_hi)]


def attention_stats_ref(q, k, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_offset: int = 0):
    """The forward kernel's softmax statistics, f32 (B, Hq, Lq): each row's
    log-sum-exp of its scaled scores over the keys it sees (natural log),
    exactly NEG_INF for a row that sees no key."""
    B, Hq, Lq, _ = q.shape
    s, mask = _scores(q, k, causal, window, q_offset, kv_offset)
    lse = torch.logsumexp(s.masked_fill(~mask, NEG_INF), dim=-1)
    lse = lse.masked_fill(~mask.any(-1), NEG_INF)
    return lse.reshape(B, Hq, Lq)


def attention_bwd_from_stats_ref(q, k, v, do, stats, *,
                                 causal: bool = True, window: int = 0,
                                 q_offset: int = 0, kv_offset: int = 0):
    """The gradient of ``attention_ref`` from the forward's statistics
    ``stats`` (``attention_stats_ref``), as ``csrc/flash_attention_bwd.cu``
    computes it, in f32: (dq, dk, dv) in the inputs' dtypes.

    It walks the key-major kernel's tiles with their skip rule: each tile
    of BQ query rows against the key tiles ``key_tiles`` gives it, taken
    as one slab of keys (the BQ x BK tiles of one query tile side by
    side; the kernel sums dQ's parts in ``dq_order``, the slab at once,
    which differs only by f32 rounding).  P is
    rebuilt as exp(S - stats) on the keys a row sees; a row whose stats
    are NEG_INF (it sees no key) has P = 1/Lkv on every key; dS = P (dP -
    delta) with delta = rowsum(P o dP) over the row's keys, and 0 in a row
    that sees one key or none (P does not depend on its scores)."""
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg, dog = (t.reshape(B, Hkv, G, Lq, D).float() for t in (q, do))
    kf, vf = k.float(), v.float()
    lse = stats.reshape(B, Hkv, G, Lq, 1).float()
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    for qt in range(-(-Lq // BQ)):
        i0, i1 = qt * BQ, min(Lq, qt * BQ + BQ)
        t_lo, t_hi = key_tiles(qt, Lq, Lkv, **kw)
        j0, j1 = t_lo * BK, min(Lkv, t_hi * BK)
        # the slab holds every key its rows see
        seen = _mask(q_offset + torch.arange(i0, i1, device=q.device)[:, None],
                     kv_offset + torch.arange(j0, j1, device=q.device)[None, :],
                     causal, window)
        kb, vb = kf[:, :, j0:j1], vf[:, :, j0:j1]
        qb, dob = qg[..., i0:i1, :], dog[..., i0:i1, :]
        lb = lse[..., i0:i1, :]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
        p = torch.where(seen, torch.exp(s - lb), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vb)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        blind = lb < 0.5 * NEG_INF
        p = torch.where(blind, 1.0 / Lkv, p)
        ds = torch.where(seen.sum(-1, keepdim=True) <= 1, 0.0, ds)
        dq[..., i0:i1, :] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb) * scale
        dk[:, :, j0:j1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb) * scale
        dv[:, :, j0:j1] += torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
    return (dq.reshape(B, Hq, Lq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
