"""Hand-written CUDA prefill attention and its gradient for Hopper,
bound with ctypes.

The forward lives in ``src/repro_torch/csrc/flash_attention.cu``, the
backward in ``src/repro_torch/csrc/flash_attention_bwd.cu`` (see the notes
there for what they replace and what bounds them); ``kernels/_build.py``
builds each into its own library at first use.
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
their calls' launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = (("fa_forward", (_P,) * 5 + (_I,) * 11 + (_P,)),
               ("fa_describe", (_I, _I, _P)))
_BWD_SIGNATURES = (("fa_backward", (_P,) * 11 + (_I,) * 11 + (_P,)),
                   ("fa_bwd_describe", (_I, _I, _I, _P)))
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_BQ = 64            # query rows per block: the forward, the f32 backward
#: the backward's two kernels by dtype, in launch order
BWD_KERNELS = {torch.bfloat16: ("bwd_delta_bf16", "bwd_keymajor_bf16"),
               torch.float32: ("bwd_dq_f32", "bwd_dkdv_f32")}
_DQ_ROWS = 64       # the key-major kernel's query tile (the .cu's tc::QT)
_DESCRIBE = ("block_rows", "threads", "smem_bytes", "registers",
             "local_bytes", "blocks_per_sm")


def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, _SIGNATURES)


def load_bwd_library() -> ctypes.CDLL:
    return _build.load(BWD_SOURCE, _BWD_SIGNATURES)


def _check_tensors(q, named) -> None:
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; q, k and v must "
                             f"share one of {DTYPES}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the bf16 kernel copies 16-byte rows)")


def check_inputs(q, k, v, window: int) -> None:
    """Raise ValueError for what the kernel does not take."""
    _check_tensors(q, (("q", q), ("k", k), ("v", v)))
    B, Hq, Lq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv, Lkv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Lq and not Lkv:
        raise ValueError("no keys to attend to (Lkv == 0)")
    if B * Hq >= 2 ** 31 or -(-Lq // _BQ) >= 2 ** 16 or Lkv >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} "
                         "exceeds the kernel's grid")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_offset: int = 0,
                    return_stats: bool = False):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D), contiguous CUDA tensors
    of one dtype (f32 or bf16).  Returns (B, Hq, Lq, D) in q's dtype; with
    ``return_stats`` also the rows' softmax statistics, f32 (B, Hq, Lq):
    the log-sum-exp of each row's scaled, masked scores, NEG_INF where the
    row sees no key (``ref.attention_stats_ref``), which
    ``flash_attention_bwd`` reads."""
    check_inputs(q, k, v, window)
    out = torch.empty_like(q)
    stats = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if return_stats else None
    if out.numel():
        B, Hq, Lq, D = q.shape
        Hkv, Lkv = k.shape[1], k.shape[2]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = load_library().fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), B, Hq, Hkv, Lq, Lkv,
            D, int(q.dtype == torch.bfloat16), int(bool(causal)),
            int(window), int(q_offset), int(kv_offset), stream)
        _build.check(err, "flash_attention")
        flash_attention.launches += 1
    return (out, stats) if return_stats else out


flash_attention.launches = 0


def check_bwd_inputs(q, k, v, do, stats, window: int) -> None:
    """Raise ValueError for what the backward kernel does not take."""
    check_inputs(q, k, v, window)
    if -(-k.shape[2] // _BQ) >= 2 ** 16 or q[..., 0].numel() >= 2 ** 31:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} exceed "
                         "the backward's grid")
    _check_tensors(q, (("do", do),))
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if (stats.device != q.device or stats.dtype != torch.float32
            or stats.shape != q.shape[:3] or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous f32 {tuple(q.shape[:3])}"
                         f" tensor on {q.device}, got {stats.dtype} "
                         f"{tuple(stats.shape)} on {stats.device}")


def _dq_scratch_sizes(q) -> tuple[int, int]:
    """The bf16 backward's scratch for q's shape, (f32 values, int32
    counters): dQ's partial sums, a (64 x D) block a (batch x head, query
    tile) as two halves of the head dim, each summed along a chain of key
    tiles; the chains' counters, and the item claim's."""
    B, Hq, Lq, D = q.shape
    tiles = B * Hq * -(-Lq // _DQ_ROWS)
    return tiles * _DQ_ROWS * D, 1 + 2 * tiles


def dq_scratch_bytes(q) -> int:
    """The bytes of the bf16 backward's scratch for q's shape."""
    return 4 * sum(_dq_scratch_sizes(q))


def flash_attention_bwd(q, k, v, do, stats, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        kv_offset: int = 0):
    """The gradient of ``flash_attention`` for the output gradient ``do``:
    (dq, dk, dv) in the inputs' dtype.  q, do: (B, Hq, Lq, D); k, v:
    (B, Hkv, Lkv, D), contiguous CUDA tensors of one dtype (f32 or bf16);
    stats: the forward's f32 (B, Hq, Lq) statistics (``return_stats``).
    The output is not an input: delta = rowsum(P o dP) is taken from the
    scores (the note in ``csrc/flash_attention_bwd.cu`` says why).  One
    call launches two kernels on the current stream (bf16: delta, then the
    key-major dq, dk and dv, with an f32 scratch of ``dq_scratch_bytes``
    for dQ's partial sums; f32: dq, then dk and dv).  Deterministic: dQ's
    partial sums are added in key-tile order, never by atomics."""
    check_bwd_inputs(q, k, v, do, stats, window)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dq_acc = counters = None
    if q.dtype == torch.bfloat16:
        values, flags = _dq_scratch_sizes(q)
        dq_acc = torch.empty(values, dtype=torch.float32, device=q.device)
        counters = torch.zeros(flags, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = load_bwd_library().fa_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        stats.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
        None if counters is None else counters.data_ptr(), B, Hq, Hkv, Lq,
        Lkv, D, int(q.dtype == torch.bfloat16), int(bool(causal)),
        int(window), int(q_offset), int(kv_offset), stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def describe(head_dim: int, dtype) -> dict:
    """The compiled instance for (head_dim, dtype) as the card reports it:
    block rows and threads, dynamic shared memory, registers and local
    (spill) bytes per thread, resident blocks per SM."""
    out = (ctypes.c_int * len(_DESCRIBE))()
    err = load_library().fa_describe(
        int(head_dim), int(dtype == torch.bfloat16), out)
    _build.check(err, "flash_attention.describe")
    return dict(zip(_DESCRIBE, out))


def bwd_describe(head_dim: int, dtype) -> dict:
    """``describe`` for the backward's two kernels, by name
    (``BWD_KERNELS[dtype]``; "block_rows" is the tile's query rows or
    keys)."""
    res = {}
    for which, name in enumerate(BWD_KERNELS[dtype]):
        out = (ctypes.c_int * len(_DESCRIBE))()
        err = load_bwd_library().fa_bwd_describe(
            int(head_dim), int(dtype == torch.bfloat16), which, out)
        _build.check(err, "flash_attention_bwd.describe")
        res[name] = dict(zip(_DESCRIBE, out))
    return res
