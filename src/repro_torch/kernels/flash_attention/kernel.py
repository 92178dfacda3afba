"""Hand-written CUDA prefill attention for Hopper, bound with ctypes.

The kernel lives in ``src/repro_torch/csrc/flash_attention.cu`` (see the
note there for what it replaces and what bounds it) and is built by
``kernels/_build.py`` at first use.  ``flash_attention.launches`` counts
its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention.cu"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = (("fa_forward", (_P, _P, _P, _P) + (_I,) * 11 + (_P,)),
               ("fa_describe", (_I, _I, _P)))
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_BQ = 64            # query rows per block, both kernels (the .cu's BQ)
_DESCRIBE = ("block_rows", "threads", "smem_bytes", "registers",
             "local_bytes", "blocks_per_sm")


def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, _SIGNATURES)


def check_inputs(q, k, v, window: int) -> None:
    """Raise ValueError for what the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
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
                    q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D), contiguous CUDA tensors
    of one dtype (f32 or bf16).  Returns (B, Hq, Lq, D) in q's dtype."""
    check_inputs(q, k, v, window)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = load_library().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        Lq, Lkv, D, int(q.dtype == torch.bfloat16), int(bool(causal)),
        int(window), int(q_offset), int(kv_offset), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def describe(head_dim: int, dtype) -> dict:
    """The compiled instance for (head_dim, dtype) as the card reports it:
    block rows and threads, dynamic shared memory, registers and local
    (spill) bytes per thread, resident blocks per SM."""
    out = (ctypes.c_int * len(_DESCRIBE))()
    err = load_library().fa_describe(
        int(head_dim), int(dtype == torch.bfloat16), out)
    _build.check(err, "flash_attention.describe")
    return dict(zip(_DESCRIBE, out))
