"""Hand-written CUDA paged decode attention for Hopper, bound with ctypes.

The kernel lives in ``src/repro_torch/csrc/paged_attention.cu`` (see the
note there for what it replaces and what bounds it) and is built by
``kernels/_build.py`` at first use.  ``paged_attention.launches`` counts
its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "paged_attention.cu"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = (("pa_forward", (_P,) * 6 + (_I,) * 8 + (_P,)),)
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, _SIGNATURES)


def check_inputs(q, k_pages, v_pages, page_table, seq_lens) -> None:
    """Raise ValueError for what the kernel does not take."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; q and the pages "
                             f"must share one of {DTYPES}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    for name, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}: want (B, Hq, D) and two "
                         "(P, page, Hkv, D)")
    B, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    if Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"head dims q {D} / pages {Dk}; want one of "
                         f"{HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            tuple(seq_lens.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match batch {B}")
    if B >= 2 ** 16 or P * page >= 2 ** 31 or P == 0 or page == 0:
        raise ValueError(f"{B} sequences over {P} pages of {page} tokens: "
                         "outside the kernel's range")


def paged_attention(q, k_pages, v_pages, page_table, seq_lens) -> torch.Tensor:
    """q: (B, Hq, D); k_pages, v_pages: (P, page, Hkv, D), one dtype (f32
    or bf16); page_table: (B, NP) int32; seq_lens: (B,) int32; all
    contiguous on one CUDA device.  Returns (B, Hq, D) in q's dtype."""
    check_inputs(q, k_pages, v_pages, page_table, seq_lens)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pa_forward(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                         page_table.data_ptr(), seq_lens.data_ptr(),
                         out.data_ptr(), B, Hq, Hkv, D, P, page,
                         page_table.shape[1], int(q.dtype == torch.bfloat16),
                         stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
