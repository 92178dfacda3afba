"""Hand-written CUDA paged decode attention for Hopper, bound with ctypes.

The kernels live in ``src/repro_torch/csrc/paged_attention.cu`` (see the
note there for what they replace and what bounds them) and are built by
``kernels/_build.py`` at first use.  A call runs two: the split kernel,
one block per (span of positions, kv head, sequence; bf16 on the tensor
cores, f32 on the CUDA cores), and, when the plan has more than one
span, ``paged_merge`` over their partial softmax states.  ``split_plan``
chooses the spans from the static shapes and the card's resident blocks
alone, so a call never reads the page table or the lengths on the host.
``paged_attention.launches`` counts calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "paged_attention.cu"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = (("pa_forward", (_P,) * 7 + (_I,) * 10 + (_P,)),
               ("pa_describe", (_I, _I, _P)))
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TILE = 64               # positions a tile of paged_split (the .cu's TILE)
MIN_SPAN_BYTES = 32 * 1024   # K and V bytes (bf16) a block reads at least
_DESCRIBE = ("threads", "stages", "smem_bytes", "registers", "local_bytes",
             "blocks_per_sm")


def split_plan(B: int, Hkv: int, NP: int, page: int, D: int, slots: int
               ) -> tuple[int, int]:
    """(split_len, n_splits): the positions each block of the split kernel
    takes and how many spans cover the ``NP * page`` positions.  The span
    is a whole number of 64-position tiles and at least MIN_SPAN_BYTES of
    K and V; within that, the B * Hkv * n_splits blocks fill one wave of
    ``slots`` resident blocks (``resident_slots``) and no more: a second
    wave, or a merge that one wave does not need, measured slower on the
    H100 than idle slots (PERF.md).  A function of the static shapes and
    the card only."""
    tiles = max(-(-NP * page // TILE), 1)
    min_tiles = -(-MIN_SPAN_BYTES // (2 * TILE * D * 2))
    want = max(slots // max(B * Hkv, 1), 1)  # spans a (kv head, sequence)
    span = min(max(min_tiles, -(-tiles // want)), tiles)
    return span * TILE, -(-tiles // span)


@functools.cache
def resident_slots(head_dim: int, device_index: int) -> int:
    """Split-kernel blocks the card holds at once: the bf16 instance's
    resident blocks an SM (``describe``) times the card's SMs.  bf16 is
    the timed type; f32 takes the same plan."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return describe(head_dim, torch.bfloat16)["blocks_per_sm"] * sms


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
    NP = page_table.shape[1]
    groups = -(-(Hq // Hkv) // 8)
    if (B >= 2 ** 16 or P * page >= 2 ** 31 or NP * page >= 2 ** 30
            or Hkv * groups >= 2 ** 16 or P == 0 or page == 0):
        raise ValueError(f"{B} sequences of {NP} pages over {P} pages of "
                         f"{page} tokens, {Hkv} kv heads: outside the "
                         "kernel's range")


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
    NP = page_table.shape[1]
    split_len, n_splits = split_plan(
        B, Hkv, NP, page, D, resident_slots(D, q.device.index))
    ws = torch.empty((B, Hq, n_splits, D + 2) if n_splits > 1 else (0,),
                     dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = load_library().pa_forward(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, Hq, Hkv, D, P, page, NP, split_len, n_splits,
        int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def describe(head_dim: int, dtype) -> dict:
    """The compiled split kernel for (head_dim, dtype) as the card reports
    it: threads, ring stages, dynamic shared memory, registers and local
    (spill) bytes per thread, resident blocks per SM."""
    out = (ctypes.c_int * len(_DESCRIBE))()
    err = load_library().pa_describe(
        int(head_dim), int(dtype == torch.bfloat16), out)
    _build.check(err, "paged_attention.describe")
    return dict(zip(_DESCRIBE, out))
