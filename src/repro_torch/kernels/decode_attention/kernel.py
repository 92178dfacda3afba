"""Hand-written CUDA decode attention over the engine's contiguous KV cache,
for Hopper, bound with ctypes.

The kernels live in ``src/repro_torch/csrc/decode_attention.cu`` (see the
note there for what they replace and what bounds them) and are built by
``kernels/_build.py`` at first use.  Two wrappers, one a pass:
``decode_scores`` writes the f32 scores of the live positions ``[lo, hi]``
and ``decode_values`` sums the probabilities, rounded to the cache dtype,
times V over the same positions (and, when the plan has more than one
span, merges the spans' partials in span order).  Neither reads a
position outside ``[lo, hi]``.  ``split_plan`` chooses the spans from the
shapes, the live length and the card's resident blocks.  Each wrapper's
``.launches`` counts its calls.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

SOURCE = "decode_attention.cu"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = (
    ("da_scores", (_P,) * 3 + (_I,) * 12 + (ctypes.c_float, _P)),
    ("da_values", (_P,) * 4 + (_I,) * 12 + (_P,)),
    ("da_describe", (_I,) * 4 + (_P,)))
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TILE = 64                   # a span is a whole number of 64 positions
MIN_SPAN_BYTES = 16 * 1024  # bytes of K (or V) a block reads at least
KERNELS = ("decode_scores", "decode_values")
_DESCRIBE = ("threads", "smem_bytes", "registers", "local_bytes",
             "blocks_per_sm")


def group_block(G: int) -> int:
    """Query heads a block takes: the least power of two that holds the
    group, at most 8 (a larger group takes several head groups)."""
    return min(8, 1 << (G - 1).bit_length())


def split_plan(blocks: int, n_live: int, D: int, itemsize: int, slots: int
               ) -> tuple[int, int]:
    """(span, n_spans): the live positions each block takes and how many
    spans cover the ``n_live`` of them, span i taking ``[i span,
    min((i + 1) span, n_live))``.  The span is a whole number of 64
    positions and at least MIN_SPAN_BYTES of K or V; within that,
    ``blocks`` (kv heads x head groups x sequences) times ``n_spans`` fill
    one wave of ``slots`` resident blocks and no more, as the paged
    kernel's plan does.  Every span holds at least one live position."""
    tiles = max(-(-n_live // TILE), 1)
    min_tiles = max(-(-MIN_SPAN_BYTES // (TILE * D * itemsize)), 1)
    want = max(slots // max(blocks, 1), 1)       # spans a block's rows
    span = min(max(min_tiles, -(-tiles // want)), tiles)
    return span * TILE, -(-tiles // span)


@functools.cache
def resident_slots(kernel: str, head_dim: int, gb: int,
                   device_index: int) -> int:
    """Blocks of ``kernel`` the card holds at once: the bf16 instance's
    resident blocks an SM (``describe``) times the card's SMs.  bf16 is
    the served type; f32 takes the same plan."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return describe(kernel, head_dim, torch.bfloat16, gb)["blocks_per_sm"] \
        * sms


def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, _SIGNATURES)


def _check_cache(name, t, ref) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, {ref.device} expected")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype not in DTYPES:
        raise ValueError(f"{name} has dtype {t.dtype}; want one of {DTYPES}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")
    if t.dim() != 4 or t.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name} {tuple(t.shape)}: want (B, Hkv, S, D), D "
                         f"one of {HEAD_DIMS}")


def _check_live(lo: int, n: int, S: int) -> None:
    if not (0 <= lo and n >= 1 and lo + n <= S):
        raise ValueError(f"live positions [{lo}, {lo + n - 1}] are not "
                         f"within the cache's {S}")


def _plan(kernel, B, Hq, Hkv, n, D, itemsize, device):
    """(GB, span, n_spans) of one call."""
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    gb = group_block(Hq // Hkv)
    n_hg = -(-(Hq // Hkv) // gb)
    if B >= 2 ** 16 or Hkv * n_hg >= 2 ** 16:
        raise ValueError(f"{B} sequences, {Hkv} kv heads: outside the "
                         "kernel's grid")
    blocks = B * Hkv * n_hg
    return (gb, *split_plan(blocks, n, D, itemsize,
                            resident_slots(kernel, D, gb, device.index)))


def decode_scores(q, k_cache, lo: int, hi: int) -> torch.Tensor:
    """q: (B, Hq, 1, D); k_cache: (B, Hkv, S, D), f32 or bf16, both
    contiguous on one CUDA device.  Returns the f32 scores q . K / sqrt(D)
    of positions ``lo .. hi`` (inclusive), (B, Hq, hi - lo + 1)."""
    _check_cache("k_cache", k_cache, q)
    B, Hkv, S, D = k_cache.shape
    if q.dim() != 4 or q.shape[0] != B or q.shape[2:] != (1, D):
        raise ValueError(f"q {tuple(q.shape)} against k_cache "
                         f"{tuple(k_cache.shape)}: want (B, Hq, 1, D)")
    if q.dtype not in DTYPES or not q.is_contiguous() \
            or q.device != k_cache.device:
        raise ValueError(f"q must be contiguous f32 or bf16 on "
                         f"{k_cache.device}")
    n = hi - lo + 1
    _check_live(lo, n, S)
    Hq = q.shape[1]
    gb, span, n_spans = _plan("decode_scores", B, Hq, Hkv, n, D,
                              k_cache.element_size(), q.device)
    scores = torch.empty((B, Hq, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = load_library().da_scores(
        q.data_ptr(), k_cache.data_ptr(), scores.data_ptr(), B, Hq, Hkv, D,
        S, lo, n, span, n_spans, gb, int(q.dtype == torch.bfloat16),
        int(k_cache.dtype == torch.bfloat16), 1.0 / math.sqrt(D), stream)
    _build.check(err, "decode_scores")
    decode_scores.launches += 1
    return scores


decode_scores.launches = 0


def decode_values(p, v_cache, lo: int, out_dtype) -> torch.Tensor:
    """p: (B, Hq, n) f32 probabilities of positions ``lo .. lo + n - 1``;
    v_cache: (B, Hkv, S, D), f32 or bf16; both contiguous on one CUDA
    device.  Returns sum_i round(p[..., i]) V[lo + i], each probability
    rounded to the cache dtype and the products summed in f32, as
    (B, Hq, 1, D) in ``out_dtype`` (f32 or bf16); zeros when n is 0."""
    _check_cache("v_cache", v_cache, p)
    B, Hkv, S, D = v_cache.shape
    if p.dim() != 3 or p.shape[0] != B or p.dtype != torch.float32 \
            or not p.is_contiguous():
        raise ValueError(f"p {tuple(p.shape)} {p.dtype}: want contiguous "
                         f"f32 (B, Hq, n) against v_cache "
                         f"{tuple(v_cache.shape)}")
    if out_dtype not in DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: want one of {DTYPES}")
    Hq, n = p.shape[1:]
    if n == 0:
        return torch.zeros((B, Hq, 1, D), dtype=out_dtype, device=p.device)
    _check_live(lo, n, S)
    gb, span, n_spans = _plan("decode_values", B, Hq, Hkv, n, D,
                              v_cache.element_size(), p.device)
    out = torch.empty((B, Hq, 1, D), dtype=out_dtype, device=p.device)
    ws = torch.empty((B, Hq, n_spans, D) if n_spans > 1 else (0,),
                     dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = load_library().da_values(
        p.data_ptr(), v_cache.data_ptr(), out.data_ptr(), ws.data_ptr(), B,
        Hq, Hkv, D, S, lo, n, span, n_spans, gb,
        int(out_dtype == torch.bfloat16),
        int(v_cache.dtype == torch.bfloat16), stream)
    _build.check(err, "decode_values")
    decode_values.launches += 1
    return out


decode_values.launches = 0


def describe(kernel: str, head_dim: int, dtype, gb: int) -> dict:
    """The compiled ``kernel`` (one of KERNELS) for (head_dim, cache dtype,
    query heads a block) as the card reports it: threads, static shared
    memory, registers and local (spill) bytes per thread, resident blocks
    per SM."""
    out = (ctypes.c_int * len(_DESCRIBE))()
    err = load_library().da_describe(
        KERNELS.index(kernel), int(head_dim), int(dtype == torch.bfloat16),
        int(gb), out)
    _build.check(err, "decode_attention.describe")
    return dict(zip(_DESCRIBE, out))
