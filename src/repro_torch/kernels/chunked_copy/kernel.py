"""Hand-written CUDA slab gather/scatter for Hopper, bound with ctypes.

The kernels live in ``src/repro_torch/csrc/chunked_copy.cu`` (see the
note there for what each replaces and what bounds it).  They are built
by ``kernels/_build.py`` at first use.

Both kernels copy bytes: a tensor of any dtype is viewed as uint8 rows
of ``C * itemsize`` bytes.  Ids come from the host; the wrappers check
range (``IndexError``) and, for the scatter, uniqueness (``ValueError``)
there, where it costs nothing, and pass them by value to the kernel.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS  # noqa: F401

SOURCE = "chunked_copy.cu"
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_void_p)
_SIGNATURES = (("cc_gather_chunks", _ARGS), ("cc_scatter_chunks", _ARGS))


def library_path():
    return _build.library_path(SOURCE)


def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, _SIGNATURES)


def host_ids(idx, n: int, *, unique: bool = False) -> np.ndarray:
    """Row ids as a contiguous int32 host array, checked against a pool
    of ``n`` rows (and for repeats when ``unique``)."""
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    ids = np.asarray(idx)
    if ids.size and not np.issubdtype(ids.dtype, np.integer):
        raise TypeError(f"row ids must be integers, got {ids.dtype}")
    ids = ids.reshape(-1).astype(np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise IndexError(f"row id out of range [0, {n}): "
                         f"{ids.min()}..{ids.max()}")
    if unique and np.unique(ids).size != ids.size:
        raise ValueError("scatter row ids must be unique")
    return np.ascontiguousarray(ids, dtype=np.int32)


def _rows(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 2-D tensor, "
                         f"got shape {tuple(t.shape)}")


def gather_chunks(src: torch.Tensor, idx) -> torch.Tensor:
    """out[i] = src[idx[i]] on the card.  src: (N, C) CUDA tensor; idx:
    M host ids -> a new (M, C) tensor.  M == 0 launches nothing."""
    _rows(src, "src")
    ids = host_ids(idx, src.shape[0])
    out = torch.empty((ids.size, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    row_bytes = src.shape[1] * src.element_size()
    if ids.size == 0 or row_bytes == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.cc_gather_chunks(src.data_ptr(), out.data_ptr(),
                               ids.ctypes.data, ids.size, row_bytes, stream)
    _build.check(err, "gather_chunks")
    gather_chunks.launches += 1
    return out


def scatter_chunks(dst: torch.Tensor, src: torch.Tensor, idx) -> torch.Tensor:
    """dst[idx[i]] = src[i] on the card, in place: only the M target rows
    are written.  dst: (N, C); src: (M, C), same dtype and device; idx:
    M unique host ids.  Returns ``dst``."""
    _rows(dst, "dst")
    _rows(src, "src")
    if src.device != dst.device or src.dtype != dst.dtype:
        raise ValueError(f"src {src.dtype}@{src.device} does not match "
                         f"dst {dst.dtype}@{dst.device}")
    ids = host_ids(idx, dst.shape[0], unique=True)
    if src.shape != (ids.size, dst.shape[1]):
        raise ValueError(f"src shape {tuple(src.shape)} != "
                         f"({ids.size}, {dst.shape[1]})")
    row_bytes = dst.shape[1] * dst.element_size()
    if ids.size == 0 or row_bytes == 0:
        return dst
    lib = load_library()
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = lib.cc_scatter_chunks(dst.data_ptr(), src.data_ptr(),
                                ids.ctypes.data, ids.size, row_bytes, stream)
    _build.check(err, "scatter_chunks")
    scatter_chunks.launches += 1
    return dst


gather_chunks.launches = 0
scatter_chunks.launches = 0
