"""Slab gather/scatter, chosen by the tensor's device alone: a CPU
tensor takes the plain version (``ref.py``); any other tensor goes to
the CUDA kernel, which launches or raises.  There is no fallback."""
from __future__ import annotations

import torch

from repro_torch.kernels.chunked_copy.kernel import (
    gather_chunks,
    host_ids,
    scatter_chunks,
)
from repro_torch.kernels.chunked_copy.ref import (
    gather_chunks_ref,
    scatter_chunks_ref,
)


def _ids_tensor(ids) -> torch.Tensor:
    return torch.from_numpy(ids.astype("int64"))


def gather(src: torch.Tensor, idx) -> torch.Tensor:
    """out[i] = src[idx[i]] -> a new (M, C) tensor on src's device."""
    if src.device.type == "cpu":
        return gather_chunks_ref(src, _ids_tensor(host_ids(idx, src.shape[0])))
    return gather_chunks(src, idx)


def scatter(dst: torch.Tensor, src: torch.Tensor, idx) -> torch.Tensor:
    """dst[idx[i]] = src[i] in place (ids unique); returns ``dst``."""
    if dst.device.type == "cpu":
        ids = host_ids(idx, dst.shape[0], unique=True)
        return scatter_chunks_ref(dst, src, _ids_tensor(ids))
    return scatter_chunks(dst, src, idx)
