"""Gradient compression for cross-pod reduction: int8 quantized all-reduce
with error feedback, PyTorch port of ``src/repro/distributed/compression.py``.

On the 2x16x16 multi-pod mesh the within-pod reduction stays full
precision; the pod-to-pod hop (the slower links) carries int8 codes + one
f32 scale per 128-block — ~4x less cross-pod traffic.  The quantization
residual is carried in an error-feedback buffer (kept alongside optimizer
state) so the bias vanishes over steps (EF-SGD style).

The codes and scales are bit-equal to the reference's: the same block of
128, ``scale = max|x| / 127 + 1e-12`` in f32 and rounding half to even
(``torch.round``, as ``jnp.round``).  The reference's ``pmax`` and
``psum`` over the pod axis are ``all_reduce(MAX)`` on the f32 scales and
``all_reduce(SUM)`` on the int32 codes over ``mesh.get_group("pod")``,
so the sync runs on the whole ``(pod, data, model)`` mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import costs
from repro_torch.models import param as PM

_BLOCK = 128


def _f32(value, device) -> torch.Tensor:
    # a 0-d f32 tensor on the operand's device, where the reference's
    # Python float meets an f32 array as a weak type
    return torch.tensor(value, dtype=torch.float32, device=device)


def _pad_to_block(x):
    n = x.numel()
    npad = (-n) % _BLOCK
    flat = F.pad(x.reshape(-1), (0, npad))
    return flat.reshape(-1, _BLOCK), n


def quantize(x):
    xb, n = _pad_to_block(x.to(torch.float32))
    scale = xb.abs().amax(dim=-1, keepdim=True) / _f32(127.0, x.device) \
        + _f32(1e-12, x.device)
    q = torch.round(xb / scale).to(torch.int8)
    return q, scale, n


def dequantize(q, scale, n, shape):
    x = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return x.reshape(shape)


def compressed_psum_leaf(g, err, group):
    """Quantize (g + err) -> sum the int8 codes over ``group`` ->
    dequantize.

    Returns (reduced, new_err).  Codes are made commensurable by rescaling
    every pod's codes to the max participating block scale; the int8 codes
    are accumulated in int32 (no overflow for <= 2^23 pods).
    """
    gf = g.to(torch.float32) + err
    q, scale, n = quantize(gf)
    gmax = scale.clone()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    costs.collective("all-reduce", gmax)
    requant = torch.round(q.to(torch.float32) * (scale / gmax)).to(torch.int8)
    summed = requant.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    costs.collective("all-reduce", summed)
    reduced_blocks = summed.to(torch.float32) * gmax
    reduced = reduced_blocks.reshape(-1)[:n].reshape(g.shape)
    # error feedback: the part this pod failed to encode
    sent = (requant.to(torch.float32) * gmax).reshape(-1)[:n].reshape(g.shape)
    new_err = gf - sent
    return reduced.to(g.dtype), new_err


def cross_pod_grad_sync(grads, err_tree, mesh, axis_name: str = "pod"):
    """int8 all-reduce of every gradient leaf over the pod axis.

    Gradients enter as per-pod partial sums (batch sharded over "pod" must
    NOT have been summed over it yet); returns (fully-reduced gradients,
    new error feedback), each in the trees' structure.
    """
    group = mesh.get_group(axis_name)
    flat_g, flat_e = PM.tree_leaves(grads), PM.tree_leaves(err_tree)
    out = [compressed_psum_leaf(g, e, group) for g, e in zip(flat_g, flat_e)]
    return (PM.tree_unflatten(grads, [o[0] for o in out]),
            PM.tree_unflatten(grads, [o[1] for o in out]))


def init_error_feedback(params):
    return PM.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
