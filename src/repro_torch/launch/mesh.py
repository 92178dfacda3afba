"""Production mesh factories, PyTorch port of ``src/repro/launch/mesh.py``.

Functions (not module-level constants) so importing this module never
touches a process group.  Each factory returns a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names over ``device_type`` (``cuda`` unless the caller asks for
``cpu``).  A CUDA mesh runs on NCCL and a CPU mesh on gloo; neither
falls back to the other.

``make_smoke_mesh`` starts a process group of one itself when none
exists (or, under ``torchrun``, one of ``WORLD_SIZE`` ranks from the
environment, for a ``shape`` the caller gives).  The production meshes
need 256 or 512 ranks: under ``torchrun`` they start the group from the
environment, and they raise when the world is another size.
"""
from __future__ import annotations

import os

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device_type: str) -> str:
    if device_type not in _BACKEND:
        raise ValueError(f"no process-group backend for {device_type!r}")
    return _BACKEND[device_type]


def _ensure_group(device_type: str, world: int):
    """A process group of ``world`` ranks: the existing one, or one of a
    single rank on a private store, or one from ``torchrun``'s
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    if not dist.is_initialized():
        env = os.environ.get("WORLD_SIZE")
        if world == 1 and env in (None, "1"):
            dist.init_process_group(_backend(device_type),
                                    store=dist.HashStore(), rank=0,
                                    world_size=1)
        elif env is None:
            raise RuntimeError(
                f"a {world}-rank mesh needs a process group: WORLD_SIZE is "
                f"not set (start it under torchrun with {world} processes)")
        elif int(env) != world:
            raise RuntimeError(f"a {world}-rank mesh needs WORLD_SIZE={world},"
                               f" not {env}")
        else:
            if device_type == "cuda":
                import torch
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(_backend(device_type))
    elif dist.get_world_size() != world:
        raise RuntimeError(f"a {world}-rank mesh on a process group of "
                           f"{dist.get_world_size()} ranks")
    backend = dist.get_backend()
    if backend not in (_BACKEND[device_type], "fake"):
        raise RuntimeError(f"a {device_type} mesh on a {backend} group")


def _mk(shape, axes, device_type: str):
    n = 1
    for s in shape:
        n *= s
    _ensure_group(device_type, n)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return _mk(*production_shape(multi_pod), device_type)


def make_smoke_mesh(device_type: str = "cuda", shape=(1, 1)):
    """1x1 mesh over the one device of a single process; under
    ``torchrun``, the ``shape`` the caller gives (``launch/train.py
    --mesh 2x2``) over ``data`` and ``model``."""
    return _mk(tuple(shape), ("data", "model"), device_type)


def degraded_mesh_shape(n_failed_hosts: int, *, chips_per_host: int = 4,
                        multi_pod: bool = False):
    """(shape, axis names) of the mesh after host failures: the data axis
    shrinks to the largest size that fits the surviving devices.

    The reference's default of 4 devices a host is a TPU v5e host's; an
    HGX H100 host has 8 GPUs, so callers there pass ``chips_per_host=8``.
    The model axis stays whole (TP groups must stay whole).
    """
    total = (2 * 16 * 16 if multi_pod else 16 * 16) - n_failed_hosts * chips_per_host
    model = 16
    data = total // model
    if data < 1:
        raise ValueError("not enough surviving chips for one model group")
    if multi_pod and data % 2 == 0:
        return (2, data // 2, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def make_degraded_mesh(n_failed_hosts: int, *, chips_per_host: int = 4,
                       multi_pod: bool = False, device_type: str = "cuda"):
    """Elastic re-mesh after host failures (``degraded_mesh_shape``)."""
    return _mk(*degraded_mesh_shape(n_failed_hosts,
                                    chips_per_host=chips_per_host,
                                    multi_pod=multi_pod), device_type)
