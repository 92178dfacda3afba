"""Checkpoints, PyTorch port of ``src/repro/training/checkpoint.py``, in
the reference's on-disk layout, so that a checkpoint crosses between
the two packages both ways.

Layout: ``<dir>/step_<N:08d>/manifest.json`` plus one ``.npy`` per leaf,
named by the leaf's path (dict keys and list indices joined by ``__``,
leaves in the reference's order: dict keys sorted).  numpy has no
bfloat16, so a bf16 leaf is stored as its uint16 bits and named
``bfloat16`` in the manifest.  A save is atomic: it writes a tmp
directory and renames it.  ``restore`` loads into the structure of a
target tree, checks every shape, and puts each leaf on its target's
device.

On a mesh, every rank calls ``save`` and ``restore`` with the same
``shardings`` (a tree of ``mesh.Sharding``, one per leaf): ``save``
all-gathers each sharded leaf, and rank 0 alone writes the layout above,
unchanged; ``restore`` reads each rank's ``local_slice`` of every leaf
(memory-mapped, so a rank reads only its slice), for any mesh, a
degraded one included, as the reference's ``device_put`` with new
``NamedSharding``s does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import (
    coordinate, entry_axes, gather_full, local_slice, mesh_axis_size,
    spec_axes)
from repro_torch.models import param as PM


def _leaves(tree):
    """(key, leaf) in the reference's order and naming."""
    for path, leaf in PM.tree_leaves_with_paths(tree):
        yield path.replace("/", "__") or "root", leaf


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(numpy array as stored, dtype name for the manifest)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def gathered(tree, shardings):
    """``tree`` with every leaf whole: each sharded leaf all-gathered
    (a collective: every rank of the mesh calls it)."""
    if shardings is None:
        return tree
    out = []
    for (_, leaf), s in zip(_leaves(tree), PM.tree_leaves(shardings)):
        mesh, spec = s
        shape = tuple(d * mesh_axis_size(mesh, entry_axes(p))
                      for d, p in zip(leaf.shape, spec))
        out.append(gather_full(leaf.detach(), shape, spec, mesh)
                   if spec_axes(spec) else leaf)
    return PM.tree_unflatten(tree, out)


def save(ckpt_dir: str | Path, step: int, tree, *, extra: dict | None = None,
         shardings=None):
    """Synchronous checkpoint save; atomic via tmp-dir rename.  With
    ``shardings``, every rank calls it and rank 0 writes."""
    tree = gathered(tree, shardings)
    if not _writer():
        return None
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for key, leaf in _leaves(tree):
        arr, dtype_name = _host(leaf)
        np.save(tmp / f"{key}.npy", arr)
        manifest["leaves"].append(
            {"key": key, "shape": list(arr.shape), "dtype": dtype_name})
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight)."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, ckpt_dir, step, tree, *, extra=None, shardings=None):
        self.wait()
        tree = gathered(tree, shardings)
        if not _writer():
            return
        # copied to the host up front, so the training step can update
        # the parameters in place while the thread writes
        snapshot = PM.tree_map(lambda t: t.detach().to("cpu", copy=True),
                               tree)
        self._thread = threading.Thread(
            target=save, args=(ckpt_dir, step, snapshot),
            kwargs={"extra": extra}, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, step: int, target_tree, shardings=None):
    """Restore into the structure of ``target_tree``: each leaf
    shape-checked against its target and put on the target's device, in
    the dtype it was saved in.  With ``shardings`` (possibly for another
    mesh than the checkpoint was written under), each target leaf is this
    rank's ``local_slice`` of the saved array.  Returns (tree,
    manifest)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    meta = {m["key"]: m for m in manifest["leaves"]}
    shd = (PM.tree_leaves(shardings) if shardings is not None
           else [None] * len(PM.tree_leaves(target_tree)))
    out = []
    for (key, tgt), s in zip(_leaves(target_tree), shd):
        if key not in meta:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(d / f"{key}.npy", mmap_mode="r")
        if s is not None:
            mesh, spec = s
            arr = arr[local_slice(arr.shape, spec, mesh, coordinate(mesh))]
        t = torch.from_numpy(np.array(arr, order="C"))
        if meta[key]["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if tuple(t.shape) != tuple(tgt.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != target "
                             f"{tuple(tgt.shape)}")
        out.append(t.to(tgt.device))
    return PM.tree_unflatten(target_tree, out), manifest


def load_extra(ckpt_dir: str | Path, step: int) -> dict:
    with open(Path(ckpt_dir) / f"step_{step:08d}" / "manifest.json") as f:
        return json.load(f)["extra"]
