"""The system under test: the PyTorch and CUDA port (``src/repro_torch``),
reached through its public entries only.  The benchmark builds the
port's configuration from its own configuration file, hands the port
its own weights and payloads, and calls ``Engine.prefill``,
``Engine.decode`` and ``ModelCache.request``."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

#: the checkout's root: this file lives in ``<root>/perfbench/``
ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def import_port():
    """Put the port's package on the path; raise where the checkout has
    none (a directory holding only the benchmark)."""
    if not (SRC / "repro_torch" / "serving" / "engine.py").is_file():
        raise SystemExit(f"perfbench: no port at {SRC / 'repro_torch'}")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def arch_config(arch: dict):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**arch)


def _layers_view(t: torch.Tensor, held: tuple, rows: list,
                 m: int) -> torch.Tensor:
    """Layers ``rows`` (n lists of m layer indices) of a leaf ``t``
    stacked over the layers ``held``, as one ``(n, m, ...)`` view.  Their
    places in ``t`` have to step evenly along both axes, as a periodic
    layout's do."""
    pos = [[held.index(i) for i in row] for row in rows]
    n = len(pos)
    base = pos[0][0] if n else 0
    a = pos[1][0] - base if n > 1 else 1
    b = pos[0][1] - base if m > 1 else 1
    if any(pos[u][j] != base + u * a + j * b
           for u in range(n) for j in range(m)):
        raise ValueError(f"layers {rows} are not evenly spaced in {held}")
    if not t.is_contiguous():
        raise ValueError("a drawn leaf is not contiguous")
    s0 = t.stride(0)
    return t.as_strided((n, m, *t.shape[1:]), (a * s0, b * s0,
                                                *t.stride()[1:]),
                        t.storage_offset() + base * s0)


def program_params(cfg, w: dict, fam, arch: dict) -> dict:
    """The benchmark's weights (``weights.py``, drawn from ``fam``'s
    table) as the port's parameter tree, by views only: for each run of
    the port's layout (``layout_for(cfg, block_pattern(cfg))``), the
    family's tree of its block kind with each leaf the view of its
    layers, ``(n_units, run_len, ...)`` in a unit and ``(run_len, ...)``
    in the rest.  Each leaf's path, shape and dtype is held to the
    port's own spec."""
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.models.blocks import block_pattern, layout_for
    layout = layout_for(cfg, block_pattern(cfg))
    table = fam.leaves(arch)
    period = sum(rl for _, rl in layout.runs)

    def run(kind, rows, rl):
        return PM.tree_map(lambda name: _layers_view(
            w[name], table[name].layers, rows, rl), fam.block(arch, kind))
    units, start = [], 0
    for kind, rl in layout.runs:
        units.append(run(kind, [[u * period + start + i for i in range(rl)]
                                for u in range(layout.n_units)], rl))
        start += rl
    rest, start = [], layout.n_units * period
    for kind, rl in layout.rest_runs:
        rest.append(PM.tree_map(lambda t: t[0], run(
            kind, [list(range(start, start + rl))], rl)))
        start += rl
    params = PM.tree_map(lambda name: w[name], fam.top(arch))
    params["blocks"] = {"units": units, "rest": rest}
    specs = dict(PM.tree_leaves_with_paths(M.model_specs(cfg)))
    have = dict(PM.tree_leaves_with_paths(params))
    if specs.keys() != have.keys():
        raise ValueError(f"{cfg.name}: leaves {sorted(specs.keys() ^ have.keys())}"
                         f" differ from the port's spec")
    for path, spec in specs.items():
        t = have[path]
        if tuple(t.shape) != tuple(spec.shape) or (
                t.dtype != spec.dtype and t.dtype != torch.float32):
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype} against "
                             f"the port's {spec.shape} {spec.dtype}")
    return params


def engine(cfg, params, device, seq_len: int, batch: int):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.serving.engine import Engine
    return Engine(cfg, ShapeSpec("bench", seq_len, batch, "decode"), params,
                  device=device)


def extend_caches(cfg, caches, to_len: int):
    from repro_torch.serving.engine import extend_caches as ext
    return ext(cfg, caches, to_len)


def checkpoint_profile(cfg, name: str):
    """The layer-granular checkpoint the swap tier reloads."""
    from repro_torch.serving.modelcache import profile_from_arch
    return profile_from_arch(cfg, name=name)


def nbytes_of(size_mb: float) -> int:
    from repro_torch.core.backend_torch import nbytes_of as nb
    return nb(size_mb)


def swap_tier(traffic: dict, device, payloads: dict):
    """``ModelCache`` over ``FaaSTube(cluster(nodes), store_cap_mb=cap,
    backend=TorchBackend)``, each store and the staging ring made at its
    full size before any request.  ``payloads`` ({data_id: uint8 tensor
    on the device}) are the bytes each checkpoint holds: registering a
    checkpoint copies them into the serving node's page-locked store
    where the backend would otherwise synthesise bytes of its own.
    Returns (cache, backend)."""
    from repro_torch.core import api, topology
    from repro_torch.core.backend_torch import TorchBackend
    from repro_torch.core.transfer import host_of
    from repro_torch.serving.modelcache import ModelCache
    cap = traffic["store_cap_mb"]
    host_mb = sum(t.numel() for t in payloads.values()) / 2 ** 20 + 64.0
    be = TorchBackend(store_mb=cap + 64.0, host_mb=host_mb, device=device)
    put = be.put_object

    def seeded_put(data_id, endpoint, payload=None, size_mb=None):
        src = payloads.get(data_id)
        if payload is not None or src is None:
            return put(data_id, endpoint, payload, size_mb)
        st = be.store_for(endpoint)
        if data_id in st:
            st.drop(data_id)
        obj = st.alloc(data_id, src.numel())
        flat = st.slabs[obj.rows[0]:obj.rows[-1] + 1].view(-1)
        if len(obj.rows) * st.slabs.shape[1] != flat.numel():
            raise RuntimeError(f"{data_id}: rows at {endpoint} are not one run")
        flat[:src.numel()].copy_(src)
        flat[src.numel():].zero_()
        return obj

    be.put_object = seeded_put
    gpu = traffic["gpu"]
    be.reserve(gpu, cap + 64.0)
    be.reserve(host_of(gpu), host_mb)
    be.ring_for(host_of(gpu))
    tube = api.FaaSTube(topology.cluster(traffic["nodes"]),
                        dataclasses.replace(api.FAASTUBE, store_cap_mb=cap),
                        backend=be)
    mc = ModelCache(tube, policy=traffic["policy"],
                    host_cache_mb=traffic["host_cache_mb"])
    return mc, be


def landed_bytes_differ(be, data_id: str, endpoint: str,
                        want: torch.Tensor, step: int = 256) -> int:
    """How many of a checkpoint's bytes at ``endpoint`` differ from
    ``want``; every byte where it is not there at all."""
    st = be.stores[endpoint]
    obj = st.objects.get(data_id)
    n = want.numel()
    if obj is None or obj.nbytes != n:
        return n
    rows = obj.rows
    width = st.slabs.shape[1]
    bad = 0
    for s in range(0, len(rows), step):
        part = rows[s:s + step]
        if all(part[i] == part[0] + i for i in range(len(part))):
            got = st.slabs[part[0]:part[0] + len(part)]
        else:
            got = st.slabs[torch.as_tensor(part, device=st.slabs.device)]
        lo = s * width
        hi = min(n, lo + got.numel())
        got = got.view(-1)[:hi - lo]
        if not torch.equal(got, want[lo:hi]):
            bad += int((got != want[lo:hi]).sum())
    return bad
