"""The port's model-swap tier against the reference's, on the CPU.

``serving/modelcache.py`` is a copy except ``profile_from_arch``, which
walks the port's own spec trees (torch dtypes): its per-layer sizes must
be the reference's for every architecture.  The five scenarios of
``tests/test_modelcache.py`` run through both packages with equal stats
and first-token times.  Then the swap tier of ``chip_smoke.py``'s phase
11, shrunk 128 times, runs with no backend, with ``TorchBackend(device=
"cpu")`` and, through the reference, with ``JaxBackend``: equal stats,
first-token times, loads and evictions; every reload's bytes equal where
it lands; no device copy left by an eviction.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS  # noqa: E402
from repro.core.backend_jax import JaxBackend  # noqa: E402
from repro.serving import modelcache as RMC  # noqa: E402
from repro_torch.core.backend_torch import (  # noqa: E402
    TorchBackend,
    nbytes_of,
    synth_payload,
)
from repro_torch.serving import modelcache as PMC  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402
from _portref import PORT, REF, both  # noqa: E402


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_profile_from_arch_equals_reference(arch):
    ref, port = RMC.profile_from_arch(arch), PMC.profile_from_arch(arch)
    assert isinstance(port, PMC.ModelProfile)
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    half = PMC.profile_from_arch(arch, tp=2, name="x")
    assert half.layer_mb == RMC.profile_from_arch(arch, tp=2,
                                                  name="x").layer_mb


def test_profile_sizes_of_the_swap_tier():
    got = {a: PMC.profile_from_arch(a) for a in ("minicpm-2b", "qwen2-vl-2b",
                                                 "whisper-medium")}
    assert {a: (p.n_layers, round(p.total_mb, 1)) for a, p in got.items()} \
        == {"minicpm-2b": (41, 5450.7), "qwen2-vl-2b": (29, 3554.3),
            "whisper-medium": (25, 817.2)}
    # MiniCPM-2B streams its 566 MB embedding first
    assert got["minicpm-2b"].layer_mb[0] == max(got["minicpm-2b"].layer_mb)


def test_synth_payload_parallel_draw_equals_reference():
    """Checkpoints are synthesised in slices drawn in parallel; the bytes
    are the reference's, slice edges and a ragged tail included."""
    from repro.core.backend_jax import synth_payload as ref_synth
    for did, nbytes in (("ckpt:a", (1 << 26) + 13), ("ckpt:b", 1 << 25)):
        np.testing.assert_array_equal(synth_payload(did, nbytes),
                                      ref_synth(did, nbytes))


# -------------------------------------------- tests/test_modelcache.py ---

def _mc(lib, topo=None, *, policy="slo", pipelined=True,
        host_cache_mb=4096.0, **cfgkw):
    cfgkw.setdefault("store_cap_mb", 800.0)
    tube = lib.api.FaaSTube(topo or lib.topology.dgx_v100(),
                            dataclasses.replace(lib.api.FAASTUBE, **cfgkw))
    return tube, lib.modelcache.ModelCache(
        tube, policy=policy, pipelined=pipelined,
        host_cache_mb=host_cache_mb)


def _prof(lib, name, **kw):
    return lib.modelcache.make_profile(name, "synth", [40.0] * 8, **kw)


def _pinned_host_hit_beats_cold_object_path(lib):
    tube, mc = _mc(lib, lib.topology.cluster(2))
    mc.register(_prof(lib, "hot"), "n1:gpu0", 0.0, prestage=True)
    mc.register(_prof(lib, "cold"), "n1:gpu1", 0.0, prestage=False)
    assert mc.entries["cold"].state == lib.modelcache.EVICTED
    mc.request("hot", 0.0)
    mc.request("cold", 0.0)
    tube.sim.run()
    assert mc.stats["host_hits"] == 1 and mc.stats["cold_misses"] == 1
    ttft = [t for _a, t, _c in mc.ttft]
    assert len(ttft) == 2 and min(ttft) < max(ttft)
    return mc.stats, mc.ttft


def _pipelined_reload_beats_whole_model(lib):
    out = []
    for pipelined, kw in ((True, {}),
                          (False, {"staging": lib.transfer.STORE_FORWARD})):
        tube, mc = _mc(lib, pipelined=pipelined, **kw)
        mc.register(_prof(lib, "m"), "gpu0", 0.0)
        mc.request("m", 0.0)
        tube.sim.run()
        out.append((mc.stats, mc.ttft, mc.entries["m"].land_t))
    (_, pipe, lands), (_, whole, lands2) = out
    assert lands == sorted(lands) and len(set(lands)) >= 3
    assert len(set(lands2)) == 1
    assert (whole[0][1] - pipe[0][1]) / whole[0][1] >= 0.10
    return out


def _skewed_queue_trace(lib):
    out = {}
    for policy in ("slo", "lru"):
        tube, mc = _mc(lib, policy=policy, store_cap_mb=1050.0,
                       host_cache_mb=8192.0)
        mc.register(_prof(lib, "mS", prefill_ms_per_mb=1.0), "gpu0", 0.0)
        for name in ("m1", "m4", "m5"):
            mc.register(_prof(lib, name), "gpu0", 0.0)
        for name, t in [("m1", 0.0), ("m4", 5.0), ("mS", 50.0),
                        ("m1", 80.0), ("m1", 81.0), ("m4", 90.0),
                        ("m5", 100.0)]:
            tube.sim.call_at(t, lambda sim, n=name, t=t: mc.request(n, t))
        tube.sim.run()
        out[policy] = (mc.stats, mc.ttft)
    (slo, slo_t), (lru, lru_t) = out["slo"], out["lru"]
    assert len(slo_t) == 7 and len(lru_t) == 7
    assert slo["evicted_with_queue"] == 0 and lru["evicted_with_queue"] >= 1
    assert slo["cold"] < lru["cold"]
    return out


def _eviction_of_mid_reload_model_is_refused(lib):
    tube, mc = _mc(lib, store_cap_mb=700.0)
    for name in ("a", "b", "c"):
        mc.register(_prof(lib, name), "gpu0", 0.0)
    mc.request("a", 0.0)
    tube.sim.run(until=100.0)
    mc.request("b", 100.0)
    assert mc.entries["b"].state == lib.migration.RELOADING
    mc.request("c", 100.001)
    assert mc.entries["b"].state == lib.migration.RELOADING
    tube.sim.run()
    assert mc.entries["c"].state == lib.migration.DEVICE
    assert mc.stats["load_failures"] == 0 and len(mc.ttft) == 3
    return mc.stats, mc.ttft


def _crash_poisons_in_flight_reload(lib, backend=None):
    tube, mc = _mc(lib, lib.topology.cluster(2))
    if backend is not None:
        tube.backend = tube.engine.backend = backend
    mc.register(_prof(lib, "dying"), "n1:gpu0", 0.0)
    mc.register(_prof(lib, "survivor"), "n0:gpu0", 0.0)
    mc.request("dying", 0.0)
    assert mc.entries["dying"].state == lib.migration.RELOADING
    tube.sim.call_at(1.0, lambda sim: tube.crash_node("n1"))
    mc.request("survivor", 0.0)
    tube.sim.run()
    e = mc.entries["dying"]
    assert mc.stats["load_failures"] >= 1 and mc.stats["failed_requests"] >= 1
    assert e.dead and e.state == lib.modelcache.EVICTED
    assert mc.request("dying", 50.0).failed
    assert mc.entries["survivor"].state == lib.migration.DEVICE
    tube.sim.run()
    return mc.stats, mc.ttft, tube


MC_SCENARIOS = [_pinned_host_hit_beats_cold_object_path,
                _pipelined_reload_beats_whole_model, _skewed_queue_trace,
                _eviction_of_mid_reload_model_is_refused,
                lambda lib: _crash_poisons_in_flight_reload(lib)[:2]]


@pytest.mark.parametrize("scenario", MC_SCENARIOS,
                         ids=["host_hit_vs_cold", "pipelined_reload",
                              "slo_vs_lru", "mid_reload_refusal",
                              "crash_poisoning"])
def test_modelcache_scenario_equals_reference(scenario):
    both(scenario)


def test_crash_mid_reload_with_a_backend():
    """With a backend the reload's bytes land at submit, before the crash
    poisons the load: the copy stays in the device store (the reference's
    behaviour, the same with JaxBackend), but the index has no record of
    it, so nothing reads it as valid; a later reload of the same id to
    the same store replaces it."""
    runs = {}
    for name, lib, be in (("port", PORT, TorchBackend(device="cpu",
                                                      store_mb=512.0)),
                          ("ref", REF, JaxBackend(store_mb=512.0))):
        stats, ttft, tube = _crash_poisons_in_flight_reload(lib, be)
        assert "ckpt:dying" not in tube.index.global_table
        runs[name] = (stats, ttft, be.where("ckpt:dying"))
    assert runs["port"] == runs["ref"]
    assert "n1:gpu0" in runs["port"][2]


# --------------------------------------------- the swap tier, shrunk ---

SCALE = 1 / 128


def _check_bytes(be, did, ep, mb):
    np.testing.assert_array_equal(be.read_object(did, ep),
                                  synth_payload(did, nbytes_of(mb)))


@pytest.mark.parametrize("policy", ["slo", "lru"])
def test_swap_tier_with_backends_equals_reference(policy):
    kw = {"policy": policy, "cap_mb": C.SWAP_CAP_MB * SCALE,
          "host_cache_mb": C.SWAP_HOST_MB * SCALE}
    runs = {}
    for name, lib, be in (("port/none", PORT, None),
                          ("port/torch", PORT, TorchBackend(device="cpu")),
                          ("ref/jax", REF, JaxBackend())):
        profiles = C.swap_profiles(SCALE, lib)
        trace = C.swap_trace([p.name for p, _ in profiles],
                             iat=C.SWAP_IAT_MS * SCALE)
        runs[name] = C.swap_run(be, _check_bytes, profiles, trace, lib=lib,
                                **kw)
        runs[name]["backend"] = be
    keys = ("stats", "ttft", "loads", "evictions", "sim_loads")
    want = {k: runs["port/none"][k] for k in keys}
    for name in ("port/torch", "ref/jax"):
        assert {k: runs[name][k] for k in keys} == want, name
    s = want["stats"]
    assert s["host_hits"] >= 1 and s["cold_misses"] >= 1
    assert s["evictions"] >= 1 and len(want["loads"]) == s["loads"]
    tb, jb = runs["port/torch"]["backend"], runs["ref/jax"]["backend"]
    assert tb.stores[C.SWAP_GPU].pool.peak_used_mb <= kw["cap_mb"]
    assert sorted(tb.stores[C.SWAP_GPU].objects) == \
        sorted(jb.stores[C.SWAP_GPU].objects)
    # the cold reloads after a demotion found no bytes on the registry
    # host and synthesised them there, in both backends alike
    assert [p[:3] for p in runs["port/torch"]["puts"]] == \
        [p[:3] for p in runs["ref/jax"]["puts"]]
    assert any(t_sim > 0 for *_x, t_sim, _s in runs["port/torch"]["puts"])
