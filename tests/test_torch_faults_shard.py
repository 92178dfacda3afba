"""The port's chaos harness and sharded simulator against the reference's.

``core/faults.py`` and ``core/shard.py`` are copies (held line for line
by ``tests/test_torch_sim_equiv.py``).  Here every scenario of
``tests/test_faults.py``, ``tests/test_shard_equiv.py`` and
``tests/test_shard_parallel.py`` runs through both packages: each keeps
its own assertions, and the port's observable results (completion times,
event traces, counters, digests) must equal the reference's exactly.
Then one chaos run, a ``WorkflowEngine`` under a seeded schedule of all
four fault kinds, runs with no backend, with ``TorchBackend(device=
"cpu")`` and with the reference's ``JaxBackend``: the simulated trace
must not move, and the bytes every backend keeps must be the same.
The sharded simulator runs on the CPU only (parallel mode forks).
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import benchmarks.fleet as F  # noqa: E402
from benchmarks.workloads import arrivals  # noqa: E402

from repro.core.backend_jax import JaxBackend  # noqa: E402
from repro_torch.core.backend_torch import (  # noqa: E402
    TorchBackend,
    nbytes_of,
    synth_payload,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402
from _portref import PORT, REF, both  # noqa: E402

# ----------------------------------------------- tests/test_faults.py ---

def _kill_contended_link_mid_burst(lib):
    sim = lib.linksim.LinkSim(lib.topology.dgx_v100(), policy="drr")
    done = {}
    tids = [sim.submit(f, [((a, b), 1.0)], 64.0, t=0.0,
                       on_done=lambda s, tr: done.__setitem__(tr.tid, s.now))
            for f, a, b in (("a", "gpu0", "gpu1"), ("b", "gpu0", "gpu1"),
                            ("c", "gpu2", "gpu3"))]
    sim.call_at(0.3, lambda s: s.kill_link("gpu0", "gpu1"))
    sim.run()
    for tid in tids[:2]:
        tr = sim.transfers[tid]
        assert tr.failed and tr.t_done >= 0.3
        assert tr.chunks_done < tr.n_chunks and done[tid] == tr.t_done
    tr = sim.transfers[tids[2]]
    assert not tr.failed and done[tids[2]] == pytest.approx(64.0 / 48.0)
    assert sim.mb_by_class["fg"] == pytest.approx(64.0)
    return done, sim.n_events, dict(sim.mb_by_class)


def _kill_link_fails_queued_and_future_arrivals(lib):
    sim = lib.linksim.LinkSim(lib.topology.dgx_v100(), policy="drr")
    seen = []
    sim.kill_link("gpu0", "gpu1")
    t = sim.submit("f", [(("gpu0", "gpu1"), 1.0)], 16.0, t=1.0,
                   on_done=lambda s, tr: seen.append(tr.failed))
    sim.run()
    assert sim.transfers[t].failed and seen and seen[0]
    return seen, sim.transfers[t].t_done


def _brownout_retimes_in_flight_service(lib):
    sim = lib.linksim.LinkSim(lib.topology.dgx_v100(), policy="drr")
    done = {}
    tid = sim.submit("f", [(("gpu0", "gpu1"), 1.0)], 64.0, t=0.0,
                     on_done=lambda s, tr: done.__setitem__("t", s.now))
    sim.call_at(64.0 / 48.0 / 2,
                lambda s: s.retime_link("gpu0", "gpu1", 24.0))
    sim.run()
    assert not sim.transfers[tid].failed
    assert 64.0 / 48.0 < done["t"] <= 64.0 / 24.0
    assert done["t"] == pytest.approx(2.0, rel=0.1)
    return done["t"]


def _engine_replans_around_link_death(lib):
    tube = lib.api.FaaSTube(lib.topology.dgx_v100(), lib.api.FAASTUBE)
    tube.engine.recovery = lib.transfer.RecoveryPolicy()
    res = {}
    plan = tube.engine.compile("g2g", "f", "gpu1", "gpu5", 64.0)
    tube.engine.submit(plan, 0.0,
                       on_done=lambda s, tr: res.setdefault("t", s.now),
                       on_fail=lambda s, e: res.setdefault("err", e))
    tube.sim.call_at(0.2, lambda s: tube.fail_link("gpu1", "gpu5"))
    tube.sim.run()
    assert "err" not in res and "t" in res
    assert tube.engine.retries >= 1 and tube.engine.failures == 0
    assert ("gpu1", "gpu5") not in tube.topo.edges
    return res["t"], tube.engine.retries


def _retry_exhaustion_surfaces_structured_failure(lib):
    tube = lib.api.FaaSTube(lib.topology.dgx_v100(), lib.api.FAASTUBE)
    tube.engine.recovery = lib.transfer.RecoveryPolicy(max_retries=3)
    errs = []
    plan = tube.engine.compile("g2g", "f", "gpu0", "gpu5", 32.0)
    tube.engine.submit(plan, 0.0, on_done=lambda s, tr: errs.append("done"),
                       on_fail=lambda s, e: errs.append(e))

    def isolate(s):
        for nb in list(tube.topo.neighbors("gpu0")):
            tube.fail_link("gpu0", nb)
    tube.sim.call_at(0.1, isolate)
    tube.sim.run()
    assert len(errs) == 1 and isinstance(errs[0], lib.errors.TransferFailed)
    e = errs[0]
    assert (e.func, e.kind, e.src, e.dst) == ("f", "g2g", "gpu0", "gpu5")
    assert e.attempts >= 1 and tube.engine.failures == 1
    return e.cause, e.attempts, tube.sim.now


def _hop_deadline_watchdog_fails_stalled_transfer(lib):
    tube = lib.api.FaaSTube(lib.topology.dgx_v100(), lib.api.FAASTUBE)
    tube.engine.recovery = lib.transfer.RecoveryPolicy(
        max_retries=1, deadline_base_ms=0.2)
    errs = []
    plan = tube.engine.compile("g2g", "f", "gpu0", "gpu2", 64.0)
    tube.engine.submit(plan, 0.0, on_done=lambda s, tr: errs.append("done"),
                       on_fail=lambda s, e: errs.append(e))
    tube.sim.run()
    assert len(errs) == 1 and isinstance(errs[0], lib.errors.TransferFailed)
    assert errs[0].cause == "deadline"
    return errs[0].attempts, tube.sim.now


def _backoff_is_capped_exponential(lib):
    rec = lib.transfer.RecoveryPolicy(backoff_ms=2.0, backoff_cap_ms=8.0)
    delays = [min(rec.backoff_ms * 2 ** a, rec.backoff_cap_ms)
              for a in range(5)]
    assert delays == [2.0, 4.0, 8.0, 8.0, 8.0]
    assert lib.transfer.RecoveryPolicy().deadline_ms(64.0) == 0.0
    armed = lib.transfer.RecoveryPolicy(deadline_base_ms=1.0,
                                        deadline_per_mb=0.5)
    assert armed.deadline_ms(64.0) == pytest.approx(33.0)
    return delays, armed.deadline_ms(64.0)


def _node_crash_invalidates_store_and_fails_parked_fetches(lib):
    tube = lib.api.FaaSTube(lib.topology.cluster(2), dataclasses.replace(
        lib.api.FAASTUBE, store_cap_mb=64.0))
    tube.engine.recovery = lib.transfer.RecoveryPolicy()
    sim = tube.sim
    tube.store("f", "d1", 40.0, "n1:gpu0", 0.0, consumer_pos=1)
    tube.store("f", "d2", 40.0, "n1:gpu0", 0.0, consumer_pos=2)
    sim.run()
    item = tube.items["n1:gpu0"]["d1"]
    assert item.state == lib.migration.HOST
    errs = []
    for g in ("g1", "g2"):
        tube.fetch(g, "d1", "n1:gpu1", sim.now,
                   on_ready=lambda s, t: errs.append("ready"),
                   on_error=lambda s, e: errs.append(e))
    tube.crash_node("n1")
    sim.run()
    assert len(errs) == 2
    assert all(isinstance(e, lib.errors.FaaSTubeError) for e in errs)
    assert any(isinstance(e, lib.errors.ObjectLost) for e in errs)
    assert "n1:gpu0" not in tube.pools and "n1" in tube.dead_nodes
    with pytest.raises(KeyError):
        tube.index.lookup("n0", "d1")
    return [type(e).__name__ for e in errs], sim.now, dict(tube.stats)


def _spill_failure_leaves_device_copy_authoritative(lib):
    tube = lib.api.FaaSTube(lib.topology.cluster(2), lib.api.FAASTUBE)
    sim = tube.sim
    tube.store("f", "d1", 32.0, "n0:gpu0", 0.0)
    sim.run()
    item = tube.items["n0:gpu0"]["d1"]
    tube._spill(item, "n0:gpu0", sim.now)
    assert item.state == lib.migration.SPILLING
    tube.lose_host("n0:host")
    sim.run()
    assert item.state == lib.migration.DEVICE and item.held == "n0:gpu0"
    assert item.host == ""
    rec, _ = tube.index.lookup("n0", "d1")
    assert rec.device == "n0:gpu0"
    return sim.now, dict(tube.stats)


def _lose_host_drops_spilled_items(lib):
    tube = lib.api.FaaSTube(lib.topology.cluster(2), dataclasses.replace(
        lib.api.FAASTUBE, store_cap_mb=64.0))
    tube.store("f", "d1", 40.0, "n0:gpu0", 0.0, consumer_pos=1)
    tube.store("f", "d2", 40.0, "n0:gpu0", 0.0, consumer_pos=2)
    tube.sim.run()
    assert tube.items["n0:gpu0"]["d1"].state == lib.migration.HOST
    tube.lose_host("n0:host")
    assert "d1" not in tube.items["n0:gpu0"] and tube.stats["lost"] >= 1
    with pytest.raises(KeyError):
        tube.index.lookup("n0", "d1")
    assert tube.items["n0:gpu0"]["d2"].state == lib.migration.DEVICE
    return tube.sim.now, dict(tube.stats)


def _video_engine(lib, recover: bool):
    topo = lib.topology.cluster(2)
    w = lib.workflow.WORKFLOWS["video"]
    gpus = [g for g in topo.gpus if g.startswith("n0:")]
    placements = {w.name: {"face_det0": gpus[0], "face_det1": gpus[1],
                           "face_det2": gpus[2], "recognize": gpus[3]}}
    eng = lib.executor.WorkflowEngine(topo, lib.api.FAASTUBE,
                                      placements=placements, recover=recover)
    eng.tube.engine.recovery = lib.transfer.RecoveryPolicy()
    return eng, w


def _requests(eng):
    return sorted((r.rid, r.t_arrive, r.t_done, r.h2g_ms, r.g2g_ms,
                   bool(r.failed)) for r in eng.completed + eng.failed)


def _lineage_reexecutes_lost_fan_in_intermediate(lib):
    eng, w = _video_engine(lib, recover=True)
    eng.submit_workflow(w, 0.0)
    eng.tube.sim.call_at(30.0, lambda s: eng.tube.crash_node("n0"))
    eng.run()
    assert len(eng.completed) == 1 and not eng.failed
    assert eng.recovered_stages >= 1
    assert all(g.startswith("n1:") for g in eng._remap.values())
    return _requests(eng), eng.recovered_stages, sorted(eng._remap.items())


def _no_retry_arm_fails_request_on_crash(lib):
    eng, w = _video_engine(lib, recover=False)
    eng.submit_workflow(w, 0.0)
    eng.tube.sim.call_at(30.0, lambda s: eng.tube.crash_node("n0"))
    eng.run()
    assert len(eng.completed) == 0
    assert len(eng.failed) == 1 and eng.failed[0].failed
    return _requests(eng)


def _recovery_budget_caps_reexecution(lib):
    eng, w = _video_engine(lib, recover=True)
    eng.submit_workflow(w, 0.0)
    rs, s = eng.requests[0], w.stages[1]
    assert all(eng._budget_ok(rs, s) for _ in range(5))
    assert not eng._budget_ok(rs, s)
    return True


def _error_taxonomy_is_shared_and_structured(lib):
    E = lib.errors
    for cls in (E.TransferFailed, E.ObjectLost, E.NodeFailure,
                E.StragglerTimeout, E.PoolCapacityError):
        assert issubclass(cls, E.FaaSTubeError)
    tf = E.TransferFailed("f", "a", "b", "g2g", "link a-b", 3)
    assert (tf.func, tf.src, tf.dst, tf.kind, tf.cause, tf.attempts) == \
        ("f", "a", "b", "g2g", "link a-b", 3)
    ol = E.ObjectLost("d1", "n1", "node n1 crashed")
    assert ol.data_id == "d1" and ol.node == "n1"
    return str(tf), str(ol)


def _pool_capacity_error_carries_structured_cause(lib):
    pool = lib.elastic_pool.ElasticPool("gpu0", capacity_mb=4.0)
    with pytest.raises(lib.errors.PoolCapacityError) as ei:
        pool.alloc("f", 100.0, 0.0)
    assert ei.value.device == "gpu0" and ei.value.cause == "capacity"
    assert ei.value.need_mb == pytest.approx(100.0)
    return str(ei.value)


def _fault_schedule_generation_is_seeded(lib):
    topo = lib.topology.cluster(4)
    kw = dict(horizon_ms=200.0, n_link=4, n_brownout=2, n_node=1, n_host=1)
    a = lib.faults.FaultSchedule.generate(topo, seed=7, **kw)
    b = lib.faults.FaultSchedule.generate(topo, seed=7, **kw)
    c = lib.faults.FaultSchedule.generate(topo, seed=8, **kw)
    assert list(a) == list(b) and len(a) == 8 and list(a) != list(c)
    assert a.by_kind()["link"] == 4 and a.by_kind()["node"] == 1
    return [dataclasses.astuple(f) for f in a]


def _empty_schedule_is_bit_identical_zero_overhead(lib):
    def run(arm: bool):
        eng = lib.executor.WorkflowEngine(lib.topology.cluster(2),
                                          lib.api.FAASTUBE)
        if arm:
            lib.faults.FaultInjector(
                eng.tube, lib.faults.FaultSchedule(),
                recovery=lib.transfer.RecoveryPolicy()).arm()
        for i, name in enumerate(("video", "driving", "image")):
            eng.submit_workflow(lib.workflow.WORKFLOWS[name], 3.0 * i)
        e0 = lib.linksim.TOTAL_EVENTS
        eng.run()
        return (lib.linksim.TOTAL_EVENTS - e0,
                sorted(r.t_done for r in eng.completed))

    plain = run(False)
    assert plain == run(True)
    return plain


FAULT_SCENARIOS = [
    _kill_contended_link_mid_burst,
    _kill_link_fails_queued_and_future_arrivals,
    _brownout_retimes_in_flight_service,
    _engine_replans_around_link_death,
    _retry_exhaustion_surfaces_structured_failure,
    _hop_deadline_watchdog_fails_stalled_transfer,
    _backoff_is_capped_exponential,
    _node_crash_invalidates_store_and_fails_parked_fetches,
    _spill_failure_leaves_device_copy_authoritative,
    _lose_host_drops_spilled_items,
    _lineage_reexecutes_lost_fan_in_intermediate,
    _no_retry_arm_fails_request_on_crash,
    _recovery_budget_caps_reexecution,
    _error_taxonomy_is_shared_and_structured,
    _pool_capacity_error_carries_structured_cause,
    _fault_schedule_generation_is_seeded,
    _empty_schedule_is_bit_identical_zero_overhead,
]


@pytest.mark.parametrize("scenario", FAULT_SCENARIOS,
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_scenario_equals_reference(scenario):
    both(scenario)


def test_core_reexports_the_fault_harness():
    from repro_torch import core
    assert core.FaultSchedule is PORT.faults.FaultSchedule
    assert core.FaultInjector is PORT.faults.FaultInjector
    assert core.Fault is PORT.faults.Fault


_TRACE_SCRIPT = r"""
import hashlib, json
from {pkg}.core.api import FAASTUBE
from {pkg}.core.faults import FaultInjector, FaultSchedule
from {pkg}.core.topology import cluster
from {pkg}.core.transfer import RecoveryPolicy
from {pkg}.serving.executor import WorkflowEngine
from {pkg}.serving.workflow import WORKFLOWS

topo = cluster(2)
sched = FaultSchedule.generate(topo, seed=11, horizon_ms=150.0,
                               n_link=3, n_brownout=2, n_node=1)
eng = WorkflowEngine(topo, FAASTUBE)
FaultInjector(eng.tube, sched, recovery=RecoveryPolicy()).arm()
for i, name in enumerate(("video", "driving", "traffic", "image")):
    eng.submit_workflow(WORKFLOWS[name], 5.0 * i)
eng.run()
trace = sorted(
    (tr.tid, tr.func, round(tr.t_submit, 9), round(tr.t_done, 9),
     tr.failed, tr.chunks_done)
    for tr in eng.tube.sim.transfers.values())
trace.append(tuple(sorted(round(r.t_done, 9) for r in eng.completed)))
print(hashlib.sha256(json.dumps(trace, sort_keys=True,
                                default=list).encode()).hexdigest())
"""


def _digest(script: str, hashseed: str) -> str:
    env = dict(os.environ, PYTHONHASHSEED=hashseed,
               PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_chaos_trace_identical_across_hash_seeds():
    """The port's chaos trace does not depend on PYTHONHASHSEED and is
    the reference's."""
    port = {_digest(_TRACE_SCRIPT.format(pkg="repro_torch"), hs)
            for hs in ("0", "1", "31337")}
    assert port == {_digest(_TRACE_SCRIPT.format(pkg="repro"), "0")}


# ------------------------------------------- tests/test_shard_equiv.py ---

def _trace(sim):
    log = []
    orig = sim._exec

    def _exec(ev):
        log.append((ev[0], ev[1], ev[2]))
        return orig(ev)

    sim._exec = _exec
    return log


def _pair(lib, topo_fn, drive):
    """Both engines of one package on one scenario: their popped-event
    traces, completion times, clocks and event counts must be equal."""
    out = []
    for cls in (lib.linksim.LinkSim, lib.shard.ShardedLinkSim):
        sim = cls(topo_fn(lib), policy="drr", bg_every=0)
        log = _trace(sim)
        drive(sim)
        sim.run()
        out.append((tuple(log),
                    {tid: tr.t_done for tid, tr in sim.transfers.items()},
                    sim.now, sim.n_events))
    assert out[0] == out[1]
    return out[1]


def _contended(seed):
    import random

    def drive(sim):
        r = random.Random(seed)
        for i in range(12):
            f = f"f{i}"
            sim.set_rate_weight(f, 0.25 + r.random() * 3)
            if r.random() < 0.3:
                sim.set_func_class(f, "bg")
            src, dst = r.sample(["gpu0", "gpu1", "gpu2", "gpu3"], 2)
            sim.submit(f, [((src, dst), 24.0)], 4.0 + r.random() * 96.0,
                       t=r.random() * 8.0)
    return lambda lib: _pair(lib, lambda lb: lb.topology.dgx_v100(), drive)


def _striped(seed):
    import random

    def drive(sim):
        r = random.Random(100 + seed)
        for i in range(8):
            f = f"m{i}"
            sim.set_rate_weight(f, 0.5 + r.random())
            sim.submit(f, [(("gpu0", "gpu2"), 24.0),
                           (("gpu0", "gpu1", "gpu2"), 24.0)],
                       16.0 + r.random() * 64.0, t=r.random() * 4.0)
    return lambda lib: _pair(lib, lambda lb: lb.topology.dgx_v100(), drive)


def _cluster3(lib):
    return lib.topology.cluster(3, base=lib.topology.dgx_v100)


def _cut_through(seed):
    import random

    def drive(sim):
        r = random.Random(200 + seed)
        for i in range(8):
            f = f"x{i}"
            a, b = r.sample(range(3), 2)
            path = (f"n{a}:gpu0", f"n{a}:host", f"n{b}:host",
                    f"n{b}:gpu{r.randrange(2)}")
            sim.set_rate_weight(f, 0.5 + r.random() * 2)
            sim.submit(f, [(path, 12.5)], 8.0 + r.random() * 56.0,
                       t=r.random() * 6.0)
    return lambda lib: _pair(lib, _cluster3, drive)


def _faults(seed):
    import random

    def drive(sim):
        r = random.Random(300 + seed)
        tids = []
        for i in range(10):
            a, b = r.sample(range(3), 2)
            path = (f"n{a}:gpu0", f"n{a}:host", f"n{b}:host", f"n{b}:gpu0")
            tids.append(sim.submit(f"k{i}", [(path, 12.5)],
                                   16.0 + r.random() * 48.0,
                                   t=r.random() * 4.0))
        va, vb = r.sample(range(3), 2)
        sim.call_at(2.0 + r.random() * 3,
                    lambda s: s.kill_link(f"n{va}:host", f"n{vb}:host",
                                          "chaos"))
        sim.call_at(1.0 + r.random() * 2,
                    lambda s: s.retime_link(f"n{va}:gpu0", f"n{va}:host",
                                            6.0 + r.random() * 6))
        doomed = tids[r.randrange(len(tids))]
        sim.call_at(r.random() * 5,
                    lambda s: s.fail_transfer(doomed, "chaos"))
    return lambda lib: _pair(lib, _cluster3, drive)


SHARD_SCENARIOS = (
    [pytest.param(_contended(s), id=f"contended-{s}") for s in range(6)]
    + [pytest.param(_striped(s), id=f"striped-{s}") for s in range(4)]
    + [pytest.param(_cut_through(s), id=f"cut_through-{s}")
       for s in range(4)]
    + [pytest.param(_faults(s), id=f"faults-{s}") for s in range(4)])


@pytest.mark.parametrize("scenario", SHARD_SCENARIOS)
def test_sharded_engine_identical_and_equals_reference(scenario):
    both(scenario)


def _fleet(lib, n_nodes: int, n_apps: int):
    """benchmarks/fleet.py's fleet, built from the package's workflows."""
    with mock.patch.object(F, "WORKFLOWS", lib.workflow.WORKFLOWS):
        topo = lib.topology.cluster(n_nodes, base=lib.topology.dgx_v100)
        apps, placements = F.build_fleet(topo, n_nodes, n_apps)
    return topo, apps, placements


def _fleet_engine(lib, sharded: bool, sname: str, with_crash: bool):
    cfg = lib.api.SYSTEMS[sname]
    topo, apps, placements = _fleet(lib, 4, 16)
    sim = lib.shard.ShardedLinkSim(
        topo, policy="drr" if cfg.slo_sched else "fifo",
        bg_every=cfg.bg_guard) if sharded else None
    eng = lib.executor.WorkflowEngine(topo, cfg, placements=placements,
                                      sim=sim)
    log = _trace(eng.tube.sim)
    if with_crash:
        eng.tube.sim.call_at(30.0, lambda s: eng.tube.crash_node("n2"))
    for k, w in enumerate(apps):
        for t in arrivals("bursty", 3, 40.0, k):
            eng.submit_workflow(w, t)
    eng.run()
    lats = tuple(sorted((r.rid, r.t_done - r.t_arrive)
                        for r in eng.completed))
    return tuple(log), lats, len(eng.failed), eng.tube.sim.n_events


@pytest.mark.parametrize("sname,with_crash", [("faastube", False),
                                              ("infless+", False),
                                              ("faastube", True)])
def test_fleet_executor_identical_and_equals_reference(sname, with_crash):
    def run(lib):
        g = _fleet_engine(lib, False, sname, with_crash)
        assert _fleet_engine(lib, True, sname, with_crash) == g
        return g
    both(run)


def test_sharded_engine_partitions_by_node():
    def run(lib):
        topo = lib.topology.cluster(4, base=lib.topology.dgx_v100)
        sim = lib.shard.ShardedLinkSim(topo, policy="drr")
        tube = lib.api.FaaSTube(topo, lib.api.FAASTUBE, sim=sim)
        tube.store("f", "d0", 64.0, "n0:gpu0", 0.0)
        tube.fetch("f", "d0", "n2:gpu1", 1.0)
        tube.store("g", "d1", 32.0, "n1:gpu0", 0.0)
        tube.fetch("g", "d1", "n1:gpu3", 1.0)
        sim.run()
        assert sim.shard_count >= 3
        return sim.shard_count, sim.now, sim.n_events
    both(run)


# ---------------------------------------- tests/test_shard_parallel.py ---

def _plan(lib, *, n_nodes=4, n_apps=16, reqs_per_app=2, seed=0):
    """benchmarks/fleet.py's build_plan, from the package's modules."""
    _topo, apps, placements = _fleet(lib, n_nodes, n_apps)
    arr = {w.name: arrivals("bursty", reqs_per_app, 40.0, seed + k)
           for k, w in enumerate(apps)}
    return lib.shard.ShardPlan(cfg=lib.api.FAASTUBE, n_nodes=n_nodes,
                               apps=apps, placements=placements,
                               arrivals=arr, seed=seed)


def _shard_digest(res):
    recs = tuple(sorted((r.rid, r.t_arrive, r.t_done, r.h2g_ms, r.g2g_ms)
                        for r in res.completed))
    return (len(res.completed), len(res.failed), res.n_events,
            res.rounds, recs)


def test_worker_count_invariant_and_equals_reference():
    def run(lib):
        plan = _plan(lib)
        d = {w: _shard_digest(lib.shard.ShardedTube(plan, workers=w).run())
             for w in (1, 2, 4)}
        assert d[1] == d[2] == d[4]
        assert d[1][0] == 32 and d[1][1] == 0
        return d[1]
    both(run)


def test_all_straddle_requests_complete():
    def run(lib):
        res = lib.shard.ShardedTube(_plan(lib, reqs_per_app=3),
                                    workers=2).run()
        assert len(res.completed) == 48 and not res.failed
        assert all(r.t_done > r.t_arrive for r in res.completed)
        return _shard_digest(res)
    both(run)


def test_parallel_conservative_vs_single_process():
    def run(lib):
        plan = _plan(lib)
        ref = lib.shard.ShardedTube(plan, workers=0).run()
        par = lib.shard.ShardedTube(plan, workers=2).run()
        assert len(par.completed) == len(ref.completed)
        p99 = [sorted(r.t_done - r.t_arrive for r in x.completed)[-1]
               for x in (ref, par)]
        assert p99[1] < 2.0 * p99[0], p99
        return p99
    both(run)


def test_crash_node_retires_shard():
    def run(lib):
        plan = _plan(lib, n_apps=8)
        plan.chaos = [(5.0, "crash_node", ("n1",))]
        digests = []
        for w in (1, 2):
            res = lib.shard.ShardedTube(plan, workers=w).run()
            assert len(res.completed) + len(res.failed) == 16
            assert len(res.failed) == 4
            assert all(r.app.startswith("video@") or r.app == ""
                       for r in res.failed)
            digests.append(_shard_digest(res))
        assert digests[0] == digests[1]
        return digests[0]
    both(run)


_SHARD_SCRIPT = """\
import hashlib, json
from unittest import mock
import benchmarks.fleet as F
from benchmarks.workloads import arrivals
from {pkg}.core.api import FAASTUBE
from {pkg}.core.shard import ShardPlan, ShardedTube
from {pkg}.core.topology import cluster, dgx_v100
from {pkg}.serving.workflow import WORKFLOWS
with mock.patch.object(F, "WORKFLOWS", WORKFLOWS):
    apps, placements = F.build_fleet(cluster(4, base=dgx_v100), 4, 8)
arr = {{w.name: arrivals("bursty", 2, 40.0, k) for k, w in enumerate(apps)}}
plan = ShardPlan(cfg=FAASTUBE, n_nodes=4, apps=apps, placements=placements,
                 arrivals=arr, seed=0)
res = ShardedTube(plan, workers=2).run()
recs = sorted((r.rid, round(r.t_done, 9)) for r in res.completed)
print(hashlib.sha256(json.dumps(
    [res.n_events, res.rounds, recs]).encode()).hexdigest())
"""


def test_parallel_trace_identical_across_hash_seeds():
    port = {_digest(_SHARD_SCRIPT.format(pkg="repro_torch"), hs)
            for hs in ("0", "31337")}
    assert port == {_digest(_SHARD_SCRIPT.format(pkg="repro"), "0")}


def test_sync_timeout_guard(monkeypatch):
    """The port's boundary-sync watchdog fails a deadlocked round loudly
    (the reference's own test runs the same case)."""
    S = PORT.shard

    def hung_worker(conn, plan_bytes, shard_ids):   # pragma: no cover
        while True:
            time.sleep(0.5)

    monkeypatch.setattr(S, "_worker_main", hung_worker)
    plan = _plan(PORT, n_nodes=2, n_apps=2, reqs_per_app=1)
    with pytest.raises(RuntimeError, match="boundary sync deadlock"):
        S.ShardedTube(plan, workers=1, sync_timeout_s=0.2).run()


# --------------------------------------- chaos with a backend armed ---

#: the chaos run at a quarter of the paper's object sizes (32 MB edges):
#: at this scale seed 34 fires every fault kind and re-plans a transfer
CPU_SCALE, CPU_SEED = 0.25, 34


def _check_bytes(be, did, ep, mb):
    np.testing.assert_array_equal(be.read_object(did, ep),
                                  synth_payload(did, nbytes_of(mb)))


def _held(be):
    return {ep: sorted(st.objects) for ep, st in be.stores.items()
            if st.objects}


@pytest.fixture(scope="module")
def chaos_runs():
    runs = {"ref/none": C.chaos_run(None, None, scale=CPU_SCALE,
                                    seed=CPU_SEED, lib=REF),
            "port/none": C.chaos_run(None, None, scale=CPU_SCALE,
                                     seed=CPU_SEED)}
    for name, be, lib in (("port/torch", TorchBackend(device="cpu"), None),
                          ("ref/jax", JaxBackend(), REF)):
        runs[name] = C.chaos_run(be, _check_bytes, scale=CPU_SCALE,
                                 seed=CPU_SEED, lib=lib)
        runs[name]["backend"] = be
    return runs


KEYS = ("trace", "requests", "stats", "fired", "faults", "retries",
        "failures", "n_events", "recovered_stages", "replans", "live")


@pytest.mark.parametrize("name", ["port/none", "port/torch", "ref/jax"])
def test_chaos_run_trace_equals_reference(chaos_runs, name):
    want, got = chaos_runs["ref/none"], chaos_runs[name]
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert all(want["fired"][k] >= 1
               for k in ("link", "brownout", "node", "host"))
    assert want["replans"] and want["stats"]["lost"] > 0


def test_chaos_run_backends_keep_the_same_bytes(chaos_runs):
    """Torch and JAX backends: bytes checked after every fault, at the
    end and after the re-planned transfer; the same objects left in the
    same stores, lost ones included (no fault entry point touches the
    backend: the reference's behaviour, reproduced)."""
    tb, jb = (chaos_runs[k]["backend"] for k in ("port/torch", "ref/jax"))
    assert chaos_runs["port/torch"]["checked"] > 0
    assert _held(tb) == _held(jb)
    for ep, ids in _held(tb).items():
        for did in ids:
            np.testing.assert_array_equal(tb.read_object(did, ep),
                                          jb.read_object(did, ep))
    held = C.held_bytes(tb, chaos_runs["port/torch"]["tube"])
    assert held == C.held_bytes(jb, chaos_runs["ref/jax"]["tube"])
    assert held["device", "lost"][0] > 0 and held["host", "lost"][0] > 0
