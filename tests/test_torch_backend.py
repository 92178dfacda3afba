"""Differential conformance: the port's TorchBackend against JaxBackend.

Both backends execute the same compiled TransferPlans (the reference
conformance MATRIX: nine plan kinds x both staging modes) and must land
the same bytes and report the same ExecReport fields — chunk and batch
counts, stripes, peak staging, hop trace and the MB of every progress
event.  The port runs on the CPU here (``device="cpu"``: plain PyTorch
versions of the kernels); the reference runs its jnp arm.  The other
tests twin the reference's own backend tests, plus the port's entry
point and the carry-across of slab stores.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_backend_jax import MATRIX, SIZE_MB, make_engine  # noqa: E402

from repro.core.backend_jax import JaxBackend  # noqa: E402
from repro.core.backend_jax import synth_payload as ref_synth  # noqa: E402
from repro.core.transfer import CUT_THROUGH, STORE_FORWARD  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.api import FAASTUBE, FaaSTube  # noqa: E402
from repro_torch.core.backend_torch import (  # noqa: E402
    TorchBackend,
    load_reference_state,
    nbytes_of,
    synth_payload,
)
from repro_torch.core.linksim import LinkSim  # noqa: E402
from repro_torch.core.pathfinder import PathFinder  # noqa: E402
from repro_torch.core.pinned_buffer import CircularPinnedBuffer  # noqa: E402
from repro_torch.core.transfer import TransferEngine  # noqa: E402

#: the port's twin of each MATRIX topology builder
PORT_TOPO = {"h2g": ttopo.dgx_v100, "g2h": ttopo.dgx_v100,
             "g2g_direct": ttopo.dgx_v100, "g2g_striped": ttopo.dgx_v100,
             "g2g_host": ttopo.dgx_v100, "spill": ttopo.dgx_v100,
             "reload": ttopo.dgx_v100,
             "internode": lambda: ttopo.cluster(2),
             "h2h": lambda: ttopo.cluster(2)}


def port_engine(topo_fn=ttopo.dgx_v100, **kw):
    topo = topo_fn()
    return TransferEngine(LinkSim(topo), PathFinder(topo),
                          CircularPinnedBuffer(), topo, **kw)


def cpu_backend(**kw):
    return TorchBackend(device="cpu", **kw)


def oracle(did, size_mb):
    return synth_payload(did, nbytes_of(size_mb))


def run_plan(eng, be, kind, src, dst, size_mb, did, **exec_kw):
    plan = eng.compile(kind, "t", src, dst, size_mb, data_id=did)
    return plan, be.execute(plan, **exec_kw)


@pytest.mark.parametrize("staging", [CUT_THROUGH, STORE_FORWARD])
@pytest.mark.parametrize("case", sorted(MATRIX))
def test_matrix_matches_jax_backend(case, staging):
    topo_fn, kind, src, dst, kw = MATRIX[case]
    did = f"{case}-{staging}"
    jplan = make_engine(topo_fn, staging=staging, **kw).compile(
        kind, "t", src, dst, SIZE_MB, data_id=did)
    jb = JaxBackend()
    jrep = jb.execute(jplan)
    tb = cpu_backend()
    tplan, trep = run_plan(port_engine(PORT_TOPO[case], staging=staging,
                                       **kw),
                           tb, kind, src, dst, SIZE_MB, did)
    assert [h.kind for h in tplan.hops] == [h.kind for h in jplan.hops]
    for f in ("kind", "src", "dst", "size_mb", "staging", "n_chunks",
              "n_batches", "stripes", "peak_staging_mb", "hop_trace"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert [mb for mb, _ in trep.events] == [mb for mb, _ in jrep.events]
    for ep in (dst, src):
        got = tb.read_object(did, ep)
        np.testing.assert_array_equal(got, jb.read_object(did, ep))
        np.testing.assert_array_equal(got, oracle(did, SIZE_MB))
    assert tb.where(did) == jb.where(did)
    assert all(r.in_flight_mb == 0.0 for r in tb.rings.values())


def test_synth_payload_equals_reference():
    for did, nbytes in (("x", 1), ("drv_in", 3 * 2 ** 20 + 5), ("", 77)):
        np.testing.assert_array_equal(synth_payload(did, nbytes),
                                      ref_synth(did, nbytes))


def test_backend_without_cuda_raises(monkeypatch):
    """The entry point asks for cuda and does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        FaaSTube(ttopo.dgx_v100(), FAASTUBE, backend="torch")
    assert cpu_backend().device == torch.device("cpu")


def test_progress_on_trigger_batch_multiples():
    eng = port_engine()
    be = cpu_backend()
    seen = []
    _, rep = run_plan(eng, be, "h2g", "host", "gpu1", 32.0, "prog",
                      on_progress=seen.append)
    assert seen == [10.0, 20.0, 30.0, 32.0]
    assert [mb for mb, _ in rep.events] == seen
    seen2 = []
    run_plan(eng, be, "h2g", "host", "gpu2", 4.0, "prog2",
             on_progress=seen2.append)
    assert seen2 == [4.0]


@pytest.mark.parametrize("staging", [CUT_THROUGH, STORE_FORWARD])
def test_staging_modes_observably_differ(staging):
    eng = port_engine(lambda: ttopo.cluster(2), staging=staging)
    be = cpu_backend()
    did = f"obs-{staging}"
    _, rep = run_plan(eng, be, "internode", "n0:gpu0", "n1:gpu1", 24.0,
                      did)
    np.testing.assert_array_equal(be.read_object(did, "n1:gpu1"),
                                  oracle(did, 24.0))
    if staging == STORE_FORWARD:
        assert rep.peak_staging_mb >= 24.0
        h0 = [i for i, t in enumerate(rep.hop_trace) if t.startswith("h0")]
        h1 = [i for i, t in enumerate(rep.hop_trace) if t.startswith("h1")]
        assert max(h0) < min(h1)
    else:
        assert rep.peak_staging_mb <= 10.0
        b0 = [t for t in rep.hop_trace if t.startswith("b0:")]
        assert b0[:3] == ["b0:g2h", "b0:net", "b0:h2g"]
    assert all(r.in_flight_mb == 0.0 for r in be.rings.values())


def test_zero_regenerations():
    eng = port_engine()
    be = cpu_backend()
    for i, dev in enumerate(["host", "gpu0", "gpu2"]):
        be.put_object(f"z{i}", dev, size_mb=6.0)

    def boom(*a, **k):
        raise AssertionError("backend regenerated a source object")

    be.put_object = boom
    for i, (kind, src, dst) in enumerate([("h2g", "host", "gpu1"),
                                          ("g2g", "gpu0", "gpu1"),
                                          ("g2h", "gpu2", "host")]):
        did = f"z{i}"
        plan, _ = run_plan(eng, be, kind, src, dst, 6.0, did)
        np.testing.assert_array_equal(be.read_object(did, plan.dst),
                                      oracle(did, 6.0))


def test_facade_spill_reload_real_bytes():
    cfg = dataclasses.replace(FAASTUBE, store_cap_mb=48.0, name="ft-small")
    tube = FaaSTube(ttopo.dgx_v100(), cfg,
                    backend=cpu_backend(store_mb=96.0, host_mb=256.0))
    for i in range(4):
        tube.store("prod", f"d{i}", 16.0, "gpu0", float(i))
    tube.sim.run()
    assert "host" in tube.backend.where("d0")
    tube.fetch("cons", "d0", "gpu2", 100.0)
    tube.sim.run()
    np.testing.assert_array_equal(
        tube.backend.read_object("d0", "gpu2"), oracle("d0", 16.0))


def test_ring_windows_bounded_and_drained():
    eng = port_engine()
    be = cpu_backend()
    for i in range(3):
        run_plan(eng, be, "h2g", "host", f"gpu{i}", 32.0, f"r{i}")
    ring = be.rings["host"]
    assert ring.stalls == 0
    assert ring.peak_mb <= ring.size_mb
    assert ring.in_flight_mb == 0.0
    assert not ring.buf.is_pinned()          # pinned only on a CUDA backend


def test_put_object_replaces_stale_copy():
    be = cpu_backend()
    be.put_object("u", "gpu0", size_mb=4.0)
    fresh = np.arange(nbytes_of(4.0), dtype=np.uint8) % 251
    be.put_object("u", "gpu0", payload=fresh)
    np.testing.assert_array_equal(be.read_object("u", "gpu0"), fresh)
    assert be.store_for("gpu0").used_mb == 4.0


def test_store_grows_past_its_start_and_keeps_bytes():
    be = cpu_backend(store_mb=256.0)
    be.put_object("a", "gpu0", size_mb=60.0)
    st = be.store_for("gpu0")
    first = st.slabs
    be.put_object("b", "gpu0", size_mb=100.0)
    assert st.slabs is not first and st.slabs.shape[0] >= 81
    np.testing.assert_array_equal(be.read_object("a", "gpu0"),
                                  oracle("a", 60.0))
    np.testing.assert_array_equal(be.read_object("b", "gpu0"),
                                  oracle("b", 100.0))


def _snapshot(jb: JaxBackend) -> dict:
    return {ep: {"slabs": np.asarray(st.slabs),
                 "objects": {d: (o.nbytes, o.rows)
                             for d, o in st.objects.items()}}
            for ep, st in jb.stores.items()}


def test_load_reference_state_round_trip():
    """Slab stores carried across from a populated JaxBackend: same rows,
    same bytes; then the same plans on both land the same bytes."""
    jb = JaxBackend()
    for did, ep, mb in (("a", "gpu0", 11.0), ("b", "gpu0", 3.0),
                        ("c", "host", 7.0), ("d", "gpu2", 70.0)):
        jb.put_object(did, ep, size_mb=mb)
    tb = cpu_backend()
    load_reference_state(tb, _snapshot(jb))
    for ep, st in jb.stores.items():
        tst = tb.stores[ep]
        assert {d: o.rows for d, o in tst.objects.items()} == \
            {d: o.rows for d, o in st.objects.items()}
        for did in st.objects:
            np.testing.assert_array_equal(tb.read_object(did, ep),
                                          jb.read_object(did, ep))
    jeng, teng = make_engine(), port_engine()
    for kind, src, dst, did, mb in (("g2g", "gpu0", "gpu1", "a", 11.0),
                                    ("h2g", "host", "gpu3", "c", 7.0),
                                    ("g2h", "gpu2", "host", "d", 70.0)):
        jb.execute(jeng.compile(kind, "t", src, dst, mb, data_id=did))
        run_plan(teng, tb, kind, src, dst, mb, did)
        np.testing.assert_array_equal(tb.read_object(did, dst),
                                      jb.read_object(did, dst))


def test_load_reference_state_refuses_fragmented_pool():
    jb = JaxBackend()
    for did in ("a", "b", "c"):
        jb.put_object(did, "gpu0", size_mb=4.0)
    jb.drop_object("b", "gpu0")        # a hole the replay cannot make
    jb.put_object("e", "gpu0", size_mb=8.0)
    with pytest.raises(ValueError, match="cannot reproduce"):
        load_reference_state(cpu_backend(), _snapshot(jb))


# ------------------------------------------ uploads from a host store -

DIRECT_MB = 23.0        # 12 chunks, ragged 1 MB tail, 3 trigger batches


def _host_backend(host: str, size_mb: float):
    """A CPU backend whose ``host`` store is reserved at full size."""
    be = cpu_backend()
    be.reserve(host, size_mb)
    return be


def _hole(be, host: str):
    """Objects at rows 0-1, 2-3 and 4 of ``host``, the middle one
    dropped: the next object's rows break after its first two."""
    for did, mb in (("fa", 4.0), ("fb", 4.0), ("fc", 2.0)):
        be.put_object(did, host, size_mb=mb)
    be.drop_object("fb", host)


@pytest.mark.parametrize("case", ["h2g", "reload"])
def test_page_locked_host_uploads_in_place(case):
    """A cut-through plan from a host store whose rows are one run
    uploads every batch from the store's own rows, on the CPU as on the
    card: no byte lands in the ring, the report (chunks, batches,
    stripes, the reserved window, hops, progress) equals the JAX
    reference's for the same plan, and every batch after the first is
    queued before the one ahead of it is confirmed."""
    topo_fn, kind, src, dst, kw = MATRIX[case]
    did = f"direct-{case}"
    jrep = JaxBackend().execute(
        make_engine(topo_fn, staging=CUT_THROUGH, **kw).compile(
            kind, "t", src, dst, DIRECT_MB, data_id=did))
    tb = _host_backend(src, DIRECT_MB)
    _, trep = run_plan(port_engine(PORT_TOPO[case], staging=CUT_THROUGH,
                                   **kw),
                       tb, kind, src, dst, DIRECT_MB, did)
    np.testing.assert_array_equal(tb.read_object(did, dst),
                                  oracle(did, DIRECT_MB))
    for f in ("n_chunks", "n_batches", "stripes", "peak_staging_mb",
              "hop_trace"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert [mb for mb, _ in trep.events] == [mb for mb, _ in jrep.events]
    assert trep.n_batches == 3
    assert trep.direct_batches == trep.n_batches
    assert trep.overlapped_batches == trep.n_batches - 1
    ring = tb.rings[src]
    assert ring.peak_mb == trep.peak_staging_mb > 0
    assert ring.in_flight_mb == 0.0
    assert not ring.buf.any()


def test_fragmented_page_locked_object_stages_only_broken_batches():
    """A host object whose rows break once (it fills a hole left by a
    dropped object): the batch across the break is staged through the
    ring, the two run batches upload in place as one pipeline (the
    second queued behind the first: one overlapped batch; the staged
    batch 0 has nothing queued ahead of it), and the bytes and the
    report still equal the reference's."""
    be = _host_backend("host", 64.0)
    _hole(be, "host")
    be.put_object("fe", "host", size_mb=30.0)
    assert be.store_for("host").objects["fe"].rows == \
        (2, 3, *range(5, 18))
    jrep = JaxBackend().execute(make_engine().compile(
        "h2g", "t", "host", "gpu1", 30.0, data_id="fe"))
    _, rep = run_plan(port_engine(), be, "h2g", "host", "gpu1", 30.0, "fe")
    np.testing.assert_array_equal(be.read_object("fe", "gpu1"),
                                  oracle("fe", 30.0))
    assert (rep.n_batches, rep.direct_batches) == (3, 2)
    assert rep.overlapped_batches == 1
    for f in ("n_chunks", "n_batches", "stripes", "peak_staging_mb",
              "hop_trace"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert [mb for mb, _ in rep.events] == [mb for mb, _ in jrep.events]
    assert be.rings["host"].buf.any()        # the broken batch was staged


# ------------------------------------------- plans through broken host rows -

#: case -> (staging, the hosts given a hole): a 30 MB object (15 chunks,
#: 3 trigger batches) that lands at such a host takes rows 2, 3, 5-17,
#: so its batch 0 breaks a run and batches 1-2 do not
BROKEN_ROWS = {
    "spill": (CUT_THROUGH, ("host",)),
    "h2h": (CUT_THROUGH, ("n0:host", "n1:host")),
    "g2g_host": (STORE_FORWARD, ("host",)),
    "internode": (STORE_FORWARD, ("n0:host", "n1:host")),
}
BROKEN_MB = 30.0


@pytest.mark.parametrize("case", sorted(BROKEN_ROWS))
def test_plan_through_broken_host_rows_matches_jax_backend(case):
    """A plan that lands in, or reads from, host rows that break a run,
    on both walks: cut-through lands a spill's window in broken rows and
    copies an h2h between broken rows; store-and-forward lands its
    intermediate copy in broken rows (through a temporary), copies an
    internode net hop between broken rows and uploads from them.  The
    bytes are the oracle's, the neighbours of the hole keep theirs, and
    the report and where the object ends up equal the JAX reference's
    under the same layout."""
    staging, hosts = BROKEN_ROWS[case]
    topo_fn, kind, src, dst, kw = MATRIX[case]
    did = f"broken-{case}"
    jb, tb = JaxBackend(), cpu_backend()
    for be in (jb, tb):
        for h in hosts:
            _hole(be, h)
    probe = tb.store_for(hosts[0])
    assert probe.alloc("probe", nbytes_of(BROKEN_MB)).rows[:3] == (2, 3, 5)
    probe.drop("probe")
    jrep = jb.execute(make_engine(topo_fn, staging=staging, **kw).compile(
        kind, "t", src, dst, BROKEN_MB, data_id=did))
    _, trep = run_plan(port_engine(PORT_TOPO[case], staging=staging, **kw),
                       tb, kind, src, dst, BROKEN_MB, did)
    for f in ("n_chunks", "n_batches", "stripes", "peak_staging_mb",
              "hop_trace"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert [mb for mb, _ in trep.events] == [mb for mb, _ in jrep.events]
    assert trep.n_batches == 3
    for ep in (dst, src):
        np.testing.assert_array_equal(tb.read_object(did, ep),
                                      oracle(did, BROKEN_MB))
    for h in hosts:
        for nb, mb in (("fa", 4.0), ("fc", 2.0)):
            np.testing.assert_array_equal(tb.read_object(nb, h),
                                          oracle(nb, mb))
    assert tb.where(did) == jb.where(did)
    assert all(r.in_flight_mb == 0.0 for r in tb.rings.values())


# ------------------------------------- the queue of an upload's batches -

class _WalkLog:
    """What a CPU walk launches and waits for, in order, with stand-in
    events (the CPU records none): ``("launch", dst_row)`` for a batch's
    upload and its scatter (the scatter reads the upload, so it is
    launched after it), ``("record", i)`` and ``("wait", i)`` for event
    ``i``, ``("stage",)`` for a batch's copy into the ring window (its
    ``ft:backend.stage`` range) and ``("landed", mb)`` for each progress
    event."""

    def __init__(self, monkeypatch):
        from types import SimpleNamespace

        from repro_torch.core import backend_torch
        from repro_torch.kernels.chunked_copy import pipeline
        self.log = []
        scatter, span = pipeline.scatter, backend_torch.span

        def record(t):
            i = sum(1 for x in self.log if x[0] == "record")
            self.log.append(("record", i))
            return SimpleNamespace(
                synchronize=lambda: self.log.append(("wait", i)))

        def launch(dst, src, idx):
            self.log.append(("launch", int(np.asarray(idx)[0])))
            return scatter(dst, src, idx)

        def stage(name):
            if name == "ft:backend.stage":
                self.log.append(("stage",))
            return span(name)

        for mod in (backend_torch, pipeline):
            monkeypatch.setattr(mod, "record", record)
        monkeypatch.setattr(pipeline, "scatter", launch)
        monkeypatch.setattr(backend_torch, "span", stage)

    def landed(self, mb):
        self.log.append(("landed", mb))


def _host_walk(monkeypatch, layout, size_mb, did="w", on_progress=None):
    """A CPU backend whose host store holds ``layout``'s objects
    (``("put" | "drop", id, mb)`` in order), then ``did``'s ``size_mb``;
    one cut-through host -> gpu1 walk of ``did`` under a
    :class:`_WalkLog`.  Returns the backend, the log, the report (None
    if the walk raised) and the exception it raised."""
    be = _host_backend("host", 64.0)
    for op, oid, mb in layout:
        if op == "put":
            be.put_object(oid, "host", size_mb=mb)
        else:
            be.drop_object(oid, "host")
    be.put_object(did, "host", size_mb=size_mb)
    log = _WalkLog(monkeypatch)

    def progress(mb):
        log.landed(mb)
        if on_progress is not None:
            on_progress(mb)
    plan = port_engine(staging=CUT_THROUGH).compile(
        "h2g", "t", "host", "gpu1", size_mb, data_id=did)
    try:
        return be, log, be.execute(plan, on_progress=progress), None
    except RuntimeError as err:
        return be, log, None, err


# 24 MB of rows 0-11 freed below one of 2 MB at row 12: a 40 MB object
# lands on rows 0-11, 13-20, so batches 0-1 are one run, batch 2 breaks
# (10, 11, 13, 14, 15) and batch 3 is a run again
BROKEN_AFTER_TWO = (("put", "a", 24.0), ("put", "b", 2.0), ("drop", "a", 0))


def test_page_locked_upload_queues_the_next_batch_before_each_wait(
        monkeypatch):
    """A host walk whose batches 0-1 are one run, batch 2 breaks
    it and batch 3 is a run: within the run batch 1's upload is launched
    before the wait on batch 0, every batch is marked landed after its
    wait, a direct batch is waited for exactly once, and the staged
    batch 2 copies into the ring only once every event recorded before
    it has been waited for; the bytes and the report equal the
    reference's."""
    be, log, rep, err = _host_walk(monkeypatch, BROKEN_AFTER_TWO, 40.0)
    assert err is None
    walk = list(log.log)
    assert be.store_for("host").objects["w"].rows == \
        (*range(12), *range(13, 21))
    np.testing.assert_array_equal(be.read_object("w", "gpu1"),
                                  oracle("w", 40.0))
    jrep = JaxBackend().execute(make_engine().compile(
        "h2g", "t", "host", "gpu1", 40.0, data_id="w"))
    for f in ("n_chunks", "n_batches", "stripes", "peak_staging_mb",
              "hop_trace"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert [mb for mb, _ in rep.events] == [mb for mb, _ in jrep.events]
    assert (rep.n_batches, rep.direct_batches, rep.overlapped_batches) == \
        (4, 3, 1)
    dst_rows = be.store_for("gpu1").objects["w"].rows
    launch, event, k = {}, {}, None    # batch -> its launch, first event
    for j, x in enumerate(walk):
        if x[0] == "launch":
            k = dst_rows.index(x[1]) // 5
            launch[k] = j
        elif x[0] == "record" and k is not None and k not in event:
            event[k] = x[1]        # recorded after batch k's scatter
    waited = {k: walk.index(("wait", i)) for k, i in event.items()}
    lands = [j for j, x in enumerate(walk) if x[0] == "landed"]
    assert [walk[j][1] for j in lands] == [10.0, 20.0, 30.0, 40.0]
    assert sorted(launch) == sorted(event) == [0, 1, 2, 3]
    assert all(waited[k] < lands[k] for k in range(4))
    # within the run: batch 1 is launched before the wait on batch 0
    assert launch[1] < waited[0] < lands[0] < waited[1] < lands[1]
    # one wait a direct batch; the staged one is also waited at its
    # boundary
    n_waits = {k: sum(1 for x in walk[launch[k]:]
                      if x[0] == "wait" and x[1] >= event[k]
                      and (k == 3 or x[1] < event[k + 1]))
               for k in range(4)}
    assert n_waits == {0: 1, 1: 1, 2: 2, 3: 1}
    # the staged batch: every event recorded before its ring copy has
    # been waited for, and the run was marked landed
    stage = walk.index(("stage",))
    assert walk.count(("stage",)) == 1
    before = [x[1] for x in walk[:stage] if x[0] == "record"]
    assert before and all(("wait", i) in walk[:stage] for i in before)
    assert lands[1] < stage < launch[2] < lands[2] < launch[3]


@pytest.mark.parametrize("fails_at", [10.0, 20.0, 23.0])
def test_page_locked_upload_drains_its_queue_when_the_walk_raises(
        monkeypatch, fails_at):
    """A progress callback that raises when batch 0 or 1 is marked
    landed, with the next batch queued behind it, or when the last one
    is: before the exception leaves ``execute`` the host has waited for
    an event recorded after the last launch (so no queued upload still
    reads the store), and the ring window is released."""
    def boom(mb):
        if mb == fails_at:
            raise RuntimeError("progress callback failed")

    be, log, rep, err = _host_walk(monkeypatch, (), 23.0,
                                     on_progress=boom)
    assert rep is None and "progress callback" in str(err)
    walk = log.log
    launches = [j for j, x in enumerate(walk) if x[0] == "launch"]
    assert len(launches) == (2 if fails_at == 10.0 else 3)
    last_wait = max(j for j, x in enumerate(walk) if x[0] == "wait")
    assert walk.index(("record", walk[last_wait][1])) > launches[-1]
    assert be.rings["host"].in_flight_mb == 0.0
