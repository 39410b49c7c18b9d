"""Parity of the port's telemetry plane with the JAX package's, on the CPU:

* the registry against the JAX ``MetricsRegistry`` on one seeded
  observation stream (equal ``snapshot()``, the same type-flip errors,
  the same log2 buckets), and ``prometheus_text`` byte-equal with and
  without ``name_prefixes``;
* the publisher: the heat, stability, capacity, convergence and lag
  trackers fed the same observations on both sides (injected clocks),
  the JAX tracker into a private registry, the port's published into
  one: equal names and values (floats of the EWMA rates at rtol 1e-12);
* every name and kind the publisher can emit is a row of the JAX
  package's metric manifest, and the manifest rows it does not publish
  are pinned as a set;
* the exporter: all seven routes of a node's server, the 404, a 500 on a
  render fault, ``/heat?plan=`` equal to the JAX ``plan_report`` on the
  same heat, ``/healthz`` equal to the node's ``ServeLoop.counts()``;
* ``regrow_timeline`` after a forced executor regrow equal to the JAX
  timeline's fields, and a CPU ``tracing.profile`` writing its trace.

Every exporter binds 127.0.0.1:0 and every request has a deadline."""

import json
import itertools
import math
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from crdt_tpu.batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.config import enable_x64
from crdt_tpu.obs import capacity as jcapacity
from crdt_tpu.obs import convergence as jconvergence
from crdt_tpu.obs import export as jexport
from crdt_tpu.obs import heat as jheat
from crdt_tpu.obs import latency as jlatency
from crdt_tpu.obs import metrics as jmetrics
from crdt_tpu.obs import namespace
from crdt_tpu.obs import stability as jstability
from crdt_tpu.parallel import JoinExecutor as JaxJoinExecutor
from crdt_tpu.scalar.orswot import Add, Orswot
from crdt_tpu.scalar.vclock import Dot
from crdt_tpu.utils import tracing as jtracing
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CrdtConfig, GCounterBatch, JoinExecutor, OrswotBatch, ReadRequest, Universe,
)
from crdt_tpu_torch.cluster import gossip
from crdt_tpu_torch.obs import capacity, convergence, export, heat, latency
from crdt_tpu_torch.obs import metrics, publish, stability
from crdt_tpu_torch.obs.fleet import FleetObservatory
from crdt_tpu_torch.utils import tracing

torch.set_num_threads(1)
enable_x64()  # the JAX heat sketch's ids are int64 under x64

DEADLINE_S = 10.0


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# -- the registry and the text exposition ------------------------------------------------------


def _stream(seed, n=300):
    rng = np.random.RandomState(seed)
    names = [f"sync.peer.p{i}.divergence" for i in range(3)] + ["cluster.rounds", "serve.reads",
                                                                "cluster.round", "x.y-z/w"]
    vals = [0.0, -1.0, 1.0, 4.0, 0.3, 1e-9, 2.5e6, 7, 1024, float("inf")]
    for _ in range(n):
        op = rng.choice(["counter_inc", "gauge_set", "observe", "aggregate"])
        yield op, names[rng.randint(len(names))], vals[rng.randint(len(vals))], int(rng.randint(9))


def _feed(reg, stream):
    errors = []
    for op, name, v, k in stream:
        try:
            if op == "counter_inc":
                reg.counter_inc(name, k)
            elif op == "gauge_set":
                reg.gauge_set(name, v)
            elif op == "observe":
                reg.observe(name, v if math.isfinite(v) else 3.0)
            else:
                reg.observe_aggregate(name, {metrics.log2_bucket(0.5 * k): k}, k, 0.5 * k * k,
                                      0.5 * k, 0.5 * k)
        except ValueError as e:
            errors.append(str(e))
    return errors


def test_registry_matches_jax_on_one_stream():
    mine, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    assert _feed(mine, _stream(3)) == _feed(theirs, _stream(3))
    assert mine.snapshot() == theirs.snapshot()
    assert mine.counters_snapshot() == theirs.counters_snapshot()
    for v in (0.0, -2.0, 1e-320, 0.25, 0.3, 1.0, 4.0, 5.0, 2.0 ** 60, 7.5e300):
        assert metrics.log2_bucket(v) == jmetrics.log2_bucket(v), v
    h, jh = metrics.Histogram("h"), jmetrics.Histogram("h")
    for v in (0.0, 0.5, 3.0, 4.0, 4.5, 1e6):
        h.observe(v)
        jh.observe(v)
    assert list(h.cumulative()) == list(jh.cumulative())
    mine.reset()
    assert mine.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_concurrent_refreshes_never_move_a_counter_back():
    # each refresh reads a rising count, loses the CPU, then publishes it:
    # a refresh that read earlier must not write over a later one's value
    reg, rising = metrics.MetricsRegistry(), itertools.count(1)

    def source(r):
        v = next(rising)
        time.sleep(0.0005)
        r.put("counter", "rising", v)

    reg.add_source(source)
    stop = threading.Event()

    def refresher():
        while not stop.is_set():
            reg.refresh()

    threads = [threading.Thread(target=refresher, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    seen, deadline = [], time.monotonic() + 0.5
    while time.monotonic() < deadline:
        seen.append(reg.counters_snapshot().get("rising", 0))
        time.sleep(0.0001)
    stop.set()
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive()
    assert len(set(seen)) > 10
    back = [(a, b) for a, b in zip(seen, seen[1:]) if b < a]
    assert not back, back[:5]


@pytest.mark.parametrize("prefixes", [None, ("cluster.",), ("sync.peer.", "x.")])
def test_prometheus_text_is_byte_equal(prefixes):
    mine, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _feed(mine, _stream(5))
    _feed(theirs, _stream(5))
    assert export.prometheus_text(mine, name_prefixes=prefixes) == \
        jexport.prometheus_text(theirs, name_prefixes=prefixes)


def test_naming_helpers_match_the_manifest():
    for name in ("wire.sync.delta.bytes", "sync.peer.a-1.staleness_s", "a b/c"):
        for kind in namespace.KINDS:
            assert metrics.prometheus_name(name, kind) == namespace.prometheus_name(name, kind)
    assert metrics.PROM_PREFIX == namespace.PROM_PREFIX


# -- the publisher against the JAX trackers -----------------------------------------------------


def _published(fn, *args):
    reg = metrics.MetricsRegistry()
    fn(reg, *args)
    return reg.snapshot()


def _same_contents(got, want, float_rtol=None):
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(got[kind]) == sorted(want[kind]), kind
    assert got["counters"] == want["counters"]
    assert got["histograms"] == want["histograms"]
    for name, v in want["gauges"].items():
        if float_rtol is None:
            assert got["gauges"][name] == v, name
        else:
            np.testing.assert_allclose(got["gauges"][name], v, rtol=float_rtol, err_msg=name)


def test_heat_publisher_matches_jax():
    jclock, pclock = _Clock(), _Clock()
    jreg = jmetrics.MetricsRegistry()
    jt = jheat.HeatTracker(capacity=16, halflife_s=5.0, registry=jreg, clock=jclock)
    pt = heat.HeatTracker(capacity=16, halflife_s=5.0, clock=pclock, device="cpu")
    rng = np.random.RandomState(4)
    n = 3000
    for step in range(24):
        ids = np.minimum(rng.zipf(1.3, rng.randint(1, 200)) - 1, n - 1)
        for trk in (jt, pt):
            (trk.record_writes(ids, n) if step % 3 == 1 else trk.record_repair(ids, n)
             if step % 3 == 2 else trk.record_reads(ids, n, mode=("eventual", "ryw")[step % 2]))
        if step % 5 == 4:
            jclock.t += 2.0 + step
            pclock.t = jclock.t
            jt.publish()
            pt.publish()
            _same_contents(_published(publish.publish_heat, pt), jreg.snapshot(),
                           float_rtol=1e-12)
    assert any(k.startswith("heat.hot.") for k in jreg.snapshot()["gauges"])


def _stability_pair():
    jclock, pclock = _Clock(), _Clock()
    jreg = jmetrics.MetricsRegistry()
    jt = jstability.StabilityTracker(
        registry=jreg, tracker=jconvergence.ConvergenceTracker(registry=jmetrics.MetricsRegistry()),
        clock=jclock, stale_after_s=10.0, quarantine_s=50.0)
    pt = stability.StabilityTracker(tracker=convergence.ConvergenceTracker(), clock=pclock,
                                    stale_after_s=10.0, quarantine_s=50.0)
    return jt, pt, jreg, jclock, pclock


def test_stability_publisher_matches_jax():
    from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
    import jax.numpy as jnp

    jt, pt, jreg, jc, pc = _stability_pair()
    n = 300
    rng = np.random.RandomState(8)
    clocks = [rng.randint(0, 90, (n, 8)).astype(np.uint32) for _ in range(3)]
    fleets = [(JaxGCounterBatch(clocks=jnp.asarray(c)), GCounterBatch.from_numpy(c, device="cpu"))
              for c in clocks]
    before = jtracing.counters()

    def both(fn):
        fn(jt, 0)
        fn(pt, 1)

    def step(dt):
        jc.t += dt
        pc.t = jc.t

    both(lambda t, i: t.observe_descent("a", [3, 17, 18, 250], n))
    step(2.0)
    both(lambda t, i: t.observe_descent("a", [17, 299], n))
    both(lambda t, i: t.observe_descent("b", np.array([5, 6]), n, at=jc.t - 1))
    step(1.5)
    for peer, k in (("a", 1), ("b", 2)):
        both(lambda t, i, peer=peer, k=k: t.observe_converged(peer, fleets[k][i]))
        step(3.0)
    jt.frontier(fleets[0][0], peers=["a", "b", "z"])
    pt.frontier(fleets[0][1], peers=["a", "b", "z"])
    step(12.0)
    jt.frontier(fleets[0][0])
    pt.frontier(fleets[0][1])
    got = _published(publish.publish_stability, pt)
    resolved = jtracing.counters_since(before).get("sync.stability.resolved", 0)
    assert got["counters"].pop("sync.stability.resolved") == resolved > 0
    _same_contents(got, jreg.snapshot())
    assert any(k.startswith("stability.frontier.subtree.") for k in got["gauges"])


def test_capacity_publisher_matches_jax():
    t = [100.0]
    jreg = jmetrics.MetricsRegistry()
    jt = jcapacity.CapacityTracker(jreg, clock=lambda: t[0], max_capacity=64)
    pt = capacity.CapacityTracker(clock=lambda: t[0], max_capacity=64)
    for step, (live, cap) in enumerate([(3, 16), (7, 16), (12, 16), (12, 32), (20, 32), (15, 32)]):
        for trk, occ_cls in ((jt, jcapacity.Occupancy), (pt, capacity.Occupancy)):
            occ = occ_cls(kind="orswot", objects=10, bytes=1000 * cap, slot_capacity=cap,
                          slots=10 * cap, live=live * 5, live_max=live, tombstones=step)
            trk.observe(occ)
            trk.observe(occ_cls(kind="oplog", objects=1, bytes=64 * live, slot_capacity=100,
                                slots=100, live=live, live_max=live), ceiling=100)
        t[0] += 1.5
        _same_contents(_published(publish.publish_capacity, pt), jreg.snapshot())


def test_convergence_publisher_matches_jax(monkeypatch):
    now = [5000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    jreg = jmetrics.MetricsRegistry()
    jt, pt = jconvergence.ConvergenceTracker(registry=jreg), convergence.ConvergenceTracker()
    for trk in (jt, pt):
        trk.register_peer("a")
        trk.register_peer("b")
        trk.observe_divergence("b", 12, 300)
        trk.observe_divergence("c", 0, 0)
        trk.observe_session("b", converged=True, rounds=2, payload_bytes=10, full_state_bytes=400)
        trk.observe_session("c", converged=False, rounds=1)
        trk.observe_tree("b", 3)
    now[0] += 7.25
    jt.refresh()
    _same_contents(_published(publish.publish_convergence, pt), jreg.snapshot())


def test_lag_publisher_matches_jax(monkeypatch):
    now = [10**12]
    monkeypatch.setattr(time, "monotonic_ns", lambda: now[0])
    jreg = jmetrics.MetricsRegistry()
    jt = jlatency.LagTracker(registry=jreg, proc_tag="aa11bb")
    pt = latency.LagTracker(proc_tag="aa11bb")
    before = jtracing.counters()
    entries = [(1, 5, now[0] - 3_000_000), (1, 6, now[0] - 2_000_000), (2, 9, now[0] - 10**9)]
    for trk in (jt, pt):
        trk.ingest_sidecar("p", entries, "aa11bb")
        trk.ingest_sidecar("q", entries[:1], "cc22dd")
        trk.observe_visibility({1: 6, 2: 3})
        trk.observe_round(True, 0.5)
        trk.observe_round(False, 0.5)
    now[0] += 250_000_000
    jt.refresh()
    got = _published(publish.publish_lag, pt)
    deltas = jtracing.counters_since(before)
    assert got["counters"].pop("sync.lag.samples") == deltas["sync.lag.samples"] == 2
    assert got["counters"].pop("sync.lag.fallback.clock_domain") == \
        deltas["sync.lag.fallback.clock_domain"] == 1
    _same_contents(got, jreg.snapshot())


#: the manifest's rows the port does not publish: the JAX package's jit
#: and XLA telemetry, tracer spans, the wire codecs' per-blob counts, GC,
#: the op log, recovery, the session profile and the fault injectors
#: (their counts stay report fields and plain counts)
UNPUBLISHED = {
    ("wire.*.*.native", "counter"), ("wire.*.*.fallback", "counter"),
    ("wire.*.*.fallback_reason.*", "counter"), ("wire.sync.*.bytes", "counter"),
    ("wire.sync.*.objects", "counter"), ("wire.sync.*.frame_bytes", "histogram"),
    ("sync.frame.*.decoded", "counter"), ("sync.digest_exchange", "histogram"),
    ("sync.digest.cache.*", "counter"), ("sync.tree.exchange", "histogram"),
    ("sync.delta_exchange", "histogram"), ("sync.full_state_exchange", "histogram"),
    ("stability.audit", "histogram"), ("sync.peer.*.network_wait_frac", "gauge"),
    ("sync.peer.*.unaccounted_frac", "gauge"), ("sync.profile.*", "histogram"),
    ("cluster.peer_transition.*", "counter"), ("cluster.faults.*", "counter"),
    ("oplog.submitted", "counter"), ("oplog.pending", "gauge"), ("oplog.parked", "gauge"),
    ("oplog.log_depth", "gauge"), ("oplog.watermark", "gauge"), ("oplog.apply.*", "counter"),
    ("oplog.apply_ops", "histogram"), ("oplog.exchange", "histogram"),
    ("oplog.frames.decoded", "counter"), ("wire.oplog.*.ops", "counter"),
    ("wire.oplog.*.bytes", "counter"), ("obs.fleet.exchange", "histogram"),
    ("gc.runs", "counter"), ("gc.shrinks", "counter"), ("gc.reclaimed_bytes", "counter"),
    ("gc.tombstones_cleared", "counter"), ("gc.oplog_ops_dropped", "counter"),
    ("gc.collect", "histogram"), ("gc.watermark.*", "gauge"),
    ("durable.replay.frames", "gauge"), ("durable.replay.ops", "gauge"),
    ("durable.recovery.wall_s", "gauge"), ("durable.checkpoint", "histogram"),
    ("durable.recover", "histogram"), ("native.engine.*.calls", "counter"),
    ("native.engine.*.objects", "counter"), ("serve.batch_depth", "gauge"),
    ("serve.frames.decoded", "counter"), ("wire.serve.*.ops", "counter"),
    ("wire.serve.*.bytes", "counter"), ("wireloop.stalls", "counter"),
    ("wireloop.staging_free", "gauge"), ("wireloop.parsed_depth", "gauge"),
    ("executor.recovery.*", "counter"), ("executor.join_all", "histogram"),
    ("executor.join_all_tree", "histogram"), ("executor.merge", "histogram"),
    ("executor.regrow", "histogram"), ("executor.shrink", "histogram"),
    ("kernel.*.errors", "counter"), ("kernel.*.compiles", "counter"),
    ("kernel.*.compile_budget_frac", "gauge"), ("kernel.*.cost_flops", "gauge"),
    ("kernel.*.cost_bytes", "gauge"), ("kernel.compiles", "counter"),
    ("kernel.budget.watermark", "gauge"), ("kernel.cost.unavailable", "counter"),
    ("devicemem.arrays", "gauge"), ("devicemem.dtype.*.bytes", "gauge"),
    ("obs.overhead.count_probe", "counter"), ("obs.overhead.gauge_probe", "gauge"),
}


def test_every_published_name_is_a_manifest_row():
    names = set(publish.names())
    for pattern, kind in names:
        assert namespace.match(pattern, kind) is not None, (pattern, kind)
    unpublished = {(s.pattern, s.kind) for s in namespace.NAMESPACE
                   if not any(k == s.kind and s.matches(p) for p, k in names)}
    assert unpublished == UNPUBLISHED


# -- the exporter ---------------------------------------------------------------------------------


def _get(server, path):
    url = f"http://127.0.0.1:{server.port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=DEADLINE_S) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Broken:
    def snapshot(self):
        raise RuntimeError("tracker fault")


def _node():
    kw = dict(num_actors=8, member_capacity=8, deferred_capacity=4, counter_bits=32)
    uni = Universe.identity(CrdtConfig(**kw))
    rng = np.random.RandomState(2)
    sets = []
    for obj in range(96):
        s = Orswot()
        for j in range(rng.randint(1, 4)):
            s.apply(Add(dot=Dot(int(rng.randint(0, 8)), j + 1), member=int(rng.randint(0, 40))))
        sets.append(s)
    batch = OrswotBatch.from_scalar(sets, uni, device="cpu")
    reg = metrics.MetricsRegistry()
    cap = capacity.CapacityTracker(device="cpu")
    node = gossip.ClusterNode("n0", batch, uni, registry=reg, capacity_tracker=cap,
                              observatory=FleetObservatory("n0", registry=reg),
                              heat_tracker=heat.HeatTracker(device="cpu", clock=_Clock()))
    return node, reg, cap


def _prom_families(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            out[name] = kind
        else:
            name, value = line.rsplit(" ", 1)
            float(value.replace("+Inf", "inf"))
            base = name.split("{")[0]
            assert base in out or any(base == f + sfx and out[f] == "histogram" for f in out
                                      for sfx in ("_bucket", "_sum", "_count")), line
    return out


def test_node_exporter_serves_every_route():
    node, reg, cap = _node()
    rng = np.random.RandomState(6)
    for mode in ("eventual", "eventual", "ryw", "monotonic"):
        node.serve_reads(ReadRequest.reads(rng.randint(0, 96, 50), mode=mode))
    node.sample_capacity()
    node.observe_stability(peers=[])
    node.heat.publish()
    server = export.start_metrics_server(port=0, registry=reg, tracker=convergence.tracker(),
                                         observatory=node.observatory, capacity=cap,
                                         stability=node.stability, heat=node.heat)
    try:
        status, text = _get(server, "/metrics")
        assert status == 200
        fams = _prom_families(text)
        table = {metrics.prometheus_name(p.replace("*", "x"), k) for p, k in publish.names()}
        assert fams and all(("_".join(n.split("_")[:3]) in {"_".join(t.split("_")[:3])
                                                               for t in table}) for n in fams)
        assert fams["crdt_tpu_serve_latency_eventual"] == "histogram"
        status, body = _get(server, "/healthz")
        counts = node.serve_loop().counts()
        serve = json.loads(body)["serve"]
        assert status == 200 and serve["reads"] == counts["reads"] == 200
        assert (serve["batches"], serve["admitted"]) == (4, sum(counts["admit"].values()))
        assert serve["latency"]["eventual"]["count"] == counts["latency_s"]["eventual"]["count"]
        status, body = _get(server, "/fleet?format=json")
        assert status == 200 and json.loads(body)["nodes"] == ["n0"]
        assert _get(server, "/fleet")[1].startswith("# TYPE crdt_tpu_fleet_nodes gauge\n")
        status, body = _get(server, "/fleet?trace=nothing")
        assert status == 200 and json.loads(body)["timeline"] == []
        status, body = _get(server, "/kernels?format=json")
        assert status == 200 and "orswot_merge" in json.loads(body)["kernels"]
        status, text = _get(server, "/kernels")
        assert status == 200 and "crdt_tpu_kernel_orswot_merge_calls_total" in text
        status, body = _get(server, "/stability")
        assert status == 200 and "frontier" in json.loads(body)
        status, text = _get(server, "/heat")
        assert status == 200 and "crdt_tpu_heat_updates_total 4" in text
        assert json.loads(_get(server, "/heat?format=json")[1])["updates"] == 4
        assert _get(server, "/heat?plan=bogus:1")[0] == 400
        status, body = _get(server, "/events?kind=obs")
        assert status == 200 and "events" in json.loads(body)
        status, text = _get(server, "/nope")
        assert status == 404 and text.startswith("not found (try /metrics")
        assert server.scrape_counts()["/heat"] == 3 and server.scraped("/metrics", "/healthz")
    finally:
        server.stop()
        server.stop()
    broken = export.start_metrics_server(port=0, registry=metrics.MetricsRegistry(),
                                         stability=_Broken())
    try:
        status, text = _get(broken, "/stability")
        assert status == 500 and "RuntimeError: tracker fault" in text
    finally:
        broken.stop()


def test_durable_node_publishes_its_counts(tmp_path):
    from crdt_tpu_torch.durable import Durability
    from crdt_tpu_torch.oplog import OpLog

    node, reg, _ = _node()
    durable = gossip.ClusterNode("n1", node.batch, node.universe, oplog=OpLog(node.universe),
                                 durability=Durability(tmp_path / "n1", fsync=False))
    durable.submit_writes(np.array([1, 5, 9], np.int64), np.array([300, 301, 302], np.int32),
                          actor=2)
    assert durable.checkpoint() is not None
    durable.submit_writes(np.array([4], np.int64), np.array([303], np.int32), actor=2)
    durable.registry.refresh()
    snap = durable.registry.snapshot()
    counts, view = durable.durability.counts(), durable.durability.snapshot()
    assert snap["counters"]["durable.snapshots"] == counts["snapshots"] == 1
    assert snap["counters"]["durable.wal.frames"] == counts["wal_frames"] == 2
    assert snap["gauges"]["durable.snapshot.generation"] == view["generation"] == 1
    assert snap["gauges"]["durable.wal.depth"] == view["wal_depth"] == 1
    for kind, table in (("counter", snap["counters"]), ("gauge", snap["gauges"]),
                        ("histogram", snap["histograms"])):
        for name in table:
            assert namespace.match(name, kind) is not None, (name, kind)


def test_heat_plan_route_equals_jax_plan_report():
    jt = jheat.HeatTracker(capacity=16, registry=jmetrics.MetricsRegistry(), clock=_Clock())
    pt = heat.HeatTracker(capacity=16, clock=_Clock(), device="cpu")
    rng = np.random.RandomState(12)
    for _ in range(6):
        ids = np.minimum(rng.zipf(1.2, 120) - 1, 4999)
        for trk in (jt, pt):
            trk.record_reads(ids, 5000)
            trk.record_writes(ids[:30], 5000)
    server = export.start_metrics_server(port=0, registry=metrics.MetricsRegistry(), heat=pt)
    try:
        for plan, granule in (("mesh:8", None), ("mesh:4", 16), ("ring:5,k=3", None)):
            q = f"/heat?plan={plan}" + (f"&granule={granule}" if granule else "")
            status, body = _get(server, q)
            assert status == 200
            assert json.loads(body)["report"] == json.loads(json.dumps(
                jt.plan_report(plan, granule=granule))), plan
    finally:
        server.stop()


# -- the executor's regrow timeline and the profiler --------------------------------------------


def test_regrow_timeline_matches_jax():
    fleets = []
    for f in range(4):
        row = []
        for obj in range(6):
            s = Orswot()
            for j in range(2):
                s.apply(Add(dot=Dot(f"w{f}", j + 1 + obj % 3), member=f"m{obj}-{f}-{j}"))
            row.append(s)
        fleets.append(row)
    kw = dict(num_actors=8, member_capacity=2, deferred_capacity=2, counter_bits=32)
    juni, puni = JaxUniverse(JaxConfig(**kw)), Universe(CrdtConfig(**kw))
    t0 = time.monotonic()
    JaxJoinExecutor(strategy="sequential", retry_backoff_s=0).join_all(
        [JaxOrswotBatch.from_scalar(f, juni) for f in fleets])
    JoinExecutor(strategy="sequential", retry_backoff_s=0).join_all(
        [OrswotBatch.from_scalar(f, puni, device="cpu") for f in fleets])
    want = [e for e in jcapacity.CapacityTracker(jmetrics.MetricsRegistry()).regrow_timeline()
            if e["mono_ts"] >= t0]
    got = [e for e in capacity.CapacityTracker().regrow_timeline() if e["mono_ts"] >= t0]
    fields = ("schedule", "member_capacity", "deferred_capacity")
    assert [{k: e[k] for k in fields} for e in got] == [{k: e[k] for k in fields} for e in want]
    assert [e["member_capacity"] for e in got] == [(2, 4), (4, 8)]


def test_profile_writes_a_trace(tmp_path):
    with tracing.profile(str(tmp_path / "prof")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with pytest.raises(ZeroDivisionError):
        with tracing.profile(str(tmp_path / "prof2")):
            1 / 0
