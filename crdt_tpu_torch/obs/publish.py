"""The publisher: the port's plain counts under the JAX package's metric
names, copied into a registry at read time.

The JAX package writes its registry at every event site; the port keeps
counts (``GossipScheduler.counts()``, ``ServeLoop.counts()``,
``session_counts()``, ``ResilientTransport.counts()``, the trackers'
state, ...) and :data:`TABLE` maps each of them to the name it replaced.
A source function (:func:`node_source`, :func:`scheduler_source`,
:func:`process_source`) reads the counts as they are now and sets them in
the registry with :meth:`~crdt_tpu_torch.obs.metrics.MetricsRegistry.put`:
counters and histograms as absolute values, gauges as levels.  Nothing
is written at an event site, and the names are data here, never the
literal argument of a registry call.

Every name :data:`TABLE` can produce matches a row of the JAX package's
metric manifest of the same kind (the port's tests hold it there).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable

from .metrics import Histogram

C, G, H = "counter", "gauge", "histogram"

#: source key -> (JAX metric name, ``{}`` for each dynamic segment; kind)
TABLE: Dict[str, tuple] = {
    # GossipScheduler.counts(), its round walls and RoundReport.health
    "sched.rounds": ("cluster.rounds", C),
    "sched.sessions_ok": ("cluster.sessions.ok", C),
    "sched.sessions_failed": ("cluster.sessions.failed", C),
    "sched.sessions_skipped_busy": ("cluster.sessions.skipped_busy", C),
    "sched.round": ("cluster.round", H),
    "health": ("cluster.gossip.{}", G),
    # Membership.counts() and snapshot()
    "members.state_count": ("cluster.peers.{}", G),
    "member.state": ("cluster.peer.{}.state", G),
    "member.consecutive_failures": ("cluster.peer.{}.consecutive_failures", G),
    # ResilientTransport.counts(), summed over the node's links, and rtt
    "link.retransmits": ("cluster.transport.retransmits", C),
    "link.duplicates": ("cluster.transport.duplicates", C),
    "link.corrupt": ("cluster.transport.corrupt", C),
    "link.transient_errors": ("cluster.transport.transient_errors", C),
    "link.sacks_sent": ("cluster.transport.window.sacks", C),
    "link.frames_sacked": ("cluster.transport.window.sacked", C),
    "link.ooo_buffered": ("cluster.transport.window.ooo", C),
    "link.timeouts": ("cluster.transport.timeouts", C),
    "link.window_fallbacks": ("cluster.transport.fallback.window", C),
    "link.window_hw": ("cluster.transport.{}.window_inflight_hw", G),
    "link.srtt_s": ("cluster.transport.{}.rtt_srtt_s", G),
    "link.rttvar_s": ("cluster.transport.{}.rtt_rttvar_s", G),
    "link.rto_s": ("cluster.transport.{}.rtt_rto_s", G),
    "link.samples": ("cluster.transport.{}.rtt_samples", G),
    # session_counts() and the frame codecs' rejected_counts()
    "session.sessions": ("sync.sessions", C),
    "session.errors": ("sync.errors", C),
    "session.digest_eager": ("sync.digest.eager", C),
    "session.digest_collision": ("sync.digest_collision", C),
    "session.tree_descents": ("sync.tree.descents", C),
    "session.tree_fallback_version": ("sync.tree.fallback.version", C),
    "session.tree_fallback_capability": ("sync.tree.fallback.capability", C),
    "session.tree_fallback_cutover": ("sync.tree.cutover", C),
    "session.tree_fallback_collision": ("sync.tree.collision", C),
    "session.spec_blasts": ("sync.tree.spec_blasts", C),
    "session.spec_hits": ("sync.tree.speculate.hit", C),
    "session.spec_misses": ("sync.tree.speculate.miss", C),
    "session.delta_chunked": ("sync.delta.chunked_exchanges", C),
    "session.lag_fallback_capability": ("sync.lag.fallback.capability", C),
    "session.full_state_fallback": ("sync.full_state_fallback", C),
    "session.full_state_fallback_by": ("sync.full_state_fallback.{}", C),
    "sync_frames.rejected": ("sync.frame.rejected.{}", C),
    "op_frames.rejected": ("oplog.frames.rejected.{}", C),
    "read_frames.rejected": ("serve.frames.rejected.{}", C),
    # ServeLoop.counts()
    "serve.reads": ("serve.reads", C),
    "serve.batches": ("serve.batches", C),
    "serve.admit": ("serve.admit.{}", C),
    "serve.park": ("serve.park.{}", C),
    "serve.reject": ("serve.reject.{}", C),
    "serve.stalls": ("serve.stalls", C),
    "serve.not_stable_rows": ("serve.not_stable_rows", C),
    "serve.latency": ("serve.latency.{}", H),
    "serve.read_latency": ("serve.read_latency", H),
    "serve.park_wait": ("serve.park_wait", H),
    "serve.park_wait_s": ("serve.park_wait_s", H),
    "serve.reads_per_s": ("serve.reads_per_s", G),
    # Durability.counts()/snapshot(), snapshot_counts()
    "durable.snapshots": ("durable.snapshots", C),
    "durable.wal_frames": ("durable.wal.frames", C),
    "durable.wal_bytes": ("durable.wal.bytes", C),
    "durable.wal_segments_dropped": ("durable.wal.segments_dropped", C),
    "durable.wal_torn": ("durable.wal.torn", C),
    "durable.snapshot_rejected": ("durable.snapshot.rejected.{}", C),
    "durable.snapshot_fallbacks": ("durable.snapshot.fallbacks", C),
    "durable.snapshot_decoded": ("durable.snapshot.decoded", C),
    "durable.generation": ("durable.snapshot.generation", G),
    "durable.bytes": ("durable.snapshot.bytes", G),
    "durable.age_s": ("durable.snapshot.age_s", G),
    "durable.wal_depth": ("durable.wal.depth", G),
    "durable.wal_pending_bytes": ("durable.wal.pending_bytes", G),
    # the heat tracker
    "heat.subtree_reads": ("heat.subtree.{}.reads", C),
    "heat.subtree_writes": ("heat.subtree.{}.writes", C),
    "heat.subtree_repair": ("heat.subtree.{}.repair", C),
    "heat.reads": ("heat.reads.{}", C),
    "heat.updates": ("heat.updates", C),
    "heat.reads_per_s": ("heat.subtree.{}.reads_per_s", G),
    "heat.writes_per_s": ("heat.subtree.{}.writes_per_s", G),
    "heat.repair_per_s": ("heat.subtree.{}.repair_per_s", G),
    "heat.hot_obj": ("heat.hot.{}.obj", G),
    "heat.hot_count": ("heat.hot.{}.count", G),
    "heat.s_hat": ("heat.zipf.s_hat", G),
    "heat.fit_r2": ("heat.zipf.fit_r2", G),
    # the stability tracker
    "stab.age": ("sync.stability.divergence_age_s", H),
    "stab.resolved": ("sync.stability.resolved", C),
    "stab.outstanding": ("sync.stability.outstanding", G),
    "stab.peer_age": ("sync.peer.{}.divergence_age_s", G),
    "stab.age_p50": ("sync.stability.divergence_age_p50_s", G),
    "stab.age_max": ("sync.stability.divergence_age_max_s", G),
    "stab.frontier": ("stability.frontier.{}", G),
    "stab.subtree_max": ("stability.frontier.subtree.{}.max_counter", G),
    "stab.checks": ("stability.audit.checks", C),
    "stab.violations": ("stability.audit.violations", C),
    # the convergence tracker, per peer
    "conv.staleness_s": ("sync.peer.{}.staleness_s", G),
    "conv.divergence": ("sync.peer.{}.divergence", G),
    "conv.divergence_frac": ("sync.peer.{}.divergence_frac", G),
    "conv.rounds_to_converge": ("sync.peer.{}.rounds_to_converge", G),
    "conv.delta_ratio": ("sync.peer.{}.delta_ratio", G),
    "conv.diverged_subtrees": ("sync.peer.{}.diverged_subtrees", G),
    # the lag tracker
    "lag.p50_s": ("sync.peer.{}.lag_p50_s", G),
    "lag.p99_s": ("sync.peer.{}.lag_p99_s", G),
    "lag.outstanding": ("sync.peer.{}.lag_outstanding", G),
    "lag.current_s": ("sync.peer.{}.lag_current_s", G),
    "lag.samples": ("sync.lag.samples", C),
    "lag.foreign": ("sync.lag.fallback.clock_domain", C),
    "lag.slo": ("sync.slo.converged_frac", G),
    # the capacity tracker and its device-memory samples
    "cap.samples": ("capacity.samples", C),
    "cap.watermark": ("capacity.watermark", G),
    "cap.plane": ("capacity.{}.{}", G),
    "mem.samples": ("devicemem.samples", C),
    "mem.live_bytes": ("devicemem.live_bytes", G),
    "mem.tracked_bytes": ("devicemem.tracked_bytes", G),
    "mem.tracked_frac": ("devicemem.tracked_frac", G),
    # the kernel observatory (process-wide)
    "kernel.calls": ("kernel.{}.calls", C),
    "kernel.bytes": ("kernel.{}.bytes", C),
    "kernel.wall": ("kernel.{}.wall", H),
    "kernel.gbps": ("kernel.{}.gbps", G),
    # the fleet observatory and the flight recorder
    "fleet.merges": ("obs.fleet.merges", C),
    "fleet.nodes": ("obs.fleet.nodes", G),
    "fleet.decoded": ("obs.fleet.frames.decoded", C),
    "fleet.rejected": ("obs.fleet.frames.rejected.{}", C),
    "fleet.snapshot_bytes": ("obs.fleet.snapshot_bytes", H),
    "events.dropped": ("obs.events.dropped", G),
    "profiler.unavailable": ("obs.profiler_unavailable", C),
    # the mesh layer: ShardedBatch.publish_gauges and mesh_counts()
    "mesh.shards": ("mesh.layout.shards", G),
    "mesh.granule": ("mesh.layout.granule", G),
    "mesh.imbalance": ("mesh.layout.imbalance", G),
    "mesh.objects": ("mesh.shard.{}.objects", G),
    "mesh.load": ("mesh.shard.{}.load", G),
    "mesh.step_rounds": ("mesh.step.rounds", C),
    "mesh.step_digest_bytes": ("mesh.step.digest_bytes", C),
    "mesh.sync_rounds": ("mesh.sync.rounds", C),
    "mesh.sync_shards_synced": ("mesh.sync.shards_synced", C),
    "mesh.sync_shards_skipped": ("mesh.sync.shards_skipped", C),
    "mesh.sync_objects": ("mesh.sync.objects", C),
    "mesh.sync_delta_bytes": ("mesh.sync.delta_bytes", C),
    "mesh.durable_snapshots": ("mesh.durable.snapshots", C),
    "mesh.durable_restores": ("mesh.durable.restores", C),
    "mesh.durable_rejected": ("mesh.durable.rejected.{}", C),
    "mesh.contract_refused": ("mesh.contract.refused", C),
}

#: the capacity plane fields published per label (``capacity.<label>.<field>``)
CAPACITY_FIELDS = ("bytes", "objects", "slots", "live", "live_max", "tombstones",
                   "utilization", "growth_rows_per_s", "eta_s", "watermark")
#: the frontier report fields published as ``stability.frontier.<field>``
FRONTIER_FIELDS = ("peers", "stale", "unheard", "excluded", "subtrees", "age_s",
                   "max_counter", "lag")
#: RoundReport.health keys published as ``cluster.gossip.<key>``
HEALTH_FIELDS = ("attempted", "ok", "failed", "skipped_busy", "fleet_divergence_max",
                 "eta_rounds")


def names() -> Iterable[tuple]:
    """Every ``(pattern, kind)`` the table can publish, ``*`` for each
    dynamic segment (the capacity plane's field expanded)."""
    for key, (template, kind) in TABLE.items():
        if key == "cap.plane":
            for field in CAPACITY_FIELDS:
                yield f"capacity.*.{field}", kind
        elif key == "stab.frontier":
            for field in FRONTIER_FIELDS:
                yield f"stability.frontier.{field}", kind
        elif key == "health":
            for field in HEALTH_FIELDS:
                yield f"cluster.gossip.{field}", kind
        else:
            yield template.replace("{}", "*"), kind


def put(reg, key: str, value, *segments) -> None:
    """Set the metric of ``key`` (its dynamic segments filled in order)."""
    template, kind = TABLE[key]
    reg.put(kind, template.format(*segments), value)


def _each(reg, key: str, counts: dict) -> None:
    for seg, v in counts.items():
        put(reg, key, v, seg)


# -- one source per part ----------------------------------------------------------------


def publish_kernels(reg, rows: dict) -> None:
    """The kernel observatory's rows (``KernelObservatory._rows()``)."""
    for name, row in rows.items():
        put(reg, "kernel.calls", row["launches"], name)
        put(reg, "kernel.bytes", row["bytes"], name)
        if row["wall"].count:
            put(reg, "kernel.wall", row["wall"], name)
        if row["gbps"] is not None:
            put(reg, "kernel.gbps", row["gbps"], name)


def publish_devicemem(reg, sample: dict, samples: int) -> None:
    """The newest device-memory sample (:func:`~crdt_tpu_torch.obs.kernels.
    sample_device_memory`) and the count of samples taken."""
    put(reg, "mem.samples", samples)
    put(reg, "mem.live_bytes", sample["allocated_bytes"])
    if "tracked_bytes" in sample:
        put(reg, "mem.tracked_bytes", sample["tracked_bytes"])
        put(reg, "mem.tracked_frac", sample["tracked_frac"])


def publish_sessions(reg) -> None:
    """The process's session counts and frame rejections."""
    from ..oplog import wire as op_wire
    from ..serve import wire as serve_wire
    from ..sync import delta as sync_delta
    from ..sync.session import session_counts

    fallbacks = 0
    for k, v in session_counts().items():
        if k.startswith("full_state_fallback_"):
            put(reg, "session.full_state_fallback_by", v, k[len("full_state_fallback_"):])
            fallbacks += v
        else:
            put(reg, "session." + k, v)
    if fallbacks:
        put(reg, "session.full_state_fallback", fallbacks)
    _each(reg, "sync_frames.rejected", sync_delta.rejected_counts())
    _each(reg, "op_frames.rejected", op_wire.rejected_counts())
    _each(reg, "read_frames.rejected", serve_wire.rejected_counts())


def publish_serve(reg, counts: dict) -> None:
    """One :meth:`~crdt_tpu_torch.serve.loop.ServeLoop.counts`."""
    put(reg, "serve.reads", counts["reads"])
    put(reg, "serve.batches", counts["batches"])
    for what in ("admit", "park", "reject"):
        _each(reg, "serve." + what, counts[what])
    put(reg, "serve.stalls", counts["stalls"])
    put(reg, "serve.not_stable_rows", counts["not_stable_rows"])
    total = Histogram()
    for mode, lat in counts["latency_s"].items():
        put(reg, "serve.latency", lat["hist"], mode)
        total.merge(lat["hist"])
    if total.count:
        put(reg, "serve.read_latency", total)
    if counts["park_hist"].count:
        put(reg, "serve.park_wait", counts["park_hist"])
        put(reg, "serve.park_wait_s", counts["park_hist"])
    if counts["reads_per_s"] is not None:
        put(reg, "serve.reads_per_s", counts["reads_per_s"])


def publish_durability(reg, durability) -> None:
    """A :class:`~crdt_tpu_torch.durable.Durability`'s counts and view."""
    from ..durable.snapshot import snapshot_counts

    c = durability.counts()
    for k in ("snapshots", "wal_frames", "wal_bytes", "wal_segments_dropped", "wal_torn",
              "snapshot_fallbacks"):
        put(reg, "durable." + k, c[k])
    _each(reg, "durable.snapshot_rejected", c["snapshot_rejected"])
    put(reg, "durable.snapshot_decoded", snapshot_counts()["decoded"])
    s = durability.snapshot()
    if s["generation"]:
        put(reg, "durable.generation", s["generation"])
        put(reg, "durable.bytes", s["snapshot_bytes"])
    if s["snapshot_age_s"] is not None:
        put(reg, "durable.age_s", round(s["snapshot_age_s"], 3))
    put(reg, "durable.wal_depth", s["wal_depth"])
    put(reg, "durable.wal_pending_bytes", s["wal_pending_bytes"])


def publish_heat(reg, heat) -> None:
    """A heat tracker: its counters now, its gauges as its last
    :meth:`~crdt_tpu_torch.obs.heat.HeatTracker.publish` left them."""
    counts = heat.counts()
    for cls in ("reads", "writes", "repair"):
        for i, v in enumerate(counts["totals"].get(cls, ())):
            if v:
                put(reg, f"heat.subtree_{cls}", int(v), i)
    _each(reg, "heat.reads", counts["reads_by_mode"])
    if counts["updates"]:
        put(reg, "heat.updates", counts["updates"])
    pub = heat.published()
    if pub is None:
        return
    for cls, rates in pub["rates"].items():
        for i, v in enumerate(rates):
            put(reg, f"heat.{cls}_per_s", float(v), i)
    for rank, (obj, count) in sorted(pub["hot"].items()):
        put(reg, "heat.hot_obj", float(obj), rank)
        put(reg, "heat.hot_count", float(count), rank)
    if pub["zipf"] is not None:
        put(reg, "heat.s_hat", pub["zipf"][0])
        put(reg, "heat.fit_r2", pub["zipf"][1])


def publish_stability(reg, stability) -> None:
    """A stability tracker's aging, frontier and audit state."""
    g = stability.gauges()
    if g["age_hist"].count:
        put(reg, "stab.age", g["age_hist"])
    if g["resolved_total"]:
        put(reg, "stab.resolved", g["resolved_total"])
    if g["aging"] is not None:
        put(reg, "stab.outstanding", g["aging"]["outstanding"])
        put(reg, "stab.age_p50", g["aging"]["p50"])
        put(reg, "stab.age_max", g["aging"]["max"])
    _each(reg, "stab.peer_age", g["peer_age"])
    if g["frontier"] is not None:
        for field in FRONTIER_FIELDS:
            put(reg, "stab.frontier", g["frontier"][field], field)
        for s, v in enumerate(g["frontier"]["subtree_max"]):
            put(reg, "stab.subtree_max", v, s)
    if g["audit_runs"]:
        put(reg, "stab.checks", g["checks"])
    if g["violations"]:
        put(reg, "stab.violations", g["violations"])


def publish_convergence(reg, tracker) -> None:
    """The convergence tracker's per-peer gauges (staleness as of now)."""
    snap = tracker.snapshot()
    for peer, leaves in tracker.published_leaves().items():
        st = snap[peer]
        for leaf in leaves:
            if leaf == "delta_ratio":
                v = st["delta_ratio_history"][-1]
            else:
                v = st[leaf]
            put(reg, "conv." + leaf, v, peer)


def publish_lag(reg, lag) -> None:
    """A lag tracker's per-peer view (as of now), samples and SLO share."""
    snap = lag.snapshot()
    for peer, st in snap["peers"].items():
        for leaf in ("p50_s", "p99_s", "outstanding", "current_s"):
            put(reg, "lag." + leaf, st[leaf], peer)
    if snap["measured"]:
        put(reg, "lag.samples", snap["measured"])
    if snap["foreign_sidecars_dropped"]:
        put(reg, "lag.foreign", snap["foreign_sidecars_dropped"])
    if snap["slo_converged_frac"] is not None:
        put(reg, "lag.slo", snap["slo_converged_frac"])


def publish_capacity(reg, capacity) -> None:
    """A capacity tracker's planes and its device-memory samples."""
    from .capacity import WATERMARK_STATES

    view = capacity.published()
    if view["samples"]:
        put(reg, "cap.samples", view["samples"])
    overall = 0
    for label, p in view["planes"].items():
        occ = p.occupancy
        state = WATERMARK_STATES.index(p.state)
        overall = max(overall, state)
        fields = {"bytes": occ.bytes, "objects": occ.objects, "slots": occ.slots,
                  "live": occ.live, "live_max": occ.live_max, "tombstones": occ.tombstones,
                  "utilization": occ.live_max / p.ceiling if p.ceiling > 0 else 0.0,
                  "eta_s": p.eta_s, "watermark": state}
        if p.rate is not None:
            fields["growth_rows_per_s"] = p.rate
        elif label in view["growth_seen"]:
            fields["growth_rows_per_s"] = 0.0
        for field, v in fields.items():
            put(reg, "cap.plane", v, label, field)
    if view["planes"]:
        put(reg, "cap.watermark", overall)
    if view["devicemem"] is not None:
        publish_devicemem(reg, view["devicemem"], view["devicemem_samples"])


def publish_links(reg, links: "LinkTally") -> None:
    """Transport counts summed over a node's links, and each link's RTT."""
    totals, per_link = links.totals()
    for k, v in totals.items():
        if k != "window_hw":
            put(reg, "link." + k, v)
    for name, (hw, rtt, rto) in per_link.items():
        put(reg, "link.window_hw", hw, name)
        if rtt["samples"]:
            put(reg, "link.srtt_s", rtt["srtt_s"], name)
            put(reg, "link.rttvar_s", rtt["rttvar_s"], name)
            put(reg, "link.rto_s", rto, name)
            put(reg, "link.samples", rtt["samples"], name)


def publish_observatory(reg, observatory) -> None:
    """A fleet observatory's merge and frame counts."""
    c = observatory.counts()
    if c["merges"]:
        put(reg, "fleet.merges", c["merges"])
        put(reg, "fleet.nodes", c["nodes"])
    if c["decoded"]:
        put(reg, "fleet.decoded", c["decoded"])
    _each(reg, "fleet.rejected", c["rejected"])
    if c["snapshot_bytes"].count:
        put(reg, "fleet.snapshot_bytes", c["snapshot_bytes"])


def publish_layout(reg, layout, loads=None) -> None:
    """A mesh layout's gauges, and each shard's load when given."""
    put(reg, "mesh.shards", layout.shards)
    put(reg, "mesh.granule", layout.granule)
    put(reg, "mesh.imbalance", layout.imbalance)
    for s, (lo, hi) in enumerate(layout.ranges()):
        put(reg, "mesh.objects", hi - lo, s)
        if loads is not None:
            put(reg, "mesh.load", float(loads[s]), s)


def publish_mesh(reg) -> None:
    """The mesh layer's process-wide counts that are not zero."""
    from ..mesh.state import mesh_counts

    for k, v in mesh_counts().items():
        if k.startswith("durable_rejected_"):
            put(reg, "mesh.durable_rejected", v, k[len("durable_rejected_"):])
        elif v:
            put(reg, "mesh." + k, v)


def process_source(reg) -> None:
    """What every registry of the process carries: the kernel observatory,
    the mesh layer's counts and the flight recorder's evictions."""
    from ..utils import tracing
    from . import events, kernels

    kernels.kernel_observatory().publish(reg)
    publish_mesh(reg)
    put(reg, "events.dropped", events.recorder().dropped)
    if tracing.unavailable_count():
        put(reg, "profiler.unavailable", tracing.unavailable_count())


class LinkTally:
    """The transports a node's sessions ran over: counts summed over
    every link, each link's RTT as of its last use.  Keeps the newest
    :attr:`KEEP` links and folds older ones into a running total."""

    KEEP = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._links: list = []
        self._retired: Dict[str, int] = {}
        self._rtt: Dict[str, tuple] = {}

    def watch(self, link) -> None:
        if not hasattr(link, "counts") or not hasattr(link, "rtt"):
            return
        with self._lock:
            self._links.append(link)
            while len(self._links) > self.KEEP:
                old = self._links.pop(0)
                for k, v in old.counts().items():
                    self._retired[k] = self._retired.get(k, 0) + v

    def totals(self) -> tuple:
        with self._lock:
            links = list(self._links)
            totals = dict(self._retired)
            for link in links:
                for k, v in link.counts().items():
                    totals[k] = totals.get(k, 0) + v
                self._rtt[link.name] = (link.counts()["window_hw"], link.rtt.snapshot(),
                                        link.current_rto())
            return totals, dict(self._rtt)


def node_source(node_ref):
    """The source of one :class:`~crdt_tpu_torch.cluster.ClusterNode`'s
    registry; ``node_ref`` is a weak reference to the node (a registry
    never keeps a fleet alive)."""

    def source(reg) -> None:
        node = node_ref()
        if node is None:
            return
        process_source(reg)
        publish_sessions(reg)
        if node._serve_loop is not None:
            publish_serve(reg, node._serve_loop.counts())
        if node.durability is not None:
            publish_durability(reg, node.durability)
        publish_heat(reg, node.heat)
        publish_stability(reg, node.stability)
        publish_convergence(reg, node.stability._conv())
        publish_lag(reg, node.lag_tracker)
        from . import capacity as capacity_mod

        publish_capacity(reg, node.capacity_tracker if node.capacity_tracker is not None
                         else capacity_mod.capacity_tracker())
        publish_links(reg, node.links)
        if node.observatory is not None and hasattr(node.observatory, "counts"):
            publish_observatory(reg, node.observatory)

    return source


def scheduler_source(sched_ref):
    """The source a :class:`~crdt_tpu_torch.cluster.GossipScheduler` adds
    to its node's registry: its counts, round walls, last round's health
    and its membership roster."""
    from ..cluster.membership import STATES

    def source(reg) -> None:
        sched = sched_ref()
        if sched is None:
            return
        for k, v in sched.counts().items():
            put(reg, "sched." + k, v)
        if sched.round_walls().count:
            put(reg, "sched.round", sched.round_walls())
        for k, v in (sched.last_health() or {}).items():
            put(reg, "health", v, k)
        _each(reg, "members.state_count", sched.membership.counts())
        for peer, row in sched.membership.snapshot().items():
            put(reg, "member.state", STATES.index(row["state"]), peer)
            put(reg, "member.consecutive_failures", row["consecutive_failures"], peer)

    return source
