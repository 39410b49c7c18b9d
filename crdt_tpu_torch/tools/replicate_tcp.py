#!/usr/bin/env python3
"""Anti-entropy between replicas of the port over TCP: two OS processes
reconciling through :class:`~crdt_tpu_torch.sync.SyncSession`, a gossip
fleet of :class:`~crdt_tpu_torch.cluster.ClusterNode`\\ s, or one replica
sharded over a mesh.  The port of ``examples/replicate_tcp.py``.

    python -m crdt_tpu_torch.tools.replicate_tcp                  # demo: two processes
    python -m crdt_tpu_torch.tools.replicate_tcp --full-state     # ship full state
    python -m crdt_tpu_torch.tools.replicate_tcp --window 16      # over the windowed ARQ
    python -m crdt_tpu_torch.tools.replicate_tcp --gossip 3 --ops 60 --reads 30 --gc
    python -m crdt_tpu_torch.tools.replicate_tcp --gossip 3 --durable DIR   # kill -9, recover
    python -m crdt_tpu_torch.tools.replicate_tcp --mesh 4 --objects 96

Every flag keeps the JAX example's name, default and meaning, but
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions)
takes the place of ``--platform``, and the ``demo`` role hands it to the
``server`` and ``client`` it spawns.  Without a card the default device
raises :class:`~crdt_tpu_torch.error.DeviceUnavailableError`.  Each
process prints the JAX example's lines, then the tools' JSON evidence
line (:func:`crdt_tpu_torch.tools.evidence`) with its converged digest
fingerprint (null if it did not converge).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import sys
import threading
import time
import weakref

import numpy as np

from . import digest_sha, evidence, run_all, say


# -- the fleets ---------------------------------------------------------------------


def _divergent_rows(n_objects: int, divergence: float, seed: int) -> np.ndarray:
    return np.random.RandomState(seed + 1).choice(
        n_objects, size=int(n_objects * divergence), replace=False)


def _divergent_member(actor, i):
    return 100 + actor * 10 + i % 7


def fleet_planes(n_objects: int, actor: int, divergence: float, seed: int, *,
                 num_actors: int = 8, m_cap: int = 32, d_cap: int = 8) -> tuple:
    """The JAX example's ``_build_fleet`` as unsigned planes ``(clock, ids,
    dots, d_ids, d_clocks)``, member slots in the scalar engine's entry
    order, built without a scalar object: a shared base history (actor 0,
    from ``seed``), a causal remove on every 7th object, and this peer's
    own add on a ``divergence`` fraction of the objects.  Object i draws
    ``k = randint(1, 5)`` and k members ``randint(0, 64)``; both ranges are
    powers of two, so each draw is one 32-bit word of the ``RandomState``
    stream, masked: one vectorised draw and a walk over the per-object
    counts reproduce it."""
    n = n_objects
    words = np.random.RandomState(seed).randint(0, 2 ** 32, size=5 * n + 1, dtype=np.uint32)
    counts = (words & 3).tolist()
    pos = np.empty(n, np.int64)
    p = 0
    for i in range(n):
        pos[i] = p
        p += 2 + counts[p]
    k = (words[pos] & 3).astype(np.int64) + 1           # adds of actor 0
    col = np.arange(4)
    valid = col < k[:, None]
    mem = np.where(valid, (words[np.minimum(pos[:, None] + 1 + col, words.size - 1)] & 63)
                   .astype(np.int32), -1)
    same = (mem[:, :, None] == mem[:, None, :]) & valid[:, None, :]
    first = valid & ~(same & (col[None, :, None] > col[None, None, :])).any(-1)
    last = np.where(same, col + 1, 0).max(-1)           # the last add's counter
    # the remove on every 7th object drops its smallest member's entry
    smallest = np.where(first, mem, 1 << 30).min(1)
    keep = first & ~((np.arange(n) % 7 == 0)[:, None] & (mem == smallest[:, None]))
    o, j = np.nonzero(keep)
    slot = (np.cumsum(keep, 1) - 1)[o, j]
    clock = np.zeros((n, num_actors), np.uint32)
    ids = np.full((n, m_cap), -1, np.int32)
    dots = np.zeros((n, m_cap, num_actors), np.uint32)
    clock[:, 0] = k
    ids[o, slot] = mem[o, j]
    dots[o, slot, 0] = last[o, j]
    # the divergent tail: one new entry with dot (actor, 1)
    t = _divergent_rows(n, divergence, seed).astype(np.int64)
    s = keep.sum(1)[t]
    ids[t, s] = _divergent_member(actor, t)
    dots[t, s, actor] = 1
    clock[t, actor] = 1
    return (clock, ids, dots, np.full((n, d_cap), -1, np.int32),
            np.zeros((n, d_cap, num_actors), np.uint32))


def identity_universe(num_actors: int = 8):
    """The tools' universe: identity interning, A actors, M=32, D=8, u32."""
    from ..config import CrdtConfig
    from ..utils.interning import Universe

    return Universe.identity(CrdtConfig(num_actors=num_actors, member_capacity=32,
                                        deferred_capacity=8, counter_bits=32))


def build_batch(n_objects: int, actor: int, divergence: float, seed: int, uni, device):
    """The fleet as an :class:`~crdt_tpu_torch.batch.OrswotBatch` on ``device``."""
    from ..batch import OrswotBatch

    cfg = uni.config
    return OrswotBatch.from_numpy(*fleet_planes(
        n_objects, actor, divergence, seed, num_actors=cfg.num_actors,
        m_cap=cfg.member_capacity, d_cap=cfg.deferred_capacity), device=device)


# -- two processes, one session ------------------------------------------------------


def _connect(role: str, port: int) -> socket.socket:
    if role == "server":
        with socket.socket() as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", port))
            srv.listen(1)
            srv.settimeout(120)  # a peer that never comes must not orphan us
            return srv.accept()[0]
    deadline = time.monotonic() + 120  # the peers race at startup
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=10)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def peer(role: str, port: int, n_objects: int, device, full_state: bool = False,
         divergence: float = 0.05, metrics_port: int | None = None, linger_s: float = 0.0,
         window: int | None = None) -> tuple:
    """One side of the two-process sync: ``(SyncReport, converged batch)``."""
    from ..cluster import ResilientTransport, RetryPolicy, TcpTransport
    from ..sync import SyncSession, digest_of

    metrics_server = None
    if metrics_port is not None:
        from ..obs import convergence, export, publish
        from ..obs.metrics import MetricsRegistry

        # the process's and the sessions' counts, and the per-peer gauges
        reg = MetricsRegistry()
        reg.add_source(publish.process_source)
        reg.add_source(publish.publish_sessions)
        metrics_server = export.start_metrics_server(port=metrics_port, registry=reg,
                                                     tracker=convergence.tracker())
        say(f"{role}: metrics exporter on http://127.0.0.1:{metrics_server.port}/metrics")

    uni = identity_universe()
    actor = 1 if role == "server" else 2
    mine = build_batch(n_objects, actor, divergence, 42, uni, device)
    sock = _connect(role, port)
    other = "client" if role == "server" else "server"
    # the full-state reference size feeds the per-peer delta_ratio
    full_ref = sum(len(b) for b in mine.to_wire(uni))
    session = SyncSession(mine, uni, full_state=full_state, peer=other,
                          full_state_bytes=full_ref)
    # <I-framed frames alone, or inside the ARQ's seq-numbered CRC-guarded
    # envelopes with up to `window` in flight (0: stop-and-wait; both peers
    # must run with --window)
    transport = TcpTransport(sock, default_timeout=120.0 if window is None else 60.0)
    if window is not None:
        transport = ResilientTransport(transport, dataclasses.replace(
            RetryPolicy(), window=max(1, window)), name=role)
    with sock:
        try:
            report = session.sync(transport)
        finally:
            transport.close()

    status = "CONVERGED" if report.converged else "DIVERGED"
    mode = "full-state" if full_state else "delta"
    say(f"{role}: {n_objects} objects  mode={mode}  session={session.session_id}  "
          f"trace={report.trace_id}  diverged={report.diverged}  "
          f"delta_objects={report.delta_objects_sent}  sent: digest={report.digest_bytes_sent}B "
          f"delta={report.delta_bytes_sent}B full={report.full_bytes_sent}B  {status}")
    if window is not None:
        say(f"{role}: transport window={report.window} streaming={report.streaming}  "
              f"inflight_hw={transport.window_hw}  retransmits={transport.retransmits}  "
              f"sacks={transport.sacks_sent}  delta_chunks={report.delta_chunks_sent}  "
              f"descent_rtts={report.tree_round_trips}")
    if metrics_server is not None:
        if linger_s > 0:
            # up until both routes were read after the sync (or the budget ends)
            baseline = metrics_server.scrape_counts()
            deadline = time.monotonic() + linger_s
            while time.monotonic() < deadline and not metrics_server.scraped(
                    "/metrics", "/events", since=baseline):
                time.sleep(0.05)
        metrics_server.stop()
    evidence(role, digest_of(session.batch, uni) if report.converged else None)
    return report, session.batch


# -- one replica over a mesh ---------------------------------------------------------


def mesh_demo(shards: int, n_objects: int, device, divergence: float = 0.05,
              zipf_s: float = 1.1) -> int:
    """``--mesh S``: two replicas laid out in S shards (a world of one
    holding all of them), the planner's granule priced against a Zipf
    write history, one anti-entropy step, per-shard predicted against
    measured load, and the digests against the unsharded merge."""
    import torch.distributed as dist

    from .. import mesh as mesh_mod
    from ..obs import heat as heat_mod
    from ..obs.stability import subtree_layout
    from ..sync import digest_of

    uni = identity_universe()
    a = build_batch(n_objects, 1, divergence, 17, uni, device)
    b = build_batch(n_objects, 2, divergence, 17, uni, device)
    _subtrees, span = subtree_layout(n_objects)
    trk = heat_mod.HeatTracker(device=device)
    rng = np.random.RandomState(7)
    probs = np.arange(1, n_objects + 1, dtype=np.float64) ** -max(zipf_s, 1e-9)
    probs /= probs.sum()
    trk.record_writes(rng.choice(n_objects, size=4096, p=probs), n_objects)
    heat = trk.heat_vector()
    layout = mesh_mod.choose_layout(n_objects, shards, heat=heat, span=span)
    predicted = heat_mod.score_plan(f"mesh:{shards}", heat, n=n_objects, span=span,
                                    granule=layout.granule)
    say(f"mesh: {shards} shards over {n_objects} objects, planner granule {layout.granule} "
          f"(predicted imbalance {predicted['imbalance']})")
    try:
        sa, sb = (mesh_mod.ShardedBatch.shard(x, uni, shards=shards, heat=heat, span=span)
                  for x in (a, b))
        res = mesh_mod.anti_entropy_step(sa, sb)
        parity = bool(np.array_equal(res.digests, np.asarray(digest_of(a.merge(b), uni),
                                                             dtype=np.uint64)))
        # measured load: the history plus the rows that churned, as repair heat
        churned = np.nonzero(np.asarray(digest_of(a, uni)) != np.asarray(digest_of(b, uni)))[0]
        if churned.size:
            trk.record_repair(churned, n_objects)
        measured = mesh_mod.shard_loads(layout, trk.heat_vector(), span)
        say(f"{'shard':>5} {'objects':>8} {'predicted':>10} {'measured':>10}")
        for s, (lo, hi) in enumerate(layout.ranges()):
            say(f"{s:>5} {hi - lo:>8} {predicted['loads'][s]:>10.1f} {measured[s]:>10.1f}")
        sa.publish_gauges(heat_vector=trk.heat_vector(), span=span)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    say(f"digest parity vs unsharded control: {'BYTE-IDENTICAL' if parity else 'DIVERGED'} "
          f"({res.digests.size} lanes, {res.live_members} live members)")
    evidence("mesh", res.digests if parity else None)
    return 0 if parity else 1


# -- a gossip fleet --------------------------------------------------------------------


class _Tally:
    """What the JAX package keeps as process-wide counters and gauges, from
    the port's counts: every session report's bytes and every link's ARQ
    counts and RTT."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes = dict.fromkeys(("digest", "delta", "full", "tree"), 0)
        self.links: list = []

    def report(self, rep) -> None:
        with self._lock:
            for k in self.bytes:
                self.bytes[k] += getattr(rep, f"{k}_bytes_sent")

    def link(self, t):
        with self._lock:
            self.links.append(t)
        return t

    def transport(self) -> tuple:
        """Summed link counts, the deepest window and each link's SRTT."""
        with self._lock:
            links = list(self.links)
        totals: dict = {}
        for t in links:
            for k, v in t.counts().items():
                totals[k] = totals.get(k, 0) + v
        srtt = {t.name: t.rtt.snapshot()["srtt_s"] for t in links
                if t.rtt.snapshot()["samples"]}
        return totals, max((t.window_hw for t in links), default=0), srtt


def _fallbacks() -> int:
    from ..sync import session_counts

    return sum(v for k, v in session_counts().items() if k.startswith("full_state_fallback_"))


def gossip_demo(n_peers: int, n_objects: int, device, divergence: float, max_sweeps: int = 20,
                fleet_port: int | None = None, ops_rate: int = 0, ops_sweeps: int = 3,
                reads_rate: int = 0, gc_enabled: bool = False, gc_interval: int = 1,
                gc_hysteresis: float = 0.5, digest_tree: bool = False, zipf_s: float = 0.0,
                burst_len: int = 1, durable_dir: str | None = None, kill_sweep: int = 2,
                window: int | None = None, heat: bool = False) -> int:
    """N nodes in one process over loopback TCP, each with a listener, a
    roster and a :class:`~crdt_tpu_torch.cluster.GossipScheduler`, swept
    round-robin until their digest vectors are identical and the
    stability frontier settled.  ``--ops`` and ``--reads`` drive writes
    and session-consistent reads into random nodes while they gossip;
    ``--durable`` kills n1 at ``kill_sweep``, recovers it a sweep later
    and asserts its rejoin shipped no full state; ``--gc`` starts from
    over-provisioned planes and collects every ``gc_interval`` rounds."""
    from ..cluster import (
        ClusterNode, GossipScheduler, Membership, ResilientTransport, RetryPolicy, TcpTransport,
        hello_accept, hello_dial,
    )
    from ..error import ConsistencyUnavailableError, PeerUnavailableError
    from ..obs.fleet import FleetObservatory
    from ..obs.metrics import MetricsRegistry
    from ..oplog import OpLog
    from ..serve import ST_OK, ReadRequest, ServeLoop
    from ..sync import session_counts
    from ..sync import digest as digest_mod
    from ..utils.workload import WorkloadGen

    uni = identity_universe(max(8, n_peers + 2))
    policy = RetryPolicy(send_deadline_s=20.0, recv_deadline_s=20.0, ack_timeout_s=0.25,
                         max_backoff_s=2.0, retry_budget=64)
    if window is not None:  # 0: stop-and-wait, a one-frame window
        policy = dataclasses.replace(policy, window=max(1, window))
    tally = _Tally()

    def make_gc_engine():
        if not gc_enabled:
            return None
        from ..gc import GcEngine, GcPolicy

        return GcEngine(GcPolicy(interval_rounds=gc_interval, shrink_hysteresis=gc_hysteresis))

    def make_durability(name):
        if durable_dir is None:
            return None
        from ..durable import Durability

        return Durability(os.path.join(durable_dir, name), interval_rounds=1, retain=2)

    def make_node(name, batch, universe, **kw):
        reg = MetricsRegistry()
        return ClusterNode(name, batch, universe, busy_timeout_s=30.0, registry=reg,
                           observatory=FleetObservatory(name, registry=reg), gc=make_gc_engine(),
                           digest_tree=digest_tree, durability=make_durability(name), **kw)

    nodes = []
    for i in range(n_peers):
        batch = build_batch(n_objects, i + 1, divergence, 42, uni, device)
        if gc_enabled:
            # over-provisioned, as an earlier burst's regrow would leave them
            batch = batch.with_capacity(uni.config.member_capacity * 4,
                                        uni.config.deferred_capacity * 4)
        nodes.append(make_node(f"n{i}", batch, uni, oplog=OpLog(uni) if (
            ops_rate or reads_rate or durable_dir) else None))

    fleet_server = None
    if fleet_port is not None:
        from ..obs import export

        fleet_server = export.start_metrics_server(port=fleet_port,
                                                   registry=nodes[0].registry,
                                                   observatory=nodes[0].observatory)
        say(f"fleet: merged observatory on http://127.0.0.1:{fleet_server.port}/fleet "
              f"(?format=json for per-node slices, ?trace=<id> for a stitched session "
              f"timeline)")

    # one listener per node; the served node is looked up at accept time,
    # so a killed slot refuses and a restarted one serves its new node
    stop = threading.Event()
    servers: list = [None] * n_peers
    ports = {}

    def start_listener(i):
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(n_peers)
        srv.settimeout(0.2)  # poll the stop flag between accepts
        ports[f"n{i}"] = srv.getsockname()[1]
        servers[i] = srv

        def serve(sock):
            node = nodes[i]
            if node is None:  # killed between accept and serve
                sock.close()
                return
            t = tally.link(ResilientTransport(TcpTransport(sock, default_timeout=20.0), policy,
                                              name=f"{node.node_id}-accept"))
            try:
                tally.report(node.accept(t, peer_id=hello_accept(t, timeout=20.0)))
            except Exception as e:  # a failed inbound session
                say(f"{node.node_id}: inbound session failed: {type(e).__name__}: {e}")
            finally:
                t.close()

        def listener():
            while not stop.is_set():
                try:
                    sock, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                threading.Thread(target=serve, args=(sock,), daemon=True).start()

        threading.Thread(target=listener, daemon=True, name=f"listen-n{i}").start()

    for i in range(n_peers):
        start_listener(i)

    def make_sched(i):
        node = nodes[i]

        def dial(peer):
            try:
                sock = socket.create_connection(("127.0.0.1", ports[peer.peer_id]),
                                                timeout=20.0)
            except OSError as e:
                # a killed peer refuses: a membership fact, not a crash
                raise PeerUnavailableError(f"dial {peer.peer_id} refused: {e}") from e
            t = tally.link(ResilientTransport(TcpTransport(sock, default_timeout=20.0), policy,
                                              name=f"{node.node_id}->{peer.peer_id}"))
            hello_dial(t, node.node_id)
            return t

        membership = Membership(suspect_after=2, dead_after=5)
        for j in range(n_peers):
            if j != i:
                membership.add(f"n{j}", address=ports[f"n{j}"])
        return GossipScheduler(node, membership, dial, fanout=2, session_timeout_s=60.0, seed=i)

    scheds = [make_sched(i) for i in range(n_peers)]

    # writes: batched dots minted against each node's write clock, folded at
    # once when it is idle, queued and piggybacked when it is mid-session
    ops_rng = np.random.RandomState(4242)
    key_gen = WorkloadGen(n_objects, seed=4242, zipf_s=zipf_s, burst_len=burst_len)
    total_ops = 0

    def inject_writes(r):
        nonlocal total_ops
        per_node = np.bincount(ops_rng.randint(0, n_peers, r), minlength=n_peers)
        for i, cnt in enumerate(per_node):
            if not cnt or nodes[i] is None:  # a killed node takes none
                continue
            nodes[i].submit_writes(key_gen.draw(int(cnt)),
                                   ops_rng.randint(200, 216, cnt).astype(np.int32), actor=i + 1)
            total_ops += cnt

    # reads: their own key stream, a serve loop per node object (a restarted
    # node gets a fresh one) with a generous park behind the fold lock
    read_rng = np.random.RandomState(2424)
    read_gen = WorkloadGen(n_objects, seed=2424, zipf_s=zipf_s)
    serve_loops = weakref.WeakKeyDictionary()
    mono_tokens = weakref.WeakKeyDictionary()
    read_stats = dict.fromkeys(("reads", "ryw", "ryw_parked_out", "mono", "frontier_ok",
                                "frontier_not_stable", "frontier_unformed"), 0)

    def serve_on(i, req):
        node = nodes[i]
        if node not in serve_loops:
            serve_loops[node] = ServeLoop(weakref.proxy(node), park_timeout_s=5.0)
        return serve_loops[node].serve(req)

    def inject_reads(r):
        """Per node: a read-your-writes probe of a fresh acknowledged write
        (a miss is a protocol violation), monotonic reads whose token may
        never regress, and frontier reads tallied by stability."""
        nonlocal total_ops
        per_node = np.bincount(read_rng.randint(0, n_peers, r), minlength=n_peers)
        for i, cnt in enumerate(per_node):
            node = nodes[i]
            if not cnt or node is None:
                continue
            key = read_gen.draw(1)
            member = np.array([180 + i], np.int32)
            node.submit_writes(key, member, actor=i + 1)
            total_ops += 1
            try:
                frame = serve_on(i, ReadRequest.reads(key, member=member, mode="ryw",
                                                      require=node.write_vv()))
                assert int(frame.val[0]) == 1, (
                    f"{node.node_id}: read-your-writes VIOLATED — admitted ryw read of obj "
                    f"{int(key[0])} does not see acknowledged member {int(member[0])}")
                read_stats["ryw"] += 1
            except ConsistencyUnavailableError:
                read_stats["ryw_parked_out"] += 1  # parked out behind a long fold lock
            tok = mono_tokens.get(node)
            frame = serve_on(i, ReadRequest.reads(read_gen.draw(int(cnt)), mode="monotonic",
                                                  require=tok))
            if tok is not None:
                assert np.all(frame.token >= tok), (
                    f"{node.node_id}: monotonic token REGRESSED {tok.tolist()} -> "
                    f"{frame.token.tolist()}")
            mono_tokens[node] = frame.token
            read_stats["mono"] += int(cnt)
            try:
                frame = serve_on(i, ReadRequest.reads(read_gen.draw(int(cnt)), mode="frontier"))
                ok = int((frame.status == ST_OK).sum())
                read_stats["frontier_ok"] += ok
                read_stats["frontier_not_stable"] += len(frame) - ok
            except ConsistencyUnavailableError:
                read_stats["frontier_unformed"] += int(cnt)
            read_stats["reads"] += 1 + 2 * int(cnt)

    victim = 1 if (durable_dir is not None and n_peers >= 2) else None
    killed_at = rejoin_baseline = recovery = None

    def kill_victim(sweep):
        """kill -9 in process: the listener closed and the node dropped,
        nothing drained or flushed."""
        servers[victim].close()
        nodes[victim] = scheds[victim] = None
        say(f"kill: n{victim} killed -9 at sweep {sweep} (listener closed, in-memory state "
              "dropped)")

    def restart_victim():
        nonlocal rejoin_baseline, recovery
        from ..durable import recover
        from ..obs.stability import StabilityTracker

        rejoin_baseline = (_fallbacks(), dict(tally.bytes))
        recovery = recover(os.path.join(durable_dir, f"n{victim}"), device=device)
        node = make_node(f"n{victim}", recovery.batch, recovery.universe,
                         oplog=OpLog(recovery.universe), applier=recovery.applier,
                         stability_tracker=StabilityTracker())
        if node.gc is not None and recovery.watermark is not None:
            node.gc.restore_watermark(recovery.watermark)  # GC resumes its frontier
        if recovery.frontier is not None:
            node.stability.restore(recovery.frontier)  # a monotone floor
        nodes[victim] = node
        start_listener(victim)
        scheds[victim] = make_sched(victim)
        rep = recovery.report
        say(f"recovery: n{victim} restored generation {rep.generation} in "
              f"{rep.wall_s * 1e3:.1f}ms — replayed {rep.replayed_frames} WAL frames / "
              f"{rep.replayed_ops} ops ({rep.replayed_bytes}B), {rep.parked_ops} re-parked; "
              "rejoining via delta sync")

    def roster_for(node):
        return [f"n{j}" for j in range(n_peers) if f"n{j}" != node.node_id]

    def fleet_vv_min(live):
        """The element-wise min of the live nodes' version vectors."""
        vvs = [np.asarray(digest_mod.version_vector(n.batch), np.uint64) for n in live]
        width = max(v.size for v in vvs)
        return np.min([np.pad(v, (0, width - v.size)) for v in vvs], axis=0)

    def frontier_is_min(node, target) -> bool:
        rep = node.stability.frontier(node.batch, peers=roster_for(node))
        if rep is None:
            return False
        clock = np.asarray(rep.clock, np.uint64)
        w = max(clock.size, target.size)
        return np.array_equal(np.pad(clock, (0, w - clock.size)),
                              np.pad(target, (0, w - target.size)))

    sweeps, converged, settled = 0, False, False
    try:
        for sweeps in range(1, max_sweeps + 1):
            if victim is not None and killed_at is None and sweeps == kill_sweep:
                kill_victim(sweeps)
                killed_at = sweeps
            elif killed_at is not None and nodes[victim] is None and sweeps == killed_at + 1:
                restart_victim()
            writing = ops_rate and sweeps <= ops_sweeps
            reading = reads_rate and sweeps <= ops_sweeps
            if writing:
                inject_writes(ops_rate)
            if reading:
                inject_reads(reads_rate)
            for sched in scheds:
                if sched is None:
                    continue  # the victim is down this sweep
                if writing:  # writes and reads land between rounds too
                    inject_writes(max(1, ops_rate // n_peers))
                if reading:
                    inject_reads(max(1, reads_rate // n_peers))
                for rep in sched.run_round().reports.values():
                    tally.report(rep)
            live = [n for n in nodes if n is not None]
            digests = [n.digest() for n in live]
            converged = len(live) == n_peers and all(
                np.array_equal(digests[0], d) for d in digests[1:])
            state = ("digest vectors identical" if converged else "still diverged"
                     if len(live) == n_peers else f"{n_peers - len(live)} node(s) down")
            if ops_rate:
                state += f" (ops submitted so far: {total_ops})"
            say(f"sweep {sweeps}: {state}")
            # only the sweeps after the writes decide, and the frontier must
            # settle (every observer re-converged with every peer)
            if converged and not writing and not reading:
                target = fleet_vv_min(live)
                settled = all(frontier_is_min(n, target) for n in live)
                if settled:
                    break
    finally:
        stop.set()
        for srv in servers:
            if srv is not None:
                srv.close()

    if recovery is not None:
        full_frames = _fallbacks() - rejoin_baseline[0]
        delta_bytes = tally.bytes["delta"] - rejoin_baseline[1]["delta"]
        say(f"rejoin: {recovery.report.replayed_bytes}B replayed from the WAL vs "
              f"{delta_bytes}B delta-synced fleet-wide during the rejoin; "
              f"full-state fallbacks={full_frames}")
        assert full_frames == 0, "rejoin shipped a full-state frame (must be delta-only)"

    if ops_rate:
        say(f"ops: {total_ops} live writes ingested through submit_ops while gossip ran; "
              f"fleet {'CONVERGED' if converged else 'DIVERGED'} after writes stopped")
        assert not converged or all(len(n._oplog) == 0 for n in nodes
                                    if n is not None and n._oplog is not None), \
            "converged with undrained op logs"

    if reads_rate:
        say(f"reads: {read_stats['reads']} live reads served while gossip ran — ryw probes "
              f"{read_stats['ryw']} (0 violations; {read_stats['ryw_parked_out']} parked out "
              f"behind the fold lock), monotonic {read_stats['mono']} (0 token regressions), "
              f"frontier-stable rows {read_stats['frontier_ok']} ok / "
              f"{read_stats['frontier_not_stable']} not-yet-stable / "
              f"{read_stats['frontier_unformed']} before a frontier formed")
        assert read_stats["ryw"] > 0, "--reads ran but no read-your-writes probe was admitted"
        if converged and settled:
            # at quiescence the frontier is the fleet VV min: every row is stable
            for i, node in enumerate(nodes):
                frame = serve_on(i, ReadRequest.reads(np.arange(min(64, n_objects)),
                                                      mode="frontier"))
                assert bool((frame.status == ST_OK).all()), (
                    f"{node.node_id}: rows still not-stable under a settled frontier")
            say("reads: quiescent frontier-mode sweep all-rows-stable on every node")

    # one merged fleet snapshot: every node's slice reached n0 on the gossip
    merged = nodes[0].observatory.merged()
    fc = merged.fleet_counters()
    say(f"fleet: merged snapshot spans nodes={merged.nodes()}")
    say(f"fleet: sync.sessions={fc.get('sync.sessions', 0)} (per-node "
          f"{merged.counters_by_node('sync.sessions')}; fleet counter == sum of per-node values "
          "by G-Counter merge)")
    last = next((n.last_report for n in reversed(nodes)
                 if n is not None and n.last_report is not None), None)
    say(f"fleet: final session trace={last.trace_id if last is not None else None} "
          "(both peers' /events carry it)")
    if last is not None and last.profile is not None:
        p = last.profile
        say(f"latency: last session wall {p.wall_ns / 1e6:.1f}ms = serialize "
              f"{p.serialize_ns / 1e6:.1f} + network {p.network_ns / 1e6:.1f} + kernel "
              f"{p.kernel_ns / 1e6:.1f} + other {p.other_ns / 1e6:.1f} + unaccounted "
              f"{p.unaccounted_ns / 1e6:.1f} (network_wait {p.network_wait_frac:.0%})")
    link_counts, hw, srtts = tally.transport()
    if srtts:
        worst = max(srtts, key=srtts.get)
        say(f"latency: srtt over {len(srtts)} link(s), worst {worst}="
              f"{srtts[worst] * 1e3:.1f}ms")
    live = [n for n in nodes if n is not None]
    if ops_rate:
        for node in live:
            node.lag_tracker.refresh()
            for origin, st in sorted(node.lag_tracker.snapshot()["peers"].items()):
                say(f"latency: {node.node_id} sees {origin} write-to-visible "
                      f"p50={st['p50_s'] * 1e3:.1f}ms p99={st['p99_s'] * 1e3:.1f}ms "
                      f"({st['samples']} samples, {st['outstanding']} outstanding)")

    if converged and live:
        # at quiescence the frontier IS the fleet VV min: asserted, not printed
        target = fleet_vv_min(live)
        worst_age, checks, violations = 0.0, 0, 0
        for node in live:
            assert frontier_is_min(node, target), (
                f"{node.node_id}: frontier != fleet VV min {target.tolist()} at quiescence")
            snap = node.stability.snapshot()
            worst_age = max(worst_age, snap["aging"]["resolved_age_max_s"] or 0.0)
            checks += snap["audit"]["checks"]
            violations += snap["audit"]["violations"]
        oldest = max(n.stability.oldest_divergence_age_s() for n in live)
        say(f"stability: frontier == fleet VV min (max_counter={int(target.max(initial=0))}, "
              f"{live[0].stability.snapshot()['frontier']['subtrees']} subtree(s)); oldest "
              f"divergence age {oldest * 1e3:.1f}ms outstanding / {worst_age * 1e3:.1f}ms worst "
              f"resolved; audit checks={checks} violations={violations}")
        assert violations == 0, "lattice auditor recorded violations on a healthy run"

    if heat and live:
        _print_heat(live, n_peers, n_objects, zipf_s)

    if gc_enabled:
        for node in live:
            rep = node.last_gc_report
            wm = "never-ran" if rep is None or rep.watermark is None \
                else rep.watermark.clock.tolist()
            say(f"gc: {node.node_id} reclaimed={node.gc.total_reclaimed_bytes}B over "
                  f"{node.gc.runs} pass(es)  member_capacity={node.batch.member_capacity}  "
                  f"watermark={wm}")
    if fleet_server is not None:
        fleet_server.stop()

    c = session_counts()
    if digest_tree:
        fallbacks = sum(c.get(f"tree_fallback_{k}", 0) for k in ("version", "capability"))
        # the port keeps no digest memo (torch planes are mutable): no cache hits
        say(f"tree: descents={c.get('tree_descents', 0)} "
              f"cutover={c.get('tree_fallback_cutover', 0)} fallbacks={fallbacks} "
              f"digest_cache_hits=0 (wire.sync.tree.bytes={tally.bytes['tree']} vs flat "
              f"wire.sync.digest.bytes={tally.bytes['digest']})")
    say(f"transport: window={policy.window}  inflight_hw={hw}  "
          f"retransmits={link_counts.get('retransmits', 0)}  "
          f"frames_sacked={link_counts.get('frames_sacked', 0)}  "
          f"window_fallbacks={link_counts.get('window_fallbacks', 0)}  "
          f"descent_rtts={last.tree_round_trips if last is not None else 0}  "
          f"streaming_last={last.streaming if last is not None else False}")
    if converged and live:
        say(f"gossip: fleet digest sha256={digest_sha(live[0].digest())}")
    say(f"gossip: {n_peers} peers x {n_objects} objects  sweeps={sweeps}  "
          f"{'CONVERGED' if converged else 'DIVERGED'}")
    evidence("gossip", live[0].digest() if converged else None)
    return 0 if converged else 1


def _print_heat(live, n_peers: int, n_objects: int, zipf_s: float) -> None:
    """The heat observatory's read of the run: the nodes' views joined on
    the host, the fleet-merged top-k and two scored placement plans."""
    from ..obs import heat as heat_mod

    for node in live:
        node.heat.publish()
    vecs = [node.heat.heat_vector() for node in live]
    width = max((v.size for v in vecs), default=0)
    fleet_heat = np.zeros(max(width, 1), np.float64)
    for v in vecs:
        fleet_heat[:v.size] += v
    merged_hot = heat_mod.merge_hot([node.heat.hot(16) for node in live])
    layout = live[0].heat.snapshot()["layout"]
    rows = {cls: sum(n.heat.snapshot()["rows"][cls] for n in live) for cls in heat_mod.CLASSES}
    say(f"heat: {int(fleet_heat.sum())} attributed rows across {width} subtree(s) "
          f"(span={layout['span']}) — reads={rows['reads']} writes={rows['writes']} "
          f"repair={rows['repair']}")
    if merged_hot:
        top = ", ".join(f"#{h['obj']}x{h['count']}" for h in merged_hot[:8])
        say(f"heat: top-k (fleet-merged, +-err<={max(h['err'] for h in merged_hot)}): {top}")
    for spec in (f"mesh:{n_peers}", f"ring:{n_peers},k=2"):
        rep = heat_mod.score_plan(spec, fleet_heat, n=n_objects, span=layout["span"])
        if rep["kind"] == "mesh":
            say(f"heat: plan {spec}: imbalance={rep['imbalance']} (max={rep['max_load']} "
                  f"mean={rep['mean_load']})")
        else:
            say(f"heat: plan {spec}: skew={rep['skew']} movement_frac={rep['movement_frac']}")
    if zipf_s and len(merged_hot) >= heat_mod.MIN_FIT_RANKS:
        s_hat, r2 = heat_mod.zipf_fit([h["count"] - h["err"]
                                       for h in merged_hot[:heat_mod.ZIPF_FIT_RANKS]])
        if s_hat is not None and rows["writes"] >= 2_000:
            say(f"heat: zipf s_hat={s_hat:.3f} (r2={r2:.3f}) vs driver s={zipf_s}")
            # a loose bar: the write volume is small and repair rides the sketch
            assert abs(s_hat - zipf_s) <= 0.4, (
                f"sketch-fitted Zipf exponent {s_hat:.3f} far from the writes' {zipf_s}")
        elif s_hat is not None:
            say(f"heat: zipf s_hat={s_hat:.3f} (r2={r2:.3f}; too few writes to assert)")


# -- the command line ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("role", nargs="?", default="demo", choices=["demo", "server", "client"])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--objects", type=int, default=64)
    ap.add_argument("--divergence", type=float, default=0.05,
                    help="fraction of objects with peer-local ops")
    ap.add_argument("--full-state", action="store_true",
                    help="ship full state instead of digest-driven deltas")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the planes live (cuda: the merge kernel; cpu: plain PyTorch)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="server/client: serve /metrics, /events, /healthz on this port")
    ap.add_argument("--linger", type=float, default=0.0,
                    help="with --metrics-port: keep the exporter up to this many seconds "
                         "after the sync, until /metrics and /events were both read")
    ap.add_argument("--gossip", type=int, default=0, metavar="N",
                    help="N nodes over loopback TCP, gossiping until their digests agree")
    ap.add_argument("--fleet-port", type=int, default=None,
                    help="with --gossip: serve the merged fleet snapshot on GET /fleet")
    ap.add_argument("--ops", type=int, default=0, metavar="R",
                    help="with --gossip: R writes per sweep into random nodes while they gossip")
    ap.add_argument("--reads", type=int, default=0, metavar="R",
                    help="with --gossip: R reads per sweep (read-your-writes, monotonic and "
                         "frontier modes, asserted) while they gossip")
    ap.add_argument("--gc", action="store_true",
                    help="with --gossip: causal GC from over-provisioned planes")
    ap.add_argument("--gc-interval", type=int, default=1, metavar="N",
                    help="with --gc: collect every Nth gossip round")
    ap.add_argument("--digest-tree", action="store_true",
                    help="with --gossip: locate divergence by digest-tree descent")
    ap.add_argument("--zipf", type=float, default=0.0, metavar="S",
                    help="with --ops: Zipf key-skew exponent of the writes (0: uniform)")
    ap.add_argument("--burst", type=int, default=1, metavar="B",
                    help="with --ops: each drawn key repeats for B writes")
    ap.add_argument("--heat", action="store_true",
                    help="with --gossip: print the heat observatory's read of the run")
    ap.add_argument("--durable", default=None, metavar="DIR",
                    help="with --gossip: snapshot + WAL under DIR/n<i>; kill n1 -9 mid-run, "
                         "recover it from disk and rejoin it by delta sync")
    ap.add_argument("--kill-sweep", type=int, default=2, metavar="K",
                    help="with --durable: kill n1 at sweep K, restart it one sweep later")
    ap.add_argument("--window", type=int, default=None, metavar="N",
                    help="ARQ window: up to N frames in flight (0: stop-and-wait)")
    ap.add_argument("--mesh", type=int, default=0, metavar="S",
                    help="shard one replica over S shards (1, 2, 4 or 8) and run one "
                         "anti-entropy step against the unsharded control")
    ap.add_argument("--gc-hysteresis", type=float, default=0.5,
                    help="with --gc: shrink only to at most this fraction of the capacity")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)  # no card: DeviceUnavailableError
    if args.mesh:
        if args.mesh not in (1, 2, 4, 8):
            ap.error("--mesh needs S in {1, 2, 4, 8}")
        return mesh_demo(args.mesh, args.objects, device, divergence=args.divergence,
                         zipf_s=args.zipf if args.zipf > 0 else 1.1)
    if args.window is not None and args.window < 0:
        ap.error("--window needs N >= 0")
    if args.gossip:
        for flag, bad in (("--gossip needs N >= 2 peers", args.gossip < 2),
                          ("--ops needs R >= 0", args.ops < 0),
                          ("--reads needs R >= 0", args.reads < 0),
                          ("--kill-sweep needs K >= 1", args.kill_sweep < 1)):
            if bad:
                ap.error(flag)
        return gossip_demo(
            args.gossip, args.objects, device, divergence=args.divergence,
            fleet_port=args.fleet_port, ops_rate=args.ops, reads_rate=args.reads,
            gc_enabled=args.gc, gc_interval=args.gc_interval, gc_hysteresis=args.gc_hysteresis,
            digest_tree=args.digest_tree, zipf_s=args.zipf, burst_len=args.burst,
            durable_dir=args.durable, kill_sweep=args.kill_sweep, window=args.window,
            heat=args.heat)
    if args.role != "demo":
        if not args.port:
            ap.error("server/client roles need --port")
        report, _ = peer(args.role, args.port, args.objects, device, full_state=args.full_state,
                         divergence=args.divergence, metrics_port=args.metrics_port,
                         linger_s=args.linger, window=args.window)
        return 0 if report.converged else 1

    # demo: both peers as OS processes
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    base = [sys.executable, "-m", "crdt_tpu_torch.tools.replicate_tcp"]
    extra = ["--port", str(port), "--objects", str(args.objects), "--divergence",
             str(args.divergence), "--device", args.device]
    if args.full_state:
        extra += ["--full-state"]
    if args.window is not None:
        extra += ["--window", str(args.window)]
    srv_extra = list(extra)
    if args.metrics_port is not None:  # one exporter, on the server
        srv_extra += ["--metrics-port", str(args.metrics_port), "--linger", str(args.linger)]
    done, _ = run_all([base + ["server"] + srv_extra, base + ["client"] + extra], float("inf"))
    rc = int(any(rc != 0 for rc, *_ in done))
    say("demo:", "CONVERGED" if rc == 0 else "DIVERGED/FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
