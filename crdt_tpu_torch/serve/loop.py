"""The serve loop: session-consistent read batches against a live cluster
node (the port of the JAX package's ``serve/loop.py``).

Reads take a ``batch`` snapshot of the node and run outside its session
lock, so gossip, writes and reads coexist.  That is safe because every
path that replaces the node's batch builds new planes (the op fold's
scatters, the delta applier's ``put_rows`` and GC are out of place): a
snapshot is never written after it is taken.  The only waiting a read
does is an explicit consistency park: a read-your-writes or monotonic
floor not yet visible re-polls briefly, nudging the node's op drain, and
then raises :class:`~crdt_tpu_torch.error.ConsistencyUnavailableError`.

``serve_frames`` runs encoded request frames through decode, admit,
gather and encode, with the decode on a background thread behind a
bounded queue (at most ``depth`` decoded batches wait), stall counts past
``stall_threshold_s`` and per-stage wall seconds.  The JAX loop's
counters and latency histograms are :meth:`ServeLoop.counts`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable

import numpy as np

from ..error import ConsistencyUnavailableError
from ..obs import events as obs_events
from ..obs.metrics import Histogram
from . import consistency as cons
from .query import _PLANE, ReadRequest, ResultFrame, gather, infer_kind

_SENTINEL = object()


def visible_vv(batch) -> np.ndarray:
    """The batch's visible version vector (``uint64[W]``: the pointwise
    max of every object's clock, flattened for PN planes), or a width-0
    vector for clockless types.  Computed on every call: torch planes
    are mutable, so there is no memo per batch object."""
    from ..sync import digest as sync_digest

    vv = sync_digest.version_vector(batch)
    if vv is None:
        return np.zeros(0, np.uint64)
    return np.asarray(vv, np.uint64).reshape(-1)


class ServeLoop:
    """Session-consistent read serving against one cluster node:
    :meth:`serve` answers a decoded :class:`ReadRequest`,
    :meth:`serve_frames` whole encoded request streams."""

    def __init__(self, node, *, depth: int = 4, park_timeout_s: float = 0.25,
                 park_poll_s: float = 0.005, stall_threshold_s: float = 0.1):
        if depth < 2:
            raise ValueError("pipelining needs a decode queue depth >= 2")
        self.node = node
        self.depth = depth
        self.park_timeout_s = park_timeout_s
        self.park_poll_s = park_poll_s
        self.stall_threshold_s = stall_threshold_s
        self._lock = threading.Lock()
        self._counts = {"admit": {}, "park": {}, "reject": {}, "stalls": 0,
                        "not_stable_rows": 0, "park_wait_s": 0.0, "latency_s": {},
                        "reads": 0, "batches": 0, "park_hist": Histogram(),
                        "reads_per_s": None}

    def counts(self) -> dict:
        """Admitted, parked and rejected batches per mode, decode stalls,
        rows stamped not stable, the seconds parked in all (and their
        log2 ``park_hist`` over the parked batches served), rows read and
        batches served, the last batch's rows per second, and per mode
        the served batches' ``count``, ``total_s``, ``max_s`` and their
        log2 ``hist`` (:class:`~crdt_tpu_torch.obs.metrics.Histogram`)."""
        with self._lock:
            out = dict(self._counts)
            for k in ("admit", "park", "reject"):
                out[k] = dict(out[k])
            out["park_hist"] = out["park_hist"].copy()
            out["latency_s"] = {m: {**v, "hist": v["hist"].copy()}
                                for m, v in out["latency_s"].items()}
        return out

    def _tally(self, what: str, mode: str) -> None:
        with self._lock:
            self._counts[what][mode] = self._counts[what].get(mode, 0) + 1

    def token(self) -> np.ndarray:
        """The node's current monotonic-reads token."""
        return visible_vv(self.node.batch)

    def _frontier(self, snapshot):
        """``(frontier_vv, subtree_clocks, span)`` from the node's
        stability tracker; ``(None, None, 1)`` before a frontier forms."""
        tracker = getattr(self.node, "stability", None)
        fc = None if tracker is None else tracker.frontier_clock()
        if fc is None:
            return None, None, 1
        from ..obs.stability import subtree_layout

        n = int(snapshot.clock.shape[0]) if hasattr(snapshot, "clock") else 0
        return fc, tracker.subtree_frontier_clocks(), subtree_layout(n)[1]

    def serve(self, req: ReadRequest) -> ResultFrame:
        """Admit, park if needed, gather and stamp.  Raises
        :class:`ConsistencyUnavailableError` on a terminal rejection;
        otherwise the frame's ``token`` is the version vector of the
        snapshot its rows were gathered from."""
        t0 = time.perf_counter()
        deadline = None
        while True:
            # the snapshot first: admission and gather read one batch
            snapshot = self.node.batch
            vv = visible_vv(snapshot)
            frontier_vv, subtree_clocks, span = self._frontier(snapshot)
            ruling = cons.admit(req.mode, req.require, vv, frontier_vv=frontier_vv)
            if ruling.admitted:
                break
            if ruling.reason == "not_visible" and self.park_timeout_s > 0:
                now = time.perf_counter()
                if deadline is None:
                    deadline = now + self.park_timeout_s
                    self._tally("park", req.mode)
                if now < deadline:
                    drain = getattr(self.node, "try_drain", None)
                    if drain is not None:
                        drain()
                    time.sleep(self.park_poll_s)
                    continue
            self._tally("reject", req.mode)
            raise ConsistencyUnavailableError(
                f"{req.mode} read not servable: {ruling.reason} (parked "
                f"{'yes' if deadline is not None else 'no'}, timeout {self.park_timeout_s}s)",
                mode=req.mode, reason=ruling.reason or "")
        self._tally("admit", req.mode)
        parked_s = time.perf_counter() - t0 if deadline is not None else 0.0
        node_kind = infer_kind(snapshot)
        if len(req) and not (req.kind == node_kind).all():
            raise ValueError(f"read batch names kind(s) {sorted(set(int(k) for k in req.kind))} "
                             f"but this node serves kind {node_kind} only")
        frame = gather(snapshot, req.obj, member=req.member, kind=node_kind)
        frame.token = vv
        if len(req):
            heat = getattr(self.node, "heat", None)
            if heat is None:
                from ..obs import heat as obs_heat

                heat = obs_heat.tracker(getattr(snapshot, _PLANE[node_kind]).device)
            heat.record_reads(req.obj, int(getattr(snapshot, _PLANE[node_kind]).shape[0]),
                              mode=req.mode)
        bad = 0
        if req.mode == cons.MODE_FRONTIER:
            frame.status = cons.stability_statuses(frame, subtree_clocks, span)
            bad = int(np.sum(frame.status != 0))
        wall = time.perf_counter() - t0
        with self._lock:
            self._counts["not_stable_rows"] += bad
            self._counts["park_wait_s"] += parked_s
            self._counts["reads"] += len(req)
            self._counts["batches"] += 1
            if deadline is not None:
                self._counts["park_hist"].observe(parked_s)
            if wall > 0 and len(frame):
                self._counts["reads_per_s"] = len(frame) / wall
            lat = self._counts["latency_s"].setdefault(
                req.mode, {"count": 0, "total_s": 0.0, "max_s": 0.0, "hist": Histogram()})
            lat["count"] += 1
            lat["total_s"] += wall
            lat["max_s"] = max(lat["max_s"], wall)
            lat["hist"].observe(wall)
        return frame

    def serve_frames(self, frames: Iterable[bytes], *, overlap: bool = True) -> tuple:
        """Serve every encoded read-request frame, returning
        ``(result_frames, stats)``: ``stats = {"frames", "rows",
        "rejected", "pipeline", "stage_s": {decode, serve, encode},
        "e2e_s"}``.  A batch that terminally fails admission yields
        ``None`` in the result list, counted in ``rejected``."""
        from .wire import decode_read_request, encode_result_frame

        frames = list(frames)
        stage_s = {"decode": 0.0, "serve": 0.0, "encode": 0.0}
        stats = {"frames": len(frames), "rows": 0, "rejected": 0}
        t_all0 = time.perf_counter()
        batch = self.node.batch
        num_objects = int(batch.clock.shape[0]) if hasattr(batch, "clock") else None

        def decode_one(frame):
            t0 = time.perf_counter()
            req = decode_read_request(frame, num_objects=num_objects)
            stage_s["decode"] += time.perf_counter() - t0
            return req

        if overlap:
            parsed_q: "queue.Queue" = queue.Queue(maxsize=self.depth)

            def worker():
                try:
                    for frame in frames:
                        parsed_q.put(decode_one(frame))
                    parsed_q.put(_SENTINEL)
                except BaseException as e:  # surfaced in the caller's thread
                    parsed_q.put(e)

            thread = threading.Thread(target=worker, daemon=True, name="serve-decode")
            thread.start()

            def staged():
                while True:
                    t0 = time.perf_counter()
                    item = parsed_q.get()
                    waited = time.perf_counter() - t0
                    if self.stall_threshold_s and waited > self.stall_threshold_s:
                        with self._lock:
                            self._counts["stalls"] += 1
                        obs_events.record("serve.stall", waited_s=round(waited, 4),
                                          staging_free=self.depth - parsed_q.qsize())
                    if item is _SENTINEL:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item

            stream = staged()
        else:
            stream = (decode_one(f) for f in frames)

        out = []
        try:
            for req in stream:
                t0 = time.perf_counter()
                try:
                    frame = self.serve(req)
                except ConsistencyUnavailableError:
                    stats["rejected"] += 1
                    out.append(None)
                    stage_s["serve"] += time.perf_counter() - t0
                    continue
                stage_s["serve"] += time.perf_counter() - t0
                stats["rows"] += len(frame)
                t0 = time.perf_counter()
                out.append(encode_result_frame(frame))
                stage_s["encode"] += time.perf_counter() - t0
        finally:
            if overlap:
                # drain, so an abandoned worker never blocks on a full queue
                while True:
                    try:
                        parsed_q.get_nowait()
                    except queue.Empty:
                        break
                thread.join(timeout=30)

        stats["pipeline"] = "overlapped" if overlap else "serial"
        stats["stage_s"] = {k: round(v, 4) for k, v in stage_s.items()}
        stats["e2e_s"] = round(time.perf_counter() - t_all0, 4)
        return out, stats
