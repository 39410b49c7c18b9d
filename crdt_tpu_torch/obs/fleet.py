"""The fleet observatory: CRDT-merged telemetry across nodes (the port of
the JAX package's ``obs/fleet.py``).

A telemetry snapshot is itself a join-semilattice, one slice per node:

* **counters** merge by per-node ``max`` (a G-Counter with the node as the
  actor); the fleet counter is the sum over nodes, and a re-delivered
  slice changes nothing;
* **gauges** and **histograms** are last-writer-wins per ``(name, node)``
  by capture stamp ``(wall_ts, seq)``; the fleet gauge is the newest
  capture, the fleet histogram the bucket-wise sum over nodes;
* the convergence view is LWW, the flight-recorder tail a union by the
  recorder's per-process ``seq``.

Snapshots travel as versioned, CRC-guarded frames, byte for byte the JAX
package's (``<BBIQ`` header, type ``0x21``, canonical JSON), piggybacked
on gossip sessions (:class:`~crdt_tpu_torch.sync.session.SyncSession`
``observatory=``).  An observatory ships its *merged* snapshot, so slices
spread transitively.  :func:`stitch_trace` rebuilds one session's
cross-peer timeline from the merged slices.

A capture first refreshes its registry (:meth:`~crdt_tpu_torch.obs.
metrics.MetricsRegistry.refresh`), so a slice carries the node's counts
as they are at capture time.  The JAX package's ``obs.fleet.*`` counters
are :meth:`FleetObservatory.counts` here.
"""

from __future__ import annotations

import itertools
import json
import math
import struct
import threading
import time
import zlib
from typing import Dict, Iterable, List, Optional

from ..error import SyncProtocolError
from . import convergence as convergence_mod
from . import events as events_mod
from . import metrics as metrics_mod
from .capacity import ETA_NOT_GROWING
from .metrics import Histogram, sanitize

FLEET_PROTOCOL_VERSION = 1
FRAME_FLEET_SNAPSHOT = 0x21
_HEADER = struct.Struct("<BBIQ")  # version | type | crc32 | payload_len
#: flight-recorder events retained per node slice
EVENTS_TAIL = 128
_CAPTURE_SEQ = itertools.count(1)
#: the merged-fleet metric prefix, apart from the per-node ``crdt_tpu_``
FLEET_PROM_PREFIX = "crdt_tpu_fleet"


def _canon(obj) -> str:
    """Canonical JSON: the deterministic tie-breaker and equality key."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _stamp_key(entry) -> tuple:
    """Total order over stamped ``[ts, seq, value]`` entries."""
    return (entry[0], entry[1], _canon(entry[2]))


def _merge_stamped(a: Dict[str, list], b: Dict[str, list]) -> Dict[str, list]:
    """Pointwise LWW join of two ``{name: [ts, seq, value]}`` maps."""
    out = dict(a)
    for name, entry in b.items():
        cur = out.get(name)
        if cur is None or _stamp_key(entry) > _stamp_key(cur):
            out[name] = entry
    return out


def _merge_events(a: List[dict], b: List[dict]) -> List[dict]:
    """Union of two event tails of one node by ``seq``, newest
    :data:`EVENTS_TAIL` kept."""
    by_seq = {ev.get("seq", 0): ev for ev in a}
    for ev in b:
        by_seq.setdefault(ev.get("seq", 0), ev)
    return [by_seq[s] for s in sorted(by_seq)][-EVENTS_TAIL:]


def _num(v: float) -> str:
    """A sample value as the fleet text renders it."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class FleetSnapshot:
    """A mergeable fleet telemetry state: ``slices`` maps node id to a
    JSON-ready slice (:func:`capture_slice`).  Immutable by convention:
    :meth:`merge` returns a new snapshot."""

    __slots__ = ("slices",)

    def __init__(self, slices: Optional[Dict[str, dict]] = None):
        self.slices = slices or {}

    def merge(self, other: "FleetSnapshot") -> "FleetSnapshot":
        """The join: commutative, associative, idempotent."""
        merged = dict(self.slices)
        for node, theirs in other.slices.items():
            mine = merged.get(node)
            merged[node] = theirs if mine is None else _merge_slice(mine, theirs)
        return FleetSnapshot(merged)

    def __eq__(self, other) -> bool:
        return isinstance(other, FleetSnapshot) and _canon(self.slices) == _canon(other.slices)

    def __hash__(self):
        return hash(_canon(self.slices))

    def nodes(self) -> List[str]:
        return sorted(self.slices)

    def fleet_counters(self) -> Dict[str, int]:
        """Every counter -> the sum of the per-node values."""
        out: Dict[str, int] = {}
        for sl in self.slices.values():
            for name, v in sl.get("counters", {}).items():
                out[name] = out.get(name, 0) + int(v)
        return out

    def counters_by_node(self, name: str) -> Dict[str, int]:
        return {node: int(sl["counters"][name]) for node, sl in self.slices.items()
                if name in sl.get("counters", {})}

    def fleet_gauges(self) -> Dict[str, float]:
        """Every gauge -> the newest capture's value fleet-wide."""
        best: Dict[str, list] = {}
        for sl in self.slices.values():
            best = _merge_stamped(best, sl.get("gauges", {}))
        return {name: entry[2] for name, entry in best.items()}

    def fleet_histograms(self) -> Dict[str, dict]:
        """Every histogram -> the bucket-wise sum over nodes."""
        out: Dict[str, dict] = {}
        for sl in self.slices.values():
            for name, entry in sl.get("histograms", {}).items():
                h = entry[2]
                acc = out.setdefault(name, {"count": 0, "sum": 0.0, "min": None, "max": None,
                                            "buckets": {}})
                acc["count"] += int(h.get("count", 0))
                acc["sum"] += float(h.get("sum", 0.0))
                for bound, pick in (("min", min), ("max", max)):
                    v = h.get(bound)
                    if v is not None:
                        acc[bound] = v if acc[bound] is None else pick(acc[bound], v)
                for e, n in h.get("buckets", {}).items():
                    acc["buckets"][e] = acc["buckets"].get(e, 0) + int(n)
        return out

    def fleet_capacity(self) -> Dict[str, dict]:
        """Every ``capacity.*`` gauge -> ``{"sum", "max", "nodes"}`` over
        each node's own value (``eta_s``'s not-growing -1 never wins the
        max)."""
        out: Dict[str, dict] = {}
        for sl in self.slices.values():
            for name, entry in sl.get("gauges", {}).items():
                if not name.startswith("capacity."):
                    continue
                v = float(entry[2])
                acc = out.setdefault(name, {"sum": 0.0, "max": None, "nodes": 0})
                acc["sum"] += v
                if not (name.endswith(".eta_s") and v < 0) and (acc["max"] is None
                                                               or v > acc["max"]):
                    acc["max"] = v
                acc["nodes"] += 1
        for acc in out.values():
            if acc["max"] is None:
                acc["max"] = ETA_NOT_GROWING
        return out

    def fleet_stability(self) -> Dict[str, dict]:
        """The frontier clock gauges reduced by MIN over nodes:
        ``{name: {"min", "nodes"}}``."""
        out: Dict[str, dict] = {}
        for sl in self.slices.values():
            for name, entry in sl.get("gauges", {}).items():
                if not name.startswith("stability.frontier.") or not name.endswith("max_counter"):
                    continue
                v = float(entry[2])
                acc = out.setdefault(name, {"min": v, "nodes": 0})
                acc["min"] = min(acc["min"], v)
                acc["nodes"] += 1
        return out

    def fleet_heat(self) -> dict:
        """Per-subtree heat counters summed over nodes, and the nodes' hot
        lists joined: same-object counts add, then re-rank."""
        subtree = {name: int(v) for name, v in self.fleet_counters().items()
                   if name.startswith("heat.subtree.")}
        acc: Dict[int, int] = {}
        seen: Dict[int, int] = {}
        for sl in self.slices.values():
            ranks: Dict[str, dict] = {}
            for name, entry in sl.get("gauges", {}).items():
                parts = name.split(".")
                if len(parts) == 4 and parts[0] == "heat" and parts[1] == "hot":
                    ranks.setdefault(parts[2], {})[parts[3]] = float(entry[2])
            for r in ranks.values():
                if "obj" in r and r.get("count", 0) > 0:
                    obj = int(r["obj"])
                    acc[obj] = acc.get(obj, 0) + int(r["count"])
                    seen[obj] = seen.get(obj, 0) + 1
        hot = [{"obj": o, "count": c, "nodes": seen[o]}
               for o, c in sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))]
        return {"subtree": subtree, "hot": hot}

    def fleet_lag(self) -> Dict[str, dict]:
        """The ``sync.peer.<p>.lag_*`` gauges: per leaf, the max over every
        (node, peer) series and the series count."""
        out: Dict[str, dict] = {}
        for sl in self.slices.values():
            for name, entry in sl.get("gauges", {}).items():
                parts = name.split(".")
                if len(parts) != 4 or parts[:2] != ["sync", "peer"] \
                        or not parts[3].startswith("lag_"):
                    continue
                acc = out.setdefault(parts[3], {"max": 0.0, "series": 0})
                acc["max"] = max(acc["max"], float(entry[2]))
                acc["series"] += 1
        return out

    def events(self, node: Optional[str] = None) -> List[dict]:
        """Retained events, each with its ``node``, by wall clock then seq."""
        out = []
        for nid, sl in self.slices.items():
            if node is not None and nid != node:
                continue
            for ev in sl.get("events", []):
                ev = dict(ev)
                ev["node"] = nid
                out.append(ev)
        out.sort(key=lambda e: (e.get("wall_ts", e.get("wall", 0.0)), e.get("seq", 0)))
        return out

    def to_json(self) -> dict:
        """The raw slices and the fleet aggregates (``/fleet?format=json``)."""
        return {"version": FLEET_PROTOCOL_VERSION, "nodes": self.nodes(), "slices": self.slices,
                "fleet": {"counters": self.fleet_counters(), "gauges": self.fleet_gauges(),
                          "histograms": self.fleet_histograms(),
                          "capacity": self.fleet_capacity(), "lag": self.fleet_lag(),
                          "stability": self.fleet_stability(), "heat": self.fleet_heat()}}


def _merge_slice(a: dict, b: dict) -> dict:
    """Join two slices of the same node."""
    counters = dict(a.get("counters", {}))
    for name, v in b.get("counters", {}).items():
        cur = counters.get(name)
        counters[name] = int(v) if cur is None else max(int(cur), int(v))
    return {
        "ts": max(a.get("ts", 0.0), b.get("ts", 0.0)),
        "seq": max(a.get("seq", 0), b.get("seq", 0)),
        "counters": counters,
        "gauges": _merge_stamped(a.get("gauges", {}), b.get("gauges", {})),
        "histograms": _merge_stamped(a.get("histograms", {}), b.get("histograms", {})),
        "convergence": max(a.get("convergence", [0.0, 0, {}]),
                           b.get("convergence", [0.0, 0, {}]), key=_stamp_key),
        "events_dropped": max(int(a.get("events_dropped", 0)), int(b.get("events_dropped", 0))),
        "events": _merge_events(a.get("events", []), b.get("events", [])),
    }


def capture_slice(node_id: str, *, registry: Optional[metrics_mod.MetricsRegistry] = None,
                  tracker: Optional[convergence_mod.ConvergenceTracker] = None,
                  recorder: Optional[events_mod.FlightRecorder] = None,
                  events_tail: int = EVENTS_TAIL) -> FleetSnapshot:
    """One node's telemetry as a single-slice snapshot: the registry,
    refreshed first and stamped ``(wall_ts, seq)``, the convergence view,
    the events dropped and a bounded flight-recorder tail."""
    reg = registry if registry is not None else metrics_mod.registry()
    trk = tracker if tracker is not None else convergence_mod.tracker()
    rec = recorder if recorder is not None else events_mod.recorder()
    reg.refresh()
    snap = reg.snapshot()
    ts, seq = time.time(), next(_CAPTURE_SEQ)
    hists = {name: [ts, seq, {"count": h["count"], "sum": h["sum"], "min": h["min"],
                              "max": h["max"],
                              "buckets": {str(e): n for e, n in h["buckets"].items()}}]
             for name, h in snap["histograms"].items()}
    slice_ = {
        "ts": ts, "seq": seq,
        "counters": {k: int(v) for k, v in snap["counters"].items()},
        "gauges": {k: [ts, seq, float(v)] for k, v in snap["gauges"].items()},
        "histograms": hists,
        "convergence": [ts, seq, trk.snapshot()],
        "events_dropped": rec.dropped,
        "events": rec.snapshot()[-max(0, events_tail):],
    }
    return FleetSnapshot({node_id: slice_})


def encode_snapshot(snap: FleetSnapshot) -> bytes:
    """The versioned, CRC-guarded frame of a snapshot."""
    payload = _canon(snap.slices).encode("utf-8")
    return _HEADER.pack(FLEET_PROTOCOL_VERSION, FRAME_FLEET_SNAPSHOT, zlib.crc32(payload),
                        len(payload)) + payload


def _reject(reason: str, message: str) -> SyncProtocolError:
    events_mod.record("obs.fleet.frame_rejected", reason=reason, error=message[:200])
    err = SyncProtocolError(message)
    err.reason = reason
    return err


def decode_snapshot(frame: bytes) -> FleetSnapshot:
    """Validate and decode one frame.  Raises :class:`~crdt_tpu_torch.
    error.SyncProtocolError` (its ``reason`` one of ``truncated``,
    ``version_mismatch``, ``unknown_type``, ``length_mismatch``,
    ``crc_mismatch``, ``malformed_payload``) and records an
    ``obs.fleet.frame_rejected`` event on a bad frame."""
    if len(frame) < _HEADER.size:
        raise _reject("truncated", f"truncated fleet frame: {len(frame)} bytes < "
                                   f"{_HEADER.size}-byte header")
    version, ftype, crc, plen = _HEADER.unpack_from(frame)
    if version != FLEET_PROTOCOL_VERSION:
        raise _reject("version_mismatch",
                      f"fleet snapshot version mismatch: peer sent v{version}, "
                      f"this build speaks v{FLEET_PROTOCOL_VERSION}")
    if ftype != FRAME_FLEET_SNAPSHOT:
        raise _reject("unknown_type", f"unknown fleet frame type {ftype:#04x}")
    payload = frame[_HEADER.size:]
    if len(payload) != plen:
        raise _reject("length_mismatch",
                      f"fleet frame length mismatch: header says {plen} payload "
                      f"bytes, frame carries {len(payload)}")
    if zlib.crc32(payload) != crc:
        raise _reject("crc_mismatch",
                      "fleet snapshot frame CRC mismatch (tampered or corrupted in transit)")
    try:
        slices = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise _reject("malformed_payload", f"malformed fleet snapshot payload: {e}") from None
    if not isinstance(slices, dict) or not all(
            isinstance(k, str) and isinstance(v, dict) for k, v in slices.items()):
        raise _reject("malformed_payload", "fleet snapshot payload is not a {node: slice} object")
    return FleetSnapshot(slices)


def merge_snapshots(frames: Iterable[bytes]) -> FleetSnapshot:
    """Decode and fold a batch of frames."""
    acc = FleetSnapshot()
    for frame in frames:
        acc = acc.merge(decode_snapshot(frame))
    return acc


def stitch_trace(snapshot_or_events, trace_id: str) -> List[dict]:
    """Every event of every slice stamped with ``trace_id`` (a ``trace``
    field or the session id), by wall clock then seq, with its node."""
    evs = snapshot_or_events.events() if isinstance(snapshot_or_events, FleetSnapshot) \
        else list(snapshot_or_events)
    return [ev for ev in evs
            if ev.get("fields", {}).get("trace") == trace_id or ev.get("session") == trace_id]


def fleet_prometheus_text(snap: FleetSnapshot, prefix: str = FLEET_PROM_PREFIX) -> str:
    """The merged snapshot as Prometheus text: ``<prefix>_nodes``, counters
    summed, gauges LWW, capacity sum/max, frontier min, lag max, the top
    8 of the joined hot list, histograms summed bucket-wise."""
    lines = [f"# TYPE {prefix}_nodes gauge", f"{prefix}_nodes {len(snap.slices)}"]

    def gauge(mname: str, v) -> None:
        lines.append(f"# TYPE {mname} gauge")
        lines.append(f"{mname} {v}")

    counters = snap.fleet_counters()
    for name in sorted(counters):
        mname = f"{prefix}_{sanitize(name)}_total"
        lines.append(f"# TYPE {mname} counter")
        lines.append(f"{mname} {int(counters[name])}")
    gauges = snap.fleet_gauges()
    for name in sorted(gauges):
        gauge(f"{prefix}_{sanitize(name)}", _num(gauges[name]))
    cap = snap.fleet_capacity()
    for name in sorted(cap):
        for reduction in ("sum", "max"):
            gauge(f"{prefix}_{sanitize(name)}_{reduction}", _num(cap[name][reduction]))
    stab = snap.fleet_stability()
    for name in sorted(stab):
        gauge(f"{prefix}_{sanitize(name)}_min", _num(stab[name]["min"]))
    lag = snap.fleet_lag()
    for leaf in sorted(lag):
        gauge(f"{prefix}_sync_{sanitize(leaf)}_max", _num(lag[leaf]["max"]))
    for rank, h in enumerate(snap.fleet_heat()["hot"][:8]):
        gauge(f"{prefix}_heat_hot_{rank}_obj", h["obj"])
        gauge(f"{prefix}_heat_hot_{rank}_count", h["count"])
    hists = snap.fleet_histograms()
    for name in sorted(hists):
        h = hists[name]
        mname = f"{prefix}_{sanitize(name)}"
        lines.append(f"# TYPE {mname} histogram")
        running = 0
        for e in sorted(h["buckets"], key=int):
            running += h["buckets"][e]
            exp = int(e)
            bound = 0.0 if exp == Histogram.ZERO_BUCKET else math.ldexp(1.0, exp)
            lines.append(f'{mname}_bucket{{le="{_num(bound)}"}} {running}')
        lines.append(f'{mname}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{mname}_sum {_num(h['sum'])}")
        lines.append(f"{mname}_count {h['count']}")
    return "\n".join(lines) + "\n"


class FleetObservatory:
    """One node's accumulation point for fleet telemetry: sessions fold
    peer frames in (:meth:`merge_frame`) and ship the merged state out
    (:meth:`encode`); ``/fleet`` reads a refreshed copy (:meth:`merged`).
    ``registry`` is the node's (the process-global one by default)."""

    def __init__(self, node_id: Optional[str] = None, *,
                 registry: Optional[metrics_mod.MetricsRegistry] = None,
                 tracker: Optional[convergence_mod.ConvergenceTracker] = None,
                 recorder: Optional[events_mod.FlightRecorder] = None,
                 events_tail: int = EVENTS_TAIL):
        self.node_id = node_id or f"proc-{events_mod._PROC_TAG}"
        self._registry = registry
        self._tracker = tracker
        self._recorder = recorder
        self._events_tail = events_tail
        self._lock = threading.Lock()
        self._merged = FleetSnapshot()
        self._counts = {"merges": 0, "nodes": 0, "decoded": 0, "rejected": {}, "encodes": 0,
                        "encode_s": 0.0, "merge_s": 0.0, "snapshot_bytes": Histogram()}

    def counts(self) -> dict:
        """Merges folded, nodes held after the last, frames decoded and
        rejected (per reason), encodes, the seconds spent in
        :meth:`encode` and :meth:`merge_frame`, and the encoded frames'
        bytes (a log2 :class:`~crdt_tpu_torch.obs.metrics.Histogram`)."""
        with self._lock:
            return {**self._counts, "rejected": dict(self._counts["rejected"]),
                    "snapshot_bytes": self._counts["snapshot_bytes"].copy()}

    def capture(self) -> FleetSnapshot:
        """Capture this node's slice, fold it in, return it."""
        local = capture_slice(self.node_id, registry=self._registry, tracker=self._tracker,
                              recorder=self._recorder, events_tail=self._events_tail)
        with self._lock:
            self._merged = self._merged.merge(local)
        return local

    def merge(self, snap: FleetSnapshot) -> FleetSnapshot:
        """Fold a peer snapshot in (idempotent); the new merged state."""
        with self._lock:
            self._merged = merged = self._merged.merge(snap)
            self._counts["merges"] += 1
            self._counts["nodes"] = len(merged.slices)
        return merged

    def merge_frame(self, frame: bytes) -> FleetSnapshot:
        """Decode one frame and fold it in; a bad frame raises
        :class:`~crdt_tpu_torch.error.SyncProtocolError` and leaves the
        merged state as it was."""
        t0 = time.perf_counter()
        try:
            snap = decode_snapshot(frame)
        except SyncProtocolError as e:
            reason = getattr(e, "reason", "unknown")
            with self._lock:
                self._counts["rejected"][reason] = self._counts["rejected"].get(reason, 0) + 1
            raise
        merged = self.merge(snap)
        with self._lock:
            self._counts["decoded"] += 1
            self._counts["merge_s"] += time.perf_counter() - t0
        return merged

    def merged(self, refresh: bool = True) -> FleetSnapshot:
        """The merged snapshot, with a fresh local capture first."""
        if refresh:
            self.capture()
        with self._lock:
            return self._merged

    def encode(self, refresh: bool = True) -> bytes:
        """The merged snapshot as one frame (what a session piggybacks)."""
        t0 = time.perf_counter()
        frame = encode_snapshot(self.merged(refresh=refresh))
        with self._lock:
            self._counts["encodes"] += 1
            self._counts["encode_s"] += time.perf_counter() - t0
            self._counts["snapshot_bytes"].observe(len(frame))
        return frame

    def reset(self) -> None:
        with self._lock:
            self._merged = FleetSnapshot()


_DEFAULT: Optional[FleetObservatory] = None
_DEFAULT_LOCK = threading.Lock()


def observatory() -> FleetObservatory:
    """The process-global observatory (``/fleet``'s default)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = FleetObservatory()
    return _DEFAULT
