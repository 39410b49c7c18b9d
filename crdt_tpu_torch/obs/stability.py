"""Divergence aging, the fleet stability frontier and the lattice auditor
(the port of the JAX package's ``obs/stability.py``; its gauges,
histograms and flight-recorder events are fields of the reports and the
snapshot here).

* **Aging**: :meth:`StabilityTracker.observe_descent` maps each digest
  exchange's diverged rows onto the digest tree's top-level subtrees
  (:func:`subtree_layout`) and tracks each ``(peer, subtree)`` from its
  first diverged sighting to the exchange that finds it clean.
* **Frontier**: a clean converged exchange proves the peer holds every
  dot of our per-subtree version vectors; :meth:`StabilityTracker.frontier`
  takes the element-wise minimum over the peers' evidence, under the GC
  watermark's liveness rules (unheard roster peers pin zero, stale peers
  freeze, silence past ``quarantine_s`` excludes), floored by a restored
  clock and the last published value, so it never regresses.
* **Auditor**: :meth:`StabilityTracker.audit` re-merges a seeded sample
  of rows with themselves through the wire codec (``gather_blobs`` →
  ``from_wire`` → ``merge``, the merge kernel on a CUDA device) and
  requires their digests unchanged, and checks the published frontier
  against the local and the peers' version vectors.

The per-subtree fold runs where the planes live: a max over
``[S, span, W]`` in the biased counter domain (whose order is the
unsigned one), unbiased on the way out.  It keeps no memo: torch planes
can be written in place, so every call reads them as they are.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dtypes import zero_of
from . import convergence as convergence_mod
from .metrics import Histogram

#: resolved divergence ages kept for the p50 and max
RESOLVED_WINDOW = 512
#: the aging p50/max before any divergence episode resolved
AGE_UNKNOWN = -1.0


def subtree_layout(n: int) -> Tuple[int, int]:
    """``(subtrees, span)`` of the digest tree's level below the root for
    an ``n``-object fleet: subtree ``s`` covers objects ``[s*span,
    (s+1)*span)``; at most ``TREE_K`` subtrees."""
    from ..sync.tree import TREE_K

    if n <= 0:
        return 0, 1
    levels, size = 1, n
    while size > 1:
        size = -(-size // TREE_K)
        levels += 1
    if levels < 2:
        return 1, 1
    span = TREE_K ** (levels - 2)
    return -(-n // span), span


def subtree_fold(clocks: torch.Tensor, subtrees: int, span: int) -> torch.Tensor:
    """Per-subtree max ``[S, W]`` of a ``[N, W]`` counter plane, where it
    lives (every subtree holds at least one row, so no padding)."""
    n, w = clocks.shape
    full = min(n // span, subtrees)
    out = torch.empty((subtrees, w), dtype=clocks.dtype, device=clocks.device)
    if full:
        out[:full] = clocks[:full * span].view(full, span, w).amax(dim=1)
    if full < subtrees:
        out[full] = clocks[full * span:].amax(dim=0)
    return out


def subtree_version_vectors(batch):
    """``uint64[S, W]`` per-subtree version vectors of ``batch`` (a PN
    counter's ``[N, 2, A]`` flattened to ``[N, 2A]``), or None for LWW."""
    from ..sync.digest import _clock_plane

    clocks = _clock_plane(batch)
    if clocks is None:
        return None
    clocks = clocks.flatten(1)
    subtrees, span = subtree_layout(int(clocks.shape[0]))
    if subtrees == 0:
        return np.zeros((0, clocks.shape[1]), dtype=np.uint64)
    vv = (subtree_fold(clocks, subtrees, span) ^ zero_of(clocks.dtype)).cpu().numpy()
    return vv.view(np.uint32 if vv.dtype == np.int32 else np.uint64).astype(np.uint64)


def _align_rows(rows: List, width: int) -> List:
    """Clock rows zero-padded (or cut) to ``width``."""
    out = []
    for r in rows:
        r = np.asarray(r, dtype=np.uint64).reshape(-1)
        if r.size < width:
            r = np.concatenate([r, np.zeros(width - r.size, dtype=np.uint64)])
        out.append(r[:width])
    return out


@dataclasses.dataclass
class FrontierReport:
    """One frontier computation: ``clock`` the fleet-min frontier
    (``uint64[W]``), ``subtree_clocks`` the per-subtree min-join
    (``uint64[S, W]``, never below ``clock``); all zero while a roster
    peer is unheard.  ``lag`` is how far the local version vector runs
    ahead of ``clock`` (its largest counter difference)."""

    clock: object
    subtree_clocks: object
    subtrees: int = 0
    peers: int = 0                # peers contributing converged clocks
    stale: int = 0                # contributing but past stale_after_s
    unheard: int = 0              # roster peers never converged with
    excluded: int = 0             # quarantined out of the minimum
    age_s: float = 0.0            # oldest contributing observation's age
    lag: int = 0

    @property
    def frozen(self) -> bool:
        return self.stale > 0 or self.unheard > 0


@dataclasses.dataclass
class AuditReport:
    """One audit pass; each violation names the plane that lied
    (``merge_idempotence``, ``frontier_local``, ``frontier_peer_vv``)."""

    checks: int = 0
    sampled: int = 0
    violations: List[dict] = dataclasses.field(default_factory=list)
    sampled_ids: object = None    # int64 rows of the idempotence sample

    @property
    def ok(self) -> bool:
        return not self.violations


class _PeerStability:
    __slots__ = ("outstanding", "clocks", "converged_ts", "age_gauge")

    def __init__(self):
        self.outstanding: Dict[int, float] = {}   # subtree -> birth time
        self.age_gauge: Optional[float] = None    # oldest outstanding age at its last observation
        self.clocks: Optional[Tuple[Tuple[int, ...], ...]] = None
        self.converged_ts: Optional[float] = None


def _device_of(batch) -> torch.device:
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, torch.Tensor):
            return v.device
    raise TypeError(f"{type(batch).__name__} holds no planes")


class StabilityTracker:
    """Aging, frontier and auditor for one observer.  ``tracker`` is the
    :class:`~crdt_tpu_torch.obs.convergence.ConvergenceTracker` whose peer
    version vectors the auditor checks (the process-global one by
    default); ``audit_sample``/``audit_every`` bound the auditor's budget
    (0 disables it); ``clock`` gives monotonic seconds."""

    def __init__(self, *, tracker: Optional[convergence_mod.ConvergenceTracker] = None,
                 stale_after_s: float = 30.0, quarantine_s: float = 300.0,
                 audit_sample: int = 8, audit_every: int = 1, seed: int = 0,
                 clock=time.monotonic):
        if not 0.0 < stale_after_s <= quarantine_s:
            raise ValueError(f"need 0 < stale_after_s <= quarantine_s, got "
                             f"{stale_after_s}/{quarantine_s}")
        self._tracker = tracker
        self.stale_after_s = stale_after_s
        self.quarantine_s = quarantine_s
        self.audit_sample = int(audit_sample)
        self.audit_every = int(audit_every)
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._peers: Dict[str, _PeerStability] = {}
        self._resolved: deque = deque(maxlen=RESOLVED_WINDOW)
        self._resolved_total = 0
        self._first_seen: Dict[str, float] = {}
        self._floor: Optional[Tuple[int, ...]] = None
        self._published: Optional[tuple] = None
        self._published_global: Optional[Tuple[int, ...]] = None
        self._audit_rounds = 0
        self._audit_checks = 0
        self._audit_violations = 0
        self._last_violation: Optional[dict] = None
        # the JAX tracker's gauges, as its event sites would have set them
        self._age_hist = Histogram()
        self._aging: Optional[dict] = None
        self._frontier_gauges: Optional[dict] = None
        self._audits = 0

    def _conv(self) -> convergence_mod.ConvergenceTracker:
        return self._tracker if self._tracker is not None else convergence_mod.tracker()

    def _state(self, peer: str) -> _PeerStability:
        st = self._peers.get(peer)
        if st is None:
            st = self._peers[peer] = _PeerStability()
        return st

    # -- aging ----------------------------------------------------------------

    @staticmethod
    def _resolve(st: _PeerStability, keep, now: float) -> list:
        """Pop ``st``'s outstanding subtrees outside ``keep``; their ages."""
        return [max(0.0, now - st.outstanding.pop(s)) for s in list(st.outstanding)
                if s not in keep]

    def _aging_view(self, st: _PeerStability) -> tuple:
        """``(oldest outstanding age of st, the fleet aging view)`` now;
        the caller holds the lock."""
        now = self._clock()
        births = st.outstanding.values()
        oldest = round(max(0.0, now - min(births)), 6) if births else 0.0
        window = sorted(self._resolved)
        if window:
            mid = window[min(len(window) - 1, max(0, int(round(0.5 * (len(window) - 1)))))]
            p50, top = round(mid, 6), round(window[-1], 6)
        else:
            p50 = top = AGE_UNKNOWN
        return oldest, {"outstanding": sum(len(p.outstanding) for p in self._peers.values()),
                        "p50": p50, "max": top}

    def observe_descent(self, peer: str, diverged_ids, objects: int,
                        at: Optional[float] = None) -> None:
        """One exchange's diverged rows against ``peer``: new subtrees are
        born now, tracked subtrees absent from the set are resolved."""
        _, span = subtree_layout(int(objects))
        now = self._clock() if at is None else at
        current = set((np.asarray(diverged_ids, np.int64).reshape(-1) // span).tolist())
        with self._lock:
            st = self._state(peer)
            ages = self._resolve(st, current, now)
            self._resolved.extend(ages)
            self._resolved_total += len(ages)
            for s in current:
                st.outstanding.setdefault(s, now)
            for age in ages:
                self._age_hist.observe(age)
            st.age_gauge, self._aging = self._aging_view(st)

    def resolve_all(self, peer: str, at: Optional[float] = None) -> None:
        """Resolve every outstanding subtree against ``peer``."""
        now = self._clock() if at is None else at
        with self._lock:
            st = self._state(peer)
            ages = self._resolve(st, (), now)
            self._resolved.extend(ages)
            self._resolved_total += len(ages)
            for age in ages:
                self._age_hist.observe(age)
            st.age_gauge, self._aging = self._aging_view(st)

    def oldest_divergence_age_s(self) -> float:
        """Age of the oldest still-diverged subtree (0 = none)."""
        now = self._clock()
        with self._lock:
            births = [b for st in self._peers.values() for b in st.outstanding.values()]
        return max(0.0, now - min(births)) if births else 0.0

    # -- the frontier ---------------------------------------------------------

    def observe_converged(self, peer: str, batch, at: Optional[float] = None) -> None:
        """A clean converged exchange with ``peer`` over ``batch``: records
        its per-subtree version vectors (element-wise max with earlier
        evidence) and resolves all aging."""
        self.resolve_all(peer, at=at)
        svv = subtree_version_vectors(batch)
        if svv is None:
            return
        now = self._clock() if at is None else at
        fresh = tuple(map(tuple, svv.tolist()))
        with self._lock:
            st = self._state(peer)
            old = st.clocks
            if old is None or len(old) != len(fresh):
                st.clocks = fresh
            else:
                st.clocks = tuple(tuple(max(a, b) for a, b in _zip_pad(o, f))
                                  for o, f in zip(old, fresh))
            st.converged_ts = now
            self._first_seen.pop(peer, None)

    def frontier(self, batch, peers=None, at: Optional[float] = None) -> Optional[FrontierReport]:
        """The stability frontier of the local ``batch`` and the recorded
        evidence (``peers``: an optional roster); None for LWW."""
        svv = subtree_version_vectors(batch)
        if svv is None:
            return None
        subtrees = int(svv.shape[0])
        width = int(svv.shape[1]) if svv.ndim == 2 else 0
        now = self._clock() if at is None else at
        report = FrontierReport(clock=np.zeros(width, np.uint64),
                                subtree_clocks=np.zeros((subtrees, width), np.uint64),
                                subtrees=subtrees)
        contributing: List[tuple] = []
        with self._lock:
            known = {p for p, st in self._peers.items() if st.clocks is not None}
            roster = set(peers) if peers is not None else set(known)
            for peer in sorted(roster | known):
                st = self._peers.get(peer)
                if st is None or st.clocks is None:
                    if peer not in roster:
                        continue
                    first = self._first_seen.setdefault(peer, now)
                    if now - first > self.quarantine_s:
                        report.excluded += 1
                    else:
                        report.unheard += 1
                    continue
                self._first_seen.pop(peer, None)
                age = max(0.0, now - st.converged_ts)
                if age > self.quarantine_s:
                    report.excluded += 1
                    continue
                report.peers += 1
                report.age_s = max(report.age_s, age)
                if age > self.stale_after_s:
                    report.stale += 1
                contributing.append(st.clocks)
            floor, published, published_global = (self._floor, self._published,
                                                  self._published_global)

        local_vv = svv.max(axis=0) if subtrees else np.zeros(width, np.uint64)
        if report.unheard:
            clocks = np.zeros((subtrees, width), np.uint64)
            fleet_min = np.zeros(width, np.uint64)
        else:
            clocks = svv.copy()
            fleet_min = local_vv.copy()
            for peer_clocks in contributing:
                # the peer's whole-fleet clock at convergence bounds the
                # fleet-min clock; a table shorter than ours gives no
                # evidence for the missing subtrees
                rows = _align_rows(list(peer_clocks), width)
                fleet_min = np.minimum(fleet_min, np.max(rows, axis=0, initial=0))
                for s in range(min(subtrees, len(rows))):
                    clocks[s] = np.minimum(clocks[s], rows[s])
                clocks[len(peer_clocks):subtrees] = 0
        # monotone floors: the restored clock and the last published values
        for prior in (floor, published_global):
            if prior is not None:
                fleet_min = np.maximum(fleet_min, _align_rows([prior], width)[0])
        for s in range(subtrees):
            clocks[s] = np.maximum(clocks[s], fleet_min)
            if published is not None and s < len(published):
                clocks[s] = np.maximum(clocks[s], _align_rows([published[s]], width)[0])
        report.subtree_clocks = clocks
        report.clock = fleet_min
        report.lag = int((local_vv - np.minimum(local_vv, fleet_min)).max(initial=0))
        with self._lock:
            self._published = tuple(map(tuple, clocks.tolist()))
            self._published_global = tuple(fleet_min.tolist())
            self._frontier_gauges = {
                "peers": report.peers, "stale": report.stale, "unheard": report.unheard,
                "excluded": report.excluded, "subtrees": subtrees,
                "age_s": round(report.age_s, 3), "max_counter": int(fleet_min.max(initial=0)),
                "lag": report.lag,
                "subtree_max": [int(clocks[s].max(initial=0)) for s in range(subtrees)]}
        return report

    def frontier_clock(self):
        """The last published fleet-min clock ``uint64[W]`` (None before
        :meth:`frontier` ran)."""
        with self._lock:
            published = self._published_global
        return None if published is None else np.asarray(published, dtype=np.uint64)

    def subtree_frontier_clocks(self):
        """The last published per-subtree clocks ``uint64[S, W]``."""
        with self._lock:
            published = self._published
        return None if published is None else np.asarray(published, dtype=np.uint64)

    def restore(self, clock) -> None:
        """Floor the frontier with a persisted fleet-min clock (a 2-D
        table floors at its row-wise minimum)."""
        arr = np.asarray(clock, dtype=np.uint64)
        if arr.ndim > 1:
            arr = arr.min(axis=0)
        with self._lock:
            self._floor = tuple(arr.reshape(-1).tolist())

    def forget(self, peer: str) -> None:
        """Drop a peer that left the roster."""
        with self._lock:
            self._peers.pop(peer, None)
            self._first_seen.pop(peer, None)

    # -- the auditor ----------------------------------------------------------

    def maybe_audit(self, batch, universe=None, peers=None) -> Optional[AuditReport]:
        """:meth:`audit` every ``audit_every``-th call (0 disables it)."""
        if self.audit_every <= 0:
            return None
        with self._lock:
            self._audit_rounds += 1
            due = self._audit_rounds % self.audit_every == 0
        return self.audit(batch, universe, peers=peers) if due else None

    def audit(self, batch, universe=None, peers=None, sample: Optional[int] = None) -> AuditReport:
        """One lattice self-check: sampled merge idempotence through the
        wire codec, frontier against the local and peer version vectors."""
        report = AuditReport()
        self._audit_merge_idempotence(batch, universe, report,
                                      self.audit_sample if sample is None else int(sample))
        self._audit_frontier(batch, report)
        with self._lock:
            self._audits += 1
            self._audit_checks += report.checks
            self._audit_violations += len(report.violations)
            if report.violations:
                self._last_violation = dict(report.violations[-1])
        return report

    def _audit_merge_idempotence(self, batch, universe, report, sample: int) -> None:
        from ..sync import digest as digest_mod
        from ..sync.delta import gather_blobs

        try:
            ref = digest_mod.digest_of(batch, universe)
        except TypeError:
            return
        n = int(ref.shape[0])
        k = min(int(sample), n)
        if k <= 0:
            return
        with self._lock:
            ids = np.asarray(sorted(self._rng.sample(range(n), k)), dtype=np.int64)
        try:
            sub = type(batch).from_wire(gather_blobs(batch, ids, universe), universe,
                                        device=_device_of(batch))
            merged = sub.merge(sub)
        except (TypeError, AttributeError):
            return
        got = digest_mod.digest_of(merged, universe)
        report.checks += k
        report.sampled += k
        report.sampled_ids = ids
        bad = ids[got != ref[ids]]
        if bad.size:
            report.violations.append({"plane": "merge_idempotence",
                                      "objects": ",".join(str(int(b)) for b in bad[:16]),
                                      "count": int(bad.size)})

    def _audit_frontier(self, batch, report) -> None:
        with self._lock:
            published_global = self._published_global
        if published_global is None:
            return
        svv = subtree_version_vectors(batch)
        if svv is not None and svv.shape[0]:
            # the fleet-min clock can never exceed the local version vector
            report.checks += 1
            local_vv = svv.max(axis=0)
            width = max(int(local_vv.shape[0]), len(published_global))
            fr, local = _align_rows([published_global, local_vv], width)
            if (fr > local).any():
                report.violations.append({"plane": "frontier_local",
                                          "frontier_max": int(fr.max(initial=0)),
                                          "local_max": int(local.max(initial=0))})
        fleet_min = np.asarray(published_global, dtype=np.uint64)
        now = self._clock()
        with self._lock:
            tracked = {p for p, st in self._peers.items() if st.clocks is not None}
        for peer, (vv, seen_ts) in sorted(self._conv().version_vectors().items()):
            if peer not in tracked or seen_ts is None or now - seen_ts > self.stale_after_s:
                continue
            report.checks += 1
            width = max(len(vv), int(fleet_min.shape[0]))
            fr, theirs = _align_rows([fleet_min, vv], width)
            if (fr > theirs).any():
                report.violations.append({"plane": "frontier_peer_vv", "peer": peer,
                                          "frontier_max": int(fr.max(initial=0)),
                                          "peer_vv_max": int(theirs.max(initial=0))})

    # -- snapshots ------------------------------------------------------------

    def snapshot(self) -> dict:
        """The published frontier, the aging view and the audit totals."""
        now = self._clock()
        with self._lock:
            published, published_global = self._published, self._published_global
            aging = {
                peer: {
                    "outstanding": {str(s): round(max(0.0, now - born), 6)
                                    for s, born in st.outstanding.items()},
                    "converged_age_s": (None if st.converged_ts is None
                                        else round(max(0.0, now - st.converged_ts), 6)),
                }
                for peer, st in self._peers.items()
            }
            window = sorted(self._resolved)
            resolved_total = self._resolved_total
            audit = {"checks": self._audit_checks, "violations": self._audit_violations,
                     "last_violation": self._last_violation}
        clocks = [list(row) for row in published] if published is not None else None
        return {
            "frontier": {"subtree_clocks": clocks,
                         "fleet_min": (list(published_global) if published_global is not None
                                       else None),
                         "subtrees": len(clocks) if clocks is not None else 0},
            "aging": {"peers": aging, "resolved_total": resolved_total,
                      "resolved_age_p50_s": window[len(window) // 2] if window else None,
                      "resolved_age_max_s": window[-1] if window else None},
            "audit": audit,
        }

    def gauges(self) -> dict:
        """The JAX tracker's registry view, as its event sites left it: the
        resolved ages (a log2 :class:`~crdt_tpu_torch.obs.metrics.
        Histogram`) and their count, the aging view at the last aging
        event (None before one), each peer's oldest outstanding age at its
        last observation, the last frontier's fields (None before one) and
        the audit runs, checks and violations."""
        with self._lock:
            return {"age_hist": self._age_hist.copy(), "resolved_total": self._resolved_total,
                    "aging": None if self._aging is None else dict(self._aging),
                    "peer_age": {p: st.age_gauge for p, st in self._peers.items()
                                 if st.age_gauge is not None},
                    "frontier": (None if self._frontier_gauges is None
                                 else dict(self._frontier_gauges)),
                    "audit_runs": self._audits, "checks": self._audit_checks,
                    "violations": self._audit_violations}

    def reset(self) -> None:
        with self._lock:
            self._age_hist = Histogram()
            self._aging = self._frontier_gauges = None
            self._audits = 0
            self._peers.clear()
            self._resolved.clear()
            self._resolved_total = 0
            self._first_seen.clear()
            self._floor = self._published = self._published_global = None
            self._audit_rounds = self._audit_checks = self._audit_violations = 0
            self._last_violation = None


def _zip_pad(a: tuple, b: tuple):
    """zip two counter rows, implied 0 past either end."""
    for i in range(max(len(a), len(b))):
        yield (a[i] if i < len(a) else 0), (b[i] if i < len(b) else 0)


_DEFAULT: Optional[StabilityTracker] = None
_DEFAULT_LOCK = threading.Lock()


def tracker() -> StabilityTracker:
    """The process-global stability tracker."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = StabilityTracker()
    return _DEFAULT


stability_tracker = tracker
