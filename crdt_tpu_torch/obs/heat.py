"""Heat and placement: per-subtree traffic attribution, a Space-Saving
top-k sketch on the device, and a shard/ring placement planner (the port
of the JAX package's ``obs/heat.py``; its counters are
:meth:`HeatTracker.counts` here, and its gauges :meth:`HeatTracker.published`,
which :mod:`~crdt_tpu_torch.obs.publish` renders under the JAX names).

Every read, write and repair batch folds into per-subtree counters
aligned to :func:`~crdt_tpu_torch.obs.stability.subtree_layout` (a
scatter-add over ``id // span`` where the tracker lives) and into one
batched Space-Saving update (:func:`sketch_update`): in-batch duplicates
aggregate by a sort and segment sums, matched entries add their group
totals, unmatched groups enter at ``total + min(table)`` with that floor
as their error, and the top ``capacity`` of the pool stay.  The table
stays on the device between updates.  Decoded counts overestimate by at
most ``err``; ``count - err`` feeds the Zipf fit (:func:`zipf_fit`).
Ties keep the lower pool index, as ``jax.lax.top_k`` does: the pool is
ordered by a stable descending sort, never ``torch.topk``.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

CLASSES = ("reads", "writes", "repair")
DEFAULT_CAPACITY = 128
DEFAULT_HALFLIFE_S = 30.0
#: decoded ranks offered to the Zipf fit, and the fewest it fits on
ZIPF_FIT_RANKS = 32
MIN_FIT_RANKS = 6
HOT_RANKS = 8
#: update batches pad to a power of two with this floor
PAD_FLOOR = 8
#: virtual points per owner on the scored hash ring
RING_VNODES = 64


def _pad_pow2(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ids padded to a power of two (floor 8); padding weighs 0."""
    b = max(PAD_FLOOR, 1 << max(0, int(ids.size) - 1).bit_length())
    out = np.zeros(b, dtype=ids.dtype)
    out[:ids.size] = ids
    w = np.zeros(b, dtype=ids.dtype)
    w[:ids.size] = 1
    return out, w


def subtree_fold(ids: torch.Tensor, weights: torch.Tensor, subtrees: int,
                 span: int) -> torch.Tensor:
    """Per-subtree weight totals, ``segment = id // span``."""
    sub = torch.clamp(torch.div(ids, span, rounding_mode="floor"), 0, subtrees - 1)
    return torch.zeros(subtrees, dtype=weights.dtype, device=weights.device) \
        .index_add_(0, sub, weights)


def sketch_update(tab_ids, tab_counts, tab_errs, ids, weights):
    """One batched Space-Saving update of the table ``(ids, counts,
    errs)`` (each ``[capacity]``) by ``ids``/``weights`` (``[B]``)."""
    b, capacity = ids.shape[0], tab_ids.shape[0]
    sid, order = torch.sort(ids, stable=True)
    sw = weights[order]
    starts = torch.ones(b, dtype=torch.bool, device=ids.device)
    starts[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(starts, 0) - 1
    totals = torch.zeros(b, dtype=weights.dtype, device=ids.device).index_add_(0, seg, sw)
    first = torch.full((b,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=ids.device)
    first.scatter_reduce_(0, seg, torch.arange(b, device=ids.device), "amin")
    gid = sid[first.clamp(0, b - 1)]
    live = totals > 0
    hit = (tab_ids[:, None] == gid[None, :]) & live[None, :]
    grown = tab_counts + torch.where(hit, totals[None, :], 0).sum(dim=1)
    floor = grown.min()
    fresh = live & ~hit.any(dim=0)
    cand_counts = torch.where(fresh, totals + floor, -1)
    cand_errs = torch.where(fresh, floor, 0)
    top, idx = torch.sort(torch.cat([grown, cand_counts]), descending=True, stable=True)
    top, idx = top[:capacity], idx[:capacity]
    return (torch.cat([tab_ids, gid])[idx], top.clamp(min=0),
            torch.cat([tab_errs, cand_errs])[idx])


def zipf_fit(counts: Sequence[float]) -> Tuple[Optional[float], Optional[float]]:
    """Least-squares slope of ``log(count)`` against ``log(rank)`` over
    the positive counts: ``(s_hat, r2)``, or ``(None, None)`` below
    :data:`MIN_FIT_RANKS` ranks."""
    c = np.asarray([v for v in counts if v > 0], dtype=np.float64)
    if c.size < MIN_FIT_RANKS:
        return None, None
    c = np.sort(c)[::-1]
    x = np.log(np.arange(1, c.size + 1, dtype=np.float64))
    y = np.log(c)
    slope, intercept = np.polyfit(x, y, 1)
    ss_res = float(np.sum((y - (slope * x + intercept)) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    return float(-slope), 1.0 if ss_tot <= 0 else 1.0 - ss_res / ss_tot


def merge_hot(hot_lists: Sequence[Sequence[dict]]) -> List[dict]:
    """Join decoded sketches: counts and errors of one object sum, then
    re-rank."""
    acc: Dict[int, int] = {}
    err: Dict[int, int] = {}
    for hot in hot_lists:
        for h in hot:
            obj = int(h["obj"])
            acc[obj] = acc.get(obj, 0) + int(h["count"])
            err[obj] = err.get(obj, 0) + int(h.get("err", 0))
    ranked = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))
    return [{"obj": o, "count": c, "err": err[o]} for o, c in ranked]


def parse_plan(spec: str) -> Tuple[str, Dict[str, int]]:
    """``"mesh:8"`` → ``("mesh", {"shards": 8})``; ``"ring:5,k=3"`` →
    ``("ring", {"owners": 5, "k": 3})``; ValueError otherwise."""
    kind, sep, rest = spec.partition(":")
    kind = kind.strip().lower()
    try:
        if kind == "mesh" and sep:
            shards = int(rest.strip())
            if shards < 1:
                raise ValueError
            return "mesh", {"shards": shards}
        if kind == "ring" and sep:
            head, _, tail = rest.partition(",")
            owners, k = int(head.strip()), 2
            if tail:
                kk, _, kv = tail.partition("=")
                if kk.strip() != "k":
                    raise ValueError
                k = int(kv.strip())
            if owners < 1 or k < 1:
                raise ValueError
            return "ring", {"owners": owners, "k": k}
    except ValueError:
        pass
    raise ValueError("bad plan spec %r (want mesh:<shards> or ring:<owners>[,k=<k>])" % (spec,))


def _ring_hash(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


def _ring_owners(names: Sequence[str], subtrees: int, k: int) -> List[Tuple[str, ...]]:
    """subtree → its k distinct clockwise owners on a blake2b ring of
    :data:`RING_VNODES` points per owner."""
    points = sorted((_ring_hash("%s#%d" % (name, v)), name)
                    for name in names for v in range(RING_VNODES))
    hashes = [p[0] for p in points]
    owners: List[Tuple[str, ...]] = []
    for s in range(subtrees):
        at = bisect.bisect_right(hashes, _ring_hash("subtree-%d" % s))
        chosen: List[str] = []
        for off in range(len(points)):
            name = points[(at + off) % len(points)][1]
            if name not in chosen:
                chosen.append(name)
                if len(chosen) == k:
                    break
        owners.append(tuple(chosen))
    return owners


def _imbalance(loads: np.ndarray) -> float:
    mean = float(np.mean(loads))
    return 1.0 if mean <= 0 else float(np.max(loads)) / mean


def mesh_bounds(n: int, shards: int, granule: int | None = None) -> list:
    """Shard boundaries of ``mesh:<shards>`` over ``n`` objects: an even
    split, or with ``granule`` (a power of two) padded shards of
    ``ceil(ceil(n/shards)/granule) * granule`` rows clipped to ``n``."""
    if granule is None:
        return [int(round(s * n / shards)) for s in range(shards + 1)]
    g = int(granule)
    if g < 1 or (g & (g - 1)) != 0:
        raise ValueError(f"granule {granule!r} must be a positive power of two (a subtree span)")
    rows = -(-int(n) // int(shards))
    per = -(-rows // g) * g
    return [min(s * per, int(n)) for s in range(int(shards) + 1)]


def mesh_loads(heat, span: int, n: int, bounds) -> np.ndarray:
    """Per-subtree heat attributed to each shard of ``bounds``, spread
    evenly within each subtree of ``span`` objects (of ``n``)."""
    heat = np.asarray(heat, dtype=np.float64)
    loads = np.zeros(len(bounds) - 1, dtype=np.float64)
    for i in range(heat.size):
        lo, hi = i * span, min((i + 1) * span, n)
        for s in range(loads.size):
            ov = min(hi, bounds[s + 1]) - max(lo, bounds[s])
            if ov > 0:
                loads[s] += heat[i] * ov / max(hi - lo, 1)
    return loads


def score_plan(spec: str, heat, *, n: int, span: int, granule: int | None = None) -> dict:
    """Score one placement spec against a per-subtree heat vector: mesh
    plans by per-shard load and ``imbalance``, ring plans by per-owner
    ``skew`` and ``movement_frac`` (the heat-weighted share of replica
    assignments that move when the newest owner joins)."""
    kind, params = parse_plan(spec)
    heat = np.asarray(heat, dtype=np.float64)
    subtrees = int(heat.size)
    total = float(np.sum(heat))
    out = {"plan": spec, "kind": kind, "heat_total": round(total, 3),
           "granularity": {"subtrees": subtrees, "span": int(span), "objects": int(n)}}
    if granule is not None and kind != "mesh":
        raise ValueError("granule= only applies to mesh:<shards> plans")
    if kind == "mesh":
        shards = params["shards"]
        bounds = mesh_bounds(n, shards, granule)
        loads = mesh_loads(heat, span, n, bounds)
        out.update(shards=shards, loads=[round(float(v), 3) for v in loads],
                   max_load=round(float(np.max(loads)) if shards else 0.0, 3),
                   mean_load=round(float(np.mean(loads)) if shards else 0.0, 3),
                   imbalance=round(_imbalance(loads), 4))
        if granule is not None:
            out["granule"] = int(granule)
            out["bounds"] = [int(b) for b in bounds]
        return out
    owners = params["owners"]
    k = min(params["k"], owners)
    names = ["node-%d" % i for i in range(owners)]
    assign = _ring_owners(names, subtrees, k)
    loads = {name: 0.0 for name in names}
    for i, chosen in enumerate(assign):
        for name in chosen:
            loads[name] += float(heat[i]) / k
    moved = 0.0
    if owners > 1:
        prev = _ring_owners(names[:-1], subtrees, min(k, owners - 1))
        for i, chosen in enumerate(assign):
            moved += float(heat[i]) * len(set(chosen) - set(prev[i])) / k
    out.update(owners=owners, k=k, vnodes=RING_VNODES,
               loads={name: round(v, 3) for name, v in loads.items()},
               skew=round(_imbalance(np.asarray(list(loads.values()), dtype=np.float64)), 4),
               movement_frac=round(moved / total, 4) if total > 0 else 0.0)
    return out


def _rebin(old: np.ndarray, old_span: int, subtrees: int, span: int) -> np.ndarray:
    """Totals re-binned onto a wider span (old spans nest whole inside
    new ones: both are powers of ``TREE_K``)."""
    new = np.zeros(subtrees, old.dtype)
    for i in range(old.shape[0]):
        new[min(i * old_span // span, subtrees - 1)] += old[i]
    return new


class HeatTracker:
    """Per-node heat attribution: :meth:`record_reads` for served read
    batches, :meth:`record_writes` for op batches, :meth:`record_repair`
    for applied delta rows, :meth:`publish` on a round cadence.  The
    sketch table lives on ``device`` (default ``"cuda"``); ``clock``
    gives monotonic seconds."""

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 halflife_s: float = DEFAULT_HALFLIFE_S, clock=time.monotonic, device=None):
        self._lock = threading.Lock()
        self.device = resolve_device(device)
        self._clock = clock
        self._capacity = int(capacity)
        self._halflife_s = float(halflife_s)
        self._t0 = clock()
        self._n = 0
        self._subtrees = 0
        self._span = 1
        self._totals: Dict[str, np.ndarray] = {}
        self._ewma: Dict[str, np.ndarray] = {}
        self._rows = {cls: 0 for cls in CLASSES}
        self._mode_reads: Dict[str, int] = {}
        self._sketch = None  # (ids, counts, errs) on the device
        self._updates = 0
        self._last_publish = None  # (t, {cls: totals copy})
        self._published = None     # the gauges' view at the last publish

    def record_reads(self, obj_ids, n: int, mode: str = "eventual"):
        """One served read batch's object ids, under ``mode``."""
        self._record("reads", obj_ids, n, mode=mode)

    def record_writes(self, obj_ids, n: int):
        """One op batch's object ids."""
        self._record("writes", obj_ids, n)

    def record_repair(self, obj_ids, n: int):
        """One applied delta row set."""
        self._record("repair", obj_ids, n)

    def _record(self, cls: str, obj_ids, n: int, mode=None):
        ids = np.asarray(obj_ids).reshape(-1).astype(np.int64, copy=False)
        if ids.size == 0 or n <= 0:
            return
        pad_ids, w = _pad_pow2(ids)
        cols = torch.from_numpy(np.stack([pad_ids, w])).to(self.device)
        with self._lock:
            if int(n) > self._n:
                (self._n, self._subtrees, self._span, self._totals, self._ewma,
                 self._last_publish) = self._grow_layout(int(n))
            per = subtree_fold(cols[0], cols[1], self._subtrees, self._span).cpu().numpy()
            self._totals[cls] += per
            self._rows[cls] += int(ids.size)
            if mode is not None:
                self._mode_reads[mode] = self._mode_reads.get(mode, 0) + int(ids.size)
            self._sketch = sketch_update(*self._table(), cols[0], cols[1])
            self._updates += 1

    def _table(self):
        if self._sketch is not None:
            return self._sketch
        z = torch.zeros(self._capacity, dtype=torch.int64, device=self.device)
        return torch.full_like(z, -1), z, z.clone()

    def _grow_layout(self, n: int) -> tuple:
        """The layout state after growing to ``n > self._n`` objects
        (computed without writing to ``self``; the caller holds the lock)."""
        from .stability import subtree_layout

        subtrees, span = subtree_layout(n)
        if self._n == 0:
            return (n, subtrees, span, {c: np.zeros(subtrees, np.int64) for c in CLASSES},
                    {c: np.zeros(subtrees, np.float64) for c in CLASSES}, self._last_publish)
        if (subtrees, span) == (self._subtrees, self._span):
            return n, subtrees, span, self._totals, self._ewma, self._last_publish
        rebin = {c: _rebin(self._totals[c], self._span, subtrees, span) for c in CLASSES}
        ewma = {c: _rebin(self._ewma[c], self._span, subtrees, span) for c in CLASSES}
        last = self._last_publish
        if last is not None:
            last = (last[0], {c: _rebin(last[1][c], self._span, subtrees, span) for c in CLASSES})
        return n, subtrees, span, rebin, ewma, last

    def _decode_hot_locked(self) -> List[dict]:
        if self._sketch is None:
            return []
        ids, counts, errs = torch.stack(self._sketch).cpu().numpy()
        keep = np.flatnonzero((ids >= 0) & (counts > 0))
        order = keep[np.argsort(-counts[keep], kind="stable")]
        return [{"obj": int(ids[i]), "count": int(counts[i]), "err": int(errs[i])} for i in order]

    @staticmethod
    def _zipf(hot: List[dict]) -> Tuple[Optional[float], Optional[float]]:
        # the guaranteed counts (count - err), so tail churn drops out
        return zipf_fit([h["count"] - h["err"] for h in hot[:ZIPF_FIT_RANKS]])

    def publish(self):
        """Refresh the EWMA rates (half-life ``halflife_s``; the first
        publish seeds them with the lifetime mean rate) and record the
        gauges' view: the rates, the top :data:`HOT_RANKS` hot objects
        (a rank once published keeps its last value) and the Zipf fit (a
        fit that fails keeps the last one)."""
        with self._lock:
            if self._n == 0:
                return
            now = self._clock()
            totals = {c: self._totals[c].copy() for c in CLASSES}
            if self._last_publish is None:
                dt = max(now - self._t0, 1e-9)
                self._ewma = {c: totals[c] / dt for c in CLASSES}
            else:
                t0, prev = self._last_publish
                dt = max(now - t0, 1e-9)
                alpha = 1.0 - 0.5 ** (dt / self._halflife_s)
                self._ewma = {c: alpha * ((totals[c] - prev[c]) / dt)
                              + (1.0 - alpha) * self._ewma[c] for c in CLASSES}
            self._last_publish = (now, totals)
            hot = self._decode_hot_locked()
            prior = self._published or {"hot": {}, "zipf": None}
            fit = self._zipf(hot)
            self._published = {
                "rates": {c: self._ewma[c].copy() for c in CLASSES},
                "hot": {**prior["hot"], **{r: (h["obj"], h["count"])
                                           for r, h in enumerate(hot[:HOT_RANKS])}},
                "zipf": fit if fit[0] is not None else prior["zipf"]}

    def published(self) -> Optional[dict]:
        """The gauges as the last :meth:`publish` left them: ``rates``
        (per class, per subtree), ``hot`` (``{rank: (obj, count)}``) and
        ``zipf`` (``(s_hat, r2)`` or None); None before a publish."""
        with self._lock:
            pub = self._published
        return None if pub is None else {"rates": pub["rates"], "hot": dict(pub["hot"]),
                                         "zipf": pub["zipf"]}

    def counts(self) -> dict:
        """The counters now: per-class ``totals`` per subtree, reads by
        mode and the update batches folded."""
        with self._lock:
            return {"totals": {c: self._totals[c].tolist() for c in self._totals},
                    "reads_by_mode": dict(self._mode_reads), "updates": self._updates}

    def hot(self, k: int = HOT_RANKS) -> List[dict]:
        """Decoded top-k ``{"obj", "count", "err"}`` rows, hottest first."""
        with self._lock:
            return self._decode_hot_locked()[:k]

    def snapshot(self) -> dict:
        """Layout, per-class rows, per-subtree totals and rates, the hot
        list, the sketch's error bound and the Zipf fit."""
        with self._lock:
            hot = self._decode_hot_locked()
            s_hat, r2 = self._zipf(hot)
            sub = [{**{c: int(self._totals[c][i]) for c in CLASSES},
                    **{c + "_per_s": round(float(self._ewma[c][i]), 3) for c in CLASSES}}
                   for i in range(self._subtrees)]
            return {
                "layout": {"objects": self._n, "subtrees": self._subtrees, "span": self._span},
                "rows": dict(self._rows),
                "updates": self._updates,
                "reads_by_mode": dict(self._mode_reads),
                "subtree": sub,
                "hot": hot[:ZIPF_FIT_RANKS],
                "sketch": {"capacity": self._capacity,
                           "error_bound": max([h["err"] for h in hot], default=0)},
                "zipf": {"s_hat": s_hat, "r2": r2},
            }

    def _heat(self, rows: int) -> np.ndarray:
        """reads + writes + repair per subtree, zero-padded to ``rows``;
        the caller holds the lock."""
        out = np.zeros(rows, np.float64)
        for c in CLASSES:
            if c in self._totals:
                out[:self._subtrees] += self._totals[c]
        return out

    def heat_vector(self) -> np.ndarray:
        """reads + writes + repair per subtree."""
        with self._lock:
            return self._heat(self._subtrees)

    def plan_report(self, spec: str, granule: int | None = None) -> dict:
        """:func:`score_plan` of ``spec`` against this node's heat."""
        with self._lock:
            heat, n, span = self._heat(max(self._subtrees, 1)), max(self._n, 1), self._span
        return score_plan(spec, heat, n=n, span=span, granule=granule)

    def reset(self):
        with self._lock:
            self._n, self._subtrees, self._span = 0, 0, 1
            self._totals, self._ewma, self._mode_reads = {}, {}, {}
            self._rows = {c: 0 for c in CLASSES}
            self._sketch = None
            self._updates = 0
            self._last_publish = self._published = None
            self._t0 = self._clock()


_DEFAULTS: Dict[torch.device, HeatTracker] = {}
_DEFAULT_LOCK = threading.Lock()


def tracker(device=None) -> HeatTracker:
    """The process-global heat tracker of ``device`` (default the card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _DEFAULT_LOCK:
        if dev not in _DEFAULTS:
            _DEFAULTS[dev] = HeatTracker(device=dev)
        return _DEFAULTS[dev]


heat_tracker = tracker
