"""YCSB-style updates to ORSWOT sets, as op frames through the program's
op path (``PipelinedOpLoop``: frame decode, ``OpApplier``, the planes).

Set-up makes a pristine fleet F0 on the device and mints a pool of
frames against it on the host, in causal order.  Every op picks its
object from one scrambled Zipf law (YCSB's ``zipfian`` chooser), with no
cap per object: an add (``1 - rm_share`` of a frame) takes an actor from
the object's preference list and a member from the object's own
universe of ``member_universe`` ids, so no object outgrows its member
slots; a remove takes a member that a read of the object saw live, under
the clock of that read.  Reads lag one frame: a remove minted in frame
``f`` read the state at the start of frame ``f - 1``, so it covers what
the replica had then, and adds made since survive it (add wins).  The
frame at ``swap_offset`` of every ``swap_period`` is delivered after its
successor, whose adds on the same object and actor park until it lands.
Frames are encoded by a frozen copy of the op-frame codec.  The Zipf
ranks come from one stream for every seed, so every seed puts the same
number of ops on its busiest object; the seed scatters the ranks over
the objects and picks actors and members.

The window replays the pool in passes, each from a device clone of F0
(its time counted), in units of ``chunk_frames`` frames, each unit one
``run`` of the loop that ends with the planes synchronized; a swapped
pair is never split between units, so nothing is parked between them.
"""

from __future__ import annotations

import struct
import time
import zlib

import numpy as np
import torch

from .. import fleets
from . import Answers
from ..reference import scalar as ref_scalar

OP_ADD, OP_RM = 0, 1
_HEADER = struct.Struct("<BBIQ")
_FIXED = struct.Struct("<IH")
PROTOCOL_VERSION, FRAME_OPS = 1, 0x31


def encode_frame(kind, obj, actor, counter, member, rm_first: int, rm_clocks) -> bytes:
    """An op frame (protocol 1): the columns, then the clocks of the
    removes (rows ``rm_first`` on, ``rm_clocks [R, A]``) as sparse ``(row,
    actor, counter)`` triples."""
    b, a = kind.shape[0], rm_clocks.shape[1]
    r, lane = np.nonzero(rm_clocks)
    parts = [_FIXED.pack(b, a), kind.astype("<u1").tobytes(), obj.astype("<u8").tobytes(),
             actor.astype("<u2").tobytes(), counter.astype("<u8").tobytes(),
             member.astype("<i4").tobytes(), struct.pack("<I", r.shape[0]),
             (r + rm_first).astype("<u4").tobytes(), lane.astype("<u2").tobytes(),
             rm_clocks[r, lane].astype("<u8").tobytes()]
    payload = b"".join(parts)
    return _HEADER.pack(PROTOCOL_VERSION, FRAME_OPS, zlib.crc32(payload), len(payload)) + payload


#: the stream the Zipf ranks come from, the same for every seed: every
#: seed gets the same ranks, so the same number of ops on its busiest
#: object, scattered over other objects
RANK_SEED = 0x59CB


class Zipf:
    """Objects by rank ``k`` with weight ``k ** -theta`` over ``n``, the
    ranks scattered over the objects by a seeded permutation; the ranks
    themselves come from ``RANK_SEED``."""

    def __init__(self, rng, n: int, theta: float):
        w = np.arange(1, n + 1, dtype=np.float64) ** -theta
        self.cdf = np.cumsum(w)
        self.cdf /= self.cdf[-1]
        self.perm = rng.permutation(n)
        self.ranks = np.random.default_rng(RANK_SEED)

    def draw(self, size: int) -> np.ndarray:
        u = self.ranks.random(size)
        order = np.argsort(u)  # sorted needles walk the table in order
        rank = np.empty(size, np.int64)
        rank[order] = np.searchsorted(self.cdf, u[order])
        return self.perm[np.minimum(rank, self.cdf.shape[0] - 1)]


def _pick_bit(rng, bits: np.ndarray, u: int) -> np.ndarray:
    """A uniformly drawn set bit of each nonzero ``bits`` (slot number)."""
    count = np.zeros(bits.shape, np.int64)
    for k in range(u):
        count += (bits >> k) & 1
    target = (rng.random(bits.shape[0]) * count).astype(np.int64)
    out = np.zeros(bits.shape, np.int64)
    seen = np.zeros(bits.shape, np.int64)
    for k in range(u):
        on = ((bits >> k) & 1).astype(bool)
        out = np.where(on & (seen == target), k, out)
        seen += on
    return out


class Pool:
    """The minted frames (delivery order) and each frame's ops (minting
    order), with the counts a correct fold of each prefix gives."""

    def __init__(self, frames, causal, parked, pairs):
        self.frames = frames
        self.causal = causal
        self.parked = parked  # parked adds per frame, credited to the later frame of a pair
        self.pairs = pairs


def _bits_of(obj: np.ndarray, k: np.ndarray):
    """``(objects ascending, OR of 1 << k over each object's rows)``."""
    order = np.argsort(obj, kind="stable")
    so = obj[order]
    starts = np.nonzero(np.r_[True, so[1:] != so[:-1]])[0]
    return so[starts], np.bitwise_or.reduceat(np.int64(1) << k[order], starts)


def _lookup(table, obj: np.ndarray) -> np.ndarray:
    """The bits ``table`` (from :func:`_bits_of`) holds for each ``obj``,
    0 where it has none."""
    keys, bits = table
    if keys.shape[0] == 0:
        return np.zeros(obj.shape, np.int64)
    i = np.minimum(np.searchsorted(keys, obj), keys.shape[0] - 1)
    return np.where(keys[i] == obj, bits[i], 0)


def swap_pairs(mix: dict) -> set:
    """Minting positions ``f`` whose frame is delivered after frame ``f + 1``."""
    return {f for f in range(mix["pool_frames"] - 1)
            if f % mix["swap_period"] == mix["swap_offset"]}


def mint(seed: int, clock: np.ndarray, live: np.ndarray, mbase: np.ndarray,
         stride: np.ndarray, first: np.ndarray, n_val: int, mix: dict) -> Pool:
    """The frame pool against F0's ``clock`` (unsigned ``[N, A]``), its
    live slot numbers ``live`` (bitmask per object), the member universes
    ``(mbase + k * stride) mod 2**24`` and the preference lists ``first +
    [0, n_val)`` (mod A)."""
    rng = np.random.default_rng([int(seed), 0x77])
    n, a = clock.shape
    clock = clock.astype(np.uint64)
    flat = clock.reshape(-1)
    live = live.astype(np.int64)
    u = mix["member_universe"]
    zipf = Zipf(rng, n, mix["zipf_theta"])
    ops, n_frames = mix["ops_per_frame"], mix["pool_frames"]
    n_rm = int(round(ops * mix["rm_share"]))
    n_add = ops - n_rm
    pairs = swap_pairs(mix)
    rm_objs = [zipf.draw(n_rm) for _ in range(n_frames)]
    snap = {0: (clock[rm_objs[0]], live[rm_objs[0]])}
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    added_before = empty
    causal, parked, prev_keys = [], [], None
    for f in range(n_frames):
        if f + 1 < n_frames:  # what frame f + 1's removes read: the start of frame f
            snap[f + 1] = (clock[rm_objs[f + 1]], live[rm_objs[f + 1]])
        obj = zipf.draw(n_add)
        actor = (first[obj] + rng.integers(0, n_val, n_add)) % a
        k = rng.integers(0, u, n_add)
        member = ((mbase[obj] + k * stride[obj]) % (1 << 24)).astype(np.int32)
        key = obj * a + actor
        order = np.argsort(key, kind="stable")
        sk = key[order]
        start = np.r_[True, sk[1:] != sk[:-1]]
        first_of = np.nonzero(start)[0]
        rank = np.arange(n_add) - first_of[np.cumsum(start) - 1]
        counter = np.empty(n_add, np.uint64)
        counter[order] = flat[sk] + (rank + 1).astype(np.uint64)
        ends = np.r_[first_of[1:], n_add] - 1
        flat[sk[ends]] = counter[order][ends]
        added = _bits_of(obj, k)
        live[added[0]] |= added[1]

        rm_obj = rm_objs[f]
        rm_clock, seen = snap.pop(f)
        seen = np.where(seen != 0, seen, np.int64(1) << rng.integers(0, u, n_rm))
        rm_k = _pick_bit(rng, seen, u)
        rm_member = ((mbase[rm_obj] + rm_k * stride[rm_obj]) % (1 << 24)).astype(np.int32)
        # a member re-added since the read keeps its newer dots
        kept = _lookup(added_before, rm_obj) | _lookup(added, rm_obj)
        np.bitwise_and.at(live, rm_obj, ~((np.int64(1) << rm_k) & ~kept))
        added_before = added
        keys = np.unique(key)
        late = f - 1 in pairs  # delivered before frame f - 1
        parked.append(int(np.isin(key, prev_keys).sum()) if late else 0)
        prev_keys = keys
        causal.append((obj, actor, counter, member, rm_obj, rm_member, rm_clock))
    frames = []
    for f in range(len(causal)):
        g = f + 1 if f in pairs else f - 1 if f - 1 in pairs else f
        obj, actor, counter, member, rm_obj, rm_member, rm_clock = causal[g]
        na, nr = obj.shape[0], rm_obj.shape[0]
        kind = np.r_[np.full(na, OP_ADD, np.uint8), np.full(nr, OP_RM, np.uint8)]
        frames.append(encode_frame(kind, np.r_[obj, rm_obj], np.r_[actor, np.zeros(nr, np.int64)],
                                   np.r_[counter, np.zeros(nr, np.uint64)],
                                   np.r_[member, rm_member], na, rm_clock))
    return Pool(frames, causal, parked, pairs)


def units(n_frames: int, chunk: int, pairs: set) -> list:
    """The pool's frames as ``(lo, hi)`` units of ``chunk`` frames, a unit
    that would end between the two frames of a swapped pair taking the
    second as well."""
    out, lo = [], 0
    while lo < n_frames:
        hi = min(n_frames, lo + chunk)
        if hi - 1 in pairs and hi < n_frames:
            hi += 1
        out.append((lo, hi))
        lo = hi
    return out


def reference_states(f0: dict, pool: Pool, n_frames: int) -> dict:
    """Each sampled object's canonical state after the first ``n_frames``
    frames of a pass, by the scalar op path (`orswot.rs:64-84`) from its
    F0 state (``f0``: object → :class:`~portbench.reference.scalar.Orswot`,
    consumed), ops applied in the order they were minted."""
    objs = np.fromiter(f0, np.int64)
    for f in range(n_frames):
        obj, actor, counter, member, rm_obj, rm_member, rm_clock = pool.causal[f]
        for i in np.nonzero(np.isin(obj, objs))[0].tolist():
            f0[int(obj[i])].apply_add(int(actor[i]), int(counter[i]), int(member[i]))
        for i in np.nonzero(np.isin(rm_obj, objs))[0].tolist():
            clock = {x: int(c) for x, c in enumerate(rm_clock[i]) if c}
            f0[int(rm_obj[i])].apply_remove(int(rm_member[i]), clock)
    return {o: s.canonical() for o, s in f0.items()}


class Cell:
    """The write cell: F0, the frame pool, and the program's op loop."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from crdt_tpu_torch import CrdtConfig, OrswotBatch, PipelinedOpLoop, Universe
        from crdt_tpu_torch.error import CapacityOverflowError

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        sizes = cfg["sizes"]
        (planes,), (mbase, stride, first) = fleets.orswot_replicas(
            seed, device, n=sizes["objects"], a=sizes["num_actors"],
            m=sizes["member_capacity"], d=sizes["deferred_capacity"], r=1, n_val=cfg["n_val"],
            **cfg["fleet"], universe=True)
        self.f0 = planes
        self.universe = Universe.identity(CrdtConfig.gpu_default(
            num_actors=sizes["num_actors"], member_capacity=sizes["member_capacity"],
            deferred_capacity=sizes["deferred_capacity"]))
        self._batch = OrswotBatch
        self._loop_cls = PipelinedOpLoop
        self._overflow = CapacityOverflowError
        u = mix["member_universe"]
        ids = planes[1]
        slots = (mbase[:, None] + torch.arange(u, device=device)[None, :] * stride[:, None]) \
            % (1 << 24)
        live = ((ids[:, None, :] == slots[:, :, None]).any(dim=-1).to(torch.int64)
                << torch.arange(u, device=device)).sum(dim=-1)
        host = [x.cpu().numpy() for x in (planes[0], live, mbase, stride, first)]
        clock_u = (host[0].astype(np.int64) + 2**31).astype(np.uint64)
        self.pool = mint(seed, clock_u, *host[1:], cfg["n_val"], mix)
        self.units = units(len(self.pool.frames), mix["chunk_frames"], self.pool.pairs)
        self.ops_per_frame = mix["ops_per_frame"]
        self.loop = None
        self.out = None
        self.delivered = 0

    def _clone_f0(self):
        return self._batch(*(x.clone() for x in self.f0))

    def _frames(self, unit: int) -> list:
        lo, hi = self.units[unit]
        return self.pool.frames[lo:hi]

    def warm(self) -> None:
        """One short frame, the first ``warm_ops`` ops of frame 0 (adds and
        removes in the frame's proportion), from a clone of F0: every
        kernel of the window's path runs once."""
        obj, actor, counter, member, rm_obj, rm_member, rm_clock = self.pool.causal[0]
        na = self.mix["warm_ops"] * obj.shape[0] // self.ops_per_frame
        nr = self.mix["warm_ops"] - na
        kind = np.r_[np.full(na, OP_ADD, np.uint8), np.full(nr, OP_RM, np.uint8)]
        frame = encode_frame(kind, np.r_[obj[:na], rm_obj[:nr]],
                             np.r_[actor[:na], np.zeros(nr, np.int64)],
                             np.r_[counter[:na], np.zeros(nr, np.uint64)],
                             np.r_[member[:na], rm_member[:nr]], na, rm_clock[:nr])
        self._loop_cls(self.universe).run(self._clone_f0(), [frame])

    def window(self, seconds: float, run=None) -> dict:
        """Replay the pool in passes for ``seconds``; ``run`` replaces the
        loop's ``run`` (the faults and the control)."""
        self.loop = self._loop_cls(self.universe)
        run = run or self.loop.run
        stats = {"applied": 0, "duplicates": 0, "still_parked": 0, "parse_s": 0.0,
                 "overflows": 0}
        unit_walls, passes, unit, batch, frames, lost = [], 0, 0, None, 0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            t = time.perf_counter()
            if unit == 0:
                batch = self._clone_f0()
            todo = self._frames(unit)
            try:
                batch, st = run(batch, todo)
            except self._overflow:
                stats["overflows"] += 1
                lost = len(todo)
                break
            unit_walls.append(time.perf_counter() - t)
            frames += len(todo)
            for k in ("applied", "duplicates"):
                stats[k] += st[k]
            stats["still_parked"] = st["still_parked"]
            stats["parse_s"] += st["stage_s"]["parse"]
            unit += 1
            if unit == len(self.units):
                unit, passes = 0, passes + 1
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t0
        self.out = batch
        self.delivered = self.units[unit - 1][1] if unit else len(self.pool.frames)
        ops = frames * self.ops_per_frame
        return {"window_s": window_s, "frames": frames, "ops": ops,
                "attempted": ops + lost * self.ops_per_frame,
                "failed": max(0, ops - stats["applied"]) + lost * self.ops_per_frame,
                "unit_walls": unit_walls, "passes": passes, **stats,
                "counts": dict(self.loop.applier.counts)}

    def expected_parked(self, passes: int) -> int:
        """Adds parked by ``passes`` whole passes and the frames delivered
        since."""
        return passes * sum(self.pool.parked) + sum(self.pool.parked[:self.delivered])

    def traced(self, tracer) -> dict:
        """``traced_units`` units from the start of a pass under ``tracer``,
        from a clone of F0 made before it starts."""
        batch = self._clone_f0()
        loop = self._loop_cls(self.universe)
        n = 0
        with tracer:
            for unit in range(self.mix["traced_units"]):
                batch, st = loop.run(batch, self._frames(unit))
                n += st["frames"]
        return {"frames": n}

    def end_to_end(self, res: dict) -> dict:
        return {"write_rate": res["ops"] / res["window_s"]}

    def checks(self, seed: int, res: dict) -> list:
        """``(name, value, limit)``: the final planes against the scalar op
        path on the sampled objects, and the loop's counts against the
        pool's."""
        whole = self.delivered == len(self.pool.frames)
        parked = self.expected_parked(res["passes"] - whole)
        counts = res["counts"]
        rows = self.sample(seed)
        got = self.judged(rows)
        want = reference_states(self.f0_rows(rows), self.pool, self.delivered)
        differ = sum(got[o] != want[o] for o in rows.tolist())
        return [("rows_differing", differ, 0),
                ("applied_gap", abs(res["ops"] - res["applied"]), 0),
                ("duplicates", res["duplicates"], 0),
                ("parked_gap", abs(counts["parked"] - parked), 0),
                ("released_gap", abs(counts["released"] - parked), 0),
                ("still_parked", res["still_parked"], 0),
                ("overflows", res["overflows"], 0)]

    def sample(self, seed: int) -> np.ndarray:
        """The objects compared: the ``hot_sample`` most written in the
        compared prefix, and ``sample`` more drawn from the seed."""
        n = self.f0[0].shape[0]
        touched = np.concatenate([np.r_[c[0], c[4]] for c in self.pool.causal[:self.delivered]])
        objs, counts = np.unique(touched, return_counts=True)
        hot = objs[np.argsort(-counts, kind="stable")[:self.mix["hot_sample"]]]
        rng = np.random.default_rng([int(seed), 0x5A])
        pick = rng.choice(n, min(n, self.mix["sample"]), replace=False)
        return np.unique(np.r_[hot, pick])

    def judged(self, rows: np.ndarray) -> dict:
        """The final state of each object of ``rows``, canonical; frees the
        rest of the program's state."""
        out, self.out = self.out, None
        if isinstance(out, Answers):
            return out.at(rows)
        planes = (out.clock, out.ids, out.dots, out.d_ids, out.d_clocks)
        return {o: s.canonical() for o, s in self._states(planes, rows).items()}

    def f0_rows(self, rows: np.ndarray, bits: int | None = None) -> dict:
        """F0's objects ``rows`` as scalar states; with ``bits``, their
        counters cut to that width (the control)."""
        return self._states(self.f0, rows, bits)

    def _states(self, planes, rows: np.ndarray, bits=None) -> dict:
        idx = torch.as_tensor(rows, device=self.device)
        objs = ref_scalar.orswots(*(x[idx].cpu().numpy() for x in planes), bits=bits)
        return dict(zip(rows.tolist(), objs))
