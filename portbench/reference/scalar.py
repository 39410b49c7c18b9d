"""Plain per-object ORSWOTs and Maps of ORSWOTs: the yardstick of the map
rejoin cell and of the write cell.

A frozen copy of the scalar reference path, one object at a time over
Python dicts of unsigned counters: the ORSWOT op path (`orswot.rs:64-84`),
merge, causal truncate and deferred replay (`orswot.rs:89-172,195-243`)
and the Map merge with reset-remove (`map.rs:131-158,192-269,325-350`),
including the Rust reference's order in the Map merge (the other side's
deferred removes are replayed against the entries before they are
replaced, so only their buffering lasts, `map.rs:256-260`).  A vector clock is a dict
``actor -> counter`` with no zero counters.  It imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np


def _leq(a: dict, b: dict) -> bool:
    return all(b.get(x, 0) >= c for x, c in a.items())


def _subtract(a: dict, b: dict) -> None:
    """Forget each actor of ``a`` that ``b`` holds at or past it (`vclock.rs:236-242`)."""
    for x, c in b.items():
        if x in a and c >= a[x]:
            del a[x]


def _join(a: dict, b: dict) -> None:
    for x, c in b.items():
        if a.get(x, 0) < c:
            a[x] = c


def _common(a: dict, b: dict) -> dict:
    return {x: c for x, c in a.items() if b.get(x, 0) == c}


def _key(clock: dict) -> tuple:
    return tuple(sorted(clock.items()))


def _sub(a: dict, b: dict) -> dict:
    out = dict(a)
    _subtract(out, b)
    return out


class Orswot:
    __slots__ = ("clock", "entries", "deferred")

    def __init__(self, clock=None, entries=None, deferred=None):
        self.clock = clock or {}
        self.entries = entries or {}
        self.deferred = deferred or {}

    def clone(self) -> "Orswot":
        return Orswot(dict(self.clock), {m: dict(c) for m, c in self.entries.items()},
                      {k: set(v) for k, v in self.deferred.items()})

    def apply_add(self, actor: int, counter: int, member) -> None:
        if self.clock.get(actor, 0) >= counter:
            return
        _join(self.entries.setdefault(member, {}), {actor: counter})
        self.clock[actor] = counter
        self.apply_deferred()

    def apply_remove(self, member, clock: dict) -> None:
        if not _leq(clock, self.clock):
            self.deferred.setdefault(_key(clock), set()).add(member)
        if member in self.entries:
            dots = self.entries.pop(member)
            _subtract(dots, clock)
            if dots:
                self.entries[member] = dots

    def apply_deferred(self) -> None:
        pending, self.deferred = self.deferred, {}
        for key, members in pending.items():
            for m in members:
                self.apply_remove(m, dict(key))

    def merge(self, other: "Orswot") -> None:
        keep = {}
        for m, dots in self.entries.items():
            if m not in other.entries:
                if not _leq(dots, other.clock):
                    keep[m] = dict(dots)
                continue
            mine, theirs = dict(dots), dict(other.entries[m])
            common = _common(mine, theirs)
            _subtract(mine, common)
            _subtract(theirs, common)
            _subtract(mine, other.clock)
            _subtract(theirs, self.clock)
            _join(common, mine)
            _join(common, theirs)
            if common:
                keep[m] = common
        for m, dots in other.entries.items():
            if m not in self.entries:
                novel = _sub(dots, self.clock)
                if novel:
                    keep[m] = novel
        for key, members in list(other.deferred.items()):
            self.deferred[key] = self.deferred.get(key, set()) | members
        self.entries = keep
        _join(self.clock, other.clock)
        self.apply_deferred()

    def truncate(self, clock: dict) -> None:
        self.merge(Orswot(dict(clock)))
        _subtract(self.clock, clock)
        for dots in self.entries.values():
            _subtract(dots, clock)

    def canonical(self) -> tuple:
        return (_key(self.clock),
                tuple(sorted((m, _key(d)) for m, d in self.entries.items())),
                frozenset((k, m) for k, ms in self.deferred.items() for m in ms))

    def sizes(self) -> tuple:
        """``(members, buffered removes)`` the state holds."""
        return len(self.entries), sum(len(v) for v in self.deferred.values())


class Map:
    """A map of ORSWOTs: ``entries`` maps a key to ``[entry clock, set]``."""

    __slots__ = ("clock", "entries", "deferred")

    def __init__(self, clock=None, entries=None, deferred=None):
        self.clock = clock or {}
        self.entries = entries or {}
        self.deferred = deferred or {}

    def apply_rm(self, key, clock: dict) -> None:
        if not _leq(clock, self.clock):
            self.deferred.setdefault(_key(clock), set()).add(key)
        if key in self.entries:
            eclock, val = self.entries.pop(key)
            _subtract(eclock, clock)
            if eclock:
                val.truncate(clock)
                self.entries[key] = [eclock, val]

    def apply_deferred(self) -> None:
        pending, self.deferred = self.deferred, {}
        for key, keys in pending.items():
            for k in keys:
                self.apply_rm(k, dict(key))

    def merge(self, other: "Map") -> None:
        keep = {}
        for k, (eclock, val) in self.entries.items():
            if k not in other.entries:
                mine = _sub(eclock, other.clock)
                if mine:
                    val = val.clone()
                    val.truncate(_sub(other.clock, mine))
                    keep[k] = [mine, val]
                continue
            o_eclock, o_val = other.entries[k]
            mine, theirs = dict(eclock), dict(o_eclock)
            common = _common(mine, theirs)
            _subtract(mine, common)
            _subtract(theirs, common)
            _subtract(mine, other.clock)
            _subtract(theirs, self.clock)
            _join(common, mine)
            _join(common, theirs)
            if common:
                val = val.clone()
                val.merge(o_val.clone())
                deleters = dict(mine)
                _join(deleters, theirs)
                _subtract(deleters, common)
                val.truncate(deleters)
                keep[k] = [common, val]
        for k, (eclock, val) in other.entries.items():
            if k not in self.entries:
                novel = _sub(eclock, self.clock)
                if novel:
                    val = val.clone()
                    val.truncate(_sub(self.clock, novel))
                    keep[k] = [novel, val]
        for key, keys in list(other.deferred.items()):
            for k in keys:
                self.apply_rm(k, dict(key))
        self.entries = keep
        _join(self.clock, other.clock)
        self.apply_deferred()

    def canonical(self) -> tuple:
        return (_key(self.clock),
                tuple(sorted((k, _key(e), v.canonical()) for k, (e, v) in self.entries.items())),
                frozenset((c, k) for c, ks in self.deferred.items() for k in ks))

    def overflows(self, k_cap: int, d_cap: int, m_cap: int, dv_cap: int) -> bool:
        """Whether the state outgrows the program's slot capacities."""
        if len(self.entries) > k_cap or sum(len(v) for v in self.deferred.values()) > d_cap:
            return True
        return any(m > m_cap or dv > dv_cap
                   for m, dv in (v.sizes() for _, v in self.entries.values()))


def join(replicas: list, caps: tuple):
    """The anti-entropy join of one object's replica states: the left fold
    of merges, then the self-merge that flushes buffered removes.
    Returns ``(state, overflow)``."""
    acc = replicas[0]
    for nxt in replicas[1:]:
        acc.merge(nxt)
    acc.merge(acc)
    return acc, acc.overflows(*caps)


# -- the program's planes, one object a row -----------------------------------


def unsigned(x: np.ndarray, bits: int | None = None) -> np.ndarray:
    """Biased int32 counters as unsigned ints; with ``bits``, cut to that
    many low bits (the control's narrower counters)."""
    u = x.astype(np.int64) + 2**31
    return u & ((1 << bits) - 1) if bits else u


def _clocks(plane: np.ndarray) -> list:
    """One dict per row of ``plane [R, A]``."""
    out = [{} for _ in range(plane.shape[0])]
    r, a = np.nonzero(plane)
    for i, x, c in zip(r.tolist(), a.tolist(), plane[r, a].tolist()):
        out[i][x] = c
    return out


def _table(ids: np.ndarray, clocks: np.ndarray) -> list:
    """``[(id, clock dict)]`` of the live slots of each row of ``ids [R, S]``,
    ``clocks [R, S, A]``."""
    r_, s_ = ids.shape
    flat = _clocks(clocks.reshape(r_ * s_, -1))
    live = ids != -1
    return [[(int(ids[i, j]), flat[i * s_ + j]) for j in np.nonzero(live[i])[0].tolist()]
            for i in range(r_)]


def orswots(clock, ids, dots, d_ids, d_clocks, bits=None) -> list:
    """One :class:`Orswot` per row of numpy planes (counters biased)."""
    clocks = _clocks(unsigned(clock, bits))
    members = _table(ids, unsigned(dots, bits))
    deferred = _table(d_ids, unsigned(d_clocks, bits))
    out = []
    for c, mem, dfr in zip(clocks, members, deferred):
        table = {}
        for m, dc in dfr:
            table.setdefault(_key(dc), set()).add(m)
        out.append(Orswot(c, {m: d for m, d in mem if d}, table))
    return out


def maps(state, bits=None) -> list:
    """One :class:`Map` per row of a map state's numpy planes ``(clock,
    keys, entry clocks, (the nested sets' five planes), d_keys,
    d_clocks)``."""
    clock, keys, eclocks, vals, d_keys, d_clocks = state
    n, k = keys.shape
    sets = orswots(*(v.reshape(n * k, *v.shape[2:]) for v in vals), bits=bits)
    clocks = _clocks(unsigned(clock, bits))
    entries = _table(keys, unsigned(eclocks, bits))
    deferred = _table(d_keys, unsigned(d_clocks, bits))
    out = []
    for i, (c, ent, dfr) in enumerate(zip(clocks, entries, deferred)):
        slot = {int(x): j for j, x in enumerate(keys[i].tolist()) if x != -1}
        table = {}
        for key, dc in dfr:
            table.setdefault(_key(dc), set()).add(key)
        out.append(Map(c, {key: [e, sets[i * k + slot[key]]] for key, e in ent if e}, table))
    return out
