"""Replica states made on the device from the run's seed.

Every plane is in the program's device layout: counters biased into
int32 (unsigned ``u`` is held as ``u - 2**31``), ids int32 with ``EMPTY``.
The states are valid, reachable ORSWOT and Map states:

* each object (or map key) draws its members from a universe of its own,
  ``(base + k * stride) mod 2**24`` for slot number ``k``;
* replicas share a base of members, each present with ``present_p``, and
  each replica adds members of its own (``novel``), so the replicas have
  diverged as after a partition;
* a member's dot is one actor's counter ``offset[actor] + c`` with
  ``c < 100``: ``offset`` puts each vnode's counter where a long-lived
  cluster has it, spread over the whole u32 range;
* the actors of an object are the ``n_val`` vnodes of its preference
  list, the partition its key hashes to and the ones after it on the
  ring (``preflist_first``): only those coordinate its writes;
* replica 0 buffers removes that are one tick ahead of its clock: in an
  ORSWOT fleet on ``deferred_frac`` of the objects, already replayed
  against the member they cite, as ``apply`` leaves them.

Made with one ``torch.Generator`` on the device, in large calls, chunk by
chunk so that the transients stay small.
"""

from __future__ import annotations

import torch

EMPTY = -1
ZERO = -(2**31)
OFFSET_MAX = 2**32 - 2**24  # headroom for every later dot of an actor
CHUNK = 1 << 17


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def _ints(gen, hi, shape, device, lo=0):
    return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)


def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def biased(u: torch.Tensor) -> torch.Tensor:
    """Unsigned counters held in int64 → the biased int32 domain."""
    return (u + ZERO).to(torch.int32)


def actor_offsets(gen, a: int, device) -> torch.Tensor:
    return _ints(gen, OFFSET_MAX, (a,), device)


def preflist_first(gen, n: int, a: int, device) -> torch.Tensor:
    """Each object's first vnode: the partition of a ring of ``a`` its key
    hashes to."""
    return _ints(gen, a, (n,), device)


def preflist_actor(gen, first, n_val: int, a: int, shape, device) -> torch.Tensor:
    """Actors drawn from the preference lists ``first[i] + [0, n_val)``
    (mod ``a``), ``first`` broadcast against ``shape``."""
    return (first.reshape(first.shape + (1,) * (len(shape) - first.dim()))
            + _ints(gen, n_val, shape, device)) % a


def _member_planes(gen, offsets, ids_s, present, m_cap, device, first, n_val):
    """Dense ``(ids [n, m_cap], dots [n, m_cap, A])`` of members ``ids_s
    [n, S]`` where ``present``, each with a one-actor dot from the row's
    preference list."""
    n, s = ids_s.shape
    a = offsets.shape[0]
    actor = preflist_actor(gen, first, n_val, a, (n, s), device)
    counter = _ints(gen, 100, (n, s), device, lo=1)
    ids = torch.full((n, m_cap), EMPTY, dtype=torch.int32, device=device)
    ids[:, :s] = torch.where(present, ids_s, EMPTY).to(torch.int32)
    onehot = (torch.arange(a, device=device) == actor[..., None]) & present[..., None]
    dots = torch.full((n, m_cap, a), ZERO, dtype=torch.int32, device=device)
    dots[:, :s] = torch.where(onehot, biased(offsets[actor] + counter)[..., None],
                              torch.full((), ZERO, dtype=torch.int32, device=device))
    return ids, dots


def orswot_replicas(seed: int, device, *, n, a, m, d, r, n_val, base, novel, present_p,
                    deferred_frac, universe=False):
    """``r`` replica fleets of ``n`` ORSWOTs: a list of 5-tuples ``(clock,
    ids, dots, d_ids, d_clocks)``; with ``universe``, also each object's
    member universe and preference list ``(mbase [n], stride [n], first
    [n])``."""
    if base + r * novel > m:
        raise ValueError(f"members base + r*novel = {base + r * novel} exceed m={m}")
    gen = generator(seed, device)
    offsets = actor_offsets(gen, a, device)
    reps = [(torch.empty((n, a), dtype=torch.int32, device=device),
             torch.empty((n, m), dtype=torch.int32, device=device),
             torch.empty((n, m, a), dtype=torch.int32, device=device),
             torch.full((n, d), EMPTY, dtype=torch.int32, device=device),
             torch.full((n, d, a), ZERO, dtype=torch.int32, device=device))
            for _ in range(r)]
    universes = []
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        c = hi - lo
        mbase = _ints(gen, 1 << 24, (c, 1), device)
        stride = _ints(gen, 64, (c, 1), device, lo=1)
        first = preflist_first(gen, c, a, device)
        universes.append((mbase[:, 0], stride[:, 0], first))
        for rep, planes in enumerate(reps):
            slot_no = torch.cat([torch.arange(base, device=device),
                                 base + rep * novel + torch.arange(novel, device=device)])
            ids_s = (mbase + slot_no[None, :] * stride) % (1 << 24)
            present = torch.cat([_rand(gen, (c, base), device) < present_p,
                                 torch.ones((c, novel), dtype=torch.bool, device=device)], 1)
            ids, dots = _member_planes(gen, offsets, ids_s, present, m, device, first, n_val)
            clock = dots.amax(dim=1)
            if rep == 0 and deferred_frac > 0 and d > 0:
                actor = preflist_actor(gen, first, n_val, a, (c,), device)
                _plant_deferred(gen, (clock, ids, dots), planes, lo, hi, deferred_frac, actor,
                                device)
            planes[0][lo:hi] = clock
            planes[1][lo:hi] = ids
            planes[2][lo:hi] = dots
    if universe:
        return reps, tuple(torch.cat(x) for x in zip(*universes))
    return reps


def _plant_deferred(gen, chunk, planes, lo, hi, frac, actor, device):
    """A remove of each hit object's first live member, one tick ahead of
    the set clock on ``actor``: buffered, and already subtracted from the
    member (which is dropped when that empties it)."""
    clock, ids, dots = chunk
    c, a = clock.shape
    live = ids != EMPTY
    hit = (_rand(gen, (c,), device) < frac) & live.any(dim=1)
    slot = live.to(torch.uint8).argmax(dim=1)
    rows = torch.arange(c, device=device)
    member = ids[rows, slot]
    ahead_u = clock[rows, actor].to(torch.int64) - ZERO + 1
    planes[3][lo:hi, 0] = torch.where(hit, member, EMPTY)
    lane = torch.where(hit[:, None] & (torch.arange(a, device=device) == actor[:, None]),
                       biased(ahead_u)[:, None], torch.full((), ZERO, dtype=torch.int32,
                                                             device=device))
    planes[4][lo:hi, 0] = lane
    cut = hit & (dots[rows, slot, actor] != ZERO)
    dots[rows[cut], slot[cut], actor[cut]] = ZERO
    emptied = cut & (dots[rows, slot] == ZERO).all(dim=-1)
    ids[rows[emptied], slot[emptied]] = EMPTY


def map_replicas(seed: int, device, *, n, a, k, d, m, dv, r, n_val, base_keys, base_members,
                 novel_members, present_p, deferred_frac, clock_extra_frac):
    """``r`` replica fleets of ``n`` maps of sets: a list of ``(clock, keys,
    eclocks, (clock, ids, dots, d_ids, d_clocks), d_keys, d_clocks)``.

    Keys ``[0, base_keys)`` are shared (each present with ``present_p``);
    replica ``rep`` adds key ``base_keys + rep``.  Each present key holds
    a set built as an ORSWOT object, its entry clock the set's clock; the
    map clock joins the entry clocks and, on ``clock_extra_frac`` of the
    maps, a later dot of one actor (keys and members that actor's earlier
    dots made were removed).  Replica 0 buffers, on ``deferred_frac`` of
    its maps, a remove of replica 1's own key, and on ``deferred_frac`` of
    its keys a remove of replica 1's first own member, each one tick ahead
    of the clock on one actor."""
    used_keys = base_keys + r
    if used_keys > k or base_members + r * novel_members > m:
        raise ValueError("the replicas' keys or members exceed the capacities")
    gen = generator(seed, device)
    offsets = actor_offsets(gen, a, device)
    i32 = dict(dtype=torch.int32, device=device)
    reps = []
    for _ in range(r):
        reps.append((torch.empty((n, a), **i32), torch.full((n, k), EMPTY, **i32),
                     torch.full((n, k, a), ZERO, **i32),
                     (torch.full((n, k, a), ZERO, **i32), torch.full((n, k, m), EMPTY, **i32),
                      torch.full((n, k, m, a), ZERO, **i32), torch.full((n, k, dv), EMPTY, **i32),
                      torch.full((n, k, dv, a), ZERO, **i32)),
                     torch.full((n, d), EMPTY, **i32), torch.full((n, d, a), ZERO, **i32)))
    chunk = max(1, CHUNK // (k * 4))
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        c = hi - lo
        kbase = _ints(gen, 1 << 24, (c, 1), device)
        kstride = _ints(gen, 64, (c, 1), device, lo=1)
        key_ids = (kbase + torch.arange(used_keys, device=device)[None, :] * kstride) % (1 << 24)
        mbase = _ints(gen, 1 << 24, (c * used_keys, 1), device)
        mstride = _ints(gen, 64, (c * used_keys, 1), device, lo=1)
        first = preflist_first(gen, c, a, device)
        first_k = first.repeat_interleave(used_keys)
        for rep, planes in enumerate(reps):
            key_on = torch.zeros((c, used_keys), dtype=torch.bool, device=device)
            key_on[:, :base_keys] = _rand(gen, (c, base_keys), device) < present_p
            key_on[:, base_keys + rep] = True
            slot_no = torch.cat([torch.arange(base_members, device=device),
                                 base_members + rep * novel_members
                                 + torch.arange(novel_members, device=device)])
            mem_ids = (mbase + slot_no[None, :] * mstride) % (1 << 24)
            present = torch.cat([
                _rand(gen, (c * used_keys, base_members), device) < present_p,
                torch.ones((c * used_keys, novel_members), dtype=torch.bool, device=device)], 1)
            present &= key_on.reshape(-1, 1)
            ids, dots = _member_planes(gen, offsets, mem_ids, present, m, device, first_k,
                                       n_val)
            sclock = dots.amax(dim=1)
            vals = (sclock, ids, dots)
            if rep == 0 and deferred_frac > 0:
                hit = (_rand(gen, (c * used_keys,), device) < deferred_frac) & key_on.reshape(-1)
                table = (torch.full((c * used_keys, dv), EMPTY, **i32),
                         torch.full((c * used_keys, dv, a), ZERO, **i32))
                own1 = mbase[:, 0] + (base_members + novel_members) * mstride[:, 0]
                _plant_ahead(gen, hit, own1, sclock, table,
                             preflist_actor(gen, first_k, n_val, a, (c * used_keys,), device),
                             device)
                vals = vals + table
            for j, x in enumerate(vals):
                planes[3][j][lo:hi, :used_keys] = x.reshape(c, used_keys, *x.shape[1:])
            eclock = torch.where(key_on[..., None], sclock.reshape(c, used_keys, a),
                                 torch.full((), ZERO, **i32))
            keys = torch.where(key_on, key_ids, EMPTY).to(torch.int32)
            planes[1][lo:hi, :used_keys] = keys
            planes[2][lo:hi, :used_keys] = eclock
            mclock = eclock.amax(dim=1)
            extra = _rand(gen, (c,), device) < clock_extra_frac
            ea = preflist_actor(gen, first, n_val, a, (c,), device)
            later = biased(offsets[ea] + _ints(gen, 121, (c,), device, lo=100))
            rows = torch.arange(c, device=device)
            mclock[rows, ea] = torch.where(extra, torch.maximum(mclock[rows, ea], later),
                                           mclock[rows, ea])
            planes[0][lo:hi] = mclock
            if rep == 0 and deferred_frac > 0:
                hit = _rand(gen, (c,), device) < deferred_frac
                rm_key = (kbase[:, 0] + (base_keys + 1) * kstride[:, 0]) % (1 << 24)
                _plant_ahead(gen, hit, rm_key, mclock, (planes[4][lo:hi], planes[5][lo:hi]),
                             preflist_actor(gen, first, n_val, a, (c,), device), device)
    return reps


def _plant_ahead(gen, hit, cited, clock, table, actor, device):
    """Slot 0 of ``table = (d_ids [c, D], d_clocks [c, D, A])`` gets, where
    ``hit``, a remove of ``cited`` (an id this state does not hold) one
    tick ahead of ``clock`` on ``actor``."""
    c, a = clock.shape
    rows = torch.arange(c, device=device)
    ahead = biased(clock[rows, actor].to(torch.int64) - ZERO + 1)
    table[0][:, 0] = torch.where(hit, (cited % (1 << 24)).to(torch.int32), EMPTY)
    lane = hit[:, None] & (torch.arange(a, device=device) == actor[:, None])
    table[1][:, 0] = torch.where(lane, ahead[:, None],
                                 torch.full((), ZERO, dtype=torch.int32, device=device))
