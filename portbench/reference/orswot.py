"""Plain PyTorch ORSWOT merge: the yardstick the rejoin cells are held to.

A frozen copy of the port's plain tile merge (its ``merge_reference``),
which follows `orswot.rs:89-156` over whole slot axes: member alignment
by id compares, the three-way dot rule, deferred union with keep-first
dedup, clock join, deferred replay, retention of still-ahead rows, then
canonical compaction (members by ascending id, deferred rows in
first-occurrence order).  It imports nothing of the program.

Planes are the program's device layout, counters biased into int32
(``x ^ 0x8000_0000``, so unsigned order is signed order and counter 0 is
``ZERO``); ids are int32 with ``EMPTY = -1``.
"""

from __future__ import annotations

import torch

EMPTY = -1
ZERO = -(2**31)
INT32_MAX = 2**31 - 1


def _zt(x):
    return torch.full((), ZERO, dtype=torch.int32, device=x.device)


def _sub(a, b):
    return torch.where(a > b, a, _zt(a))


def _nonempty(clock):
    return (clock != ZERO).any(dim=-1)


def _align_against(ids_a, dots_a, ids_b, dots_b):
    valid_a = ids_a != EMPTY
    match = valid_a[..., :, None] & (ids_a[..., :, None] == ids_b[..., None, :])
    e2 = torch.where(match[..., None], dots_b[..., None, :, :], _zt(dots_a)).amax(dim=-2)
    return e2, match.any(dim=-2)


def _merge_rule(e1, e2, p1, p2, valid, self_clock, other_clock):
    sc = self_clock[..., None, :]
    oc = other_clock[..., None, :]
    z = _zt(e1)
    common = torch.where(e1 == e2, e1, z)
    c1 = _sub(_sub(e1, common), oc)
    c2 = _sub(_sub(e2, common), sc)
    out_both = torch.maximum(common, torch.maximum(c1, c2))
    keep1 = ~(e1 <= oc).all(dim=-1)
    out_only1 = torch.where(keep1[..., None], e1, z)
    out_only2 = _sub(e2, sc)
    both = (p1 & p2)[..., None]
    only1 = (p1 & ~p2)[..., None]
    out = torch.where(both, out_both, torch.where(only1, out_only1, out_only2))
    return torch.where(valid[..., None], out, z)


def _select(sel, payload_ids, payload_clocks):
    ids = torch.where(sel, payload_ids[..., None, :] + 1, 0).sum(dim=-1) - 1
    clocks = torch.where(sel[..., None], payload_clocks[..., None, :, :],
                         _zt(payload_clocks)).amax(dim=-2)
    return ids.to(torch.int32), clocks


def _rank_select(keys, live, payload_ids, payload_clocks, cap):
    smaller = live[..., :, None] & live[..., None, :] & (keys[..., None, :] < keys[..., :, None])
    rank = smaller.sum(dim=-1)
    k = torch.arange(cap, device=keys.device)
    sel = live[..., None, :] & (rank[..., None, :] == k[:, None])
    ids, clocks = _select(sel, payload_ids, payload_clocks)
    return ids, clocks, live.sum(dim=-1) > cap


def _rank_select_slots(live, payload_ids, payload_clocks, cap):
    live_i = live.to(torch.int64)
    rank = live_i.cumsum(dim=-1) - live_i
    k = torch.arange(cap, device=live.device)
    sel = live[..., None, :] & (rank[..., None, :] == k[:, None])
    ids, clocks = _select(sel, payload_ids, payload_clocks)
    return ids, clocks, live_i.sum(dim=-1) > cap


def _dedup_live(d_ids, d_clocks):
    d_valid = d_ids != EMPTY
    same = (
        d_valid[..., :, None] & d_valid[..., None, :]
        & (d_ids[..., :, None] == d_ids[..., None, :])
        & (d_clocks[..., :, None, :] == d_clocks[..., None, :, :]).all(dim=-1)
    )
    dn = d_ids.shape[-1]
    earlier = torch.ones((dn, dn), dtype=torch.bool, device=d_ids.device).tril(-1)
    return d_valid & ~(same & earlier).any(dim=-1)


def _replay_rm(slot_ids, d_ids, d_live, d_clocks, like):
    match = (slot_ids[..., :, None] == d_ids[..., None, :]) & d_live[..., None, :]
    return torch.where(match[..., None], d_clocks[..., None, :, :], _zt(like)).amax(dim=-2)


def merge(sa, sb, m_cap: int, d_cap: int):
    """Pairwise merge of two states ``(clock [T,A], ids [T,M], dots [T,M,A],
    d_ids [T,D], d_clocks [T,D,A])`` (any leading axes).  Returns the
    merged 5-tuple and ``overflow bool[T, 2]`` (member, deferred)."""
    ca, ids_a, dots_a, dida, dca = sa
    cb, ids_b, dots_b, didb, dcb = sb
    z = _zt(ca)
    e2_for_a, b_matched = _align_against(ids_a, dots_a, ids_b, dots_b)
    valid_a = ids_a != EMPTY
    valid_b = ids_b != EMPTY
    out_a = _merge_rule(dots_a, e2_for_a, valid_a & _nonempty(dots_a),
                        valid_a & _nonempty(e2_for_a), valid_a, ca, cb)
    b_only = valid_b & ~b_matched
    out_b = torch.where(b_only[..., None], _sub(dots_b, ca[..., None, :]), z)
    empty = torch.full((), EMPTY, dtype=torch.int32, device=ca.device)
    ids_cat = torch.cat([torch.where(valid_a, ids_a, empty), torch.where(b_only, ids_b, empty)],
                        dim=-1)
    dots_cat = torch.cat([out_a, out_b], dim=-2)

    d_ids = torch.cat([dida, didb], dim=-1)
    d_clocks = torch.cat([dca, dcb], dim=-2)
    d_live = _dedup_live(d_ids, d_clocks)
    d_ids = torch.where(d_live, d_ids, empty)
    d_clocks = torch.where(d_live[..., None], d_clocks, z)

    clock = torch.maximum(ca, cb)
    new_dots = _sub(dots_cat, _replay_rm(ids_cat, d_ids, d_live, d_clocks, dots_cat))
    live = _nonempty(new_dots) & (ids_cat != EMPTY)
    still_ahead = d_live & ~(d_clocks <= clock[..., None, :]).all(dim=-1)

    m_keys = torch.where(live, ids_cat,
                         torch.full((), INT32_MAX, dtype=torch.int32, device=ca.device))
    ids_out, dots_out, m_over = _rank_select(m_keys, live, ids_cat, new_dots, m_cap)
    dids_out, dclk_out, d_over = _rank_select_slots(still_ahead, d_ids, d_clocks, d_cap)
    return (clock, ids_out, dots_out, dids_out, dclk_out), torch.stack([m_over, d_over], dim=-1)


def join(replicas, m_cap: int, d_cap: int):
    """The anti-entropy join of replica states: the left fold of pairwise
    merges, then the plunger self-merge that flushes buffered removes.
    Returns ``(state, overflow bool[T, 2])``, overflow OR-ed over every
    merge."""
    acc = replicas[0]
    over = None
    for nxt in list(replicas[1:]) + [None]:
        acc, o = merge(acc, acc if nxt is None else nxt, m_cap, d_cap)
        over = o if over is None else over | o
    return acc, over


def narrowed(state, bits: int):
    """The control's input: every counter plane cut to its low ``bits``
    bits as an unsigned counter (re-biased), ids untouched: what a
    program that stored counters at that width would read back."""
    mask = (1 << bits) - 1

    def cut(x):
        u = (x.to(torch.int64) - ZERO) & mask
        return (u + ZERO).to(torch.int32)

    return tuple(cut(x) if i in (0, 2, 4) else x for i, x in enumerate(state))
