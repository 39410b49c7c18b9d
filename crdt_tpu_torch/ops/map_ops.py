"""Batched reset-remove Map ops in the biased counter domain (`map.rs`).

Dense per-object state for ``Map<K, V>`` (`map.rs:83-99`), counters
biased (:mod:`crdt_tpu_torch.dtypes`):

* ``clock    int[..., A]``    — the map clock
* ``keys     int32[..., K]``  — interned key ids, ``-1`` = empty slot
* ``eclocks  int[..., K, A]`` — per-key entry clocks
* ``vals``                    — the nested value state: a nested tuple of
  tensors whose leaves carry the key axis right after the batch axes
* ``d_keys   int32[..., D]``  — deferred-remove key ids
* ``d_clocks int[..., D, A]`` — deferred-remove witnessing clocks

The nested value type is a value kernel ``vk``
(:mod:`crdt_tpu_torch.batch.val_kernels`): ``merge``, ``truncate`` and
``zeros_like``, rank-polymorphic over leading batch axes, so a Map kernel
as ``vk`` nests maps.  ``merge`` follows `map.rs:192-269` as the JAX
package's ``map_ops.merge`` does, the **asymmetric** deferred replay
included: other's deferred rows already covered by self's clock are
dropped without effect (`map.rs:256-260`).  A nested ORSWOT's merge and
truncate run the pairwise merge kernel on a CUDA device, over the
``[N, 2K]`` aligned value slots.
"""

from __future__ import annotations

import torch

from ..dtypes import EMPTY, INT32_MAX
from ..utils.tracing import span
from . import clock_ops
from .orswot_ops import _dedup_deferred, _stable_order, _take, _take_rows, _z, compact


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested tuples of the same structure."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_gather(v, idx):
    """Gather value slots along the key axis (position ``idx.dim() - 1``)."""
    ax = idx.dim() - 1

    def g(leaf):
        ii = idx.to(torch.int64).reshape(idx.shape + (1,) * (leaf.dim() - idx.dim()))
        return torch.gather(leaf, ax, ii.expand(*idx.shape, *leaf.shape[idx.dim():]))

    return _tree_map(g, v)


def tree_where(mask, v, w):
    """Slot-wise select between two value states; ``mask`` broadcasts from
    the leading axes."""
    return _tree_map(
        lambda a, b: torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b),
        v, w)


def tree_scatter_slot(v, slot, upd, do, num_slots):
    """Write ``upd`` (leaves ``[..., *inner]``) into key slot ``slot`` of
    ``v`` (leaves ``[..., K, *inner]``) for the objects where ``do``."""
    onehot = (torch.arange(num_slots, device=slot.device) == slot[..., None]) & do[..., None]
    return _tree_map(
        lambda leaf, u: torch.where(
            onehot.reshape(onehot.shape + (1,) * (leaf.dim() - onehot.dim())),
            u.unsqueeze(slot.dim()), leaf),
        v, upd)


def align_keyed(keys_a, keys_b):
    """Align two key tables on key id by a stable sort and an
    adjacent-run match (`map.rs:196-197`).  Returns ``(keys, idx_a, p_a,
    idx_b, p_b)`` over ``Ka + Kb`` slots: per distinct key its slot in
    each side's table and its presence there."""
    k_a = keys_a.shape[-1]
    cat = torch.cat([keys_a, keys_b], dim=-1)
    side = torch.cat([torch.zeros_like(keys_a), torch.ones_like(keys_b)], dim=-1)
    order = _stable_order(torch.where(cat == EMPTY, torch.full_like(cat, INT32_MAX), cat))
    s_ids, s_side, s_src = _take(cat, order), _take(side, order), order

    valid = s_ids != EMPTY
    adj = (s_ids[..., 1:] == s_ids[..., :-1]) & valid[..., 1:]
    false_col = torch.zeros_like(valid[..., :1])
    same_as_prev = torch.cat([false_col, adj], dim=-1)
    same_as_next = torch.cat([adj, false_col], dim=-1)
    first = valid & ~same_as_prev

    # keys are unique within each side and the sort is stable, so a run is
    # [a], [b] or [a, b], never longer and never [b, a]
    nxt_src = torch.roll(s_src, -1, dims=-1)
    p_a = first & (s_side == 0)
    p_b = first & ((s_side == 1) | same_as_next)
    idx_a = torch.where(p_a, s_src, 0)
    idx_b = torch.where(s_side == 1, s_src, nxt_src) - k_a
    idx_b = torch.clamp(torch.where(p_b, idx_b, 0), 0, max(cat.shape[-1] - k_a - 1, 0))
    keys = torch.where(first, s_ids, torch.full_like(s_ids, EMPTY))
    return keys, idx_a, p_a, idx_b, p_b


def _settle_deferred(clock, keys, eclocks, vals, d_keys, d_clocks, vk):
    """``apply_deferred`` (`map.rs:325-333`): replay every buffered
    ``(clock, key)`` row against the current clock, the matching rows'
    subtracts composed into one subtract by their join; rows still ahead
    of the clock stay buffered (`map.rs:336-350`)."""
    z = _z(eclocks)
    d_valid = d_keys != EMPTY
    cited = torch.where(d_valid, d_keys, torch.full_like(d_keys, EMPTY - 1))
    match = keys[..., :, None] == cited[..., None, :]
    rm = torch.where(match[..., None], d_clocks[..., None, :, :], z).amax(dim=-2)
    new_e = clock_ops.subtract(eclocks, rm)
    live = ~clock_ops.is_empty(new_e) & (keys != EMPTY)
    with span("map/nested_truncate"):
        vals, over = vk.truncate(vals, rm)
    keys = torch.where(live, keys, torch.full_like(keys, EMPTY))
    new_e = torch.where(live[..., None], new_e, z)
    vals = tree_where(live, vals, vk.zeros_like(vals))

    still_ahead = ~clock_ops.leq(d_clocks, clock[..., None, :]) & d_valid
    d_keys = torch.where(still_ahead, d_keys, torch.full_like(d_keys, EMPTY))
    d_clocks = torch.where(still_ahead[..., None], d_clocks, z)
    return keys, new_e, vals, d_keys, d_clocks, over.any(dim=-1)


def compact_keyed(keys, eclocks, vals, cap):
    """Pack live key slots first and cut to ``cap`` slots: ``(keys,
    eclocks, vals, overflow)``."""
    live = keys != EMPTY
    order = _stable_order((~live).to(torch.int32))[..., :cap]
    return (_take(keys, order), _take_rows(eclocks, order), tree_gather(vals, order),
            live.sum(dim=-1) > cap)


def merge(state_a, state_b, vk, k_cap: int, d_cap: int):
    """Full pairwise Map merge (`map.rs:192-269`) of ``state = (clock,
    keys, eclocks, vals, d_keys, d_clocks)``.  Returns ``(state,
    overflow)``; the per-object flag is set when surviving keys exceed
    ``k_cap``, deferred rows exceed ``d_cap`` or a nested value
    overflowed.  Under a profiler: a ``map/merge`` span over ``map/align``,
    ``map/nested_merge``, ``map/nested_truncate``, ``map/settle_deferred``
    and ``map/compact``."""
    with span("map/merge"):
        return _merge(state_a, state_b, vk, k_cap, d_cap)


def _merge(state_a, state_b, vk, k_cap: int, d_cap: int):
    clock_a, keys_a, ec_a, vals_a, dk_a, dc_a = state_a
    clock_b, keys_b, ec_b, vals_b, dk_b, dc_b = state_b
    z = _z(ec_a)

    with span("map/align"):
        keys, idx_a, p_a, idx_b, p_b = align_keyed(keys_a, keys_b)
        e1 = torch.where(p_a[..., None], _take_rows(ec_a, idx_a), z)
        e2 = torch.where(p_b[..., None], _take_rows(ec_b, idx_b), z)
        g1 = tree_gather(vals_a, idx_a)
        v1 = tree_where(p_a, g1, vk.zeros_like(g1))
        g2 = tree_gather(vals_b, idx_b)
        v2 = tree_where(p_b, g2, vk.zeros_like(g2))

    sc = clock_a[..., None, :]
    oc = clock_b[..., None, :]
    # present in both (`map.rs:213-240`)
    common0 = clock_ops.intersection(e1, e2)
    c1 = clock_ops.subtract(clock_ops.subtract(e1, common0), oc)
    c2 = clock_ops.subtract(clock_ops.subtract(e2, common0), sc)
    e_both = torch.maximum(common0, torch.maximum(c1, c2))
    # `map.rs:229-235` literally: always empty, as in the reference
    del_both = clock_ops.subtract(torch.maximum(c1, c2), e_both)
    # only in self (`map.rs:198-211`): the SUBTRACTED clock
    e_only1 = clock_ops.subtract(e1, oc)
    del_only1 = clock_ops.subtract(oc, e_only1)
    # only in other (`map.rs:244-253`)
    e_only2 = clock_ops.subtract(e2, sc)
    del_only2 = clock_ops.subtract(sc, e_only2)

    both = p_a & p_b
    only1 = p_a & ~p_b
    eclocks = torch.where(both[..., None], e_both,
                          torch.where(only1[..., None], e_only1, e_only2))
    eclocks = torch.where((p_a | p_b)[..., None], eclocks, z)
    deleters = torch.where(both[..., None], del_both,
                           torch.where(only1[..., None], del_only1, del_only2))

    with span("map/nested_merge"):
        v_merged, over_vm = vk.merge(v1, v2)
    vals = tree_where(both, v_merged, tree_where(only1, v1, v2))
    with span("map/nested_truncate"):
        vals, over_vt = vk.truncate(vals, deleters)

    survive = ~clock_ops.is_empty(eclocks) & (p_a | p_b)
    keys = torch.where(survive, keys, torch.full_like(keys, EMPTY))
    eclocks = torch.where(survive[..., None], eclocks, z)
    vals = tree_where(survive, vals, vk.zeros_like(vals))

    # deferred: adopt other's rows NOT covered by self's clock
    # (`map.rs:256-260`), keep all of self's, dedup exact (key, clock) pairs
    adopt = ~clock_ops.leq(dc_b, clock_a[..., None, :]) & (dk_b != EMPTY)
    d_keys = torch.cat([dk_a, torch.where(adopt, dk_b, torch.full_like(dk_b, EMPTY))], dim=-1)
    d_clocks = torch.cat([dc_a, torch.where(adopt[..., None], dc_b, z)], dim=-2)
    d_keys, d_clocks = _dedup_deferred(d_keys, d_clocks)

    # clock join (`map.rs:265`), then apply_deferred (`map.rs:267`)
    clock = clock_ops.merge(clock_a, clock_b)
    with span("map/settle_deferred"):
        keys, eclocks, vals, d_keys, d_clocks, over_def = _settle_deferred(
            clock, keys, eclocks, vals, d_keys, d_clocks, vk)
    with span("map/compact"):
        keys, eclocks, vals, k_over = compact_keyed(keys, eclocks, vals, k_cap)
        d_keys, d_clocks, d_over = compact(d_keys, d_clocks, d_cap)
    overflow = ((over_vm & both & survive).any(dim=-1) | (over_vt & survive).any(dim=-1)
                | over_def | k_over | d_over)
    return (clock, keys, eclocks, vals, d_keys, d_clocks), overflow


def truncate(state, clock, vk):
    """``Causal::truncate`` (`map.rs:131-158`) by a biased ``clock [...,
    A]``: subtract it from every entry clock (dropping emptied keys,
    truncating surviving values) and the map clock, filter deferred
    rows."""
    mclock, keys, eclocks, vals, d_keys, d_clocks = state
    z = _z(eclocks)
    new_e = clock_ops.subtract(eclocks, clock[..., None, :])
    live = ~clock_ops.is_empty(new_e) & (keys != EMPTY)
    # the kernels take contiguous planes, not a broadcast view
    vals, over = vk.truncate(vals, clock[..., None, :].expand(eclocks.shape).contiguous())
    keys = torch.where(live, keys, torch.full_like(keys, EMPTY))
    new_e = torch.where(live[..., None], new_e, z)
    vals = tree_where(live, vals, vk.zeros_like(vals))

    d_new = clock_ops.subtract(d_clocks, clock[..., None, :])
    d_live = ~clock_ops.is_empty(d_new) & (d_keys != EMPTY)
    d_keys = torch.where(d_live, d_keys, torch.full_like(d_keys, EMPTY))
    d_new = torch.where(d_live[..., None], d_new, z)
    return ((clock_ops.subtract(mclock, clock), keys, new_e, vals, d_keys, d_new),
            over.any(dim=-1))


def _first(mask):
    """Index of the first True along the last axis (0 where none):
    ``argmax`` returns the first maximum, and has no bool kernel."""
    return mask.to(torch.uint8).argmax(dim=-1)


def apply_up(state, actor_idx, counter, key_id, nested_apply, vk):
    """Batched ``Op::Up`` (`map.rs:163-189`), one nested update per object
    (``counter`` biased).  ``nested_apply(v) -> (v, overflow)`` applies the
    nested op to the gathered slot state (leaves ``[..., *inner]``);
    objects whose op is already seen (`map.rs:170-173`) keep their slot."""
    clock, keys, eclocks, vals, d_keys, d_clocks = state
    actor = actor_idx.to(torch.int64)
    seen = torch.gather(clock, -1, actor[..., None])[..., 0] >= counter

    existing = keys == key_id[..., None]
    has_slot = existing.any(dim=-1)
    free = keys == EMPTY
    has_free = free.any(dim=-1)
    slot = torch.where(has_slot, _first(existing), _first(free))
    overflow = ~seen & ~has_slot & ~has_free
    do = ~seen & (has_slot | has_free)

    k = keys.shape[-1]
    put = do[..., None] & (torch.arange(k, device=keys.device) == slot[..., None])
    new_keys = torch.where(put, key_id[..., None], keys)
    # witness the dot on the entry clock and the map clock (`map.rs:181-185`)
    on_actor = torch.arange(clock.shape[-1], device=clock.device) == actor[..., None]
    new_e = torch.where(put[..., None] & on_actor[..., None, :],
                        torch.maximum(eclocks, counter[..., None, None]), eclocks)
    new_clock = torch.where(do[..., None] & on_actor, torch.maximum(clock, counter[..., None]),
                            clock)

    v_slot = _tree_map(lambda leaf: leaf.squeeze(slot.dim()), tree_gather(vals, slot[..., None]))
    v_new, v_over = nested_apply(v_slot)
    vals = tree_scatter_slot(vals, slot, v_new, do, k)

    keys2, e2, vals2, dk2, dc2, over_def = _settle_deferred(
        new_clock, new_keys, new_e, vals, d_keys, d_clocks, vk)
    return (new_clock, keys2, e2, vals2, dk2, dc2), overflow | (v_over & do) | over_def


def apply_rm(state, rm_clock, key_id, vk):
    """Batched ``Op::Rm`` → ``apply_rm`` (`map.rs:336-350`), one remove per
    object (``rm_clock`` biased): buffer it when its clock is ahead of the
    map clock, and always subtract it from the entry, dropping the key if
    emptied and truncating the nested value otherwise."""
    clock, keys, eclocks, vals, d_keys, d_clocks = state
    z = _z(eclocks)
    ahead = ~clock_ops.leq(rm_clock, clock)

    d_valid = d_keys != EMPTY
    same = (d_keys == key_id[..., None]) & clock_ops.eq(d_clocks, rm_clock[..., None, :]) & d_valid
    want = ahead & ~same.any(dim=-1)
    free = ~d_valid
    has_free = free.any(dim=-1)
    overflow = want & ~has_free
    put = (want & has_free)[..., None] & (
        torch.arange(d_keys.shape[-1], device=d_keys.device) == _first(free)[..., None])
    new_dk = torch.where(put, key_id[..., None], d_keys)
    new_dc = torch.where(put[..., None], rm_clock[..., None, :], d_clocks)

    target = keys == key_id[..., None]
    new_e = torch.where(target[..., None], clock_ops.subtract(eclocks, rm_clock[..., None, :]),
                        eclocks)
    live = ~clock_ops.is_empty(new_e) & (keys != EMPTY)
    rm_slots = torch.where(target[..., None], rm_clock[..., None, :], z)
    vals, over_t = vk.truncate(vals, rm_slots)
    new_keys = torch.where(live, keys, torch.full_like(keys, EMPTY))
    new_e = torch.where(live[..., None], new_e, z)
    vals = tree_where(live, vals, vk.zeros_like(vals))
    return (clock, new_keys, new_e, vals, new_dk, new_dc), overflow | over_t.any(dim=-1)
