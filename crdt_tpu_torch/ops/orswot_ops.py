"""Batched ORSWOT merge and the anti-entropy folds, in PyTorch.

Dense per-object state (leading axes are free batch axes), counters in
the biased signed domain of :mod:`crdt_tpu_torch.dtypes`:

* ``clock    int[..., A]``      — the set clock
* ``ids      int32[..., M]``    — interned member ids, ``-1`` = empty slot
* ``dots     int[..., M, A]``   — per-member dot clocks
* ``d_ids    int32[..., D]``    — deferred-remove member ids, ``-1`` = empty
* ``d_clocks int[..., D, A]``   — deferred-remove witnessing clocks

``merge`` reproduces `orswot.rs:89-156` bit for bit, as the JAX
package's ``crdt_tpu.ops.orswot_ops.merge`` does: members only in *self*
keep their **full** clock when any dot is novel (`orswot.rs:94-103`),
members only in *other* keep the **subtracted** clock
(`orswot.rs:132-138`).

Implementations (:func:`resolve_merge_impl`): ``rank`` is the
rank-select pipeline below, plain PyTorch on any device and any counter
width; ``unrolled`` and ``pallas`` route 32-bit batches with ``M <= 64``
to the pairwise tile merge (:mod:`crdt_tpu_torch.ops.orswot_tile`, a
CUDA kernel on the card).  :func:`fold_merge` with ``impl="pallas"``
routes rank-3 32-bit planes to the union-aligned fold kernel
(:mod:`crdt_tpu_torch.ops.orswot_fold_aligned`).  64-bit batches stay on
the rank path everywhere, as the JAX package keeps them off Pallas.
"""

from __future__ import annotations

import warnings

import torch

from .. import _build
from ..config import MERGE_IMPLS
from ..dtypes import EMPTY, INT32_MAX, zero_of
from . import clock_ops

_SORT_MAX = INT32_MAX

# above this member capacity the O(M²) match costs more than sort+gather
# alignment (elastic regrowth can push M to 2^16); the tile kernels also
# stop here
_ALIGN_MATCH_MAX_M = 64


def _z(x: torch.Tensor) -> torch.Tensor:
    """Biased counter zero of ``x``'s dtype, as a 0-d tensor."""
    return torch.full((), zero_of(x.dtype), dtype=x.dtype, device=x.device)


def _take(x, idx):
    """``take_along_axis`` on the last axis."""
    return torch.gather(x, -1, idx.to(torch.int64))


def _take_rows(x, idx):
    """Gather whole actor rows: ``x [..., S, A]``, ``idx [..., K]`` →
    ``[..., K, A]``."""
    idx = idx.to(torch.int64)[..., None].expand(*idx.shape, x.shape[-1])
    return torch.gather(x, -2, idx)


def _align_sorted(ids_a, dots_a, ids_b, dots_b):
    """Sort+gather alignment, used above ``_ALIGN_MATCH_MAX_M``.
    Concatenate both tables, stably sort by member id, and match adjacent
    duplicates (runs have length <= 2 since ids are unique within each
    side).  Returns ``(ids, e1, e2, first)`` over the 2M slots in sorted
    order."""
    ids_cat = torch.cat([ids_a, ids_b], dim=-1)
    dots_cat = torch.cat([dots_a, dots_b], dim=-2)
    side = torch.cat([torch.zeros_like(ids_a), torch.ones_like(ids_b)], dim=-1)

    key = torch.where(ids_cat == EMPTY, torch.full_like(ids_cat, _SORT_MAX), ids_cat)
    order = _stable_order(key)
    s_ids = _take(ids_cat, order)
    s_dots = _take_rows(dots_cat, order)
    s_side = _take(side, order)

    valid = s_ids != EMPTY
    same_next = (s_ids[..., 1:] == s_ids[..., :-1])
    false_col = torch.zeros_like(valid[..., :1])
    nxt_same = torch.cat([same_next & valid[..., 1:], false_col], dim=-1)
    prv_same = torch.cat([false_col, same_next & valid[..., :-1]], dim=-1)
    first = valid & ~prv_same

    z = _z(dots_a)
    from_a = torch.where((s_side == 0)[..., None], s_dots, z)
    from_b = torch.where((s_side == 1)[..., None], s_dots, z)

    def nxt(x):
        return torch.cat([x[..., 1:, :], torch.full_like(x[..., :1, :], zero_of(x.dtype))], dim=-2)

    take_nxt = nxt_same[..., None]
    e1 = torch.maximum(from_a, torch.where(take_nxt, nxt(from_a), z))
    e2 = torch.maximum(from_b, torch.where(take_nxt, nxt(from_b), z))
    out_ids = torch.where(first, s_ids, torch.full_like(s_ids, EMPTY))
    return out_ids, e1, e2, first


def _merge_aligned(e1, e2, present1, present2, self_clock, other_clock):
    """The per-member dot-algebra rule (`orswot.rs:92-138`), elementwise
    over the actor axis."""
    sc = self_clock[..., None, :]
    oc = other_clock[..., None, :]
    z = _z(e1)

    # present in both (`orswot.rs:105-129`)
    common = clock_ops.intersection(e1, e2)
    c1 = clock_ops.subtract(clock_ops.subtract(e1, common), oc)
    c2 = clock_ops.subtract(clock_ops.subtract(e2, common), sc)
    out_both = torch.maximum(common, torch.maximum(c1, c2))

    # only in self (`orswot.rs:94-103`): keep FULL clock iff not dominated
    keep1 = ~clock_ops.leq(e1, oc)
    out_only1 = torch.where(keep1[..., None], e1, z)

    # only in other (`orswot.rs:132-138`): keep the SUBTRACTED clock
    out_only2 = clock_ops.subtract(e2, sc)

    both = (present1 & present2)[..., None]
    only1 = (present1 & ~present2)[..., None]
    out = torch.where(both, out_both, torch.where(only1, out_only1, out_only2))
    return torch.where((present1 | present2)[..., None], out, z)


def _dedup_deferred(d_ids, d_clocks):
    """Drop exact (member, clock) duplicate rows, keeping the first
    (`orswot.rs:29`: the deferred map is ``{clock: {members}}``)."""
    same_member = d_ids[..., :, None] == d_ids[..., None, :]
    same_clock = clock_ops.eq(d_clocks[..., :, None, :], d_clocks[..., None, :, :])
    valid = d_ids != EMPTY
    dup_pair = same_member & same_clock & valid[..., :, None] & valid[..., None, :]
    d = d_ids.shape[-1]
    earlier = torch.ones((d, d), dtype=torch.bool, device=d_ids.device).tril(-1)
    is_dup = (dup_pair & earlier).any(dim=-1)
    keep = valid & ~is_dup
    return (
        torch.where(keep, d_ids, torch.full_like(d_ids, EMPTY)),
        torch.where(keep[..., None], d_clocks, _z(d_clocks)),
    )


def _apply_deferred(clock, ids, dots, d_ids, d_clocks):
    """Replay buffered removes (`orswot.rs:195-243`), single pass: subtract
    from each member the join of all matching deferred clocks, drop
    emptied members, keep only deferred rows still ahead of the set
    clock."""
    z = _z(dots)
    d_valid = d_ids != EMPTY
    if d_ids.shape[-1] > 0:
        cited = torch.where(d_valid, d_ids, torch.full_like(d_ids, EMPTY - 1))
        match = ids[..., :, None] == cited[..., None, :]  # [..., M, D]
        rm = torch.where(
            match[..., None], d_clocks[..., None, :, :], z
        ).amax(dim=-2)
    else:
        rm = torch.full_like(dots, zero_of(dots.dtype))
    new_dots = clock_ops.subtract(dots, rm)
    live = ~clock_ops.is_empty(new_dots) & (ids != EMPTY)
    new_ids = torch.where(live, ids, torch.full_like(ids, EMPTY))
    new_dots = torch.where(live[..., None], new_dots, z)

    # keep deferred rows whose clock is still not covered (`orswot.rs:197`)
    still_ahead = ~clock_ops.leq(d_clocks, clock[..., None, :]) & d_valid
    out_d_ids = torch.where(still_ahead, d_ids, torch.full_like(d_ids, EMPTY))
    out_d_clocks = torch.where(still_ahead[..., None], d_clocks, z)
    return new_ids, new_dots, out_d_ids, out_d_clocks


def _stable_order(key):
    """Permutation that stably sorts ``key`` ascending along the last axis
    (ties keep slot order) — the JAX package's counting rank computes
    the same permutation."""
    return torch.sort(key, dim=-1, stable=True).indices


def compact(ids, payload, cap):
    """Pack live slots first (original slot order) and truncate to ``cap``.
    Returns ``(ids, payload, overflow)``."""
    live = ids != EMPTY
    order = _stable_order((~live).to(torch.int32))
    ids_out = _take(ids, order)[..., :cap]
    payload = _take_rows(payload, order)[..., :cap, :]
    return ids_out, payload, live.sum(dim=-1) > cap


def compact_by_id(ids, payload, cap):
    """Pack live slots in ascending member-id order and truncate to
    ``cap`` — the canonical member-table order every engine emits."""
    live = ids != EMPTY
    key = torch.where(live, ids, torch.full_like(ids, _SORT_MAX))
    order = _stable_order(key)
    ids_out = _take(ids, order)[..., :cap]
    payload = _take_rows(payload, order)[..., :cap, :]
    return ids_out, payload, live.sum(dim=-1) > cap


def resolve_merge_impl(impl: str | None = None, device=None) -> str:
    """Which pairwise-merge implementation :func:`merge` dispatches to.

    An explicit non-``"auto"`` choice wins; otherwise the device
    decides: ``unrolled`` (the tile kernel) on CUDA, ``rank`` on the CPU
    — the JAX package picks ``unrolled`` on TPU and ``rank`` elsewhere
    the same way."""
    if impl is not None and impl != "auto":
        if impl not in MERGE_IMPLS:
            raise ValueError(f"merge impl {impl!r} is not one of rank/unrolled/pallas")
        return impl
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return "unrolled" if dev.type == "cuda" else "rank"


def merge(
    clock_a, ids_a, dots_a, dids_a, dclocks_a,
    clock_b, ids_b, dots_b, dids_b, dclocks_b,
    m_cap: int, d_cap: int, impl: str | None = None,
):
    """Full pairwise ORSWOT merge (`orswot.rs:89-156`).

    Returns ``(clock, ids, dots, d_ids, d_clocks, overflow)``; overflow is
    ``bool[..., 2]`` — member flag then deferred flag."""
    impl = resolve_merge_impl(impl, clock_a.device)
    narrow = ids_a.shape[-1] <= _ALIGN_MATCH_MAX_M
    if impl in ("unrolled", "pallas"):
        if clock_a.dtype != torch.int32:
            warnings.warn(
                f"orswot merge impl {impl!r} requires 32-bit counters; this "
                f"{clock_a.dtype} batch takes the 'rank' path. Build the "
                "universe with CrdtConfig(counter_bits=32) to stay on the "
                "kernel paths.",
                stacklevel=2,
            )
        elif narrow:
            from . import orswot_tile

            return orswot_tile.merge(
                clock_a, ids_a, dots_a, dids_a, dclocks_a,
                clock_b, ids_b, dots_b, dids_b, dclocks_b,
                m_cap, d_cap, prebiased=True,
            )
    if not narrow:
        _build._count(_build.WIDE_MERGES)
        return _merge_wide(
            clock_a, ids_a, dots_a, dids_a, dclocks_a,
            clock_b, ids_b, dots_b, dids_b, dclocks_b,
            m_cap, d_cap,
        )
    # the deferred pipeline runs whether or not any deferred row exists:
    # replay over empty deferred tables is the identity, and testing for
    # them would need a host-side read that stalls the stream
    clock = clock_ops.merge(clock_a, clock_b)
    ids, out_dots, d_ids, d_clocks, over = _merge_narrow_deferred(
        clock, clock_a, ids_a, dots_a, dids_a, dclocks_a,
        clock_b, ids_b, dots_b, dids_b, dclocks_b,
        m_cap, d_cap,
    )
    return clock, ids, out_dots, d_ids, d_clocks, over


def _member_match(ids_a, ids_b):
    """Boolean member alignment: match matrix reductions only."""
    valid_a = ids_a != EMPTY
    valid_b = ids_b != EMPTY
    match = valid_a[..., :, None] & (ids_a[..., :, None] == ids_b[..., None, :])
    a_matched = match.any(dim=-1)
    # first matching b slot (argmax of a bool picks the first True)
    j_idx = torch.argmax(match.to(torch.int32), dim=-1)
    b_only = valid_b & ~match.any(dim=-2)
    return valid_a, a_matched, j_idx, b_only


def _rank_select_merge(
    clock_a, ids_a, dots_a, clock_b, ids_b, dots_b, m_cap: int,
):
    """Shared merge core: survival reduces → rank-select → compute.
    Returns ``(out_ids, out_dots, n_survivors)`` — the member table in
    canonical ascending-id order, before deferred replay."""
    ma = ids_a.shape[-1]
    z = _z(dots_a)
    valid_a, a_matched, j_idx, b_only = _member_match(ids_a, ids_b)
    sc = clock_a[..., None, :]
    oc = clock_b[..., None, :]

    # per-(slot, actor) survival predicates, OR-reduced over actors
    e2 = _take_rows(dots_b, j_idx)
    same = dots_a == e2
    both_lane = (same & (dots_a > z)) | (~same & ((dots_a > oc) | (e2 > sc)))
    a_novel = (dots_a > oc).any(dim=-1)
    a_surv = valid_a & torch.where(a_matched, both_lane.any(dim=-1), a_novel)
    b_surv = b_only & (dots_b > sc).any(dim=-1)
    n_surv = a_surv.sum(dim=-1) + b_surv.sum(dim=-1)

    # rank-select the m_cap smallest surviving member ids
    big = torch.full_like(ids_a[..., :1], _SORT_MAX)
    keys = torch.cat(
        [torch.where(a_surv, ids_a, big), torch.where(b_surv, ids_b, big)], dim=-1
    )
    sel = _stable_order(keys)[..., :m_cap]  # concat-space source slot
    out_ids_key = _take(keys, sel)
    live = out_ids_key != _SORT_MAX
    out_ids = torch.where(live, out_ids_key, torch.full_like(out_ids_key, EMPTY))

    # gather algebra inputs for the selected slots only
    is_b = sel >= ma
    sel_a = torch.where(is_b, torch.zeros_like(sel), sel)
    src_a = _take_rows(dots_a, sel_a)
    sel_matched = _take(a_matched, sel_a) & ~is_b
    j_sel = _take(j_idx, sel_a)
    j_comb = torch.where(is_b, sel - ma, j_sel)
    src_other = _take_rows(dots_b, j_comb)

    # dot algebra on [..., m_cap, A] (`orswot.rs:105-138`)
    common = clock_ops.intersection(src_a, src_other)
    c1 = clock_ops.subtract(clock_ops.subtract(src_a, common), oc)
    c2 = clock_ops.subtract(clock_ops.subtract(src_other, common), sc)
    out_both = torch.maximum(common, torch.maximum(c1, c2))
    out_a = torch.where(sel_matched[..., None], out_both, src_a)
    out_dots = torch.where(is_b[..., None], clock_ops.subtract(src_other, sc), out_a)
    out_dots = torch.where(live[..., None], out_dots, z)
    return out_ids, out_dots, n_surv


def _merge_narrow_deferred(
    clock, clock_a, ids_a, dots_a, dids_a, dclocks_a,
    clock_b, ids_b, dots_b, dids_b, dclocks_b,
    m_cap: int, d_cap: int,
):
    """Narrow merge: the rank-select core, then union + dedup + replay of
    the deferred tables (`orswot.rs:141-155`) at ``m_cap`` width, then a
    repack of whatever the replay emptied.  The member-overflow flag comes from the
    pre-replay survivor count."""
    out_ids, out_dots, n_surv = _rank_select_merge(
        clock_a, ids_a, dots_a, clock_b, ids_b, dots_b, m_cap
    )
    m_over = n_surv > m_cap

    d_ids = torch.cat([dids_a, dids_b], dim=-1)
    d_clocks = torch.cat([dclocks_a, dclocks_b], dim=-2)
    d_ids, d_clocks = _dedup_deferred(d_ids, d_clocks)
    out_ids, out_dots, d_ids, d_clocks = _apply_deferred(
        clock, out_ids, out_dots, d_ids, d_clocks
    )

    out_ids, out_dots, _ = compact_by_id(out_ids, out_dots, m_cap)
    d_ids, d_clocks, d_over = compact(d_ids, d_clocks, d_cap)
    return out_ids, out_dots, d_ids, d_clocks, torch.stack([m_over, d_over], dim=-1)


def _merge_wide(
    clock_a, ids_a, dots_a, dids_a, dclocks_a,
    clock_b, ids_b, dots_b, dids_b, dclocks_b,
    m_cap: int, d_cap: int,
):
    """Sort-aligned merge pipeline for member tables wider than
    ``_ALIGN_MATCH_MAX_M`` (same semantics, O(M log M) alignment)."""
    z = _z(dots_a)
    ids, e1, e2, valid = _align_sorted(ids_a, dots_a, ids_b, dots_b)
    p1 = ~clock_ops.is_empty(e1) & valid
    p2 = ~clock_ops.is_empty(e2) & valid
    out_dots = _merge_aligned(e1, e2, p1, p2, clock_a, clock_b)
    survive = ~clock_ops.is_empty(out_dots)
    ids = torch.where(survive, ids, torch.full_like(ids, EMPTY))
    out_dots = torch.where(survive[..., None], out_dots, z)

    d_ids = torch.cat([dids_a, dids_b], dim=-1)
    d_clocks = torch.cat([dclocks_a, dclocks_b], dim=-2)
    d_ids, d_clocks = _dedup_deferred(d_ids, d_clocks)

    clock = clock_ops.merge(clock_a, clock_b)
    ids, out_dots, d_ids, d_clocks = _apply_deferred(clock, ids, out_dots, d_ids, d_clocks)

    ids, out_dots, m_over = compact_by_id(ids, out_dots, m_cap)
    d_ids, d_clocks, d_over = compact(d_ids, d_clocks, d_cap)
    return clock, ids, out_dots, d_ids, d_clocks, torch.stack([m_over, d_over], dim=-1)


def fold_merge(
    clock, ids, dots, dids, dclocks, m_cap: int, d_cap: int,
    plunger: bool = True, impl: str | None = None, u_cap: int | None = None,
):
    """Left-fold ``R`` stacked replica fleets (``[R, N, ...]``) into one
    ``[N, ...]`` state, with the defer-plunger self-merge — the
    anti-entropy join.

    With ``impl="pallas"`` and eligible planes (32-bit counters, rank-3
    ``[R, N, ...]``, ``M <= 64``) the whole fold runs in the union-aligned
    fold (:mod:`~crdt_tpu_torch.ops.orswot_fold_aligned`, one kernel on
    the card) that reads each replica state once; its overflow flags are
    conservative and its outputs unspecified where a flag is set.  Other
    choices run :func:`fold_merge_sequential`.

    Returns ``(clock, ids, dots, d_ids, d_clocks, overflow)``."""
    resolved = resolve_merge_impl(impl, clock.device)
    if (
        resolved == "pallas"
        and clock.dtype == torch.int32
        and clock.dim() == 3
        and ids.shape[-1] <= _ALIGN_MATCH_MAX_M
    ):
        from . import orswot_fold_aligned

        return orswot_fold_aligned.fold_merge(
            clock, ids, dots, dids, dclocks, m_cap, d_cap,
            u_cap=u_cap, plunger=plunger, prebiased=True,
        )
    return fold_merge_sequential(
        clock, ids, dots, dids, dclocks, m_cap, d_cap,
        plunger=plunger, impl=impl,
    )


def fold_merge_sequential(
    clock, ids, dots, dids, dclocks, m_cap: int, d_cap: int,
    plunger: bool = True, impl: str | None = None,
):
    """The canonical sequential left fold over stacked ``[R, N, ...]``
    planes, ORing capacity overflow across every pairwise merge."""
    state = (clock, ids, dots, dids, dclocks)
    acc = tuple(x[0] for x in state)
    over_acc = torch.zeros(clock.shape[1:-1] + (2,), dtype=torch.bool, device=clock.device)
    for i in range(1, clock.shape[0]):
        out = merge(*acc, *(x[i] for x in state), m_cap, d_cap, impl=impl)
        acc, over_acc = out[:5], over_acc | out[5]
    if plunger:
        out = merge(*acc, *acc, m_cap, d_cap, impl=impl)
        acc, over_acc = out[:5], over_acc | out[5]
    return acc + (over_acc,)


def fold_merge_tree(
    clock, ids, dots, dids, dclocks, m_cap: int, d_cap: int,
    plunger: bool = True, impl: str | None = None,
):
    """Join ``R`` stacked replica fleets (``[R, N, ...]``) into one
    ``[N, ...]`` state by pairwise tree reduction: tree level ``l`` runs
    its ``R / 2**l`` merges as ONE batched :func:`merge` call.

    For deferred-free states this is bit-identical to the left fold.
    With causally-future removes in flight the dot tables depend on the
    fold order (`orswot.rs:195-211,235-243`); ``value()``, the set clock
    and the member table do not.

    Returns ``(clock, ids, dots, d_ids, d_clocks, overflow)`` with
    ``overflow`` OR-reduced over every merge in the tree."""
    state = (clock, ids, dots, dids, dclocks)
    r = clock.shape[0]
    over_acc = torch.zeros(clock.shape[1:-1] + (2,), dtype=torch.bool, device=clock.device)
    while r > 1:
        half = r // 2
        # strided slices copied to contiguous planes: the kernels take
        # contiguous tensors only
        lhs = tuple(x[0: 2 * half: 2].contiguous() for x in state)
        rhs = tuple(x[1: 2 * half: 2].contiguous() for x in state)
        out = merge(*lhs, *rhs, m_cap, d_cap, impl=impl)
        merged, over = out[:5], out[5]
        over_acc = over_acc | over.any(dim=0)
        if r % 2:
            # odd fleet carries through to the next level
            merged = tuple(torch.cat([m, x[-1:]], dim=0) for m, x in zip(merged, state))
        state = merged
        r = half + r % 2
    state = tuple(x[0] for x in state)
    if plunger:
        out = merge(*state, *state, m_cap, d_cap, impl=impl)
        state, over = out[:5], out[5]
        over_acc = over_acc | over
    return state + (over_acc,)


def contains(ids, member_id):
    """Membership bitmap (`orswot.rs:214-224`)."""
    return (ids == member_id[..., None]).any(dim=-1)


def apply_add(clock, ids, dots, dids, dclocks, actor_idx, counter, member_id):
    """Batched ``Op::Add`` (`orswot.rs:66-79`), one add per object:
    ``actor_idx``, ``counter`` (biased) and ``member_id`` are ``[...]``.
    Returns the updated state and an overflow flag (no free member
    slot)."""
    actor = actor_idx.to(torch.int64)
    seen = torch.gather(clock, -1, actor[..., None])[..., 0] >= counter
    existing = ids == member_id[..., None]
    has_slot = existing.any(dim=-1)
    free = ids == EMPTY
    has_free = free.any(dim=-1)
    # argmax returns the first maximal index, as jnp.argmax does
    slot = torch.where(has_slot, existing.to(torch.int8).argmax(dim=-1),
                       free.to(torch.int8).argmax(dim=-1))
    overflow = ~seen & ~has_slot & ~has_free

    do = (~seen & (has_slot | has_free))[..., None]
    put = do & (torch.arange(ids.shape[-1], device=ids.device) == slot[..., None])
    new_ids = torch.where(put, member_id[..., None], ids)
    # witness the dot on the member clock and the set clock
    on_actor = torch.arange(clock.shape[-1], device=clock.device) == actor[..., None]
    new_dots = torch.where(put[..., None] & on_actor[..., None, :],
                           torch.maximum(dots, counter[..., None, None]), dots)
    new_clock = torch.where(do & on_actor, torch.maximum(clock, counter[..., None]), clock)
    new_ids, new_dots, d_ids, d_clocks = _apply_deferred(new_clock, new_ids, new_dots,
                                                         dids, dclocks)
    return new_clock, new_ids, new_dots, d_ids, d_clocks, overflow


def apply_remove(clock, ids, dots, dids, dclocks, rm_clock, member_id):
    """Batched ``Op::Rm`` (`orswot.rs:195-211`), one remove per object:
    defer when the remove clock is ahead of the set clock, and always
    subtract it from the member's dots.  Returns the updated state and an
    overflow flag (deferred table full)."""
    ahead = ~clock_ops.leq(rm_clock, clock)
    # dedup: an identical (member, clock) row may already be buffered
    d_valid = dids != EMPTY
    same = (dids == member_id[..., None]) & clock_ops.eq(dclocks, rm_clock[..., None, :]) & d_valid
    want_defer = ahead & ~same.any(dim=-1)
    free = ~d_valid
    has_free = free.any(dim=-1)
    slot = free.to(torch.int8).argmax(dim=-1)
    overflow = want_defer & ~has_free
    do = (want_defer & has_free)[..., None]
    put = do & (torch.arange(dids.shape[-1], device=dids.device) == slot[..., None])
    new_dids = torch.where(put, member_id[..., None], dids)
    new_dclocks = torch.where(put[..., None], rm_clock[..., None, :], dclocks)

    # subtract the remove clock from the member's dots (`orswot.rs:205-210`)
    target = ids == member_id[..., None]
    new_dots = torch.where(target[..., None], clock_ops.subtract(dots, rm_clock[..., None, :]),
                           dots)
    live = ~clock_ops.is_empty(new_dots) & (ids != EMPTY)
    new_ids = torch.where(live, ids, torch.full_like(ids, EMPTY))
    new_dots = torch.where(live[..., None], new_dots, _z(new_dots))
    return clock, new_ids, new_dots, new_dids, new_dclocks, overflow


def member_mask(ids):
    """Live-member mask: ``value()`` as a bitmap over slots."""
    return ids != EMPTY
