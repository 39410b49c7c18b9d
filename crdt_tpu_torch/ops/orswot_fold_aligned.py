"""Union-aligned anti-entropy fold — the port of
``crdt_tpu/ops/orswot_fold_aligned.py``.

The expensive work of the pairwise pipeline is alignment and
compaction, and neither needs to happen per fold step.  Per object:

1. **Union table, once** — the distinct member ids across all ``R``
   replica tables, in first-occurrence order, into ``u_cap`` slots.
2. **Align, once per replica** — replica ``r``'s dot rows gathered onto
   the union slots.
3. **Fold steps, elementwise** — with every side on the same slot table
   the dot rule (`orswot.rs:89-156`) is elementwise over ``[U, A]``; each
   step replays the deferred pipeline exactly like the pairwise merge.
4. **Canonical compaction, once** — ascending-member-id rank selection
   into ``m_cap`` slots.

Contract against the sequential fold of pairwise merges: with no
overflow flagged the outputs are bit-identical; with overflow flagged
they are unspecified.  The member flag is conservative — it also covers
the union outgrowing ``u_cap``.

:func:`fold_merge_reference` is the plain PyTorch version;
:func:`fold_merge` launches ``csrc/orswot_fold_aligned.cu`` for CUDA
tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..dtypes import EMPTY, INT32_MAX
from .orswot_tile import (
    ZERO,
    _check_planes,
    _dedup_live,
    _empty_out,
    _enter,
    _leave,
    _nonempty,
    _nbytes,
    _ptrs,
    _rank_select,
    _rank_select_slots,
    _sub,
    _zt,
)

# the card's opt-in shared memory per block (H100: 227 KB)
_SMEM_LIMIT = 232_448


def _build_union(id_planes, u_cap: int):
    """Distinct member ids across the replica tables, first-occurrence
    order, into ``u_cap`` slots.  ``id_planes``: list of ``[T, M]`` int32
    planes.  Returns ``(union_ids [T, u_cap], n_union [T])``; ids past
    ``u_cap`` are dropped (the caller flags ``n_union > u_cap``)."""
    t = id_planes[0].shape[0]
    dev = id_planes[0].device
    union_ids = torch.full((t, u_cap), EMPTY, dtype=torch.int32, device=dev)
    n_union = torch.zeros((t,), dtype=torch.int64, device=dev)
    slot_iota = torch.arange(u_cap, device=dev)
    for ids in id_planes:
        for m in range(ids.shape[-1]):
            cand = ids[:, m: m + 1]  # [T, 1]
            is_new = (cand[:, 0] != EMPTY) & ~((union_ids != EMPTY) & (union_ids == cand)).any(dim=-1)
            place = is_new[:, None] & (slot_iota[None, :] == n_union[:, None])
            union_ids = torch.where(place, cand, union_ids)
            n_union = n_union + is_new.to(torch.int64)
    return union_ids, n_union


def _align_to_union(union_ids, ids, dots):
    """Replica dot rows gathered onto union slots (``ZERO`` rows where
    the member is absent): ``[T, M]`` / ``[T, M, A]`` → ``[T, U, A]``."""
    match = (union_ids[:, :, None] != EMPTY) & (union_ids[:, :, None] == ids[:, None, :])
    if ids.shape[-1] == 0:
        return torch.full(union_ids.shape + dots.shape[-1:], ZERO, dtype=torch.int32,
                          device=dots.device)
    return torch.where(match[..., None], dots[:, None, :, :], _zt(dots)).amax(dim=-2)


def _step_members(acc, e2, c_prev, c_rep, union_valid, m_cap: int):
    """One fold step's member dot rule on union slots, self = the
    accumulator (clock ``c_prev``), other = the replica (``c_rep``).
    Returns ``(out [T, U, A], m_over [T])`` with the survivor count taken
    before the replay."""
    sc = c_prev[:, None, :]
    oc = c_rep[:, None, :]
    z = _zt(acc)
    p1 = _nonempty(acc)
    p2 = _nonempty(e2)
    common = torch.where(acc == e2, acc, z)
    c1 = _sub(_sub(acc, common), oc)
    c2 = _sub(_sub(e2, common), sc)
    out_both = torch.maximum(common, torch.maximum(c1, c2))
    keep1 = ~(acc <= oc).all(dim=-1)  # keep FULL clock (`orswot.rs:94-103`)
    out_only1 = torch.where(keep1[..., None], acc, z)
    out_only2 = _sub(e2, sc)  # subtracted clock (`orswot.rs:132-138`)
    both = (p1 & p2)[..., None]
    only1 = (p1 & ~p2)[..., None]
    out = torch.where(both, out_both, torch.where(only1, out_only1, out_only2))
    out = torch.where(union_valid[..., None], out, z)
    n_surv = (_nonempty(out) & union_valid).sum(dim=-1)
    return out, n_surv > m_cap


def _step_deferred(union_ids, acc, c_new, d1_ids, d1_clocks, d2_ids, d2_clocks, d_cap: int):
    """One fold step's deferred pipeline: union + keep-first dedup
    (`orswot.rs:141-148`), replay against the member rows, retain rows
    still ahead of ``c_new``, compact to ``d_cap`` in slot order."""
    d_ids = torch.cat([d1_ids, d2_ids], dim=-1)
    d_clocks = torch.cat([d1_clocks, d2_clocks], dim=-2)
    d_live = _dedup_live(d_ids, d_clocks)
    match = (
        (union_ids[:, :, None] != EMPTY)
        & (union_ids[:, :, None] == d_ids[:, None, :])
        & d_live[:, None, :]
    )
    if d_ids.shape[-1]:
        rm = torch.where(match[..., None], d_clocks[:, None, :, :], _zt(acc)).amax(dim=-2)
        acc = _sub(acc, rm)
    still_ahead = d_live & ~(d_clocks <= c_new[:, None, :]).all(dim=-1)
    d_ids_out, d_clocks_out, d_over = _rank_select_slots(still_ahead, d_ids, d_clocks, d_cap)
    return acc, d_ids_out, d_clocks_out, d_over


def fold_merge_reference(clock, ids, dots, dids, dclocks, m_cap: int, d_cap: int,
                         u_cap: int | None = None, plunger: bool = True):
    """Plain PyTorch union-aligned fold of ``[R, N, ...]`` biased-int32
    planes.  Returns ``(clock, ids, dots, d_ids, d_clocks, overflow)``."""
    r = clock.shape[0]
    if u_cap is None:
        u_cap = 2 * m_cap
    union_ids, n_union = _build_union([ids[rr] for rr in range(r)], u_cap)
    union_valid = union_ids != EMPTY
    acc = _align_to_union(union_ids, ids[0], dots[0])
    c_acc = clock[0]
    d_ids_acc, d_clocks_acc = dids[0], dclocks[0]
    m_over = n_union > u_cap
    d_over = torch.zeros_like(m_over)

    def step(acc, c_acc, d_ids_acc, d_clocks_acc, e2, c_rep, d2i, d2c):
        out, over_m = _step_members(acc, e2, c_acc, c_rep, union_valid, m_cap)
        c_new = torch.maximum(c_acc, c_rep)
        out, d_ids_o, d_clocks_o, over_d = _step_deferred(
            union_ids, out, c_new, d_ids_acc, d_clocks_acc, d2i, d2c, d_cap,
        )
        return out, c_new, d_ids_o, d_clocks_o, over_m, over_d

    for rr in range(1, r):
        e2 = _align_to_union(union_ids, ids[rr], dots[rr])
        acc, c_acc, d_ids_acc, d_clocks_acc, om, od = step(
            acc, c_acc, d_ids_acc, d_clocks_acc, e2, clock[rr], dids[rr], dclocks[rr]
        )
        m_over, d_over = m_over | om, d_over | od
    if plunger:
        acc, c_acc, d_ids_acc, d_clocks_acc, om, od = step(
            acc, c_acc, d_ids_acc, d_clocks_acc, acc, c_acc, d_ids_acc, d_clocks_acc,
        )
        m_over, d_over = m_over | om, d_over | od

    # --- canonical compaction (ascending member id) ---
    live = _nonempty(acc) & union_valid
    keys = torch.where(live, union_ids, torch.full((), INT32_MAX, dtype=torch.int32,
                                                   device=acc.device))
    ids_out, dots_out, _ = _rank_select(keys, live, union_ids, acc, m_cap)
    return (c_acc, ids_out, dots_out, d_ids_acc, d_clocks_acc,
            torch.stack([m_over, d_over], dim=-1))


def fold_plan(st, d_cap: int, u_cap: int) -> dict:
    """The instantiation, alignment path and copy route
    ``csrc/orswot_fold_aligned.cu`` takes for these biased ``[R, N, ...]``
    CUDA planes: ``{"union_slots": 16 in registers, 0 in shared memory,
    "actors_per_lane": 2 in registers, 0 in shared memory, "bulk": bool,
    "align": "match" (one __match_any_sync per replica) | "loop"}``."""
    a, m, d = st[0].shape[-1], st[1].shape[-1], st[3].shape[-1]
    code = _build.library("orswot_fold_aligned").orswot_fold_aligned_plan(
        st[0].data_ptr(), st[1].data_ptr(), st[2].data_ptr(), st[4].data_ptr(), a, m, d, d_cap,
        u_cap)
    return {"union_slots": code % 10000 // 100, "actors_per_lane": code // 10 % 10,
            "bulk": bool(code % 10), "align": "match" if code // 10000 else "loop"}


def fold_merge(clock, ids, dots, dids, dclocks, m_cap: int, d_cap: int,
               u_cap: int | None = None, plunger: bool = True, prebiased: bool = False):
    """Anti-entropy fold of ``R`` stacked replica fleets (``[R, N, ...]``
    planes) into one ``[N, ...]`` state.  ``u_cap`` bounds the distinct
    members per object across all replicas (default ``2 * m_cap``).
    Counters are ``torch.uint32`` or, with ``prebiased=True``, biased
    int32 in and out.  Returns ``(clock, ids, dots, d_ids, d_clocks,
    overflow)``."""
    if u_cap is None:
        u_cap = 2 * m_cap
    st = _enter((clock, ids, dots, dids, dclocks), prebiased)
    if st[0].dim() != 3:
        raise ValueError(f"fold_merge takes [R, N, A] planes, got clock {tuple(st[0].shape)}")
    r, n, a = st[0].shape
    m, d = st[1].shape[-1], st[3].shape[-1]
    if r == 1 and not plunger and d != d_cap:
        raise ValueError("a one-replica fold without plunger keeps the deferred capacity")
    if not st[0].is_cuda:
        return _leave(fold_merge_reference(*st, m_cap, d_cap, u_cap, plunger), prebiased)
    _check_planes((st,), 2)
    lib = _build.library("orswot_fold_aligned")
    per_warp = lib.orswot_fold_aligned_smem_per_warp(a, d, d_cap, u_cap, r, m, m_cap)
    if per_warp > _SMEM_LIMIT:
        raise ValueError(
            f"union-aligned fold needs {per_warp} B of shared memory per object "
            f"(A={a}, u_cap={u_cap}, D={d}, d_cap={d_cap}, R={r}, M={m}); the card offers "
            f"{_SMEM_LIMIT} B per block — lower u_cap or use fold_merge_sequential"
        )
    out = _empty_out(n, a, m_cap, d_cap, st[0].device)
    _build.launch(
        "orswot_fold_aligned", "orswot_fold_aligned_launch",
        *_ptrs(st), *_ptrs(out),
        r, n, a, m, d, m_cap, d_cap, u_cap, int(plunger),
        torch.cuda.current_stream(st[0].device).cuda_stream,
        nbytes=_nbytes((*st, *out)),
    )
    return _leave(out[:5], prebiased) + (out[5].bool(),)
