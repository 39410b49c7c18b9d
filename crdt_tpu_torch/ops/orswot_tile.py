"""The pairwise ORSWOT tile merge and its sequential fold — the port of
``crdt_tpu/ops/orswot_pallas.py`` (its ``merge`` and ``fold_merge``
kernels) and ``crdt_tpu/ops/orswot_unrolled.py``.

Two versions of each function:

* the plain PyTorch tile math (:func:`_merge_tile` and its helpers,
  :func:`merge_reference`, :func:`fold_merge_reference`), written over
  whole slot axes at once, in the kernels' biased-int32 domain;
* the kernel wrappers :func:`merge` (``csrc/orswot_merge.cu``) and
  :func:`fold_merge` (``csrc/orswot_fold.cu``), which launch the CUDA
  kernel for CUDA tensors and take the plain version only for CPU
  tensors.  There is no fallback: a kernel that does not build or launch
  raises.

Semantics follow `orswot.rs:89-156`: member alignment by O(M²) id
compares, the three-way dot rule, deferred union with keep-first dedup,
clock join, deferred replay, retention of still-ahead rows, then
canonical compaction — members by ascending id into ``m_cap`` slots,
deferred rows in first-occurrence order into ``d_cap`` slots — by rank
selection.  Counters are 32-bit only (biased int32 inside; ``u64``
batches take the rank path of :mod:`~crdt_tpu_torch.ops.orswot_ops`).
"""

from __future__ import annotations

import torch

from .. import _build
from ..dtypes import EMPTY, INT32_MAX, ZERO32, bias_torch_u32, unbias_torch_u32
from ..error import KernelError

ZERO = ZERO32
_COUNTER_PLANES = (0, 2, 4)


def _zt(x):
    return torch.full((), ZERO, dtype=torch.int32, device=x.device)


def _sub(a, b):
    return torch.where(a > b, a, _zt(a))


def _nonempty(clock):
    return (clock != ZERO).any(dim=-1)


def _align_against(ids_a, dots_a, ids_b, dots_b):
    """For each a-slot, the matching b dot clock (``ZERO`` rows where
    unmatched), plus the mask of b-slots consumed by a match."""
    valid_a = ids_a != EMPTY
    match = valid_a[..., :, None] & (ids_a[..., :, None] == ids_b[..., None, :])
    if ids_b.shape[-1] == 0:
        return torch.full_like(dots_a, ZERO), match.any(dim=-2)
    e2 = torch.where(match[..., None], dots_b[..., None, :, :], _zt(dots_a)).amax(dim=-2)
    return e2, match.any(dim=-2)


def _merge_rule(e1, e2, p1, p2, valid, self_clock, other_clock):
    """The three-way per-member dot rule (`orswot.rs:92-138`)."""
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
    """Output slot ``k`` takes the source slots ``sel[..., k, :]`` marks:
    ids as the masked sum of ``id + 1`` minus one, clocks as the masked
    max (one hot in valid state)."""
    ids = torch.where(sel, payload_ids[..., None, :] + 1, 0).sum(dim=-1) - 1
    if payload_clocks.shape[-2] == 0:
        clocks = torch.full(sel.shape[:-1] + payload_clocks.shape[-1:], ZERO,
                            dtype=torch.int32, device=sel.device)
    else:
        clocks = torch.where(
            sel[..., None], payload_clocks[..., None, :, :], _zt(payload_clocks)
        ).amax(dim=-2)
    return ids.to(torch.int32), clocks


def _rank_select(keys, live, payload_ids, payload_clocks, cap):
    """Pack live slots in ascending-``keys`` order into ``cap`` output
    slots (keys unique among live slots).  Returns ``(ids [..., cap],
    clocks [..., cap, A], overflow [...])``."""
    smaller = live[..., :, None] & live[..., None, :] & (keys[..., None, :] < keys[..., :, None])
    rank = smaller.sum(dim=-1)  # live slots with a smaller key
    k = torch.arange(cap, device=keys.device)
    sel = live[..., None, :] & (rank[..., None, :] == k[:, None])  # [..., cap, S]
    ids, clocks = _select(sel, payload_ids, payload_clocks)
    return ids, clocks, live.sum(dim=-1) > cap


def _rank_select_slots(live, payload_ids, payload_clocks, cap):
    """Deferred-table pack: live slots in slot (first-occurrence) order —
    the rank of slot ``j`` is the count of live slots before it."""
    live_i = live.to(torch.int64)
    rank = live_i.cumsum(dim=-1) - live_i
    k = torch.arange(cap, device=live.device)
    sel = live[..., None, :] & (rank[..., None, :] == k[:, None])
    ids, clocks = _select(sel, payload_ids, payload_clocks)
    return ids, clocks, live_i.sum(dim=-1) > cap


def _dedup_live(d_ids, d_clocks):
    """Valid deferred rows that no earlier row repeats (same id and
    clock) — keep-first dedup (`orswot.rs:141-148`)."""
    d_valid = d_ids != EMPTY
    same = (
        d_valid[..., :, None] & d_valid[..., None, :]
        & (d_ids[..., :, None] == d_ids[..., None, :])
        & (d_clocks[..., :, None, :] == d_clocks[..., None, :, :]).all(dim=-1)
    )  # [..., j, i]
    dn = d_ids.shape[-1]
    earlier = torch.ones((dn, dn), dtype=torch.bool, device=d_ids.device).tril(-1)
    return d_valid & ~(same & earlier).any(dim=-1)


def _replay_rm(slot_ids, d_ids, d_live, d_clocks, like):
    """Per slot, the join of the live deferred clocks citing its id."""
    if d_ids.shape[-1] == 0:
        return torch.full_like(like, ZERO)
    match = (slot_ids[..., :, None] == d_ids[..., None, :]) & d_live[..., None, :]
    return torch.where(match[..., None], d_clocks[..., None, :, :], _zt(like)).amax(dim=-2)


def _merge_tile(sa, sb, m_cap: int, d_cap: int):
    """Full pairwise merge of two states ``(clock [T,A], ids [T,M], dots
    [T,M,A], d_ids [T,D], d_clocks [T,D,A])`` in the biased-int32 domain;
    returns the merged state at ``m_cap``/``d_cap`` slots and ``overflow
    bool[T, 2]``."""
    ca, ids_a, dots_a, dida, dca = sa
    cb, ids_b, dots_b, didb, dcb = sb
    z = _zt(ca)

    # --- member alignment + dot algebra (`orswot.rs:92-138`) ---
    e2_for_a, b_matched = _align_against(ids_a, dots_a, ids_b, dots_b)
    valid_a = ids_a != EMPTY
    valid_b = ids_b != EMPTY
    out_a = _merge_rule(
        dots_a, e2_for_a, valid_a & _nonempty(dots_a), valid_a & _nonempty(e2_for_a),
        valid_a, ca, cb,
    )
    b_only = valid_b & ~b_matched
    out_b = torch.where(b_only[..., None], _sub(dots_b, ca[..., None, :]), z)
    empty = torch.full((), EMPTY, dtype=torch.int32, device=ca.device)
    ids_cat = torch.cat(
        [torch.where(valid_a, ids_a, empty), torch.where(b_only, ids_b, empty)], dim=-1
    )
    dots_cat = torch.cat([out_a, out_b], dim=-2)

    # --- deferred union + dedup, keep first (`orswot.rs:141-148`) ---
    d_ids = torch.cat([dida, didb], dim=-1)
    d_clocks = torch.cat([dca, dcb], dim=-2)
    d_live = _dedup_live(d_ids, d_clocks)
    d_ids = torch.where(d_live, d_ids, empty)
    d_clocks = torch.where(d_live[..., None], d_clocks, z)

    # --- clock join (`orswot.rs:153`) then deferred replay (`:155`) ---
    clock = torch.maximum(ca, cb)
    new_dots = _sub(dots_cat, _replay_rm(ids_cat, d_ids, d_live, d_clocks, dots_cat))
    live = _nonempty(new_dots) & (ids_cat != EMPTY)
    still_ahead = d_live & ~(d_clocks <= clock[..., None, :]).all(dim=-1)

    # --- canonical compaction ---
    m_keys = torch.where(live, ids_cat, torch.full((), INT32_MAX, dtype=torch.int32,
                                                   device=ca.device))
    ids_out, dots_out, m_over = _rank_select(m_keys, live, ids_cat, new_dots, m_cap)
    dids_out, dclk_out, d_over = _rank_select_slots(still_ahead, d_ids, d_clocks, d_cap)
    return (clock, ids_out, dots_out, dids_out, dclk_out), torch.stack([m_over, d_over], dim=-1)


def merge_reference(
    clock_a, ids_a, dots_a, dids_a, dclocks_a,
    clock_b, ids_b, dots_b, dids_b, dclocks_b,
    m_cap: int, d_cap: int,
):
    """Plain PyTorch pairwise merge on biased-int32 planes; returns
    ``(clock, ids, dots, d_ids, d_clocks, overflow)``."""
    out, over = _merge_tile(
        (clock_a, ids_a, dots_a, dids_a, dclocks_a),
        (clock_b, ids_b, dots_b, dids_b, dclocks_b), m_cap, d_cap,
    )
    return out + (over,)


def fold_merge_reference(clock, ids, dots, dids, dclocks, m_cap: int, d_cap: int,
                         plunger: bool = True):
    """Plain PyTorch sequential fold of ``[R, N, ...]`` biased-int32
    planes: R-1 tile merges, then the plunger self-merge."""
    refs = (clock, ids, dots, dids, dclocks)
    acc = tuple(x[0] for x in refs)
    over = torch.zeros(clock.shape[1:-1] + (2,), dtype=torch.bool, device=clock.device)
    for r in range(1, clock.shape[0]):
        acc, o = _merge_tile(acc, tuple(x[r] for x in refs), m_cap, d_cap)
        over = over | o
    if plunger:
        acc, o = _merge_tile(acc, acc, m_cap, d_cap)
        over = over | o
    return acc + (over,)


# ---------------------------------------------------------------------------
# kernel domain and wrappers
# ---------------------------------------------------------------------------


def to_kernel_domain(state):
    """Map a 5-tuple with ``torch.uint32`` counter planes into the
    kernels' biased-int32 domain; pair with ``prebiased=True``."""
    return tuple(bias_torch_u32(x) if i in _COUNTER_PLANES else x for i, x in enumerate(state))


def from_kernel_domain(x):
    """Inverse of :func:`to_kernel_domain` for one counter plane."""
    return unbias_torch_u32(x)


def _enter(state, prebiased):
    if prebiased:
        if state[0].dtype != torch.int32:
            raise TypeError(
                f"prebiased planes must be biased int32, got {state[0].dtype}; "
                "use to_kernel_domain() first"
            )
        return tuple(state)
    if state[0].dtype != torch.uint32:
        raise TypeError(
            f"the tile kernels take torch.uint32 counters (or biased int32 with "
            f"prebiased=True), got {state[0].dtype}"
        )
    return to_kernel_domain(state)


def _leave(out, prebiased):
    if prebiased:
        return out
    return tuple(
        from_kernel_domain(x) if i in _COUNTER_PLANES else x for i, x in enumerate(out)
    )


def _check_planes(states, lead: int):
    """Device, dtype, shape and contiguity checks before a launch.
    ``lead`` is the number of leading batch axes every plane shares."""
    dev = states[0][0].device
    a = states[0][0].shape[-1]
    for st in states:
        clock, ids, dots, d_ids, d_clocks = st
        for name, x, dt in (("clock", clock, torch.int32), ("ids", ids, torch.int32),
                            ("dots", dots, torch.int32), ("d_ids", d_ids, torch.int32),
                            ("d_clocks", d_clocks, torch.int32)):
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, expected {dev}")
            if x.dtype != dt:
                raise TypeError(f"{name} must be {dt}, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        batch = clock.shape[:lead]
        m, d = ids.shape[-1], d_ids.shape[-1]
        shapes = (
            (clock, batch + (a,)), (ids, batch + (m,)), (dots, batch + (m, a)),
            (d_ids, batch + (d,)), (d_clocks, batch + (d, a)),
        )
        for x, want in shapes:
            if tuple(x.shape) != tuple(want):
                raise ValueError(f"plane shape {tuple(x.shape)} != {tuple(want)}")
    if states[0][0].shape[:lead] != states[-1][0].shape[:lead]:
        raise ValueError("both sides must share their batch axes")


def _empty_out(n, a, m_cap, d_cap, device):
    i32 = dict(dtype=torch.int32, device=device)
    return (
        torch.empty((n, a), **i32), torch.empty((n, m_cap), **i32),
        torch.empty((n, m_cap, a), **i32), torch.empty((n, d_cap), **i32),
        torch.empty((n, d_cap, a), **i32), torch.empty((n, 2), **i32),
    )


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _nbytes(ts) -> int:
    """Bytes of the planes a launch reads and writes, each once."""
    return sum(t.numel() * t.element_size() for t in ts)


def merge(
    clock_a, ids_a, dots_a, dids_a, dclocks_a,
    clock_b, ids_b, dots_b, dids_b, dclocks_b,
    m_cap: int, d_cap: int, prebiased: bool = False,
):
    """Pairwise tile merge over any leading batch axes.  CUDA tensors
    launch ``csrc/orswot_merge.cu``; CPU tensors run
    :func:`merge_reference`.  Counters are ``torch.uint32`` or, with
    ``prebiased=True``, biased int32 in and out.  Returns ``(clock, ids,
    dots, d_ids, d_clocks, overflow)``."""
    sa = _enter((clock_a, ids_a, dots_a, dids_a, dclocks_a), prebiased)
    sb = _enter((clock_b, ids_b, dots_b, dids_b, dclocks_b), prebiased)
    if not sa[0].is_cuda:
        return _leave(merge_reference(*sa, *sb, m_cap, d_cap), prebiased)
    lead = sa[0].dim() - 1
    _check_planes((sa, sb), lead)
    batch = tuple(sa[0].shape[:-1])
    a = sa[0].shape[-1]
    n = 1
    for s in batch:
        n *= s
    ma, mb = sa[1].shape[-1], sb[1].shape[-1]
    da, db = sa[3].shape[-1], sb[3].shape[-1]
    out = _empty_out(n, a, m_cap, d_cap, sa[0].device)
    _build.launch(
        "orswot_merge", "orswot_merge_launch",
        *_ptrs(sa), *_ptrs(sb), *_ptrs(out),
        n, a, ma, mb, da, db, m_cap, d_cap,
        torch.cuda.current_stream(sa[0].device).cuda_stream,
        nbytes=_nbytes((*sa, *sb, *out)),
    )
    shapes = (batch + (a,), batch + (m_cap,), batch + (m_cap, a), batch + (d_cap,),
              batch + (d_cap, a), batch + (2,))
    res = tuple(x.view(s) for x, s in zip(out, shapes))
    return _leave(res[:5], prebiased) + (res[5].bool(),)


_MERGE_ROUTES = ("words", "bulk", "direct")


def merge_plan(sa, sb, m_cap: int) -> dict:
    """The instantiation, route and alignment path ``csrc/orswot_merge.cu``
    takes for these biased CUDA planes: ``{"actors_per_lane": 2 or 0
    (run-time A), "route": "bulk" | "words" (staged by bulk copies or
    per-lane cp.async) | "direct" (stages too wide for shared memory: read
    from device memory), "align": "match" (one __match_any_sync) |
    "loop"}``."""
    a, ma, mb, da, db = sa[0].shape[-1], sa[1].shape[-1], sb[1].shape[-1], sa[3].shape[-1], \
        sb[3].shape[-1]
    lib = _build.library("orswot_merge")
    code = lib.orswot_merge_plan(*(t.data_ptr() for i, t in enumerate(sa) if i != 3),
                                 *(t.data_ptr() for i, t in enumerate(sb) if i != 3),
                                 a, ma, mb, da, db, m_cap)
    return _decode_plan(lib, "orswot_merge_plan", code)


def _decode_plan(lib, fn: str, code: int) -> dict:
    """A plan code of the merge and fold launchers: 100 * one match + 10 *
    actors per lane + route, or minus a CUDA error."""
    if code < 0:
        raise KernelError(f"{fn}: CUDA error {-code} "
                          f"({lib.orswot_error_string(-code).decode(errors='replace')})")
    return {"actors_per_lane": code % 100 // 10, "route": _MERGE_ROUTES[code % 10],
            "align": "match" if code // 100 else "loop"}


def fold_merge_plan(st, m_cap: int, d_cap: int) -> dict:
    """The instantiation, route and alignment path ``csrc/orswot_fold.cu``
    takes for these biased ``[R, N, ...]`` CUDA planes: ``{"actors_per_lane":
    2 or 0 (run-time A), "route": "bulk" | "words" (replicas staged by bulk
    copies or per-lane cp.async, the accumulator in shared memory) |
    "direct" (too wide for shared memory: merged from device memory, the
    accumulator in a device-memory scratch), "align": "match" (one
    __match_any_sync per fold step) | "loop"}``."""
    a, m, d = st[0].shape[-1], st[1].shape[-1], st[3].shape[-1]
    lib = _build.library("orswot_fold")
    code = lib.orswot_fold_plan(st[0].data_ptr(), st[1].data_ptr(), st[2].data_ptr(),
                                st[4].data_ptr(), a, m, d, m_cap, d_cap)
    return _decode_plan(lib, "orswot_fold_plan", code)


def fold_merge(clock, ids, dots, dids, dclocks, m_cap: int, d_cap: int,
               plunger: bool = True, prebiased: bool = False):
    """Sequential anti-entropy fold of ``[R, N, ...]`` planes into one
    ``[N, ...]`` state (R-1 tile merges and the plunger), bit-exact with
    the sequential fold of pairwise merges.  CUDA tensors launch
    ``csrc/orswot_fold.cu``; CPU tensors run
    :func:`fold_merge_reference`."""
    st = _enter((clock, ids, dots, dids, dclocks), prebiased)
    if not st[0].is_cuda:
        return _leave(fold_merge_reference(*st, m_cap, d_cap, plunger), prebiased)
    if st[0].dim() != 3:
        raise ValueError(f"fold_merge takes [R, N, A] planes, got clock {tuple(st[0].shape)}")
    _check_planes((st,), 2)
    r, n, a = st[0].shape
    m, d = st[1].shape[-1], st[3].shape[-1]
    if r == 1 and not plunger and (m, d) != (m_cap, d_cap):
        raise ValueError("a one-replica fold without plunger keeps the input capacities")
    out = _empty_out(n, a, m_cap, d_cap, st[0].device)
    acc = None  # the direct route's accumulator scratch; the staged routes keep it on chip
    if n and fold_merge_plan(st, m_cap, d_cap)["route"] == "direct":
        lib = _build.library("orswot_fold")
        acc = torch.empty((n, lib.orswot_fold_acc_ints(a, m_cap, d_cap)),
                          dtype=torch.int32, device=st[0].device)
    _build.launch(
        "orswot_fold", "orswot_fold_launch",
        *_ptrs(st), *_ptrs(out), None if acc is None else acc.data_ptr(),
        r, n, a, m, d, m_cap, d_cap, int(plunger),
        torch.cuda.current_stream(st[0].device).cuda_stream,
        nbytes=_nbytes((*st, *out)),
    )
    return _leave(out[:5], prebiased) + (out[5].bool(),)
