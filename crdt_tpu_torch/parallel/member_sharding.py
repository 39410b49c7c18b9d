"""Member-universe sharding: a set too big for one member table,
hash-partitioned over a ``members`` mesh axis (the port of
``crdt_tpu/parallel/member_sharding.py``; SURVEY.md §5).

Why a shard-local merge is exact (`orswot.rs:89-156`): a member's dot
algebra needs only both sides' dots for it and both set clocks.  Members
route by ``member_id % S``, so a member sits on the same shard on both
sides, and each shard carries a copy of the full set clock, joined alike
on every shard by a merge.  A deferred remove of member ``m`` routes to
``m``'s shard and replays there.  The one collective is after op
application: an ``Add`` witnesses its dot on the owning shard only, so
:func:`rebroadcast_clock` joins the clock copies by an ``all_reduce``
MAX over the ``members`` group.

State: the ORSWOT 5-tuple with a leading shard axis, ``clock [S, N, A]``
(copies), ``ids [S, N, Mс]``, ``dots [S, N, Mс, A]``, ``d_ids [S, N,
Dс]``, ``d_clocks [S, N, Dс, A]``; the logical capacity is ``S × Mс``.
One rank holds the contiguous shard rows ``[r·S/W, (r+1)·S/W)`` of a
world of W (biased counters on its device); the host-side partition
works on whole unsigned numpy planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import EMPTY, zero_of
from ..error import raise_for_overflow
from ..ops import orswot_ops


def member_shard(member_ids, n_shards: int):
    """Routing hash: the shard that owns each (non-negative) member id."""
    return member_ids % n_shards


def _slots(key: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Each entry's slot: its place, in ``order``, among the entries of
    equal ``key``."""
    k = key[order]
    starts = np.r_[0, np.flatnonzero(k[1:] != k[:-1]) + 1]
    slot = np.empty_like(order)
    slot[order] = np.arange(k.size) - np.repeat(starts, np.diff(np.r_[starts, k.size]))
    return slot


def partition_dense(clock, ids, dots, d_ids, d_clocks, n_shards: int, m_cap_shard: int,
                    d_cap_shard: int):
    """Host-side: split unsigned ``[N, ...]`` planes into member-sharded
    ``[S, N, ...]`` planes (numpy), the set clock copied into every shard
    row and each shard's slots in input order.  Raises ``ValueError``
    when a shard overflows its capacity (size ``m_cap_shard`` to at
    least ``ceil(m_cap / n_shards)`` plus slack)."""
    clock = np.asarray(clock)
    n = clock.shape[0]
    out = [np.broadcast_to(clock, (n_shards,) + clock.shape).copy()]
    for table, payload, cap, what in ((ids, dots, m_cap_shard, "members"),
                                      (d_ids, d_clocks, d_cap_shard, "deferred")):
        table, payload = np.asarray(table), np.asarray(payload)
        obj, col = np.nonzero(table != EMPTY)
        mids = table[obj, col]
        shard = member_shard(mids, n_shards)
        key = shard * n + obj
        slot = _slots(key, np.argsort(key, kind="stable"))
        if (slot >= cap).any():  # the first in input order
            k = np.flatnonzero(slot >= cap)[0]
            raise ValueError(f"{what}: shard {int(shard[k])} object {int(obj[k])} "
                             f"exceeds per-shard capacity {cap}")
        out_ids = np.full((n_shards, n, cap), EMPTY, dtype=table.dtype)
        out_pay = np.zeros((n_shards, n, cap) + payload.shape[2:], dtype=payload.dtype)
        out_ids[shard, obj, slot] = mids
        out_pay[shard, obj, slot] = payload[obj, col]
        out += [out_ids, out_pay]
    return tuple(out)


def unpartition_dense(s_clock, s_ids, s_dots, s_dids, s_dclocks, m_cap: int, d_cap: int):
    """Host-side inverse of :func:`partition_dense`: one dense table per
    plane, members in ascending-id order, deferred rows in shard order."""
    s_clock = np.asarray(s_clock)
    n = s_clock.shape[1]
    out = [s_clock.max(axis=0)]  # copies of one clock: the max is a no-op join
    for src, payload, cap, sort_ids in ((s_ids, s_dots, m_cap, True),
                                        (s_dids, s_dclocks, d_cap, False)):
        src, payload = np.asarray(src), np.asarray(payload)
        sh, obj, col = np.nonzero(src != EMPTY)
        mids = src[sh, obj, col]
        order = np.lexsort((mids, obj)) if sort_ids else np.argsort(obj, kind="stable")
        slot = _slots(obj, order)
        if (slot >= cap).any():  # the first in collect order
            raise ValueError(f"object {int(obj[order][slot[order] >= cap][0])} exceeds "
                             f"capacity {cap} on collect")
        out_ids = np.full((n, cap), EMPTY, dtype=src.dtype)
        out_pay = np.zeros((n, cap) + payload.shape[3:], dtype=payload.dtype)
        out_ids[obj, slot] = mids
        out_pay[obj, slot] = payload[sh, obj, col]
        out += [out_ids, out_pay]
    return tuple(out)


def _group(mesh, axis: str, kernel: str):
    from ..mesh.contracts import require_shardable
    from .mesh import axis_size

    require_shardable(kernel, axis_size(mesh, axis))
    return mesh.get_group(axis)


def _raise_everywhere(overflow, group, context: str) -> None:
    """Raise on every rank of ``group`` when any rank's ``overflow``
    flags (``[..., 2]``) are set: one SUM of the two flags' counts."""
    import torch.distributed as dist

    flags = overflow.reshape(-1, 2).sum(0)
    dist.all_reduce(flags, group=group)
    raise_for_overflow(flags > 0, context)


def member_sharded_merge(state_a, state_b, mesh, axis: str = "members", check: bool = True,
                         impl: str | None = None):
    """Pairwise merge of two member-sharded states on this rank's shard
    rows: the merge (the merge kernel on the card) over the rows with the
    copied set clocks, no collective but the overflow check's (``check``:
    a SUM of the flags, so every rank raises or none).  Returns the
    merged 5-tuple."""
    from .collective import shard_local_merge_fn

    m_cap, d_cap = state_a[1].shape[-1], state_a[3].shape[-1]
    lead = state_a[0].shape[:2]
    flat = [tuple(x.flatten(0, 1) for x in s) for s in (state_a, state_b)]
    state, overflow = shard_local_merge_fn(mesh, axis, m_cap, d_cap, impl)(*flat)
    if check:
        _raise_everywhere(overflow, mesh.get_group(axis), "member-sharded merge")
    return tuple(x.unflatten(0, lead) for x in state)


def rebroadcast_clock(state, mesh, axis: str = "members"):
    """Join the set-clock copies: the MAX over this rank's shard rows,
    then an ``all_reduce`` MAX over the ``axis`` group, broadcast back to
    every row.  Needed after op application and before the next merge."""
    from .collective import all_reduce_clock_join

    _group(mesh, axis, "parallel.member_clock_join")
    return (all_reduce_clock_join(state[0], mesh, axis), *state[1:])


def sharded_apply_add(state, actor_idx, counter, member_id, mesh, axis: str = "members"):
    """Batched ``Op::Add`` (one op per object; ``[N]`` tensors, ``counter``
    biased) against a member-sharded state: every shard row sees the op,
    only the owner (``member_id % S``) applies it, then the clock
    rebroadcast restores coherence."""
    group = _group(mesh, axis, "parallel.member_apply_add")
    k = state[0].shape[0]
    n_shards = k * group.size()
    first = mesh.get_local_rank(axis) * k
    rows = torch.arange(first, first + k, device=member_id.device)
    mine = member_shard(member_id.to(torch.int64), n_shards)[None, :] == rows[:, None]
    # a non-owner applies counter 0, which is always already witnessed
    cnt = torch.where(mine, counter[None, :], zero_of(counter.dtype))
    *out, overflow = orswot_ops.apply_add(*state, actor_idx.expand(k, -1), cnt,
                                          member_id.expand(k, -1))
    # an add overflows its member slots only (JAX reads its [S, N] flags
    # as [..., 2] pairs)
    _raise_everywhere(torch.stack([overflow, torch.zeros_like(overflow)], -1), group,
                      "member-sharded add")
    return rebroadcast_clock(tuple(out), mesh, axis)
