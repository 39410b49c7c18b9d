"""Random dense ORSWOT state for benchmarks, smoke runs and tests.

Numpy copies of the JAX package's generators (same random draws in the
same order, so one seed gives both packages the same fleets), plus
:func:`build_fleet_planes` in PyTorch: it expands the compact
:func:`fleet_columns` encoding into dense planes ON the device, so only
the columns cross the host link.

Invariants a valid ORSWOT batch holds (`orswot.rs:26-30`):

* member ids are unique within an object;
* live member slots carry non-empty dot clocks;
* the set clock covers every entry dot.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import EMPTY, ZERO32


def random_orswot_arrays(
    rng, n, a, m, d, dtype=np.uint32, max_counter=100,
    min_live=1, deferred_frac=0.0,
):
    """Random valid dense ORSWOT batch of ``n`` objects as numpy arrays
    ``(clock, ids, dots, d_ids, d_clocks)`` (unsigned counters).

    ``min_live`` raises the lower bound of members per object;
    ``deferred_frac`` plants one causally-ahead deferred remove row on
    that fraction of objects."""
    ids = np.full((n, m), -1, dtype=np.int32)
    dots = np.zeros((n, m, a), dtype=dtype)
    live = rng.randint(min(min_live, m), m + 1, size=n)
    base = rng.randint(0, 1 << 20, size=n)
    stride = rng.randint(1, 64, size=n)
    for j in range(m):
        mask = live > j
        k = int(mask.sum())
        if k == 0:
            continue
        ids[mask, j] = (base[mask] + j * stride[mask]) % (1 << 24)
        actor = rng.randint(0, a, size=k)
        dots[mask, j, actor] = rng.randint(1, max_counter, size=k)
    clock = dots.max(axis=1)
    d_ids = np.full((n, d), -1, dtype=np.int32)
    d_clocks = np.zeros((n, d, a), dtype=dtype)
    if deferred_frac > 0 and d > 0:
        _plant_deferred(rng, deferred_frac, live, clock, ids, d_ids, d_clocks, dtype)
    return clock, ids, dots, d_ids, d_clocks


def _plant_deferred(rng, frac, live, clock, ids, d_ids, d_clocks, dtype):
    """Give ``frac`` of the objects one causally-future deferred remove: a
    live member cited under a clock one tick past what the set witnessed
    for a random actor (`orswot.rs:195-203`)."""
    n, a = clock.shape
    hit = (rng.rand(n) < frac) & (live > 0)
    rows = np.where(hit)[0]
    if rows.size == 0:
        return
    slot = np.argmax(ids[rows] != -1, axis=1)  # first live slot
    d_ids[rows, 0] = ids[rows, slot]
    actor = rng.randint(0, a, size=rows.size)
    ahead = clock[rows, actor].astype(np.int64) + 1
    d_clocks[rows, 0, actor] = ahead.astype(dtype)


def anti_entropy_fleets(
    rng, n, a, m_cap, d, r, base=6, novel=1, present_p=0.9,
    deferred_frac=0.0, dtype=np.uint32, max_counter=100,
):
    """R replica fleets of the same N logical objects, shaped like an
    anti-entropy round: every replica holds most of a shared ``base``
    member set (concurrent per-replica dots on the shared members) plus
    ``novel`` members only it has witnessed; ``deferred_frac`` plants
    causally-future removes on fleet 0.  The union is bounded by
    ``base + r*novel <= m_cap``.

    Returns a list of ``r`` numpy tuples ``(clock, ids, dots, d_ids,
    d_clocks)``."""
    if base + r * novel > m_cap:
        raise ValueError(
            f"union bound base+r*novel = {base + r * novel} exceeds m_cap={m_cap}"
        )
    base_val = rng.randint(0, 1 << 20, size=n)
    stride = rng.randint(1, 64, size=n)

    def member_id(slot_no):
        return (base_val + slot_no * stride) % (1 << 24)

    fleets = []
    for rep in range(r):
        ids = np.full((n, m_cap), -1, dtype=np.int32)
        dots = np.zeros((n, m_cap, a), dtype=dtype)
        slot = 0
        for j in range(base):
            present = rng.rand(n) < present_p
            ids[present, slot] = member_id(j)[present]
            actor = rng.randint(0, a, size=n)
            cnt = rng.randint(1, max_counter, size=n)
            dots[np.arange(n)[present], slot, actor[present]] = cnt[present]
            slot += 1
        for j in range(novel):
            ids[:, slot] = member_id(base + rep * novel + j)
            actor = rng.randint(0, a, size=n)
            dots[np.arange(n), slot, actor] = rng.randint(1, max_counter, size=n)
            slot += 1
        clock = dots.max(axis=1)
        d_ids = np.full((n, d), -1, dtype=np.int32)
        d_clocks = np.zeros((n, d, a), dtype=dtype)
        if rep == 0 and deferred_frac > 0 and d > 0:
            live = (ids != -1).sum(axis=1)
            _plant_deferred(
                rng, deferred_frac, live, clock, ids, d_ids, d_clocks, dtype
            )
        fleets.append((clock, ids, dots, d_ids, d_clocks))
    return fleets


def fleet_columns(
    rng, n, a, m_cap, d, r, base=6, novel=1, present_p=0.9,
    deferred_frac=0.0, max_counter=100,
):
    """Compact column encoding of an anti-entropy fleet: the same
    statistical shape as :func:`anti_entropy_fleets`, ~200x smaller than
    the dense planes.  Ship THESE to the device and let
    :func:`build_fleet_planes` expand them there.

    Returns a dict of numpy arrays."""
    if base + r * novel > m_cap:
        raise ValueError(
            f"union bound base+r*novel = {base + r * novel} exceeds m_cap={m_cap}"
        )
    if a > 256 or max_counter > 255:
        raise ValueError("columns encode actor/counter as uint8")
    s = base + novel
    return {
        "base_val": rng.randint(0, 1 << 20, size=n).astype(np.uint32),
        "stride": rng.randint(1, 64, size=n).astype(np.uint8),
        "present": rng.rand(r, base, n) < present_p,
        "actor": rng.randint(0, a, size=(r, s, n)).astype(np.uint8),
        "counter": rng.randint(1, max_counter, size=(r, s, n)).astype(np.uint8),
        "def_hit": (
            rng.rand(n) < deferred_frac
            if deferred_frac > 0 and d > 0
            else np.zeros(n, dtype=bool)
        ),
        "def_actor": rng.randint(0, a, size=n).astype(np.uint8),
    }


def build_fleet_planes(cols, *, a, m_cap, d, base, novel, device=None):
    """Dense fleet planes from :func:`fleet_columns` output, built on
    ``device`` (default ``"cuda"``): only the columns are copied over.

    Member id for logical slot ``k`` is ``(base_val + k*stride) % 2^24``;
    slots ``[0, base)`` are the shared members gated by ``present``, slot
    ``base+j`` of replica ``rep`` is its novel member ``base + rep*novel +
    j``.  Replica 0 gets one deferred remove row on ``def_hit`` objects:
    its first live member cited one tick past the set clock for
    ``def_actor``.

    Returns ``(clock, ids, dots, d_ids, d_clocks)`` with leading axes
    ``[r, n, ...]``, counters biased int32 (u32 counters in the package
    domain, :mod:`crdt_tpu_torch.dtypes`)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    col = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in cols.items()}
    base_val = col["base_val"].to(torch.int64)
    stride = col["stride"].to(torch.int64)
    present = col["present"]
    actor = col["actor"].to(torch.int64)
    counter = col["counter"].to(torch.int32)
    r, s, n = actor.shape

    j = torch.arange(s, device=dev)[None, :, None]  # [1, S, 1]
    rep = torch.arange(r, device=dev)[:, None, None]  # [r, 1, 1]
    slot_no = torch.where(j < base, j, base + rep * novel + (j - base))
    mid = ((base_val[None, None, :] + slot_no * stride[None, None, :]) % (1 << 24)).to(torch.int32)
    pres = torch.cat(
        [present, torch.ones((r, s - base, n), dtype=torch.bool, device=dev)], dim=1
    )  # [r, S, n]
    ids_s = torch.where(pres, mid, torch.full_like(mid, EMPTY))  # [r, S, n]
    onehot = torch.arange(a, device=dev)[None, None, None, :] == actor[..., None]
    # counters are < 255, so the biased value is counter + ZERO32
    dots_s = torch.where(
        onehot & pres[..., None], counter[..., None] + ZERO32,
        torch.full((), ZERO32, dtype=torch.int32, device=dev),
    )  # [r, S, n, a]

    ids = torch.full((r, n, m_cap), EMPTY, dtype=torch.int32, device=dev)
    dots = torch.full((r, n, m_cap, a), ZERO32, dtype=torch.int32, device=dev)
    ids[:, :, :s] = ids_s.permute(0, 2, 1)
    dots[:, :, :s] = dots_s.permute(0, 2, 1, 3)
    clock = dots.amax(dim=2)  # [r, n, a]

    d_ids = torch.full((r, n, d), EMPTY, dtype=torch.int32, device=dev)
    d_clocks = torch.full((r, n, d, a), ZERO32, dtype=torch.int32, device=dev)
    live0 = ids[0] != EMPTY
    hit = col["def_hit"] & live0.any(dim=-1)
    first_slot = torch.argmax(live0.to(torch.int32), dim=-1)  # [n]
    first_mid = torch.gather(ids[0], 1, first_slot[:, None])[:, 0]
    d_ids[0, :, 0] = torch.where(hit, first_mid, torch.full_like(first_mid, EMPTY))
    def_actor = col["def_actor"].to(torch.int64)
    ahead = torch.gather(clock[0], 1, def_actor[:, None])[:, 0] + 1
    oh_def = torch.arange(a, device=dev)[None, :] == def_actor[:, None]
    d_clocks[0, :, 0, :] = torch.where(
        oh_def & hit[:, None], ahead[:, None],
        torch.full((), ZERO32, dtype=torch.int32, device=dev),
    )
    return clock, ids, dots, d_ids, d_clocks


def random_map(rng, val: str = "mvreg", m=None, n_keys=5, n_actors=6, max_ops=10, rm_p=0.3,
               counters=(1, 2, 3, 4, 5), max_val=9, actor0=0):
    """Random op-built scalar ``Map<int, V>`` (`test/map.rs:13-46` idiom),
    ``V`` an MVReg (``val="mvreg"``), an Orswot (``"orswot"``) or a
    ``Map<int, MVReg>`` (``"map"``); ``m`` continues an existing map.  Each
    op is a Map remove (probability ``rm_p``) or an update under a dot of
    a random actor in ``[actor0, actor0 + n_actors)`` and a counter drawn
    from ``counters``: a put, an add or
    a nested remove, and in a nested map a put or an inner remove.
    Removes ahead of the clock are buffered as deferred rows."""
    from ..scalar.map import Map, Rm, Up
    from ..scalar.mvreg import MVReg, Put
    from ..scalar.orswot import Add, Orswot, Rm as SetRm
    from ..scalar.vclock import Dot
    from .serde import MapOf

    if m is None:
        m = Map({"mvreg": MVReg, "orswot": Orswot, "map": MapOf(MVReg)}[val])
    for _ in range(int(rng.randint(0, max_ops + 1))):
        actor, key = actor0 + int(rng.randint(n_actors)), int(rng.randint(n_keys))
        dot = Dot(actor, int(counters[rng.randint(len(counters))]))
        clock, x, nested_rm = dot.to_vclock(), int(rng.randint(max_val)), rng.rand() < 0.3
        if rng.rand() < rm_p:
            m.apply(Rm(clock=clock, key=key))
            continue
        if val == "mvreg":
            op = Put(clock=clock, val=x)
        elif val == "orswot":
            op = SetRm(clock=clock, member=x) if nested_rm else Add(dot=dot, member=x)
        else:
            ikey = int(rng.randint(n_keys))
            op = Rm(clock=clock, key=ikey) if nested_rm else Up(
                dot=dot, key=ikey, op=Put(clock=clock, val=x))
        m.apply(Up(dot=dot, key=key, op=op))
    return m


def plant_dominated_deferred(batch, rows, dup: int = 0) -> int:
    """Write into ``batch``'s planes, in place, a deferred remove of the
    member in slot 0 of each of ``rows`` that holds one, with the row's
    own clock as its context, in the last deferred slot, and an exact
    duplicate of the first ``dup`` of them in the slot before: deferred
    rows the object's clock dominates, which settling replays and
    clears.  Those slots must be empty.  Returns the rows planted."""
    idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=batch.ids.device)
    idx = idx[batch.ids[idx, 0] != EMPTY]
    for slot, at in ((-1, idx), (-2, idx[:dup])):
        if bool((batch.d_ids[at, slot] != EMPTY).any()):
            raise ValueError(f"deferred slot {slot} is taken in a planted row")
        batch.d_ids[at, slot] = batch.ids[at, 0]
        batch.d_clocks[at, slot] = batch.clock[at]
    return int(idx.numel())
