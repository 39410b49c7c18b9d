"""Parity of the port's read front-end (``crdt_tpu_torch.serve``) with the
JAX package's, on the CPU, exact: ``gather`` for all six kinds at u32 and
u64 (counters at and above 2^31 and 2^63, a u32 row summing past 2^32, a
u64 row wrapping), ``contains`` probes on present, absent and negative
members, ``value()``/``len()`` reads, the empty batch and the
out-of-range ``IndexError``, a mixed-kind ``QueryEngine``, the
consistency rulings, and ``read_ctx`` rows against the port's scalar
``ReadCtx``.  Both packages read the same numpy planes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu import serve as jax_serve
from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.lwwreg_batch import LWWRegBatch as JaxLWWRegBatch
from crdt_tpu.batch.map_batch import MapBatch as JaxMapBatch
from crdt_tpu.batch.mvreg_batch import MVRegBatch as JaxMVRegBatch
from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.batch.val_kernels import MVRegKernel as JaxMVRegKernel
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CrdtConfig, GCounterBatch, LWWRegBatch, MapBatch, MapKernel, MVRegBatch, MVRegKernel,
    OrswotBatch, PNCounterBatch, QueryEngine, Universe, gather,
)
from crdt_tpu_torch import serve
from crdt_tpu_torch.scalar import Orswot
from crdt_tpu_torch.serve import consistency

torch.set_num_threads(1)

N, A, M, D, K = 96, 6, 5, 3, 4
BITS = (32, 64)


def _counters(rng, shape, bits, sparse=0.5):
    """Counters with a share at and above the signed boundary and at the
    top of the range, zero where ``sparse`` says."""
    top = (1 << bits) - 1
    half = 1 << (bits - 1)
    pool = np.array([0, 1, 2, 7, 99, half - 1, half, half + 1, top - 1, top], dtype=np.uint64)
    x = pool[rng.randint(0, pool.size, size=shape)]
    x[rng.rand(*shape) < sparse] = 0
    return x.astype(np.uint32 if bits == 32 else np.uint64)


def _unique_ids(rng, n, width, live_p=0.7, space=40):
    """int32 ids unique per row, -1 where empty."""
    ids = np.stack([rng.permutation(space)[:width] for _ in range(n)]).astype(np.int32)
    ids[rng.rand(n, width) > live_p] = -1
    return ids


def _orswot(bits, seed):
    rng = np.random.RandomState(seed)
    ids = _unique_ids(rng, N, M)
    dots = _counters(rng, (N, M, A), bits) * (ids != -1)[..., None]
    clock = np.maximum(dots.max(axis=1), _counters(rng, (N, A), bits))
    d_ids = _unique_ids(rng, N, D)
    d_clocks = _counters(rng, (N, D, A), bits) * (d_ids != -1)[..., None]
    planes = (clock, ids, dots, d_ids, d_clocks)
    return (JaxOrswotBatch(*(jnp.asarray(x) for x in planes)),
            OrswotBatch.from_numpy(*planes, device="cpu"), ids)


def _probes(rng, ids, obj):
    """Members: present in the row, absent, -1 (whole object) and -7."""
    b = obj.size
    member = rng.randint(0, 60, b).astype(np.int32)
    present = ids[obj, rng.randint(0, ids.shape[1], b)]
    pick = rng.rand(b)
    member[pick < 0.4] = present[pick < 0.4]
    member[(pick >= 0.4) & (pick < 0.55)] = -1
    member[(pick >= 0.55) & (pick < 0.6)] = -7
    return member


def _same_frame(got, want):
    for f in ("obj", "kind", "member", "status", "val", "add_clock", "rm_clock", "token"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert sorted(got.extras) == sorted(want.extras)
    for k, w in want.extras.items():
        g = got.extras[k]
        if isinstance(w, dict):  # QueryEngine: {kind: (idx, col)}
            assert sorted(g) == sorted(w)
            for kind, (wi, wc) in w.items():
                np.testing.assert_array_equal(g[kind][0], wi)
                assert g[kind][1].dtype == wc.dtype, k
                np.testing.assert_array_equal(g[kind][1], wc, err_msg=k)
        else:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("bits", BITS)
def test_orswot_gather_matches_jax(bits):
    jb, pb, ids = _orswot(bits, 1 + bits)
    rng = np.random.RandomState(bits)
    for b in (1, 7, 8, 9, 300):  # the JAX side pads each to its power-of-two ladder
        obj = rng.randint(0, N, b)
        member = _probes(rng, ids, obj)
        _same_frame(gather(pb, obj, member=member), jax_serve.gather(jb, obj, member=member))
    obj = np.arange(N)
    _same_frame(gather(pb, obj), jax_serve.gather(jb, obj))


def _flat(kind, bits, seed):
    rng = np.random.RandomState(seed)
    if kind == "gcounter":
        c = _counters(rng, (N, A), bits, sparse=0.2)
        return JaxGCounterBatch(clocks=jnp.asarray(c)), GCounterBatch.from_numpy(c, device="cpu")
    if kind == "pncounter":
        c = _counters(rng, (N, 2, A), bits, sparse=0.2)
        return (JaxPNCounterBatch(planes=jnp.asarray(c)),
                PNCounterBatch.from_numpy(c, device="cpu"))
    if kind == "lww":
        v, m = _counters(rng, (N,), 64, 0.1), _counters(rng, (N,), 64, 0.1)
        return (JaxLWWRegBatch(vals=jnp.asarray(v), markers=jnp.asarray(m)),
                LWWRegBatch.from_numpy(v, m, device="cpu"))
    c = _counters(rng, (N, K, A), bits) * (rng.rand(N, K, 1) < 0.6)
    v = _counters(rng, (N, K), bits, 0.0) * c.any(-1)
    return (JaxMVRegBatch(clocks=jnp.asarray(c), vals=jnp.asarray(v)),
            MVRegBatch.from_numpy(c, v, device="cpu"))


@pytest.mark.parametrize("kind", ["gcounter", "pncounter", "lww", "mvreg"])
@pytest.mark.parametrize("bits", BITS)
def test_flat_gathers_match_jax(kind, bits):
    jb, pb = _flat(kind, bits, 10 + bits)
    rng = np.random.RandomState(3)
    for b in (1, 8, 130):
        obj = rng.randint(0, N, b)
        _same_frame(gather(pb, obj), jax_serve.gather(jb, obj))


def test_counter_sums_take_the_jax_widths():
    """A u32 row summing past 2^32 does not wrap; a u64 row wraps mod
    2^64; PN's P − N is two's complement."""
    u32 = np.array([[2**31, 2**31, 5], [0, 0, 0]], np.uint32)
    u64 = np.array([[2**63, 2**63, 5], [1, 0, 0]], np.uint64)
    for c in (u32, u64):
        got = gather(GCounterBatch.from_numpy(c, device="cpu"), [0, 1])
        want = jax_serve.gather(JaxGCounterBatch(clocks=jnp.asarray(c)), [0, 1])
        _same_frame(got, want)
    assert int(gather(GCounterBatch.from_numpy(u32, device="cpu"), [0]).val[0]) == 4294967301
    pn = np.stack([u64[::-1], u64], axis=1)  # P = [1,0,0], N = [2^63, 2^63, 5]
    got = gather(PNCounterBatch.from_numpy(pn, device="cpu"), [0])
    _same_frame(got, jax_serve.gather(JaxPNCounterBatch(planes=jnp.asarray(pn)), [0]))
    assert int(got.val[0]) == (1 - 5) % (1 << 64)


def _maps(bits, seed, n=N):
    kw = dict(num_actors=A, key_capacity=K, deferred_capacity=D, mv_capacity=2, counter_bits=bits)
    juni, uni = JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))
    rng = np.random.RandomState(seed)
    keys = _unique_ids(rng, n, K, space=12)
    eclocks = _counters(rng, (n, K, A), bits) * (keys != -1)[..., None]
    clock = np.maximum(eclocks.max(axis=1), _counters(rng, (n, A), bits))
    jb = JaxMapBatch.zeros(n, juni, JaxMVRegKernel.from_config(juni.config))
    jb = jb.replace(clock=jnp.asarray(clock), keys=jnp.asarray(keys),
                    entry_clocks=jnp.asarray(eclocks))
    state = tuple(np.asarray(x) if not isinstance(x, tuple) else tuple(map(np.asarray, x))
                  for x in jb.state)
    vk = MVRegKernel.from_config(uni.config)
    return jb, MapBatch.from_numpy(*state, MapKernel.from_config(uni.config, vk),
                                   device="cpu"), keys


@pytest.mark.parametrize("bits", BITS)
def test_map_gather_matches_jax(bits):
    jb, pb, keys = _maps(bits, 20 + bits)
    rng = np.random.RandomState(4)
    for b in (1, 8, 200):
        obj = rng.randint(0, N, b)
        key = _probes(rng, keys, obj)
        _same_frame(gather(pb, obj, member=key), jax_serve.gather(jb, obj, member=key))


def test_empty_batch_range_check_and_counts():
    jb, pb, _ = _orswot(32, 5)
    _same_frame(gather(pb, []), jax_serve.gather(jb, []))
    for bad in ([0, N], [-1, 2]):
        with pytest.raises(IndexError) as want:
            jax_serve.gather(jb, bad)
        with pytest.raises(IndexError, match=str(want.value).replace("[", r"\[").replace(")", r"\)")):
            gather(pb, bad)
    with pytest.raises(TypeError):
        gather(object(), [0])
    serve.query.reset_read_counts()
    gather(pb, [0, 3, 3])
    gather(pb, [])
    assert serve.read_counts() == {"reads": 3, "batches": 2}


def test_mixed_kind_engine_matches_jax():
    jo, po, ids = _orswot(32, 6)
    jg, pg = _flat("gcounter", 64, 7)
    jp, pp = _flat("pncounter", 32, 8)
    jl, pl = _flat("lww", 64, 9)
    jm, pm = _flat("mvreg", 32, 10)
    jmap, pmap, keys = _maps(32, 11)
    jeng = jax_serve.QueryEngine({0: jo, 1: jg, 2: jp, 3: jl, 4: jm, 5: jmap})
    peng = QueryEngine({0: po, 1: pg, 2: pp, 3: pl, 4: pm, 5: pmap})
    assert peng.width() == jeng.width()
    rng = np.random.RandomState(12)
    obj = rng.randint(0, N, 500)
    kind = rng.randint(0, 6, 500).astype(np.uint8)
    member = _probes(rng, ids, obj)
    _same_frame(peng.gather(obj, kind, member), jeng.gather(obj, kind, member))
    with pytest.raises(ValueError):
        peng.gather(obj)
    with pytest.raises(ValueError):
        QueryEngine({0: po}).gather(obj[:3], kind=1)
    _same_frame(QueryEngine(po).gather(obj[:5]), jax_serve.QueryEngine(jo).gather(obj[:5]))


def test_read_ctx_rows_equal_the_scalar_read_ctx():
    """Gathered rows bridge to the port's scalar ``ReadCtx`` exactly."""
    uni = Universe.identity(CrdtConfig(num_actors=4, member_capacity=8, deferred_capacity=2))
    rng = np.random.RandomState(13)
    sets = []
    for _ in range(24):
        s = Orswot()
        for _ in range(rng.randint(1, 7)):
            s.apply(s.add(int(rng.randint(0, 12)), s.value().derive_add_ctx(int(rng.randint(0, 4)))))
        if rng.rand() < 0.5 and s.value().val:
            s.apply(s.remove(sorted(s.value().val)[0], s.value().derive_rm_ctx()))
        sets.append(s)
    batch = OrswotBatch.from_scalar(sets, uni, device="cpu")
    obj = rng.randint(0, 24, 400)
    member = rng.randint(-1, 14, 400).astype(np.int32)
    frame = gather(batch, obj, member=member)
    for i, o in enumerate(obj):
        want = sets[o].value() if member[i] < 0 else sets[o].contains(int(member[i]))
        got = frame.read_ctx(i, uni)
        assert got.add_clock.dots == want.add_clock.dots, i
        assert got.rm_clock.dots == want.rm_clock.dots, i
        assert got.val == (len(want.val) if member[i] < 0 else int(bool(want.val))), i
        assert frame.read_ctx(i).add_clock.dots == want.add_clock.dots


def test_consistency_rulings_match_jax():
    rng = np.random.RandomState(14)
    jc = jax_serve.consistency
    for _ in range(200):
        vis = rng.randint(0, 4, rng.randint(0, 6)).astype(np.uint64)
        req = None if rng.rand() < 0.1 else rng.randint(0, 4, rng.randint(0, 6)).astype(np.uint64)
        assert consistency.covers(vis, req) == jc.covers(vis, req)
        for mode in consistency.MODES:
            fr = None if rng.rand() < 0.5 else vis
            assert tuple(consistency.admit(mode, req, vis, fr)) == tuple(jc.admit(mode, req, vis, fr))
    with pytest.raises(ValueError):
        consistency.admit("bogus", None, [])
    assert consistency.MODE_CODES == jc.MODE_CODES


@pytest.mark.parametrize("widths", [(6, 6), (6, 4), (4, 6)])
def test_stability_statuses_match_jax(widths):
    jb, pb, ids = _orswot(64, 15)
    rng = np.random.RandomState(16)
    obj = rng.randint(0, N, 300)
    frame, jframe = gather(pb, obj), jax_serve.gather(jb, obj)
    frame = dataclasses.replace(frame, add_clock=frame.add_clock[:, :widths[0]])
    jframe = dataclasses.replace(jframe, add_clock=jframe.add_clock[:, :widths[0]])
    span = 16
    for _ in range(5):
        sub = np.asarray(frame.add_clock[rng.randint(0, 300, 6)][:, :widths[1]])
        sub = np.pad(sub, ((0, 0), (0, max(0, widths[1] - sub.shape[1]))))
        got = consistency.stability_statuses(frame, sub, span)
        want = jax_serve.consistency.stability_statuses(jframe, sub, span)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert {0, 1} >= set(got.tolist())
    assert consistency.stability_statuses(frame, None, span).tolist() == [0] * 300
