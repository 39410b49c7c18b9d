"""Parity of the port's op path with the JAX package, on the CPU at small
sizes, with exact equality: the clock ops, ``apply_add``/``apply_remove``
(one op per object), the batched causal contexts, ``OpApplier.apply_ops``
over a sequence of batches (duplicates, in-batch re-delivery, gaps that
park and release, remove rounds, deferral, capacity overflow), the op
frame codec with its rejection matrix, the op log, and the whole slice:
op frames through ``PipelinedOpLoop`` with and without overlap."""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.wireloop import PipelinedOpLoop as JaxPipelinedOpLoop
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import CapacityOverflowError as JaxCapacityOverflowError
from crdt_tpu.error import OpLogOverflowError as JaxOpLogOverflowError
from crdt_tpu.ops import clock_ops as jax_clock_ops, orswot_ops as jax_orswot_ops
from crdt_tpu.oplog import OpApplier as JaxOpApplier, OpBatch as JaxOpBatch, OpLog as JaxOpLog
from crdt_tpu.oplog import decode_ops_frame as jax_decode, derive_add_ctx as jax_derive_add
from crdt_tpu.oplog import derive_rm_ctx as jax_derive_rm, encode_ops_frame as jax_encode
from crdt_tpu.scalar.ctx import sequential_add_ctxs as jax_sequential_add_ctxs
from crdt_tpu.scalar.orswot import Orswot as JaxOrswot
from crdt_tpu.scalar.vclock import VClock as JaxVClock
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CapacityOverflowError, CrdtConfig, OpLogOverflowError, OrswotBatch, PipelinedOpLoop,
    SyncProtocolError, Universe, WireFormatError,
)
from crdt_tpu_torch.dtypes import bias_np, counters_to_numpy
from crdt_tpu_torch.ops import clock_ops, orswot_ops
from crdt_tpu_torch.oplog import (
    OP_ADD, OP_INC, OP_RM, OPLOG_PROTOCOL_VERSION, OpApplier, OpBatch, OpLog,
    decode_ops_frame, derive_add_ctx, derive_rm_ctx, encode_ops_frame, frame_bytes_per_op,
    intern_ops,
)
from crdt_tpu_torch.oplog import wire as port_wire
from crdt_tpu_torch.scalar.ctx import sequential_add_ctxs
from crdt_tpu_torch.scalar.vclock import VClock
from crdt_tpu_torch.utils.testdata import random_orswot_arrays

torch.set_num_threads(1)

A, M, D = 8, 16, 4
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")
COLS = ("kind", "obj", "actor", "counter", "member")


def _unis(**kw):
    cfg = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=32)
    cfg.update(kw)
    return JaxUniverse.identity(JaxConfig(**cfg)), Universe.identity(CrdtConfig(**cfg))


def _base_fleet(n, seed, juni, members=12):
    """A JAX fleet from states the scalar engine built (canonical), and the
    same planes as a port batch on the CPU."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        s = JaxOrswot()
        for _ in range(rng.randint(1, 5)):
            s.apply(s.add(int(rng.randint(0, members)), s.value().derive_add_ctx(
                int(rng.randint(0, 3)))))
        if rng.rand() < 0.3:  # a remove whose clock is ahead: a deferred row
            m = int(rng.randint(0, members))
            ahead = s.clock.clone()
            ahead.apply(ahead.inc(int(rng.randint(0, A))))
            s.apply(s.remove(m, type(s.contains(m).derive_rm_ctx())(clock=ahead)))
        out.append(s)
    jb = JaxOrswotBatch.from_scalar(out, juni, via_device=False)
    return jb, _port(jb)


def _port(jb):
    return OrswotBatch.from_numpy(*(np.asarray(getattr(jb, k)) for k in PLANES), device="cpu")


def _assert_same(tb, jb):
    for name, g, w in zip(PLANES, tb.to_numpy(), (np.asarray(getattr(jb, k)) for k in PLANES)):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_ops(got, want):
    for c in COLS:
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c), err_msg=c)
        assert getattr(got, c).dtype == getattr(want, c).dtype, c
    if want.rm_clocks is None:
        assert got.rm_clocks is None
    else:
        np.testing.assert_array_equal(got.rm_clocks, want.rm_clocks)


def _jax_ops(ops):
    return JaxOpBatch(**{c: getattr(ops, c) for c in COLS}, rm_clocks=ops.rm_clocks)


# -- clock ops -------------------------------------------------------------------


@pytest.mark.parametrize("bits", [32, 64])
def test_clock_ops_match_jax(bits):
    dt = np.uint32 if bits == 32 else np.uint64
    rng = np.random.RandomState(bits)
    a = rng.randint(0, 4, size=(64, 5)).astype(dt)
    b = rng.randint(0, 4, size=(64, 5)).astype(dt)
    a[0], b[1] = np.iinfo(dt).max, np.iinfo(dt).max - 1
    ta, tb = torch.from_numpy(bias_np(a)), torch.from_numpy(bias_np(b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("truncate", "merge"):
        got = counters_to_numpy(getattr(clock_ops, name)(ta, tb))
        np.testing.assert_array_equal(got, np.asarray(getattr(jax_clock_ops, name)(ja, jb)))
    for name in ("dominates_or_eq", "lt", "concurrent", "leq", "eq", "is_empty"):
        args = (ta,) if name == "is_empty" else (ta, tb)
        jargs = (ja,) if name == "is_empty" else (ja, jb)
        np.testing.assert_array_equal(getattr(clock_ops, name)(*args).numpy(),
                                      np.asarray(getattr(jax_clock_ops, name)(*jargs)), name)
    actor = rng.randint(0, 5, size=64)
    cnt = rng.randint(0, 6, size=64).astype(dt)
    got = clock_ops.witness(ta, torch.from_numpy(actor), torch.from_numpy(bias_np(cnt)))
    np.testing.assert_array_equal(counters_to_numpy(got), np.asarray(jax_clock_ops.witness(
        ja, jnp.asarray(actor), jnp.asarray(cnt))))
    got = clock_ops.inc_counter(ta, torch.from_numpy(actor))
    np.testing.assert_array_equal(counters_to_numpy(got), np.asarray(
        jax_clock_ops.inc_counter(ja, jnp.asarray(actor))))
    small = a % 7
    np.testing.assert_array_equal(clock_ops.value_sum(torch.from_numpy(bias_np(small))).numpy(),
                                  np.asarray(jax_clock_ops.value_sum(jnp.asarray(small))))
    z = clock_ops.zeros((3, 5), ta.dtype)
    assert counters_to_numpy(z).tolist() == [[0] * 5] * 3


# -- one op per object -------------------------------------------------------------


@pytest.mark.parametrize("m,d", [(16, 2), (3, 1)])
def test_apply_add_and_remove_match_jax(m, d):
    """On random fleets with deferred rows (and, at M=3 and D=1, full
    member and deferred tables): the planes and both overflow flags, and
    the methods raise CapacityOverflowError where the JAX ones do."""
    rng = np.random.RandomState(m)
    n = 48
    planes = random_orswot_arrays(rng, n, A, m, d, max_counter=8, deferred_frac=0.5)
    jplanes = tuple(jnp.asarray(x) for x in planes)
    tplanes = OrswotBatch.from_numpy(*planes, device="cpu")
    tp = tuple(getattr(tplanes, k) for k in PLANES)
    actor = rng.randint(0, A, n)
    counter = rng.randint(1, 12, n).astype(np.uint32)
    member = np.where(rng.rand(n) < 0.5, planes[1][:, 0], rng.randint(0, 1 << 24, n))
    member = member.astype(np.int32)
    want = jax_orswot_ops.apply_add(*jplanes, jnp.asarray(actor), jnp.asarray(counter),
                                    jnp.asarray(member))
    got = orswot_ops.apply_add(*tp, torch.from_numpy(actor), torch.from_numpy(bias_np(counter)),
                               torch.from_numpy(member))
    for k, (g, w) in enumerate(zip(got, want)):
        g = counters_to_numpy(g) if k in (0, 2, 4) else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))
    assert bool(got[5].any()) == (m == 3)
    # half the remove clocks are ahead of the set clock, a fifth are empty
    rm_clock = (planes[0] + (rng.rand(n, A) < 0.2) * (rng.rand(n, 1) < 0.5)).astype(np.uint32)
    rm_clock[rng.rand(n) < 0.2] = 0
    want = jax_orswot_ops.apply_remove(*jplanes, jnp.asarray(rm_clock), jnp.asarray(member))
    got = orswot_ops.apply_remove(*tp, torch.from_numpy(bias_np(rm_clock)),
                                  torch.from_numpy(member))
    for k, (g, w) in enumerate(zip(got, want)):
        g = counters_to_numpy(g) if k in (0, 2, 4) else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))
    assert bool(got[5].any()) == (d == 1)

    jb = JaxOrswotBatch(*jplanes)
    for op, args in (("apply_add", (actor, counter, member)), ("apply_remove", (rm_clock, member))):
        try:
            want_b, want_err = getattr(jb, op)(*(jnp.asarray(x) for x in args)), None
        except JaxCapacityOverflowError as e:
            want_b, want_err = None, (e.member, e.deferred)
        try:
            got_b, got_err = getattr(tplanes, op)(*args), None
        except CapacityOverflowError as e:
            got_b, got_err = None, (e.member, e.deferred)
        assert got_err == want_err, op
        if want_b is not None:
            _assert_same(got_b, want_b)
        _assert_same(getattr(tplanes, op)(*args, check=False),
                     getattr(jb, op)(*(jnp.asarray(x) for x in args), check=False))


# -- causal contexts -------------------------------------------------------------


def test_derive_add_ctx_matches_jax_and_the_scalar_loop():
    """Interleaved actors on one object, fresh actors (an implied 0) and
    many writes per (object, actor): the counter column and the ctx clocks
    equal JAX's and the scalar loop's; near 2^32 - 1 the u32 width wraps
    in both packages, and the scalar loop agrees modulo 2^32."""
    rng = np.random.RandomState(11)
    for case in range(8):
        n, a = int(rng.randint(1, 12)), int(rng.randint(2, 7))
        b = int(rng.randint(1, 64))
        dt = (np.uint64, np.uint32)[case % 2]
        base = rng.randint(0, 9, size=(n, a)).astype(dt)
        base[rng.rand(n) < 0.3] = 0
        if case >= 6:  # near the top of the counter width
            base = (np.iinfo(dt).max - base).astype(dt)
        obj, actor = rng.randint(0, n, b), rng.randint(0, a, b)
        member = rng.randint(0, 50, b)
        ops, ctx = derive_add_ctx(base, obj, actor, member=member, device="cpu")
        jops, jctx = jax_derive_add(base, obj, actor, member=member)
        _assert_ops(ops, jops)
        np.testing.assert_array_equal(ctx, jctx)
        assert ctx.dtype == jctx.dtype
        # the same from the biased plane the fleet holds
        ops2, ctx2 = derive_add_ctx(torch.from_numpy(bias_np(base)), obj, actor, member=member)
        _assert_ops(ops2, jops)
        np.testing.assert_array_equal(ctx2, jctx)
        width = 1 << (8 * base.dtype.itemsize)
        for o in range(n):
            rows = np.nonzero(obj == o)[0]
            if not rows.size:
                continue
            vc = VClock({i: int(base[o, i]) for i in range(a) if base[o, i]})
            for r, want in zip(rows, sequential_add_ctxs(vc, [int(actor[r]) for r in rows])):
                assert int(ops.counter[r]) == want.dot.counter % width
                want_clock = np.zeros(a, np.uint64)
                for act, cnt in want.clock.dots.items():
                    want_clock[act] = cnt % width
                np.testing.assert_array_equal(ctx[r], want_clock)
        # the JAX package's own loop agrees with the port's
        vc = VClock({0: 3})
        jvc = JaxVClock({0: 3})
        assert ([c.dot.counter for c in sequential_add_ctxs(vc, [0, 1, 0])]
                == [c.dot.counter for c in jax_sequential_add_ctxs(jvc, [0, 1, 0])])


def test_derive_rm_ctx_and_bad_inputs_match_jax():
    rng = np.random.RandomState(3)
    base = rng.randint(0, 9, size=(6, 5)).astype(np.uint32)
    obj, member = [1, 4, 4], [0, 2, 7]
    want = jax_derive_rm(base, obj, member)
    _assert_ops(derive_rm_ctx(base, obj, member), want)
    _assert_ops(derive_rm_ctx(torch.from_numpy(bias_np(base)), obj, member), want)
    _assert_ops(derive_rm_ctx(base, [], []), jax_derive_rm(base, [], []))
    zero = np.zeros((4, 4), np.uint64)
    for call in (lambda f: f(zero, [0], [7]), lambda f: f(zero, [0], [0], kind=OP_RM),
                 lambda f: f(zero, [0, 1], [0])):
        with pytest.raises(ValueError) as want_e:
            call(jax_derive_add)
        with pytest.raises(ValueError) as got_e:
            call(lambda *x, **k: derive_add_ctx(*x, device="cpu", **k))
        assert str(got_e.value).split(" ")[:2] == str(want_e.value).split(" ")[:2]
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_derive_rm(zero, [0, 1], [5])
    with pytest.raises(ValueError, match="shape mismatch"):
        derive_rm_ctx(zero, [0, 1], [5])


# -- the applier ---------------------------------------------------------------------


def _both(tapp, japp, tb, jb, ops, check=True):
    """One apply_ops on both sides: equal planes, reports and park buffers,
    or the same error class."""
    try:
        jb2, jrep = japp.apply_ops(jb, _jax_ops(ops), check=check)
        jerr = None
    except (JaxCapacityOverflowError, JaxOpLogOverflowError, ValueError) as e:
        jerr = type(e).__name__
    try:
        tb2, trep = tapp.apply_ops(tb, ops, check=check)
        terr = None
    except (CapacityOverflowError, OpLogOverflowError, ValueError) as e:
        terr = type(e).__name__
    assert terr == jerr
    _assert_ops(tapp.parked, japp.parked)
    if jerr is not None:
        return tb, jb, None
    _assert_same(tb2, jb2)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    return tb2, jb2, trep


def test_apply_ops_sequence_matches_jax():
    juni, tuni = _unis()
    rng = np.random.RandomState(5)
    jb, tb = _base_fleet(24, 5, juni)
    japp, tapp = JaxOpApplier(juni), OpApplier(tuni)
    clock = np.asarray(jb.clock).copy()

    def adds(b, members=12):
        ops, _ = jax_derive_add(clock, rng.randint(0, 24, b), rng.randint(0, A, b),
                                member=rng.randint(0, members, b))
        return ops

    first = adds(40)
    second = adds(30)  # derived from the same clock: its dots collide with first's
    np.maximum.at(clock, (first.obj, first.actor), first.counter)
    later = adds(20)  # ahead of `first`: parks until `first` lands
    np.maximum.at(clock, (later.obj, later.actor), later.counter)

    tb, jb, rep = _both(tapp, japp, tb, jb, later)
    assert rep.parked > 0 and rep.still_parked == rep.parked
    tb, jb, rep = _both(tapp, japp, tb, jb, OpBatch.concat([first, first]))  # in-batch re-delivery
    assert rep.released > 0 and rep.duplicates > 0 and rep.still_parked == 0
    tb, jb, rep = _both(tapp, japp, tb, jb, OpBatch.concat([second, first]))  # duplicates
    assert rep.duplicates >= len(first)

    # removes: several rounds on some objects, some clocks ahead (defer)
    vals = jb.value_sets(juni)
    robj = np.asarray([o for o in (0, 0, 0, 3, 3, 7, 9, 9, 11) if vals[o]], np.int64)
    rmem = np.asarray([sorted(vals[o])[i % len(vals[o])] for i, o in enumerate(robj)], np.int32)
    rms = jax_derive_rm(np.asarray(jb.clock), robj, rmem)
    rms.rm_clocks[1::3, 5] += 1  # a dot not yet seen: the remove defers
    tb, jb, rep = _both(tapp, japp, tb, jb, OpBatch.concat([rms, adds(10)]))
    assert rep.rm_rounds == 3 and rep.applied_rms == len(robj)
    assert (np.asarray(jb.d_ids) != -1).any()

    # the deferred removes fire when their dot arrives; a u64 counter
    # past the u32 width wraps on the way in, as in JAX
    clock = np.asarray(jb.clock).copy()
    tb, jb, rep = _both(tapp, japp, tb, jb, adds(16))
    big = OpBatch(kind=[OP_ADD], obj=[2], actor=[1], counter=[(1 << 32) + 1 + int(clock[2, 1])],
                  member=[3])
    tb, jb, rep = _both(tapp, japp, tb, jb, big)

    # capacity overflow: more new members than free slots on one object
    flood = OpBatch(kind=[OP_ADD] * M, obj=[1] * M, actor=np.arange(M) % A,
                    counter=[int(clock[1, a]) + 1 + i // A for i, a in enumerate(np.arange(M) % A)],
                    member=1000 + np.arange(M))
    tb, jb, rep = _both(tapp, japp, tb, jb, flood)
    assert rep is None
    # the park buffer bound
    small_t, small_j = OpApplier(tuni, park_capacity=2), JaxOpApplier(juni, park_capacity=2)
    gapped = OpBatch(kind=[OP_ADD] * 3, obj=[0] * 3, actor=[6] * 3, counter=[50, 51, 52],
                     member=[1, 2, 3])
    _both(small_t, small_j, tb, jb, gapped)
    wide_t, wide_j = OpApplier(tuni), JaxOpApplier(juni)
    _both(wide_t, wide_j, tb, jb, gapped)
    assert wide_t.occupancy() == wide_j.occupancy()
    assert wide_t.prune(lambda b: b.counter > 50) == wide_j.prune(lambda b: b.counter > 50)
    _assert_ops(wide_t.parked, wide_j.parked)
    assert orswot_ops.member_mask(tb.ids).tolist() == (np.asarray(jb.ids) != -1).tolist()
    with pytest.raises(ValueError, match="counter/lww|counter and LWW"):
        tapp.apply_ops(tb, OpBatch(kind=[OP_INC], obj=[0], actor=[0], counter=[1], member=[-1]))
    assert tapp.counts["ops"] > 0 and tapp.counts["rm_rounds"] >= 3


def test_apply_ops_matches_the_scalar_apply_loop():
    juni, tuni = _unis()
    rng = np.random.RandomState(6)
    jb, tb = _base_fleet(16, 6, juni)
    states = _jax_scalar(jb, juni)
    obj, actor, member = rng.randint(0, 16, 60), rng.randint(0, A, 60), rng.randint(0, 12, 60)
    ops, _ = derive_add_ctx(tb.clock, obj, actor, member=member)
    tb2, rep = OpApplier(tuni).apply_ops(tb, ops)
    assert rep.applied_adds == 60 and rep.merge_steps == 1
    for r in range(60):
        s = states[int(obj[r])]
        s.apply(s.add(int(member[r]), s.value().derive_add_ctx(int(actor[r]))))
    from crdt_tpu.utils.serde import to_binary as jax_to_binary
    from crdt_tpu_torch.utils.serde import to_binary

    assert [to_binary(s) for s in tb2.to_scalar(tuni)] == [jax_to_binary(s) for s in states]


def _jax_scalar(jb, juni):
    """Scalar states of a JAX batch, without its native egress."""
    clock, ids, dots, d_ids, d_clocks = (np.asarray(getattr(jb, k)) for k in PLANES)
    out = []
    for i in range(clock.shape[0]):
        s = JaxOrswot()
        for a in np.nonzero(clock[i])[0].tolist():
            s.clock.dots[a] = int(clock[i, a])
        for j in np.nonzero(ids[i] != -1)[0].tolist():
            s.entries[int(ids[i, j])] = JaxVClock(
                {a: int(dots[i, j, a]) for a in np.nonzero(dots[i, j])[0].tolist()})
        for r in np.nonzero(d_ids[i] != -1)[0].tolist():
            vc = JaxVClock({a: int(d_clocks[i, r, a]) for a in np.nonzero(d_clocks[i, r])[0].tolist()})
            s.deferred.setdefault(vc.key(), set()).add(int(d_ids[i, r]))
        out.append(s)
    return out


# -- the op frame ---------------------------------------------------------------------


def test_ops_frames_are_byte_equal_to_jax():
    juni, _ = _unis()
    rng = np.random.RandomState(21)
    base = rng.randint(0, 9, size=(16, A)).astype(np.uint64)
    adds, _ = jax_derive_add(base, rng.randint(0, 16, 40), rng.randint(0, A, 40),
                             member=rng.randint(0, 12, 40))
    rms = jax_derive_rm(base, [2, 9], [0, 1])
    for ops in (OpBatch.concat([adds, rms]), adds, OpBatch.empty()):
        frame = encode_ops_frame(ops)
        assert frame == jax_encode(_jax_ops(ops))
        back = decode_ops_frame(frame, num_actors=A)
        _assert_ops(back, jax_decode(frame, num_actors=A))
        assert port_wire.frame_op_count(frame) == len(ops)
        if len(ops):
            assert frame_bytes_per_op(ops) == len(frame) / len(ops)


def _reframe(frame, pos, value):
    """``frame`` with payload byte ``pos`` set and the CRC made right."""
    f = bytearray(frame)
    f[pos] = value
    struct.pack_into("<I", f, 2, zlib.crc32(bytes(f[14:])))
    return bytes(f)


def _faults():
    one = OpBatch(kind=[OP_ADD], obj=[0], actor=[1], counter=[1], member=[3])
    frame = encode_ops_frame(one)
    tampered = bytearray(frame)
    tampered[-1] ^= 0xFF
    return {
        "truncated": (frame[:6], None),
        "version_mismatch": (bytes([OPLOG_PROTOCOL_VERSION + 1]) + frame[1:], None),
        "unknown_type": (frame[:1] + b"\x7f" + frame[2:], None),
        "length_mismatch": (frame[:-3], None),
        "crc_mismatch": (bytes(tampered), None),
        "bad_kind": (_reframe(frame, 20, 99), None),
        "actor_range": (encode_ops_frame(OpBatch(kind=[OP_ADD], obj=[0], actor=[7], counter=[1],
                                                 member=[0])), 4),
        "clock_on_non_rm": (encode_ops_frame(OpBatch(kind=[OP_ADD], obj=[0], actor=[0],
                                                     counter=[1], member=[0],
                                                     rm_clocks=np.ones((1, 4), np.uint64))),
                            None),
        "clock_actor_range": (encode_ops_frame(OpBatch(kind=[OP_RM], obj=[0], actor=[0],
                                                       counter=[0], member=[0],
                                                       rm_clocks=np.ones((1, 6), np.uint64))),
                              4),
        "trailing_bytes": (_trailing(frame), None),
        "truncated_column": (_short_column(frame), None),
    }


def _trailing(frame):
    payload = frame[14:] + b"\x00"
    return struct.pack("<BBIQ", frame[0], frame[1], zlib.crc32(payload), len(payload)) + payload


def _short_column(frame):
    payload = frame[14:20]  # the column header only
    return struct.pack("<BBIQ", frame[0], frame[1], zlib.crc32(payload), len(payload)) + payload


@pytest.mark.parametrize("reason", list(_faults()))
def test_ops_frame_rejections_match_jax(reason):
    frame, num_actors = _faults()[reason]
    with pytest.raises(Exception) as want:
        jax_decode(frame, num_actors=num_actors)
    before = port_wire.rejected_counts().get(reason, 0)
    with pytest.raises((SyncProtocolError, WireFormatError)) as got:
        decode_ops_frame(frame, num_actors=num_actors)
    assert type(got.value).__name__ == type(want.value).__name__
    assert port_wire.rejected_counts()[reason] == before + 1


def test_op_log_matches_jax():
    juni, tuni = _unis()
    jlog, tlog = JaxOpLog(juni, capacity=10), OpLog(tuni, capacity=10)
    ops = OpBatch(kind=[OP_ADD] * 6, obj=[0] * 6, actor=[2] * 6, counter=[1, 2, 3, 4, 5, 6],
                  member=[0] * 6)
    for log in (jlog, tlog):
        log.append(ops if log is tlog else _jax_ops(ops))
    np.testing.assert_array_equal(tlog.watermark, jlog.watermark)
    with pytest.raises(JaxOpLogOverflowError):
        jlog.append(_jax_ops(ops))
    with pytest.raises(OpLogOverflowError, match="capacity"):
        tlog.append(ops)
    assert tlog.occupancy() == jlog.occupancy()
    assert tlog.compact(lambda b: b.counter > 4) == jlog.compact(lambda b: b.counter > 4)
    _assert_ops(tlog.pending(), jlog.pending())
    _assert_ops(tlog.drain(), jlog.drain())
    assert len(tlog) == 0 and int(tlog.watermark[2]) == 6 and tlog.appended_total == 6


def test_intern_ops_matches_jax():
    from crdt_tpu.oplog import intern_ops as jax_intern_ops
    from crdt_tpu.utils.interning import Registry as JaxRegistry
    from crdt_tpu_torch.utils.interning import Registry

    cfg = dict(num_actors=8, member_capacity=4, deferred_capacity=1)
    juni, tuni = JaxUniverse(JaxConfig(**cfg)), Universe(CrdtConfig(**cfg))
    names = (["b", "a", "b", 3], ["x", "y", "x", "z"], ["o1", "o2", "o1", "o3"])
    want = jax_intern_ops(juni, *names, object_registry=JaxRegistry())
    got = intern_ops(tuni, *names, object_registry=Registry())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    with pytest.raises(ValueError, match="object_registry"):
        intern_ops(tuni, ["a"], objects=["o"])


# -- the whole slice: frames through the loop -------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
def test_pipelined_op_loop_matches_jax(overlap):
    """Op frames (adds, removes with rounds and deferral, a frame before its
    predecessor, a re-delivered frame) through the port's loop and the JAX
    loop: bit-equal planes and equal counts."""
    juni, tuni = _unis()
    rng = np.random.RandomState(31)
    jb, tb = _base_fleet(40, 31, juni)
    clock = np.asarray(jb.clock).copy()
    frames = []
    for k in range(6):
        b = int(rng.randint(8, 40))
        ops, _ = jax_derive_add(clock, rng.randint(0, 40, b), rng.randint(0, A, b),
                                member=rng.randint(0, 12, b))
        np.maximum.at(clock, (ops.obj, ops.actor), ops.counter)
        robj = rng.randint(0, 40, 4)
        rms = jax_derive_rm(clock, robj, rng.randint(0, 12, 4).astype(np.int32))
        rms.rm_clocks[0, rng.randint(A)] += 1
        frames.append(jax_encode(JaxOpBatch.concat([ops, rms])))
    frames[2], frames[3] = frames[3], frames[2]
    frames.append(frames[0])
    jout, jst = JaxPipelinedOpLoop(juni).run(jb, frames, overlap=overlap)
    tout, tst = PipelinedOpLoop(tuni).run(tb, frames, overlap=overlap)
    _assert_same(tout, jout)
    for k in ("frames", "ops", "applied", "duplicates", "still_parked", "pipeline"):
        assert tst[k] == jst[k], k
    assert tst["duplicates"] > 0
    _assert_same(tb, jb)  # the loop left its input batch as it was
