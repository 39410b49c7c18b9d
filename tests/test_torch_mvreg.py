"""Parity of the port's MVRegBatch, ``ops/mvreg_ops.py`` and
``batch/val_kernels.MVRegKernel`` with the JAX package: merge (with and
without antichain overflow), ``apply_put``, ``truncate``, ``read_clock``,
``compact``, ``with_capacity``, the scalar round trip, clocks holding
u64 counters at and above 2^63, and a fleet whose merge overflows
``mv_capacity`` regrowing through the port's executor as through the
JAX one."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from crdt_tpu.batch.mvreg_batch import MVRegBatch as JaxMVRegBatch
from crdt_tpu.batch.val_kernels import MVRegKernel as JaxMVRegKernel
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import CapacityOverflowError as JaxCapacityOverflowError
from crdt_tpu.ops import mvreg_ops as jax_mvreg_ops
from crdt_tpu.parallel import JoinExecutor as JaxJoinExecutor, JoinStats as JaxJoinStats
from crdt_tpu.scalar.mvreg import MVReg as JaxMVReg
from crdt_tpu.scalar.vclock import VClock as JaxVClock
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CapacityOverflowError, CrdtConfig, JoinExecutor, JoinStats, MVRegBatch, Universe,
)
from crdt_tpu_torch.batch import mvreg_batch
from crdt_tpu_torch.batch.val_kernels import MVRegKernel
from crdt_tpu_torch.dtypes import counters_to_numpy, payload_to_numpy
from crdt_tpu_torch.ops import mvreg_ops
from crdt_tpu_torch.scalar import MVReg
from crdt_tpu_torch.scalar.vclock import VClock

torch.set_num_threads(1)

N, K, A = 160, 4, 6


def _regs(seed, bits, big=False, k=K):
    """Dense registers: a few live slots, small counters (some at 2^63 and
    above when ``big``), payload ids 0..5 (and one near 2^bits)."""
    rng = np.random.RandomState(seed)
    dt = np.uint32 if bits == 32 else np.uint64
    clocks = rng.randint(0, 4, size=(N, k, A)).astype(np.uint64)
    if big:
        clocks[rng.rand(N, k, A) < 0.1] = np.uint64(1 << 63) + rng.randint(0, 3, dtype=np.uint64)
    clocks *= (rng.rand(N, k, 1) < 0.6)
    vals = rng.randint(0, 6, size=(N, k)).astype(np.uint64)
    vals[3] = (1 << bits) - 1
    vals[~clocks.any(-1)] = 0
    return clocks.astype(dt), vals.astype(dt)


def _jax(c, v):
    return JaxMVRegBatch(clocks=jnp.asarray(c), vals=jnp.asarray(v))


def _port(c, v):
    return MVRegBatch.from_numpy(c, v, device="cpu")


def _same(port, jax_batch):
    c, v = port.to_numpy()
    assert c.dtype == np.asarray(jax_batch.clocks).dtype
    np.testing.assert_array_equal(c, np.asarray(jax_batch.clocks))
    np.testing.assert_array_equal(v, np.asarray(jax_batch.vals))


@pytest.mark.parametrize("bits,big", [(32, False), (64, False), (64, True)])
def test_merge_matches_jax(bits, big):
    a, b = _regs(1, bits, big), _regs(2, bits, big)
    b[0][:10], b[1][:10] = a[0][:10], a[1][:10]  # equal registers dedupe
    _same(_port(*a).merge(_port(*b), check=False), _jax(*a).merge(_jax(*b), check=False))
    with pytest.raises(JaxCapacityOverflowError):
        _jax(*a).merge(_jax(*b))
    with pytest.raises(CapacityOverflowError) as e:
        _port(*a).merge(_port(*b))
    assert (e.value.member, e.value.deferred) == (True, False)
    _same(_port(*a).merge(_port(*a)), _jax(*a).merge(_jax(*a)))


def test_merge_runs_in_object_chunks(monkeypatch):
    a, b = _regs(3, 64, True), _regs(4, 64, True)
    whole = _port(*a).merge(_port(*b), check=False)
    monkeypatch.setattr(mvreg_batch, "_PAIR_ELEMS", 7 * K * K * A)
    chunked = _port(*a).merge(_port(*b), check=False)
    assert torch.equal(whole.clocks, chunked.clocks) and torch.equal(whole.vals, chunked.vals)


@pytest.mark.parametrize("bits,big", [(32, False), (64, True)])
def test_ops_merge_and_compact_match_jax(bits, big):
    a, b = _regs(5, bits, big), _regs(6, bits, big)
    pa, pb = _port(*a), _port(*b)
    want = jax_mvreg_ops.merge(*(jnp.asarray(x) for x in (*a, *b)))
    got = mvreg_ops.merge(pa.clocks, pa.vals, pb.clocks, pb.vals)
    np.testing.assert_array_equal(counters_to_numpy(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(payload_to_numpy(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for k_cap in (1, 3, 2 * K):
        cw = jax_mvreg_ops.compact(*want, k_cap)
        cg = mvreg_ops.compact(*got, k_cap)
        np.testing.assert_array_equal(counters_to_numpy(cg[0]), np.asarray(cw[0]))
        np.testing.assert_array_equal(payload_to_numpy(cg[1]), np.asarray(cw[1]))
        np.testing.assert_array_equal(cg[2].numpy(), np.asarray(cw[2]))
    assert bool(cg[2].any()) is False and bool(mvreg_ops.compact(*got, 1)[2].any())
    np.testing.assert_array_equal(counters_to_numpy(mvreg_ops.read_clock(pa.clocks)),
                                  np.asarray(jax_mvreg_ops.read_clock(jnp.asarray(a[0]))))
    np.testing.assert_array_equal(counters_to_numpy(pa.read_clock()),
                                  np.asarray(_jax(*a).read_clock()))


@pytest.mark.parametrize("bits,big", [(32, False), (64, True)])
def test_apply_put_matches_jax(bits, big):
    a = _regs(7, bits, big)
    rng = np.random.RandomState(8)
    dt = a[0].dtype
    op_c = (np.asarray(_jax(*a).read_clock()) + rng.randint(0, 2, size=(N, A))).astype(dt)
    op_c[::5] = rng.randint(0, 3, size=op_c[::5].shape)  # concurrent or covered puts
    op_c[::11] = 0  # empty clock: a no-op
    op_v = rng.randint(0, 9, size=N).astype(dt)
    _same(_port(*a).apply_put(op_c, op_v, check=False),
          _jax(*a).apply_put(op_c, op_v, check=False))
    tight = _regs(9, bits, big, k=1)
    with pytest.raises(JaxCapacityOverflowError):
        _jax(*tight).apply_put(op_c, op_v)
    with pytest.raises(CapacityOverflowError):
        _port(*tight).apply_put(op_c, op_v)


@pytest.mark.parametrize("bits,big", [(32, False), (64, True)])
def test_truncate_matches_jax(bits, big):
    a = _regs(10, bits, big)
    t = np.array(_jax(*a).read_clock())
    t[::2] = np.random.RandomState(11).randint(0, 3, size=t[::2].shape)
    _same(_port(*a).truncate(t), _jax(*a).truncate(t))


def test_with_capacity_and_kernel_grow_state_match_jax():
    a = _regs(12, 64)
    _same(_port(*a).with_capacity(7), _jax(*a).with_capacity(7))
    assert _port(*a).with_capacity(K).member_capacity == K
    for kw, match in (({"member_capacity": 2}, "shrink"), ({"deferred_capacity": 1}, "deferred")):
        with pytest.raises(ValueError, match=match):
            _port(*a).with_capacity(**kw)
    kern, jkern = MVRegKernel(K, A), JaxMVRegKernel(K, A)
    z = kern.zeros((3,), device="cpu")
    c, v = kern.grow_state(z, MVRegKernel(2 * K, A))
    jc, jv = jkern.grow_state(jkern.zeros((3,)), JaxMVRegKernel(2 * K, A))
    np.testing.assert_array_equal(counters_to_numpy(c), np.asarray(jc))
    np.testing.assert_array_equal(payload_to_numpy(v), np.asarray(jv))
    pa, ja = _port(*a), _jax(*a)
    (pc, pv), pover = kern.merge((pa.clocks, pa.vals), (pa.clocks, pa.vals))
    (wc, wv), wover = jkern.merge((ja.clocks, ja.vals), (ja.clocks, ja.vals))
    np.testing.assert_array_equal(counters_to_numpy(pc), np.asarray(wc))
    np.testing.assert_array_equal(pover.numpy(), np.asarray(wover))


@pytest.mark.parametrize("bits", [32, 64])
def test_scalar_round_trip_matches_jax(bits):
    rng = np.random.RandomState(13)
    pool = ["p", "q", 4, ("r", 1)]
    jregs, regs = [], []
    for _ in range(30):
        pairs = []
        for _ in range(rng.randint(0, K + 1)):
            dots = {int(x): int(rng.randint(1, 9)) for x in rng.randint(0, A, size=2)}
            pairs.append((dots, pool[rng.randint(len(pool))]))
        jregs.append(JaxMVReg([(JaxVClock(d), v) for d, v in pairs]))
        regs.append(MVReg([(VClock(d), v) for d, v in pairs]))
    cfg = dict(num_actors=A, mv_capacity=K, counter_bits=bits)
    juni, uni = JaxUniverse(JaxConfig(**cfg)), Universe(CrdtConfig(**cfg))
    got = MVRegBatch.from_scalar(regs, uni, device="cpu")
    _same(got, JaxMVRegBatch.from_scalar(jregs, juni))
    assert got.to_scalar(uni) == regs
    z = MVRegBatch.zeros(2, uni, device="cpu")
    _same(z, JaxMVRegBatch.zeros(2, juni))
    with pytest.raises(ValueError, match="mv_capacity"):
        MVRegBatch.from_scalar([MVReg([(VClock({0: i + 1}), i) for i in range(K + 1)])], uni,
                               device="cpu")


def test_overflowing_fleet_regrows_through_the_executor_as_jax():
    """Five replicas each write one concurrent value: the fold outgrows
    K=2, regrows to 4 and then 8, and ends as the JAX executor's."""
    n, reps = 8, 5
    clocks = np.zeros((reps, n, 2, A), np.uint64)
    vals = np.zeros((reps, n, 2), np.uint64)
    for r in range(reps):
        clocks[r, :, 0, r] = 1 + np.arange(n) % 3
        vals[r, :, 0] = 10 + r
    jax_fleet = [_jax(clocks[r], vals[r]) for r in range(reps)]
    port_fleet = [_port(clocks[r], vals[r]) for r in range(reps)]
    jstats, pstats = JaxJoinStats(), JoinStats()
    want = JaxJoinExecutor(retry_backoff_s=0).join_all(jax_fleet, stats=jstats)
    got = JoinExecutor(retry_backoff_s=0).join_all(port_fleet, stats=pstats)
    _same(got, want)
    assert (pstats.overflow_regrows, pstats.final_member_capacity, pstats.joins) == (
        jstats.overflow_regrows, jstats.final_member_capacity, jstats.joins)
    assert pstats.final_member_capacity == 8
