"""Parity of the port's VClock, GCounter and PNCounter batches (and
``ops/counter_ops.py``) with the JAX package on seeded unsigned planes,
bit for bit: counters at the edges of u32 and u64 (2^31, 2^63 and the
maxima), and the sums that wrap modulo 2^64."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.batch.vclock_batch import VClockBatch as JaxVClockBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.ops import counter_ops as jax_counter_ops
from crdt_tpu.scalar.gcounter import GCounter as JaxGCounter
from crdt_tpu.scalar.pncounter import PNCounter as JaxPNCounter
from crdt_tpu.scalar.vclock import VClock as JaxVClock
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CrdtConfig, DeviceUnavailableError, GCounterBatch, PNCounterBatch, Universe, VClockBatch,
)
from crdt_tpu_torch.dtypes import counters_to_numpy
from crdt_tpu_torch.ops import counter_ops
from crdt_tpu_torch.scalar import GCounter, PNCounter, VClock

torch.set_num_threads(1)

N, A = 96, 12


def _edges(bits):
    top = (1 << bits) - 1
    return np.array([0, 0, 1, 2, 7, (1 << (bits - 1)) - 1, 1 << (bits - 1),
                     (1 << (bits - 1)) + 3, top - 1, top], dtype=np.uint64)


def _planes(seed, bits, shape):
    """Unsigned planes mixing small counters and the width's edge values."""
    rng = np.random.RandomState(seed)
    dt = np.uint32 if bits == 32 else np.uint64
    small = rng.randint(0, 5, size=shape).astype(np.uint64)
    edge = _edges(bits)[rng.randint(0, 10, size=shape)]
    return np.where(rng.rand(*shape) < 0.3, edge, small).astype(dt)


def _cfg(bits):
    return dict(num_actors=A, counter_bits=bits)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("bits", [32, 64])
def test_vclock_ops_match_jax(bits):
    a, b = _planes(1, bits, (N, A)), _planes(2, bits, (N, A))
    b[:8] = a[:8]  # equal clocks
    b[8:16] = np.maximum(a[8:16], b[8:16])  # b dominates
    ja, jb = JaxVClockBatch(clocks=jnp.asarray(a)), JaxVClockBatch(clocks=jnp.asarray(b))
    pa, pb = VClockBatch.from_numpy(a, device="cpu"), VClockBatch.from_numpy(b, device="cpu")
    for name in ("merge", "subtract", "intersection", "truncate"):
        got = getattr(pa, name)(pb).to_numpy()
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, _np(getattr(ja, name)(jb).clocks), err_msg=name)
    for name in ("leq", "concurrent"):
        np.testing.assert_array_equal(getattr(pa, name)(pb).numpy(), _np(getattr(ja, name)(jb)))
    np.testing.assert_array_equal(pa.is_empty().numpy(), _np(ja.is_empty()))
    rng = np.random.RandomState(3)
    idx = rng.randint(0, A, size=N)
    ctr = _planes(4, bits, (N,))
    np.testing.assert_array_equal(
        pa.witness(idx, ctr).to_numpy(),
        _np(ja.witness(jnp.asarray(idx), jnp.asarray(ctr)).clocks))


@pytest.mark.parametrize("bits", [32, 64])
def test_gcounter_merge_inc_and_value_match_jax(bits):
    a, b = _planes(5, bits, (N, A)), _planes(6, bits, (N, A))
    ja, jb = JaxGCounterBatch(clocks=jnp.asarray(a)), JaxGCounterBatch(clocks=jnp.asarray(b))
    pa, pb = GCounterBatch.from_numpy(a, device="cpu"), GCounterBatch.from_numpy(b, device="cpu")
    np.testing.assert_array_equal(pa.merge(pb).to_numpy(), _np(ja.merge(jb).clocks))
    idx = np.random.RandomState(7).randint(0, A, size=N)
    np.testing.assert_array_equal(pa.inc(idx).to_numpy(), _np(ja.inc(jnp.asarray(idx)).clocks))
    # the sum's bits, modulo 2^64 (u64) or exact (u32 summed wide)
    want = _np(ja.merge(jb).value()).astype(np.uint64).view(np.int64)
    got = pa.merge(pb).value()
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [32, 64])
def test_pncounter_merge_inc_dec_and_value_match_jax(bits):
    a, b = _planes(8, bits, (N, 2, A)), _planes(9, bits, (N, 2, A))
    ja, jb = JaxPNCounterBatch(planes=jnp.asarray(a)), JaxPNCounterBatch(planes=jnp.asarray(b))
    pa = PNCounterBatch.from_numpy(a, device="cpu")
    pb = PNCounterBatch.from_numpy(b, device="cpu")
    np.testing.assert_array_equal(pa.merge(pb).to_numpy(), _np(ja.merge(jb).planes))
    idx = np.random.RandomState(10).randint(0, A, size=N)
    np.testing.assert_array_equal(pa.inc(idx).to_numpy(), _np(ja.inc(jnp.asarray(idx)).planes))
    np.testing.assert_array_equal(pa.dec(idx).to_numpy(), _np(ja.dec(jnp.asarray(idx)).planes))
    np.testing.assert_array_equal(pa.merge(pb).value().numpy(), _np(ja.merge(jb).value()))


@pytest.mark.parametrize("bits", [32, 64])
def test_pncounter_value_wraps_as_jax(bits):
    """Sums that cross 2^63 and 2^64 on either plane."""
    top = (1 << bits) - 1
    rows = [
        [[top, top, 1], [0, 0, 0]],
        [[1 << (bits - 1), 1 << (bits - 1), 5], [3, 0, 0]],
        [[0, 0, 0], [top, top, top]],
        [[(1 << 63) % (1 << bits), 0, 7], [top, 1, 0]],
    ]
    if bits == 64:
        rows.append([[1 << 63, 1 << 62, 1 << 62], [1, 0, 0]])
        rows.append([[top, 2, 0], [1 << 63, 1 << 63, 1]])
    planes = np.array(rows, dtype=np.uint32 if bits == 32 else np.uint64)
    want = _np(jax_counter_ops.pncounter_value(jnp.asarray(planes)))
    got = counter_ops.pncounter_value(PNCounterBatch.from_numpy(planes, device="cpu").planes)
    np.testing.assert_array_equal(got.numpy(), want)
    gwant = _np(jax_counter_ops.gcounter_value(jnp.asarray(planes[:, 0]))).astype(np.uint64)
    gotg = counter_ops.gcounter_value(GCounterBatch.from_numpy(planes[:, 0], device="cpu").clocks)
    np.testing.assert_array_equal(gotg.numpy(), gwant.view(np.int64))


@pytest.mark.parametrize("bits", [32, 64])
def test_scalar_round_trip_matches_jax(bits):
    rng = np.random.RandomState(11)
    states, pstates = [], []
    for _ in range(20):
        p = {int(x): int(rng.randint(1, 1 << 20)) for x in rng.randint(0, A, size=3)}
        q = {int(x): int(rng.randint(1, 1 << 20)) for x in rng.randint(0, A, size=2)}
        states.append(JaxPNCounter(JaxGCounter(JaxVClock(p)), JaxGCounter(JaxVClock(q))))
        pstates.append(PNCounter(GCounter(VClock(p)), GCounter(VClock(q))))
    juni, uni = JaxUniverse.identity(JaxConfig(**_cfg(bits))), Universe.identity(
        CrdtConfig(**_cfg(bits)))
    got = PNCounterBatch.from_scalar(pstates, uni, device="cpu")
    np.testing.assert_array_equal(got.to_numpy(), _np(JaxPNCounterBatch.from_scalar(states, juni).planes))
    assert got.to_scalar(uni) == pstates
    g = GCounterBatch.from_scalar([s.p for s in pstates], uni, device="cpu")
    np.testing.assert_array_equal(
        g.to_numpy(), _np(JaxGCounterBatch.from_scalar([s.p for s in states], juni).clocks))
    assert [x.inner for x in g.to_scalar(uni)] == [s.p.inner for s in pstates]
    v = VClockBatch.from_scalar([s.n.inner for s in pstates], uni, device="cpu")
    assert v.to_scalar(uni) == [s.n.inner for s in pstates]


def test_zeros_are_the_biased_zero_and_cuda_needs_a_card():
    uni = Universe.identity(CrdtConfig(**_cfg(64)))
    z = PNCounterBatch.zeros(3, uni, device="cpu")
    assert (z.to_numpy() == 0).all() and (z.value() == 0).all()
    assert (counters_to_numpy(GCounterBatch.zeros(2, uni, device="cpu").clocks) == 0).all()
    assert bool(VClockBatch.zeros(2, uni, device="cpu").is_empty().all())
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            VClockBatch.zeros(2, uni)
        with pytest.raises(DeviceUnavailableError):
            PNCounterBatch.from_numpy(np.zeros((1, 2, A), np.uint64))
