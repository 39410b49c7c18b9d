"""Parity of the port's LWWRegBatch and ``ops/lww_ops.py`` with the JAX
package: merges with and without equal-marker conflicts, ``update``,
both ``check=`` paths (the error text included), markers at and above
2^63, and the scalar round trip with interned string values."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from crdt_tpu.batch.lwwreg_batch import LWWRegBatch as JaxLWWRegBatch
from crdt_tpu.error import ConflictingMarker as JaxConflictingMarker
from crdt_tpu.ops import lww_ops as jax_lww_ops
from crdt_tpu.scalar.lwwreg import LWWReg as JaxLWWReg
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import ConflictingMarker, LWWRegBatch, Universe
from crdt_tpu_torch.dtypes import counters_to_numpy, payload_to_numpy
from crdt_tpu_torch.ops import lww_ops
from crdt_tpu_torch.scalar import LWWReg

torch.set_num_threads(1)

N = 200
MARKERS = np.array([0, 1, 2, 3, (1 << 63) - 1, 1 << 63, (1 << 64) - 2, (1 << 64) - 1],
                   dtype=np.uint64)


def _regs(seed):
    rng = np.random.RandomState(seed)
    vals = rng.randint(0, 6, size=N).astype(np.uint64)
    vals[::17] = np.uint64((1 << 64) - 1) - rng.randint(0, 2, size=vals[::17].shape).astype(np.uint64)
    return vals, MARKERS[rng.randint(0, len(MARKERS), size=N)]


def _pair(conflicts: bool):
    va, ma = _regs(1)
    vb, mb = _regs(2)
    # equal markers: the same value except where a conflict is planted
    same = ma == mb
    vb[same] = va[same]
    if conflicts:
        vb[[5, 40, 41]] = va[[5, 40, 41]] + 1
        mb[[5, 40, 41]] = ma[[5, 40, 41]]
    return (va, ma), (vb, mb)


def _jax(v, m):
    return JaxLWWRegBatch(vals=jnp.asarray(v), markers=jnp.asarray(m))


def _port(v, m):
    return LWWRegBatch.from_numpy(v, m, device="cpu")


def _assert_same(port, jax_batch):
    v, m = port.to_numpy()
    np.testing.assert_array_equal(v, np.asarray(jax_batch.vals))
    np.testing.assert_array_equal(m, np.asarray(jax_batch.markers))


@pytest.mark.parametrize("conflicts", [False, True])
def test_merge_matches_jax(conflicts):
    a, b = _pair(conflicts)
    jm, jc = _jax(*a).merge_with_conflicts(_jax(*b))
    pm, pc = _port(*a).merge_with_conflicts(_port(*b))
    _assert_same(pm, jm)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert bool(pc.any()) == conflicts
    _assert_same(_port(*a).merge(_port(*b), check=False), _jax(*a).merge(_jax(*b), check=False))
    if conflicts:
        with pytest.raises(JaxConflictingMarker) as want:
            _jax(*a).merge(_jax(*b))
        with pytest.raises(ConflictingMarker) as got:
            _port(*a).merge(_port(*b))
        assert str(got.value) == str(want.value)
        assert "3 conflicting marker(s), first at 5" in str(got.value)
    else:
        _assert_same(_port(*a).merge(_port(*b)), _jax(*a).merge(_jax(*b)))


@pytest.mark.parametrize("conflicts", [False, True])
def test_update_matches_jax(conflicts):
    a, (vb, mb) = _pair(conflicts)
    if conflicts:
        with pytest.raises(JaxConflictingMarker):
            _jax(*a).update(vb, mb)
        with pytest.raises(ConflictingMarker):
            _port(*a).update(vb, mb)
    else:
        _assert_same(_port(*a).update(vb, mb), _jax(*a).update(vb, mb))
        pb = _port(vb, mb)  # tensors: raw ids and biased markers
        _assert_same(_port(*a).update(pb.vals, pb.markers), _jax(*a).update(vb, mb))


def test_lww_ops_merge_keeps_val_a_on_a_conflict():
    a, b = _pair(True)
    pa, pb = _port(*a), _port(*b)
    want = jax_lww_ops.merge(*(jnp.asarray(x) for x in (a[0], a[1], b[0], b[1])))
    got = lww_ops.merge(pa.vals, pa.markers, pb.vals, pb.markers)
    np.testing.assert_array_equal(payload_to_numpy(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(counters_to_numpy(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (payload_to_numpy(got[0])[[5, 40, 41]] == a[0][[5, 40, 41]]).all()


def test_scalar_round_trip_interns_as_jax():
    rng = np.random.RandomState(3)
    vals = ["x", "y", 3, ("t", 1), "x", None]
    regs = [(vals[rng.randint(len(vals))], int(MARKERS[rng.randint(len(MARKERS))]))
            for _ in range(30)]
    juni, uni = JaxUniverse(), Universe()
    want = JaxLWWRegBatch.from_scalar([JaxLWWReg(v, m) for v, m in regs], juni)
    got = LWWRegBatch.from_scalar([LWWReg(v, m) for v, m in regs], uni, device="cpu")
    _assert_same(got, want)
    assert uni.members.values() == juni.members.values()
    assert [(r.val, r.marker) for r in got.to_scalar(uni)] == regs
