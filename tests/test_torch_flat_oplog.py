"""Parity of the counter and LWW op folds (``apply_gcounter_ops``,
``apply_pncounter_ops``, ``apply_lww_ops``) with the JAX package on the
same op batches: the planes, re-delivery (nothing changes), delivery out
of order, the ``ValueError`` for other kinds, and for LWW the planted
equal-marker conflicts — ``ConflictingMarker`` with the JAX text under
``check=True``, the JAX bitmap under ``check=False``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.lwwreg_batch import LWWRegBatch as JaxLWWRegBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.error import ConflictingMarker as JaxConflictingMarker
from crdt_tpu.oplog import apply as jax_apply
from crdt_tpu.oplog.records import OpBatch as JaxOpBatch
from crdt_tpu_torch import ConflictingMarker, GCounterBatch, LWWRegBatch, PNCounterBatch
from crdt_tpu_torch.oplog import (
    OP_ADD, OP_DEC, OP_INC, OP_SET, OpBatch, apply_gcounter_ops, apply_lww_ops,
    apply_pncounter_ops, decode_ops_frame, encode_ops_frame,
)

torch.set_num_threads(1)

N, A, B = 64, 8, 600


def _ops(kind, obj, actor, counter, member):
    cols = (np.asarray(kind, np.uint8), np.asarray(obj, np.int64), np.asarray(actor, np.int32),
            np.asarray(counter, np.uint64), np.asarray(member, np.int32))
    return OpBatch(*cols), JaxOpBatch(*cols)


def _counter_ops(seed, kinds):
    """Cumulative per-(object, actor, plane) dots, shuffled, one frame's
    worth re-delivered."""
    rng = np.random.RandomState(seed)
    kind = np.asarray(kinds, np.uint8)[rng.randint(0, len(kinds), size=B)]
    obj, actor = rng.randint(0, N, size=B), rng.randint(0, A, size=B)
    key = (obj * A + actor) * 2 + (kind == OP_DEC)
    order = np.argsort(key, kind="stable")
    counter = np.empty(B, np.uint64)
    ranks = np.arange(B) - np.searchsorted(key[order], key[order])
    counter[order] = ranks + 1
    counter[::37] += np.uint64(1 << 63)  # counters past 2^63
    perm = rng.permutation(B)
    return _ops(kind[perm], obj[perm], actor[perm], counter[perm], np.full(B, -1))


def _np(x):
    return np.asarray(x)


def test_gcounter_ops_fold_as_jax_and_redelivery_changes_nothing():
    ops, jops = _counter_ops(1, [OP_INC])
    start = np.random.RandomState(2).randint(0, 3, size=(N, A)).astype(np.uint64)
    want = jax_apply.apply_gcounter_ops(JaxGCounterBatch(clocks=jnp.asarray(start)), jops)
    got = apply_gcounter_ops(GCounterBatch.from_numpy(start, device="cpu"), ops)
    np.testing.assert_array_equal(got.to_numpy(), _np(want.clocks))
    again = apply_gcounter_ops(got, decode_ops_frame(encode_ops_frame(ops)))
    assert torch.equal(again.clocks, got.clocks)
    half = OpBatch.concat([ops.select(np.arange(B) >= B // 2), ops.select(np.arange(B) < B // 2)])
    assert torch.equal(apply_gcounter_ops(GCounterBatch.from_numpy(start, device="cpu"),
                                          half).clocks, got.clocks)
    assert apply_gcounter_ops(got, OpBatch.empty()) is got


def test_pncounter_ops_fold_as_jax():
    ops, jops = _counter_ops(3, [OP_INC, OP_DEC])
    start = np.zeros((N, 2, A), np.uint32)
    want = jax_apply.apply_pncounter_ops(JaxPNCounterBatch(planes=jnp.asarray(start)), jops)
    got = apply_pncounter_ops(PNCounterBatch.from_numpy(start, device="cpu"), ops)
    np.testing.assert_array_equal(got.to_numpy(), _np(want.planes))
    np.testing.assert_array_equal(got.value().numpy(), _np(want.value()))
    assert torch.equal(apply_pncounter_ops(got, ops).planes, got.planes)


@pytest.mark.parametrize("fold,batch,kind", [
    ("apply_gcounter_ops", "g", OP_DEC), ("apply_pncounter_ops", "p", OP_ADD),
    ("apply_lww_ops", "l", OP_INC)])
def test_other_kinds_raise_value_error_as_jax(fold, batch, kind):
    ops, jops = _ops([kind, kind], [0, 1], [0, 0], [1, 1], [0, 0])
    port = {"g": GCounterBatch.from_numpy(np.zeros((2, A), np.uint64), device="cpu"),
            "p": PNCounterBatch.from_numpy(np.zeros((2, 2, A), np.uint64), device="cpu"),
            "l": LWWRegBatch.from_numpy(np.zeros(2, np.uint64), np.zeros(2, np.uint64),
                                        device="cpu")}[batch]
    with pytest.raises(ValueError) as want:
        getattr(jax_apply, fold)(None, jops)
    with pytest.raises(ValueError) as got:
        globals()[fold](port, ops)
    assert str(got.value) == str(want.value)


def _lww(seed, conflicts):
    rng = np.random.RandomState(seed)
    obj = rng.randint(0, N, size=B)
    marker = rng.randint(1, 40, size=B).astype(np.uint64)
    marker[::29] = np.uint64((1 << 64) - 5)
    member = (obj * 7 + marker.astype(np.int64) % 5).astype(np.int32)  # one value per marker
    if conflicts:  # equal markers, different values: in the batch and against the registers
        member[[3, 300]] += 1
    vals = np.arange(N, dtype=np.uint64) % 5
    markers = rng.randint(0, 30, size=N).astype(np.uint64)
    if conflicts:
        hit = obj[10]
        markers[hit], vals[hit] = marker[10], np.uint64(member[10] + 100)
    return _ops(np.full(B, OP_SET), obj, np.zeros(B), marker, member), (vals, markers)


@pytest.mark.parametrize("conflicts", [False, True])
def test_lww_ops_fold_as_jax(conflicts):
    (ops, jops), (vals, markers) = _lww(5, conflicts)
    jb = JaxLWWRegBatch(vals=jnp.asarray(vals), markers=jnp.asarray(markers))
    pb = LWWRegBatch.from_numpy(vals, markers, device="cpu")
    jout, jconf = jax_apply.apply_lww_ops(jb, jops, check=False)
    pout, pconf = apply_lww_ops(pb, ops, check=False)
    for g, w in zip(pout.to_numpy(), (jout.vals, jout.markers)):
        np.testing.assert_array_equal(g, _np(w))
    np.testing.assert_array_equal(pconf, jconf)
    assert bool(pconf.any()) == conflicts
    if conflicts:
        with pytest.raises(JaxConflictingMarker) as want:
            jax_apply.apply_lww_ops(jb, jops)
        with pytest.raises(ConflictingMarker) as got:
            apply_lww_ops(pb, ops)
        assert str(got.value) == str(want.value)
    else:
        again = apply_lww_ops(apply_lww_ops(pb, ops), decode_ops_frame(encode_ops_frame(ops)))
        assert torch.equal(again.vals, pout.vals) and torch.equal(again.markers, pout.markers)
        perm = np.random.RandomState(6).permutation(B)
        late = apply_lww_ops(pb, ops.select(perm))
        assert torch.equal(late.vals, pout.vals)
    assert apply_lww_ops(pb, OpBatch.empty(), check=False)[1].shape == (N,)


def test_ops_outside_the_planes_raise():
    ops, _ = _ops([OP_INC], [N], [0], [1], [-1])
    with pytest.raises(ValueError, match="outside the planes"):
        apply_gcounter_ops(GCounterBatch.from_numpy(np.zeros((N, A), np.uint64), device="cpu"), ops)
