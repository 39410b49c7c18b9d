"""Parity of the port's capacity tracker (``crdt_tpu_torch.obs.capacity``)
with the JAX package's, on the CPU, exact: sequences of samples (growth,
a flat plane, a regrow and a shrink re-seeding the rate, several planes)
under injected clocks give the same ``watermark()`` and ``planes()``;
``sample`` on the same planes, ``sample_oplog`` and
``sample_gap_buffer`` agree; ``GcEngine.due`` driven by the port's
tracker rules as the JAX engine driven by the JAX tracker."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.gc import GcEngine as JaxGcEngine, GcPolicy as JaxGcPolicy
from crdt_tpu.obs import capacity as jax_capacity
from crdt_tpu.obs.metrics import MetricsRegistry
from crdt_tpu.oplog import OpApplier as JaxOpApplier, OpBatch as JaxOpBatch, OpLog as JaxOpLog
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CapacityTracker, CrdtConfig, DeviceUnavailableError, GcEngine, GcPolicy, OrswotBatch,
    PNCounterBatch, Universe,
)
from crdt_tpu_torch.obs import capacity
from crdt_tpu_torch.oplog import OpApplier, OpBatch, OpLog

torch.set_num_threads(1)

A, D = 4, 2


def _orswot(live, m):
    """One object per entry of ``live`` holding that many members, in
    both packages."""
    n = len(live)
    ids = np.full((n, m), -1, np.int32)
    dots = np.zeros((n, m, A), np.uint32)
    for i, k in enumerate(live):
        ids[i, :k] = np.arange(k)
        dots[i, np.arange(k), np.arange(k) % A] = 1
    planes = (dots.max(axis=1), ids, dots, np.full((n, D), -1, np.int32),
              np.zeros((n, D, A), np.uint32))
    return JaxOrswotBatch(*(jnp.asarray(x) for x in planes)), OrswotBatch.from_numpy(*planes,
                                                                                    device="cpu")


def _pn(n):
    c = np.zeros((n, 2, A), np.uint32)
    c[0, 0, :3] = 5
    return JaxPNCounterBatch(planes=jnp.asarray(c)), PNCounterBatch.from_numpy(c, device="cpu")


def _trackers(**kw):
    t = [0.0]
    jt = jax_capacity.CapacityTracker(MetricsRegistry(), clock=lambda: t[0], **kw)
    pt = CapacityTracker(clock=lambda: t[0], **kw)
    return jt, pt, t


def _same(pt, jt):
    assert pt.watermark() == jt.watermark()
    got, want = pt.planes(), jt.planes()
    assert sorted(got) == sorted(want)
    for label, w in want.items():
        g = got[label]
        assert dataclasses.asdict(g.occupancy) == dataclasses.asdict(w.occupancy), label
        for f in ("ceiling", "rate", "eta_s", "state", "sampled_at"):
            assert getattr(g, f) == getattr(w, f), (label, f)


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_sample_sequences_match_jax(alpha):
    jt, pt, t = _trackers(max_capacity=32, alpha=alpha)
    for step, (live, m, label) in enumerate([
            ([4], 32, None), ([8, 1], 32, None), ([12], 32, None), ([16, 3], 32, None),
            ([24], 32, None), ([30], 32, None), ([30], 32, None),  # warn, critical, flat
            ([30], 64, None),                                       # regrown: rate re-seeds
            ([31], 64, "shadow"), ([20], 64, None), ([2], 8, None)]):  # shrink re-seeds too
        t[0] += 10.0 if step != 3 else 0.0  # one sample at an unchanged time
        jb, pb = _orswot(live, m)
        want = jt.sample(jb, label=label)
        got = pt.sample(pb, label=label)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        _same(pt, jt)
    jb, pb = _pn(3)
    jt.sample(jb)
    pt.sample(pb)
    jt.sample(jb, ceiling=4)
    pt.sample(pb, ceiling=4)
    _same(pt, jt)
    for bad in ("a.b", "", "x/y"):
        with pytest.raises(ValueError, match="single metric segment"):
            pt.sample(pb, label=bad)
    with pytest.raises(TypeError):
        pt.sample(object())
    pt.reset()
    jt.reset()
    _same(pt, jt)


def test_op_buffers_match_jax():
    kw = dict(num_actors=A, member_capacity=8, deferred_capacity=D)
    juni, uni = JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))
    jt, pt, t = _trackers()
    jlog, plog = JaxOpLog(juni, capacity=100), OpLog(uni, capacity=100)
    rng = np.random.RandomState(3)
    for _ in range(3):
        cols = dict(kind=np.zeros(20, np.uint8), obj=rng.randint(0, 9, 20),
                    actor=rng.randint(0, A, 20), counter=rng.randint(1, 9, 20),
                    member=rng.randint(0, 50, 20))
        jlog.append(JaxOpBatch(**cols))
        plog.append(OpBatch(**cols))
        t[0] += 1.0
        jt.sample_oplog(jlog)
        pt.sample_oplog(plog)
        _same(pt, jt)
    jt.sample_gap_buffer(JaxOpApplier(juni))
    pt.sample_gap_buffer(OpApplier(uni))
    _same(pt, jt)


@pytest.mark.parametrize("trigger", ["warn", "critical", None])
def test_gc_engine_due_driven_by_the_tracker(trigger):
    """The utilization trigger fires off-cadence once the port's tracker
    reaches it, round by round as the JAX engine with the JAX tracker."""
    jt, pt, t = _trackers(max_capacity=10)
    jeng = JaxGcEngine(JaxGcPolicy(interval_rounds=4, utilization_trigger=trigger),
                       capacity_tracker=jt, registry=MetricsRegistry())
    peng = GcEngine(GcPolicy(interval_rounds=4, utilization_trigger=trigger), capacity_tracker=pt)
    rounds = []
    for live in (1, 5, 7, 8, 9, 10, 3):
        t[0] += 1.0
        jb, pb = _orswot([live], 16)
        jt.sample(jb)
        pt.sample(pb)
        for r in range(1, 6):
            assert peng.due(r) == jeng.due(r), (live, r)
            rounds.append(peng.due(r))
    assert any(rounds) and not all(rounds)


def test_device_memory_sample():
    _, pb = _orswot([3], 8)
    trk = CapacityTracker(device="cpu")
    trk.sample(pb)
    assert trk.sample_device_memory() is None  # no allocator statistics on the CPU
    assert capacity.capacity_tracker() is capacity.capacity_tracker()


def test_device_memory_default_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        CapacityTracker().sample_device_memory()
