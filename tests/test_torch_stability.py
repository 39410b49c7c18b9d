"""Parity of the port's stability observatory (``crdt_tpu_torch.obs.
stability``) with the JAX package's, on the CPU, exact: ``subtree_layout``
for every n to 5,000 and a few large n, ``subtree_version_vectors`` for
Orswot, PNCounter, GCounter and VClock fleets (counters at and above 2^31
and 2^63; LWW has none), the frontier and divergence aging under injected
clocks (unheard roster peers, stale and quarantined peers, ``restore``,
``forget``, a shorter peer table), and the auditor: no violation on a
healthy fleet, the same sampled rows as the JAX auditor for one seed, and
the same frontier violations when the published frontier is planted above
the local clocks or above a peer's advertised vector.  The JAX auditor's
own re-merge goes through its wire codec, which port tests never reach:
its ``gather_blobs`` is replaced by a recorder, and the port's re-merge
(wire codec, merge) runs in full."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.lwwreg_batch import LWWRegBatch as JaxLWWRegBatch
from crdt_tpu.batch.mvreg_batch import MVRegBatch as JaxMVRegBatch
from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.batch.vclock_batch import VClockBatch as JaxVClockBatch
from crdt_tpu.obs import convergence as jax_convergence, stability as jax_stability
from crdt_tpu.obs.metrics import MetricsRegistry
from crdt_tpu_torch import (
    CrdtConfig, GCounterBatch, LWWRegBatch, MVRegBatch, OrswotBatch, PNCounterBatch, Universe,
    VClockBatch,
)
from crdt_tpu_torch.obs import convergence, stability
from crdt_tpu_torch.scalar import Orswot

torch.set_num_threads(1)

A = 8


def test_subtree_layout_matches_jax():
    for n in list(range(0, 5001)) + [65_535, 65_536, 65_537, 1_048_576, 1_250_000, 10**8]:
        assert stability.subtree_layout(n) == jax_stability.subtree_layout(n), n


def _counters(rng, shape, bits):
    half, top = 1 << (bits - 1), (1 << bits) - 1
    pool = np.array([0, 1, 5, 99, half - 1, half, half + 3, top], dtype=np.uint64)
    x = pool[rng.randint(0, pool.size, size=shape)]
    x[rng.rand(*shape) < 0.6] = 0
    return x.astype(np.uint32 if bits == 32 else np.uint64)


def _pair(kind, n, bits, seed):
    rng = np.random.RandomState(seed)
    if kind == "orswot":
        ids = np.full((n, 2), -1, np.int32)
        dots = np.zeros((n, 2, A), np.uint32 if bits == 32 else np.uint64)
        planes = (_counters(rng, (n, A), bits), ids, dots, np.full((n, 1), -1, np.int32),
                  np.zeros((n, 1, A), dots.dtype))
        return (JaxOrswotBatch(*(jnp.asarray(x) for x in planes)),
                OrswotBatch.from_numpy(*planes, device="cpu"))
    if kind == "pncounter":
        c = _counters(rng, (n, 2, A), bits)
        return JaxPNCounterBatch(planes=jnp.asarray(c)), PNCounterBatch.from_numpy(c, device="cpu")
    if kind == "lww":
        v = _counters(rng, (n,), 64)
        return (JaxLWWRegBatch(vals=jnp.asarray(v), markers=jnp.asarray(v)),
                LWWRegBatch.from_numpy(v, v, device="cpu"))
    c = _counters(rng, (n, A), bits)
    jcls, pcls = {"gcounter": (JaxGCounterBatch, GCounterBatch),
                  "vclock": (JaxVClockBatch, VClockBatch)}[kind]
    return jcls(clocks=jnp.asarray(c)), pcls.from_numpy(c, device="cpu")


@pytest.mark.parametrize("kind", ["orswot", "pncounter", "gcounter", "vclock"])
@pytest.mark.parametrize("bits", [32, 64])
def test_subtree_version_vectors_match_jax(kind, bits):
    for n in (1, 17, 256, 300):
        jb, pb = _pair(kind, n, bits, n + bits)
        got, want = stability.subtree_version_vectors(pb), jax_stability.subtree_version_vectors(jb)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # an empty fleet: the JAX host reshape of a 0-row plane raises; the
    # port gives the empty table its own n == 0 branch means
    jb, pb = _pair(kind, 0, bits, bits)
    with pytest.raises(ValueError):
        jax_stability.subtree_version_vectors(jb)
    got = stability.subtree_version_vectors(pb)
    assert got.dtype == np.uint64 and got.shape == (0, 2 * A if kind == "pncounter" else A)


def test_clockless_and_unsupported_types():
    jb, pb = _pair("lww", 20, 64, 1)
    assert stability.subtree_version_vectors(pb) is None
    assert jax_stability.subtree_version_vectors(jb) is None
    c = np.zeros((4, 2, A), np.uint64)
    v = np.zeros((4, 2), np.uint64)
    with pytest.raises(TypeError):
        jax_stability.subtree_version_vectors(
            JaxMVRegBatch(clocks=jnp.asarray(c), vals=jnp.asarray(v)))
    with pytest.raises(TypeError):
        stability.subtree_version_vectors(MVRegBatch.from_numpy(c, v, device="cpu"))
    trk = stability.StabilityTracker(clock=lambda: 0.0)
    assert trk.frontier(pb) is None
    trk.observe_converged("p", pb)
    assert trk.snapshot()["frontier"]["subtrees"] == 0


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _trackers(**kw):
    jclock, pclock = _Clock(), _Clock()
    jt = jax_stability.StabilityTracker(
        registry=MetricsRegistry(),
        tracker=jax_convergence.ConvergenceTracker(registry=MetricsRegistry()),
        clock=jclock, **kw)
    pt = stability.StabilityTracker(tracker=convergence.ConvergenceTracker(), clock=pclock, **kw)
    return jt, pt, jclock, pclock


def _same_report(got, want):
    for f in ("subtrees", "peers", "stale", "unheard", "excluded", "age_s"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.frozen == want.frozen
    for f in ("clock", "subtree_clocks"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _snap_equal(got, want):
    want = dict(want)
    assert got["frontier"] == want["frontier"]
    assert got["aging"] == want["aging"]
    assert got["audit"]["checks"] == want["audit"]["checks"]
    assert got["audit"]["violations"] == want["audit"]["violations"]


@pytest.mark.parametrize("bits", [32, 64])
def test_frontier_and_aging_match_jax(bits):
    """One script on both trackers: aging births and resolutions, evidence
    from three fleets, a roster with an unheard peer, staleness,
    quarantine, a shorter peer table, ``restore`` and ``forget``."""
    jt, pt, jc, pc = _trackers(stale_after_s=10.0, quarantine_s=50.0)
    n = 300  # 19 subtrees of 16
    fleets = [_pair("gcounter", n, bits, s) for s in (1, 2, 3)]
    small = _pair("gcounter", 40, bits, 4)
    local_j, local_p = fleets[0]

    def both(fn):
        fn(jt, 0)
        fn(pt, 1)

    def step(dt):
        jc.t += dt
        pc.t = jc.t

    both(lambda t, i: t.observe_descent("a", [3, 17, 18, 250], n))
    step(2.0)
    both(lambda t, i: t.observe_descent("a", [17, 299], n))
    both(lambda t, i: t.observe_descent("b", np.array([5, 6]), n, at=jc.t - 1))
    step(1.0)
    assert pt.oldest_divergence_age_s() == jt.oldest_divergence_age_s()
    _snap_equal(pt.snapshot(), jt.snapshot())
    for peer, fleet in (("a", fleets[1]), ("b", fleets[2]), ("c", small)):
        both(lambda t, i, peer=peer, fleet=fleet: t.observe_converged(peer, fleet[i]))
        step(3.0)
    _same_report(pt.frontier(local_p), jt.frontier(local_j))
    _same_report(pt.frontier(local_p, peers=["a", "b", "c", "z"]),
                 jt.frontier(local_j, peers=["a", "b", "c", "z"]))
    step(12.0)  # past stale_after_s for every peer
    _same_report(pt.frontier(local_p, peers=["a", "b"]), jt.frontier(local_j, peers=["a", "b"]))
    both(lambda t, i: t.observe_converged("a", fleets[2][i]))  # evidence max-merges
    step(45.0)  # b and c past quarantine, a stale; z's first sighting quarantined
    _same_report(pt.frontier(local_p, peers=["a", "b", "z"]),
                 jt.frontier(local_j, peers=["a", "b", "z"]))
    floor = np.asarray(fleets[2][0].clocks).max(axis=0)
    both(lambda t, i: t.restore(np.stack([floor, floor // 2])))  # a table floors at its min
    both(lambda t, i: t.forget("c"))
    _same_report(pt.frontier(local_p), jt.frontier(local_j))
    np.testing.assert_array_equal(pt.frontier_clock(), jt.frontier_clock())
    np.testing.assert_array_equal(pt.subtree_frontier_clocks(), jt.subtree_frontier_clocks())
    both(lambda t, i: t.resolve_all("b"))
    step(1.0)
    _snap_equal(pt.snapshot(), jt.snapshot())
    pt.reset()
    jt.reset()
    _snap_equal(pt.snapshot(), jt.snapshot())
    assert pt.frontier_clock() is None and pt.subtree_frontier_clocks() is None


def _sets_fleet(n, seed):
    uni = Universe.identity(CrdtConfig(num_actors=A, member_capacity=8, deferred_capacity=2))
    rng = np.random.RandomState(seed)
    sets = []
    for _ in range(n):
        s = Orswot()
        for _ in range(rng.randint(1, 6)):
            s.apply(s.add(int(rng.randint(0, 20)), s.value().derive_add_ctx(int(rng.randint(0, A)))))
        if rng.rand() < 0.3 and s.value().val:
            s.apply(s.remove(sorted(s.value().val)[0], s.value().derive_rm_ctx()))
        sets.append(s)
    pb = OrswotBatch.from_scalar(sets, uni, device="cpu")
    return JaxOrswotBatch(*(jnp.asarray(x) for x in pb.to_numpy())), pb, uni


def _record_jax_sample(monkeypatch):
    """The JAX auditor's sampled rows; its wire re-merge is skipped."""
    from crdt_tpu.sync import delta as jax_delta

    seen = []

    def record(batch, ids, universe):
        seen.append(np.asarray(ids))
        raise TypeError("wire re-merge left to the port")

    monkeypatch.setattr(jax_delta, "gather_blobs", record)
    return seen


def test_audit_healthy_samples_the_jax_rows(monkeypatch):
    jb, pb, uni = _sets_fleet(120, 31)
    seen = _record_jax_sample(monkeypatch)
    jt, pt, jc, pc = _trackers(seed=7)
    for t, b in ((jt, jb), (pt, pb)):
        t.observe_converged("a", b)
        t.frontier(b, peers=["a"])
    want = jt.audit(jb, None, sample=24)
    got = pt.audit(pb, uni, sample=24)
    assert got.ok and want.ok
    assert got.sampled == 24 and got.checks == 24 + 1
    np.testing.assert_array_equal(got.sampled_ids, seen[0])
    np.testing.assert_array_equal(
        got.sampled_ids, sorted(random.Random(7).sample(range(120), 24)))
    assert pt._rng.getstate() == jt._rng.getstate()
    # the cadence hook: every second call audits
    pt.audit_every = jt.audit_every = 2
    assert pt.maybe_audit(pb, uni) is None and jt.maybe_audit(jb) is None
    assert pt.maybe_audit(pb, uni).sampled == 8
    jt.maybe_audit(jb)
    np.testing.assert_array_equal(pt._rng.getstate()[1], jt._rng.getstate()[1])
    pt.audit_every = 0
    assert pt.maybe_audit(pb, uni) is None
    assert pt.snapshot()["audit"]["violations"] == 0


def test_audit_finds_the_planted_frontier_violations(monkeypatch):
    jb, pb, uni = _sets_fleet(40, 32)
    _record_jax_sample(monkeypatch)
    jt, pt, jc, pc = _trackers()
    for t, b in ((jt, jb), (pt, pb)):
        t.restore(np.full(A, 999, np.uint64))  # above every local counter
        t.frontier(b, peers=[])
    want, got = jt.audit(jb, None, sample=4), pt.audit(pb, uni, sample=4)
    assert got.violations == want.violations
    assert [v["plane"] for v in got.violations] == ["frontier_local"]
    assert pt.snapshot()["audit"]["last_violation"] == want.violations[-1]
    # evidence from "a" above what "a" advertises
    jt, pt, jc, pc = _trackers()
    for t, b in ((jt, jb), (pt, pb)):
        t.observe_converged("a", b)
        t.frontier(b, peers=["a"])
        t._conv().observe_version_vector("a", [0] * A, at=jc.t)
        t._conv().observe_version_vector("x", [0] * A, at=jc.t)  # no evidence: not checked
    want, got = jt.audit(jb, None, sample=0), pt.audit(pb, uni, sample=0)
    assert got.violations == want.violations
    assert [v["plane"] for v in got.violations] == ["frontier_peer_vv"]
    assert got.checks == want.checks == 2


def test_audit_catches_a_merge_that_is_not_idempotent(monkeypatch):
    from crdt_tpu_torch.batch import orswot_batch

    _, pb, uni = _sets_fleet(40, 33)
    real = orswot_batch.OrswotBatch.merge

    def drift(self, other, *a, **kw):
        out = real(self, other, *a, **kw)
        out.clock[0, 0] += 1  # one biased counter up: a different digest
        return out

    monkeypatch.setattr(orswot_batch.OrswotBatch, "merge", drift)
    rep = stability.StabilityTracker(clock=lambda: 0.0).audit(pb, uni, sample=40)
    assert [v["plane"] for v in rep.violations] == ["merge_idempotence"]
    assert rep.violations[0]["count"] == 1 and rep.violations[0]["objects"] == "0"
