"""The port's ``PipelinedWireLoop`` on the CPU (the merge kernel's plain
version), held byte for byte against the JAX package's scalar engine:
for every object, the loop's output blob equals ``to_binary`` of the
left fold of ``from_binary`` over the replicas followed by the
defer-plunger self-merge — overlapped and serial, across rounds that
reuse the staging buffers, for u32 and u64 counters and for universes
that are not identity-interned; an overflow raises
``CapacityOverflowError``."""

import numpy as np
import pytest
import torch

from crdt_tpu.scalar.orswot import Orswot as JaxOrswot
from crdt_tpu.scalar.vclock import VClock as JaxVClock
from crdt_tpu.utils.serde import from_binary as jax_from_binary, to_binary as jax_to_binary
from crdt_tpu_torch import (
    CapacityOverflowError, CrdtConfig, PipelinedWireLoop, Universe, WireFormatError,
)
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets

torch.set_num_threads(1)
engine.set_threads(1)

A, M, D = 16, 8, 2


def _uni(bits=32, identity=True, **caps):
    cfg = CrdtConfig(**{"num_actors": A, "member_capacity": M, "deferred_capacity": D,
                        "counter_bits": bits, **caps})
    return Universe.identity(cfg) if identity else Universe(cfg)


def _jax_blob(clock, ids, dots, d_ids, d_clocks, i):
    """``to_binary`` of object ``i`` of unsigned planes, as a JAX scalar
    Orswot built directly from them."""
    s = JaxOrswot()
    for a in np.nonzero(clock[i])[0].tolist():
        s.clock.dots[a] = int(clock[i, a])
    for j in np.nonzero(ids[i] != -1)[0].tolist():
        s.entries[int(ids[i, j])] = JaxVClock(
            {a: int(dots[i, j, a]) for a in np.nonzero(dots[i, j])[0].tolist()})
    for r in np.nonzero(d_ids[i] != -1)[0].tolist():
        vc = JaxVClock({a: int(d_clocks[i, r, a]) for a in np.nonzero(d_clocks[i, r])[0].tolist()})
        s.deferred.setdefault(vc.key(), set()).add(int(d_ids[i, r]))
    return jax_to_binary(s)


def _fleet_blobs(seed, n, r, bits=32, **kw):
    shape = dict(base=4, novel=1, deferred_frac=0.25,
                 dtype=np.uint32 if bits == 32 else np.uint64)
    shape.update(kw)
    reps = anti_entropy_fleets(np.random.RandomState(seed), n, A, M, D, r, **shape)
    return [[_jax_blob(*rep, i) for i in range(n)] for rep in reps]


def _scalar_fold_blob(rep_blobs, i):
    acc = jax_from_binary(rep_blobs[0][i])
    for rr in range(1, len(rep_blobs)):
        acc.merge(jax_from_binary(rep_blobs[rr][i]))
    acc.merge(acc.clone())  # the defer plunger, as the loop
    return jax_to_binary(acc)


def _assert_folds(rep_blobs, out):
    assert len(out) == len(rep_blobs[0])
    for i in range(len(out)):
        assert out[i] == _scalar_fold_blob(rep_blobs, i), i


@pytest.mark.parametrize("overlap", [True, False])
def test_loop_matches_jax_scalar_fold(overlap):
    rep_blobs = _fleet_blobs(3, 64, 4)
    loop = PipelinedWireLoop(_uni(), device="cpu")
    res = loop.run([rep_blobs], overlap=overlap)
    assert res["pipeline"] == ("overlapped" if overlap else "serial")
    assert res["fold_path"] == "merge_reference" and res["device"] == "cpu"
    assert res["merges"] == 64 * 4 and res["objects"] == 64 and res["rounds"] == 1
    assert res["ingest_native_fraction"] == res["egress_native_fraction"] == 1.0
    assert res["wire_counters"]["from_wire"] == {"native": 4 * 64, "fallback": 0, "reasons": {}}
    assert set(res["stage_s"]) == {"parse", "h2d", "fold", "stall", "d2h", "encode", "egress"}
    assert len(res["out_blobs"]) == 1
    _assert_folds(rep_blobs, res["out_blobs"][0])


def test_staging_reuse_does_not_leak_between_rounds():
    """Rounds with different data through one loop instance, within one
    run and across runs, and a sparse round after dense ones: the reused
    staging sets must not carry rows from one round into the next."""
    loop = PipelinedWireLoop(_uni(), device="cpu", staging_sets=2)
    rounds = [_fleet_blobs(seed, 48, 3) for seed in (7, 8)]
    res = loop.run(rounds)
    assert res["rounds"] == 2 and len(res["out_blobs"]) == 2
    for rep_blobs, out in zip(rounds, res["out_blobs"]):
        _assert_folds(rep_blobs, out)
    sparse = _fleet_blobs(9, 48, 3, base=1, deferred_frac=0.0)
    for overlap in (True, False):
        _assert_folds(sparse, loop.run([sparse], overlap=overlap)["out_blobs"][0])


def test_overlapped_equals_serial_and_one_fleet_rounds():
    rep_blobs = _fleet_blobs(5, 40, 3)
    loop = PipelinedWireLoop(_uni(), device="cpu")
    a = loop.run([rep_blobs] * 2, overlap=True)["out_blobs"]
    b = loop.run([rep_blobs] * 2, overlap=False)["out_blobs"]
    assert a == b and len(a) == 2
    one = loop.run([rep_blobs[:1]])  # a one-fleet round: the plunger alone
    _assert_folds(rep_blobs[:1], one["out_blobs"][0])


def test_u64_loop_folds_through_the_rank_merge():
    rep_blobs = _fleet_blobs(6, 40, 3, bits=64, max_counter=2**40)
    res = PipelinedWireLoop(_uni(64), device="cpu").run([rep_blobs])
    assert res["fold_path"] == "rank"
    _assert_folds(rep_blobs, res["out_blobs"][0])


def test_non_identity_universe_loop():
    rng = np.random.RandomState(12)
    rep_blobs = [[], []]
    for _ in range(24):
        for rep in rep_blobs:
            s = JaxOrswot()
            for _ in range(rng.randint(0, 4)):
                member = ["m", "n", 3, "o"][rng.randint(4)]
                actor = f"actor{rng.randint(3)}"
                s.apply(s.add(member, s.value().derive_add_ctx(actor)))
            rep.append(jax_to_binary(s))
    res = PipelinedWireLoop(_uni(identity=False), device="cpu").run([rep_blobs])
    assert res["ingest_native_fraction"] == res["egress_native_fraction"] == 0.0
    assert res["wire_counters"]["from_wire"]["reasons"] == {"non_identity": 48}
    _assert_folds(rep_blobs, res["out_blobs"][0])


@pytest.mark.parametrize("overlap", [True, False])
def test_overflow_raises_capacity_overflow(overlap):
    """Each replica holds M members of its own: their union outgrows the
    member capacity, and the round's overflow check raises."""
    rep_blobs = []
    for r in range(2):
        s = JaxOrswot()
        for k in range(M):
            s.apply(s.add(100 * r + k, s.value().derive_add_ctx(r)))
        rep_blobs.append([jax_to_binary(s)] * 4)
    loop = PipelinedWireLoop(_uni(), device="cpu")
    with pytest.raises(CapacityOverflowError, match="member_capacity"):
        loop.run([rep_blobs], overlap=overlap)
    # the loop is reusable after the failed round
    good = _fleet_blobs(13, 4, 2)
    _assert_folds(good, loop.run([good], overlap=overlap)["out_blobs"][0])


def test_bad_blob_raises_from_the_parse_thread():
    rep_blobs = _fleet_blobs(14, 8, 2)
    rep_blobs[1][3] = rep_blobs[1][3][:-1]
    loop = PipelinedWireLoop(_uni(), device="cpu")
    with pytest.raises(WireFormatError, match="blob 3: truncated"):
        loop.run([rep_blobs], overlap=True)


def test_arguments_are_checked():
    with pytest.raises(ValueError, match="staging sets"):
        PipelinedWireLoop(_uni(), device="cpu", staging_sets=1)
    loop = PipelinedWireLoop(_uni(), device="cpu")
    with pytest.raises(ValueError, match="at least one fleet"):
        loop.run([[]])
    with pytest.raises(ValueError, match="same object count"):
        loop.run([[[b""] * 3, [b""] * 2]])
    empty = loop.run([])
    assert empty["out_blobs"] == [] and empty["merges"] == 0
