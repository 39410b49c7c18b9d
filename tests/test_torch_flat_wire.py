"""Parity of the flat types' wire legs with the JAX package's pure-Python
codec: every leg's ``from_wire`` of JAX-serialized blobs gives the planes
of the JAX ``from_scalar([from_binary(b) ...])``, and its ``to_wire``
gives the bytes of the JAX ``to_binary`` of the same scalar states — by
the native route, the per-blob grammar splice (status 1), the hard
statuses, the non-identity route and the u64 zigzag guard, each with its
wire counts by leg.  The oracle never reaches ``crdt_tpu.native``."""

import numpy as np
import pytest
import torch

from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.gset_batch import GSetBatch as JaxGSetBatch
from crdt_tpu.batch.lwwreg_batch import LWWRegBatch as JaxLWWRegBatch
from crdt_tpu.batch.mvreg_batch import MVRegBatch as JaxMVRegBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.batch.vclock_batch import VClockBatch as JaxVClockBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.scalar.gcounter import GCounter as JaxGCounter
from crdt_tpu.scalar.gset import GSet as JaxGSet
from crdt_tpu.scalar.lwwreg import LWWReg as JaxLWWReg
from crdt_tpu.scalar.mvreg import MVReg as JaxMVReg
from crdt_tpu.scalar.orswot import Orswot as JaxOrswot
from crdt_tpu.scalar.pncounter import PNCounter as JaxPNCounter
from crdt_tpu.scalar.vclock import VClock as JaxVClock
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import from_binary as jax_from_binary, to_binary as jax_to_binary
from crdt_tpu_torch import (
    CrdtConfig, GCounterBatch, GSetBatch, LWWRegBatch, MVRegBatch, PNCounterBatch, Universe,
    VClockBatch, WireFormatError,
)
from crdt_tpu_torch.batch import wirebulk
from crdt_tpu_torch.native import engine

torch.set_num_threads(1)
engine.set_threads(1)

N, A, K, U = 40, 10, 3, 24


def _vc(row):
    return JaxVClock({int(a): int(row[a]) for a in np.nonzero(row)[0]})


def _counters(rng, bits, shape):
    dt = np.uint32 if bits == 32 else np.uint64
    top = (1 << bits) - 1
    x = rng.randint(0, 6, size=shape).astype(np.uint64) * (rng.rand(*shape) < 0.5)
    x[rng.rand(*shape) < 0.05] = top if bits == 32 else (1 << 62) + 1
    return x.astype(dt)


# leg -> (port batch, JAX batch, planes(rng, bits), JAX states of planes, extra args)
LEGS = {
    "vclock": (VClockBatch, JaxVClockBatch, lambda rng, bits: (_counters(rng, bits, (N, A)),),
               lambda c: [_vc(r) for r in c], ()),
    "gcounter": (GCounterBatch, JaxGCounterBatch,
                 lambda rng, bits: (_counters(rng, bits, (N, A)),),
                 lambda c: [JaxGCounter(_vc(r)) for r in c], ()),
    "pncounter": (PNCounterBatch, JaxPNCounterBatch,
                  lambda rng, bits: (_counters(rng, bits, (N, 2, A)),),
                  lambda p: [JaxPNCounter(JaxGCounter(_vc(r[0])), JaxGCounter(_vc(r[1])))
                             for r in p], ()),
    "gset": (GSetBatch, JaxGSetBatch, lambda rng, bits: (rng.rand(N, U) < 0.2,),
             lambda b: [JaxGSet({int(i) for i in np.nonzero(r)[0]}) for r in b], (U,)),
    "lww": (LWWRegBatch, JaxLWWRegBatch,
            lambda rng, bits: (rng.randint(0, 1 << 31, size=N).astype(np.uint64),
                               rng.randint(0, 1 << 62, size=N).astype(np.uint64)),
            lambda v, m: [JaxLWWReg(int(x), int(y)) for x, y in zip(v, m)], ()),
    "mvreg": (MVRegBatch, JaxMVRegBatch,
              lambda rng, bits: (_counters(rng, bits, (N, K, A)),
                                 rng.randint(0, 1 << 20, size=(N, K)).astype(
                                     np.uint32 if bits == 32 else np.uint64)),
              lambda c, v: [JaxMVReg([(_vc(c[i, j]), int(v[i, j])) for j in range(K)
                                      if c[i, j].any()]) for i in range(len(c))], ()),
}
CASES = [(leg, bits) for leg in LEGS for bits in ((64,) if leg in ("gset", "lww") else (32, 64))]


def _universes(bits, identity=True):
    kw = dict(num_actors=A, mv_capacity=K, counter_bits=bits)
    if identity:
        return JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))
    return JaxUniverse(JaxConfig(**kw)), Universe(CrdtConfig(**kw))


def _jax_planes(leg, blobs, juni):
    _, jcls, _, _, extra = LEGS[leg]
    b = jcls.from_scalar([jax_from_binary(x) for x in blobs], juni, *extra)
    return tuple(np.asarray(getattr(b, f.name)) for f in b.__dataclass_fields__.values())


def _port_planes(batch):
    got = batch.to_numpy()
    return got if isinstance(got, tuple) else (got,)


def _assert_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("leg,bits", CASES)
def test_wire_legs_match_jax_both_ways(leg, bits):
    cls, _, make, states_of, extra = LEGS[leg]
    juni, uni = _universes(bits)
    planes = make(np.random.RandomState(len(leg) + bits), bits)
    blobs = [jax_to_binary(s) for s in states_of(*planes)]
    before = wirebulk.wire_counts(leg)
    batch = cls.from_wire(blobs, uni, *extra, device="cpu")
    _assert_planes(_port_planes(batch), _jax_planes(leg, blobs, juni))
    assert cls.from_numpy(*planes, device="cpu").to_wire(uni) == blobs
    assert batch.to_wire(uni) == blobs
    n = len(blobs)
    assert wirebulk.counts_since(before, leg) == {
        "from_wire": {"native": n, "fallback": 0, "reasons": {}},
        "to_wire": {"native": 2 * n, "fallback": 0, "reasons": {}}}
    assert cls.from_wire([], uni, *extra, device="cpu").to_wire(uni) == []


def _big(leg):
    """A JAX state whose counter or marker is at or above 2^63: outside
    the codec's fast path both ways, valid for the Python codec."""
    big = JaxVClock({1: 1 << 63, 2: (1 << 64) - 1})
    return {"vclock": big, "gcounter": JaxGCounter(big),
            "pncounter": JaxPNCounter(JaxGCounter(big), JaxGCounter(JaxVClock({0: 2}))),
            "lww": JaxLWWReg(7, (1 << 64) - 1), "mvreg": JaxMVReg([(big, 5)])}[leg]


@pytest.mark.parametrize("leg", ["vclock", "gcounter", "pncounter", "lww", "mvreg"])
def test_blobs_past_2_63_splice_in_and_take_the_python_encoder(leg):
    cls, _, make, states_of, extra = LEGS[leg]
    juni, uni = _universes(64)
    states = states_of(*make(np.random.RandomState(3), 64))
    states.insert(5, _big(leg))
    blobs = [jax_to_binary(s) for s in states]
    before = wirebulk.wire_counts(leg)
    batch = cls.from_wire(blobs, uni, device="cpu")
    _assert_planes(_port_planes(batch), _jax_planes(leg, blobs, juni))
    assert batch.to_wire(uni) == blobs
    n = len(blobs)
    assert wirebulk.counts_since(before, leg) == {
        "from_wire": {"native": n - 1, "fallback": 1, "reasons": {"grammar": 1}},
        "to_wire": {"native": 0, "fallback": n, "reasons": {"overflow_zigzag": n}}}


def _bad(leg, case):
    if case == "truncated":
        _, _, make, states_of, _ = LEGS[leg]
        return jax_to_binary(states_of(*make(np.random.RandomState(9), 64))[1])[:-1]
    if case == "not_the_type":
        return jax_to_binary(JaxOrswot())
    actor = JaxVClock({A + 2: 1})
    return {("vclock", "hard"): jax_to_binary(actor),
            ("gcounter", "hard"): jax_to_binary(JaxGCounter(actor)),
            ("pncounter", "hard"): jax_to_binary(JaxPNCounter(JaxGCounter(), JaxGCounter(actor))),
            ("mvreg", "hard"): jax_to_binary(JaxMVReg([(JaxVClock({0: i + 1, 1: K - i}), i)
                                                       for i in range(K + 1)])),
            ("gset", "hard"): jax_to_binary(JaxGSet({U + 1})),
            ("gset", "id_space"): jax_to_binary(JaxGSet({1 << 40})),
            ("lww", "id_space"): jax_to_binary(JaxLWWReg(1 << 40, 3))}[leg, case]


BAD = [(leg, case, match) for leg in LEGS for case, match in (
    ("truncated", "truncated"), ("not_the_type", "not a")) + {
    "vclock": (("hard", "actor outside"),), "gcounter": (("hard", "actor outside"),),
    "pncounter": (("hard", "actor outside"),), "mvreg": (("hard", "more values than"),),
    "gset": (("hard", "member universe overflow"), ("id_space", "identity registry")),
    "lww": (("id_space", "identity registry"),)}[leg]]


@pytest.mark.parametrize("leg,case,match", BAD)
def test_bad_blobs_raise_wire_format_errors(leg, case, match):
    """A truncated blob, another type's blob, a hard status and a payload
    id past the int32 id space: ``WireFormatError`` (a ``ValueError``, as
    the JAX oracle raises)."""
    cls, _, make, states_of, extra = LEGS[leg]
    juni, uni = _universes(64)
    blobs = [jax_to_binary(s) for s in states_of(*make(np.random.RandomState(4), 64))[:6]]
    blobs.insert(4, _bad(leg, case))
    with pytest.raises((ValueError, TypeError, AttributeError)):
        _jax_planes(leg, blobs, juni)
    with pytest.raises(WireFormatError, match=match):
        cls.from_wire(blobs, uni, *extra, device="cpu")


@pytest.mark.parametrize("leg,bits", [(leg, 64) for leg in LEGS])
def test_non_identity_universes_take_the_python_codec(leg, bits):
    """String actors and payloads intern in the JAX package's order."""
    cls, _, _, _, extra = LEGS[leg]
    rng = np.random.RandomState(6)
    names = ["ann", "bob", "cy"]

    def vc():
        return JaxVClock({names[i]: int(rng.randint(1, 9)) for i in rng.randint(0, 3, size=2)})

    make = {"vclock": vc, "gcounter": lambda: JaxGCounter(vc()),
            "pncounter": lambda: JaxPNCounter(JaxGCounter(vc()), JaxGCounter(vc())),
            "gset": lambda: JaxGSet({names[i] for i in rng.randint(0, 3, size=2)}),
            "lww": lambda: JaxLWWReg(names[rng.randint(3)], int(rng.randint(0, 99))),
            "mvreg": lambda: JaxMVReg([(vc(), names[rng.randint(3)])])}[leg]
    blobs = [jax_to_binary(make()) for _ in range(12)]
    juni, uni = _universes(bits, identity=False)
    before = wirebulk.wire_counts(leg)
    batch = cls.from_wire(blobs, uni, *extra, device="cpu")
    _assert_planes(_port_planes(batch), _jax_planes(leg, blobs, juni))
    assert uni.members.values() == juni.members.values()
    assert uni.actors.values() == juni.actors.values()
    assert batch.to_wire(uni) == blobs
    assert wirebulk.counts_since(before, leg) == {
        "from_wire": {"native": 0, "fallback": 12, "reasons": {"non_identity": 12}},
        "to_wire": {"native": 0, "fallback": 12, "reasons": {"non_identity": 12}}}


def test_wire_counts_are_kept_per_leg():
    _, uni = _universes(64)
    snap = {leg: wirebulk.wire_counts(leg) for leg in wirebulk.LEGS}
    assert set(wirebulk.LEGS) == {"orswot", "map", *LEGS}
    GCounterBatch.zeros(3, uni, device="cpu").to_wire(uni)
    for leg in wirebulk.LEGS:
        grew = wirebulk.counts_since(snap[leg], leg)["to_wire"]["native"]
        assert grew == (3 if leg == "gcounter" else 0), leg
    assert wirebulk.counts_since(snap["orswot"]) == wirebulk.counts_since(snap["orswot"], "orswot")


def test_codec_bindings_check_their_planes():
    with pytest.raises(ValueError, match="2, A"):
        engine.pncounter_encode_wire(np.zeros((2, 3, 4), np.uint64))
    with pytest.raises(TypeError, match="uint64"):
        engine.lww_encode_wire(np.zeros(2, np.uint32), np.zeros(2, np.uint32))
    with pytest.raises(TypeError, match="mismatch"):
        engine.mvreg_encode_wire(np.zeros((1, 2, 3), np.uint64), np.zeros((1, 2), np.uint32))
    with pytest.raises(ValueError, match="expected shape"):
        engine.mvreg_encode_wire(np.zeros((1, 2, 3), np.uint64), np.zeros((1, 3), np.uint64))
    with pytest.raises(ValueError, match="one \\[n\\] shape"):
        engine.lww_encode_wire(np.zeros(3, np.uint64), np.zeros(2, np.uint64))
    with pytest.raises(ValueError, match="offsets"):
        engine.gset_ingest_wire(b"\x28\x00", np.array([0, 5]), 4)
