"""Parity of the port's Map codec legs (``MapBatch.from_wire``/``to_wire``
through ``native/wire_ingest.cpp``) with the JAX package's pure-Python
codec, for ``Map<K, MVReg>``, ``Map<K, Orswot>`` and ``Map<K, Map<K2,
MVReg>>``: ``from_wire`` of JAX-serialized blobs gives the planes of the
JAX ``from_scalar([from_binary(b) ...])`` and ``to_wire`` gives the bytes
of the JAX ``to_binary``; blobs outside the codec's grammar (counters at
or above 2^63) splice in through the scalar codec (status 1), each hard
status raises ``WireFormatError`` naming the blob, u64 counters past the
zigzag range take the Python encoder, and compositions without a leg or
a universe that is not identity-interned take the scalar codec, each with
its wire counts.  The oracle never reaches ``crdt_tpu.native``."""

import jax
import numpy as np
import pytest
import torch

from crdt_tpu.batch.map_batch import MapBatch as JaxMapBatch
from crdt_tpu.batch.val_kernels import (
    MapKernel as JaxMapKernel, MVRegKernel as JaxMVRegKernel, OrswotKernel as JaxOrswotKernel,
)
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import from_binary as jax_from_binary, to_binary as jax_to_binary
from crdt_tpu_torch import (
    CrdtConfig, MapBatch, MapKernel, MVRegKernel, OrswotKernel, Universe, WireFormatError,
)
from crdt_tpu_torch.batch import wirebulk
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.scalar import Add, Map, MapRm, MapUp, MVReg, Orswot, Put
from crdt_tpu_torch.scalar.vclock import Dot
from crdt_tpu_torch.utils.serde import MapOf, to_binary
from crdt_tpu_torch.utils.testdata import random_map

torch.set_num_threads(1)
engine.set_threads(1)

N, A, KEYS = 36, 6, 5
KINDS = ("mvreg", "orswot", "map")
# every random map fits these; _bad's small universe does not
ROOMY = dict(member_capacity=16, deferred_capacity=24, mv_capacity=16, key_capacity=KEYS)
SMALL = dict(member_capacity=2, deferred_capacity=2, mv_capacity=2, key_capacity=2)


def _setup(kind, bits, identity=True, caps=ROOMY):
    kw = dict(num_actors=A, counter_bits=bits, **caps)
    make = (JaxUniverse.identity, Universe.identity) if identity else (JaxUniverse, Universe)
    juni, uni = make[0](JaxConfig(**kw)), make[1](CrdtConfig(**kw))
    jc, pc = juni.config, uni.config
    return juni, uni, *{
        "mvreg": lambda: (JaxMVRegKernel.from_config(jc), MVRegKernel.from_config(pc)),
        "orswot": lambda: (JaxOrswotKernel.from_config(jc), OrswotKernel.from_config(pc)),
        "map": lambda: (JaxMapKernel.from_config(jc, JaxMVRegKernel.from_config(jc)),
                        MapKernel.from_config(pc, MVRegKernel.from_config(pc))),
        "map_orswot": lambda: (JaxMapKernel.from_config(jc, JaxOrswotKernel.from_config(jc)),
                               MapKernel.from_config(pc, OrswotKernel.from_config(pc))),
    }[kind]()


def _blobs(kind, bits, seed, big=False):
    """JAX ``to_binary`` blobs of random maps (the port's scalar engine
    builds them; the bytes are the same)."""
    top = 1 << (bits - 1)
    counters = (1, 2, 3, 4, 5) + ((top, top + 1, (1 << bits) - 1) if big else ())
    rng = np.random.RandomState(seed)
    states = [random_map(rng, kind, n_keys=KEYS, n_actors=A, counters=counters)
              for _ in range(N)]
    return [jax_to_binary(jax_from_binary(to_binary(m))) for m in states]


def _assert_planes(batch, blobs, juni, jvk):
    want = jax.tree_util.tree_leaves(
        JaxMapBatch.from_scalar([jax_from_binary(b) for b in blobs], juni, jvk).state)
    got = [x for x in jax.tree_util.tree_leaves(batch.to_numpy())]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _counts(native, fallback=0, reasons=None):
    return {"native": native, "fallback": fallback, "reasons": reasons or {}}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [32, 64])
def test_map_legs_match_jax_both_ways(kind, bits):
    juni, uni, jvk, vk = _setup(kind, bits)
    blobs = _blobs(kind, bits, 1 + bits, big=bits == 32)
    before = wirebulk.wire_counts("map")
    batch = MapBatch.from_wire(blobs, uni, vk, device="cpu")
    _assert_planes(batch, blobs, juni, jvk)
    assert batch.to_wire(uni) == blobs
    assert MapBatch.from_numpy(*batch.to_numpy(), batch.kernel, device="cpu").to_wire(uni) == blobs
    assert wirebulk.counts_since(before, "map") == {"from_wire": _counts(N),
                                                    "to_wire": _counts(2 * N)}
    assert MapBatch.from_wire([], uni, vk, device="cpu").to_wire(uni) == []


@pytest.mark.parametrize("kind", KINDS)
def test_blobs_past_2_63_splice_in_and_take_the_python_encoder(kind):
    juni, uni, jvk, vk = _setup(kind, 64)
    blobs = _blobs(kind, 64, 7, big=True)
    big = sum(any(b in blob for b in (b"\x80\x80\x80\x80\x80\x80\x80\x80\x80\x02",
                                      b"\xfe\xff\xff\xff\xff\xff\xff\xff\xff\x03"))
              for blob in blobs)
    before = wirebulk.wire_counts("map")
    batch = MapBatch.from_wire(blobs, uni, vk, device="cpu")
    _assert_planes(batch, blobs, juni, jvk)
    assert batch.to_wire(uni) == blobs
    grew = wirebulk.counts_since(before, "map")
    n_fb = grew["from_wire"]["fallback"]
    assert n_fb >= big > 0
    assert grew == {"from_wire": _counts(N - n_fb, n_fb, {"grammar": n_fb}),
                    "to_wire": _counts(0, N, {"overflow_zigzag": N})}


def _nested(kind, dot, k):
    clock = dot.to_vclock()
    if kind == "mvreg":
        return Put(clock=clock, val=k)
    if kind == "orswot":
        return Add(dot=dot, member=k)
    return MapUp(dot=dot, key=k, op=Put(clock=clock, val=k))


def _bad(kind, status):
    """A map that breaks ``SMALL``'s capacities (2 keys, 2 deferred rows, 2
    values per slot) or the actor range, by ``status``."""
    m = Map({"mvreg": MVReg, "orswot": Orswot, "map": MapOf(MVReg)}[kind])
    if status == 2:
        for k in range(3):
            m.apply(MapUp(dot=Dot(0, k + 1), key=k, op=_nested(kind, Dot(0, k + 1), k)))
    elif status == 3:
        for k in range(3):
            m.apply(MapRm(clock=Dot(1, 5).to_vclock(), key=k))
    elif status == 4:
        m.apply(MapUp(dot=Dot(A + 2, 1), key=0, op=_nested(kind, Dot(A + 2, 1), 0)))
    else:
        for a in range(3):
            m.apply(MapUp(dot=Dot(a, 1), key=0, op=_nested(kind, Dot(a, 1), a)))
    return jax_to_binary(jax_from_binary(to_binary(m)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("status,match", [
    (2, "map 1 has more keys than key_capacity 2"),
    (3, "map 1 has more deferred rows than deferred_capacity 2"),
    (4, r"map 1: actor outside the identity registry range \[0, 6\)"),
    (5, "map 1 has (a value antichain wider than mv_capacity 2|a value set exceeding "
        "member_capacity 2 / deferred_capacity 2|an inner map exceeding key_capacity 2 / "
        "deferred_capacity 2 / mv_capacity 2)")])
def test_hard_statuses_raise_with_the_blob_index(kind, status, match):
    _, uni, _, vk = _setup(kind, 32, caps=SMALL)
    empty = to_binary(Map({"mvreg": MVReg, "orswot": Orswot, "map": MapOf(MVReg)}[kind]))
    with pytest.raises(WireFormatError, match=match):
        MapBatch.from_wire([empty, _bad(kind, status), empty], uni, vk, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_undecodable_or_foreign_blobs_raise(kind):
    _, uni, _, vk = _setup(kind, 32)
    blobs = _blobs(kind, 32, 3)
    with pytest.raises(WireFormatError, match="blob 2"):
        MapBatch.from_wire(blobs[:2] + [blobs[2][:-1]], uni, vk, device="cpu")
    with pytest.raises(WireFormatError, match="blob 1: a Orswot, not a Map"):
        MapBatch.from_wire([blobs[0], to_binary(Orswot())], uni, vk, device="cpu")


def test_non_identity_universes_and_other_compositions_take_the_scalar_codec():
    juni, uni, jvk, vk = _setup("mvreg", 64, identity=False)
    blobs = _blobs("mvreg", 64, 5)
    before = wirebulk.wire_counts("map")
    batch = MapBatch.from_wire(blobs, uni, vk, device="cpu")
    _assert_planes(batch, blobs, juni, jvk)
    assert batch.to_wire(uni) == blobs
    assert wirebulk.counts_since(before, "map") == {
        "from_wire": _counts(0, N, {"non_identity": N}),
        "to_wire": _counts(0, N, {"non_identity": N})}
    # Map<K, Map<K2, Orswot>>: no codec leg
    juni, uni, jvk, vk = _setup("map_orswot", 64)
    states = []
    for i in range(6):
        m = Map(MapOf(Orswot))
        for j in range(i % 3 + 1):
            dot = Dot(j, i + 1)
            m.apply(MapUp(dot=dot, key=j, op=MapUp(dot=dot, key=i, op=Add(dot=dot, member=j))))
        states.append(m)
    blobs = [jax_to_binary(jax_from_binary(to_binary(m))) for m in states]
    before = wirebulk.wire_counts("map")
    batch = MapBatch.from_wire(blobs, uni, vk, device="cpu")
    _assert_planes(batch, blobs, juni, jvk)
    assert batch.to_wire(uni) == blobs
    assert wirebulk.counts_since(before, "map") == {
        "from_wire": _counts(0, 6, {"no_native_leg": 6}),
        "to_wire": _counts(0, 6, {"no_native_leg": 6})}


def test_codec_checks_plane_shapes_before_any_pointer_crosses():
    _, uni, _, vk = _setup("mvreg", 32)
    planes = jax.tree_util.tree_leaves(
        MapBatch.from_wire(_blobs("mvreg", 32, 9), uni, vk, device="cpu").to_numpy())
    with pytest.raises(ValueError, match="plane 3"):
        engine.map_mvreg_encode_wire(*planes[:3], planes[3][:, :, :1], *planes[4:])
    with pytest.raises(ValueError, match="plane 1"):
        engine.map_mvreg_encode_wire(planes[0], planes[1].astype(np.uint32), *planes[2:])
