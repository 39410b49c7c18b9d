"""Parity of the port's wire leg (``OrswotBatch.from_wire``/``to_wire``
through its own host codec) with the JAX package's pure-Python codec:
the port's ``from_wire`` of JAX-serialized blobs gives the planes of the
JAX ``OrswotBatch.from_scalar([from_binary(b) ...], via_device=False)``,
and the port's ``to_wire`` gives the bytes of the JAX ``to_binary`` of
the same scalar states — by the native route, the per-blob grammar
splice, the non-identity route and the u64 zigzag route, each with its
wire counts."""

import numpy as np
import pytest
import torch

from crdt_tpu.batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.scalar.orswot import Orswot as JaxOrswot
from crdt_tpu.scalar.vclock import VClock as JaxVClock
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import from_binary as jax_from_binary, to_binary as jax_to_binary
from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe, WireFormatError
from crdt_tpu_torch.batch import wirebulk
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.utils.serde import to_binary as port_to_binary
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets, random_orswot_arrays

torch.set_num_threads(1)
engine.set_threads(1)

CAPS = dict(num_actors=16, member_capacity=8, deferred_capacity=2)


def _universes(bits, identity=True, **caps):
    kw = {**CAPS, **caps, "counter_bits": bits}
    if identity:
        return JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))
    return JaxUniverse(JaxConfig(**kw)), Universe(CrdtConfig(**kw))


def _planes(seed, bits, n=48):
    dt = np.uint32 if bits == 32 else np.uint64
    rng = np.random.RandomState(seed)
    fleets = anti_entropy_fleets(rng, n, CAPS["num_actors"], CAPS["member_capacity"],
                                 CAPS["deferred_capacity"], 2, base=4, novel=1,
                                 deferred_frac=0.4, dtype=dt)
    rand = random_orswot_arrays(rng, n, CAPS["num_actors"], CAPS["member_capacity"],
                                CAPS["deferred_capacity"], dtype=dt, max_counter=2**31,
                                deferred_frac=0.5)
    return tuple(np.concatenate([f[k] for f in fleets] + [rand[k]]) for k in range(5))


def _jax_states(planes):
    """JAX scalar Orswots holding the dense planes (unsigned counters,
    identity ids) — built directly, not through either package's batch."""
    clock, ids, dots, d_ids, d_clocks = planes
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


def _jax_want(blobs, juni):
    b = JaxOrswotBatch.from_scalar([jax_from_binary(x) for x in blobs], juni, via_device=False)
    return tuple(np.asarray(x) for x in (b.clock, b.ids, b.dots, b.d_ids, b.d_clocks))


def _assert_planes(got, want):
    for name, g, w in zip(("clock", "ids", "dots", "d_ids", "d_clocks"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _delta(before, direction):
    return wirebulk.counts_since(before)[direction]


@pytest.mark.parametrize("bits", [32, 64])
def test_from_wire_matches_jax_from_scalar(bits):
    juni, tuni = _universes(bits)
    blobs = [jax_to_binary(s) for s in _jax_states(_planes(1, bits))]
    before = wirebulk.wire_counts()
    got = OrswotBatch.from_wire(blobs, tuni, device="cpu").to_numpy()
    _assert_planes(got, _jax_want(blobs, juni))
    assert _delta(before, "from_wire") == {"native": len(blobs), "fallback": 0, "reasons": {}}


@pytest.mark.parametrize("bits", [32, 64])
def test_to_wire_matches_jax_to_binary(bits):
    _, tuni = _universes(bits)
    planes = _planes(2, bits)
    before = wirebulk.wire_counts()
    got = OrswotBatch.from_numpy(*planes, device="cpu").to_wire(tuni)
    assert got == [jax_to_binary(s) for s in _jax_states(planes)]
    assert _delta(before, "to_wire") == {"native": len(got), "fallback": 0, "reasons": {}}


@pytest.mark.parametrize("bits", [32, 64])
def test_to_scalar_matches_jax_states(bits):
    _, tuni = _universes(bits)
    planes = _planes(3, bits)
    got = OrswotBatch.from_numpy(*planes, device="cpu").to_scalar(tuni)
    assert [port_to_binary(s) for s in got] == [jax_to_binary(s) for s in _jax_states(planes)]
    assert all(type(s).__module__.startswith("crdt_tpu_torch.") for s in got)


def test_round_trip_is_plane_for_plane():
    _, tuni = _universes(32)
    blobs = [jax_to_binary(s) for s in _jax_states(_planes(4, 32))]
    x = OrswotBatch.from_wire(blobs, tuni, device="cpu")
    assert x.to_wire(tuni) == blobs
    y = OrswotBatch.from_wire(x.to_wire(tuni), tuni, device="cpu")
    for name in ("clock", "ids", "dots", "d_ids", "d_clocks"):
        assert torch.equal(getattr(x, name), getattr(y, name)), name


def _noncanonical_blob():
    """A valid ORSWOT blob whose entries are not in the codec's sorted
    order: outside the fast-path grammar, decoded by the scalar codec."""
    s = JaxOrswot()
    s.clock.dots[1] = 3
    s.entries[9] = JaxVClock({1: 2})
    s.entries[4] = JaxVClock({1: 3})
    canon = jax_to_binary(s)
    head = canon[:canon.index(b"\x03\x08")]  # through the entry count
    e9 = b"\x03\x12\x20\x01\x03\x02\x03\x04"
    e4 = b"\x03\x08\x20\x01\x03\x02\x03\x06"
    assert canon == head + e4 + e9 + b"\x00"
    return head + e9 + e4 + b"\x00"


def test_grammar_splice_of_non_canonical_blob():
    juni, tuni = _universes(32)
    blobs = [jax_to_binary(s) for s in _jax_states(_planes(5, 32, n=8))]
    blobs.insert(3, _noncanonical_blob())
    before = wirebulk.wire_counts()
    got = OrswotBatch.from_wire(blobs, tuni, device="cpu").to_numpy()
    _assert_planes(got, _jax_want(blobs, juni))
    assert _delta(before, "from_wire") == {"native": len(blobs) - 1, "fallback": 1,
                                           "reasons": {"grammar": 1}}


def test_u64_zigzag_routes():
    """A u64 counter at 2^63 zigzags past the native varint: its blob is
    spliced in through the scalar codec on the way in, and the batch takes
    the Python encoder on the way out."""
    juni, tuni = _universes(64)
    states = _jax_states(_planes(6, 64, n=6))
    big = JaxOrswot()
    big.clock.witness(1, 1 << 63)
    big.entries[5] = big.clock.clone()
    states.insert(2, big)
    blobs = [jax_to_binary(s) for s in states]
    before = wirebulk.wire_counts()
    batch = OrswotBatch.from_wire(blobs, tuni, device="cpu")
    _assert_planes(batch.to_numpy(), _jax_want(blobs, juni))
    assert batch.to_wire(tuni) == blobs
    assert wirebulk.counts_since(before) == {
        "from_wire": {"native": len(blobs) - 1, "fallback": 1, "reasons": {"grammar": 1}},
        "to_wire": {"native": 0, "fallback": len(blobs), "reasons": {"overflow_zigzag": len(blobs)}},
    }


def test_string_member_on_an_identity_universe_raises_like_the_scalar_path():
    juni, tuni = _universes(32)
    s = JaxOrswot()
    s.apply(s.add("a", s.value().derive_add_ctx(1)))
    blobs = [jax_to_binary(x) for x in _jax_states(_planes(7, 32, n=4))] + [jax_to_binary(s)]
    with pytest.raises(ValueError):
        _jax_want(blobs, juni)
    with pytest.raises(WireFormatError, match=f"blob indices are \\[{len(blobs) - 1}\\]"):
        OrswotBatch.from_wire(blobs, tuni, device="cpu")


@pytest.mark.parametrize("bits", [32, 64])
def test_non_identity_universe_takes_the_python_codec(bits):
    """String actors and members: the whole batch goes through the scalar
    codec both ways, interning in the JAX package's order."""
    juni, tuni = _universes(bits, identity=False)
    rng = np.random.RandomState(8)
    states = []
    for _ in range(12):
        s = JaxOrswot()
        for _ in range(rng.randint(0, 7)):
            member = ["m", "n", 3, "o", (1, 2)][rng.randint(5)]
            actor = f"actor{rng.randint(4)}"
            if rng.rand() < 0.7:
                s.apply(s.add(member, s.value().derive_add_ctx(actor)))
            else:
                s.apply(s.remove(member, s.contains(member).derive_rm_ctx()))
        states.append(s)
    blobs = [jax_to_binary(s) for s in states]
    before = wirebulk.wire_counts()
    batch = OrswotBatch.from_wire(blobs, tuni, device="cpu")
    _assert_planes(batch.to_numpy(), _jax_want(blobs, juni))
    assert tuni.members.values() == juni.members.values()
    assert tuni.actors.values() == juni.actors.values()
    assert batch.to_wire(tuni) == blobs
    n = len(blobs)
    assert wirebulk.counts_since(before) == {
        "from_wire": {"native": 0, "fallback": n, "reasons": {"non_identity": n}},
        "to_wire": {"native": 0, "fallback": n, "reasons": {"non_identity": n}},
    }


@pytest.mark.parametrize("case,match", [
    ("members", "member_capacity"), ("deferred", "deferred_capacity"), ("actor", "identity"),
    ("truncated", "truncated"), ("garbage", "unknown tag"), ("not_an_orswot", "malformed"),
])
def test_bad_blobs_raise_wire_format_error(case, match):
    _, tuni = _universes(32, member_capacity=2, deferred_capacity=1)
    s = JaxOrswot()
    if case == "members":
        for m in (1, 2, 3):
            s.apply(s.add(m, s.value().derive_add_ctx(0)))
    elif case == "deferred":
        s.clock.witness(0, 1)
        s.deferred[JaxVClock({0: 5}).key()] = {1, 2}
    elif case == "actor":
        s.apply(s.add(1, s.value().derive_add_ctx(99)))
    blob = jax_to_binary(s)
    blob = {"truncated": blob[:-1], "garbage": b"\x6a\x00",
            "not_an_orswot": jax_to_binary(JaxVClock({1: 2}))}.get(case, blob)
    good = jax_to_binary(JaxOrswot())
    with pytest.raises(WireFormatError, match=match) as info:
        OrswotBatch.from_wire([good, blob], tuni, device="cpu")
    assert "1" in str(info.value)  # the caller's blob index


def test_encode_rows_and_thread_counts_agree():
    """One thread and a team of three (3,300 objects: four blocks of the
    codec's 1,024) give the same bytes and planes, and the blobs of
    gathered rows are those rows' blobs."""
    planes = _planes(9, 32, n=1100)
    ref_buf, ref_off = engine.orswot_encode_wire(*planes)
    rows = np.array([5, 0, 3077, 5, 12], dtype=np.int64)
    engine.set_threads(3)
    try:
        buf, off = engine.orswot_encode_wire(*planes)
        got = wirebulk.slice_blobs(*engine.orswot_encode_wire(*(x[rows] for x in planes)))
        buf_b, off_b = wirebulk.concat_blobs(wirebulk.slice_blobs(ref_buf, ref_off))
        a3 = engine.orswot_ingest_wire(buf_b, off_b, 16, 8, 2, np.uint32)
    finally:
        engine.set_threads(1)
    assert bytes(buf) == bytes(ref_buf) and off.tolist() == ref_off.tolist()
    want = wirebulk.slice_blobs(ref_buf, ref_off)
    assert got == [want[r] for r in rows.tolist()]
    a1 = engine.orswot_ingest_wire(buf_b, off_b, 16, 8, 2, np.uint32)
    for x, y in zip(a1, a3):
        np.testing.assert_array_equal(x, y)


def test_bindings_check_what_they_hand_the_codec():
    planes = _planes(15, 32, n=4)
    with pytest.raises(ValueError, match="dots: expected shape"):
        engine.orswot_encode_wire(planes[0], planes[1], planes[2][:, :4], *planes[3:])
    with pytest.raises(TypeError, match="ids must be int32"):
        engine.orswot_encode_wire(planes[0], planes[1].astype(np.int64), *planes[2:])
    with pytest.raises(TypeError, match="counter dtype mismatch"):
        engine.orswot_encode_wire(*planes[:4], planes[4].astype(np.uint64))
    with pytest.raises(TypeError, match="uint32/uint64"):
        engine.orswot_encode_wire(*(p.astype(np.int32) for p in planes))
    buf, off = wirebulk.concat_blobs([jax_to_binary(JaxOrswot())] * 3)
    for bad in ([0, 4, 2, 12], [0, 4, 8, 13], [-1, 4, 8, 12]):
        with pytest.raises(ValueError, match="offsets"):
            engine.orswot_ingest_wire(buf, np.array(bad), 16, 8, 2, np.uint32)


def test_wire_counts_survive_concurrent_tallies():
    """The parse thread and the caller's thread both add to the wire
    counts: no update is lost under a short switch interval."""
    import sys
    import threading

    before = wirebulk.wire_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            wirebulk._tally("from_wire", native=1, fallback=1, reason="grammar")
            for _ in range(2000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _delta(before, "from_wire") == {"native": 16000, "fallback": 16000,
                                           "reasons": {"grammar": 16000}}


def test_reused_output_buffers_are_cleared():
    """``out=`` with ``clear=1``: a dense set parsed into a buffer holding
    an earlier, denser set equals a fresh parse."""
    dense = [jax_to_binary(s) for s in _jax_states(_planes(10, 32, n=20))]
    sparse = [jax_to_binary(JaxOrswot())] * 100
    n = len(sparse)
    out = tuple(np.full(shape, 7, dtype=dt) for shape, dt in (
        ((n, 16), np.uint32), ((n, 8), np.int32), ((n, 8, 16), np.uint32),
        ((n, 2), np.int32), ((n, 2, 16), np.uint32)))
    engine.orswot_ingest_wire(*wirebulk.concat_blobs((dense * 2)[:n]), 16, 8, 2, np.uint32, out=out)
    got = engine.orswot_ingest_wire(*wirebulk.concat_blobs(sparse), 16, 8, 2, np.uint32, out=out)
    fresh = engine.orswot_ingest_wire(*wirebulk.concat_blobs(sparse), 16, 8, 2, np.uint32)
    for x, y in zip(got, fresh):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="C-contiguous"):
        engine.orswot_ingest_wire(*wirebulk.concat_blobs(sparse), 16, 8, 2, np.uint32,
                                  out=(out[0][:, ::2],) + out[1:])


def test_empty_blob_list():
    _, tuni = _universes(32)
    batch = OrswotBatch.from_wire([], tuni, device="cpu")
    assert batch.clock.shape == (0, 16)
    assert batch.to_wire(tuni) == []


def test_codec_builds_under_build_and_failures_raise(monkeypatch, tmp_path):
    """The codec library goes to a hash-named file under
    ``build/crdt_tpu_torch/`` (never under the JAX package); a missing
    compiler or a failed compile raises ``KernelError``."""
    from crdt_tpu_torch import KernelError, _build

    path = _build._lib_path("wire_ingest")
    assert path.parent == _build.BUILD_DIR and path.parent.parts[-2:] == ("build", "crdt_tpu_torch")
    assert path.name.startswith("libwire_ingest-") and path.suffix == ".so"
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-include", "/nonexistent.h"))
    with pytest.raises(KernelError, match="wire_ingest"):
        _build.build_all(["wire_ingest"])
    monkeypatch.setattr(_build, "_gxx", lambda: "/nonexistent/g++")
    with pytest.raises(KernelError, match="could not start the compiler"):
        _build.build_all(["wire_ingest"])
    assert list(tmp_path.iterdir()) == []  # no temporary left behind
