"""Parity of the port's delta layer (``crdt_tpu_torch.sync.delta``) with
the JAX package, on the CPU, exact: every ported frame's bytes against
the JAX encoder (and each package decoding the other's frames), the
rejection of corrupted, truncated and malformed frames, ``gather_blobs``
against ``to_binary`` of the JAX scalar rows, ``OrswotDeltaApplier``
against the JAX batch merge of the gathered rows followed by
``.at[ids].set`` (the JAX package's jnp route) at the config widths and
at regrown widths, both ways between two replicas, with the overflow
raise, and ``apply_delta_rows`` for GCounter, PNCounter, LWWReg and
``Map<K, MVReg>``.  The JAX oracle never reaches its native library:
peer rows come from ``from_scalar`` of ``crdt_tpu.utils.serde``'s
``from_binary``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.lwwreg_batch import LWWRegBatch as JaxLWWRegBatch
from crdt_tpu.batch.map_batch import MapBatch as JaxMapBatch
from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.batch.val_kernels import MVRegKernel as JaxMVRegKernel
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import CapacityOverflowError as JaxCapacityOverflowError
from crdt_tpu.error import SyncProtocolError as JaxSyncProtocolError
from crdt_tpu.scalar.orswot import Orswot as JaxOrswot
from crdt_tpu.scalar.vclock import VClock as JaxVClock
from crdt_tpu.sync import delta as jdelta
from crdt_tpu.sync import tree as jtree
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import from_binary as jax_from_binary, to_binary as jax_to_binary
from crdt_tpu_torch import (
    CapacityOverflowError, CrdtConfig, GCounterBatch, LWWRegBatch, MapBatch, MapKernel,
    MVRegKernel, OrswotBatch, PNCounterBatch, SyncProtocolError, Universe,
)
from crdt_tpu_torch.batch import wirebulk
from crdt_tpu_torch.batch.map_batch import _leaves
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.sync import delta, digest, tree
from crdt_tpu_torch.utils.serde import to_binary
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets, random_map

torch.set_num_threads(1)
engine.set_threads(1)

N, A, M, D = 40, 8, 8, 4
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")


def _unis(**over):
    kw = {**dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=32), **over}
    return JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))


def _jax_states(planes):
    """JAX scalar Orswots holding unsigned dense planes (identity ids)."""
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
            vc = JaxVClock({a: int(d_clocks[i, r, a])
                            for a in np.nonzero(d_clocks[i, r])[0].tolist()})
            s.deferred.setdefault(vc.key(), set()).add(int(d_ids[i, r]))
        out.append(s)
    return out


def _np(jb):
    return tuple(np.asarray(getattr(jb, p)) for p in PLANES)


def _rows(jb, rows):
    return jax.tree_util.tree_map(lambda p: p[rows], jb)


def _set_rows(jb, rows, sub):
    return jax.tree_util.tree_map(lambda p, s: p.at[rows].set(s), jb, sub)


def _add_on(jb, rows, actor, member):
    """``jb`` with one add (the next dot of ``actor``) on each of ``rows``."""
    sub = _rows(jb, rows)
    k = rows.shape[0]
    sub = sub.apply_add(np.full(k, actor, np.int32), jnp.max(sub.clock, axis=-1) + 1,
                        np.full(k, member, np.int32))
    return _set_rows(jb, rows, sub)


def _replicas(seed=0):
    """JAX replicas P and Q of one plunged fleet, each with adds of its
    own on a seeded eighth of the rows, and the planted rows."""
    rng = np.random.RandomState(seed)
    (base,) = anti_entropy_fleets(rng, N, A, M, D, 1, base=4, novel=0, deferred_frac=0.25)
    p0 = JaxOrswotBatch(*(jnp.asarray(x) for x in base))
    p0 = p0.merge(p0)
    rows_p = np.sort(rng.choice(N, N // 8, replace=False))
    rows_q = np.sort(rng.choice(N, N // 8, replace=False))
    return _add_on(p0, rows_p, 1, 1 << 20), _add_on(p0, rows_q, 0, 1 << 21), rows_p, rows_q


def _port(planes):
    return OrswotBatch.from_numpy(*planes, device="cpu")


def _assert_planes(got, want):
    for name, g, w in zip(PLANES, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# -- frames ----------------------------------------------------------------------


def _frame_pairs():
    """(label, port frame, JAX frame) for every ported frame kind."""
    rng = np.random.RandomState(3)
    d = rng.randint(0, 2**62, size=300, dtype=np.int64).astype(np.uint64)
    vv = np.asarray([0, 5, 2**40, 2**64 - 1], np.uint64)
    pt, jt = tree.build_tree(d, device="cpu"), jtree.build_tree(d)
    parents = np.asarray([0, 1])
    lanes = pt.child_lanes(0, parents)
    blobs = [b"", b"\x01\x02", bytes(range(200))]
    ids = np.asarray([3, 9, 250])
    return [
        ("digest", delta.encode_digest_frame(d, vv), jdelta.encode_digest_frame(d, vv)),
        ("digest_no_vv", delta.encode_digest_frame(d[:5], None, version=3),
         jdelta.encode_digest_frame(d[:5], None, version=3)),
        ("tree_root", delta.encode_tree_root_frame(pt, vv), jdelta.encode_tree_root_frame(jt, vv)),
        ("tree_level", delta.encode_tree_level_frame(0, parents, lanes),
         jdelta.encode_tree_level_frame(0, parents, lanes)),
        ("tree_spec", delta.encode_tree_spec_frame(1, parents, lanes, version=4),
         jdelta.encode_tree_spec_frame(1, parents, lanes, version=4)),
        ("delta", delta.encode_delta_frame(300, ids, blobs),
         jdelta.encode_delta_frame(300, ids, blobs)),
        ("delta_chunk", delta.encode_delta_chunk_frame(300, 1, 4, ids, blobs),
         jdelta.encode_delta_chunk_frame(300, 1, 4, ids, blobs)),
        ("full", delta.encode_full_frame(blobs), jdelta.encode_full_frame(blobs)),
    ]


DECODERS = {"digest": "decode_digest_payload", "digest_no_vv": "decode_digest_payload",
            "tree_root": "decode_tree_root_payload", "tree_level": "decode_tree_level_payload",
            "tree_spec": "decode_tree_spec_payload", "delta": "decode_delta_payload",
            "delta_chunk": "decode_delta_chunk_payload", "full": "decode_full_payload"}


def _same_decoded(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_decoded(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("label", [p[0] for p in _frame_pairs()])
def test_frames_are_byte_equal_to_jax_and_decode_alike(label):
    _, mine, theirs = next(p for p in _frame_pairs() if p[0] == label)
    assert mine == theirs
    ftype, payload = delta.decode_frame(mine)
    assert (ftype, payload) == jdelta.decode_frame(mine)
    if label.startswith("tree"):
        assert delta.tree_subframe_kind(payload) == payload[0]
    _same_decoded(getattr(delta, DECODERS[label])(payload),
                  getattr(jdelta, DECODERS[label])(payload))


def _corrupt(frame, how):
    b = bytearray(frame)
    if how == "truncated_header":
        return bytes(b[:10])
    if how == "truncated_payload":
        return bytes(b[:-1])
    if how == "overlong":
        return bytes(b) + b"\x00"
    if how == "version":
        b[0] = 9
    elif how == "type":
        b[1] = 0x7F
    elif how == "crc":
        b[-1] ^= 0xFF
    return bytes(b)


@pytest.mark.parametrize("how", ["truncated_header", "truncated_payload", "overlong", "version",
                                 "type", "crc"])
def test_corrupted_frames_raise(how):
    frame = _frame_pairs()[5][1]
    bad = _corrupt(frame, how)
    with pytest.raises(JaxSyncProtocolError):
        jdelta.decode_frame(bad)
    before = sum(delta.rejected_counts().values())
    with pytest.raises(SyncProtocolError):
        delta.decode_frame(bad)
    assert sum(delta.rejected_counts().values()) == before + 1


@pytest.mark.parametrize("label", ["digest", "tree_root", "tree_level", "delta", "delta_chunk",
                                   "full"])
def test_malformed_payloads_raise(label):
    _, frame, _ = next(p for p in _frame_pairs() if p[0] == label)
    _, payload = delta.decode_frame(frame)
    for bad in (payload[:-3], payload + b"\x00\x00", payload[:5]):
        with pytest.raises(JaxSyncProtocolError):
            getattr(jdelta, DECODERS[label])(bad)
        with pytest.raises(SyncProtocolError):
            getattr(delta, DECODERS[label])(bad)
    with pytest.raises(SyncProtocolError):
        delta.decode_tree_level_payload(delta.decode_frame(_frame_pairs()[4][1])[1])
    with pytest.raises(SyncProtocolError):
        delta.tree_subframe_kind(b"")


def test_diverged_indices_match_jax_and_reject_unequal_fleets():
    a = np.arange(20, dtype=np.uint64)
    b = a.copy()
    b[[2, 7, 19]] += np.uint64(1)
    np.testing.assert_array_equal(delta.diverged_indices(a, b), jdelta.diverged_indices(a, b))
    with pytest.raises(SyncProtocolError, match="shape mismatch"):
        delta.diverged_indices(a, b[:5])


# -- gather and apply --------------------------------------------------------------


def test_gather_blobs_equal_jax_scalar_rows():
    jp, jq, rows_p, rows_q = _replicas()
    _, uni = _unis()
    ids = np.union1d(rows_p, rows_q)
    for jb in (jp, jq):
        planes = _np(jb)
        pb = _port(planes)
        got = delta.gather_blobs(pb, ids, uni)
        assert got == [jax_to_binary(s) for s in _jax_states(tuple(x[ids] for x in planes))]
        # the codec's encode of the whole planes, sliced to the rows, gives the same bytes
        whole = wirebulk.slice_blobs(*engine.orswot_encode_wire(*planes))
        assert got == [whole[i] for i in ids.tolist()]
    assert delta.gather_blobs(_port(_np(jp)), np.zeros(0, np.int64), uni) == []


def _jax_apply(local, blobs, ids, juni):
    """The JAX jnp route: peer rows from ``from_scalar`` of the decoded
    blobs, merged with the gathered local rows, scattered back."""
    peer = JaxOrswotBatch.from_scalar([jax_from_binary(b) for b in blobs], juni,
                                      via_device=False)
    return _set_rows(local, ids, _rows(local, ids).merge(peer))


@pytest.mark.parametrize("widths", ["config", "regrown"])
@pytest.mark.parametrize("direction", ["q_into_p", "p_into_q"])
def test_delta_applier_matches_jax_merge_and_set(widths, direction):
    juni, uni = _unis()
    jp, jq, rows_p, rows_q = _replicas(1)
    jlocal, jpeer = (jp, jq) if direction == "q_into_p" else (jq, jp)
    if widths == "regrown":
        jlocal = jlocal.with_capacity(2 * M, 2 * D)
    local = _port(_np(jlocal))
    ids = delta.diverged_indices(digest.digest_of(local, uni),
                                 digest.digest_of(_port(_np(jpeer)), uni))
    np.testing.assert_array_equal(ids, np.union1d(rows_p, rows_q))
    blobs = delta.gather_blobs(_port(_np(jpeer)), ids, uni)
    applier = delta.OrswotDeltaApplier(uni)
    before = local.to_numpy()
    got = applier.apply(local, ids, blobs)
    _assert_planes(local.to_numpy(), before)  # out of place
    want = _jax_apply(jlocal, blobs, ids, juni)
    _assert_planes(got.to_numpy(), _np(want))
    assert got.member_capacity == jlocal.ids.shape[-1]
    # after the exchange the fleets agree on the rows the peer holds
    np.testing.assert_array_equal(
        digest.digest_of(got, uni)[ids],
        digest.digest_of(_port(_np(jpeer)).with_capacity(got.member_capacity,
                                                         got.deferred_capacity).merge(
            _port(_np(jlocal)).with_capacity(got.member_capacity, got.deferred_capacity)),
            uni)[ids])
    # the warm staging is reused for a smaller delta
    staging = applier._staging
    seconds = {}
    again = applier.apply(local, ids[:3], blobs[:3], seconds=seconds)
    assert applier._staging is staging
    assert list(seconds) == ["parse_s", "h2d_s", "merge_s", "scatter_s"]
    assert all(v >= 0 for v in seconds.values())
    _assert_planes(again.to_numpy(), _np(_jax_apply(jlocal, blobs[:3], ids[:3], juni)))


def _crowded(ids_from, n=4, members=4):
    """Unsigned planes of ``n`` objects holding ``members`` members each,
    from ``ids_from`` up, one dot of actor ``ids_from % A`` apiece."""
    clock = np.zeros((n, A), np.uint32)
    ids = np.full((n, members), -1, np.int32)
    dots = np.zeros((n, members, A), np.uint32)
    actor = ids_from % A
    for j in range(members):
        ids[:, j] = ids_from + j
        dots[:, j, actor] = j + 1
    clock[:, actor] = members
    return (clock, ids, dots, np.full((n, 2), -1, np.int32), np.zeros((n, 2, A), np.uint32))


def test_delta_applier_raises_on_overflow_like_jax():
    juni, uni = _unis(member_capacity=4, deferred_capacity=2)
    local_planes, peer_planes = _crowded(0), _crowded(5)
    blobs = [jax_to_binary(s) for s in _jax_states(peer_planes)]
    ids = np.arange(4)
    with pytest.raises(JaxCapacityOverflowError):
        _jax_apply(JaxOrswotBatch(*(jnp.asarray(x) for x in local_planes)), blobs, ids, juni)
    with pytest.raises(CapacityOverflowError) as e:
        delta.OrswotDeltaApplier(uni).apply(_port(local_planes), ids, blobs)
    assert e.value.member


def test_delta_applier_rejects_mismatched_or_foreign_rows():
    _, uni = _unis()
    jp, jq, _, _ = _replicas(2)
    local = _port(_np(jp))
    blobs = delta.gather_blobs(_port(_np(jq)), np.asarray([1, 2]), uni)
    applier = delta.OrswotDeltaApplier(uni)
    with pytest.raises(SyncProtocolError, match="ids vs"):
        applier.apply(local, np.asarray([1]), blobs)
    with pytest.raises(SyncProtocolError, match="outside fleet"):
        applier.apply(local, np.asarray([1, N]), blobs)
    assert applier.apply(local, np.zeros(0, np.int64), []) is local
    assert delta.apply_delta_rows(local, np.zeros(0, np.int64), [], uni) is local


def _flat_fleets(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "lww":
        vals = [rng.randint(0, 50, size=N).astype(np.uint64) for _ in range(2)]
        marks = rng.permutation(4 * N)[:2 * N].astype(np.uint64) + np.uint64(1)
        return ((vals[0], marks[:N]), (vals[1], marks[N:]))
    shape = (N, A) if kind == "gcounter" else (N, 2, A)
    return tuple((rng.randint(0, 2**32, size=shape, dtype=np.int64).astype(np.uint32),)
                 for _ in range(2))


FLAT = {"gcounter": (GCounterBatch, JaxGCounterBatch),
        "pncounter": (PNCounterBatch, JaxPNCounterBatch),
        "lww": (LWWRegBatch, JaxLWWRegBatch)}


@pytest.mark.parametrize("kind", sorted(FLAT))
def test_apply_delta_rows_flat_types_match_jax(kind):
    juni, uni = _unis()
    cls, jcls = FLAT[kind]
    local_np, peer_np = _flat_fleets(kind, 5)
    local = cls.from_numpy(*local_np, device="cpu")
    peer = cls.from_numpy(*peer_np, device="cpu")
    ids = np.asarray([0, 3, 4, 17, N - 1])
    blobs = delta.gather_blobs(peer, ids, uni)
    got = delta.apply_delta_rows(local, ids, blobs, uni)
    jlocal = jcls(*(jnp.asarray(x) for x in local_np))
    jpeer = jcls.from_scalar([jax_from_binary(b) for b in blobs], juni)
    want = _set_rows(jlocal, ids, _rows(jlocal, ids).merge(jpeer))
    for g, w in zip(got.to_numpy() if kind == "lww" else (got.to_numpy(),),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_apply_delta_rows_map_mvreg_matches_jax():
    rng = np.random.RandomState(6)
    base = [random_map(rng, "mvreg", n_keys=4, n_actors=A) for _ in range(N)]
    forks = [[random_map(rng, "mvreg", m=m.clone(), n_keys=4, n_actors=A) for m in base]
             for _ in range(2)]
    kw = dict(num_actors=A, key_capacity=4, deferred_capacity=8, mv_capacity=16,
              member_capacity=M, counter_bits=32)
    juni, uni = JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))
    jvk, vk = JaxMVRegKernel.from_config(juni.config), MVRegKernel.from_config(uni.config)
    jlocal, jpeer = (JaxMapBatch.from_scalar([jax_from_binary(to_binary(m)) for m in f], juni,
                                             jvk) for f in forks)

    def port(jb):
        return MapBatch.from_numpy(*jax.tree.map(np.asarray, jb.state),
                                   MapKernel.from_config(uni.config, vk), device="cpu")

    local, peer = port(jlocal), port(jpeer)
    ids = np.asarray([1, 2, 8, 30])
    blobs = delta.gather_blobs(peer, ids, uni)
    got = delta.apply_delta_rows(local, ids, blobs, uni)
    sub = JaxMapBatch.from_scalar([jax_from_binary(b) for b in blobs], juni, jvk)
    want = _set_rows(jlocal, ids, _rows(jlocal, ids).merge(sub))
    got_leaves = _leaves(got.to_numpy())
    want_leaves = jax.tree_util.tree_leaves(want.state)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, np.asarray(w))
