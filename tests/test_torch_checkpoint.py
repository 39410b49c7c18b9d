"""Parity of the port's batch checkpoint (``crdt_tpu_torch.utils.
checkpoint``) with the JAX package's, on the CPU:

* ``save_bytes`` byte-equal to the JAX one for all eight batch types
  (three Map compositions), u32 and u64 counters (near 2^31 and 2^63 where
  a type holds counters), identity and dict universes;
* cross-loads both ways giving bit-equal planes (and the universe back);
* the JAX ``tests/test_checkpoint.py`` corruptions raising
  ``CheckpointFormatError`` (a ``ValueError``) in both packages, a missing
  file and a directory keeping their I/O errors, and non-batch types
  refused.

The JAX batches are built straight from numpy planes (Maps from scalar
maps through the pure-Python codec): nothing reaches ``crdt_tpu.native``."""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch import (
    GCounterBatch as JaxGCounterBatch, GSetBatch as JaxGSetBatch, LWWRegBatch as JaxLWWRegBatch,
    MapBatch as JaxMapBatch, MVRegBatch as JaxMVRegBatch, OrswotBatch as JaxOrswotBatch,
    PNCounterBatch as JaxPNCounterBatch, VClockBatch as JaxVClockBatch,
)
from crdt_tpu.batch.val_kernels import (
    MapKernel as JaxMapKernel, MVRegKernel as JaxMVRegKernel, OrswotKernel as JaxOrswotKernel,
)
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import CheckpointFormatError as JaxCheckpointFormatError
from crdt_tpu.utils import checkpoint as jck
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import from_binary as jax_from_binary
from crdt_tpu_torch import (
    CheckpointFormatError, CrdtConfig, CrdtError, GCounterBatch, GSetBatch, LWWRegBatch,
    MapBatch, MapKernel, MVRegBatch, MVRegKernel, OrswotBatch, OrswotKernel, PNCounterBatch,
    Universe, VClockBatch,
)
from crdt_tpu_torch.utils import checkpoint as ck
from crdt_tpu_torch.utils.serde import to_binary
from crdt_tpu_torch.utils.testdata import random_map, random_orswot_arrays

torch.set_num_threads(1)

N, A, M, D, K, U = 24, 6, 5, 3, 3, 40
KINDS = ("orswot", "vclock", "gcounter", "pncounter", "lwwreg", "mvreg", "gset", "map_mvreg",
         "map_orswot", "map_map")


def _kw(bits):
    return dict(num_actors=A, member_capacity=M, deferred_capacity=D, mv_capacity=K,
                key_capacity=6, counter_bits=bits)


def _universes(bits, ident):
    kw = _kw(bits)
    if ident:
        return JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))
    unis = JaxUniverse(JaxConfig(**kw)), Universe(CrdtConfig(**kw))
    for u in unis:
        u.actors.intern_all(["alice", "bob", 7])
        u.members.intern_all(["m0", 3, ("t", 1), "m1"])
    return unis


def _counters(rng, shape, bits):
    dt = np.uint32 if bits == 32 else np.uint64
    top = 1 << (bits - 1)
    return (rng.randint(0, 50, size=shape).astype(dt)
            + np.where(rng.rand(*shape) < 0.3, dt(top), dt(0)).astype(dt))


def _map_pair(kind, bits, juni, uni, rng):
    """A JAX Map batch from random scalar maps and the port's of its planes."""
    val = {"map_mvreg": "mvreg", "map_orswot": "orswot", "map_map": "map"}[kind]
    jc, pc = juni.config, uni.config
    if val == "mvreg":
        jvk, pvk = JaxMVRegKernel.from_config(jc), MVRegKernel.from_config(pc)
    elif val == "orswot":
        jvk, pvk = JaxOrswotKernel.from_config(jc), OrswotKernel.from_config(pc)
    else:
        jvk = JaxMapKernel.from_config(jc, JaxMVRegKernel.from_config(jc))
        pvk = MapKernel.from_config(pc, MVRegKernel.from_config(pc))
    top = 1 << (bits - 1)
    maps = [random_map(rng, val, n_keys=4, n_actors=3, max_ops=4, counters=(1, 2, top, top + 1))
            for _ in range(8)]
    jb = JaxMapBatch.from_scalar([jax_from_binary(to_binary(m)) for m in maps], juni, jvk)
    # the JAX build interned the maps' actors, keys and values: the port's
    # universe takes the same registries
    uni.actors.intern_all(juni.actors.values())
    uni.members.intern_all(juni.members.values())
    state = jax.tree.map(np.asarray, jb.state)
    return jb, MapBatch.from_numpy(*state, MapKernel.from_config(pc, pvk), device="cpu")


def _pair(kind, bits, juni, uni, seed=0):
    """The same state as a JAX batch and as the port's (on the CPU)."""
    rng = np.random.RandomState(seed)
    if kind.startswith("map"):
        return _map_pair(kind, bits, juni, uni, rng)
    dt = np.uint32 if bits == 32 else np.uint64
    if kind == "orswot":
        planes = list(random_orswot_arrays(rng, N, A, M, D, dtype=dt, deferred_frac=0.3))
        planes[0] = planes[0] + dt(1 << (bits - 1))  # clocks past 2^31 / 2^63
        return (JaxOrswotBatch(*(jnp.asarray(x) for x in planes)),
                OrswotBatch.from_numpy(*planes, device="cpu"))
    if kind in ("vclock", "gcounter"):
        x = _counters(rng, (N, A), bits)
        jcls, pcls = (JaxVClockBatch, VClockBatch) if kind == "vclock" \
            else (JaxGCounterBatch, GCounterBatch)
        return jcls(clocks=jnp.asarray(x)), pcls.from_numpy(x, device="cpu")
    if kind == "pncounter":
        x = _counters(rng, (N, 2, A), bits)
        return JaxPNCounterBatch(planes=jnp.asarray(x)), PNCounterBatch.from_numpy(x, device="cpu")
    if kind == "lwwreg":  # u64 in both packages, whatever the counter width
        v = _counters(rng, (N,), 64)
        m = _counters(rng, (N,), 64)
        return (JaxLWWRegBatch(vals=jnp.asarray(v), markers=jnp.asarray(m)),
                LWWRegBatch.from_numpy(v, m, device="cpu"))
    if kind == "mvreg":
        c, v = _counters(rng, (N, K, A), bits), _counters(rng, (N, K), bits)
        return (JaxMVRegBatch(clocks=jnp.asarray(c), vals=jnp.asarray(v)),
                MVRegBatch.from_numpy(c, v, device="cpu"))
    bits_ = rng.rand(N, U) < 0.3
    return JaxGSetBatch(bits=jnp.asarray(bits_)), GSetBatch.from_numpy(bits_, device="cpu")


def _jax_leaves(jb):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jb)]


def _port_leaves(pb):
    planes = pb.to_numpy()
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(planes)]


def _same_universe(got, want):
    assert _config(got.config) == _config(want.config)
    assert got.actors.values() == want.actors.values()
    assert got.members.values() == want.members.values()
    assert type(got.actors).__name__ == type(want.actors).__name__
    assert type(got.members).__name__ == type(want.members).__name__


def _config(cfg):
    """A config's fields, less the JAX package's ``merge_impl``."""
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "merge_impl"}


@pytest.mark.parametrize("ident", [True, False], ids=["identity", "dict"])
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_save_bytes_equal_and_cross_loads(kind, bits, ident):
    juni, uni = _universes(bits, ident)
    jb, pb = _pair(kind, bits, juni, uni)
    want = jck.save_bytes(jb, juni)
    got = ck.save_bytes(pb, uni)
    assert got == want
    # the port loads the JAX bytes ...
    back, buni = ck.load_bytes(want, device="cpu")
    assert type(back) is type(pb)
    assert len(_port_leaves(back)) == len(_jax_leaves(jb)) > 0
    for g, w in zip(_port_leaves(back), _jax_leaves(jb)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _same_universe(buni, uni)
    # ... and the JAX package the port's
    jback, jbuni = jck.load_bytes(got)
    assert len(_jax_leaves(jback)) == len(_port_leaves(pb))
    for g, w in zip(_jax_leaves(jback), _port_leaves(pb)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _same_universe(uni, jbuni)
    if kind.startswith("map"):
        assert back.kernel == pb.kernel


def test_file_paths_round_trip_as_jax(tmp_path):
    juni, uni = _universes(32, True)
    jb, pb = _pair("orswot", 32, juni, uni, seed=5)
    ck.save(tmp_path / "port", pb, uni)  # ".npz" appended, as the JAX save does
    jck.save(tmp_path / "jax", jb, juni)
    assert (tmp_path / "port.npz").read_bytes() == (tmp_path / "jax.npz").read_bytes()
    back, _ = ck.load(tmp_path / "port", device="cpu")
    for g, w in zip(back.to_numpy(), pb.to_numpy()):
        np.testing.assert_array_equal(g, w)
    with np.load(tmp_path / "port.npz", allow_pickle=False) as z:
        assert z.files[:3] == ["__meta__", "__universe__", "clock"]


def _valid():
    juni, uni = _universes(64, False)
    return _pair("orswot", 64, juni, uni, seed=2)[1], uni


def _npz(**members):
    buf = io.BytesIO()
    np.savez(buf, **members)
    return buf.getvalue()


def _flip_member(data):
    data = bytearray(data)
    name_len = data[26] | (data[27] << 8)
    data[30 + name_len + 64] ^= 0xFF
    return bytes(data)


def _drop_member(data):
    src = zipfile.ZipFile(io.BytesIO(data))
    victim = next(n for n in src.namelist() if not n.startswith("__"))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as dst:
        for n in src.namelist():
            if n != victim:
                dst.writestr(n, src.read(n))
    return out.getvalue()


def _meta(**over):
    meta = {"version": 1, "type": "OrswotBatch", "static": {}, "empty": {}, **over}
    pb, uni = _valid()
    z = np.load(io.BytesIO(ck.save_bytes(pb, uni)))
    members = {k: z[k] for k in z.files}
    members["__meta__"] = np.frombuffer(to_binary(meta), dtype=np.uint8)
    return _npz(**members)


CORRUPTIONS = {
    "empty": lambda: b"",
    "garbage": lambda: b"garbage-not-a-zip",
    "zip_head_only": lambda: b"PK\x03\x04truncated",
    "npz_not_checkpoint": lambda: _npz(a=np.arange(3)),
    "meta_not_dict": lambda: _npz(__meta__=np.frombuffer(to_binary(42), dtype=np.uint8),
                                  __universe__=np.frombuffer(to_binary({}), dtype=np.uint8)),
    "bare_npy": lambda: (lambda b: (np.save(b, np.arange(4)), b.getvalue())[1])(io.BytesIO()),
    "truncated_1": lambda: ck.save_bytes(*_valid())[:1],
    "truncated_half": lambda: (lambda d: d[:len(d) // 2])(ck.save_bytes(*_valid())),
    "truncated_tail": lambda: ck.save_bytes(*_valid())[:-3],
    "member_crc": lambda: _flip_member(ck.save_bytes(*_valid())),
    "missing_field": lambda: _drop_member(ck.save_bytes(*_valid())),
    "version": lambda: _meta(version=2),
    "unknown_type": lambda: _meta(type="NoSuchBatch"),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corruptions_raise_checkpoint_format_error_in_both(case):
    data = CORRUPTIONS[case]()
    with pytest.raises(JaxCheckpointFormatError):
        jck.load_bytes(data)
    with pytest.raises(CheckpointFormatError) as ei:
        ck.load_bytes(data, device="cpu")
    assert isinstance(ei.value, CrdtError) and isinstance(ei.value, ValueError)


def test_io_errors_and_non_batches_kept(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.load(tmp_path / "nope.npz", device="cpu")
    with pytest.raises(IsADirectoryError):
        ck.load(tmp_path, device="cpu")
    uni = Universe()
    for bad in (object(), MVRegKernel.from_config(uni.config)):
        with pytest.raises(TypeError, match="checkpointable"):
            ck.save(io.BytesIO(), bad, uni)
