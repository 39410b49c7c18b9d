"""Parity of the port's ``ops/map_ops.py`` helpers and value-kernel state
protocol with the JAX package's: ``align_keyed`` (the both-sides run
rule under a stable sort), ``compact_keyed``, the tree helpers over
nested tuples, ``_settle_deferred`` (whose max identity is the biased
zero) and the kernels' ``grow_state``/``zeros``/``zeros_like``, on seeded
numpy planes with counters at and above 2^31 (u32) and 2^63 (u64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.val_kernels import (
    MapKernel as JaxMapKernel, MVRegKernel as JaxMVRegKernel, OrswotKernel as JaxOrswotKernel,
)
from crdt_tpu.ops import map_ops as jax_map_ops
from crdt_tpu_torch.batch.val_kernels import MapKernel, MVRegKernel, OrswotKernel
from crdt_tpu_torch.dtypes import counters_to_numpy
from crdt_tpu_torch.ops import map_ops

torch.set_num_threads(1)

N, A, K, KV, D = 48, 5, 4, 3, 3


def _keys(rng, n, k, hi=9):
    """Key tables with unique ids per row and EMPTY holes anywhere."""
    out = np.full((n, k), -1, np.int32)
    for i in range(n):
        live = rng.rand(k) < 0.7
        out[i, live] = rng.choice(hi, size=int(live.sum()), replace=False)
    return out


def _ctr(rng, shape, bits):
    """Unsigned counters: mostly 0 and small, some at and above 2^(bits-1)."""
    top = 1 << (bits - 1)
    pool = np.array([0, 0, 0, 1, 2, 3, top, top + 1, (1 << bits) - 1], dtype=np.uint64)
    return pool[rng.randint(0, len(pool), size=shape)].astype(
        np.uint32 if bits == 32 else np.uint64)


def _flat(tree):
    return [x for t in tree for x in _flat(t)] if isinstance(tree, tuple) else [tree]


def _kernels(bits):
    """Port and JAX value kernels of ``Map<K2, MVReg>``."""
    inner, jinner = MVRegKernel(KV, A, bits), JaxMVRegKernel(KV, A, bits)
    return MapKernel(K, D, A, inner, bits), JaxMapKernel(K, D, A, jinner, bits)


def _state(rng, bits, n=N, k=K):
    """Unsigned planes of a ``Map<K2, MVReg>`` value state ``[n, ...]``."""
    dt = np.uint32 if bits == 32 else np.uint64
    mv = (_ctr(rng, (n, k, KV, A), bits), rng.randint(0, 9, size=(n, k, KV)).astype(dt))
    return (_ctr(rng, (n, A), bits), _keys(rng, n, k), _ctr(rng, (n, k, A), bits), mv,
            _keys(rng, n, D), _ctr(rng, (n, D, A), bits))


def _same(got_np, want):
    got, want = _flat(got_np), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_align_keyed_matches_jax():
    rng = np.random.RandomState(0)
    for ka, kb in ((4, 4), (3, 5), (1, 6)):
        a, b = _keys(rng, N, ka), _keys(rng, N, kb)
        b[::4, :min(ka, kb)] = a[::4, :min(ka, kb)]  # many keys on both sides
        want = jax_map_ops.align_keyed(jnp.asarray(a), jnp.asarray(b))
        got = map_ops.align_keyed(torch.from_numpy(a), torch.from_numpy(b))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bits", [32, 64])
def test_compact_keyed_and_tree_helpers_match_jax(bits):
    rng = np.random.RandomState(bits)
    kern, jkern = _kernels(bits)
    st = _state(rng, bits, k=2 * K)
    dev = kern.from_numpy_vals(st, "cpu")
    jst = jax.tree.map(jnp.asarray, st)
    vals, jvals = dev[3], jst[3]
    for cap in (2, K, 2 * K):
        got = map_ops.compact_keyed(dev[1], dev[2], vals, cap)
        want = jax_map_ops.compact_keyed(jst[1], jst[2], jvals, jkern.val_kernel, cap)
        _same((got[0].numpy(), counters_to_numpy(got[1]), kern.val_kernel.to_numpy_vals(got[2]),
               got[3].numpy()), want)
    idx = rng.randint(0, 2 * K, size=(N, 3))
    mask = rng.rand(N, 2 * K) < 0.5
    slot, do = rng.randint(0, 2 * K, size=N), rng.rand(N) < 0.6
    zeros = kern.val_kernel.zeros_like(vals)
    got = map_ops.tree_gather(vals, torch.from_numpy(idx))
    _same(kern.val_kernel.to_numpy_vals(got), jax_map_ops.tree_gather(jvals, jnp.asarray(idx)))
    got = map_ops.tree_where(torch.from_numpy(mask), vals, zeros)
    _same(kern.val_kernel.to_numpy_vals(got), jax_map_ops.tree_where(
        jnp.asarray(mask), jvals, jkern.val_kernel.zeros_like(jvals)))
    upd = map_ops._tree_map(lambda x: x[:, 0], zeros)
    got = map_ops.tree_scatter_slot(vals, torch.from_numpy(slot), upd,
                                    torch.from_numpy(do), 2 * K)
    _same(kern.val_kernel.to_numpy_vals(got), jax_map_ops.tree_scatter_slot(
        jvals, jnp.asarray(slot), jax.tree.map(lambda x: jnp.zeros_like(x[:, 0]), jvals),
        jnp.asarray(do), 2 * K))


@pytest.mark.parametrize("bits", [32, 64])
def test_settle_deferred_matches_jax(bits):
    """The replay's join over matching rows starts from the biased zero: a
    plain 0 would be a live counter in the port's domain."""
    rng = np.random.RandomState(10 + bits)
    kern, jkern = _kernels(bits)
    st = _state(rng, bits)
    st[4][::3] = st[1][::3, :D]  # deferred rows citing live keys
    dev = kern.from_numpy_vals(st, "cpu")
    got = map_ops._settle_deferred(*dev, kern.val_kernel)
    want = jax_map_ops._settle_deferred(*jax.tree.map(jnp.asarray, st), jkern.val_kernel)
    _same(kern.to_numpy_vals((dev[0],) + got[:5])[1:] + (got[5].numpy(),), want)


@pytest.mark.parametrize("bits", [32, 64])
def test_grow_state_and_zeros_match_jax(bits):
    rng = np.random.RandomState(20 + bits)
    kern, jkern = _kernels(bits)
    st = _state(rng, bits)
    target, jtarget = kern.grown(2), jkern.grown(2)
    got = kern.grow_state(kern.from_numpy_vals(st, "cpu"), target)
    _same(target.to_numpy_vals(got),
          jkern.grow_state(jax.tree.map(jnp.asarray, st), jtarget))
    wide = MapKernel(K + 3, D, A, kern.val_kernel, bits)
    _same(wide.to_numpy_vals(kern.grow_state(kern.from_numpy_vals(st, "cpu"), wide)),
          jkern.grow_state(jax.tree.map(jnp.asarray, st), JaxMapKernel(
              K + 3, D, A, jkern.val_kernel, bits)))
    with pytest.raises(ValueError, match="shrink"):
        target.grow_state(got, kern)
    orswot, jorswot = OrswotKernel(3, 2, A, bits), JaxOrswotKernel(3, 2, A, bits)
    for k, jk in ((kern, jkern), (orswot, jorswot), (kern.val_kernel, jkern.val_kernel)):
        z = k.zeros((2, 3), "cpu")
        _same(k.to_numpy_vals(z), jk.zeros((2, 3)))
        _same(k.to_numpy_vals(k.zeros_like(z)), jk.zeros_like(jk.zeros((2, 3))))
    og = orswot.grow_state(orswot.zeros((4,), "cpu"), orswot.grown(3))
    _same(orswot.grown(3).to_numpy_vals(og),
          jorswot.grow_state(jorswot.zeros((4,)), jorswot.grown(3)))


def test_first_true_index_of_bool_masks():
    rng = np.random.RandomState(1)
    m = rng.rand(64, 9) < 0.3
    np.testing.assert_array_equal(map_ops._first(torch.from_numpy(m)).numpy(),
                                  np.argmax(m, axis=-1))
