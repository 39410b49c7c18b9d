"""Parity of the port's union-aligned fold (the plain version of the K1
kernel, ``crdt_tpu_torch.ops.orswot_fold_aligned``) with the JAX
package's ``orswot_fold_aligned.fold_merge`` run in interpret mode —
bit for bit, overflow flags included — and, at the north-star widths
(where interpret mode is too slow for the suite), with the JAX
sequential fold, which is the kernel's contract."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.ops import orswot_fold_aligned as jfa, orswot_ops as jops
from crdt_tpu.utils.testdata import anti_entropy_fleets, random_orswot_arrays
from crdt_tpu_torch import OrswotBatch
from crdt_tpu_torch.ops import orswot_fold_aligned as tfa

torch.set_num_threads(1)

NAMES = ("clock", "ids", "dots", "d_ids", "d_clocks", "overflow")


def _port(planes):
    b = OrswotBatch.from_numpy(*planes, device="cpu")
    return b.clock, b.ids, b.dots, b.d_ids, b.d_clocks


def _unport(out):
    return OrswotBatch(*out[:5]).to_numpy() + (out[5].numpy(),)


def _assert_same(want, got):
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _fleets(seed, n, a, m, d, r, **kw):
    fl = anti_entropy_fleets(np.random.RandomState(seed), n, a, m, d, r, **kw)
    return tuple(np.stack([f[k] for f in fl]) for k in range(5))


def _interp(st, m_cap, d_cap, **kw):
    return jfa.fold_merge(*map(jnp.asarray, st), m_cap, d_cap, interpret=True, **kw)


# (seed, n, a, m, d, r, base, novel, deferred_frac, u_cap): the odd widths
# and u_cap=32 are the shapes chip_smoke.py holds the kernel's shared-memory
# instantiation and per-lane cp.async route against this plain version at
@pytest.mark.parametrize("case", [
    (3, 11, 8, 6, 2, 3, 3, 1, 0.0, None),
    (3, 11, 8, 6, 2, 3, 3, 1, 0.6, None),
    (21, 37, 13, 5, 3, 3, 2, 1, 0.6, None),
    (22, 5, 8, 16, 2, 4, 8, 2, 0.5, 32),
], ids=["no_deferred", "deferred", "odd_widths", "u_cap_32"])
def test_fold_matches_interpret(case):
    seed, n, a, m, d, r, base, novel, deferred_frac, u_cap = case
    st = _fleets(seed, n, a, m, d, r, base=base, novel=novel, deferred_frac=deferred_frac)
    kw = {} if u_cap is None else {"u_cap": u_cap}
    want = _interp(st, m, d, **kw)
    got = _unport(tfa.fold_merge(*_port(st), m, d, prebiased=True, **kw))
    _assert_same(want, got)


def test_fold_no_plunger_matches_interpret():
    st = _fleets(6, 9, 8, 6, 2, 3, base=3, novel=1, deferred_frac=0.5)
    want = _interp(st, 6, 2, plunger=False)
    got = _unport(tfa.fold_merge(*_port(st), 6, 2, plunger=False, prebiased=True))
    _assert_same(want, got)


def test_single_replica_fold_matches_interpret():
    st = _fleets(7, 9, 8, 6, 2, 1, base=3, novel=1, deferred_frac=0.5)
    want = _interp(st, 6, 2)
    got = _unport(tfa.fold_merge(*_port(st), 6, 2, prebiased=True))
    _assert_same(want, got)


def test_union_overflow_flagged_like_interpret():
    """Disjoint member sets per replica: the union outgrows u_cap and the
    member flag must be set, exactly where the JAX kernel sets it."""
    rng = np.random.RandomState(8)
    n, a, m, d, r = 7, 4, 4, 2, 3
    reps = []
    for rep in range(r):
        c, i, dt, di, dc = random_orswot_arrays(rng, n, a, m, d, min_live=m)
        reps.append((c, np.where(i >= 0, i + rep * (1 << 25), i).astype(np.int32), dt, di, dc))
    st = tuple(np.stack([x[k] for x in reps]) for k in range(5))
    want = _interp(st, m, d, u_cap=6)
    got = _unport(tfa.fold_merge(*_port(st), m, d, u_cap=6, prebiased=True))
    assert got[5][:, 0].all()
    np.testing.assert_array_equal(got[5], np.asarray(want[5]))


@pytest.mark.parametrize("seed", [0, 1])
def test_north_star_shape_matches_sequential_fold(seed):
    """A=64, M=16, D=2, R=8, u_cap=16 at small n: no overflow, and
    bit-equal to the JAX sequential fold of pairwise merges."""
    st = _fleets(seed, 12, 64, 16, 2, 8, base=6, novel=1, deferred_frac=0.25)
    want = jops.fold_merge_sequential(*map(jnp.asarray, st), 16, 2, impl="rank")
    got = _unport(tfa.fold_merge(*_port(st), 16, 2, u_cap=16, prebiased=True))
    assert not np.asarray(want[5]).any() and not got[5].any()
    _assert_same(want, got)


def test_uint32_entry_and_prebiased_agree():
    st = _fleets(4, 10, 8, 6, 2, 3, base=3, novel=1, deferred_frac=0.5)
    u32 = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in st)
    out = tfa.fold_merge(*u32, 6, 2)
    assert out[0].dtype == torch.uint32
    biased = tfa.fold_merge(*_port(st), 6, 2, prebiased=True)
    from crdt_tpu_torch.ops.orswot_tile import to_kernel_domain

    for x, y in zip(to_kernel_domain(out[:5]) + (out[5],), biased):
        assert torch.equal(x, y)
