"""Parity of the port's digest trees (``crdt_tpu_torch.sync.tree``) with
the JAX package's, on the CPU, bit for bit: every level of
``build_tree``, ``wire_lanes``, ``diverged_children``, and
``simulate_descent``'s diverged set and byte accounting over converged,
sparse, clustered and dense divergence, a forced cutover, an XOR
collision and fleet sizes that are not powers of k."""

import dataclasses

import numpy as np
import pytest
import torch

from crdt_tpu.sync import tree as jt
from crdt_tpu_torch.sync import tree as pt

torch.set_num_threads(1)


def _digests(n, seed):
    return np.random.RandomState(seed).randint(0, 2**63, size=n, dtype=np.int64).astype(
        np.uint64) * np.uint64(3)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 300, 4097])
def test_build_tree_levels_match_jax(n):
    d = _digests(n, n)
    want, got = jt.build_tree(d), pt.build_tree(d, device="cpu")
    assert got.num_levels == want.num_levels and got.n == want.n
    for g, w in zip(got.levels, want.levels):
        assert g.dtype == np.uint64
        np.testing.assert_array_equal(g, w)
    assert got.root == want.root
    if got.num_levels >= 2:
        parents = np.arange(got.level_size(got.num_levels - 1))
        np.testing.assert_array_equal(got.child_lanes(got.num_levels - 2, parents),
                                      want.child_lanes(want.num_levels - 2, parents))


def test_build_tree_refuses_another_fanout():
    with pytest.raises(ValueError, match="k=16"):
        pt.build_tree(_digests(4, 0), k=8, device="cpu")


def _diverge(d, rows, seed):
    out = d.copy()
    out[rows] ^= np.random.RandomState(seed).randint(1, 2**62, size=len(rows)).astype(
        np.uint64)
    return out


CASES = {
    "converged": lambda n: np.zeros(0, np.int64),
    "one": lambda n: np.asarray([n // 3]),
    "sparse": lambda n: np.random.RandomState(1).choice(n, n // 100, replace=False),
    "clustered": lambda n: np.arange(n // 2, n // 2 + 40),
    "dense": lambda n: np.arange(n),
}


@pytest.mark.parametrize("n", [4000, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_descent_matches_jax(n, case):
    d = _digests(n, 7)
    rows = np.sort(CASES[case](n))
    e = _diverge(d, rows, 8)
    want_ids, want_stats = jt.simulate_descent(jt.build_tree(d), jt.build_tree(e))
    got_ids, got_stats = pt.simulate_descent(pt.build_tree(d, device="cpu"),
                                             pt.build_tree(e, device="cpu"))
    np.testing.assert_array_equal(got_ids, want_ids)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)
    # a descent finds the planted rows exactly, unless it cut over
    np.testing.assert_array_equal(got_ids, np.zeros(0, np.int64) if got_stats.cutover
                                  else rows)


def test_descent_flat_budget_collision_and_single_level():
    d = _digests(600, 3)
    e = _diverge(d, np.arange(0, 600, 5), 4)
    for flat in (None, 64, 10_000):
        want = jt.simulate_descent(jt.build_tree(d), jt.build_tree(e), flat_bytes=flat)
        got = pt.simulate_descent(pt.build_tree(d, device="cpu"),
                                  pt.build_tree(e, device="cpu"), flat_bytes=flat)
        np.testing.assert_array_equal(got[0], want[0])
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    # a parent that differs while no child does reads as a collision
    ta = pt.build_tree(d, device="cpu")
    tb = pt.DigestTree([lv.copy() for lv in ta.levels])
    tb.levels[-1][0] ^= np.uint64(1)
    ids, stats = pt.simulate_descent(ta, tb)
    assert ids.size == 0 and stats.collision
    jb = jt.DigestTree([lv.copy() for lv in ta.levels])
    jb.levels[-1][0] ^= np.uint64(1)
    assert dataclasses.asdict(stats) == dataclasses.asdict(
        jt.simulate_descent(jt.DigestTree(ta.levels), jb)[1])
    # one-object trees diverge whole
    one, other = _digests(1, 0), _digests(1, 1)
    got = pt.simulate_descent(pt.build_tree(one, device="cpu"), pt.build_tree(other, device="cpu"))
    want = jt.simulate_descent(jt.build_tree(one), jt.build_tree(other))
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="size mismatch"):
        pt.simulate_descent(ta, pt.build_tree(one, device="cpu"))


def test_wire_lanes_and_diverged_children_match_jax():
    rng = np.random.RandomState(5)
    mine = rng.randint(0, 2**63, size=48, dtype=np.int64).astype(np.uint64)
    theirs = mine.copy()
    theirs[[3, 17, 40]] ^= np.uint64(1 << 33)  # above the wire width: invisible
    theirs[[5, 20]] ^= np.uint64(1)
    np.testing.assert_array_equal(pt.wire_lanes(mine), jt.wire_lanes(mine))
    parents = np.asarray([0, 4, 9])
    for count in (48 * 4, 150):
        np.testing.assert_array_equal(
            pt.diverged_children(parents, mine, theirs, count),
            jt.diverged_children(parents, mine, theirs, count))
