"""Parity of the port's heat observatory (``crdt_tpu_torch.obs.heat``) with
the JAX package's, on the CPU: the subtree fold and the Space-Saving
sketch bit-equal to the JAX kernels over seeded batches with duplicates
and ties, ``zipf_fit`` (floats at rtol 1e-12), ``merge_hot``,
``parse_plan``, ``mesh_bounds`` and ``score_plan``, and a
``HeatTracker`` driven alike on both sides (injected clocks, a private
JAX registry) through a layout regrow: snapshots, ``hot()``, the heat
vector and plan reports equal."""

import numpy as np
import pytest
import torch

from crdt_tpu.config import enable_x64
from crdt_tpu.obs import heat as jax_heat
from crdt_tpu.obs.metrics import MetricsRegistry
from crdt_tpu_torch.obs import heat

torch.set_num_threads(1)
enable_x64()  # the JAX tracker's own ids dtype (int64 under x64)


def _table(capacity):
    z = np.zeros(capacity, np.int64)
    return np.full(capacity, -1, np.int64), z, z.copy()


@pytest.mark.parametrize("capacity,space", [(8, 12), (16, 40), (128, 3000)])
def test_sketch_matches_jax_batch_by_batch(capacity, space):
    """60 seeded batches of skewed ids (in-batch duplicates, equal counts
    everywhere): the table is bit-equal to the JAX kernel's after each."""
    rng = np.random.RandomState(capacity)
    jt = tuple(map(np.asarray, _table(capacity)))
    pt = tuple(torch.from_numpy(x) for x in _table(capacity))
    kern = jax_heat._sketch_kernel(capacity)
    for step in range(60):
        b = int(rng.choice([1, 3, 8, 9, 64, 200]))
        ids = np.minimum(rng.zipf(1.3, b) - 1, space - 1).astype(np.int64)
        if step % 7 == 0:
            ids = np.repeat(ids[: max(1, b // 4)], 4)[:b]  # runs of equal ids
        pad, w = jax_heat._pad_pow2(ids)
        jt = tuple(np.asarray(x) for x in kern(*jt, pad, w))
        ppad, pw = heat._pad_pow2(ids)
        np.testing.assert_array_equal(ppad, pad)
        pt = heat.sketch_update(*pt, torch.from_numpy(ppad), torch.from_numpy(pw))
        for g, want, name in zip(pt, jt, ("ids", "counts", "errs")):
            assert g.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(g.numpy(), want, err_msg=f"{name} after batch {step}")


@pytest.mark.parametrize("n", [1, 17, 300, 5000, 70_000])
def test_subtree_fold_matches_jax(n):
    from crdt_tpu_torch.obs.stability import subtree_layout

    subtrees, span = subtree_layout(n)
    rng = np.random.RandomState(n)
    ids = rng.randint(0, n, 77).astype(np.int64)
    pad, w = heat._pad_pow2(ids)
    want = np.asarray(jax_heat._fold_kernel(subtrees, span)(pad, w))
    got = heat.subtree_fold(torch.from_numpy(pad), torch.from_numpy(w), subtrees, span).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_zipf_fit_and_merge_hot_match_jax():
    rng = np.random.RandomState(3)
    for s in (0.6, 1.1, 1.5):
        counts = list(1e5 / np.arange(1, 40) ** s * rng.uniform(0.9, 1.1, 39))
        for c in (counts, counts[:5], counts[:6], [0, -1] + counts[:8], [7.0] * 10):
            got, want = heat.zipf_fit(c), jax_heat.zipf_fit(c)
            if want[0] is None:
                assert got == want
            else:
                np.testing.assert_allclose(got, want, rtol=1e-12)
    lists = [[{"obj": int(o), "count": int(c), "err": int(e)}
              for o, c, e in zip(rng.randint(0, 20, 10), rng.randint(1, 99, 10),
                                 rng.randint(0, 5, 10))] for _ in range(3)]
    lists.append([{"obj": 3, "count": 5}])
    assert heat.merge_hot(lists) == jax_heat.merge_hot(lists)


@pytest.mark.parametrize("spec", ["mesh:8", "mesh:1", " RING:5, k=3", "ring:3", "ring:1,k=4",
                                  "mesh:0", "ring:4,j=2", "ring:x", "disk:2", "mesh"])
def test_parse_plan_matches_jax(spec):
    try:
        want = jax_heat.parse_plan(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="bad plan spec"):
            heat.parse_plan(spec)
        assert "bad plan spec" in str(e)
    else:
        assert heat.parse_plan(spec) == want


@pytest.mark.parametrize("spec,granule", [("mesh:4", None), ("mesh:3", 16), ("mesh:7", 256),
                                          ("ring:5,k=3", None), ("ring:1", None),
                                          ("ring:6,k=2", None)])
def test_score_plan_matches_jax(spec, granule):
    rng = np.random.RandomState(5)
    for n, span in ((5000, 4096), (300, 16), (1, 1)):
        sub = -(-n // span)
        vec = rng.zipf(1.2, sub).astype(np.float64)
        assert heat.score_plan(spec, vec, n=n, span=span, granule=granule) == \
            jax_heat.score_plan(spec, vec, n=n, span=span, granule=granule)
        assert heat.mesh_bounds(n, 5, granule) == jax_heat.mesh_bounds(n, 5, granule)
    with pytest.raises(ValueError):
        heat.mesh_bounds(10, 2, 3)
    with pytest.raises(ValueError):
        heat.score_plan("ring:2", [1.0], n=1, span=1, granule=4)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _same_snapshot(got, want):
    for key in ("layout", "rows", "updates", "reads_by_mode", "hot", "sketch", "subtree"):
        assert got[key] == want[key], key
    for key in ("s_hat", "r2"):
        if want["zipf"][key] is None:
            assert got["zipf"][key] is None
        else:
            np.testing.assert_allclose(got["zipf"][key], want["zipf"][key], rtol=1e-12)


def test_tracker_matches_jax_through_a_regrow():
    """Reads under two modes, writes and repair rows into a growing
    fleet (200 → 5,000 objects re-bins the subtrees), published on an
    injected clock: both trackers agree at every step."""
    jclock, pclock = _Clock(), _Clock()
    jt = jax_heat.HeatTracker(capacity=16, halflife_s=5.0, registry=MetricsRegistry(),
                              clock=jclock)
    pt = heat.HeatTracker(capacity=16, halflife_s=5.0, clock=pclock, device="cpu")
    rng = np.random.RandomState(9)
    n = 200
    for step in range(40):
        if step == 20:
            n = 5000
        ids = np.minimum(rng.zipf(1.2, rng.randint(1, 300)) - 1, n - 1)
        which = step % 3
        for trk in (jt, pt):
            if which == 0:
                trk.record_reads(ids, n, mode="frontier" if step % 6 == 0 else "eventual")
            elif which == 1:
                trk.record_writes(ids, n)
            else:
                trk.record_repair(ids, n)
        if step % 4 == 3:
            jclock.t += 1.5 + step
            pclock.t = jclock.t
            jt.publish()
            pt.publish()
            for cls in heat.CLASSES:
                np.testing.assert_allclose(pt._ewma[cls], jt._ewma[cls], rtol=1e-12)
            _same_snapshot(pt.snapshot(), jt.snapshot())
        assert pt.hot(5) == jt.hot(5)
    np.testing.assert_array_equal(pt.heat_vector(), jt.heat_vector())
    for spec in ("mesh:4", "ring:3,k=2"):
        assert pt.plan_report(spec) == jt.plan_report(spec)
    assert pt.plan_report("mesh:2", granule=4096) == jt.plan_report("mesh:2", granule=4096)
    pt.record_reads([], 10)
    pt.record_reads([1], 0)
    assert pt.snapshot()["updates"] == 40
    pt.reset()
    jt.reset()
    _same_snapshot(pt.snapshot(), jt.snapshot())
    assert pt.heat_vector().shape == (0,)


def test_default_tracker_wants_the_card(monkeypatch):
    from crdt_tpu_torch import DeviceUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        heat.HeatTracker()
