"""Parity of the port's ``WorkloadGen`` (``crdt_tpu_torch.utils.workload``)
with the JAX package's: the same seed gives the same keys, read flags,
hot-object members and sampled rows, draw by draw."""

import numpy as np
import pytest
import torch

from crdt_tpu.utils.workload import WorkloadGen as JaxWorkloadGen
from crdt_tpu_torch.utils.workload import WorkloadGen

torch.set_num_threads(1)

SHAPES = {
    "uniform": dict(),
    "zipf_burst_mixed": dict(zipf_s=1.1, burst_len=4, read_frac=0.5),
    "zipf_permuted": dict(zipf_s=1.2, burst_len=3, permute_ranks=True, read_frac=0.25),
}


@pytest.mark.parametrize("seed", [0, 7, 29])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_draws_match_jax(seed, shape):
    kw = SHAPES[shape]
    got, want = WorkloadGen(5000, seed=seed, **kw), JaxWorkloadGen(5000, seed=seed, **kw)
    for count in (1, 37, 300, 2):  # bursts carry across calls
        np.testing.assert_array_equal(got.draw(count), want.draw(count))
    for count in (64, 513):
        (gk, gr), (wk, wr) = got.draw_mixed(count), want.draw_mixed(count)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gr, wr)
    for count in (3, 5):
        (go, gm), (wo, wm) = got.hot_object_members(count), want.hot_object_members(count)
        assert go == wo
        np.testing.assert_array_equal(gm, wm)
    for k in (0, 17, 6000):
        np.testing.assert_array_equal(got.sample_rows(k), want.sample_rows(k))


@pytest.mark.parametrize("kw", [dict(n_objects=0), dict(n_objects=4, zipf_s=-1.0),
                                dict(n_objects=4, burst_len=0),
                                dict(n_objects=4, read_frac=1.5)])
def test_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        JaxWorkloadGen(**kw)
    with pytest.raises(ValueError):
        WorkloadGen(**kw)
