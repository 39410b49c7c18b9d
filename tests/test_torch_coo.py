"""Parity of the port's COO route with the JAX package: ``from_coo`` by
both routes, ``_cells`` and ``to_coo``, ``from_scalar``/``from_wire``
with ``via_device`` and ``to_scalar`` by both routes — on the CPU, at
small sizes, with exact equality (planes bit for bit, columns value for
value in row-major order).  The JAX oracle stays on its pure-Python and
jnp paths: it never reaches ``crdt_tpu.native``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.scalar.orswot import Orswot as JaxOrswot
from crdt_tpu.scalar.vclock import VClock as JaxVClock
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import to_binary as jax_to_binary
from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.utils.serde import to_binary as port_to_binary
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets, random_orswot_arrays

torch.set_num_threads(1)
engine.set_threads(1)

CAPS = dict(num_actors=16, member_capacity=8, deferred_capacity=2)
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")


def _universes(bits):
    kw = {**CAPS, "counter_bits": bits}
    return JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))


def _planes(seed, bits, n=20):
    dt = np.uint32 if bits == 32 else np.uint64
    rng = np.random.RandomState(seed)
    fleets = anti_entropy_fleets(rng, n, CAPS["num_actors"], CAPS["member_capacity"],
                                 CAPS["deferred_capacity"], 2, base=4, novel=1,
                                 deferred_frac=0.4, dtype=dt)
    rand = random_orswot_arrays(rng, n, CAPS["num_actors"], CAPS["member_capacity"],
                                CAPS["deferred_capacity"], dtype=dt, max_counter=2**31,
                                deferred_frac=0.5)
    planes = [np.concatenate([f[k] for f in fleets] + [rand[k]]) for k in range(5)]
    planes[0][3] = 0  # an object with no dots at all
    planes[1][3], planes[2][3] = -1, 0
    if bits == 64:  # counters past 2^32
        planes[2][5] += np.where(planes[2][5] > 0, dt(1) << dt(40), dt(0))
        planes[0][5] = planes[2][5].max(axis=0)
    return tuple(planes)


def _jax_batch(planes):
    return JaxOrswotBatch(*(jnp.asarray(x) for x in planes))


def _jax_np(batch):
    return tuple(np.asarray(getattr(batch, k)) for k in PLANES)


def _assert_planes(got, want):
    for name, g, w in zip(PLANES, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_cols(got, want):
    assert len(got) == len(want)
    for bundle_g, bundle_w in zip(got, want):
        assert len(bundle_g) == len(bundle_w)
        for g, w in zip(bundle_g, bundle_w):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _jax_states(planes):
    """JAX scalar Orswots of dense unsigned planes, built directly."""
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


def _coo_kwargs(coo):
    clock, dots, q, h = coo
    kw = {"clock_coords": clock, "dot_coords": dots}
    if len(q[0]):
        kw.update(deferred_members=q, deferred_coords=h)
    return kw


@pytest.mark.parametrize("via_device", [False, True])
@pytest.mark.parametrize("bits", [32, 64])
def test_from_coo_matches_jax(bits, via_device):
    """Both routes of the port give the JAX planes, on one fleet's export
    and on two overlapping exports whose counter cells join by max."""
    juni, tuni = _universes(bits)
    n = 40
    coo_a = _jax_batch(_planes(1, bits, n=n // 3)).to_coo(via_device=False)
    reps = anti_entropy_fleets(np.random.RandomState(2), n, CAPS["num_actors"],
                               CAPS["member_capacity"], CAPS["deferred_capacity"], 2, base=4,
                               novel=1, deferred_frac=0.4,
                               dtype=np.uint32 if bits == 32 else np.uint64)
    r0, r1 = (_jax_batch(r).to_coo(via_device=False) for r in reps)
    joined = tuple(tuple(np.concatenate([x, y]) for x, y in zip(b0, b1))
                   for b0, b1 in zip(r0[:2], r1[:2])) + r0[2:]
    for coo in (coo_a, joined):
        want = JaxOrswotBatch.from_coo(n, juni, via_device=via_device, **_coo_kwargs(coo))
        got = OrswotBatch.from_coo(n, tuni, via_device=via_device, device="cpu",
                                   **_coo_kwargs(coo))
        _assert_planes(got.to_numpy(), _jax_np(want))


def test_from_coo_without_deferred_and_empty():
    juni, tuni = _universes(32)
    planes = _planes(3, 32)
    n = planes[0].shape[0]
    coo = _jax_batch(planes).to_coo(via_device=False)
    for via_device in (False, True):
        want = JaxOrswotBatch.from_coo(n, juni, clock_coords=coo[0], dot_coords=coo[1],
                                       via_device=via_device)
        got = OrswotBatch.from_coo(n, tuni, clock_coords=coo[0], dot_coords=coo[1],
                                   via_device=via_device, device="cpu")
        _assert_planes(got.to_numpy(), _jax_np(want))
        e = np.zeros(0, np.int64)
        want = JaxOrswotBatch.from_coo(5, juni, clock_coords=(e, e, e), dot_coords=(e, e, e, e),
                                       via_device=via_device)
        got = OrswotBatch.from_coo(5, tuni, clock_coords=(e, e, e), dot_coords=(e, e, e, e),
                                   via_device=via_device, device="cpu")
        _assert_planes(got.to_numpy(), _jax_np(want))


def _bad_inputs():
    z = np.zeros(1, np.int64)
    dots = (np.zeros(3, np.int64), np.asarray([1, 2, 3]), np.zeros(3, np.int64), np.ones(3))
    clock = (z, z, np.ones(1))
    return {
        "negative member": dict(clock_coords=clock, dot_coords=(z, -z - 1, z, np.ones(1))),
        "member overflow": dict(clock_coords=clock, dot_coords=(
            np.zeros(9, np.int64), np.arange(9), np.zeros(9, np.int64), np.ones(9))),
        "row out of range": dict(clock_coords=clock, dot_coords=dots,
                                 deferred_members=(z, z + 2, z), deferred_coords=(z, z, z, z + 1)),
        "half a pair": dict(clock_coords=clock, dot_coords=dots, deferred_members=(z, z, z)),
        "conflict": dict(clock_coords=clock, dot_coords=dots,
                         deferred_members=(np.zeros(2, np.int64), np.zeros(2, np.int64),
                                           np.asarray([1, 2])),
                         deferred_coords=(z, z, z, z + 1)),
        "negative deferred member": dict(clock_coords=clock, dot_coords=dots,
                                         deferred_members=(z, z, z - 1),
                                         deferred_coords=(z, z, z, z + 1)),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_from_coo_rejects_like_jax(case):
    juni, tuni = _universes(32)
    kw = _bad_inputs()[case]
    for via_device in (False, True):
        with pytest.raises(ValueError) as want:
            JaxOrswotBatch.from_coo(4, juni, via_device=via_device, **kw)
        with pytest.raises(ValueError) as got:
            OrswotBatch.from_coo(4, tuni, via_device=via_device, device="cpu", **kw)
        assert type(got.value) is type(want.value)
        assert str(got.value).split(" ")[:3] == str(want.value).split(" ")[:3]


@pytest.mark.parametrize("via_device", [False, True])
@pytest.mark.parametrize("bits", [32, 64])
def test_cells_and_to_coo_match_jax(bits, via_device):
    planes = _planes(4, bits)
    jb = _jax_batch(planes)
    tb = OrswotBatch.from_numpy(*planes, device="cpu")
    for want_entries in (True, False):
        _assert_cols(tb._cells(via_device, want_entries=want_entries),
                     jb._cells(via_device, want_entries=want_entries))
    _assert_cols(tb.to_coo(via_device), jb.to_coo(via_device))


@pytest.mark.parametrize("via_device", [False, True])
@pytest.mark.parametrize("bits", [32, 64])
def test_from_scalar_matches_jax(bits, via_device):
    """Both routes keep each state's entry order, as the JAX ones do."""
    juni, tuni = _universes(bits)
    states = _jax_states(_planes(5, bits))
    rng = np.random.RandomState(5)
    for s in states[::3]:  # entries out of id order
        items = list(s.entries.items())
        rng.shuffle(items)
        s.entries = dict(items)
    want = JaxOrswotBatch.from_scalar(states, juni, via_device=via_device)
    got = OrswotBatch.from_scalar(states, tuni, device="cpu", via_device=via_device)
    _assert_planes(got.to_numpy(), _jax_np(want))


@pytest.mark.parametrize("bits", [32, 64])
def test_from_wire_via_device_is_the_jax_route(bits):
    """``from_wire(via_device=True)`` gives what the JAX ``from_wire`` gives
    on an accelerator: the parsed planes through ``to_coo`` and
    ``from_coo(via_device=True)``, member slots in ascending-id order."""
    juni, tuni = _universes(bits)
    blobs = [jax_to_binary(s) for s in _jax_states(_planes(6, bits))]
    from crdt_tpu.utils.serde import from_binary as jax_from_binary

    dense = JaxOrswotBatch.from_scalar([jax_from_binary(b) for b in blobs], juni,
                                       via_device=False)
    want = JaxOrswotBatch.from_coo(len(blobs), juni, via_device=True,
                                   **_coo_kwargs(dense.to_coo(via_device=False)))
    got = OrswotBatch.from_wire(blobs, tuni, device="cpu", via_device=True)
    _assert_planes(got.to_numpy(), _jax_np(want))
    ids = got.ids.numpy()
    keyed = np.where(ids == -1, np.iinfo(np.int32).max, ids)
    assert (np.sort(keyed, axis=1) == keyed).all()
    # the dense route keeps wire order, and both encode to the same bytes
    dense_port = OrswotBatch.from_wire(blobs, tuni, device="cpu", via_device=False)
    _assert_planes(dense_port.to_numpy(), _jax_np(dense))
    assert got.to_wire(tuni) == dense_port.to_wire(tuni) == blobs


@pytest.mark.parametrize("bits", [32, 64])
def test_to_scalar_routes_agree_with_the_jax_states(bits):
    _, tuni = _universes(bits)
    planes = _planes(7, bits)
    states = _jax_states(planes)
    batch = OrswotBatch.from_numpy(*planes, device="cpu")
    want = [jax_to_binary(s) for s in states]
    for via_device in (False, True):
        got = batch.to_scalar(tuni, via_device=via_device)
        assert [port_to_binary(s) for s in got] == want
