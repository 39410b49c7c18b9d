"""The port's CUDA kernels on the card, each against its plain PyTorch
version (bit for bit, overflow flags included).  Needs an NVIDIA card
and ``nvcc``; skips without a card.  Imports nothing of JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from crdt_tpu_torch import KernelError, _build
from crdt_tpu_torch.dtypes import bias_np
from crdt_tpu_torch.ops import orswot_fold_aligned as fa, orswot_tile as tile
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets, random_orswot_arrays

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _to(planes, dev):
    return tuple(
        torch.from_numpy(np.ascontiguousarray(bias_np(x) if i in (0, 2, 4) else x)).to(dev)
        for i, x in enumerate(planes)
    )


def _fleets(seed, n, a, m, d, r, dev, **kw):
    reps = anti_entropy_fleets(np.random.RandomState(seed), n, a, m, d, r, **kw)
    return _to(tuple(np.stack([rep[k] for rep in reps]) for k in range(5)), dev)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,a,m,d,m_cap,d_cap", [
    (37, 64, 16, 2, 16, 2), (5, 33, 8, 3, 4, 1), (129, 8, 64, 2, 64, 2),
])
def test_merge_kernel_matches_plain(dev, n, a, m, d, m_cap, d_cap):
    rng = np.random.RandomState(n)
    sa = _to(random_orswot_arrays(rng, n, a, m, d, max_counter=6, deferred_frac=0.6), dev)
    sb = _to(random_orswot_arrays(rng, n, a, m, d, max_counter=6, deferred_frac=0.6), dev)
    before = _build.launch_counts()["orswot_merge"]
    got = tile.merge(*sa, *sb, m_cap, d_cap, prebiased=True)
    assert _build.launch_counts()["orswot_merge"] == before + 1
    _equal(got, tile.merge_reference(*sa, *sb, m_cap, d_cap))


@pytest.mark.parametrize("u_cap", [None, 16, 8])
def test_fold_kernels_match_plain(dev, u_cap):
    st = _fleets(3, 67, 64, 16, 2, 8, dev, base=6, novel=1, deferred_frac=0.5)
    _equal(fa.fold_merge(*st, 16, 2, u_cap=u_cap, prebiased=True),
           fa.fold_merge_reference(*st, 16, 2, u_cap=u_cap))
    _equal(tile.fold_merge(*st, 16, 2, prebiased=True), tile.fold_merge_reference(*st, 16, 2))


def test_fold_kernels_without_plunger_and_single_replica(dev):
    st = _fleets(4, 9, 8, 6, 2, 3, dev, base=3, novel=1, deferred_frac=0.5)
    for sub in (st, tuple(x[:1].contiguous() for x in st)):
        for plunger in (True, False):
            _equal(fa.fold_merge(*sub, 6, 2, plunger=plunger, prebiased=True),
                   fa.fold_merge_reference(*sub, 6, 2, plunger=plunger))
            _equal(tile.fold_merge(*sub, 6, 2, plunger=plunger, prebiased=True),
                   tile.fold_merge_reference(*sub, 6, 2, plunger=plunger))


def _shifted(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary, so the kernels must stage it by per-lane cp.async."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# id: (seed, n, a, m, d, r, fleet kwargs, u_cap, shifted, expected plan)
K1_ROUTES = {
    "regs16_bulk": (3, 67, 64, 16, 2, 8, dict(base=6, novel=1), 16, False, (16, 2, True, "match")),
    "regs16_words": (4, 67, 64, 16, 2, 8, dict(base=6, novel=1), 16, True, (16, 2, False, "match")),
    "wide_u32_bulk": (5, 45, 64, 32, 2, 4, dict(base=20, novel=3), 32, False, (0, 0, True, "loop")),
    "wide_u32_words": (6, 45, 64, 32, 2, 4, dict(base=20, novel=3), 32, True, (0, 0, False, "loop")),
    "a32_bulk": (7, 33, 32, 8, 2, 4, dict(base=4, novel=1), 16, False, (0, 0, True, "loop")),
    "smem_words_odd": (8, 29, 37, 5, 3, 3, dict(base=2, novel=1), None, False,
                       (0, 0, False, "loop")),
    "smem_bulk": (9, 29, 8, 8, 2, 3, dict(base=4, novel=1), 48, False, (0, 0, True, "loop")),
    "fewer_objects_than_warps": (10, 3, 64, 16, 2, 8, dict(base=6, novel=1), 16, False,
                                 (16, 2, True, "match")),
    # register accumulator with more member rows than the one-match map takes
    "regs16_m32_bulk": (20, 45, 64, 32, 2, 4, dict(base=8, novel=2), 16, False,
                        (16, 2, True, "loop")),
    "regs16_m32_words": (21, 45, 64, 32, 2, 4, dict(base=8, novel=2), 16, True,
                         (16, 2, False, "loop")),
}


@pytest.mark.parametrize("case", list(K1_ROUTES.values()), ids=list(K1_ROUTES))
def test_fold_aligned_routes_match_plain(dev, case):
    seed, n, a, m, d, r, kw, u_cap, shifted, want_plan = case
    st = _fleets(seed, n, a, m, d, r, dev, deferred_frac=0.5, **kw)
    if shifted:
        st = tuple(_shifted(x) for x in st)
    u = 2 * m if u_cap is None else u_cap
    plan = fa.fold_plan(st, d, u)
    assert (plan["union_slots"], plan["actors_per_lane"], plan["bulk"], plan["align"]) == want_plan
    for plunger in (True, False):
        _equal(fa.fold_merge(*st, m, d, u_cap=u_cap, plunger=plunger, prebiased=True),
               fa.fold_merge_reference(*st, m, d, u_cap=u_cap, plunger=plunger))


def test_fold_aligned_ragged_view_matches_plain(dev):
    """Replicas 1..R of an [R+1, N, ...] stack at a ragged N: every plane
    but d_ids starts 16-byte aligned, d_ids only 8-byte aligned."""
    st = _fleets(11, 4099, 64, 16, 2, 9, dev, base=6, novel=1, deferred_frac=0.5)
    view = tuple(x[1:] for x in st)
    assert view[3].data_ptr() % 16 == 8
    assert fa.fold_plan(view, 2, 16)["bulk"]
    _equal(fa.fold_merge(*view, 16, 2, u_cap=16, prebiased=True),
           fa.fold_merge_reference(*view, 16, 2, u_cap=16))


@pytest.mark.parametrize("m,r,base,novel", [(16, 8, 6, 1), (32, 4, 8, 2)], ids=["m16", "m32"])
@pytest.mark.parametrize("shifted", [False, True], ids=["bulk", "words"])
def test_fold_aligned_duplicate_ids_in_a_replica_match_plain(dev, m, r, base, novel, shifted):
    """One replica holds an id in two rows (invalid state): the alignment
    joins the rows by max, as the plain version's gather does — in the
    stage the copy engine refills next, on both copy routes."""
    st = [x.clone() for x in _fleets(19, 67, 64, m, 2, r, dev, base=base, novel=novel,
                                      deferred_frac=0.5)]
    st[1][3, ::2, 1] = st[1][3, ::2, 0]
    if shifted:
        st = [_shifted(x) for x in st]
    assert fa.fold_plan(st, 2, 16) == {"union_slots": 16, "actors_per_lane": 2,
                                       "bulk": not shifted, "align": "match" if m == 16 else "loop"}
    _equal(fa.fold_merge(*st, m, 2, u_cap=16, prebiased=True),
           fa.fold_merge_reference(*st, m, 2, u_cap=16))


# id: (seed, n, a, m, d, m_cap, d_cap, shifted, expected plan)
K2_ROUTES = {
    "a64_bulk": (12, 67, 64, 16, 2, 16, 2, False, (2, "bulk", "match")),
    "a64_words": (13, 67, 64, 16, 2, 16, 2, True, (2, "words", "match")),
    "wide_m32": (14, 45, 64, 32, 2, 32, 2, False, (2, "bulk", "loop")),
    "wide_m32_words": (24, 45, 64, 32, 2, 32, 2, True, (2, "words", "loop")),
    "odd_words": (15, 29, 37, 5, 3, 5, 3, False, (0, "words", "match")),
    "odd_words_m20": (25, 29, 37, 20, 3, 20, 3, False, (0, "words", "loop")),
    "runtime_a_bulk": (16, 29, 8, 8, 2, 8, 2, False, (0, "bulk", "match")),
    "runtime_a_bulk_m20": (26, 29, 36, 20, 2, 20, 2, False, (0, "bulk", "loop")),
    "fewer_objects_than_warps": (17, 3, 64, 16, 2, 16, 2, False, (2, "bulk", "match")),
    # two stages of A=256, M=64 exceed the card's shared memory per block
    "wide_a_direct": (22, 67, 256, 64, 2, 64, 2, False, (0, "direct", "loop")),
    "wide_a_direct_unaligned": (23, 29, 256, 64, 2, 64, 2, True, (0, "direct", "loop")),
}


@pytest.mark.parametrize("case", list(K2_ROUTES.values()), ids=list(K2_ROUTES))
def test_merge_routes_match_plain(dev, case):
    seed, n, a, m, d, m_cap, d_cap, shifted, want_plan = case
    rng = np.random.RandomState(seed)
    sa = _to(random_orswot_arrays(rng, n, a, m, d, max_counter=6, deferred_frac=0.6), dev)
    sb = _to(random_orswot_arrays(rng, n, a, m, d, max_counter=6, deferred_frac=0.6), dev)
    if shifted:
        sa, sb = tuple(_shifted(x) for x in sa), tuple(_shifted(x) for x in sb)
    plan = tile.merge_plan(sa, sb, m_cap)
    assert (plan["actors_per_lane"], plan["route"], plan["align"]) == want_plan
    _equal(tile.merge(*sa, *sb, m_cap, d_cap, prebiased=True),
           tile.merge_reference(*sa, *sb, m_cap, d_cap))


def test_merge_duplicate_live_ids_match_plain(dev):
    """Two live slots of one side with one id (invalid state): the
    kernel's slow path sums their ids + 1 and maxes their rows, as the
    plain version's one-hot selection does."""
    rng = np.random.RandomState(18)
    a_np = random_orswot_arrays(rng, 37, 64, 16, 2, max_counter=6, min_live=4)
    b_np = random_orswot_arrays(rng, 37, 64, 16, 2, max_counter=6, min_live=4)
    ids = a_np[1].copy()
    ids[::2, 1] = ids[::2, 0]
    sa, sb = _to((a_np[0], ids) + a_np[2:], dev), _to(b_np, dev)
    _equal(tile.merge(*sa, *sb, 16, 2, prebiased=True), tile.merge_reference(*sa, *sb, 16, 2))


# id: (seed, n, a, m, d, r, fleet kwargs, m_cap, d_cap, view, expected plan);
# view: "shifted" (every plane 4 bytes past a 16-byte boundary), "ragged"
# (replicas 1..R of an [R+1, N, ...] stack: d_ids only 8-byte aligned),
# "dup" (a replica holding one id in two rows), or None; no fleet kwargs:
# R independent random states (several deferred rows ahead per object)
K3_ROUTES = {
    "north_star_bulk": (30, 67, 64, 16, 2, 8, dict(base=6, novel=1), 16, 2, None,
                        (2, "bulk", "match")),
    "north_star_words": (31, 67, 64, 16, 2, 8, dict(base=6, novel=1), 16, 2, "shifted",
                         (2, "words", "match")),
    "ragged_view": (32, 4099, 64, 16, 2, 8, dict(base=6, novel=1), 16, 2, "ragged",
                    (2, "bulk", "match")),
    "n3": (33, 3, 64, 16, 2, 8, dict(base=6, novel=1), 16, 2, None, (2, "bulk", "match")),
    "odd_words": (34, 29, 37, 5, 3, 3, dict(base=2, novel=1), 5, 3, None,
                  (0, "words", "match")),
    "m8_into_m16": (35, 45, 64, 8, 2, 3, dict(base=4, novel=1), 16, 3, None,
                    (2, "bulk", "match")),
    "r1": (36, 45, 64, 16, 2, 1, dict(base=6, novel=1), 16, 2, None, (2, "bulk", "match")),
    "dup_ids_bulk": (37, 67, 64, 16, 2, 8, dict(base=6, novel=1), 16, 2, "dup",
                     (2, "bulk", "match")),
    "overflow": (38, 67, 64, 16, 2, 3, None, 4, 1, None, (2, "bulk", "match")),
    "wide_m32_bulk": (39, 45, 64, 32, 2, 4, dict(base=20, novel=3), 32, 2, None,
                      (2, "bulk", "loop")),
    "wide_m32_words": (40, 45, 64, 32, 2, 4, dict(base=20, novel=3), 32, 2, "shifted",
                       (2, "words", "loop")),
    "runtime_a_bulk": (41, 29, 36, 8, 2, 3, dict(base=4, novel=1), 8, 2, None,
                       (0, "bulk", "match")),
    "runtime_a_words_m20": (42, 29, 37, 20, 3, 3, dict(base=8, novel=2), 20, 3, None,
                            (0, "words", "loop")),
    "runtime_a_bulk_m20": (43, 29, 36, 20, 2, 3, dict(base=8, novel=2), 20, 2, None,
                           (0, "bulk", "loop")),
    # the footprint of A=256, M=64 exceeds the card's shared memory per block
    "wide_a_direct": (44, 67, 256, 64, 2, 3, dict(base=24, novel=4), 64, 2, None,
                      (0, "direct", "loop")),
}


@pytest.mark.parametrize("case", list(K3_ROUTES.values()), ids=list(K3_ROUTES))
def test_fold_routes_match_plain(dev, case):
    seed, n, a, m, d, r, kw, m_cap, d_cap, view, want_plan = case
    if kw is None:
        rng = np.random.RandomState(seed)
        reps = [random_orswot_arrays(rng, n, a, m, d, max_counter=6, deferred_frac=0.6)
                for _ in range(r)]
        st = _to(tuple(np.stack([rep[k] for rep in reps]) for k in range(5)), dev)
    else:
        st = _fleets(seed, n, a, m, d, r + (view == "ragged"), dev, deferred_frac=0.5, **kw)
    if view == "shifted":
        st = tuple(_shifted(x) for x in st)
    elif view == "ragged":
        st = tuple(x[1:] for x in st)
        assert st[3].data_ptr() % 16 == 8
    elif view == "dup":
        st = [x.clone() for x in st]
        st[1][3, ::2, 1] = st[1][3, ::2, 0]
    plan = tile.fold_merge_plan(st, m_cap, d_cap)
    assert (plan["actors_per_lane"], plan["route"], plan["align"]) == want_plan
    before = _build.launch_counts()["orswot_fold"]
    for plunger in (True, False):
        if r == 1 and not plunger and (m, d) != (m_cap, d_cap):
            continue
        got = tile.fold_merge(*st, m_cap, d_cap, plunger=plunger, prebiased=True)
        _equal(got, tile.fold_merge_reference(*st, m_cap, d_cap, plunger=plunger))
        if kw is None:  # forced member and deferred overflow
            assert bool(got[5].any(0).all())
    assert _build.launch_counts()["orswot_fold"] > before


def test_wrapper_refuses_non_contiguous_planes(dev):
    st = _fleets(5, 8, 8, 6, 2, 2, dev, base=3, novel=1)
    every_other = [tuple(x[r][::2] for x in st) for r in range(2)]
    with pytest.raises(ValueError, match="contiguous"):
        tile.merge(*every_other[0], *every_other[1], 6, 2, prebiased=True)


def test_build_failure_raises(dev, monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "/nonexistent/nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "missing-nvcc-probe")
    with pytest.raises(KernelError, match="nvcc"):
        _build.build_all(["orswot_merge"])


def test_wire_loop_on_the_card_equals_the_loop_on_the_cpu(dev):
    """PipelinedWireLoop on the card (parse thread, copy stream, K2, D2H,
    encode) gives the same blobs as on the CPU (merge_reference), over
    two rounds through one instance, overlapped and serial."""
    from crdt_tpu_torch import CrdtConfig, OrswotBatch, PipelinedWireLoop, Universe

    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=64, member_capacity=16,
                                                   deferred_capacity=2))
    rounds = []
    for seed in (21, 22):
        reps = anti_entropy_fleets(np.random.RandomState(seed), 517, 64, 16, 2, 5, base=6,
                                   novel=1, deferred_frac=0.25)
        rounds.append([OrswotBatch.from_numpy(*r, device="cpu").to_wire(uni) for r in reps])
    want = PipelinedWireLoop(uni, device="cpu").run(rounds)["out_blobs"]
    loop = PipelinedWireLoop(uni, device=dev)
    for overlap in (True, False):
        before = _build.launch_counts()["orswot_merge"]
        res = loop.run(rounds, overlap=overlap)
        assert _build.launch_counts()["orswot_merge"] - before == 2 * 5
        assert res["fold_path"] == "k2"
        assert res["ingest_native_fraction"] == res["egress_native_fraction"] == 1.0
        assert res["out_blobs"] == want


@pytest.mark.parametrize("overlap", [True, False])
def test_wire_loop_overflow_on_the_card_raises_and_the_loop_recovers(dev, overlap):
    """Two replicas of M members each outgrow the member capacity: the
    overflow flags ORed on the card raise ``CapacityOverflowError`` at the
    round's check, and the same loop then folds good fleets as the loop
    on the CPU does (the cut-short round's merges ended before the next
    run copies into the device twins)."""
    from crdt_tpu_torch import (
        CapacityOverflowError, CrdtConfig, OrswotBatch, PipelinedWireLoop, Universe,
    )
    from crdt_tpu_torch.scalar.orswot import Orswot
    from crdt_tpu_torch.utils.serde import to_binary

    m = 8
    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=16, member_capacity=m,
                                                   deferred_capacity=2))
    bad = []
    for r in range(2):
        s = Orswot()
        for k in range(m):
            s.apply(s.add(100 * r + k, s.value().derive_add_ctx(r)))
        bad.append([to_binary(s)] * 1500)
    reps = anti_entropy_fleets(np.random.RandomState(23), 1500, 16, m, 2, 3, base=4, novel=1,
                               deferred_frac=0.25)
    good = [OrswotBatch.from_numpy(*r, device="cpu").to_wire(uni) for r in reps]
    want = PipelinedWireLoop(uni, device="cpu").run([good])["out_blobs"]
    loop = PipelinedWireLoop(uni, device=dev)
    assert loop.fold_path == "k2"
    with pytest.raises(CapacityOverflowError, match="member_capacity"):
        loop.run([bad, good], overlap=overlap)
    assert loop.run([good], overlap=overlap)["out_blobs"] == want


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_scatter_max_on_the_card_is_the_lattice_join(dev, dtype):
    """``scatter_reduce_(..., "amax")`` on biased planes over the full
    counter range, duplicate indices included, equals the unsigned max
    (the lattice join) and the same scatter on the CPU."""
    from crdt_tpu_torch.dtypes import zero_of
    from crdt_tpu_torch.oplog.apply import _scatter_max

    rng = np.random.RandomState(41)
    info = torch.iinfo(dtype)
    np_dt = np.int32 if dtype == torch.int32 else np.int64
    plane = torch.from_numpy(rng.randint(info.min, info.max, size=(257, 16, 8), dtype=np_dt))
    lin = torch.from_numpy(rng.randint(0, plane.numel(), size=5000))
    vals = torch.from_numpy(rng.randint(info.min, info.max, size=5000, dtype=np_dt))
    vals[:100] = zero_of(dtype)
    got = _scatter_max(plane.to(dev), lin.to(dev), vals.to(dev)).cpu()
    assert torch.equal(got, _scatter_max(plane, lin, vals))
    unsigned = np.uint32 if dtype == torch.int32 else np.uint64
    want = (plane.numpy() ^ np_dt(info.min)).view(unsigned).reshape(-1).copy()
    np.maximum.at(want, lin.numpy(), (vals.numpy() ^ np_dt(info.min)).view(unsigned))
    assert np.array_equal((got.numpy() ^ np_dt(info.min)).view(unsigned).reshape(-1), want)


@pytest.mark.parametrize("bits", [32, 64])
def test_coo_routes_on_the_card_equal_the_cpu(dev, bits):
    """``from_coo`` by both routes and ``_cells``/``to_scalar`` computed on
    the card equal the same on the CPU."""
    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe

    dt = np.uint32 if bits == 32 else np.uint64
    uni = Universe.identity(CrdtConfig(num_actors=33, member_capacity=8, deferred_capacity=2,
                                       counter_bits=bits))
    planes = random_orswot_arrays(np.random.RandomState(42), 301, 33, 8, 2, dtype=dt,
                                  max_counter=2**31, deferred_frac=0.5)
    cpu = OrswotBatch.from_numpy(*planes, device="cpu")
    clock, dots, q, h = cpu.to_coo(via_device=False)
    names = ("clock", "ids", "dots", "d_ids", "d_clocks")
    want = OrswotBatch.from_coo(301, uni, clock_coords=clock, dot_coords=dots,
                                deferred_members=q, deferred_coords=h, device="cpu")
    for via_device in (True, False):
        got = OrswotBatch.from_coo(301, uni, clock_coords=clock, dot_coords=dots,
                                   deferred_members=q, deferred_coords=h, device=dev,
                                   via_device=via_device)
        for name in names:
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    card = OrswotBatch.from_numpy(*planes, device=dev)
    for b_got, b_want in zip(card._cells(via_device=True), cpu._cells(via_device=True)):
        for g, w in zip(b_got, b_want):
            assert np.array_equal(g, w) and g.dtype == w.dtype
    from crdt_tpu_torch.utils.serde import to_binary

    assert ([to_binary(s) for s in card.to_scalar(uni)]
            == [to_binary(s) for s in cpu.to_scalar(uni, via_device=False)])


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("overlap", [True, False])
def test_op_loop_on_the_card_equals_the_loop_on_the_cpu(dev, bits, overlap):
    """Op frames (adds, removes in several rounds, deferral, a frame
    before its predecessor) folded by ``PipelinedOpLoop`` on the card give
    the planes and counts of the same loop on the CPU."""
    from crdt_tpu_torch import CrdtConfig, OrswotBatch, PipelinedOpLoop, Universe
    from crdt_tpu_torch.oplog import OpBatch, derive_add_ctx, derive_rm_ctx, encode_ops_frame

    dt = np.uint32 if bits == 32 else np.uint64
    uni = Universe.identity(CrdtConfig(num_actors=64, member_capacity=16, deferred_capacity=2,
                                       counter_bits=bits))
    reps = anti_entropy_fleets(np.random.RandomState(43), 999, 64, 16, 2, 1, base=6, novel=1,
                               deferred_frac=0.25, dtype=dt)
    cpu = OrswotBatch.from_numpy(*reps[0], device="cpu")
    cpu = cpu.merge(cpu)
    rng = np.random.RandomState(44)
    clock = cpu.to_numpy()[0].astype(np.uint64)
    # removes go to objects without deferred rows, at most two each, so
    # that deferral stays within D=2
    pool = rng.permutation(np.nonzero((cpu.d_ids == -1).all(dim=1).numpy())[0])
    frames = []
    for f in range(4):
        ops, _ = derive_add_ctx(clock, rng.randint(0, 999, 3000), rng.randint(0, 64, 3000),
                                member=rng.randint(0, 4, 3000), device="cpu")
        np.maximum.at(clock, (ops.obj, ops.actor), ops.counter)
        robj = pool[100 * f:100 * (f + 1)]
        robj = np.concatenate([robj, robj[:10]])
        rms = derive_rm_ctx(clock, robj, rng.randint(0, 4, robj.shape[0]))
        rms.rm_clocks[::7, 3] += 1
        frames.append(encode_ops_frame(OpBatch.concat([ops, rms])))
    frames[1], frames[2] = frames[2], frames[1]
    want, wst = PipelinedOpLoop(uni).run(cpu, frames, overlap=overlap)
    got, gst = PipelinedOpLoop(uni).run(OrswotBatch(*(getattr(cpu, k).to(dev) for k in (
        "clock", "ids", "dots", "d_ids", "d_clocks"))), frames, overlap=overlap)
    for name in ("clock", "ids", "dots", "d_ids", "d_clocks"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    for k in ("ops", "applied", "duplicates", "still_parked"):
        assert gst[k] == wst[k], k


def _flat_pairs(seed, dev):
    """Two replicas of each flat type on the CPU (u64, dense counters),
    with its wire universe and ``from_wire`` arguments."""
    from crdt_tpu_torch import (
        CrdtConfig, GCounterBatch, GSetBatch, LWWRegBatch, MVRegBatch, PNCounterBatch, Universe,
        VClockBatch,
    )

    rng = np.random.RandomState(seed)
    uni = Universe.identity(CrdtConfig(num_actors=16, mv_capacity=4))
    n = 777

    def c(*shape):
        return rng.randint(0, 1000, size=(n, *shape)).astype(np.uint64)

    def mv():
        clocks = c(4, 16) * (np.arange(4) < 2)[None, :, None]
        return clocks, rng.randint(1, 99, size=(n, 4)).astype(np.uint64) * clocks.any(-1)

    return uni, {
        "vclock": (lambda i: VClockBatch.from_numpy(c(16), device="cpu"), ()),
        "gcounter": (lambda i: GCounterBatch.from_numpy(c(16), device="cpu"), ()),
        "pncounter": (lambda i: PNCounterBatch.from_numpy(c(2, 16), device="cpu"), ()),
        # markers unique across the two replicas: no equal-marker conflict
        "lww": (lambda i: LWWRegBatch.from_numpy(rng.randint(0, 99, n).astype(np.uint64),
                                                c() * 2 + np.uint64(i), device="cpu"), ()),
        "gset": (lambda i: GSetBatch.from_numpy(rng.rand(n, 40) < 0.1, device="cpu"), (40,)),
        "mvreg": (lambda i: MVRegBatch.from_numpy(*mv(), device="cpu"), ()),
    }


@pytest.mark.parametrize("kind", ["vclock", "gcounter", "pncounter", "lww", "gset", "mvreg"])
def test_flat_types_on_the_card_equal_the_cpu(dev, kind):
    """Each flat type's merge on the card gives the CPU's planes, and a
    wire round on the card (``to_wire`` → ``from_wire`` → merge →
    ``to_wire``) gives the CPU's bytes."""
    import dataclasses

    uni, types = _flat_pairs(51, dev)
    make, extra = types[kind]
    a, b = make(0), make(1)

    def on(x, d):
        return type(x)(*(getattr(x, f.name).to(d) for f in dataclasses.fields(x)))

    want = a.merge(b)
    got = on(a, dev).merge(on(b, dev))
    for f in dataclasses.fields(want):
        assert getattr(got, f.name).device.type == "cuda"
        assert torch.equal(getattr(got, f.name).cpu(), getattr(want, f.name)), f.name
    cls = type(a)
    blobs = [x.to_wire(uni) for x in (a, b)]
    back = [cls.from_wire(bl, uni, *extra, device=dev) for bl in blobs]
    assert back[0].merge(back[1]).to_wire(uni) == want.to_wire(uni)


@pytest.mark.parametrize("kind", ["mvreg", "orswot", "map"])
@pytest.mark.parametrize("bits", [32, 64])
def test_map_merge_on_the_card_equals_the_cpu(dev, kind, bits):
    """A Map merge (both ways), truncate, ``apply_up`` and ``apply_rm`` on
    the card give the CPU's planes; a 32-bit ``Map<K, Orswot>`` launches
    the merge kernel for its nested sets (a 64-bit one takes ``rank``)."""
    import warnings

    from crdt_tpu_torch import CrdtConfig, MapBatch, MapKernel, MVRegKernel, OrswotKernel, Universe
    from crdt_tpu_torch.batch.map_batch import _leaves
    from crdt_tpu_torch.ops.map_ops import _tree_map
    from crdt_tpu_torch.utils.testdata import random_map

    uni = Universe.identity(CrdtConfig(num_actors=8, member_capacity=16, deferred_capacity=24,
                                       mv_capacity=16, key_capacity=6, counter_bits=bits))
    cfg = uni.config
    vk = {"mvreg": MVRegKernel.from_config(cfg), "orswot": OrswotKernel.from_config(cfg),
          "map": MapKernel.from_config(cfg, MVRegKernel.from_config(cfg))}[kind]
    rng = np.random.RandomState(bits)
    top = 1 << (bits - 1)
    kw = dict(n_keys=6, n_actors=8, counters=(1, 2, 3, top, top + 1))
    base = [random_map(rng, kind, **kw) for _ in range(48)]
    a, b = ([random_map(rng, kind, m=m.clone(), **kw) for m in base] for _ in range(2))
    cpu = [MapBatch.from_scalar(x, uni, vk, device="cpu") for x in (a, b)]
    card = [MapBatch.from_state(_tree_map(lambda t: t.to(dev), x.state), x.kernel) for x in cpu]

    def same(got, want):
        g, w = _leaves(got.state), _leaves(want.state)
        assert len(g) == len(w) and all(torch.equal(x.cpu(), y) for x, y in zip(g, w))

    _build.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 64-bit nested sets take rank, with a warning
        for x, y in ((0, 1), (1, 0)):
            want = cpu[x].merge(cpu[y], check=False)
            got = card[x].merge(card[y], check=False)
            same(got, want)
        t = np.asarray(want.to_numpy()[0]) * (rng.rand(48, 8) < 0.3)
        same(got.truncate(t), want.truncate(t))
        key = rng.randint(0, 7, size=48).astype(np.int32)
        same(card[0].apply_rm(t, key, check=False), cpu[0].apply_rm(t, key, check=False))
    launched = _build.launch_counts()["orswot_merge"]
    assert launched > 0 if (kind, bits) == ("orswot", 32) else launched == 0
    assert got.to_wire(uni) == want.to_wire(uni)


def _sync_pair(dev, bits=32, n=96, seed=61, a=16, m=8, d=2):
    """Two replicas of one plunged fleet on the CPU, each with adds of its
    own on a seeded eighth of the rows, and their universe."""
    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe

    uni = Universe.identity(CrdtConfig(num_actors=a, member_capacity=m, deferred_capacity=d,
                                       counter_bits=bits))
    rng = np.random.RandomState(seed)
    dt = np.uint32 if bits == 32 else np.uint64
    (base,) = anti_entropy_fleets(rng, n, a, m, d, 1, base=4, novel=0, deferred_frac=0.25,
                                  dtype=dt)
    p0 = OrswotBatch.from_numpy(*base, device="cpu")
    p0 = p0.merge(p0)
    out = []
    for actor, member in ((1, 1 << 20), (0, 1 << 21)):
        rows = np.sort(rng.choice(n, n // 8, replace=False))
        sub = OrswotBatch(*(getattr(p0, f)[rows] for f in ("clock", "ids", "dots", "d_ids",
                                                           "d_clocks")))
        nxt = (sub.clock.amax(dim=-1) ^ torch.iinfo(sub.clock.dtype).min) + 1
        sub = sub.apply_add(np.full(len(rows), actor), nxt.numpy().astype(dt),
                            np.full(len(rows), member))
        fleet = OrswotBatch(*(getattr(p0, f).clone() for f in ("clock", "ids", "dots", "d_ids",
                                                               "d_clocks")))
        for f in ("clock", "ids", "dots", "d_ids", "d_clocks"):
            getattr(fleet, f)[rows] = getattr(sub, f)
        out.append((fleet, rows))
    return uni, out


def _on(batch, d):
    import dataclasses

    return dataclasses.replace(batch, **{f.name: getattr(batch, f.name).to(d)
                                         for f in dataclasses.fields(batch)})


@pytest.mark.parametrize("bits", [32, 64])
def test_digest_and_tree_on_the_card_equal_the_cpu(dev, bits):
    """The ORSWOT, counter and LWW digests, the version vector and the
    digest tree computed on the card equal the CPU's, bit for bit."""
    from crdt_tpu_torch import LWWRegBatch, PNCounterBatch
    from crdt_tpu_torch.sync import digest, tree

    uni, ((p, _), (q, _)) = _sync_pair(dev, bits)
    for b in (p, q, p.with_capacity(16, 4)):
        want = digest.digest_of(b, uni)
        np.testing.assert_array_equal(digest.digest_of(_on(b, dev), uni), want)
        np.testing.assert_array_equal(digest.version_vector(_on(b, dev)),
                                      digest.version_vector(b))
        for lv_got, lv_want in zip(tree.build_tree(want, device=dev).levels,
                                   tree.build_tree(want, device="cpu").levels):
            np.testing.assert_array_equal(lv_got, lv_want)
    rng = np.random.RandomState(bits)
    dt = np.uint32 if bits == 32 else np.uint64
    pn = PNCounterBatch.from_numpy(rng.randint(0, 2**31, size=(64, 2, 16)).astype(dt),
                                   device="cpu")
    lww = LWWRegBatch.from_numpy(rng.randint(0, 2**62, size=64).astype(np.uint64),
                                 rng.randint(1, 2**62, size=64).astype(np.uint64), device="cpu")
    for b in (pn, lww):
        np.testing.assert_array_equal(digest.digest_of(_on(b, dev), uni),
                                      digest.digest_of(b, uni))


@pytest.mark.parametrize("widths", ["config", "regrown"])
def test_delta_applier_on_the_card_equals_the_cpu(dev, widths):
    """The delta exchange both ways on the card: the applier launches the
    merge kernel (counted) on the gathered rows, also at widths unequal
    to the peer rows', and gives the CPU's planes; the kernel takes
    unequal member and deferred widths in either order, bit-equal to its
    plain version."""
    from crdt_tpu_torch.sync import delta, digest

    uni, ((p, rp), (q, rq)) = _sync_pair(dev)
    if widths == "regrown":
        p, q = p.with_capacity(16, 8), q.with_capacity(32, 4)
    ids = delta.diverged_indices(digest.digest_of(p, uni), digest.digest_of(q, uni))
    np.testing.assert_array_equal(ids, np.union1d(rp, rq))
    for local, peer in ((p, q), (q, p)):
        blobs = delta.gather_blobs(_on(peer, dev), ids, uni)
        assert blobs == delta.gather_blobs(peer, ids, uni)
        want = delta.OrswotDeltaApplier(uni).apply(local, ids, blobs)
        _build.reset_launch_counts()
        got = delta.OrswotDeltaApplier(uni).apply(_on(local, dev), ids, blobs)
        assert _build.launch_counts()["orswot_merge"] == 1
        for f in ("clock", "ids", "dots", "d_ids", "d_clocks"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    idx = torch.as_tensor(ids, device=dev)
    sa, sb = ([getattr(delta.take_rows(_on(x, dev), idx), f) for f in (
        "clock", "ids", "dots", "d_ids", "d_clocks")] for x in (p, q))
    for x, y in ((sa, sb), (sb, sa)):
        m_cap, d_cap = x[1].shape[-1], x[3].shape[-1]
        _equal(tile.merge(*x, *y, m_cap, d_cap, prebiased=True),
               tile.merge_reference(*x, *y, m_cap, d_cap))


def test_gc_pass_and_truncate_on_the_card_equal_the_cpu(dev, monkeypatch):
    """One ``GcEngine.collect`` (settle in several row chunks over planted
    dominated deferred rows, repack, op-log compaction below the
    watermark) and ``truncate_orswot`` (the merge kernel, counted) on the
    card give the CPU's planes and report."""
    from crdt_tpu_torch import GcEngine, GcPolicy
    from crdt_tpu_torch.gc import compact
    from crdt_tpu_torch.obs.convergence import ConvergenceTracker
    from crdt_tpu_torch.oplog import OpBatch, OpLog
    from crdt_tpu_torch.sync import digest
    from crdt_tpu_torch.utils.testdata import plant_dominated_deferred

    uni, ((p, _), (q, _)) = _sync_pair(dev)
    q = q.with_capacity(32, 8)
    planted = plant_dominated_deferred(q, np.arange(0, q.clock.shape[0], 2), dup=4)
    # seven rows per settle chunk: (M + D) * D * A cells a row
    monkeypatch.setattr(compact, "_SETTLE_CELLS", 7 * (32 + 8) * 8 * 16)
    rng = np.random.RandomState(7)
    b = 512
    ops = OpBatch(kind=np.zeros(b, np.uint8), obj=rng.randint(0, 96, size=b),
                  actor=rng.randint(0, 16, size=b), counter=rng.randint(1, 120, size=b),
                  member=rng.randint(0, 99, size=b))
    results = []
    for d in ("cpu", dev):
        trk = ConvergenceTracker()
        trk.observe_version_vector("p", digest.version_vector(p))
        log = OpLog(uni, capacity=b)
        log.append(ops)
        eng = GcEngine(GcPolicy(interval_rounds=1), tracker=trk)
        results.append(eng.collect(_on(q, d), universe=uni, oplog=log, peers=["p"]) +
                       (log.pending(),))
    (want, wrep, wlog), (got, grep, glog) = results
    for f in ("clock", "ids", "dots", "d_ids", "d_clocks"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert grep.tombstones_cleared >= planted + 4 and grep.members_freed >= planted
    assert (grep.tombstones_cleared, grep.members_freed, grep.member_capacity,
            grep.deferred_capacity,
            grep.reclaimed_bytes, grep.oplog_ops_dropped) == (
        wrep.tombstones_cleared, wrep.members_freed, wrep.member_capacity,
        wrep.deferred_capacity, wrep.reclaimed_bytes, wrep.oplog_ops_dropped)
    np.testing.assert_array_equal(glog.counter, wlog.counter)
    wm = grep.watermark.clock
    _build.reset_launch_counts()
    got_t = compact.truncate_orswot(_on(p, dev), wm)
    assert _build.launch_counts()["orswot_merge"] == 1
    want_t = compact.truncate_orswot(p, wm)
    for f in ("clock", "ids", "dots", "d_ids", "d_clocks"):
        assert torch.equal(getattr(got_t, f).cpu(), getattr(want_t, f)), f


def _read_fleets(dev, seed=70, n=3000, a=16, k=4):
    """One small fleet of each read kind, seeded numpy planes, on ``dev``."""
    from crdt_tpu_torch import (GCounterBatch, LWWRegBatch, MapBatch, MapKernel, MVRegBatch,
                                MVRegKernel, OrswotBatch, PNCounterBatch, CrdtConfig)
    from crdt_tpu_torch.serve import query

    rng = np.random.RandomState(seed)
    top = np.array([0, 1, 7, 2**31, 2**32 - 1], np.uint64)
    planes = random_orswot_arrays(rng, n, a, 8, 2, max_counter=90, deferred_frac=0.3)
    c32 = lambda *s: top[rng.randint(0, 5, s)].astype(np.uint32)  # noqa: E731
    c64 = lambda *s: (top[rng.randint(0, 5, s)] << np.uint64(31)).astype(np.uint64)  # noqa: E731
    cfg = CrdtConfig(num_actors=a, key_capacity=k, deferred_capacity=2, mv_capacity=2)
    keys = np.where(rng.rand(n, k) < 0.7, np.arange(k)[None, :] * 3, -1).astype(np.int32)
    mk = MapKernel.from_config(cfg, MVRegKernel.from_config(cfg))
    mp = MapBatch.from_state(mk.zeros((n,), dev), mk)
    mp.clock.copy_(torch.from_numpy(bias_np(c32(n, a))).to(dev))
    mp.keys.copy_(torch.from_numpy(keys).to(dev))
    mp.entry_clocks.copy_(torch.from_numpy(bias_np(c32(n, k, a))).to(dev))
    return {
        query.K_ORSWOT: OrswotBatch.from_numpy(*planes, device=dev),
        query.K_GCOUNTER: GCounterBatch.from_numpy(c64(n, a), device=dev),
        query.K_PNCOUNTER: PNCounterBatch.from_numpy(c32(n, 2, a), device=dev),
        query.K_LWW: LWWRegBatch.from_numpy(c64(n), c64(n), device=dev),
        query.K_MVREG: MVRegBatch.from_numpy(c32(n, k, a), c32(n, k), device=dev),
        query.K_MAP: mp,
    }, planes[1]


def test_gathers_on_the_card_equal_the_cpu(dev):
    from crdt_tpu_torch.serve import NO_MEMBER, QueryEngine, gather

    on_card, ids = _read_fleets(dev)
    on_cpu, _ = _read_fleets(torch.device("cpu"))
    rng = np.random.RandomState(71)
    obj = rng.randint(0, ids.shape[0], 8192)
    member = ids[obj, rng.randint(0, ids.shape[1], obj.size)]
    member[rng.rand(obj.size) < 0.3] = NO_MEMBER
    for kind in on_card:
        got, want = gather(on_card[kind], obj, member=member), gather(on_cpu[kind], obj,
                                                                      member=member)
        for f in ("val", "add_clock", "rm_clock"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{kind} {f}")
        for name, col in want.extras.items():
            assert got.extras[name].dtype == col.dtype
            np.testing.assert_array_equal(got.extras[name], col, err_msg=f"{kind} {name}")
    kinds = rng.randint(0, 6, obj.size)
    got = QueryEngine(on_card).gather(obj, kinds, member)
    want = QueryEngine(on_cpu).gather(obj, kinds, member)
    np.testing.assert_array_equal(got.rm_clock, want.rm_clock)


def test_sketch_and_folds_on_the_card_equal_the_cpu(dev):
    """Tie-heavy batches through the Space-Saving update (the stable
    sort on CUDA), the heat subtree fold and the frontier fold."""
    from crdt_tpu_torch.obs import heat, stability

    rng = np.random.RandomState(72)
    tables = []
    for d in (dev, torch.device("cpu")):
        z = torch.zeros(32, dtype=torch.int64, device=d)
        tables.append((torch.full_like(z, -1), z, z.clone()))
    for step in range(80):
        ids = np.minimum(rng.zipf(1.1, int(rng.choice([7, 64, 4096]))) - 1, 200).astype(np.int64)
        pad, w = heat._pad_pow2(np.repeat(ids, 2)[: ids.size])
        tables = [heat.sketch_update(*t, torch.from_numpy(pad).to(t[0].device),
                                     torch.from_numpy(w).to(t[0].device)) for t in tables]
        for g, c in zip(*tables):
            assert torch.equal(g.cpu(), c), step
        got = heat.subtree_fold(torch.from_numpy(pad).to(dev), torch.from_numpy(w).to(dev), 13, 16)
        assert torch.equal(got.cpu(), heat.subtree_fold(torch.from_numpy(pad),
                                                        torch.from_numpy(w), 13, 16))
    on_card, _ = _read_fleets(dev, n=70_001)
    on_cpu, _ = _read_fleets(torch.device("cpu"), n=70_001)
    for kind in (0, 1, 2):
        np.testing.assert_array_equal(stability.subtree_version_vectors(on_card[kind]),
                                      stability.subtree_version_vectors(on_cpu[kind]))
    trk = heat.HeatTracker(capacity=16, device=dev)
    cpu = heat.HeatTracker(capacity=16, device="cpu", clock=trk._clock)
    for t in (trk, cpu):
        t.record_reads(np.arange(5000) % 37, 70_001)
        t.record_writes(np.arange(900) % 5, 70_001)
    assert trk.snapshot()["hot"] == cpu.snapshot()["hot"]


def test_audit_launches_the_merge_kernel_and_the_observatory_counts_it(dev, monkeypatch):
    """The auditor's self-merge runs through the merge kernel, bit-equal to
    ``merge_reference``; the observatory times every launch."""
    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
    from crdt_tpu_torch.obs import kernel_observatory, stability

    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=64, member_capacity=16,
                                                   deferred_capacity=2))
    rng = np.random.RandomState(73)
    (planes,) = anti_entropy_fleets(rng, 20_000, 64, 16, 2, 1, base=4, novel=0,
                                    deferred_frac=0.25)
    fleet = OrswotBatch.from_numpy(*planes, device=dev)
    fleet = fleet.merge(fleet)
    seen, real = [], tile.merge

    def capture(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, out))
        return out

    monkeypatch.setattr(tile, "merge", capture)
    obs = kernel_observatory()
    obs.reset()
    _build.reset_launch_counts()
    obs.set_enabled(True)
    try:
        trk = stability.StabilityTracker(seed=5)
        trk.observe_converged("peer", fleet)
        trk.frontier(fleet)
        rep = trk.audit(fleet, uni, sample=2048)
    finally:
        obs.set_enabled(False)
    assert rep.ok and rep.sampled == 2048
    assert _build.launch_counts()["orswot_merge"] >= 1 and seen
    for args, out in seen:
        sa, sb, (m_cap, d_cap) = args[:5], args[5:10], args[10:12]
        _equal(out, tile.merge_reference(*sa, *sb, m_cap, d_cap))
    table = obs.table()
    assert len(seen) == _build.launch_counts()["orswot_merge"]
    assert table["orswot_merge"]["timed"] == _build.launch_counts()["orswot_merge"]
    assert table["orswot_merge"]["device_ms_total"] > 0 and table["orswot_merge"]["bytes"] > 0


class _Windowed:
    def __init__(self, send, recv, window=4):
        self.send, self.recv, self.window = send, recv, window

    def negotiate_window(self, peer_window):
        self.window = min(self.window, int(peer_window))
        return self.window


def _session_run(p, q, uni, mode):
    import threading

    from crdt_tpu_torch.obs import HeatTracker
    from crdt_tpu_torch.sync import session

    kw = dict(digest_tree=mode != "flat")
    sa = session.SyncSession(p, uni, peer="q", heat=HeatTracker(device=p.device), **kw)
    sb = session.SyncSession(q, uni, peer="p", heat=HeatTracker(device=q.device), **kw)
    if mode != "stream":
        ra, rb = session.sync_pair(sa, sb)
    else:
        (send_a, recv_a), (send_b, recv_b) = session.queue_transport()
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "b", sb.sync(_Windowed(send_b, recv_b))), daemon=True)
        t.start()
        ra = sa.sync(_Windowed(send_a, recv_a))
        t.join(timeout=120)
        assert not t.is_alive()
        rb = out["b"]
    return sa.batch, sb.batch, ra, rb


@pytest.mark.parametrize("mode", ["flat", "tree", "stream"])
def test_session_pair_on_the_card_equals_the_cpu(dev, mode):
    """Two sessions on the card (N=4,096, A=64, M=16, D=2) converge to the
    planes the same pair reaches on the CPU, and every diverged apply
    launches the merge kernel."""
    from crdt_tpu_torch.sync import delta

    uni, ((p, _), (q, _)) = _sync_pair(dev, n=4096, a=64, m=16, d=2)
    want = _session_run(p, q, uni, mode)
    _build.reset_launch_counts()
    got = _session_run(_on(p, dev), _on(q, dev), uni, mode)
    launches = _build.launch_counts()["orswot_merge"]
    for g, w in zip(got[:2], want[:2]):
        for f in ("clock", "ids", "dots", "d_ids", "d_clocks"):
            assert getattr(g, f).device.type == "cuda"
            assert torch.equal(getattr(g, f).cpu(), getattr(w, f)), f
    ra, rb = got[2:]
    assert ra.converged and rb.converged and ra.diverged == want[2].diverged > 0
    assert ra.tree_mode == (mode != "flat") and ra.streaming == (mode == "stream")
    applies = 2 * (-(-ra.diverged // delta.DELTA_CHUNK_ROWS) if mode == "stream" else 1)
    assert launches >= applies


def _tcp_session_run(p, q, uni, seed):
    """Two flat sessions over loopback TCP, each end
    ``ResilientTransport(FaultyTransport(TcpTransport))`` with a mixed
    plan; whichever finishes first answers its peer until both are done."""
    import socket
    import threading

    from crdt_tpu_torch.cluster import (
        FaultPlan, FaultyTransport, ResilientTransport, RetryPolicy, TcpTransport, linger,
    )
    from crdt_tpu_torch.obs import HeatTracker
    from crdt_tpu_torch.sync import session

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10.0)
    c = socket.create_connection(srv.getsockname(), timeout=10.0)
    s, _ = srv.accept()
    srv.close()
    policy = RetryPolicy(send_deadline_s=30.0, recv_deadline_s=30.0, ack_timeout_s=0.05,
                         max_backoff_s=0.5, retry_budget=2000)
    ends = [ResilientTransport(FaultyTransport(TcpTransport(x, 30.0), FaultPlan(
        seed=seed + k, drop=0.1, duplicate=0.1, truncate=0.1, delay=0.1)), policy,
        seed=seed + k) for k, x in enumerate((c, s))]
    sessions = [session.SyncSession(b, uni, peer=peer, heat=HeatTracker(device=b.device))
                for b, peer in ((p, "q"), (q, "p"))]
    out, done = {}, [threading.Event(), threading.Event()]

    def run(k):
        try:
            out[k] = sessions[k].sync(ends[k])
        except BaseException as e:  # reported below
            out[k] = e
        done[k].set()
        linger(ends[k], done[1 - k].is_set, 60.0)

    ts = [threading.Thread(target=run, args=(k,), daemon=True) for k in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in ts), "a session over TCP hung"
    for e in ends:
        e.close()
    for k in (0, 1):
        if isinstance(out[k], BaseException):
            raise out[k]
    return sessions[0].batch, sessions[1].batch, out[0], out[1], ends


def test_session_over_tcp_on_the_card_equals_the_cpu(dev, monkeypatch):
    """Two sessions on the card (N=4,096, A=64, M=16, D=2) over loopback
    TCP through the ARQ with faults injected converge to the planes the
    same pair reaches on the CPU, and every merge-kernel launch equals
    ``merge_reference``."""
    uni, ((p, _), (q, _)) = _sync_pair(dev, n=4096, a=64, m=16, d=2)
    want = _tcp_session_run(p, q, uni, seed=90)
    seen, real = [], tile.merge

    def capture(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, out))
        return out

    monkeypatch.setattr(tile, "merge", capture)
    _build.reset_launch_counts()
    got = _tcp_session_run(_on(p, dev), _on(q, dev), uni, seed=95)
    launches = _build.launch_counts()["orswot_merge"]
    for g, w in zip(got[:2], want[:2]):
        for f in ("clock", "ids", "dots", "d_ids", "d_clocks"):
            assert getattr(g, f).device.type == "cuda"
            assert torch.equal(getattr(g, f).cpu(), getattr(w, f)), f
    ra, rb = got[2:4]
    assert ra.converged and rb.converged and ra.diverged == want[2].diverged > 0
    assert ra.streaming and ra.window == 16
    assert launches >= 2 and len(seen) == launches
    for args, out in seen:
        sa, sb, (m_cap, d_cap) = args[:5], args[5:10], args[10:12]
        _equal(out, tile.merge_reference(*sa, *sb, m_cap, d_cap))
    assert sum(e.counts()["retransmits"] + e.counts()["corrupt"] for e in got[4]) > 0


def _gossip_run(p, q, uni):
    """Two ``ClusterNode``s (digest tree on) over queue links, each with a
    ``GossipScheduler``; each node takes writes, then rounds run until
    their digests agree; then one batch of read frames per mode.  Returns
    both batches, the result frames, the rounds and the reports."""
    import threading

    from crdt_tpu_torch.cluster import ClusterNode, GossipScheduler, Membership, queue_pair
    from crdt_tpu_torch.obs import convergence
    from crdt_tpu_torch.serve import ReadRequest, encode_read_request

    nodes = [ClusterNode(name, b, uni, digest_tree=True) for name, b in (("a", p), ("b", q))]

    def dialer(i):
        def dial(peer):
            ta, tb = queue_pair(default_timeout=60.0)
            t = threading.Thread(target=nodes[1 - i].accept, args=(tb, nodes[i].node_id),
                                 daemon=True)
            t.start()
            return ta
        return dial

    scheds = []
    for i, node in enumerate(nodes):
        roster = Membership(tracker=convergence.ConvergenceTracker())
        roster.add(nodes[1 - i].node_id)
        scheds.append(GossipScheduler(node, roster, dialer(i), fanout=1, seed=i,
                                      tracker=convergence.ConvergenceTracker()))
    rng = np.random.RandomState(71)
    n = p.clock.shape[0]
    for i, node in enumerate(nodes):
        node.submit_writes(rng.randint(0, n, 512), rng.randint(200, 216, 512), actor=i + 3)
    reports = []
    for rounds in range(1, 5):
        for s in scheds:
            rep = s.run_round()
            assert not rep.failed, rep.failed
            reports += list(rep.reports.values())
        if np.array_equal(nodes[0].digest(), nodes[1].digest()):
            break
    obj = rng.randint(0, n, 256)
    member = np.where(rng.rand(256) < 0.25, -1, rng.randint(200, 216, 256)).astype(np.int32)
    frames = []
    for node in nodes:
        reqs = [ReadRequest.reads(obj, member=member),
                ReadRequest.reads(obj, member=member, mode="ryw", require=node.write_vv()),
                ReadRequest.reads(obj, member=member, mode="monotonic",
                                  require=node.read_token())]
        out, stats = node.serve_loop().serve_frames([encode_read_request(r) for r in reqs])
        assert stats["rejected"] == 0
        frames.append(out)
    return [node.batch for node in nodes], frames, rounds, reports


def test_gossip_on_the_card_equals_the_cpu(dev):
    """Two cluster nodes on the card (N=4,096, A=64, M=16, D=2) take writes
    and gossip to equal digests; their planes and served read frames equal
    the same run's on the CPU, and the sessions launch the merge kernel."""
    uni, ((p, _), (q, _)) = _sync_pair(dev, n=4096, a=64, m=16, d=2)
    want = _gossip_run(p, q, uni)
    _build.reset_launch_counts()
    got = _gossip_run(_on(p, dev), _on(q, dev), uni)
    assert _build.launch_counts()["orswot_merge"] >= 2
    assert got[2] == want[2] <= 2
    for g, w in zip(got[0], want[0]):
        for f in ("clock", "ids", "dots", "d_ids", "d_clocks"):
            assert getattr(g, f).device.type == "cuda"
            assert torch.equal(getattr(g, f).cpu(), getattr(w, f)), f
    assert got[1] == want[1]
    assert all(r.converged and r.tree_mode for r in got[3])


def test_durable_snapshot_recovery_and_rejoin_on_the_card(dev, tmp_path):
    """A node on the card checkpoints (the planes read from the card), takes
    WAL'd writes and is dropped; ``recover(device="cuda")`` gives its planes
    bit for bit, equal to a CPU recovery of the same directory, and neither
    launches a kernel; the recovered node rejoins its peer over queue links
    by delta sync, the merge kernel on its applies."""
    import threading

    from crdt_tpu_torch.cluster import ClusterNode, queue_pair
    from crdt_tpu_torch.durable import Durability, recover
    from crdt_tpu_torch.oplog import OpLog

    uni, ((p, _), (q, _)) = _sync_pair(dev, n=4096, a=64, m=16, d=2)
    node = ClusterNode("a", _on(p, dev), uni, oplog=OpLog(uni),
                       durability=Durability(tmp_path))
    _build.reset_launch_counts()
    snap = node.checkpoint()
    rows = np.arange(0, 4096, 97)
    node.submit_writes(rows, np.full(rows.size, 1 << 22, np.int32), actor=5)
    want = [getattr(node.batch, f).clone() for f in ("clock", "ids", "dots", "d_ids",
                                                      "d_clocks")]
    del node
    rec = recover(tmp_path, device="cuda")
    cpu = recover(tmp_path, device="cpu")
    assert sum(_build.launch_counts().values()) == 0
    assert snap.generation == rec.report.generation == 1
    assert rec.report.replayed_ops == rows.size
    for w, f in zip(want, ("clock", "ids", "dots", "d_ids", "d_clocks")):
        assert getattr(rec.batch, f).device.type == "cuda"
        assert torch.equal(getattr(rec.batch, f), w), f
        assert torch.equal(getattr(cpu.batch, f), w.cpu()), f
    a = ClusterNode("a", rec.batch, uni, oplog=OpLog(uni), applier=rec.applier,
                    durability=Durability(tmp_path))
    b = ClusterNode("b", _on(q, dev), uni, oplog=OpLog(uni))
    _build.reset_launch_counts()
    reports = []
    for _ in range(4):
        ta, tb = queue_pair(default_timeout=60.0)
        t = threading.Thread(target=lambda: reports.append(b.accept(tb, "a")), daemon=True)
        t.start()
        reports.append(a.sync_with("b", ta))
        t.join(timeout=120.0)
        assert not t.is_alive()
        if np.array_equal(a.digest(), b.digest()):
            break
    assert np.array_equal(a.digest(), b.digest())
    assert _build.launch_counts()["orswot_merge"] >= 1
    assert not any(r.full_state_fallback or r.full_bytes_sent for r in reports)


def _planes_of(batch):
    return tuple(getattr(batch, f) for f in ("clock", "ids", "dots", "d_ids", "d_clocks"))


@pytest.fixture
def nccl_world(dev, tmp_path):
    """A world of one rank over NCCL (one card holds one rank)."""
    import torch.distributed as dist

    from crdt_tpu_torch.parallel import initialize

    initialize(num_processes=1, process_id=0, store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_nccl_joins_at_world_one_equal_the_local_state(dev, nccl_world):
    import torch.distributed as dist

    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
    from crdt_tpu_torch.batch import GSetBatch, LWWRegBatch, MVRegBatch
    from crdt_tpu_torch.obs.fleet import FleetObservatory
    from crdt_tpu_torch.parallel import (
        all_reduce_clock_join, allgather_join_gset, allgather_join_lww, allgather_join_mvreg,
        allgather_join_orswot, make_mesh, make_multihost_mesh,
    )
    from crdt_tpu_torch.parallel.collective import allgather_fleet_snapshots

    mesh = make_mesh({"replicas": 1}, device="cuda")
    assert str(dist.get_backend(mesh.get_group("replicas"))) == "nccl"
    planes = tuple(x[0] for x in _fleets(3, 512, 64, 16, 2, 1, dev))
    batch = OrswotBatch(*planes)
    assert torch.equal(all_reduce_clock_join(batch.clock[None], mesh)[0], batch.clock)
    _equal(_planes_of(allgather_join_orswot(batch, mesh)), planes)
    hybrid = make_multihost_mesh({"replicas": 1}, {"objects": 1}, device="cuda")
    _equal(_planes_of(allgather_join_orswot(batch, hybrid, object_axis="objects")), planes)
    rng = np.random.RandomState(5)
    lww = LWWRegBatch.from_numpy(rng.randint(0, 9, 64), rng.randint(1, 99, 64), device=dev)
    joined, conflict = allgather_join_lww(lww, mesh)
    assert torch.equal(joined.vals, lww.vals) and not bool(conflict.any())
    uni = Universe(CrdtConfig(num_actors=8, mv_capacity=4))
    mv = MVRegBatch.zeros(32, uni, device=dev)
    assert torch.equal(allgather_join_mvreg(mv, mesh).clocks, mv.clocks)
    bits = torch.from_numpy(rng.rand(64, 32) < 0.3).to(dev)
    assert torch.equal(allgather_join_gset(GSetBatch(bits), mesh).bits, bits)
    with pytest.raises(ValueError, match="needs a gloo group"):
        all_reduce_clock_join(batch.clock.cpu()[None], mesh)
    assert allgather_fleet_snapshots(FleetObservatory("n0")).nodes() == ["n0"]


@pytest.mark.parametrize("impl", [None, "pallas"])
def test_anti_entropy_on_the_card_equals_the_cpu(dev, impl):
    from crdt_tpu_torch import OrswotBatch
    from crdt_tpu_torch.parallel import anti_entropy

    planes = _fleets(7, 4096, 64, 16, 2, 8, dev, deferred_frac=0.25)
    _build.reset_launch_counts()
    got, rounds = anti_entropy(OrswotBatch(*planes), impl=impl)
    launches = _build.launch_counts()
    want, cpu_rounds = anti_entropy(OrswotBatch(*(x.cpu() for x in planes)), impl=impl)
    assert rounds == cpu_rounds
    _equal([x.cpu() for x in _planes_of(got)], _planes_of(want))
    # the fold's R - 1 merges and a self-merge per later round, all pairwise
    assert launches["orswot_merge"] >= 7 + rounds - 1
    assert launches["orswot_fold_aligned"] == launches["orswot_fold"] == 0


def test_mesh_step_and_member_sharding_over_nccl_equal_the_cpu(dev, nccl_world):
    """At world size one over NCCL: ``anti_entropy_step`` over 8 shards
    and ``member_sharded_merge`` over 4 member shards, on the card and on
    the CPU (the same default group's gloo dims), equal bit for bit, and
    each launches the merge kernel."""
    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe, mesh
    from crdt_tpu_torch.parallel import make_mesh, member_sharded_merge, partition_dense

    uni = Universe.identity(CrdtConfig(num_actors=64, member_capacity=16, deferred_capacity=2,
                                       counter_bits=32))
    planes = _fleets(11, 4099, 64, 16, 2, 2, dev, deferred_frac=0.25)
    results = {}
    for d in ("cuda", "cpu"):
        a, b = (OrswotBatch(*(x[r].to(d) for x in planes)) for r in range(2))
        sa, sb = (mesh.ShardedBatch.shard(x, uni, shards=8, granule=256) for x in (a, b))
        _build.reset_launch_counts()
        res = mesh.anti_entropy_step(sa, sb)
        parts = [partition_dense(*x.to_numpy(), 4, 8, 2) for x in (a, b)]
        state = member_sharded_merge(
            *(_planes_of(OrswotBatch.from_numpy(*p, device=d)) for p in parts),
            make_mesh({"members": 1}, device=d))
        results[d] = (res, state, _build.launch_counts()["orswot_merge"])
    (got, gstate, launches), (want, wstate, cpu_launches) = results["cuda"], results["cpu"]
    assert launches >= 2 and cpu_launches == 0
    np.testing.assert_array_equal(got.digests, want.digests)
    np.testing.assert_array_equal(got.version_vector, want.version_vector)
    assert got.live_members == want.live_members
    _equal([x.cpu() for x in _planes_of(got.batch.device)], _planes_of(want.batch.device))
    _equal([x.cpu() for x in gstate], wstate)


def test_tools_replicate_tcp_demo_on_the_card_equals_the_cpu(dev):
    """``replicate_tcp`` at 4,096 objects: two peers in process on the card
    and on the CPU converge on the same blobs (the card's applies launch
    the merge kernel), and the two-process demo on the card reports the
    CPU merge's digest fingerprint from both children."""
    import json
    import pathlib
    import socket
    import subprocess
    import sys
    import threading

    from crdt_tpu_torch.sync import digest_of
    from crdt_tpu_torch.tools import digest_sha
    from crdt_tpu_torch.tools import replicate_tcp as rt

    n, blobs = 4096, {}
    for d in ("cuda", "cpu"):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        out = {}
        _build.reset_launch_counts()
        legs = [threading.Thread(target=lambda r=r: out.update({r: rt.peer(r, port, n, d)}),
                                 daemon=True) for r in ("server", "client")]
        for t in legs:
            t.start()
        for t in legs:
            t.join(timeout=300)
        assert all(out[r][0].converged for r in ("server", "client"))
        assert (_build.launch_counts()["orswot_merge"] > 0) == (d == "cuda")
        blobs[d] = [out[r][1].to_wire(rt.identity_universe()) for r in ("server", "client")]
        if d == "cpu":
            sha = digest_sha(digest_of(out["server"][1], rt.identity_universe()))
    assert blobs["cuda"] == blobs["cpu"] and blobs["cpu"][0] == blobs["cpu"][1]
    proc = subprocess.run([sys.executable, "-m", "crdt_tpu_torch.tools.replicate_tcp",
                           "--objects", str(n)], cwd=pathlib.Path(__file__).parent.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-1500:]
    ev = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith('{"role"')]
    assert sorted(e["role"] for e in ev) == ["client", "server"]
    assert all(e["k2_launches"] > 0 and e["digest_sha256"] == sha for e in ev), ev


def test_join_spans_own_every_device_record_and_the_tracer_drops_their_copies(dev):
    """A tree join of three fleets under the benchmark's tracer: its one
    ``executor/join_all`` span owns every device record, the merge kernel's
    three launches (made through ``ctypes``, under no aten op) included,
    and the device-side copy of the span stays out of the tracer's device
    records."""
    from crdt_tpu_torch import JoinExecutor, OrswotBatch
    from portbench import spans, trace

    planes = _fleets(13, 4096, 64, 16, 2, 3, dev, deferred_frac=0.25)
    fleets = [OrswotBatch(*(x[r] for x in planes)) for r in range(3)]
    JoinExecutor().join_all(fleets)
    _build.reset_launch_counts()
    with trace.Tracer(dev) as tracer:
        JoinExecutor().join_all(fleets)
    launches = _build.launch_counts()["orswot_merge"]
    found = spans.Spans.of(tracer)
    assert [n for n, *_ in found.spans] == ["executor/join_all"]
    assert launches == 3
    assert sum("orswot_merge" in n for n, *_ in found.under("executor/join_all")) == launches
    assert found.attributed_share() == 1.0
    assert "executor/join_all" not in {n for n, _, _ in tracer.device_events}
    assert sum(d for *_, d in tracer.device_events) == pytest.approx(
        sum(d for _, _, d, _ in found.device))
