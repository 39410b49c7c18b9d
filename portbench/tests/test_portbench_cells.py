"""Each cell end to end on the CPU at a tiny size, the control, and the
faults the comparison has to catch."""

import time

import numpy as np
import pytest
import torch

from portbench import control, fleets, run
from portbench.kinds import rejoin
from portbench.tests.conftest import tiny_spec

CELLS = ("orswot64.rejoin", "orswot64.writes", "map_orswot.rejoin")
SEED = 2**31 + 977


def _run(workload, device, trace=False, fault=None, seconds=0.3):
    return run.run_cell(tiny_spec(workload), SEED, seconds, trace, device, time.perf_counter(),
                        fault=fault)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_port_matches_the_reference(workload, trace, cpu):
    out = _run(workload, cpu, trace)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    if not trace:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, cpu):
    out = _run(workload, cpu, fault=control.fault, seconds=0.0)
    assert not out["correct"]
    assert out["checks"]["rows_differing"]["value"] > 0, out["checks"]


def _unchanged(cell):
    if isinstance(cell, rejoin.Cell):
        return lambda unit, stats: cell.units[unit][0]
    return lambda batch, frames: cell.loop.run(batch, [])


def _half(cell):
    if isinstance(cell, rejoin.Cell):
        def join(unit, stats):
            out = cell.join(unit, stats)
            first = cell.units[unit][0]
            half = cell.span // 2
            for name in ("clock", "ids", "dots", "d_ids", "d_clocks", "entry_clocks", "keys"):
                if hasattr(out, name):
                    getattr(out, name)[half:] = getattr(first, name)[half:]
            return out
        return join
    return lambda batch, frames: cell.loop.run(batch, frames[: len(frames) // 2])


def _altered(cell):
    if isinstance(cell, rejoin.Cell):
        def join(unit, stats):
            out = cell.join(unit, stats)
            out.clock[0, 0] += 1
            return out
        return join

    def step(batch, frames):
        out, st = cell.loop.run(batch, frames)
        out.clock[0, 0] += 1
        return out, st
    return step


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(workload, fault, cpu):
    out = _run(workload, cpu, fault=fault)
    assert not out["correct"], out["checks"]


def test_frames_decode_to_the_minted_ops(cpu):
    from crdt_tpu_torch.oplog import decode_ops_frame

    cell = run.make_cell(tiny_spec("orswot64.writes"), SEED, cpu)
    pool = cell.pool
    for f, frame in enumerate(pool.frames):
        g = f + 1 if f in pool.pairs else f - 1 if f - 1 in pool.pairs else f
        obj, actor, counter, member, rm_obj, rm_member, rm_clock = pool.causal[g]
        ops = decode_ops_frame(frame, num_actors=64)
        na = obj.shape[0]
        assert np.array_equal(ops.obj, np.r_[obj, rm_obj])
        assert np.array_equal(ops.counter[:na], counter)
        assert np.array_equal(ops.member, np.r_[member, rm_member])
        assert np.array_equal(ops.rm_clocks[na:], rm_clock)
        assert not ops.rm_clocks[:na].any()
    assert sum(pool.parked) > 0


def test_removes_follow_the_zipf_law_with_no_cap(cpu):
    """The busiest object takes many removes a frame, as many as the Zipf
    law gives it, and every remove reads a state one frame old."""
    spec = tiny_spec("orswot64.writes")
    spec["mix"].update(ops_per_frame=4096)
    cell = run.make_cell(spec, SEED, cpu)
    rm_obj = cell.pool.causal[1][4]
    assert np.unique(rm_obj, return_counts=True)[1].max() > 8
    f0 = cell.f0[0].cpu().numpy().astype(np.int64) + 2**31
    assert np.array_equal(cell.pool.causal[1][6], f0[rm_obj].astype(np.uint64))


def test_units_keep_a_swapped_pair_whole():
    from portbench.kinds.writes import units

    assert units(8, 1, {2}) == [(0, 1), (1, 2), (2, 4), (4, 5), (5, 6), (6, 7), (7, 8)]
    assert units(8, 3, {2, 5}) == [(0, 4), (4, 7), (7, 8)]


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_orswot_replicas_are_valid_and_seeded(seed, cpu):
    kw = dict(n=300, a=64, m=16, d=2, r=3, n_val=3, base=6, novel=1, present_p=0.9,
              deferred_frac=0.25)
    reps = fleets.orswot_replicas(seed, cpu, **kw)
    again = fleets.orswot_replicas(seed, cpu, **kw)
    for rep, rep2 in zip(reps, again):
        assert all(torch.equal(x, y) for x, y in zip(rep, rep2))
        clock, ids, dots, d_ids, d_clocks = rep
        assert bool((clock >= dots.amax(dim=1)).all())
        live = ids != fleets.EMPTY
        same = (ids[:, :, None] == ids[:, None, :]) & live[:, :, None] & live[:, None, :]
        assert int(same.sum()) == int(live.sum())
        assert bool(((dots != fleets.ZERO).any(-1) == live).all())
        assert int((clock != fleets.ZERO).sum(-1).max()) <= 3  # the preference list's vnodes
    assert int((reps[0][3] != fleets.EMPTY).sum()) > 0
    assert int((reps[1][3] != fleets.EMPTY).sum()) == 0


def test_map_replicas_are_valid(cpu):
    reps = fleets.map_replicas(7, cpu, n=40, a=64, k=16, d=8, m=32, dv=8, r=3, n_val=3,
                               base_keys=8,
                               base_members=12, novel_members=2, present_p=0.9,
                               deferred_frac=0.2, clock_extra_frac=0.2)
    for clock, keys, eclocks, vals, d_keys, d_clocks in reps:
        assert bool((clock >= eclocks.amax(dim=1)).all())
        assert bool((eclocks >= vals[0]).all())
        assert bool(((keys != fleets.EMPTY) == (eclocks != fleets.ZERO).any(-1)).all())
        assert int((clock != fleets.ZERO).sum(-1).max()) <= 3
    assert int((reps[0][4] != fleets.EMPTY).sum()) > 0
    assert int((reps[0][3][3] != fleets.EMPTY).sum()) > 0


def test_no_card_no_result(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(run, "_cache_dirs", lambda: None)
    assert run.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(workload):
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", workload, "--seed",
                          str(SEED), "--seconds", "2", "--trace", "1"], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
