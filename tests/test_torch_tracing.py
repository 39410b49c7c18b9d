"""The port's program spans (``crdt_tpu_torch.utils.tracing.span``) under a
CPU ``torch.profiler`` run: the executor's, the op applier's, the op
loop's and the Map merge's spans, their nesting and threads, ``oplog/remove_round`` against ``ApplyReport.rm_rounds``, the
off path's cost with no profiler running; and the benchmark's
attribution of device records and idle time to spans
(``portbench/spans.py``) on made-up records."""

import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crdt_tpu_torch import (
    CrdtConfig, JoinExecutor, JoinStats, MapBatch, OrswotBatch, OrswotKernel, PipelinedOpLoop,
    Universe,
)
from crdt_tpu_torch.oplog import OP_ADD, OP_RM, OpApplier, OpBatch, encode_ops_frame
from crdt_tpu_torch.scalar.orswot import Add, Orswot
from crdt_tpu_torch.scalar.vclock import Dot
from crdt_tpu_torch.utils import tracing
from crdt_tpu_torch.utils.testdata import random_orswot_arrays
from portbench import spans

torch.set_num_threads(1)

A, M, D = 8, 8, 4


def _traced(fn):
    """``(fn(), Spans)`` of a CPU profile of ``fn``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans.Spans.of(types.SimpleNamespace(_prof=prof))


def _parents(found):
    """``{span name: {parent names}}`` (None for a span with no parent)."""
    out = {}
    for (name, *_), p in zip(found.spans, found.parent):
        out.setdefault(name, set()).add(None if p is None else found.spans[p][0])
    return out


def _threads(found, *names):
    return {tid for n, tid, *_ in found.spans if n in names}


def _universe():
    return Universe.identity(CrdtConfig(num_actors=A, member_capacity=M, deferred_capacity=D,
                                        counter_bits=32))


def _fleets(r, n=16, seed=3):
    """``r`` replicas of one random fleet (their join needs no regrow)."""
    planes = random_orswot_arrays(np.random.RandomState(seed), n, A, M, D, deferred_frac=0.3)
    return [OrswotBatch.from_numpy(*planes, device="cpu") for _ in range(r)]


def test_join_tree_spans_nest_under_the_executor():
    """A tree join is one ``executor/join_all`` span and no other: the
    tree's phases carry none, so a traced rejoin round pays for one span."""
    fleets = _fleets(3)
    _, found = _traced(lambda: JoinExecutor(strategy="tree").join_all(fleets))
    assert _parents(found) == {"executor/join_all": {None}}
    assert found.count("executor/join_all") == 1


def _ladder(n=4):
    """Two fleets whose objects each hold two members through fleet-private
    actors, at member capacity 2: their join needs 4 slots."""
    uni = Universe(CrdtConfig(num_actors=4, member_capacity=2, deferred_capacity=2,
                              counter_bits=32))
    fleets = []
    for f in range(2):
        row = []
        for obj in range(n):
            s = Orswot()
            for j in range(2):
                s.apply(Add(dot=Dot(f"w{f}", j + 1), member=f"m{obj}-{f}-{j}"))
            row.append(s)
        fleets.append(OrswotBatch.from_scalar(row, uni, device="cpu"))
    return fleets


@pytest.mark.parametrize("strategy", ["sequential", "tree"])
def test_a_regrow_is_a_span_of_the_executor(strategy):
    stats = JoinStats()
    executor = JoinExecutor(strategy=strategy, retry_backoff_s=0)
    _, found = _traced(lambda: executor.join_all(_ladder(), stats=stats))
    assert stats.overflow_regrows == found.count("executor/regrow") >= 1
    assert _parents(found)["executor/regrow"] == {"executor/join_all"}
    if strategy == "sequential":
        assert found.count("executor/merge") == stats.joins + stats.overflow_regrows


def test_map_merge_spans_nest_under_the_left_fold():
    uni = _universe()
    kernel = OrswotKernel(M, D, A, 32)
    maps = [MapBatch.zeros(8, uni, kernel, device="cpu") for _ in range(3)]
    _, found = _traced(lambda: JoinExecutor(strategy="sequential").join_all(maps))
    assert _parents(found) == {
        "executor/join_all": {None}, "executor/merge": {"executor/join_all"},
        "map/merge": {"executor/merge"}, "map/align": {"map/merge"},
        "map/nested_merge": {"map/merge"}, "map/settle_deferred": {"map/merge"},
        "map/nested_truncate": {"map/merge", "map/settle_deferred"},
        "map/compact": {"map/merge"}}
    # two merges of the fold and the plunger
    assert found.count("executor/merge") == found.count("map/merge") == 3
    assert len(_threads(found, *_parents(found))) == 1


def _ops(batch, n_rm=3, seed=5):
    """Ready adds on every object (one more dot of a random actor each) and
    ``n_rm`` removes of object 0's members under its clock."""
    rng = np.random.RandomState(seed)
    clock, ids = batch.to_numpy()[:2]
    n = clock.shape[0]
    actor = rng.randint(0, A, n)
    adds = OpBatch(kind=np.full(n, OP_ADD), obj=np.arange(n), actor=actor,
                   counter=clock[np.arange(n), actor].astype(np.uint64) + 1,
                   member=ids[np.arange(n), 0])
    live = ids[0][ids[0] >= 0][:n_rm]
    rms = OpBatch(kind=np.full(len(live), OP_RM), obj=np.zeros(len(live), np.int64),
                  actor=np.zeros(len(live)), counter=np.zeros(len(live), np.uint64),
                  member=live, rm_clocks=np.repeat(clock[:1].astype(np.uint64), len(live), 0))
    return OpBatch.concat([adds, rms])


def test_apply_ops_spans_count_the_remove_rounds():
    batch = _fleets(1, seed=7)[0]
    applier = OpApplier(_universe())
    ops = _ops(batch)
    (_, report), found = _traced(lambda: applier.apply_ops(batch, ops))
    assert report.rm_rounds == 3 and report.applied_rms == 3
    assert found.count("oplog/remove_round") == report.rm_rounds
    assert _parents(found) == {
        "oplog/apply": {None}, "oplog/partition": {"oplog/apply"},
        "oplog/plan_slots": {"oplog/apply"}, "oplog/fold_adds": {"oplog/apply"},
        "oplog/deferred_replay": {"oplog/apply"}, "oplog/removes": {"oplog/apply"},
        "oplog/remove_round": {"oplog/removes"}}


@pytest.mark.parametrize("overlap", [True, False])
def test_op_loop_spans_on_their_threads(overlap):
    batch = _fleets(1, seed=11)[0]
    frames = [encode_ops_frame(_ops(batch, n_rm=1, seed=s)) for s in range(3)]
    loop = PipelinedOpLoop(_universe())
    _, found = _traced(lambda: loop.run(batch, frames, overlap=overlap))
    parents = _parents(found)
    assert found.count("oploop/frame") == found.count("oplog/apply") == 3
    assert parents["oploop/frame"] == {None}
    assert parents["oplog/apply"] == {"oploop/frame"}
    # the fold waits on the decode thread only when it runs one; the
    # profiler records the folding thread, where every span is
    assert found.count("oploop/stall") == (3 if overlap else 0)
    if overlap:
        assert parents["oploop/stall"] == {"oploop/frame"}
    assert len(_threads(found, *parents)) == 1


def test_spans_record_only_while_a_profiler_runs():
    fleets = _fleets(2)
    assert tracing.span("executor/join_all") is tracing.span("oplog/apply")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    JoinExecutor(strategy="tree").join_all(fleets)
    assert not spans.Spans.of(types.SimpleNamespace(_prof=prof)).spans
    # entering and leaving one span with no profiler: the best of 5 runs
    n = 20_000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("oplog/remove_round"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    print(f"span off path: {best * 1e9:.0f} ns")
    assert best < 2e-6


# -- the benchmark's attribution, on made-up records ----------------------------


def test_records_go_to_the_innermost_span_of_their_launching_thread():
    program = [("outer", 1, 0.0, 10.0), ("inner", 1, 2.0, 4.0), ("other", 2, 0.0, 10.0),
               ("next", 1, 4.0, 6.0)]
    # (name, start, dur, correlation): the device runs later than the launch
    device = [("k0", 1.0, 1.0, 10), ("k1", 3.0, 2.0, 11), ("k2", 5.0, 1.0, 12),
              ("k3", 7.0, 1.0, 13), ("k4", 8.0, 1.0, 99)]
    launches = {10: (1, 0.5), 11: (1, 2.5), 12: (2, 3.0), 13: (1, 4.0)}
    found = spans.Spans(program, device, launches)
    assert found.parent == [None, 0, None, 0]
    names = [None if i is None else program[i][0] for i in found.owner]
    # k2 was launched from thread 2; k3 at the instant "inner" ends and
    # "next" begins; k4's launch is missing
    assert names == ["outer", "inner", "other", "next", None]
    assert found.device_s("outer") == pytest.approx(1.0 + 2.0 + 1.0)
    assert [n for n, *_ in found.under("outer")] == ["k0", "k1", "k3"]
    assert found.device_s("other") == pytest.approx(1.0)
    assert found.attributed_share() == pytest.approx(5.0 / 6.0)
    assert found.count("inner") == 1 and found.count("missing") == 0


def test_idle_time_counts_overlapping_streams_once():
    program = [("join", 1, 0.0, 4.0), ("join", 1, 6.0, 10.0)]
    # two streams overlap in [1, 2.5); the device is busy [1, 3) and [7, 8)
    device = [("a", 1.0, 1.5, 1), ("b", 2.0, 1.0, 2), ("c", 7.0, 1.0, 3)]
    found = spans.Spans(program, device, {1: (1, 0.1), 2: (1, 0.2), 3: (1, 6.1)})
    assert found.idle_s("join") == pytest.approx(8.0 - 2.0 - 1.0)
    assert found.device_s("join") == pytest.approx(3.5)
    assert found.idle_s("none") == 0.0


def test_concurrent_threads_keep_their_own_nesting():
    # thread 2's span overlaps both of thread 1's, and parents none of them
    program = [("a", 1, 0.0, 2.0), ("b", 1, 2.0, 4.0), ("c", 2, 1.0, 3.0),
               ("d", 2, 1.5, 2.5)]
    found = spans.Spans(program, [], {})
    assert found.parent == [None, None, None, 2]
    assert found.attributed_share() == 0.0


def test_empty_spans_open_and_close():
    found = spans.Spans([("z", 1, 1.0, 1.0), ("w", 1, 0.0, 2.0)],
                        [("k", 1.0, 0.5, 1)], {1: (1, 1.0)})
    assert found.parent == [1, None] and found.owner == [0]


def test_a_thread_that_the_profiler_does_not_record_leaves_no_span():
    """The benchmark's tracer records the thread that starts it: a span
    on another thread runs but is not recorded."""
    def other():
        with tracing.span("other/thread"):
            torch.ones(4).sum()

    def body():
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with tracing.span("oploop/frame"):
            pass

    _, found = _traced(body)
    assert [n for n, *_ in found.spans] == ["oploop/frame"]
