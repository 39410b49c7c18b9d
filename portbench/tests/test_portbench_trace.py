"""The trace's arithmetic and each per-layer reader on a made-up trace."""

import types

import pytest

from portbench import run, trace, yardstick
from portbench.tests.conftest import tiny_spec


def test_busy_time_is_the_union_of_intervals():
    events = [("a", 0.0, 1.0), ("b", 0.5, 1.0), ("c", 3.0, 0.5)]
    assert trace.busy_intervals(events) == [(0.0, 1.5), (3.0, 3.5)]
    host = [("outer", 0.0, 10.0), ("inner", 1.6, 1.0)]
    assert trace.idle_gaps(events, host) == [["inner", 1.5]]
    assert trace.device_ops(events + [("a", 5.0, 1.0)])[0] == ["a", 2.0]


def _ctx(workload, events, window_s, traced, window=None):
    spec = run.load_spec(workload)
    busy = sum(e - s for s, e in trace.busy_intervals(events))
    tracer = types.SimpleNamespace(device_events=events, host_events=[], busy_s=busy,
                                   window_s=window_s)
    span = spec["cfg"]["sizes"]["objects"] // (
        1 if spec["mix"]["per_round"] == "node" else spec["cfg"]["vnodes"]) \
        if spec["mix"]["kind"] == "rejoin" else None
    return {"cfg": spec["cfg"], "mix": spec["mix"], "window": window or {}, "traced": traced,
            "trace": tracer, "yardstick": yardstick, "span": span}, spec


def test_rejoin_readers():
    k2 = "void (anonymous namespace)::orswot_merge_kernel<2>(int const*)"
    events = [(k2, 0.0, 0.020), ("Memcpy DtoD (Device -> Device)", 0.020, 0.015),
              ("CatArrayBatchedCopy_vectorized", 0.035, 0.005)]
    ctx, spec = _ctx("orswot64.rejoin", events, 0.050, {"rounds": 1})
    got = {m["name"]: run.reader(m["name"])(ctx) for m in spec["per_layer"]}
    want_k2 = 100 * yardstick.round_bytes(spec["cfg"], 1_250_000)["k2"] / 3.35e12 / 0.020
    assert got["k2_roofline_pct.merge"] == pytest.approx(want_k2)
    assert got["tree_copy_ms"] == pytest.approx(20.0)
    assert got["round_host_ms"] == pytest.approx(10.0)
    assert got["idle_pct.merge"] == pytest.approx(20.0)


def test_write_readers_and_silence_without_records():
    events = [("where", 0.0, 0.5)]
    ctx, spec = _ctx("orswot64.writes", events, 1.0, {"frames": 8},
                     window={"frames": 16, "parse_s": 0.32})
    got = {m["name"]: run.reader(m["name"])(ctx) for m in spec["per_layer"]}
    assert got == pytest.approx({"apply_device_ms": 62.5, "parse_ms": 20.0,
                                 "idle_pct.write": 50.0})
    ctx, spec = _ctx("map_orswot.rejoin", [], 1.0, {"rounds": 2})
    assert all(run.reader(m["name"])(ctx) is None for m in spec["per_layer"])


def test_map_bytes_cover_every_plane(cpu):
    spec = tiny_spec("map_orswot.rejoin")
    cell = run.make_cell(spec, 5, cpu)
    rep = cell.reps[0]
    leaves = [rep[0], rep[1], rep[2], *rep[3], rep[4], rep[5]]
    s = spec["cfg"]["sizes"]
    assert sum(x.numel() * 4 for x in leaves) == yardstick.map_bytes(
        s["objects"], s["num_actors"], s["key_capacity"], s["deferred_capacity"],
        s["member_capacity"], s["set_deferred_capacity"])
