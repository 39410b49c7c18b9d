"""The readers of the program's spans (``source: program_span``) on made-up
spans and records, and their silence where the program left no span."""

import pytest

from portbench import run, spans
from portbench.tests.test_portbench_trace import _ctx

#: the span readers; ``parse_ms`` reads the loop's own clock, not a span
READERS = ("rm_rounds", "rm_device_ms", "apply_idle_ms", "join_idle_ms", "map_passes_ms")


def _read(ctx, spec):
    return {m["name"]: run.reader(m["name"])(ctx) for m in spec["per_layer"]
            if m["name"] in READERS}


def _spanned(ctx, program_spans, device, launches):
    """``ctx`` with the readers' spans made up: the spans the program left,
    device records ``(name, start, dur, correlation)`` and their launches
    ``{correlation: (thread, t)}``."""
    ctx["program_spans"] = spans.Spans(program_spans, device, launches)
    ctx["trace"].device_events = [(n, s, d) for n, s, d, _ in device]
    return ctx


def test_write_span_readers():
    # two frames; the first has two remove rounds, the second one
    program = [("oplog/apply", 1, 0.0, 1.0), ("oplog/removes", 1, 0.5, 1.0),
               ("oplog/remove_round", 1, 0.5, 0.7), ("oplog/remove_round", 1, 0.7, 1.0),
               ("oplog/apply", 1, 2.0, 3.0), ("oplog/removes", 1, 2.5, 3.0),
               ("oplog/remove_round", 1, 2.5, 3.0)]
    device = [("scatter", 0.1, 0.3, 1), ("where", 0.6, 0.3, 2), ("where", 2.6, 0.2, 3)]
    launches = {1: (1, 0.05), 2: (1, 0.55), 3: (1, 2.55)}
    ctx, spec = _ctx("orswot64.writes", [], 4.0, {"frames": 2}, window={"frames": 4})
    got = _read(_spanned(ctx, program, device, launches), spec)
    # idle in the applier: 2.0 s of spans less 0.8 s of device work
    assert got == pytest.approx({"rm_rounds": 1.5, "rm_device_ms": 250.0,
                                 "apply_idle_ms": 600.0})


@pytest.mark.parametrize("workload", ["orswot64.rejoin", "map_orswot.rejoin"])
def test_rejoin_span_readers(workload):
    program = [("executor/join_all", 1, 0.0, 0.050), ("map/merge", 1, 0.0, 0.040),
               ("map/nested_merge", 1, 0.010, 0.020), ("map/nested_truncate", 1, 0.020, 0.030)]
    device = [("where", 0.001, 0.009, 1), ("orswot_merge", 0.011, 0.009, 2),
              ("where", 0.021, 0.001, 3), ("orswot_merge", 0.023, 0.004, 4),
              ("copy", 0.040, 0.005, 5)]
    launches = {1: (1, 0.0005), 2: (1, 0.0105), 3: (1, 0.0205), 4: (1, 0.0225),
                5: (1, 0.045)}
    ctx, spec = _ctx(workload, [], 0.1, {"rounds": 2})
    got = _read(_spanned(ctx, program, device, launches), spec)
    # busy 0.001-0.010, 0.011-0.020, 0.021-0.022, 0.023-0.027, 0.040-0.045 (28 ms)
    # of join_all's 50 ms
    want = {"join_idle_ms": (0.050 - 0.028) / 2 * 1e3}
    if workload.startswith("map"):
        # the two wheres, the second in a truncate; not the merge kernels
        want["map_passes_ms"] = (0.009 + 0.001) / 2 * 1e3
    assert got == pytest.approx(want)


@pytest.mark.parametrize("workload", ["orswot64.rejoin", "orswot64.writes",
                                      "map_orswot.rejoin"])
def test_span_readers_are_silent_without_spans(workload):
    """A port without spans, and a made-up tracer, read None."""
    events = [("where", 0.0, 0.5)]
    ctx, spec = _ctx(workload, events, 1.0, {"frames": 1, "rounds": 1})
    got = _read(ctx, spec)
    assert got and all(v is None for v in got.values())
    ctx, _ = _ctx(workload, events, 1.0, {"frames": 1, "rounds": 1})
    ctx["program_spans"] = None
    assert all(v is None for v in _read(ctx, spec).values())
