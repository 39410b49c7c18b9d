"""The program's spans in the traced sub-window, and what the device did
under each.

The program marks its phases with ``crdt_tpu_torch.utils.tracing.span``:
``record_function`` ranges, which the profiler keeps among its host
records on the clock of its device records.  From the raw records of the
profiler that :class:`~portbench.trace.Tracer` ran:

* a **span** is a host user annotation: ``(name, thread, start_s,
  end_s)``; its parent is the innermost span of its thread that holds it;
* a **device record** (a kernel, copy or set; never the device-side copy of
  an annotation) goes to the innermost span, on the thread that launched
  it, that holds its launch: the host record of the CUDA API call with
  the same correlation id.  A record whose launch is missing goes to no span;
* the device is **idle under a span** for the part of the span's
  intervals that no device record covers.

A version of the port without spans leaves none, and every reader of
these numbers then returns None.
"""

from __future__ import annotations

import collections

from .trace import _annotation, busy_intervals


def _launch(name: str) -> bool:
    """A host record of a CUDA API call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``): a launch.  Told by its name,
    since not every torch version gives the record's activity kind."""
    return name.startswith("cu")


def nest(spans, points):
    """``(parent, owner)``: for each span of ``spans`` (``(name, thread,
    start, end)``) the index of the innermost other span of its thread
    that holds it, and for each ``(thread, t)`` of ``points`` the index of
    the innermost span of that thread that holds ``t`` (None where there
    is none).  Spans of one thread nest; a span holds its start and not
    its end, so of two spans that meet, the later holds the instant."""
    parent, owner = [None] * len(spans), [None] * len(points)
    events = collections.defaultdict(list)
    for i, (_, tid, s, e) in enumerate(spans):
        # at one instant: closes (the inner first), opens (the outer
        # first), points, then the closes of empty spans
        events[tid].append((s, 1, -e, i))
        events[tid].append((e, 0 if e > s else 3, -s, i))
    for j, (tid, t) in enumerate(points):
        events[tid].append((t, 2, 0.0, j))
    for evs in events.values():
        evs.sort()
        stack = []
        for _, kind, _, k in evs:
            if kind == 1:
                parent[k] = stack[-1] if stack else None
                stack.append(k)
            elif kind == 2:
                owner[k] = stack[-1] if stack else None
            else:
                stack.remove(k)
    return parent, owner


def _overlap(intervals, cover):
    """The length of ``intervals`` (sorted, disjoint ``(s, e)``) that
    ``cover`` (sorted, disjoint) covers."""
    total, j = 0.0, 0
    for s, e in intervals:
        while j < len(cover) and cover[j][1] <= s:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < e:
            total += min(e, cover[k][1]) - max(s, cover[k][0])
            k += 1
    return total


class Spans:
    """Spans and device records of one trace, each record put down to a
    span.  ``spans``: ``[(name, thread, start_s, end_s)]``; ``device``:
    ``[(name, start_s, dur_s, correlation)]``; ``launches``:
    ``{correlation: (thread, t_s)}``."""

    def __init__(self, spans, device, launches):
        self.spans, self.device = list(spans), list(device)
        points = [launches.get(c, (None, 0.0)) for _, _, _, c in self.device]
        self.parent, self.owner = nest(self.spans, points)
        self.busy = busy_intervals([(n, s, d) for n, s, d, _ in self.device])

    @classmethod
    def of(cls, tracer) -> "Spans | None":
        """From the raw records of ``tracer``'s profiler; None when it
        holds none (a made-up tracer)."""
        prof = getattr(tracer, "_prof", None)
        if prof is None:
            return None
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        spans, device, launches = [], [], {}
        for ev in prof.profiler.kineto_results.events():
            start = ev.start_ns() * 1e-9
            if ev.device_type() == cuda:
                if not _annotation(ev):
                    device.append((ev.name(), start, ev.duration_ns() * 1e-9,
                                   ev.correlation_id()))
            elif _annotation(ev):
                spans.append((ev.name(), ev.start_thread_id(), start,
                              start + ev.duration_ns() * 1e-9))
            elif _launch(ev.name()):
                launches[ev.correlation_id()] = (ev.start_thread_id(), start)
        return cls(spans, device, launches)

    def count(self, name: str) -> int:
        return sum(1 for n, *_ in self.spans if n == name)

    def _chain(self, i):
        while i is not None:
            yield self.spans[i][0]
            i = self.parent[i]

    def under(self, name: str):
        """The device records ``(name, start_s, dur_s, correlation)``
        launched under a span ``name``."""
        return [rec for rec, i in zip(self.device, self.owner) if name in self._chain(i)]

    def device_s(self, name: str) -> float:
        """Device time launched under a span ``name``."""
        return sum(d for _, _, d, _ in self.under(name))

    def idle_s(self, name: str) -> float:
        """Time inside the spans ``name`` (their union) when no device
        record ran."""
        mine = busy_intervals([(n, s, e - s) for n, _, s, e in self.spans if n == name])
        return sum(e - s for s, e in mine) - _overlap(mine, self.busy)

    def attributed_share(self) -> float:
        """The share of the device time put down to some span."""
        total = sum(d for _, _, d, _ in self.device)
        mine = sum(d for (_, _, d, _), i in zip(self.device, self.owner) if i is not None)
        return mine / total if total else 0.0


def of(ctx) -> Spans | None:
    """The traced run's :class:`Spans`, read once per run and kept in the
    readers' shared ``ctx``; None when the program left no span."""
    if "program_spans" not in ctx:
        found = Spans.of(ctx["trace"])
        ctx["program_spans"] = found if found is not None and found.spans else None
    return ctx["program_spans"]
