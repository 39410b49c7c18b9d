"""The traced sub-window: ``torch.profiler`` over a few rounds or frames,
read from its raw activity records.

Device time is summed from the raw kernel, copy and set records, never
from ``key_averages()`` (which has been seen to read twice the raw sum),
and never from the device-side copies of host annotations.  Busy time is
the union of the device records' intervals, so overlapping streams are
counted once.  Nothing is written to disk.
"""

from __future__ import annotations

import time

import torch


def _annotation(ev) -> bool:
    """A host annotation's copy on the device timeline, not device work."""
    probe = getattr(ev, "is_user_annotation", None)
    return bool(probe()) if probe is not None else False


class Tracer:
    """Context manager: profiles its block, synchronizing the device at
    both ends, then holds ``device`` (``[(name, start_s, dur_s)]``),
    ``host`` (the host-side records, same form), ``window_s`` and
    ``busy_s``."""

    def __init__(self, device):
        self.device = device
        self.device_events, self.host_events = [], []
        self.window_s = self.busy_s = 0.0
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        for ev in self._prof.profiler.kineto_results.events():
            rec = (ev.name(), ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9)
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if not _annotation(ev):
                    self.device_events.append(rec)
            else:
                self.host_events.append(rec)
        self.busy_s = sum(e - s for s, e in busy_intervals(self.device_events))
        return False


def busy_intervals(events):
    """The union of ``(start, start + dur)`` over ``events``, merged and
    sorted."""
    spans = sorted((s, s + d) for _, s, d in events)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def device_ops(events, top: int = 10):
    """The device operations that took most time: ``[[name, seconds]]``."""
    total = {}
    for name, _, d in events:
        total[name] = total.get(name, 0.0) + d
    return [[n[:200], s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(device_events, host_events, top: int = 10):
    """The idle stretches between device work, named by the innermost host
    record under each gap's midpoint and summed per name over the 200
    longest gaps: ``[[name, seconds]]``, longest first."""
    spans = busy_intervals(device_events)
    gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(spans, spans[1:])),
                  reverse=True)[:200]
    total = {}
    for _, e0, s1 in gaps:
        mid = (e0 + s1) / 2
        under = [(d, n) for n, s, d in host_events if s <= mid <= s + d]
        name = min(under)[1] if under else "host Python outside torch ops"
        total[name] = total.get(name, 0.0) + (s1 - e0)
    return [[n[:200], s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
