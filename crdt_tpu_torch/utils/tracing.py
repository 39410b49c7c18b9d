"""Profiler capture and program spans (the port of the JAX package's
``utils/tracing.py`` ``profile`` and ``span``; its counter tracer has no
caller in the port, whose modules keep plain counts).

:func:`profile` runs ``torch.profiler`` over its block (CPU activity,
and CUDA activity when a card is there) and writes a Chrome trace into
``log_dir``.  A profiler that cannot start is not an error for the
caller: the block runs unprofiled, :func:`unavailable_count` goes up, and
the first failure of each exception class leaves an
``obs.profiler_unavailable`` flight-recorder event.  The caller's own
exceptions propagate.

:func:`span` marks a phase of the program (``"executor/join_all"``) as a
``record_function`` range, so it lands among the profiler's host records
on the clock of its device records.  It records exactly while a torch
profiler runs, :func:`profile` or any other; otherwise it is one flag
check.  Names use ``/``: a dotted name would read as a metric.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, Optional

from torch.autograd import profiler as _profiler

_LOCK = threading.Lock()
_UNAVAILABLE = [0]
_SEEN: set = set()
#: what :func:`span` hands out while no profiler runs: stateless, so one
#: instance serves every thread and every nesting
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("oplog/apply"): ...``: a ``record_function`` range while
    a torch profiler runs (the flag it sets on start is read first:
    entering a range costs microseconds even with no profiler), else a
    no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


def unavailable_count() -> int:
    """Profiler setups that failed in this process."""
    with _LOCK:
        return _UNAVAILABLE[0]


def _unavailable(exc: BaseException, log_dir: str) -> None:
    cls = type(exc).__name__
    with _LOCK:
        _UNAVAILABLE[0] += 1
        first = cls not in _SEEN
        _SEEN.add(cls)
    if first:
        from ..obs import events

        events.record("obs.profiler_unavailable", error=cls, detail=str(exc)[:200],
                      log_dir=log_dir)


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[Optional[object]]:
    """Profile the block into ``log_dir/trace-<pid>.json`` (a Chrome
    trace); yields the ``torch.profiler.profile`` (its ``key_averages()``
    hold the device times), or None when the profiler could not start."""
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity

        os.makedirs(log_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 - a missing profiler never fails the caller
        _unavailable(e, log_dir)
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
            except Exception as e:  # noqa: BLE001
                _unavailable(e, log_dir)
