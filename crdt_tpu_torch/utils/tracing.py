"""Profiler capture (the port of the JAX package's ``utils/tracing.py``
``profile``; its span and counter tracer has no caller in the port,
whose modules keep plain counts).

:func:`profile` runs ``torch.profiler`` over its block (CPU activity,
and CUDA activity when a card is there) and writes a Chrome trace into
``log_dir``.  A profiler that cannot start is not an error for the
caller: the block runs unprofiled, :func:`unavailable_count` goes up, and
the first failure of each exception class leaves an
``obs.profiler_unavailable`` flight-recorder event.  The caller's own
exceptions propagate.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, Optional

_LOCK = threading.Lock()
_UNAVAILABLE = [0]
_SEEN: set = set()


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
