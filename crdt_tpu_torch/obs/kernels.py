"""The kernel observatory: device time per kernel by CUDA events (the
port's counterpart of the JAX package's ``obs/kernels.py``, which watches
jit compiles; here there are none, and the kernel list is
``_build.KERNELS``).

While enabled (off by default) :func:`crdt_tpu_torch._build.launch`
records a pair of CUDA events around each launch on the current stream,
with the bytes the wrapper says the kernel moves.  Nothing synchronizes
in the launch: :meth:`KernelObservatory.table` waits for the pending
events and returns, per kernel, the launches (``_build.launch_counts()``),
device ms (total, mean, max over the timed launches) and the bytes and
their share of the bytes bound; :meth:`KernelObservatory.publish` writes
the same table into a registry as ``kernel.<name>.{calls,bytes,wall,gbps}``
(the JAX package's compile counts, budgets, recompile storms and XLA cost
analysis have no counterpart here).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from .. import _build
from . import publish as publish_mod
from .metrics import Histogram

#: HBM rate of an H100 SXM (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12


class KernelObservatory:
    """Per-kernel device time of the launches made while enabled."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: List[tuple] = []
        self._stats: Dict[str, dict] = {}

    @property
    def enabled(self) -> bool:
        return _build.OBSERVER is self

    def set_enabled(self, on: bool = True) -> None:
        """Start or stop timing launches (the events already recorded
        stay pending until :meth:`table`)."""
        if on:
            _build.OBSERVER = self
        elif _build.OBSERVER is self:
            _build.OBSERVER = None

    def begin(self):
        """A started event on the current stream (``_build.launch``)."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def end(self, name: str, start, nbytes: Optional[int]) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        with self._lock:
            self._pending.append((name, start, ev, nbytes))

    def table(self) -> Dict[str, dict]:
        """``{kernel: {launches, timed, device_ms_total, device_ms_mean,
        device_ms_max, bytes, bound_ms, bound_share, gbps}}`` for every
        kernel of ``_build.KERNELS`` (JSON-ready)."""
        rows = self._rows()
        for row in rows.values():
            del row["wall"]
        return rows

    def _rows(self) -> Dict[str, dict]:
        """:meth:`table`'s rows, each with its launches' device seconds
        as a :class:`~crdt_tpu_torch.obs.metrics.Histogram` under
        ``wall``."""
        with self._lock:
            pending, self._pending = self._pending, []
            for name, start, end, nbytes in pending:
                end.synchronize()
                ms = start.elapsed_time(end)
                st = self._stats.setdefault(name, {"timed": 0, "ms": 0.0, "max": 0.0,
                                                   "bytes": 0, "bytes_ms": 0.0,
                                                   "wall": Histogram()})
                st["timed"] += 1
                st["wall"].observe(ms / 1e3)
                st["ms"] += ms
                st["max"] = max(st["max"], ms)
                if nbytes is not None:
                    st["bytes"] += int(nbytes)
                    st["bytes_ms"] += ms
            stats = {k: {**v, "wall": v["wall"].copy()} for k, v in self._stats.items()}
        counts = _build.launch_counts()
        out = {}
        for name in _build.KERNELS:
            st = stats.get(name, {"timed": 0, "ms": 0.0, "max": 0.0, "bytes": 0, "bytes_ms": 0.0,
                                  "wall": Histogram()})
            bound = st["bytes"] / HBM_BYTES_PER_S * 1e3
            out[name] = {
                "launches": counts[name], "timed": st["timed"], "device_ms_total": st["ms"],
                "device_ms_mean": st["ms"] / st["timed"] if st["timed"] else 0.0,
                "device_ms_max": st["max"], "bytes": st["bytes"], "bound_ms": bound,
                "bound_share": bound / st["bytes_ms"] if st["bytes_ms"] else None,
                "wall": st["wall"],
                "gbps": st["bytes"] / st["bytes_ms"] / 1e6 if st["bytes_ms"] else None,
            }
        return out

    def publish(self, registry) -> None:
        """Write :meth:`table` into ``registry``: per kernel its launches,
        the bytes of its timed launches, their device seconds (a log2
        histogram) and GB/s."""
        publish_mod.publish_kernels(registry, self._rows())

    def reset(self) -> None:
        """Forget the timings (the launch counts are ``_build``'s)."""
        with self._lock:
            self._pending = []
            self._stats = {}


_DEFAULT = KernelObservatory()


def kernel_observatory() -> KernelObservatory:
    """The process-global observatory."""
    return _DEFAULT


def sample_device_memory(device=None, tracker=None) -> Optional[dict]:
    """The CUDA allocator's statistics for ``device`` (default
    ``"cuda"``): allocated, reserved and peak bytes, and with a
    :class:`~crdt_tpu_torch.obs.capacity.CapacityTracker` the tracked
    plane bytes and their share of the allocated bytes.  None on a CPU
    device, which has no allocator statistics.  A capacity tracker keeps
    its newest sample, which the publisher writes as the ``devicemem.*``
    gauges (the allocated bytes are ``live_bytes``; the allocator has no
    per-dtype split)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    out = {"allocated_bytes": int(stats.get("allocated_bytes.all.current", 0)),
           "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
           "peak_allocated_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
           "allocations": int(stats.get("allocation.all.current", 0))}
    if tracker is not None:
        tracked = sum(p.occupancy.bytes for p in tracker.planes().values())
        out["tracked_bytes"] = tracked
        out["tracked_frac"] = tracked / out["allocated_bytes"] if out["allocated_bytes"] else 0.0
    return out
