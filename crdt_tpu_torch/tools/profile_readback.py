#!/usr/bin/env python3
"""What it costs to read a profiled block's device time back, on one
CUDA card: the raw profiler events against ``key_averages()``.

    python -m crdt_tpu_torch.tools.profile_readback

Each of ``REPEATS`` runs profiles ``LAUNCHES`` small kernels (one
in-place add on a 4 KiB tensor each; ``chip_smoke.py``'s profiled
scheduler round records ~85,000 device events) under
:func:`crdt_tpu_torch.utils.tracing.profile`, then times, on the host's
clock: the block itself, stopping the profiler and writing its Chrome
trace, summing the device events' durations from the raw events (what
``chip_smoke.py`` does), and summing the device self time over
``key_averages()``; it prints both sums.  One line per run, the card's
name and power limit, and one JSON line last.  The traces go to
``LOG_DIR`` and are removed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

LAUNCHES, REPEATS = 85_000, 2
LOG_DIR = os.path.join("build", "profile_readback")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _device_self_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("no device self time on a key_averages() row")


def measure(launches: int, log_dir: str) -> dict:
    import torch
    from torch.autograd import DeviceType

    from crdt_tpu_torch.utils import tracing

    x = torch.zeros(1024, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing.profile(log_dir) as prof:
        for _ in range(launches):
            x.add_(1.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    if prof is None:
        raise RuntimeError("the profiler did not start")
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    raw_ms = sum(e.duration_ns() for e in device) / 1e6
    t3 = time.perf_counter()
    avg_ms = sum(_device_self_us(e) for e in prof.key_averages()) / 1e3
    t4 = time.perf_counter()
    if not device:
        raise RuntimeError("the profiler recorded no device event")
    return {"launches": launches, "device_events": len(device), "block_s": t1 - t0,
            "stop_and_export_s": t2 - t1, "raw_s": t3 - t2, "key_averages_s": t4 - t3,
            "raw_busy_ms": raw_ms, "key_averages_busy_ms": avg_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_readback: needs a CUDA card", file=sys.stderr)
        return 2
    runs = []
    for i in range(REPEATS):
        try:
            r = measure(LAUNCHES, LOG_DIR)
        finally:
            shutil.rmtree(LOG_DIR, ignore_errors=True)
        runs.append(r)
        print(f"repeat {i}: {r['device_events']} device events; block {r['block_s']:.3f} s, "
              f"stop and export {r['stop_and_export_s']:.3f} s, raw events {r['raw_s']:.3f} s, "
              f"key_averages() {r['key_averages_s']:.3f} s; busy {r['raw_busy_ms']:.3f} ms "
              f"(key_averages {r['key_averages_busy_ms']:.3f})", flush=True)
    card = _card()
    print(card)
    print(json.dumps({"card": card, "torch": torch.__version__, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
