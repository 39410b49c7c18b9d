#!/usr/bin/env python3
"""Where the union-aligned fold kernel (K1, ``csrc/orswot_fold_aligned.cu``)
spends its cycles, phase by phase, on one CUDA card.

    python -m crdt_tpu_torch.tools.k1_phases [--iters 5] [--chunk 62500]

Builds the kernel twice: as the package builds it, and with
``-DORSWOT_PHASE_CLOCKS``, which compiles ``clock64()`` stamps in at the
phase boundaries (id staging, union build, issuing the copy of the
next staged replica, waiting for a staged replica, alignment; each fold
step's member dot rule, deferred dedup, replay and
retention; the plunger step; compaction and store) and sums each
warp's cycles per phase into a device-wide total.  Both builds fold the
north-star chunk (A=64, M=16, D=2, R=8, u_cap=16, the fleets
``chip_smoke.py`` times) and must agree bit for bit; the script then
prints each phase's share of the stamped cycles, both builds' times by
CUDA events, the card's name and power limit, and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np

PHASES = ("ids", "union", "issue", "wait", "align", "rule", "dedup", "replay", "retain",
          "plunger", "store")
STAMPS = ("-DORSWOT_PHASE_CLOCKS",)
A, M, D, R, U_CAP = 64, 16, 2, 8, 16
BASE, NOVEL, DEFERRED_FRAC = 6, 1, 0.25


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(name: str, phases, launch_stamped, package_call, label: str, argv=None) -> int:
    """Build kernel library ``name`` plain and with ``STAMPS``, fold the
    north-star chunk through both (``package_call(st)`` through the
    package, ``launch_stamped(lib, st, out, n, stream)`` through the
    stamped library's launcher), require them bit-equal, time both, and
    print each phase's share of the stamped cycles (``phases`` in the
    order of the library's ``<name>_phase_cycles`` totals)."""
    ap = argparse.ArgumentParser(description=label)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=62_500)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print(f"{name}: needs a CUDA card", file=sys.stderr)
        return 2
    from crdt_tpu_torch import _build
    from crdt_tpu_torch.ops.orswot_tile import _empty_out
    from crdt_tpu_torch.utils.testdata import build_fleet_planes, fleet_columns

    dev = torch.device("cuda", 0)
    _build.build_all([name])
    _build.build_all([name], STAMPS)
    for key, info in _build.BUILD_LOG.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print(f"ptxas[{key}]: {line.strip()}")
    lib = _build.library(name, STAMPS)
    read_cycles = getattr(lib, f"{name}_phase_cycles")
    read_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read_cycles.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * len(phases))()

    def read(reset: bool) -> list[int]:
        rc = read_cycles(ctypes.addressof(cycles), int(reset))
        if rc != 0:
            raise RuntimeError(f"reading the phase clocks failed: CUDA error {rc}")
        return list(cycles)

    cols = fleet_columns(np.random.RandomState(args.seed), args.chunk, A, M, D, R,
                         base=BASE, novel=NOVEL, deferred_frac=DEFERRED_FRAC)
    st = build_fleet_planes(cols, a=A, m_cap=M, d=D, base=BASE, novel=NOVEL, device=dev)
    n = st[0].shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = _empty_out(n, A, M, D, dev)

    def stamped():
        rc = launch_stamped(lib, st, out, n, stream)
        if rc != 0:
            raise RuntimeError(f"stamped launch failed: CUDA error {rc}")

    want = package_call(st)
    stamped()
    torch.cuda.synchronize()
    got = out[:5] + (out[5].bool(),)
    for plane, g, w in zip(("clock", "ids", "dots", "d_ids", "d_clocks", "overflow"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"stamped build disagrees with the package build on {plane}")
    ms_plain = _ms(lambda: package_call(st), args.iters)
    ms_stamped = _ms(stamped, args.iters)
    read(reset=True)
    for _ in range(args.iters):
        stamped()
    torch.cuda.synchronize()
    totals = read(reset=False)
    whole = sum(totals) or 1
    card = _card()
    print(f"card: {card}; {label} at [{R}, {n}, ...] A={A} M={M} D={D}: "
          f"{ms_plain:.4f} ms unstamped, {ms_stamped:.4f} ms stamped "
          f"(mean of {args.iters}); stamped build bit-equal")
    per_obj = whole / (args.iters * n)
    for phase, c in zip(phases, totals):
        print(f"  {phase:8s} {100.0 * c / whole:6.2f} %  {c / (args.iters * n):10.0f} cycles/object")
    print(f"  {'total':8s} 100.00 %  {per_obj:10.0f} cycles/object (per warp, summed over warps)")
    print(json.dumps({
        "card": card, "n": n, "iters": args.iters, "ms_unstamped": ms_plain,
        "ms_stamped": ms_stamped, "cycles_per_object": per_obj,
        "share": {phase: c / whole for phase, c in zip(phases, totals)},
    }))
    return 0


def main(argv=None) -> int:
    from crdt_tpu_torch.ops import orswot_fold_aligned as fa
    from crdt_tpu_torch.ops.orswot_tile import _ptrs

    def launch_stamped(lib, st, out, n, stream):
        return lib.orswot_fold_aligned_launch(*_ptrs(st), *_ptrs(out), R, n, A, M, D, M, D,
                                              U_CAP, 1, stream)

    return measure("orswot_fold_aligned", PHASES, launch_stamped,
                   lambda st: fa.fold_merge(*st, M, D, u_cap=U_CAP, prebiased=True),
                   f"K1 u_cap={U_CAP}", argv)


if __name__ == "__main__":
    sys.exit(main())
