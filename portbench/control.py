"""The control: the plain reference put in the program's place, with its
counters held at 16 bits, the width below the configurations' u32.  It
runs through the harness's own run (``run.run_cell``) as the step that
the window drives, so the cell's own comparison judges it, and it has to
come out as not correct.

    python -m portbench.control --workload <name> --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .kinds import Answers

NARROW_BITS = 16


def _narrow_pool(pool, bits: int):
    """The pool's ops with every counter cut to ``bits`` bits."""
    from portbench.kinds.writes import Pool

    mask = np.uint64((1 << bits) - 1)
    causal = [(obj, actor, counter & mask, member, rm_obj, rm_member, rm_clock & mask)
              for obj, actor, counter, member, rm_obj, rm_member, rm_clock in pool.causal]
    return Pool(pool.frames, causal, pool.parked, pool.pairs)


def fault(cell):
    """The step the window drives, with the control in the program's
    place: the rejoin's join or the op loop's ``run``."""
    from portbench.kinds import rejoin, writes

    if isinstance(cell, rejoin.Cell):
        def join(unit, stats):
            return Answers(lambda rows: cell.reference(rows, narrow_bits=NARROW_BITS)[0])
        return join

    def answers(rows):
        return writes.reference_states(cell.f0_rows(rows, NARROW_BITS),
                                       _narrow_pool(cell.pool, NARROW_BITS), cell.delivered)

    def run(batch, frames):
        ops = len(frames) * cell.ops_per_frame
        return Answers(answers), {"frames": len(frames), "applied": ops, "duplicates": 0,
                                  "still_parked": 0, "stage_s": {"parse": 0.0}}
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from portbench import run

    run._cache_dirs()
    spec = run.load_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(spec, seed, 0.0, False, device, time.perf_counter(), fault=fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
