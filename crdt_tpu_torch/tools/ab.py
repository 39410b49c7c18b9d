#!/usr/bin/env python3
"""A/B of two trees of this repository on one CUDA card, in one process
tree: ``chip_smoke.py`` of each, in turns, and K3's peak device memory
per call in each.

    python -m crdt_tpu_torch.tools.ab --other build/parent [--order otto] [--out DIR]
                                      [--phase wire]

``--other`` is a checkout of the other tree (``git archive <commit> |
tar -x -C build/parent``; ``build/`` is ignored by git).  ``--order``
names the runs: ``o`` the other tree, ``t`` this one; the default
``otto`` is other, this, this, other.  Each run's full log goes to
``--out`` (default ``build/ab``).  Per run the script prints each
kernel's device ms (the ``kernels`` line), the fold's mean wall ms per
chunk and merges/s, and K3's peak device memory per call above its
inputs (one fold of the 62,500-object main-path chunk, measured by
``torch.cuda.max_memory_allocated`` in a separate process); then the
card's name and power limit, and one JSON line last.

``--phase wire`` runs only ``chip_smoke.py``'s phase 6 (the wire leg,
after the kernels' build) in each tree, and reports each loop mode's
merges/s end to end per run instead.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# K3 once on the main path's first-chunk shapes, in the tree it runs in
PROBE = r"""
import json, numpy as np, torch
from crdt_tpu_torch.ops import orswot_tile as tile
from crdt_tpu_torch.utils.testdata import build_fleet_planes, fleet_columns
A, M, D, R, N = 64, 16, 2, 8, 62_500
cols = fleet_columns(np.random.RandomState(3), N, A, M, D, R, base=6, novel=1,
                     deferred_frac=0.25)
st = build_fleet_planes(cols, a=A, m_cap=M, d=D, base=6, novel=1, device=torch.device("cuda"))
out = tile.fold_merge(*st, M, D, prebiased=True)  # build and warm up
del out
torch.cuda.synchronize()
before = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
out = tile.fold_merge(*st, M, D, prebiased=True)
torch.cuda.synchronize()
print(json.dumps({"k3_peak_bytes": torch.cuda.max_memory_allocated() - before}))
"""


# chip_smoke.py's phase 6 alone, in the tree it runs in
WIRE = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke
from crdt_tpu_torch import _build
_build.build_all()
chip_smoke.wire_leg(torch.device("cuda", 0), chip_smoke.card_line())
"""


def _run_wire(tree: Path, log: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", WIRE], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    log.write_text(proc.stdout + proc.stderr)
    rates = re.findall(r"loop ([\w ,]+): per round .*?; ([\d.]+)M merges/s", proc.stdout)
    return {"rc": proc.returncode, "merges_per_s_M": {k: float(v) for k, v in rates}}


def _run(tree: Path, log: Path) -> dict:
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
                          text=True, timeout=1200)
    log.write_text(proc.stdout + proc.stderr)
    row = {"rc": proc.returncode}
    for line in proc.stdout.splitlines():
        if line.startswith('{"kernels"'):
            row["ms"] = {k["name"]: k["ms"] for k in json.loads(line)["kernels"]}
        m = re.search(r"mean fold ([\d.]+) ms/chunk .*?, ([\d.]+)M merges/s", line)
        if m:
            row["fold_ms"], row["merges_per_s_M"] = float(m.group(1)), float(m.group(2))
    probe = subprocess.run([sys.executable, "-c", PROBE], cwd=tree, capture_output=True,
                           text=True, timeout=600)
    lines = probe.stdout.strip().splitlines()
    row["k3_peak_bytes"] = json.loads(lines[-1])["k3_peak_bytes"] if probe.returncode == 0 \
        and lines else None
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--order", default="otto")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab")
    ap.add_argument("--phase", choices=("all", "wire"), default="all")
    args = ap.parse_args(argv)
    run = _run_wire if args.phase == "wire" else _run
    out_dir = args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"o": args.other.resolve(), "t": ROOT}
    rows = []
    for i, key in enumerate(args.order):
        row = {"run": i, "tree": "other" if key == "o" else "this",
               **run(trees[key], out_dir / f"{i}_{key}.log")}
        rows.append(row)
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"ab": rows, "card": card}))
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
