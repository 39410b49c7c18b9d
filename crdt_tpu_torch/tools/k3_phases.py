#!/usr/bin/env python3
"""Where the sequential fold kernel (K3, ``csrc/orswot_fold.cu``) spends
its cycles, phase by phase, on one CUDA card.

    python -m crdt_tpu_torch.tools.k3_phases [--iters 5] [--chunk 62500]

Builds the kernel twice: as the package builds it, and with
``-DORSWOT_PHASE_CLOCKS``, which compiles ``clock64()`` stamps in at the
phase boundaries of every staged merge (member alignment; deferred dedup
with the clock join and the still-ahead test; dot rule and replay; rank;
member store; deferred pack) and of the fold around them (waiting for a
staged replica; releasing stages and issuing their refills; the
plunger's copy of the accumulator), and sums each warp's cycles per phase
into a device-wide total.  Both builds fold the north-star chunk (A=64,
M=16, D=2, R=8, the fleets ``chip_smoke.py`` times) and must agree bit
for bit; the script then prints each phase's share of the stamped
cycles, both builds' times by CUDA events, the card's name and power
limit, and one JSON line last.
"""

from __future__ import annotations

import sys

from .k1_phases import A, D, M, R, measure

PHASES = ("align", "dedup", "rule", "rank", "store", "pack", "wait", "issue", "copy")


def main(argv=None) -> int:
    from crdt_tpu_torch.ops import orswot_tile as tile
    from crdt_tpu_torch.ops.orswot_tile import _ptrs

    def launch_stamped(lib, st, out, n, stream):
        if tile.fold_merge_plan(st, M, D)["route"] == "direct":
            raise AssertionError("the north-star chunk should take a staged route")
        return lib.orswot_fold_launch(*_ptrs(st), *_ptrs(out), None, R, n, A, M, D, M, D, 1,
                                      stream)

    return measure("orswot_fold", PHASES, launch_stamped,
                   lambda st: tile.fold_merge(*st, M, D, prebiased=True), "K3", argv)


if __name__ == "__main__":
    sys.exit(main())
