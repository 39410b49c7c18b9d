#!/usr/bin/env python3
"""Display forms through the port: the port of ``examples/pprint.py``.

    python -m crdt_tpu_torch.tools.pprint [--device cuda|cpu]

A VClock and a multi-value register with two concurrent writers, shown in
their Display forms by the port's scalar engine, then a small ORSWOT
fleet packed onto ``--device`` (``OrswotBatch.from_scalar``), unpacked
(``to_scalar``) and printed object by object.
"""

from __future__ import annotations

import argparse
import sys

from . import say


def lines(device) -> list:
    """The lines the tool prints."""
    from ..batch import OrswotBatch
    from ..config import CrdtConfig
    from ..scalar import MVReg, Orswot, VClock
    from ..utils.interning import Universe

    vclock = VClock()
    for actor, counter in ((31231, 2), (4829, 9), (87132, 32)):
        vclock.witness(actor, counter)
    reg = MVReg()
    ops = [reg.set(val, reg.read().derive_add_ctx(actor))
           for val, actor in (("some val", 9742820), ("some other val", 648572))]
    for op in ops:  # two concurrent writers: both values stay visible
        reg.apply(op)
    out = [f"vclock:\t{vclock}", f"reg:\t{reg}"]

    uni = Universe(CrdtConfig(num_actors=4, member_capacity=8, deferred_capacity=4))
    fleet = []
    for items in (["apple", "pear"], ["plum"]):
        s = Orswot()
        for actor, member in enumerate(items):
            s.apply(s.add(member, s.value().derive_add_ctx(actor)))
        fleet.append(s)
    batch = OrswotBatch.from_scalar(fleet, uni, device=device)
    for i, scalar in enumerate(batch.to_scalar(uni)):
        out.append(f"orswot[{i}]:\t{{{', '.join(sorted(map(str, scalar.value().val)))}}}")
    return out


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    for line in lines(resolve_device(ap.parse_args(argv).device)):
        say(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
