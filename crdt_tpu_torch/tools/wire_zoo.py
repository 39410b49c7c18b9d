#!/usr/bin/env python3
"""Every type family with a wire leg through the port's codec: the port of
``examples/wire_zoo.py``.

    python -m crdt_tpu_torch.tools.wire_zoo [--device cuda|cpu]

Sites A and B each build divergent fleets of N=4 objects of GCounter,
PNCounter, VClock, GSet, LWWReg, MVReg, ORSWOT, ``Map<K, MVReg>`` and
``Map<K, Orswot>`` with the port's scalar engine, exchange ``to_binary``
blobs, decode them with ``from_wire`` onto ``--device`` and ``merge``
them there (on a card the ORSWOT merge and the nested sets of
``Map<K, Orswot>`` take the merge kernel), and hold the result against
the scalar merge: equal states, and ``to_wire`` byte-identical to
``to_binary`` of the scalar result.  Counters are 32-bit, the merge
kernel's width.  The last line is the tools' JSON evidence line
(:func:`crdt_tpu_torch.tools.evidence`).
"""

from __future__ import annotations

import argparse
import sys

from . import evidence, say

N = 4  # objects per fleet: the printout stays readable


def build_sites() -> tuple:
    """(site_a, site_b): per family, a fleet of scalars with the actor's
    own ops."""
    from ..scalar import GCounter, GSet, LWWReg, Map, MVReg, Orswot, PNCounter, VClock

    def counted(cls, actor, steps, dec):
        out = []
        for i in range(N):
            c = cls()
            for _ in range(steps(i)):
                c.apply(c.inc(actor))
            if dec and i % 2:
                c.apply(c.dec(actor))
            out.append(c)
        return out

    def mvreg(actor, i):
        r = MVReg()
        r.apply(r.set(actor * 100 + i, r.read().derive_add_ctx(actor)))
        return r

    def orswot(actor, i):
        s = Orswot()
        s.apply(s.add(actor * 10 + i, s.value().derive_add_ctx(actor)))
        return s

    def gset(actor, i):
        s = GSet()
        s.insert(actor * 10 + i)
        return s

    def nested(val_type, actor, i, up):
        m = Map(val_type)
        m.apply(m.update(i, m.get(i).derive_add_ctx(actor), up))
        return m

    def site(a):
        return {
            "GCounter": counted(GCounter, a, lambda i: i + 1, False),
            "PNCounter": counted(PNCounter, a, lambda i: i + a + 1, True),
            "VClock": [VClock({a: i + 1}) for i in range(N)],
            "GSet": [gset(a, i) for i in range(N)],
            # markers are globally unique timestamps; the actor breaks ties
            "LWWReg": [LWWReg(val=a * 100 + i, marker=2 * i + a) for i in range(N)],
            "MVReg": [mvreg(a, i) for i in range(N)],
            "Orswot": [orswot(a, i) for i in range(N)],
            "Map<K,MVReg>": [nested(MVReg, a, i, lambda v, c, _v=a * 100 + i: v.set(_v, c))
                             for i in range(N)],
            "Map<K,Orswot>": [nested(Orswot, a, i, lambda v, c, _m=a * 10 + i: v.add(_m, c))
                              for i in range(N)],
        }

    return site(1), site(2)


def run(device) -> dict:
    """Both sites' exchange and merge, family by family; returns
    ``{family: merged blobs}``."""
    from ..batch import (
        GCounterBatch, GSetBatch, LWWRegBatch, MapBatch, MVRegBatch, MVRegKernel, OrswotBatch,
        OrswotKernel, PNCounterBatch, VClockBatch,
    )
    from ..config import CrdtConfig
    from ..utils.interning import Universe
    from ..utils.serde import to_binary

    cfg = CrdtConfig(num_actors=4, member_capacity=8, deferred_capacity=4, mv_capacity=4,
                     key_capacity=4, counter_bits=32)
    uni = Universe.identity(cfg)
    decode = {
        "GCounter": lambda b: GCounterBatch.from_wire(b, uni, device=device),
        "PNCounter": lambda b: PNCounterBatch.from_wire(b, uni, device=device),
        "VClock": lambda b: VClockBatch.from_wire(b, uni, device=device),
        "GSet": lambda b: GSetBatch.from_wire(b, uni, 64, device=device),
        "LWWReg": lambda b: LWWRegBatch.from_wire(b, uni, device=device),
        "MVReg": lambda b: MVRegBatch.from_wire(b, uni, device=device),
        "Orswot": lambda b: OrswotBatch.from_wire(b, uni, device=device),
        "Map<K,MVReg>": lambda b: MapBatch.from_wire(b, uni, MVRegKernel.from_config(cfg),
                                                     device=device),
        "Map<K,Orswot>": lambda b: MapBatch.from_wire(b, uni, OrswotKernel.from_config(cfg),
                                                      device=device),
    }
    site_a, site_b = build_sites()
    merged = {}
    for name, fleet_a in site_a.items():
        # what would cross the socket, merged by each side on the device
        wire_a = [to_binary(s) for s in fleet_a]
        wire_b = [to_binary(s) for s in site_b[name]]
        ba = decode[name](wire_b).merge(decode[name](wire_a))
        bb = decode[name](wire_a).merge(decode[name](wire_b))
        oracle = []
        for sa, sb in zip(fleet_a, site_b[name]):
            sa.merge(sb)
            oracle.append(sa)
        assert ba.to_scalar(uni) == bb.to_scalar(uni) == oracle, f"{name}: divergence"
        # egress byte-identical to the scalar encoder: any peer can decode it
        merged[name] = ba.to_wire(uni)
        assert merged[name] == [to_binary(s) for s in oracle], f"{name}: not byte-faithful"
        say(f"{name:>14}: converged, byte-faithful "
              f"({sum(map(len, wire_a)) + sum(map(len, wire_b))} wire bytes)")
    say("wire zoo: all", len(site_a), "type families converged")
    return merged


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    run(resolve_device(ap.parse_args(argv).device))
    evidence("wire_zoo")
    return 0


if __name__ == "__main__":
    sys.exit(main())
