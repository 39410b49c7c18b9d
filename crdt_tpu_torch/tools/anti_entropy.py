#!/usr/bin/env python3
"""The anti-entropy walkthrough on the port: the port of
``examples/anti_entropy.py``'s nine steps.

    python -m crdt_tpu_torch.tools.anti_entropy [--device cuda|cpu]

1. op-based replication between scalar replicas over ``to_binary`` bytes;
2. a causally-future remove buffered in the deferred table, resolved by
   anti-entropy;
3. eight replica fleets of 256 objects joined on ``--device``
   (``OrswotBatch.join_fleet``; the merge kernel on a card);
4. the same join as a collective, one replica per rank;
5. the LWW and MVReg collective joins;
6. elastic regrowth of an overflowing join (``JoinExecutor``);
7. 2,000 wire blobs decoded onto the device, merged, encoded back
   byte-identical to the scalar codec;
8. the same traffic through ``PipelinedWireLoop``, every replica's
   digest vector converged;
9. causal GC of a regrown fleet, its digest vector unchanged.

Steps 4 and 5 need eight replicas, and the port holds one per rank: they
run over eight ranks, gloo ranks on the CPU or one NCCL rank per card,
spawned as ``tools.multihost`` spawns them; with fewer than eight cards
they print the JAX example's skip line.  The last line is the tools'
JSON evidence line (:func:`crdt_tpu_torch.tools.evidence`).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import evidence, say

RANKS = 8


def step1_op_replication():
    """Three replicas exchanging serialized ops (no shared memory)."""
    from ..scalar import Orswot
    from ..utils.serde import from_binary, to_binary

    replicas = {name: Orswot() for name in ("alice", "bob", "carol")}

    def broadcast(op):
        wire = to_binary(op)  # what would cross the network
        for r in replicas.values():
            r.apply(from_binary(wire))

    a, b = replicas["alice"], replicas["bob"]
    broadcast(a.add("apple", a.value().derive_add_ctx("alice")))
    broadcast(b.add("pear", b.value().derive_add_ctx("bob")))
    assert {frozenset(r.value().val) for r in replicas.values()} == {frozenset({"apple",
                                                                                 "pear"})}
    say("1. op replication over the wire:", sorted(a.value().val))
    return replicas


def step2_deferred_remove(replicas):
    """A remove whose context is causally ahead buffers, then resolves."""
    from ..scalar import Orswot

    carol, bob = replicas["carol"], replicas["bob"]
    ctx = carol.contains("apple").derive_rm_ctx()
    ctx.clock.witness("dave", 1)  # dave's write has not reached carol yet
    bob.apply(carol.remove("apple", ctx))
    assert len(bob.deferred) == 1  # buffered, not lost
    dave = Orswot()
    dave.apply(dave.add("fig", dave.value().derive_add_ctx("dave")))
    bob.merge(dave)
    bob.merge(Orswot())  # the defer plunger
    assert "apple" not in bob.value().val and "fig" in bob.value().val
    say("2. deferred remove resolved after anti-entropy:", sorted(bob.value().val))


def replica_fleets(device):
    """Step 3's eight fleets of 256 objects (every rank builds all eight, so
    the universe interns alike everywhere)."""
    from ..batch import OrswotBatch
    from ..config import CrdtConfig
    from ..scalar import Orswot
    from ..utils.interning import Universe

    rng = np.random.RandomState(0)
    uni = Universe(CrdtConfig(num_actors=8, member_capacity=16, deferred_capacity=4,
                              counter_bits=32))
    fleets = []
    for r in range(RANKS):
        row = []
        for i in range(256):
            s = Orswot()
            for j in range(int(rng.randint(1, 5))):
                s.apply(s.add(f"item{(i * 7 + j * 3) % 11}", s.value().derive_add_ctx(f"node{r}")))
            row.append(s)
        fleets.append(OrswotBatch.from_scalar(row, uni, device=device))
    return uni, fleets


def step3_batched_join(device):
    from ..batch import OrswotBatch

    uni, fleets = replica_fleets(device)
    sets = OrswotBatch.join_fleet(fleets).value_sets(uni)  # a log-depth pairwise tree
    say(f"3. batched join: {len(fleets)} fleets × 256 objects → e.g. object 0 = "
          f"{sorted(sets[0])}")


def collective_steps(rank: int, device) -> None:
    """Steps 4 and 5 on one rank of eight; rank 0 prints their lines."""
    from ..batch import LWWRegBatch, MVRegBatch, OrswotBatch
    from ..config import CrdtConfig
    from ..parallel import allgather_join_lww, allgather_join_mvreg, allgather_join_orswot
    from ..parallel import make_mesh
    from ..scalar import LWWReg, MVReg
    from ..utils.interning import Universe

    mesh = make_mesh({"replicas": RANKS}, device=device.type)
    uni, fleets = replica_fleets(device)
    joined = allgather_join_orswot(fleets[rank], mesh)
    assert joined.value_sets(uni) == OrswotBatch.join_fleet(fleets).value_sets(uni)
    out = say if rank == 0 else (lambda *a: None)
    out(f"4. collective join over a {RANKS}-device mesh axis matches the batched join on "
        "every shard")

    uni = Universe(CrdtConfig(num_actors=8, mv_capacity=8))
    # LWW: each replica last-wrote one register at its own time
    lww = [LWWRegBatch.from_scalar([LWWReg(val=f"edit-{r}", marker=100 + r)], uni,
                                   device=device) for r in range(RANKS)]
    got, conflict = allgather_join_lww(lww[rank], mesh)
    assert not bool(conflict.any())
    winner = got.to_scalar(uni)[0]
    assert winner.val == "edit-7"  # the largest marker wins everywhere
    # MVReg: eight concurrent writers, all eight values survive the join
    regs = []
    for r in range(RANKS):
        reg = MVReg()
        reg.apply(reg.set(f"draft-{r}", reg.read().derive_add_ctx(r)))
        regs.append(MVRegBatch.from_scalar([reg], uni, device=device))
    survivors = allgather_join_mvreg(regs[rank], mesh).to_scalar(uni)[0]
    assert len(survivors.read().val) == RANKS
    out(f"5. typed collective joins: LWW marker-argmax winner {winner.val!r}; MVReg keeps all "
        f"{len(survivors.read().val)} concurrent values")


def step6_elastic_regrowth(device):
    """An overflowing join regrows the padded axes and requeues."""
    from ..batch import OrswotBatch
    from ..config import CrdtConfig
    from ..parallel import JoinExecutor, JoinStats
    from ..scalar import Orswot
    from ..utils.interning import Universe

    uni = Universe(CrdtConfig(num_actors=8, member_capacity=2, deferred_capacity=2,
                              counter_bits=32))
    fleets = []
    for r in range(4):
        s = Orswot()
        for j in range(2):
            s.apply(s.add(f"m{r}-{j}", s.value().derive_add_ctx(f"node{r}")))
        fleets.append(OrswotBatch.from_scalar([s], uni, device=device))
    stats = JoinStats()
    sets = JoinExecutor().join_all(fleets, stats=stats).value_sets(uni)
    assert len(sets[0]) == 8  # the union exceeded capacity 2, nothing lost
    say(f"6. elastic regrowth: capacity 2 → {stats.final_member_capacity} after "
          f"{stats.overflow_regrows} regrow(s); all {len(sets[0])} members survived")


def step7_bulk_wire_loop(device):
    """Blobs decoded straight into planes by the host codec, merged on the
    device, encoded back byte-identical to ``to_binary``."""
    from ..batch import OrswotBatch
    from ..config import CrdtConfig
    from ..scalar import Orswot
    from ..utils.interning import Universe
    from ..utils.serde import from_binary, to_binary

    rng = np.random.RandomState(7)
    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=8, member_capacity=8,
                                                   deferred_capacity=4))
    n, incoming = 2000, []
    for _ in range(n):
        s = Orswot()
        for j in range(int(rng.randint(1, 4))):
            s.apply(s.add(int(rng.randint(0, 100)), s.value().derive_add_ctx(j % 4)))
        incoming.append(to_binary(s))
    local = OrswotBatch.from_wire(incoming, uni, device=device)
    merged = local.merge(OrswotBatch.zeros(n, uni, device=device))  # the device picks the impl
    outgoing = merged.to_wire(uni)
    assert outgoing[:64] == [to_binary(s) for s in merged.to_scalar(uni)[:64]]
    assert from_binary(outgoing[0]).value().val == from_binary(incoming[0]).value().val
    say(f"7. bulk wire loop: {n} blobs in -> device merge -> {n} blobs out, byte-identical "
          "to the scalar codec")
    return uni, n, incoming


def step8_pipelined_wire_loop(uni, n, incoming, device):
    """Step 7's traffic through the pipelined loop; every replica that
    merges its output lands on one digest vector."""
    from ..batch import OrswotBatch, PipelinedWireLoop
    from ..sync import digest_of
    from ..utils.serde import from_binary, to_binary

    res = PipelinedWireLoop(uni, device=device).run([[incoming, incoming]])
    (out,) = res["out_blobs"]  # the one chunk's blobs
    acc = from_binary(incoming[0])
    acc.merge(from_binary(incoming[0]))
    acc.merge(acc.clone())
    assert out[0] == to_binary(acc)
    folded = OrswotBatch.from_wire(out, uni, device=device)
    want = digest_of(folded, uni)
    for r in range(2):
        replica = OrswotBatch.from_wire(incoming, uni, device=device).merge(folded)
        replica = replica.merge(replica)  # the defer plunger
        assert np.array_equal(digest_of(replica, uni), want), \
            f"replica {r} digest vector diverged after anti-entropy"
    say(f"8. pipelined wire loop ({res['fold_path']} fold, {res['pipeline']}): "
          f"{res['merges']} replica-objects in {res['e2e_s']:.3f}s, ingest "
          f"native_fraction={res['ingest_native_fraction']}; all replica digest vectors "
          "converged")


def step9_causal_gc(uni, n, incoming, device):
    """GC settles and re-packs a regrown fleet; the digests stay."""
    from ..batch import OrswotBatch
    from ..gc import GcEngine, GcPolicy
    from ..sync import digest_of

    fleet = OrswotBatch.from_wire(incoming, uni, device=device)
    fleet = fleet.merge(fleet)  # the canonical (plunged) form
    cfg = uni.config
    fleet = fleet.with_capacity(cfg.member_capacity * 4, cfg.deferred_capacity * 4)
    before = digest_of(fleet, uni)
    bytes_before = sum(x.numel() * x.element_size() for x in (
        fleet.clock, fleet.ids, fleet.dots, fleet.d_ids, fleet.d_clocks))
    compacted, report = GcEngine(GcPolicy(interval_rounds=1)).collect(fleet, universe=uni)
    assert np.array_equal(before, digest_of(compacted, uni)), \
        "causal GC changed the digest vector"
    assert report.reclaimed_bytes > 0 and report.shrunk
    say(f"9. causal GC: member capacity {report.member_capacity[0]} -> "
          f"{report.member_capacity[1]}, {report.reclaimed_bytes} of {bytes_before} plane bytes "
          "reclaimed; digest vector byte-identical before/after")


def collective_joins(device) -> None:
    """Steps 4 and 5 over eight ranks, or the skip lines."""
    import torch

    from .multihost import spawn_ranks

    have = torch.cuda.device_count() if device.type == "cuda" else RANKS
    if have < RANKS:
        say(f"4. collective join skipped ({have} devices < {RANKS})")
        say(f"5. typed collective joins skipped ({have} devices < {RANKS})")
        return
    if spawn_ranks("crdt_tpu_torch.tools.anti_entropy", RANKS, ["--device", device.type]):
        raise RuntimeError("a rank of the collective joins failed")


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    from ..parallel import initialize
    from .multihost import rank_device

    torch.set_num_threads(1)
    dev = rank_device(args.device, args.rank)
    initialize(num_processes=RANKS, process_id=args.rank,
               store=dist.FileStore(args.store, RANKS))
    try:
        collective_steps(args.rank, dev)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    device = resolve_device(args.device)
    step2_deferred_remove(step1_op_replication())
    step3_batched_join(device)
    collective_joins(device)
    step6_elastic_regrowth(device)
    uni, n, incoming = step7_bulk_wire_loop(device)
    step8_pipelined_wire_loop(uni, n, incoming, device)
    step9_causal_gc(uni, n, incoming, device)
    say("anti-entropy walkthrough: OK")
    evidence("anti_entropy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
