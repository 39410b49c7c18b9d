#!/usr/bin/env python3
"""A lattice join across processes: the ranks of one process group join
ORSWOT fleets through ``crdt_tpu_torch.parallel``.

    python -m crdt_tpu_torch.tools.multihost [--device cuda|cpu] [--ranks R]
                                             [--topology replicas|hybrid] [--objects 8]

``--device cuda`` (the default) runs one NCCL rank per visible card (by
default as many ranks as cards; more are refused before anything is
spawned); ``--device cpu`` runs gloo ranks (default 2).  Spawns
``--ranks`` processes that rendezvous through a ``FileStore`` in a
temporary directory, each holding one replica of the same objects:

* ``replicas`` — every rank is one replica of every object, so the join's
  all-gather crosses every process boundary;
* ``hybrid`` — ``make_multihost_mesh({"replicas": ranks // 2},
  {"objects": 2})``: the objects split across the leading (DCN) dim, with
  no join traffic between the halves, and each half's replicas join over
  the trailing dim (``object_axis="objects"``).

Each rank holds its join against the scalar N-way merge of every
replica (the fleets are seeded, so any rank can rebuild them) and prints
``MULTIHOST OK``; the launcher exits nonzero if a rank failed or did not
finish in time.  The universe is ``Universe.identity``: planes built in
different processes meet in the join, so the interning must be shared
(:mod:`crdt_tpu_torch.parallel.multihost`).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from . import run_all, say

JOIN_TIMEOUT_S = 120.0


def spawn_ranks(module: str, ranks: int, args: list, timeout_s: float = JOIN_TIMEOUT_S) -> int:
    """Run ``python -m module *args --store S --rank r`` for every rank at
    once (one ``FileStore`` rendezvous in a temporary directory) and return
    0 if every rank exited 0, else 1; a rank still running after
    ``timeout_s`` is killed and fails the run."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", module, *args, "--store", os.path.join(tmp, "store")]
        done, _ = run_all([cmd + ["--rank", str(r)] for r in range(ranks)], timeout_s)
    return int(any(rc != 0 for rc, *_ in done))


def rank_device(name: str, rank: int):
    """This rank's device: its own card for ``cuda`` (one rank per card)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    return dev


def fleet_row(replica: int, n_objects: int) -> list:
    """Replica ``replica``'s scalar ORSWOTs, seeded by the replica: adds by
    actor ``replica``."""
    import numpy as np

    from ..scalar import Orswot

    rng = np.random.RandomState(1000 + replica)
    row = []
    for _ in range(n_objects):
        o = Orswot()
        for _ in range(int(rng.randint(1, 4))):
            o.apply(o.add(int(rng.randint(0, 12)), o.value().derive_add_ctx(replica)))
        row.append(o)
    return row


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    from .. import _build
    from ..batch import OrswotBatch
    from ..config import CrdtConfig
    from ..parallel import allgather_join_orswot, initialize, local_shard, make_multihost_mesh
    from ..scalar import Orswot
    from ..utils.interning import Universe

    torch.set_num_threads(1)
    dev = rank_device(args.device, args.rank)
    topo = initialize(num_processes=args.ranks, process_id=args.rank,
                      store=dist.FileStore(args.store, args.ranks))
    # 32-bit counters: on a card every merge takes the merge kernel
    uni = Universe.identity(CrdtConfig(num_actors=8, member_capacity=16, deferred_capacity=8,
                                       counter_bits=32))
    if args.topology == "replicas":
        mesh = make_multihost_mesh({"replicas": args.ranks}, device=dev.type)
        replicas, objects = range(args.ranks), slice(None)
        object_axis = None
    else:
        mesh = make_multihost_mesh({"replicas": args.ranks // 2}, {"objects": 2},
                                   device=dev.type)
        replicas = range(args.ranks // 2)
        objects = local_shard(args.objects, 2, mesh.get_local_rank("objects"))
        object_axis = "objects"
    mine = fleet_row(mesh.get_local_rank("replicas"), args.objects)[objects]
    joined = allgather_join_orswot(OrswotBatch.from_scalar(mine, uni, device=dev), mesh,
                                   object_axis=object_axis)
    expected = [Orswot() for _ in mine]
    for r in replicas:
        for e, o in zip(expected, fleet_row(r, args.objects)[objects]):
            e.merge(o)
    plunged = joined.merge(OrswotBatch.zeros(len(mine), uni, device=dev))
    for e in expected:
        e.merge(Orswot())  # the defer plunger
    if plunged.to_scalar(uni) != expected:
        raise AssertionError(f"rank {args.rank}: the join diverged from the scalar merge")
    dist.destroy_process_group()
    say(f"rank {args.rank}: topology={args.topology} objects={args.objects} "
          f"processes={topo['processes']} MULTIHOST OK "
          f"k2_launches={_build.launch_counts()['orswot_merge']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes (default: one per card on cuda, 2 on cpu)")
    ap.add_argument("--topology", default="replicas", choices=["replicas", "hybrid"])
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    from ..device import resolve_device

    if resolve_device(args.device).type == "cuda":
        import torch

        cards = torch.cuda.device_count()
        if args.ranks is None:
            args.ranks = cards
        elif args.ranks > cards:
            ap.error(f"--ranks {args.ranks} needs {args.ranks} cards, {cards} visible "
                     "(one NCCL rank per card)")
    elif args.ranks is None:
        args.ranks = 2
    if args.ranks < 1 or (args.topology == "hybrid" and args.ranks % 2):
        ap.error("--ranks must be positive, and even for --topology hybrid")
    rc = spawn_ranks("crdt_tpu_torch.tools.multihost", args.ranks, [
        "--device", args.device, "--ranks", str(args.ranks), "--topology", args.topology,
        "--objects", str(args.objects)])
    say("launcher:", "MULTIHOST OK" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
