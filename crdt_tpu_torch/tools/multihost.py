#!/usr/bin/env python3
"""A lattice join across processes, on the CPU: ranks of one gloo
process group join ORSWOT fleets through ``crdt_tpu_torch.parallel``.

    python -m crdt_tpu_torch.tools.multihost [--ranks 2] [--topology replicas|hybrid]
                                             [--objects 8]

Spawns ``--ranks`` processes that rendezvous through a ``FileStore`` in a
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
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JOIN_TIMEOUT_S = 120.0


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

    from ..batch import OrswotBatch
    from ..config import CrdtConfig
    from ..parallel import allgather_join_orswot, initialize, local_shard, make_multihost_mesh
    from ..scalar import Orswot
    from ..utils.interning import Universe

    torch.set_num_threads(1)
    topo = initialize(num_processes=args.ranks, process_id=args.rank,
                      store=dist.FileStore(args.store, args.ranks))
    uni = Universe.identity(CrdtConfig(num_actors=8, member_capacity=16, deferred_capacity=8))
    if args.topology == "replicas":
        mesh = make_multihost_mesh({"replicas": args.ranks}, device="cpu")
        replicas, objects = range(args.ranks), slice(None)
        object_axis = None
    else:
        mesh = make_multihost_mesh({"replicas": args.ranks // 2}, {"objects": 2}, device="cpu")
        replicas = range(args.ranks // 2)
        objects = local_shard(args.objects, 2, mesh.get_local_rank("objects"))
        object_axis = "objects"
    mine = fleet_row(mesh.get_local_rank("replicas"), args.objects)[objects]
    joined = allgather_join_orswot(OrswotBatch.from_scalar(mine, uni, device="cpu"), mesh,
                                   object_axis=object_axis)
    expected = [Orswot() for _ in mine]
    for r in replicas:
        for e, o in zip(expected, fleet_row(r, args.objects)[objects]):
            e.merge(o)
    plunged = joined.merge(OrswotBatch.zeros(len(mine), uni, device="cpu"))
    for e in expected:
        e.merge(Orswot())  # the defer plunger
    if plunged.to_scalar(uni) != expected:
        raise AssertionError(f"rank {args.rank}: the join diverged from the scalar merge")
    dist.destroy_process_group()
    print(f"rank {args.rank}: topology={args.topology} objects={args.objects} "
          f"processes={topo['processes']} MULTIHOST OK", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--topology", default="replicas", choices=["replicas", "hybrid"])
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    if args.ranks < 1 or (args.topology == "hybrid" and args.ranks % 2):
        ap.error("--ranks must be positive, and even for --topology hybrid")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "crdt_tpu_torch.tools.multihost", "--ranks",
               str(args.ranks), "--topology", args.topology, "--objects", str(args.objects),
               "--store", os.path.join(tmp, "store")]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT) for r in range(args.ranks)]
        rc = 0
        try:
            for p in procs:
                rc |= p.wait(timeout=JOIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = 1
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print("launcher:", "MULTIHOST OK" if rc == 0 else "FAILED", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
