"""One rank of the port's mesh layer, for ``test_torch_mesh.py``.

    python tests/torch_rank_mesh.py DIR RANK WORLD

Joins a gloo process group of WORLD ranks through a ``FileStore`` at
``DIR/store``, reads the fleets from ``DIR/in.npz`` (unsigned numpy
planes) and runs, on an ``objects`` mesh of WORLD ranks, the mesh step
at every shard count of ``MESH_SIZES`` that WORLD divides and a
shard-subset sync of the gathered logical fleets; then, on a ``members``
mesh, the member-sharded merge, add and clock rebroadcast over 8 member
shards, and a merge that overflows one shard.  It writes this rank's
part of each result (or the error it raised) to ``DIR/out<RANK>.npz``.

It imports neither ``jax`` nor ``crdt_tpu``: the test holds its output
against the JAX package in the pytest process.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
from crdt_tpu_torch.dtypes import bias_np
from crdt_tpu_torch.mesh import (
    MESH_SIZES, ShardedBatch, anti_entropy_step, shard_roots, shard_subset_sync,
)
from crdt_tpu_torch.parallel import (
    initialize, local_shard, make_mesh, member_sharded_merge, partition_dense,
    rebroadcast_clock, sharded_apply_add,
)
from crdt_tpu_torch.parallel.collective import _planes

#: member sharding: shards, per-shard member and deferred capacities
M_SHARDS, M_CAP_SHARD, D_CAP_SHARD = 8, 16, 4


def planes(inp, key):
    return [inp[f"{key}/{i}"] for i in range(5)]


def put(out, key, arrays):
    for i, x in enumerate(arrays):
        out[f"{key}/{i}"] = np.asarray(x)


def attempt(out, key, fn):
    """``fn()``'s arrays under ``key``, or the error it raised under
    ``key/err``: its class, and an overflow's member and deferred flags."""
    try:
        put(out, key, fn())
    except Exception as e:  # the test compares the error with the JAX package's
        flags = [getattr(e, "member", None), getattr(e, "deferred", None)]
        out[f"{key}/err"] = np.array(f"{type(e).__name__} {flags}")


def universe(inp, key):
    a, m, d = (int(x) for x in inp[key])
    return Universe.identity(CrdtConfig(num_actors=a, member_capacity=m, deferred_capacity=d))


def step_cases(inp, out, world):
    uni, mesh = universe(inp, "cfg"), make_mesh({"objects": world}, device="cpu")
    a, b = (OrswotBatch.from_numpy(*planes(inp, k), device="cpu") for k in ("a", "b"))
    for s in MESH_SIZES:
        if s % world:
            continue
        sa, sb = (ShardedBatch.shard(x, uni, shards=s, mesh=mesh, granule=int(inp["granule"]))
                  for x in (a, b))

        def step(sa=sa, sb=sb):
            res = anti_entropy_step(sa, sb)
            lay = sa.layout
            return [res.digests, res.version_vector, np.array(res.live_members),
                    shard_roots(res.digests, lay, "cpu"), *res.batch.device.to_numpy(),
                    np.array([lay.n, lay.shards, lay.granule, lay.per_shard, lay.imbalance]),
                    *res.batch.logical().to_numpy()]
        attempt(out, f"step{s}", step)
    s = max(4, world)
    sa, sb = (ShardedBatch.shard(OrswotBatch.from_numpy(*planes(inp, k), device="cpu"), uni,
                                 shards=s, mesh=mesh, granule=8) for k in ("sync_a", "sync_b"))

    def subset():
        merged, st = shard_subset_sync(sa.logical(), sb.logical(), sa.layout, uni)
        return [np.array([st.shards_synced, st.shards_skipped, st.objects, st.root_bytes,
                          st.descent_bytes, st.delta_bytes]), st.object_ids,
                np.array(sorted(st.per_shard)), *merged.to_numpy()]
    attempt(out, "subset", subset)


def member_cases(inp, out, rank, world):
    mesh = make_mesh({"members": world}, device="cpu")
    rows = local_shard(M_SHARDS, world, rank)

    def state(key, m_cap=M_CAP_SHARD):
        parts = partition_dense(*planes(inp, key), M_SHARDS, m_cap, D_CAP_SHARD)
        return _planes(OrswotBatch.from_numpy(*(p[rows] for p in parts), device="cpu"))

    def merged():
        return member_sharded_merge(state("ma"), state("mb"), mesh)
    attempt(out, "member_merge", lambda: OrswotBatch(*merged()).to_numpy())

    def add():
        dt = state("ma")[0].dtype
        cnt = torch.from_numpy(bias_np(inp["add/counter"].astype(
            np.uint64 if dt == torch.int64 else np.uint32)))
        return OrswotBatch(*sharded_apply_add(
            merged(), torch.from_numpy(inp["add/actor"]), cnt, torch.from_numpy(inp["add/member"]),
            mesh)).to_numpy()
    attempt(out, "member_add", add)
    attempt(out, "member_clock", lambda: OrswotBatch(*rebroadcast_clock(
        state("ma"), mesh)).to_numpy())
    attempt(out, "member_over", lambda: OrswotBatch(*member_sharded_merge(
        state("oa", 2), state("ob", 2), mesh)).to_numpy())


def run(path: str, rank: int, world: int, store=None) -> dict:
    torch.set_num_threads(1)
    initialize(num_processes=world, process_id=rank,
               store=store or dist.FileStore(os.path.join(path, "store"), world))
    inp, out = dict(np.load(os.path.join(path, "in.npz"))), {}
    try:
        step_cases(inp, out, world)
        member_cases(inp, out, rank, world)
    finally:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    result = run(path, rank, world)
    assert "jax" not in sys.modules and "crdt_tpu" not in sys.modules, "a rank imported JAX"
    np.savez(os.path.join(path, f"out{rank}.npz"), **result)
