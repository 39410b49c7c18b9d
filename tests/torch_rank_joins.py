"""One rank of the port's collective joins, for ``test_torch_collective.py``.

    python tests/torch_rank_joins.py DIR RANK WORLD

Joins a gloo process group of WORLD ranks through a ``FileStore`` at
``DIR/store``, reads the fleets from ``DIR/in.npz`` (unsigned numpy
planes, replica axis first), takes this rank's replica of each, runs
every join of ``crdt_tpu_torch.parallel`` in turn and writes its part of
each result (or the error it raised) to ``DIR/out<RANK>.npz``.  At
WORLD 4 it also runs the 2x2 ``objects`` x ``replicas`` hybrid.

It imports neither ``jax`` nor ``crdt_tpu``: the test holds its output
against the JAX joins in the pytest process.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from crdt_tpu_torch import CrdtConfig, MapBatch, MVRegKernel
from crdt_tpu_torch.batch import (
    GSetBatch, LWWRegBatch, MapKernel, MVRegBatch, OrswotBatch, VClockBatch,
)
from crdt_tpu_torch.batch.map_batch import _leaves, _unflatten, map_planes
from crdt_tpu_torch.obs.fleet import FleetObservatory
from crdt_tpu_torch.obs.metrics import MetricsRegistry
from crdt_tpu_torch.parallel import (
    all_reduce_clock_join, allgather_join_gset, allgather_join_lww, allgather_join_map,
    allgather_join_mvreg, allgather_join_orswot, global_batch_from_local, initialize,
    local_shard, make_mesh, make_multihost_mesh, shard_batch,
)
from crdt_tpu_torch.parallel.collective import (
    allgather_fleet_snapshots, shard_local_pairwise_merge,
)
from crdt_tpu_torch.utils.interning import Universe

CFG = CrdtConfig(num_actors=8, member_capacity=16, deferred_capacity=8)
MAP_KERNEL = MapKernel.from_config(CFG, MVRegKernel.from_config(CFG))


def planes(inp, key, rows):
    """The planes stored under ``key/0``, ``key/1``, ... at ``rows``."""
    out, i = [], 0
    while f"{key}/{i}" in inp:
        out.append(inp[f"{key}/{i}"][rows])
        i += 1
    return out


def put(out, key, arrays):
    for i, x in enumerate(arrays):
        out[f"{key}/{i}"] = np.asarray(x)


def attempt(out, key, fn):
    """``fn()``'s arrays under ``key``, or the error it raised under
    ``key/err``: its class, and an overflow's member and deferred flags."""
    try:
        put(out, key, fn())
    except Exception as e:  # the test compares the error with the JAX join's
        flags = [getattr(e, "member", None), getattr(e, "deferred", None)]
        out[f"{key}/err"] = np.array(f"{type(e).__name__} {flags}")


def fleet_frame(rank: int, world: int, mesh) -> list:
    """Every rank's observatory gathered; returns the frame this rank
    sent and the merged snapshot, both encoded."""
    from crdt_tpu_torch.obs.fleet import encode_snapshot

    reg = MetricsRegistry()
    reg.counter_inc("rank_ops", 100 + rank)
    obs = FleetObservatory(f"rank{rank}", registry=reg)
    sent = []
    encode = obs.encode
    obs.encode = lambda **kw: sent.append(encode(**kw)) or sent[-1]
    merged = allgather_fleet_snapshots(obs)
    return [np.frombuffer(sent[0], np.uint8), np.frombuffer(encode_snapshot(merged), np.uint8)]


def run(path: str, rank: int, world: int, store=None) -> dict:
    torch.set_num_threads(1)
    initialize(num_processes=world, process_id=rank,
               store=store or dist.FileStore(os.path.join(path, "store"), world))
    inp = dict(np.load(os.path.join(path, "in.npz")))
    me, out = slice(rank, rank + 1), {}
    mesh = make_mesh({"replicas": world}, device="cpu")

    attempt(out, "clock", lambda: [VClockBatch(all_reduce_clock_join(
        VClockBatch.from_numpy(inp["clock"][me][0], device="cpu").clocks[None], mesh)[0]
    ).to_numpy()[None]])
    for key, lead in (("orswot", True), ("orswot32", False), ("over", True)):
        def orswot_join(key=key, lead=lead, check=True, impl=None):
            batch = OrswotBatch.from_numpy(*planes(inp, key, me if lead else rank),
                                           device="cpu")
            return allgather_join_orswot(batch, mesh, check=check, impl=impl).to_numpy()
        attempt(out, key, orswot_join)
        attempt(out, key + "_unchecked", lambda f=orswot_join: f(check=False))
    attempt(out, "orswot32_unrolled", lambda: orswot_join("orswot32", True, impl="unrolled"))

    template = map_planes([], Universe(CFG), MAP_KERNEL.val_kernel)

    def map_join():
        state = _unflatten(template, iter(planes(inp, "map", me)))
        batch = MapBatch.from_numpy(*state, MAP_KERNEL, device="cpu")
        return _leaves(allgather_join_map(batch, mesh).to_numpy())
    attempt(out, "map", map_join)

    for key, check in (("lww", True), ("lwwc", True), ("lwwc_unchecked", False)):
        def lww_join(key=key, check=check):
            batch = LWWRegBatch.from_numpy(*planes(inp, key.split("_")[0], rank), device="cpu")
            joined, conflict = allgather_join_lww(batch, mesh, check=check)
            return [*joined.to_numpy(), conflict.numpy()]
        attempt(out, key, lww_join)
    for key in ("mvreg", "mvo"):
        attempt(out, key, lambda key=key: allgather_join_mvreg(MVRegBatch.from_numpy(
            *planes(inp, key, me), device="cpu"), mesh).to_numpy())
    attempt(out, "gset", lambda: [allgather_join_gset(GSetBatch.from_numpy(
        planes(inp, "gset", rank)[0], device="cpu"), mesh).to_numpy()])
    attempt(out, "fleet", lambda: fleet_frame(rank, world, mesh))

    objects = make_mesh({"objects": world}, device="cpu")
    a, b = (shard_batch(OrswotBatch.from_numpy(*planes(inp, k, slice(None)), device="cpu"),
                        objects) for k in ("a", "b"))
    attempt(out, "shard_local", lambda: [*OrswotBatch(*shard_local_pairwise_merge(
        a, b, objects)[0]).to_numpy(), shard_local_pairwise_merge(a, b, objects)[1].numpy()])
    rows = local_shard(inp["horizon"].shape[0], world, objects.get_local_rank("objects"))
    attempt(out, "truncate", lambda: a.truncate(inp["horizon"][rows]).to_numpy())
    part = global_batch_from_local(mesh, OrswotBatch.from_numpy(*planes(inp, "orswot", me),
                                                                device="cpu"), "replicas")
    out["global/span"] = np.array([part.span.start, part.span.stop, part.size])
    attempt(out, "global_join", lambda: allgather_join_orswot(part.value, mesh).to_numpy())
    if world == 4:
        hybrid(inp, rank, out)
    dist.destroy_process_group()
    return out


def hybrid(inp, rank, out):
    """The 2x2 mesh: objects over the leading (DCN) dim, replicas over the
    trailing one; rank ``r`` holds replica ``r % 2`` of object shard
    ``r // 2``.  An overflow on one object shard must raise on every
    rank, and the collective after it must still run."""
    mesh = make_multihost_mesh({"replicas": 2}, {"objects": 2}, device="cpu")
    rep, obj = mesh.get_local_rank("replicas"), mesh.get_local_rank("objects")
    for key in ("hyb", "hybo"):
        def join(key=key):
            full = planes(inp, key, rep)
            rows = local_shard(full[0].shape[0], 2, obj)
            batch = OrswotBatch.from_numpy(*(x[rows] for x in full), device="cpu")
            return allgather_join_orswot(batch, mesh, object_axis="objects").to_numpy()
        attempt(out, key, join)
    out["hyb/coords"] = np.array([obj, rep])
    attempt(out, "hyb_after", lambda: [all_reduce_clock_join(
        torch.tensor([[rank]]), mesh, "objects").numpy()])


if __name__ == "__main__":
    path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    result = run(path, rank, world)
    assert "jax" not in sys.modules and "crdt_tpu" not in sys.modules, "a rank imported JAX"
    np.savez(os.path.join(path, f"out{rank}.npz"), **result)
