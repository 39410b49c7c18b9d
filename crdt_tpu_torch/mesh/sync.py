"""Shard-subset sync: repair the diverged shards of a sharded fleet and
leave the others home (the port of ``crdt_tpu/mesh/sync.py``).

Compare one 8-byte digest-tree root per shard first, then point the
subtree descent at only the diverged shards' leaf ranges, and pull
exactly their diverged rows.  Host orchestration over the digest, tree
and delta machinery: the rows ride :func:`~crdt_tpu_torch.sync.delta.
gather_blobs` and :func:`~crdt_tpu_torch.sync.delta.apply_delta_rows`,
whose ORSWOT applier merges through the merge kernel on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .state import MeshLayout, _bump


def shard_roots(digests, layout: MeshLayout, device=None) -> np.ndarray:
    """``uint64[S]``: the digest-tree root of each shard's slice of the
    digest vector, as the fleet snapshot manifest records them.  Tree
    roots, not an XOR fold: two rows of one shard that took identical
    updates still change the root.  An empty shard roots to 0.  The
    trees fold on ``device`` (default ``"cuda"``)."""
    from ..sync.tree import build_tree

    d = np.asarray(digests, dtype=np.uint64)
    if d.size != layout.n:
        raise ValueError(f"digest vector has {d.size} lanes, layout has {layout.n}")
    return np.array([build_tree(d[lo:hi], device=device).root if hi > lo else 0
                     for lo, hi in layout.ranges()], dtype=np.uint64)


def diverged_shards(mine, theirs, layout: MeshLayout, device=None) -> np.ndarray:
    """Ascending indices of the shards whose roots disagree."""
    a, b = shard_roots(mine, layout, device), shard_roots(theirs, layout, device)
    return np.nonzero(a != b)[0].astype(np.int64)


@dataclasses.dataclass
class ShardSyncStats:
    """One shard-subset sync: which shards moved, the descent's wire
    bytes per diverged shard, and the delta payload that shipped."""

    shards_synced: int = 0
    shards_skipped: int = 0
    objects: int = 0
    root_bytes: int = 0        # the per-shard root compare (8 B * S)
    descent_bytes: int = 0     # subtree-descent lanes, diverged shards only
    delta_bytes: int = 0       # delta row payloads, diverged shards only
    per_shard: dict = dataclasses.field(default_factory=dict)
    #: global ids of every repaired row (what a heat tracker records)
    object_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))


def shard_subset_sync(dst_batch, src_batch, layout: MeshLayout, universe=None, *,
                      applier=None, dst_digests=None, src_digests=None):
    """Pull every diverged shard's rows from ``src`` into ``dst`` (both
    logical fleets of ``layout.n`` rows): the per-shard root compare, the
    shard-scoped descent for the byte bill, then the rows.  Digests may
    be passed in when the caller holds them.  Returns ``(merged_dst,
    ShardSyncStats)``."""
    from ..parallel.mesh import tree_leaves
    from ..sync import delta as delta_mod
    from ..sync.digest import digest_of
    from ..sync.tree import build_tree, simulate_descent

    dev = tree_leaves(dst_batch)[0].device
    mine, theirs = (np.asarray(digest_of(b, universe) if d is None else d, dtype=np.uint64)
                    for b, d in ((dst_batch, dst_digests), (src_batch, src_digests)))
    stats = ShardSyncStats(root_bytes=8 * layout.shards)
    diverged = diverged_shards(mine, theirs, layout, dev)
    stats.shards_skipped = layout.shards - int(diverged.size)
    out, all_ids = dst_batch, [stats.object_ids]
    for s in diverged.tolist():
        lo, hi = layout.ranges()[s]
        descent = simulate_descent(build_tree(mine[lo:hi], device=dev),
                                   build_tree(theirs[lo:hi], device=dev))[1]
        ids = lo + delta_mod.diverged_indices(mine[lo:hi], theirs[lo:hi])
        blobs = delta_mod.gather_blobs(src_batch, ids, universe)
        nbytes = sum(map(len, blobs))
        out = delta_mod.apply_delta_rows(out, ids, blobs, universe, applier=applier)
        stats.shards_synced += 1
        stats.objects += int(ids.size)
        stats.descent_bytes += int(descent.payload_bytes)
        stats.delta_bytes += nbytes
        shard_idx, local = layout.rebase(ids)
        assert set(shard_idx.tolist()) <= {s}
        stats.per_shard[s] = {"objects": int(ids.size), "delta_bytes": nbytes,
                              "descent_bytes": int(descent.payload_bytes),
                              "local_rows": local.tolist() if ids.size <= 64 else None}
        all_ids.append(ids)
    stats.object_ids = np.concatenate(all_ids)
    for key in ("shards_synced", "shards_skipped", "objects", "delta_bytes"):
        _bump("sync_" + key, getattr(stats, key))
    _bump("sync_rounds")
    return out, stats
