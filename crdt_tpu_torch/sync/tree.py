"""Hierarchical digest trees — anti-entropy by subtree descent (the port
of the JAX package's ``sync/tree.py``).

The per-object digest vector (:mod:`crdt_tpu_torch.sync.digest`) folds
into a k-ary (k=16) XOR tree over the object axis, so two peers compare
roots first and descend only into diverged subtrees.  The tree folds
position-mixed leaf lanes, ``mix(digest[i] ^ mix(i + tag))``: a
bijection per position (the same diverged set), under which identical
deltas at different positions no longer cancel in a parent.  The leaf
mix and the level folds run as torch ops on ``device`` (default
``"cuda"``); the levels come back as host ``uint64`` arrays, and the
descent planning is numpy.  On the wire internal and leaf lanes ship
truncated to u32, the root as a full u64.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .digest import _s64, mix, xor_fold

#: the protocol fan-out
TREE_K = 16

#: wire width of internal/leaf lanes during descent (bytes); the root
#: ships as a full u64
LANE_WIRE_BYTES = 4

_LANE_MASK = np.uint64(0xFFFFFFFF)

#: leaf position-mix domain tag
_T_LEAF = 0xD6E8FEB86659FD93


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def _fold_level(lanes: torch.Tensor) -> torch.Tensor:
    """One level up: pad to a multiple of k with zero (the XOR identity)
    and XOR each group of k."""
    pad = (-lanes.shape[0]) % TREE_K
    if pad:
        lanes = torch.cat([lanes, torch.zeros(pad, dtype=lanes.dtype, device=lanes.device)])
    return xor_fold(lanes.view(-1, TREE_K))


@dataclasses.dataclass
class DigestTree:
    """The k-ary XOR fold of one digest vector, leaves first:
    ``levels[0]`` the position-mixed leaf lanes, each higher level the
    XOR of k children, ``levels[-1]`` the root.  Node ``i`` at level
    ``l`` covers leaves ``[i*k**l, (i+1)*k**l)``."""

    levels: List[np.ndarray]
    k: int = TREE_K

    @property
    def n(self) -> int:
        return int(self.levels[0].shape[0])

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def root(self) -> int:
        return int(self.levels[-1][0]) if self.levels[-1].size else 0

    def level_size(self, level: int) -> int:
        return int(self.levels[level].shape[0])

    def child_lanes(self, child_level: int, parents: np.ndarray) -> np.ndarray:
        """``u64[len(parents)*k]``: the k children (zero past the level
        edge) of each ``parents`` node of level ``child_level + 1``."""
        lv = self.levels[child_level]
        parents = np.asarray(parents, dtype=np.int64)
        idx = (parents[:, None] * self.k + np.arange(self.k, dtype=np.int64)[None, :]).reshape(-1)
        in_range = idx < lv.shape[0]
        out = np.zeros(idx.shape[0], dtype=np.uint64)
        out[in_range] = lv[idx[in_range]]
        return out


def build_tree(digests: np.ndarray, k: int = TREE_K, device=None) -> DigestTree:
    """Fold a host digest vector into its :class:`DigestTree` on
    ``device``: the position mix, then one fold per level."""
    if k != TREE_K:
        raise ValueError(f"digest trees are protocol-fixed at k={TREE_K}, got k={k}")
    raw = np.ascontiguousarray(digests, dtype=np.uint64).reshape(-1)
    if raw.shape[0] == 0:
        return DigestTree([raw, np.zeros(1, dtype=np.uint64)])
    lanes = torch.from_numpy(raw.view(np.int64)).to(resolve_device(device))
    pos = mix(torch.arange(lanes.shape[0], dtype=torch.int64, device=lanes.device)
              + _s64(_T_LEAF))
    level = mix(lanes ^ pos)
    levels = [level]
    while levels[-1].shape[0] > 1:
        levels.append(_fold_level(levels[-1]))
    return DigestTree([_host(lv) for lv in levels])


# -- descent planning (numpy, shared by both peers) ---------------------------


def wire_lanes(lanes: np.ndarray) -> np.ndarray:
    """The u32 wire truncation of internal/leaf lanes."""
    return (np.asarray(lanes, dtype=np.uint64) & _LANE_MASK).astype("<u4")


def diverged_children(parents: np.ndarray, mine: np.ndarray, theirs: np.ndarray,
                      child_count: int, k: int = TREE_K) -> np.ndarray:
    """Child node ids whose wire lanes disagree; ``mine``/``theirs`` are
    the ``len(parents)*k`` child lane blocks in parent order, and ids
    past ``child_count`` are padding."""
    parents = np.asarray(parents, dtype=np.int64)
    mask = wire_lanes(mine) != wire_lanes(theirs)
    ids = (parents[:, None] * k + np.arange(k, dtype=np.int64)[None, :]).reshape(-1)[mask]
    return ids[ids < child_count]


@dataclasses.dataclass
class DescentStats:
    """Byte and level accounting of one simulated descent."""

    levels: int = 0                 # level exchanges after the root frame
    lanes_shipped: int = 0          # internal+leaf lanes, per side
    payload_bytes: int = 0          # per side, headers excluded
    diverged_leaves: int = 0
    max_subtrees: int = 0           # widest diverged frontier
    cutover: bool = False           # fell back to the flat exchange
    collision: bool = False         # parent differed, no child did


def root_frame_lanes(tree: DigestTree) -> int:
    """Lanes a root frame carries: the root plus the top children level."""
    return 1 + (tree.level_size(tree.num_levels - 2) if tree.num_levels >= 2 else 0)


def simulate_descent(tree_a: DigestTree, tree_b: DigestTree,
                     flat_bytes: Optional[int] = None) -> tuple[np.ndarray, DescentStats]:
    """The descent two in-process trees would run: ``(diverged_leaf_ids,
    stats)``, byte-exact per side with header bytes excluded."""
    if tree_a.n != tree_b.n:
        raise ValueError(f"tree size mismatch: {tree_a.n} vs {tree_b.n}")
    stats = DescentStats()
    n = tree_a.n
    if flat_bytes is None:
        flat_bytes = 8 * n
    stats.payload_bytes = 8 + LANE_WIRE_BYTES * (root_frame_lanes(tree_a) - 1)
    stats.lanes_shipped = root_frame_lanes(tree_a)
    none = np.zeros(0, dtype=np.int64)
    if tree_a.root == tree_b.root:
        return none, stats
    if tree_a.num_levels < 2:
        stats.diverged_leaves = n
        return np.arange(n, dtype=np.int64), stats
    top = tree_a.num_levels - 2
    root = np.zeros(1, dtype=np.int64)
    d = diverged_children(root, tree_a.child_lanes(top, root), tree_b.child_lanes(top, root),
                          tree_a.level_size(top))
    level = top
    while level > 0:
        if d.size == 0:
            stats.collision = True
            return none, stats
        stats.max_subtrees = max(stats.max_subtrees, int(d.size))
        ship = d.size * TREE_K * LANE_WIRE_BYTES + d.size * 8
        if stats.payload_bytes + ship > flat_bytes:
            stats.cutover = True
            return none, stats
        stats.levels += 1
        stats.lanes_shipped += d.size * TREE_K
        stats.payload_bytes += ship
        d = diverged_children(d, tree_a.child_lanes(level - 1, d),
                              tree_b.child_lanes(level - 1, d), tree_a.level_size(level - 1))
        level -= 1
    if d.size == 0:
        stats.collision = True
        return none, stats
    stats.max_subtrees = max(stats.max_subtrees, int(d.size))
    stats.diverged_leaves = int(d.size)
    return np.sort(d).astype(np.int64), stats
