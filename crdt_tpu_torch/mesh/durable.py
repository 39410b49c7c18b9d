"""Per-shard snapshot generations and the fleet manifest that ties them
(the port of ``crdt_tpu/mesh/durable.py``; the files are the JAX
package's, byte for byte).

A sharded fleet checkpoints as S per-shard snapshot generations (each a
:class:`~crdt_tpu_torch.durable.snapshot.SnapshotStore` under
``shard-NN/``) and one manifest, ``fleet.json``, naming each shard's
generation, its digest-tree root and the layout.  Shards are written
first and the manifest last, renamed in: a crash between them leaves
the previous manifest pointing at the previous generations, which the
stores retain, so a restore is always a consistent cut.  A restore
checks each shard's planes against the root in its file (the store does)
and that root against the manifest's.
"""

from __future__ import annotations

import binascii
import json
import os
from typing import Optional, Tuple

import numpy as np

from .state import MeshLayout, _bump

_MANIFEST = "fleet.json"
_MANIFEST_VERSION = 1


def _manifest_crc(obj: dict) -> int:
    body = json.dumps({k: v for k, v in sorted(obj.items()) if k != "crc"}, sort_keys=True)
    return binascii.crc32(body.encode()) & 0xFFFFFFFF


class MeshSnapshotStore:
    """S per-shard snapshot stores and the fleet manifest under one
    directory.  Callers serialize writes; reads see only complete,
    renamed files."""

    def __init__(self, dirpath, layout: MeshLayout, *, retain: int = 2, fsync: bool = True):
        from ..durable.snapshot import SnapshotStore, _plain_writer, default_writer

        self.dirpath = os.fspath(dirpath)
        self.layout = layout
        os.makedirs(self.dirpath, exist_ok=True)
        self._stores = [SnapshotStore(os.path.join(self.dirpath, f"shard-{s:02d}"),
                                      retain=retain, fsync=fsync)
                        for s in range(layout.shards)]
        self._writer = default_writer if fsync else _plain_writer

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dirpath, _MANIFEST)

    def store(self, shard: int):
        """The per-shard :class:`SnapshotStore`."""
        return self._stores[shard]

    def write_fleet(self, batch, universe, *, node_id: str = "", wal_seq: int = 0,
                    watermark=None) -> dict:
        """Checkpoint the logical fleet: one generation per shard's leaf
        range, then the manifest (written last, renamed in).  Returns the
        manifest."""
        from ..parallel.mesh import tree_leaves, tree_map

        lay = self.layout
        n = int(tree_leaves(batch)[0].shape[0])
        if n != lay.n:
            raise ValueError(f"write_fleet got {n} rows for a layout of {lay.n}")
        snaps = [self._stores[s].write(tree_map(lambda x: x[lo:hi], batch), universe,
                                       wal_seq=wal_seq, watermark=watermark, node_id=node_id)
                 for s, (lo, hi) in enumerate(lay.ranges())]
        manifest = {"version": _MANIFEST_VERSION, "node_id": node_id, "layout": lay.to_json(),
                    "generations": [int(x.generation) for x in snaps],
                    "roots": [int(x.root) for x in snaps], "wal_seq": int(wal_seq)}
        manifest["crc"] = _manifest_crc(manifest)
        tmp = self.manifest_path + ".tmp"
        self._writer(tmp, [json.dumps(manifest, sort_keys=True).encode()])
        os.replace(tmp, self.manifest_path)
        _bump("durable_snapshots")
        return manifest

    def _reject(self, reason: str, message: str):
        from ..error import CheckpointFormatError

        _bump("durable_rejected_" + reason)
        raise CheckpointFormatError(message)

    def read_manifest(self) -> dict:
        from ..error import DurabilityError

        if not os.path.exists(self.manifest_path):
            _bump("durable_rejected_manifest_missing")
            raise DurabilityError(f"no fleet manifest under {self.dirpath}: nothing to "
                                  "restore (a fresh sharded replica)")
        try:
            with open(self.manifest_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            self._reject("manifest_corrupt", f"fleet manifest unreadable: {e}")
        if manifest.get("version") != _MANIFEST_VERSION:
            self._reject("manifest_corrupt", f"fleet manifest version "
                         f"{manifest.get('version')!r} != {_MANIFEST_VERSION}")
        if _manifest_crc(manifest) != manifest.get("crc"):
            self._reject("manifest_corrupt", "fleet manifest CRC mismatch (torn write?)")
        return manifest

    def load_fleet(self, universe=None, device=None) -> Tuple[object, dict]:
        """Restore the logical fleet onto ``device`` (default ``"cuda"``):
        decode every shard's manifest generation, check its root against
        the manifest's and join the rows in shard order.  Returns
        ``(batch, manifest)``."""
        import torch

        from ..error import CheckpointFormatError
        from ..parallel.mesh import tree_map

        manifest = self.read_manifest()
        lay = MeshLayout.from_json(manifest["layout"])
        if lay != self.layout:
            self._reject("layout_mismatch", f"manifest layout {lay} != store layout "
                         f"{self.layout}")
        parts = []
        for s, (gen, root) in enumerate(zip(manifest["generations"], manifest["roots"])):
            try:
                snap = self._stores[s].load(int(gen), device=device)
            except FileNotFoundError as e:
                self._reject("shard_missing", f"shard {s}: {e}")
            except CheckpointFormatError:
                _bump("durable_rejected_shard_missing")
                raise
            if int(snap.root) != int(root):
                self._reject("root_mismatch", f"shard {s} generation {gen}: subtree root "
                             f"{int(snap.root):#x} != manifest {int(root):#x}")
            parts.append(snap.batch)
        batch = tree_map(lambda *xs: torch.cat(xs), *parts)
        _bump("durable_restores")
        return batch, manifest

    def latest_manifest(self) -> Optional[dict]:
        """The manifest if one exists and verifies, else None."""
        return self.read_manifest() if os.path.exists(self.manifest_path) else None


def shard_root_of(digests, device=None) -> int:
    """The digest-tree root of one shard's digest slice: what the
    manifest records per shard."""
    from ..sync.tree import build_tree

    return int(build_tree(np.asarray(digests, dtype=np.uint64), device=device).root)
