"""The snapshot store: versioned, CRC'd durable generations of one replica
(the port of the JAX package's ``durable/snapshot.py``, byte for byte the
same files).

Each generation is one self-verifying file, all little-endian::

    magic(8 = b"CRDTSNAP") | version(1) | type(1) | crc32(4)
    | payload_len(8) | payload

The payload is one serde dict: the batch checkpoint
(:func:`crdt_tpu_torch.utils.checkpoint.host_arrays`, dense planes and
intern tables), the fleet version vector, the GC watermark clock, any
causally parked ops as an op frame, the stability-frontier clock, the WAL
sequence the snapshot is current through, the node id, and the
digest-tree root of the planes at save time.  A file is written to a temp
name, fsync'd, renamed into place and its directory fsync'd, so a crash
mid-checkpoint leaves the previous generation visible.  A restore
recomputes the root from the restored planes
(:func:`crdt_tpu_torch.sync.digest.digest_of` and
:func:`~crdt_tpu_torch.sync.tree.build_tree`, the oracle sync sessions
converge on) and rejects a mismatch.

Unlike the JAX package, the store never holds the file in one piece on
the host: the planes are copied off the card once, the npz is written
into one buffer, and the serde framing around it, the CRC (``zlib.crc32``
folded over the pieces) and the write go piece by piece.  The bytes are
the same.  A writer hook therefore takes ``(path, pieces)``.

Generations are retained newest-``retain``; :meth:`SnapshotStore.
load_latest` falls back past a rejected one, loudly, and raises
:class:`~crdt_tpu_torch.error.DurabilityError` only when every retained
generation is bad.  Every rejection is counted by reason
(:func:`snapshot_counts`) and recorded (``durable.snapshot_rejected``)
before it raises :class:`~crdt_tpu_torch.error.CheckpointFormatError`.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..error import CheckpointFormatError, CrdtError, DurabilityError
from ..obs import events as obs_events
from ..utils import checkpoint as checkpoint_mod
from ..utils import serde

#: leads every snapshot file
SNAPSHOT_MAGIC = b"CRDTSNAP"

#: bumped whenever the snapshot grammar changes
SNAPSHOT_VERSION = 1

#: frame type byte, apart from the sync (0x01-0x07), fleet (0x21) and ops
#: (0x31) codecs
FRAME_SNAPSHOT = 0x41

_HEADER = struct.Struct("<BBIQ")  # version | type | crc32 | payload_len

_HEAD_LEN = len(SNAPSHOT_MAGIC) + _HEADER.size

_SNAP_PREFIX = "snap-"
_SNAP_SUFFIX = ".crdtsnap"

#: a snapshot writer: ``(path, pieces)``, the file being the pieces' concatenation
Writer = Callable[[str, Sequence], None]

_COUNTS_LOCK = threading.Lock()
_COUNTS = {"decoded": 0, "fallbacks": 0, "rejected": {}}


def snapshot_counts() -> dict:
    """Snapshots decoded, fallbacks past a rejected generation, and
    rejections by reason, in this process."""
    with _COUNTS_LOCK:
        return {**_COUNTS, "rejected": dict(_COUNTS["rejected"])}


def _count(key: str, reason: Optional[str] = None) -> None:
    with _COUNTS_LOCK:
        if reason is None:
            _COUNTS[key] += 1
        else:
            _COUNTS[key][reason] = _COUNTS[key].get(reason, 0) + 1


def _reject(reason: str, message: str) -> CheckpointFormatError:
    """Count and record a rejection, then hand back the error to raise."""
    _count("rejected", reason)
    obs_events.record("durable.snapshot_rejected", reason=reason, error=message[:200])
    return CheckpointFormatError(message)


def default_writer(path: str, pieces: Sequence) -> None:
    """Write the pieces to ``path`` and fsync it: the durable half of
    write-temp-then-rename."""
    with open(path, "wb") as f:
        for piece in pieces:
            f.write(piece)
        f.flush()
        os.fsync(f.fileno())


def _plain_writer(path: str, pieces: Sequence) -> None:
    """The writer without fsync (a benchmark and test knob)."""
    with open(path, "wb") as f:
        for piece in pieces:
            f.write(piece)


def _fsync_dir(dirpath: str) -> None:
    """fsync the directory, so that the rename itself is durable."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return  # platforms without directory descriptors: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclasses.dataclass
class Snapshot:
    """One decoded and root-verified generation, or one just written.
    ``digests`` is the planes' digest vector (host ``uint64[N]``), from
    which ``root`` was computed; ``split_s`` the seconds of each step of
    the write or the restore."""

    batch: object
    universe: object
    generation: int
    wal_seq: int                       # WAL frames below this are folded in
    root: int                          # digest-tree root at save time
    vv: np.ndarray                     # fleet version vector (uint64, flat)
    watermark: Optional[np.ndarray]    # GC watermark clock, if one existed
    parked: Optional[object]           # causally parked OpBatch, if any
    frontier: Optional[np.ndarray] = None   # fleet-min stability frontier
    node_id: str = ""
    nbytes: int = 0                    # file size on disk
    digests: Optional[np.ndarray] = None
    split_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def _digests_and_root(batch, universe) -> Tuple[np.ndarray, int]:
    from ..sync import digest as digest_mod
    from ..sync import tree as tree_mod

    digests = np.asarray(digest_mod.digest_of(batch, universe), dtype=np.uint64)
    dev = next(getattr(batch, f) for f in ("clock", "planes", "clocks", "markers")
               if hasattr(batch, f)).device
    return digests, int(tree_mod.build_tree(digests, device=dev).root)


class SnapshotStore:
    """Retained snapshot generations under one directory.

    ``retain`` keeps the newest N (2 or more keeps a fallback behind a
    torn newest); ``fsync`` gates the data and directory syncs; ``writer``
    is the hook fault injection wraps.  Callers serialize writes (the
    cluster node checkpoints under its busy lock); reads are safe at any
    time, since only complete, renamed generations are visible.  File
    names carry the generation and the WAL sequence
    (``snap-<gen>-w<seq>.crdtsnap``), so the WAL floor costs no decode."""

    def __init__(self, dirpath, *, retain: int = 2, fsync: bool = True,
                 writer: Optional[Writer] = None):
        if retain < 1:
            raise ValueError(f"retain {retain} < 1")
        self.dirpath = os.fspath(dirpath)
        self.retain = int(retain)
        self.fsync = bool(fsync)
        self._writer = writer if writer is not None else (
            default_writer if fsync else _plain_writer)
        os.makedirs(self.dirpath, exist_ok=True)

    def _path(self, generation: int, wal_seq: int) -> str:
        return os.path.join(self.dirpath,
                            f"{_SNAP_PREFIX}{generation:010d}-w{wal_seq:010d}{_SNAP_SUFFIX}")

    def _entries(self) -> List[Tuple[int, int, str]]:
        """``(generation, wal_seq, path)`` of every retained file, oldest
        first (a crashed write's ``.tmp`` is not one)."""
        out = []
        for name in os.listdir(self.dirpath):
            if not (name.startswith(_SNAP_PREFIX) and name.endswith(_SNAP_SUFFIX)):
                continue
            gen, sep, seq = name[len(_SNAP_PREFIX):-len(_SNAP_SUFFIX)].partition("-w")
            if sep and gen.isdigit() and seq.isdigit():
                out.append((int(gen), int(seq), os.path.join(self.dirpath, name)))
        return sorted(out)

    def generations(self) -> List[int]:
        """Retained generation numbers, ascending."""
        return [gen for gen, _, _ in self._entries()]

    def path_of(self, generation: int) -> str:
        for gen, _, path in self._entries():
            if gen == generation:
                return path
        raise FileNotFoundError(f"no retained snapshot generation {generation} under "
                                f"{self.dirpath}")

    def wal_floor(self) -> int:
        """The smallest ``wal_seq`` of the retained generations (0 when
        there are none): WAL truncation keeps frames from there, so that a
        fallback past a torn newest still finds its replay."""
        return min((seq for _, seq, _ in self._entries()), default=0)

    def write(self, batch, universe, *, wal_seq: int = 0, watermark=None, parked=None,
              frontier=None, node_id: str = "") -> Snapshot:
        """Write the next generation atomically and prune the old ones.
        ``wal_seq``: every WAL frame below it is folded into ``batch`` or
        carried in ``parked`` (the applier's causally parked ops);
        ``watermark`` and ``frontier``: the GC watermark and the
        stability-frontier clocks, restored as monotone floors."""
        from ..sync import digest as digest_mod

        clock, split = time.perf_counter, {}
        t = clock()
        gens = self.generations()
        generation = (gens[-1] + 1) if gens else 1
        vv = digest_mod.version_vector(batch)
        vv = np.zeros(0, np.uint64) if vv is None else np.asarray(vv, np.uint64).reshape(-1)
        digests, root = _digests_and_root(batch, universe)
        parked_frame = None
        if parked is not None and len(parked):
            from ..oplog.wire import encode_ops_frame

            parked_frame = encode_ops_frame(parked)
        if frontier is not None:
            frontier = np.asarray(frontier, np.uint64)
            if frontier.ndim == 1:
                frontier = frontier.reshape(1, -1)
        if watermark is not None:
            watermark = np.asarray(watermark, np.uint64).reshape(-1)
        split["digest"], t = clock() - t, clock()
        arrays = checkpoint_mod.host_arrays(batch, universe)
        split["to_numpy"], t = clock() - t, clock()
        blob = checkpoint_mod.npz_buffer(arrays)
        del arrays
        split["npz"], t = clock() - t, clock()
        pieces = serde.to_binary_pieces({
            "generation": generation,
            "wal_seq": int(wal_seq),
            "root": root,
            "vv": [int(x) for x in vv],
            "watermark": None if watermark is None else [int(x) for x in watermark],
            "frontier": None if frontier is None else [[int(x) for x in r] for r in frontier],
            "parked": parked_frame,
            "node": str(node_id),
            "checkpoint": blob,
        })
        crc, plen = 0, 0
        for piece in pieces:
            crc = zlib.crc32(piece, crc)
            plen += len(piece)
        head = SNAPSHOT_MAGIC + _HEADER.pack(SNAPSHOT_VERSION, FRAME_SNAPSHOT, crc, plen)
        split["crc"], t = clock() - t, clock()
        final = self._path(generation, int(wal_seq))
        tmp = final + ".tmp"
        self._writer(tmp, [head, *pieces])
        del pieces, blob
        split["write_fsync"], t = clock() - t, clock()
        # the crash window: a kill here leaves only a .tmp, and the previous
        # generation stays the visible one
        from ..cluster import faults as cluster_faults

        cluster_faults.crash_point("durable.snapshot.pre_rename")
        os.replace(tmp, final)
        if self.fsync:
            _fsync_dir(self.dirpath)
        self._prune()
        split["rename_fsync"] = clock() - t
        nbytes = len(head) + plen
        obs_events.record("durable.checkpoint", node=node_id, generation=generation,
                          bytes=nbytes, wal_seq=int(wal_seq))
        return Snapshot(batch=batch, universe=universe, generation=generation,
                        wal_seq=int(wal_seq), root=root, vv=vv, watermark=watermark,
                        frontier=frontier, parked=parked, node_id=node_id, nbytes=nbytes,
                        digests=digests, split_s=split)

    def _prune(self) -> None:
        for _, _, path in self._entries()[:-self.retain]:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def load(self, generation: int, device=None) -> Snapshot:
        """Decode and verify one generation onto ``device`` (default
        ``"cuda"``).  Raises :class:`CheckpointFormatError` on any fault."""
        t = time.perf_counter()
        with open(self.path_of(generation), "rb") as f:
            head = f.read(_HEAD_LEN)
            payload = f.read()  # read apart, so the decode never copies the file
        read_s = time.perf_counter() - t
        snap = _decode(head, payload, device)
        snap.generation = generation
        snap.split_s = {"read": read_s, **snap.split_s}
        return snap

    def load_latest(self, device=None) -> Optional[Snapshot]:
        """The newest generation that decodes and verifies, falling back
        past rejected ones, loudly.  None for an empty store;
        :class:`DurabilityError` when every retained generation is bad."""
        gens = self.generations()
        last_err: Optional[Exception] = None
        for generation in reversed(gens):
            try:
                return self.load(generation, device=device)
            except CheckpointFormatError as e:
                last_err = e
                _count("fallbacks")
                obs_events.record("durable.snapshot_fallback", generation=generation,
                                  error=str(e)[:200])
        if gens:
            raise DurabilityError(f"all {len(gens)} retained snapshot generations rejected "
                                  f"(newest error: {last_err})") from last_err
        return None


def decode_snapshot(data, device=None) -> Snapshot:
    """One snapshot file's bytes → a verified :class:`Snapshot` on
    ``device`` (default ``"cuda"``).  Every fault is counted, recorded and
    raised as :class:`CheckpointFormatError`."""
    return _decode(bytes(data[:_HEAD_LEN]), memoryview(data)[_HEAD_LEN:], device)


def _decode(head: bytes, payload, device) -> Snapshot:
    """:func:`decode_snapshot` of a file read as its header and its payload
    (a ``bytes`` payload is decoded without a copy of it)."""
    clock, split = time.perf_counter, {}
    if len(head) < _HEAD_LEN:
        raise _reject("truncated",
                      f"truncated snapshot: {len(head)} bytes < {_HEAD_LEN}-byte header")
    if head[:len(SNAPSHOT_MAGIC)] != SNAPSHOT_MAGIC:
        raise _reject("bad_magic", "not a snapshot file (magic mismatch)")
    version, ftype, crc, plen = _HEADER.unpack_from(head, len(SNAPSHOT_MAGIC))
    if version != SNAPSHOT_VERSION:
        raise _reject("version_mismatch",
                      f"snapshot format version skew: file is v{version}, this build speaks "
                      f"v{SNAPSHOT_VERSION}")
    if ftype != FRAME_SNAPSHOT:
        raise _reject("unknown_type", f"unknown snapshot frame type {ftype:#04x}")
    if len(payload) != plen:
        raise _reject("length_mismatch",
                      f"snapshot length mismatch: header says {plen} payload bytes, file "
                      f"carries {len(payload)} (torn write?)")
    t = clock()
    if zlib.crc32(payload) != crc:
        raise _reject("crc_mismatch", "snapshot CRC mismatch (torn or bit-flipped on disk)")
    split["crc"], t = clock() - t, clock()
    try:
        meta = serde.from_binary(payload)
    except ValueError as e:
        raise _reject("bad_payload", f"snapshot payload undecodable: {e}") from None
    del payload
    if not isinstance(meta, dict) or "checkpoint" not in meta:
        raise _reject("bad_payload", "snapshot payload is not a snapshot dict")
    try:
        decoded = checkpoint_mod.load_host(io.BytesIO(meta.pop("checkpoint")))
        split["decode"], t = clock() - t, clock()
        batch, universe = checkpoint_mod.to_batch(decoded, device)
    except CheckpointFormatError as e:
        raise _reject("bad_checkpoint", f"snapshot checkpoint blob rejected: {e}") from None
    del decoded
    split["h2d"], t = clock() - t, clock()
    # the restored planes must be digest-identical to the saved ones: the
    # tree-root oracle a sync session's converged check uses
    digests, root = _digests_and_root(batch, universe)
    want = meta.get("root")
    if not isinstance(want, int) or root != want:
        raise _reject("root_mismatch",
                      f"restored planes are not digest-identical to the snapshot (recomputed "
                      f"tree root {root:#018x}, recorded {want!r})")
    split["root_verify"] = clock() - t
    parked = None
    if meta.get("parked"):
        from ..oplog.wire import decode_ops_frame

        try:
            parked = decode_ops_frame(bytes(meta["parked"]),
                                      num_actors=universe.config.num_actors)
        except (CrdtError, ValueError) as e:
            raise _reject("bad_parked", f"snapshot parked-ops frame rejected: {e}") from None
    wm, fr = meta.get("watermark"), meta.get("frontier")
    _count("decoded")
    return Snapshot(
        batch=batch, universe=universe, generation=int(meta.get("generation", 0)),
        wal_seq=int(meta.get("wal_seq", 0)), root=root,
        vv=np.asarray(meta.get("vv", []), dtype=np.uint64).reshape(-1),
        watermark=None if wm is None else np.asarray(wm, dtype=np.uint64).reshape(-1),
        frontier=None if fr is None else np.asarray(fr, dtype=np.uint64),
        parked=parked, node_id=str(meta.get("node", "")), nbytes=_HEAD_LEN + plen,
        digests=digests, split_s=split)
