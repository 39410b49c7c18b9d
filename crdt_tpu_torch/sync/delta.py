"""Delta frames and the diverged-row gather and apply (the port of the
JAX package's ``sync/delta.py``: the envelope, and the hello, fleet,
ops, lag, digest, tree, delta, delta-chunk and full-state frames, byte
for byte).

Frame layout (all little-endian)::

    version(1) | type(1) | crc32(4) | payload_len(8) | payload

A malformed frame raises :class:`~crdt_tpu_torch.error.SyncProtocolError`
after adding one to its reason's count (:func:`rejected_counts`).

The gather side copies only the diverged rows to the host: they are
selected where the planes live (``index_select``), then encoded by the
type's ``to_wire`` (the host codec for ORSWOT).  The apply side
(:class:`OrswotDeltaApplier`) parses the peer's blobs into warm
config-shaped host planes, copies them to the device, merges them with
the gathered local rows (the merge kernel on a CUDA device) and
scatters the result into a new batch, out of place.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import threading
import time
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..error import SyncProtocolError
from ..ops.map_ops import _tree_map
from .tree import TREE_K, wire_lanes

#: the envelope version this build writes, the version hello frames ship
#: at, and the versions it parses
PROTOCOL_VERSION = 4
BASELINE_VERSION = 2
COMPAT_VERSIONS = frozenset({2, 3, 4})

FRAME_DIGEST = 0x01
FRAME_DELTA = 0x02
FRAME_FULL = 0x03
FRAME_HELLO = 0x04
FRAME_FLEET = 0x05
FRAME_OPS = 0x06
FRAME_TREE = 0x07
FRAME_LAG = 0x08
FRAME_DELTA_CHUNK = 0x09

_FRAME_NAMES = {FRAME_DIGEST: "digest", FRAME_DELTA: "delta", FRAME_FULL: "full",
                FRAME_HELLO: "hello", FRAME_FLEET: "fleet", FRAME_OPS: "ops",
                FRAME_TREE: "tree", FRAME_LAG: "lag", FRAME_DELTA_CHUNK: "delta_chunk"}
_HEADER = struct.Struct("<BBIQ")
_REJECTED_LOCK = threading.Lock()
_REJECTED: dict = {}


def rejected_counts() -> dict:
    """Frames rejected so far, per reason (``truncated``,
    ``version_mismatch``, ``unknown_type``, ``length_mismatch``,
    ``crc_mismatch``, ``payload``)."""
    with _REJECTED_LOCK:
        return dict(_REJECTED)


def _reject(reason: str, message: str) -> SyncProtocolError:
    with _REJECTED_LOCK:
        _REJECTED[reason] = _REJECTED.get(reason, 0) + 1
    return SyncProtocolError(message)


def _frame(ftype: int, payload: bytes, version: int | None = None) -> bytes:
    return _HEADER.pack(PROTOCOL_VERSION if version is None else version, ftype,
                        zlib.crc32(payload), len(payload)) + payload


def decode_frame(frame: bytes) -> tuple[int, bytes]:
    """``(frame_type, payload)`` of a validated frame; raises
    :class:`SyncProtocolError` on a version outside
    :data:`COMPAT_VERSIONS`, an unknown type, a truncated or overlong
    frame, or a CRC mismatch."""
    if len(frame) < _HEADER.size:
        raise _reject("truncated", f"truncated sync frame: {len(frame)} bytes < "
                                   f"{_HEADER.size}-byte header")
    version, ftype, crc, plen = _HEADER.unpack_from(frame)
    if version not in COMPAT_VERSIONS:
        raise _reject("version_mismatch",
                      f"sync protocol version mismatch: peer sent v{version}, this build "
                      f"speaks v{PROTOCOL_VERSION} (compatible: {sorted(COMPAT_VERSIONS)})")
    if ftype not in _FRAME_NAMES:
        raise _reject("unknown_type", f"unknown sync frame type {ftype:#04x}")
    payload = frame[_HEADER.size:]
    if len(payload) != plen:
        raise _reject("length_mismatch", f"sync frame length mismatch: header says {plen} "
                                         f"payload bytes, frame carries {len(payload)}")
    if zlib.crc32(payload) != crc:
        raise _reject("crc_mismatch", f"sync {_FRAME_NAMES[ftype]} frame CRC mismatch "
                                      "(tampered or corrupted in transit)")
    return ftype, payload


def _malformed(kind: str, e: Exception) -> SyncProtocolError:
    return _reject("payload", f"malformed {kind} payload: {e}")


def _vv_bytes(version_vec) -> bytes:
    vv = np.ascontiguousarray(version_vec if version_vec is not None else np.zeros(0),
                              dtype="<u8").reshape(-1)
    return struct.pack("<I", vv.shape[0]) + vv.tobytes()


def _vv_at(payload: bytes, off: int) -> np.ndarray:
    (v,) = struct.unpack_from("<I", payload, off)
    off += 4
    vv = np.frombuffer(payload, dtype="<u8", count=v, offset=off)
    if off + 8 * v != len(payload):
        raise ValueError("trailing bytes")
    return vv.astype(np.uint64)


# -- session frames ------------------------------------------------------------


class HelloInfo(NamedTuple):
    """One peer's decoded hello: its trace proposal, node label,
    capability flags, the protocol version it speaks (absent: v2) and its
    transport's ARQ window (absent or 0: stop-and-wait)."""

    trace: str
    node: str
    fleet_obs: bool
    oplog: bool
    ver: int
    digest_tree: bool
    lag: bool = False
    window: int = 0


def encode_hello_frame(trace: str, node: str, fleet_obs: bool, oplog: bool = False,
                       digest_tree: bool = False, lag: bool = False, window: int = 0,
                       ver: int = PROTOCOL_VERSION) -> bytes:
    """A HELLO frame: sorted compact JSON of the trace proposal, node
    label, version spoken, four capability flags and the ARQ window.
    Always shipped at :data:`BASELINE_VERSION`: it precedes the
    negotiation every later frame's version follows."""
    payload = json.dumps(
        {"trace": str(trace), "node": str(node), "fleet_obs": bool(fleet_obs),
         "oplog": bool(oplog), "ver": int(ver), "digest_tree": bool(digest_tree),
         "lag": bool(lag), "window": int(window)},
        sort_keys=True, separators=(",", ":")).encode("utf-8")
    return _frame(FRAME_HELLO, payload, version=BASELINE_VERSION)


def decode_hello_payload(payload: bytes) -> HelloInfo:
    """The :class:`HelloInfo` of a HELLO payload, labels bounded; a
    missing key reads as no capability, v2, stop-and-wait."""
    try:
        doc = json.loads(payload.decode("utf-8"))
        info = HelloInfo(str(doc["trace"])[:128], str(doc.get("node", "peer"))[:64],
                         bool(doc.get("fleet_obs", False)), bool(doc.get("oplog", False)),
                         int(doc.get("ver", BASELINE_VERSION)),
                         bool(doc.get("digest_tree", False)), bool(doc.get("lag", False)),
                         max(0, int(doc.get("window", 0))))
    except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
        raise _malformed("hello", e) from None
    if not info.trace:
        raise _reject("payload", "hello payload carries an empty trace ID")
    return info


def encode_fleet_frame(snapshot_frame: bytes, version: int | None = None) -> bytes:
    """A FLEET frame: a fleet-observatory snapshot frame (versioned and
    checked by its own codec) in the sync envelope."""
    return _frame(FRAME_FLEET, bytes(snapshot_frame), version=version)


def decode_fleet_payload(payload: bytes) -> bytes:
    """The nested fleet-snapshot frame of a FLEET payload."""
    return bytes(payload)


def encode_ops_sync_frame(ops_frame: bytes, version: int | None = None) -> bytes:
    """An OPS frame: an op-batch frame
    (:func:`crdt_tpu_torch.oplog.wire.encode_ops_frame`) in the sync
    envelope."""
    return _frame(FRAME_OPS, bytes(ops_frame), version=version)


def decode_ops_sync_payload(payload: bytes) -> bytes:
    """The nested op-batch frame of an OPS payload."""
    return bytes(payload)


_LAG_ENTRY = struct.Struct("<HQq")


def encode_lag_frame(entries, proc_tag: str, version: int | None = None) -> bytes:
    """A LAG frame, the write-to-visible sidecar: the origin's clock-domain
    tag (at most 255 bytes) and its ``(actor, counter, mono_ns)`` ingest
    stamps."""
    proc = str(proc_tag).encode("utf-8")[:255]
    payload = b"".join([struct.pack("<B", len(proc)), proc, struct.pack("<I", len(entries))]
                       + [_LAG_ENTRY.pack(int(a), int(c), int(t)) for a, c, t in entries])
    return _frame(FRAME_LAG, payload, version=version)


def decode_lag_payload(payload: bytes) -> tuple[str, list]:
    """``(origin_proc_tag, [(actor, counter, mono_ns), ...])``."""
    try:
        (plen,) = struct.unpack_from("<B", payload, 0)
        raw = payload[1:1 + plen]
        if len(raw) != plen:
            raise ValueError("proc tag truncated")
        proc = raw.decode("utf-8")
        off = 1 + plen
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        if off + n * _LAG_ENTRY.size != len(payload):
            raise ValueError(f"expected {n} entries, payload holds "
                             f"{(len(payload) - off) // _LAG_ENTRY.size}")
        entries = [_LAG_ENTRY.unpack_from(payload, off + i * _LAG_ENTRY.size)
                   for i in range(n)]
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        raise _malformed("lag", e) from None
    return proc, entries


# -- digest frames -------------------------------------------------------------


def encode_digest_frame(digests: np.ndarray, version_vec: np.ndarray | None = None,
                        version: int | None = None) -> bytes:
    """A DIGEST frame: the u64 digest vector and the (possibly empty)
    version-vector summary."""
    d = np.ascontiguousarray(digests, dtype="<u8")
    payload = struct.pack("<Q", d.shape[0]) + d.tobytes() + _vv_bytes(version_vec)
    return _frame(FRAME_DIGEST, payload, version=version)


def decode_digest_payload(payload: bytes) -> tuple[np.ndarray, np.ndarray]:
    """``(digests u64[n], version_vector u64[v])``."""
    try:
        (n,) = struct.unpack_from("<Q", payload, 0)
        d = np.frombuffer(payload, dtype="<u8", count=n, offset=8)
        vv = _vv_at(payload, 8 + 8 * n)
    except (struct.error, ValueError) as e:
        raise _malformed("digest", e) from None
    return d.astype(np.uint64), vv


# -- digest-tree frames --------------------------------------------------------

TREE_SUB_ROOT = 0x01
TREE_SUB_LEVEL = 0x02
TREE_SUB_SPEC = 0x03
_ROOT = struct.Struct("<BBQQQI")
_LEVEL = struct.Struct("<BBI")


def tree_subframe_kind(payload: bytes) -> int:
    """The subframe tag of a TREE payload (ROOT/LEVEL/SPEC)."""
    if not payload:
        raise _reject("payload", "empty tree payload")
    return payload[0]


def encode_tree_root_frame(tree, version_vec: np.ndarray | None = None,
                           version: int | None = None) -> bytes:
    """A TREE/root frame: fan-out k, fleet size, level count, the u64
    root, the top children level as u32 wire lanes, and the version
    vector."""
    cw = wire_lanes(tree.levels[-2] if tree.num_levels >= 2 else np.zeros(0, np.uint64))
    payload = (_ROOT.pack(TREE_SUB_ROOT, tree.k, tree.n, tree.num_levels,
                          tree.root & 0xFFFFFFFFFFFFFFFF, cw.shape[0])
               + cw.tobytes() + _vv_bytes(version_vec))
    return _frame(FRAME_TREE, payload, version=version)


def decode_tree_root_payload(payload: bytes):
    """``(k, n, levels, root, children u32[c], version_vector u64[v])``."""
    try:
        sub, k, n, levels, root, c = _ROOT.unpack_from(payload, 0)
        if sub != TREE_SUB_ROOT:
            raise ValueError(f"expected a tree ROOT subframe, got {sub}")
        children = np.frombuffer(payload, dtype="<u4", count=c, offset=_ROOT.size)
        vv = _vv_at(payload, _ROOT.size + 4 * c)
    except (struct.error, ValueError) as e:
        raise _malformed("tree root", e) from None
    return int(k), int(n), int(levels), int(root), children.astype(np.uint32), vv


def _encode_tree_sublevel(sub: int, level: int, parents, lanes, version) -> bytes:
    parents = np.ascontiguousarray(parents, dtype="<u8")
    lw = wire_lanes(lanes)
    if lw.shape[0] != parents.shape[0] * TREE_K:
        raise ValueError(f"tree level frame: {parents.shape[0]} parents need "
                         f"{parents.shape[0] * TREE_K} child lanes, got {lw.shape[0]}")
    payload = _LEVEL.pack(sub, level, parents.shape[0]) + parents.tobytes() + lw.tobytes()
    return _frame(FRAME_TREE, payload, version=version)


def _decode_tree_sublevel(sub: int, kind: str, payload: bytes):
    try:
        got, level, p = _LEVEL.unpack_from(payload, 0)
        if got != sub:
            raise ValueError(f"expected a tree {kind} subframe, got {got}")
        off = _LEVEL.size
        parents = np.frombuffer(payload, dtype="<u8", count=p, offset=off)
        off += 8 * p
        lanes = np.frombuffer(payload, dtype="<u4", count=p * TREE_K, offset=off)
        if off + 4 * p * TREE_K != len(payload):
            raise ValueError("trailing bytes")
    except (struct.error, ValueError) as e:
        raise _malformed(f"tree {kind.lower()}", e) from None
    return int(level), parents.astype(np.int64), lanes.astype(np.uint32)


def encode_tree_level_frame(level: int, parents, lanes, version: int | None = None) -> bytes:
    """A TREE/level frame: the diverged parent ids (level ``level + 1``)
    and the u32 wire lanes of their k children each, parent-major."""
    return _encode_tree_sublevel(TREE_SUB_LEVEL, level, parents, lanes, version)


def decode_tree_level_payload(payload: bytes):
    """``(level, parents int64[p], lanes u32[p*k])``."""
    return _decode_tree_sublevel(TREE_SUB_LEVEL, "LEVEL", payload)


def encode_tree_spec_frame(level: int, parents, lanes, version: int | None = None) -> bytes:
    """A TREE/spec frame: one speculative descent level, in the LEVEL
    grammar."""
    return _encode_tree_sublevel(TREE_SUB_SPEC, level, parents, lanes, version)


def decode_tree_spec_payload(payload: bytes):
    """``(level, parents int64[p], lanes u32[p*k])``."""
    return _decode_tree_sublevel(TREE_SUB_SPEC, "SPEC", payload)


# -- delta and full-state frames -----------------------------------------------


def _pack_blobs(blobs) -> bytes:
    return b"".join(struct.pack("<I", len(b)) + b for b in blobs)


def _unpack_blobs(payload: bytes, off: int, count: int) -> list[bytes]:
    out = []
    view = memoryview(payload)
    for _ in range(count):
        if off + 4 > len(payload):
            raise _reject("payload", "malformed sync payload: blob length field truncated")
        (ln,) = struct.unpack_from("<I", payload, off)
        off += 4
        if off + ln > len(payload):
            raise _reject("payload", f"malformed sync payload: blob of {ln} bytes overruns "
                                     "frame")
        out.append(bytes(view[off:off + ln]))
        off += ln
    if off != len(payload):
        raise _reject("payload", f"malformed sync payload: {len(payload) - off} trailing bytes")
    return out


def _ids_bytes(ids, blobs, what: str) -> bytes:
    ids = np.ascontiguousarray(ids, dtype="<u8")
    if ids.shape[0] != len(blobs):
        raise ValueError(f"{what}: {ids.shape[0]} ids vs {len(blobs)} blobs")
    return ids.tobytes()


def encode_delta_frame(fleet_n: int, ids, blobs, version: int | None = None) -> bytes:
    """A DELTA frame: the diverged object ids and their wire blobs, with
    the fleet size."""
    payload = (struct.pack("<QQ", fleet_n, len(blobs)) + _ids_bytes(ids, blobs, "delta frame")
               + _pack_blobs(blobs))
    return _frame(FRAME_DELTA, payload, version=version)


def decode_delta_payload(payload: bytes) -> tuple[int, np.ndarray, list[bytes]]:
    """``(fleet_n, ids int64[k], blobs)``."""
    try:
        fleet_n, k = struct.unpack_from("<QQ", payload, 0)
        ids = np.frombuffer(payload, dtype="<u8", count=k, offset=16)
    except (struct.error, ValueError) as e:
        raise _malformed("delta", e) from None
    return int(fleet_n), ids.astype(np.int64), _unpack_blobs(payload, 16 + 8 * k, k)


#: rows per streamed DELTA_CHUNK frame
DELTA_CHUNK_ROWS = 256
_CHUNK = struct.Struct("<QIIQ")


def encode_delta_chunk_frame(fleet_n: int, chunk_idx: int, chunk_count: int, ids, blobs,
                             version: int | None = None) -> bytes:
    """A DELTA_CHUNK frame: one slice of the diverged rows, with its
    index and the stream's chunk count."""
    payload = (_CHUNK.pack(fleet_n, chunk_idx, chunk_count, len(blobs))
               + _ids_bytes(ids, blobs, "delta chunk frame") + _pack_blobs(blobs))
    return _frame(FRAME_DELTA_CHUNK, payload, version=version)


def decode_delta_chunk_payload(payload: bytes):
    """``(fleet_n, chunk_idx, chunk_count, ids int64[k], blobs)``."""
    try:
        fleet_n, idx, total, k = _CHUNK.unpack_from(payload, 0)
        ids = np.frombuffer(payload, dtype="<u8", count=k, offset=_CHUNK.size)
    except (struct.error, ValueError) as e:
        raise _malformed("delta chunk", e) from None
    blobs = _unpack_blobs(payload, _CHUNK.size + 8 * k, k)
    return int(fleet_n), int(idx), int(total), ids.astype(np.int64), blobs


def encode_full_frame(blobs, version: int | None = None) -> bytes:
    """A FULL frame: every object's wire blob, in object order."""
    return _frame(FRAME_FULL, struct.pack("<Q", len(blobs)) + _pack_blobs(blobs),
                  version=version)


def decode_full_payload(payload: bytes) -> list[bytes]:
    try:
        (n,) = struct.unpack_from("<Q", payload, 0)
    except struct.error as e:
        raise _malformed("full-state", e) from None
    return _unpack_blobs(payload, 8, n)


# -- diverged rows -------------------------------------------------------------


def diverged_indices(mine: np.ndarray, theirs: np.ndarray) -> np.ndarray:
    """Ascending object indices where two digest vectors disagree."""
    mine = np.asarray(mine, dtype=np.uint64)
    theirs = np.asarray(theirs, dtype=np.uint64)
    if mine.shape != theirs.shape:
        raise SyncProtocolError(f"digest vector shape mismatch: {mine.shape} vs "
                                f"{theirs.shape} (peers must sync equal-sized fleets)")
    return np.nonzero(mine != theirs)[0].astype(np.int64)


def _fields(batch) -> dict:
    """The plane fields of a batch dataclass (tensors, or nested tuples
    of them as a Map's values)."""
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), (torch.Tensor, tuple))}


def take_rows(batch, idx: torch.Tensor):
    """``batch`` restricted to the rows ``idx`` (an int64 tensor on the
    batch's device), gathered where the planes live."""
    return dataclasses.replace(batch, **{
        k: _tree_map(lambda p: p.index_select(0, idx), v) for k, v in _fields(batch).items()})


def put_rows(batch, idx: torch.Tensor, rows):
    """A new batch: ``batch`` with ``rows`` written at ``idx`` (out of
    place; ``batch`` is unchanged)."""
    return dataclasses.replace(batch, **{
        k: _tree_map(lambda p, s: p.index_copy(0, idx, s), v, getattr(rows, k))
        for k, v in _fields(batch).items()})


def _index(batch, ids) -> torch.Tensor:
    dev = next(iter(_fields(batch).values()))
    while isinstance(dev, tuple):
        dev = dev[0]
    return torch.as_tensor(np.ascontiguousarray(ids, dtype=np.int64), device=dev.device)


def gather_blobs(batch, ids: np.ndarray, universe) -> list[bytes]:
    """Wire blobs of the fleet rows ``ids``, byte-identical to
    ``batch.to_wire(universe)`` restricted to them: the rows are gathered
    where the planes live and only they are copied to the host and
    encoded."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if ids.size == 0:
        return []
    return take_rows(batch, _index(batch, ids)).to_wire(universe)


class OrswotDeltaApplier:
    """Scatter-merge delta rows into an ORSWOT fleet.  One instance owns
    a warm host plane set, config-shaped and sized to the largest delta
    seen (power-of-two rows), that the host codec parses into
    (``out=``); reuse it across rounds."""

    def __init__(self, universe):
        self.universe = universe
        self._staging = None

    def _buffers(self, k: int) -> tuple:
        if self._staging is None or self._staging[0].shape[0] < k:
            from ..batch.orswot_batch import _np_planes

            self._staging = _np_planes(1 << max(0, (k - 1).bit_length()), self.universe.config)
        return tuple(p[:k] for p in self._staging)

    def parse(self, blobs) -> tuple:
        """The peer rows' unsigned host planes at the config widths: the
        host codec into the warm staging, or the Python codec for a
        universe that is not identity-interned.  The planes are views of
        the staging until the next call."""
        from ..batch.wirebulk import orswot_planes_from_wire, planes_of_blobs

        planes = orswot_planes_from_wire(blobs, self.universe, out=self._buffers(len(blobs)))
        return planes_of_blobs(blobs, self.universe) if planes is None else planes

    def apply(self, batch, ids: np.ndarray, blobs, seconds: dict | None = None):
        """A new batch: ``batch`` with ``merge(local_row, peer_row)`` at
        every ``ids`` row, the peer rows decoded from ``blobs``.  The
        local rows keep their widths (a regrown or repacked fleet merges
        config-shaped peer rows; the merge takes unequal slot widths).
        Raises :class:`~crdt_tpu_torch.error.CapacityOverflowError` when
        a row union outgrows the local capacities.  A ``seconds`` dict is
        filled with each step's host seconds (``parse_s``, ``h2d_s``,
        ``merge_s`` for the gather and the merge, ``scatter_s``), the
        device synchronized after each."""
        from ..batch.orswot_batch import OrswotBatch

        ids = np.ascontiguousarray(ids, dtype=np.int64)
        if len(blobs) != ids.shape[0]:
            raise SyncProtocolError(f"delta apply: {ids.shape[0]} ids vs {len(blobs)} blobs")
        if ids.size == 0:
            return batch
        n = batch.clock.shape[0]
        if ids.min() < 0 or ids.max() >= n:
            raise SyncProtocolError(f"delta apply: object id outside fleet [0, {n})")
        lap = _Laps(seconds, batch.device)
        host = self.parse(blobs)
        lap("parse_s")
        idx = _index(batch, ids)
        peer = OrswotBatch.from_numpy(*host, device=batch.device)
        lap("h2d_s")
        merged = take_rows(batch, idx).merge(peer)
        lap("merge_s")
        out = put_rows(batch, idx, merged)
        lap("scatter_s")
        return out


class _Laps:
    """Calling it records the host seconds since the last call under a
    step name, after synchronizing the device; a no-op without a dict."""

    def __init__(self, seconds: dict | None, device):
        self.seconds, self.device = seconds, device
        self.t = time.perf_counter()

    def __call__(self, step: str) -> None:
        if self.seconds is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.seconds[step], self.t = t - self.t, t


def apply_delta_rows(batch, ids: np.ndarray, blobs, universe,
                     applier: OrswotDeltaApplier | None = None):
    """Scatter-merge a peer's delta rows into any fleet batch: ORSWOT
    through ``applier`` (or a new one); other types decode the blobs with
    their ``from_wire`` (a Map with its value kernel), merge them with the
    gathered local rows and scatter back."""
    from ..batch.orswot_batch import OrswotBatch

    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if ids.size == 0:
        return batch
    if isinstance(batch, OrswotBatch):
        return (applier or OrswotDeltaApplier(universe)).apply(batch, ids, blobs)
    extra = (batch.kernel.val_kernel,) if hasattr(batch, "kernel") else ()
    idx = _index(batch, ids)
    peer = type(batch).from_wire(blobs, universe, *extra, device=idx.device)
    return put_rows(batch, idx, take_rows(batch, idx).merge(peer))
