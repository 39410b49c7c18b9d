"""Op frames: the versioned wire envelope for columnar op batches.

The port of the JAX package's ``oplog/wire.py``, byte for byte.  A
1-byte protocol version leads every frame so that mixed-version peers
fail loudly, and a CRC32 of the payload turns truncation or tampering
into a clean rejection.  Envelope faults raise
:class:`~crdt_tpu_torch.error.SyncProtocolError`, payload grammar faults
:class:`~crdt_tpu_torch.error.WireFormatError`; every rejection first
adds one to its reason's count (:func:`rejected_counts`).

Frame layout (all little-endian)::

    version(1) | type(1) | crc32(4) | payload_len(8) | payload

Payload layout (columnar, B ops)::

    B(4) | A(2)
    | kind    u8 [B]
    | obj     u64[B]
    | actor   u16[B]
    | counter u64[B]
    | member  i32[B]
    | R(4) | row u32[R] | ractor u16[R] | rcounter u64[R]

The tail triples are the sparse remove clocks: ``Op::Rm`` ships a
witnessing clock (`orswot.rs:80-83`), ``Op::Add`` only its dot
(`orswot.rs:66-79`), so an add costs the 23-byte fixed row.
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

from ..error import SyncProtocolError, WireFormatError
from .records import OP_KINDS, OP_RM, OpBatch

#: bumped whenever the op-frame grammar changes
OPLOG_PROTOCOL_VERSION = 1

#: frame type byte, disjoint from the sync (0x01-0x05) and fleet (0x21)
#: frames, so a frame routed to the wrong decoder rejects on type
FRAME_OPS = 0x31

_HEADER = struct.Struct("<BBIQ")
_FIXED = struct.Struct("<IH")
_REJECTED_LOCK = threading.Lock()  # frames may decode on a loop's thread
_REJECTED: dict = {}


def rejected_counts() -> dict:
    """Frames rejected so far, per reason (``truncated``,
    ``version_mismatch``, ``crc_mismatch``, ``bad_kind``, ...)."""
    with _REJECTED_LOCK:
        return dict(_REJECTED)


def _reject(reason: str, message: str, hard: bool = False):
    """Count the rejection under ``reason`` and return the typed error:
    :class:`WireFormatError` for a grammar fault (``hard``), else
    :class:`SyncProtocolError`."""
    with _REJECTED_LOCK:
        _REJECTED[reason] = _REJECTED.get(reason, 0) + 1
    return (WireFormatError if hard else SyncProtocolError)(message)


def encode_ops_frame(ops: OpBatch) -> bytes:
    """One op frame for ``ops`` (B may be 0)."""
    a = 0 if ops.rm_clocks is None else ops.rm_clocks.shape[1]
    parts = [
        _FIXED.pack(len(ops), a),
        np.ascontiguousarray(ops.kind, dtype="<u1").tobytes(),
        np.ascontiguousarray(ops.obj, dtype="<u8").tobytes(),
        np.ascontiguousarray(ops.actor, dtype="<u2").tobytes(),
        np.ascontiguousarray(ops.counter, dtype="<u8").tobytes(),
        np.ascontiguousarray(ops.member, dtype="<i4").tobytes(),
    ]
    if ops.rm_clocks is not None:
        rows, actors = np.nonzero(ops.rm_clocks)
        vals = ops.rm_clocks[rows, actors]
    else:
        rows = actors = vals = np.zeros(0, np.int64)
    parts += [struct.pack("<I", rows.shape[0]),
              np.ascontiguousarray(rows, dtype="<u4").tobytes(),
              np.ascontiguousarray(actors, dtype="<u2").tobytes(),
              np.ascontiguousarray(vals, dtype="<u8").tobytes()]
    payload = b"".join(parts)
    return _HEADER.pack(OPLOG_PROTOCOL_VERSION, FRAME_OPS, zlib.crc32(payload),
                        len(payload)) + payload


def _take(payload: memoryview, off: int, nbytes: int, what: str):
    if off + nbytes > len(payload):
        raise _reject("truncated_column",
                      f"op payload truncated inside {what}: needs {nbytes} bytes at offset "
                      f"{off}, frame has {len(payload) - off}", hard=True)
    return payload[off:off + nbytes], off + nbytes


def decode_ops_frame(frame: bytes, *, num_actors: int | None = None) -> OpBatch:
    """The validated :class:`OpBatch` of an op frame.  Raises
    :class:`SyncProtocolError` on an envelope fault (version, type,
    length, CRC) and :class:`WireFormatError` on a payload grammar fault
    (unknown kind, clock triple out of range, truncated column).
    ``num_actors`` also bounds the actor columns by the receiving
    universe."""
    frame = bytes(frame)
    if len(frame) < _HEADER.size:
        raise _reject("truncated",
                      f"truncated op frame: {len(frame)} bytes < {_HEADER.size}-byte header")
    version, ftype, crc, plen = _HEADER.unpack_from(frame)
    if version != OPLOG_PROTOCOL_VERSION:
        raise _reject("version_mismatch",
                      f"op-frame protocol version mismatch: peer sent v{version}, this build "
                      f"speaks v{OPLOG_PROTOCOL_VERSION}")
    if ftype != FRAME_OPS:
        raise _reject("unknown_type", f"unknown op frame type {ftype:#04x}")
    payload = memoryview(frame)[_HEADER.size:]
    if len(payload) != plen:
        raise _reject("length_mismatch",
                      f"op frame length mismatch: header says {plen} payload bytes, frame "
                      f"carries {len(payload)}")
    if zlib.crc32(payload) != crc:
        raise _reject("crc_mismatch", "op frame CRC mismatch (tampered or corrupted in transit)")

    head, off = _take(payload, 0, _FIXED.size, "the column header")
    b, a = _FIXED.unpack(bytes(head))
    cols = {}
    for name, dt, width in (("kind", "<u1", 1), ("obj", "<u8", 8), ("actor", "<u2", 2),
                            ("counter", "<u8", 8), ("member", "<i4", 4)):
        raw, off = _take(payload, off, b * width, f"the {name} column")
        cols[name] = np.frombuffer(raw, dtype=dt)
    raw, off = _take(payload, off, 4, "the clock-triple count")
    (r,) = struct.unpack("<I", bytes(raw))
    raw, off = _take(payload, off, 4 * r, "the clock rows")
    rows = np.frombuffer(raw, dtype="<u4").astype(np.int64)
    raw, off = _take(payload, off, 2 * r, "the clock actors")
    ractors = np.frombuffer(raw, dtype="<u2").astype(np.int64)
    raw, off = _take(payload, off, 8 * r, "the clock counters")
    rvals = np.frombuffer(raw, dtype="<u8")
    if off != len(payload):
        raise _reject("trailing_bytes", f"op payload carries {len(payload) - off} trailing bytes",
                      hard=True)

    kind = cols["kind"]
    known = np.isin(kind, np.asarray(OP_KINDS, np.uint8))
    if b and not known.all():
        raise _reject("bad_kind", f"op frame carries unknown kind {int(kind[~known][0])}",
                      hard=True)
    actor = cols["actor"].astype(np.int32)
    if num_actors is not None and b and int(actor.max()) >= num_actors:
        raise _reject("actor_range",
                      f"op actor {int(actor.max())} outside the receiving universe's dense "
                      f"axis [0, {num_actors})", hard=True)
    rm_clocks = None
    if r:
        if a == 0:
            raise _reject("clock_width", "op frame carries clock triples but a zero actor width",
                          hard=True)
        if int(rows.max()) >= b:
            raise _reject("clock_row_range",
                          f"clock triple names op row {int(rows.max())} of a {b}-op frame",
                          hard=True)
        if not np.isin(rows, np.nonzero(kind == OP_RM)[0]).all():
            raise _reject("clock_on_non_rm",
                          "clock triple attached to a non-remove op (Op::Add ships only its "
                          "dot, orswot.rs:66-79)", hard=True)
        if int(ractors.max()) >= a or (num_actors is not None
                                       and int(ractors.max()) >= num_actors):
            raise _reject("clock_actor_range",
                          f"clock triple actor {int(ractors.max())} outside width {a}", hard=True)
        rm_clocks = np.zeros((b, a), np.uint64)
        np.maximum.at(rm_clocks, (rows, ractors), rvals)
    try:
        return OpBatch(kind=kind, obj=cols["obj"].astype(np.int64), actor=actor,
                       counter=cols["counter"], member=cols["member"], rm_clocks=rm_clocks)
    except ValueError as e:
        raise _reject("bad_columns", f"malformed op columns: {e}", hard=True) from None


def frame_op_count(frame: bytes) -> int:
    """The op count of a frame without a full decode (the ``B`` field of
    the column header), for a frame this process just encoded."""
    frame = bytes(frame)
    if len(frame) < _HEADER.size + _FIXED.size:
        return 0
    return _FIXED.unpack_from(frame, _HEADER.size)[0]


def frame_bytes_per_op(ops: OpBatch) -> float:
    """Wire bytes per op for ``ops``, the header amortised."""
    if len(ops) == 0:
        return float(_HEADER.size + _FIXED.size + 4)
    return len(encode_ops_frame(ops)) / len(ops)
