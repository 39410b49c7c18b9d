"""Serve frames: the versioned wire envelope for read batches (the port
of the JAX package's ``serve/wire.py``, byte for byte).

A 1-byte protocol version leads every frame so that mixed-version peers
fail loudly, and a CRC32 of the payload turns truncation or tampering
into a clean rejection.  Every rejection adds one to its reason's count
(:func:`rejected_counts`) and leaves a ``serve.protocol_error`` event in
the flight recorder before it raises: envelope faults
:class:`~crdt_tpu_torch.error.SyncProtocolError`, payload grammar faults
:class:`~crdt_tpu_torch.error.WireFormatError`.

Frame layout (all little-endian)::

    version(1) | type(1) | crc32(4) | payload_len(8) | payload

Read-request payload (columnar, B rows)::

    B(4) | W(2) | mode(1)
    | obj u64[B] | kind u8[B] | member i32[B]
    | require u64[W]

Result-frame payload::

    B(4) | W(2) | T(2)
    | obj u64[B] | kind u8[B] | member i32[B]
    | status u8[B] | val u64[B]
    | add_clock u64[B*W] | rm_clock u64[B*W]
    | token u64[T]

``W`` is the clock-row width (0 for clockless kinds), ``T`` the token
width.  Per-kind extras never ride the wire.
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

from ..error import SyncProtocolError, WireFormatError
from ..obs import events as obs_events
from .consistency import CODE_MODES, MODE_CODES
from .query import NO_MEMBER, READ_KINDS, STATUSES, ReadRequest, ResultFrame

#: bumped whenever the serve-frame grammar changes
SERVE_PROTOCOL_VERSION = 1

#: frame type bytes, disjoint from the sync, fleet and op frames, so a
#: frame routed to the wrong decoder rejects on type
FRAME_READ = 0x41
FRAME_RESULT = 0x42

_HEADER = struct.Struct("<BBIQ")
_REQ_FIXED = struct.Struct("<IHB")
_RES_FIXED = struct.Struct("<IHH")
_REJECTED_LOCK = threading.Lock()  # frames decode on the serve loop's thread
_REJECTED: dict = {}
_KINDS = np.asarray(READ_KINDS, np.uint8)
_STATUSES = np.asarray(STATUSES, np.uint8)


def rejected_counts() -> dict:
    """Frames rejected so far, per reason (``truncated``,
    ``version_mismatch``, ``crc_mismatch``, ``bad_kind``, ...)."""
    with _REJECTED_LOCK:
        return dict(_REJECTED)


def _reject(reason: str, message: str, hard: bool = False):
    """Count the rejection under ``reason``, record a
    ``serve.protocol_error`` event and return the typed error:
    :class:`WireFormatError` for a grammar fault (``hard``), else
    :class:`SyncProtocolError`."""
    with _REJECTED_LOCK:
        _REJECTED[reason] = _REJECTED.get(reason, 0) + 1
    obs_events.record("serve.protocol_error", reason=reason, error=message[:200])
    return (WireFormatError if hard else SyncProtocolError)(message)


def _take(payload: memoryview, off: int, nbytes: int, what: str):
    if off + nbytes > len(payload):
        raise _reject("truncated_column",
                      f"serve payload truncated inside {what}: needs {nbytes} bytes at "
                      f"offset {off}, frame has {len(payload) - off}", hard=True)
    return payload[off:off + nbytes], off + nbytes


def _envelope(ftype: int, payload: bytes) -> bytes:
    return _HEADER.pack(SERVE_PROTOCOL_VERSION, ftype, zlib.crc32(payload),
                        len(payload)) + payload


def _open(frame: bytes, want_type: int, what: str) -> memoryview:
    frame = bytes(frame)
    if len(frame) < _HEADER.size:
        raise _reject("truncated", f"truncated {what} frame: {len(frame)} bytes < "
                                   f"{_HEADER.size}-byte header")
    version, ftype, crc, plen = _HEADER.unpack_from(frame)
    if version != SERVE_PROTOCOL_VERSION:
        raise _reject("version_mismatch",
                      f"serve protocol version mismatch: peer sent v{version}, "
                      f"this build speaks v{SERVE_PROTOCOL_VERSION}")
    if ftype != want_type:
        raise _reject("unknown_type", f"unexpected serve frame type {ftype:#04x} "
                                      f"(wanted {want_type:#04x})")
    payload = memoryview(frame)[_HEADER.size:]
    if len(payload) != plen:
        raise _reject("length_mismatch",
                      f"serve frame length mismatch: header says {plen} payload bytes, "
                      f"frame carries {len(payload)}")
    if zlib.crc32(payload) != crc:
        raise _reject("crc_mismatch",
                      f"serve {what} frame CRC mismatch (tampered or corrupted in transit)")
    return payload


def _columns(payload: memoryview, off: int, b: int):
    """The ``obj``, ``kind`` and ``member`` columns both frames lead with."""
    raw, off = _take(payload, off, b * 8, "the object column")
    obj = np.frombuffer(raw, dtype="<u8").astype(np.int64)
    raw, off = _take(payload, off, b, "the kind column")
    kind = np.frombuffer(raw, dtype="<u1").copy()
    raw, off = _take(payload, off, b * 4, "the member column")
    return obj, kind, np.frombuffer(raw, dtype="<i4").astype(np.int32), off


def _u64(payload: memoryview, off: int, count: int, what: str):
    raw, off = _take(payload, off, count * 8, what)
    return np.frombuffer(raw, dtype="<u8").astype(np.uint64), off


def _check_tail(payload: memoryview, off: int, what: str, kind: np.ndarray) -> None:
    if off != len(payload):
        raise _reject("trailing_bytes",
                      f"{what} payload carries {len(payload) - off} trailing bytes", hard=True)
    bad = kind[~np.isin(kind, _KINDS)]
    if bad.size:
        raise _reject("bad_kind", f"{what} frame carries unknown kind {int(bad[0])}", hard=True)


def encode_read_request(req: ReadRequest) -> bytes:
    """One read-request frame (B may be 0: a pure token refresh)."""
    require = np.zeros(0, np.uint64) if req.require is None \
        else np.asarray(req.require, np.uint64).reshape(-1)
    return _envelope(FRAME_READ, b"".join([
        _REQ_FIXED.pack(len(req), require.size, MODE_CODES[req.mode]),
        np.ascontiguousarray(req.obj, dtype="<u8").tobytes(),
        np.ascontiguousarray(req.kind, dtype="<u1").tobytes(),
        np.ascontiguousarray(req.member, dtype="<i4").tobytes(),
        np.ascontiguousarray(require, dtype="<u8").tobytes(),
    ]))


def decode_read_request(frame: bytes, *, num_objects: int | None = None) -> ReadRequest:
    """The validated :class:`ReadRequest` of a read frame; ``num_objects``
    also bounds the object column by the serving fleet."""
    payload = _open(frame, FRAME_READ, "read-request")
    head, off = _take(payload, 0, _REQ_FIXED.size, "the request header")
    b, w, mode_code = _REQ_FIXED.unpack(bytes(head))
    if mode_code not in CODE_MODES:
        raise _reject("bad_mode", f"read frame carries unknown consistency mode code "
                                  f"{mode_code}", hard=True)
    obj, kind, member, off = _columns(payload, off, b)
    require, off = _u64(payload, off, w, "the require clock")
    _check_tail(payload, off, "read", kind)
    if b and int(member.min()) < NO_MEMBER:
        raise _reject("bad_member", f"read frame member {int(member.min())} below the "
                                    f"NO_MEMBER sentinel {NO_MEMBER}", hard=True)
    if b and num_objects is not None and int(obj.max()) >= num_objects:
        raise _reject("object_range",
                      f"read object {int(obj.max())} outside the serving fleet's dense axis "
                      f"[0, {num_objects})", hard=True)
    return ReadRequest(obj=obj, kind=kind, member=member, mode=CODE_MODES[mode_code],
                       require=require if w else None)


def encode_result_frame(res: ResultFrame) -> bytes:
    """One result frame for a gathered batch."""
    w = int(res.add_clock.shape[1]) if res.add_clock.ndim == 2 else 0
    token = np.asarray(res.token, np.uint64).reshape(-1)
    return _envelope(FRAME_RESULT, b"".join([
        _RES_FIXED.pack(len(res), w, token.size),
        np.ascontiguousarray(res.obj, dtype="<u8").tobytes(),
        np.ascontiguousarray(res.kind, dtype="<u1").tobytes(),
        np.ascontiguousarray(res.member, dtype="<i4").tobytes(),
        np.ascontiguousarray(res.status, dtype="<u1").tobytes(),
        np.ascontiguousarray(res.val, dtype="<u8").tobytes(),
        np.ascontiguousarray(res.add_clock, dtype="<u8").tobytes(),
        np.ascontiguousarray(res.rm_clock, dtype="<u8").tobytes(),
        np.ascontiguousarray(token, dtype="<u8").tobytes(),
    ]))


def decode_result_frame(frame: bytes) -> ResultFrame:
    """The validated :class:`ResultFrame` of a result frame."""
    payload = _open(frame, FRAME_RESULT, "result")
    head, off = _take(payload, 0, _RES_FIXED.size, "the result header")
    b, w, t = _RES_FIXED.unpack(bytes(head))
    obj, kind, member, off = _columns(payload, off, b)
    raw, off = _take(payload, off, b, "the status column")
    status = np.frombuffer(raw, dtype="<u1").copy()
    val, off = _u64(payload, off, b, "the value column")
    add, off = _u64(payload, off, b * w, "the add-clock rows")
    rm, off = _u64(payload, off, b * w, "the rm-clock rows")
    token, off = _u64(payload, off, t, "the token")
    _check_tail(payload, off, "result", kind)
    bad = status[~np.isin(status, _STATUSES)]
    if bad.size:
        raise _reject("bad_status", f"result frame carries unknown status {int(bad[0])}",
                      hard=True)
    return ResultFrame(obj=obj, kind=kind, member=member, status=status, val=val,
                       add_clock=add.reshape(b, w), rm_clock=rm.reshape(b, w), token=token)
