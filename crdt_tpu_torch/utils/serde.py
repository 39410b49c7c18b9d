"""Binary serialization — the wire format (L5).

The reference serializes every CRDT and every Op with serde + bincode via
crate-level ``to_binary`` / ``from_binary`` (`src/lib.rs:62-83`);
replication is "serialize state or op, transport however you like, merge or
apply on the other side", and checkpointing is the same operation (state *is*
the checkpoint; resume = merge — SURVEY.md §5).

This module is the framework's equivalent (the port's own copy of the JAX
package's codec, byte for byte the same format): a compact, deterministic,
self-describing tag-based binary codec over the scalar CRDT types, their ops
and contexts, plus ordinary Python primitives.  Determinism matters — equal
CRDTs encode to equal bytes (maps and sets are sorted by encoded key), so the
codec can double as a content hash for anti-entropy digests.

Dense batches take the bulk path instead: ``OrswotBatch.from_wire`` /
``to_wire`` parse and encode this same format in C++
(``crdt_tpu_torch/native/wire_ingest.cpp``).
"""

from __future__ import annotations

import io
import struct
from typing import Any, Callable, Dict

# -- varint primitives ------------------------------------------------------


def _write_uvarint(out: io.BytesIO, n: int) -> None:
    if n < 0:
        raise ValueError("uvarint must be non-negative")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


def _read_exact(buf: io.BytesIO, n: int) -> bytes:
    raw = buf.read(n)
    if len(raw) != n:
        raise ValueError(f"truncated input: wanted {n} bytes, got {len(raw)}")
    return raw


# Longest varint the decoder accepts.  Generic int payloads are
# arbitrary-precision (zigzagged through _write_uvarint), so a tight
# 64-bit cap would reject legitimate states — but an UNBOUNDED decode is
# an asymmetric CPU-DoS on the replication receive path: a run of 0x80
# bytes costs quadratic big-int work in its length.  2048 bytes (~14k
# bits) is far beyond any plausible payload and keeps the worst-case
# decode cost trivially small.
_MAX_VARINT_BYTES = 2048


def _read_uvarint(buf: io.BytesIO) -> int:
    shift = 0
    result = 0
    for _ in range(_MAX_VARINT_BYTES):
        raw = buf.read(1)
        if not raw:
            raise ValueError("truncated varint")
        b = raw[0]
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result
        shift += 7
    raise ValueError(
        f"varint longer than {_MAX_VARINT_BYTES} bytes (corrupt or adversarial)"
    )


def _zigzag_big(n: int) -> int:
    # zigzag over arbitrary-precision ints (Python ints are unbounded)
    return n * 2 if n >= 0 else -n * 2 - 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


# a corrupt or adversarial wire can nest one level per byte; bound the
# decoder explicitly so depth failures are deterministic (independent of
# the caller's remaining interpreter stack) and honestly attributed.
# to_binary recursion makes states this deep unconstructible in practice.
_MAX_DEPTH = 256

# -- tags -------------------------------------------------------------------

_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_LIST = 0x07
_T_TUPLE = 0x08
_T_SET = 0x09
_T_DICT = 0x0A
_T_FROZENSET = 0x0B

_T_VCLOCK = 0x20
_T_DOT = 0x21
_T_GCOUNTER = 0x22
_T_PNCOUNTER = 0x23
_T_LWWREG = 0x24
_T_MVREG = 0x25
_T_ORSWOT = 0x26
_T_MAP = 0x27
_T_GSET = 0x28

_T_OP_ADD = 0x30  # orswot::Op::Add
_T_OP_ORM = 0x31  # orswot::Op::Rm
_T_OP_PUT = 0x32  # mvreg::Op::Put
_T_OP_PN = 0x33  # pncounter::Op
_T_OP_MNOP = 0x34  # map::Op::Nop
_T_OP_MRM = 0x35  # map::Op::Rm
_T_OP_MUP = 0x36  # map::Op::Up

_T_ADDCTX = 0x40
_T_RMCTX = 0x41
_T_READCTX = 0x42

_T_VALTYPE_NAMED = 0x50  # Map val_type: registered class by name
_T_VALTYPE_MAP = 0x51  # Map val_type: nested MapOf


class MapOf:
    """A serializable factory for nested Maps.

    The reference expresses nesting through generics
    (``Map<K, Map<K2, V, A>, A>``, `test/map.rs:8`); in Python the Map's
    value constructor is a runtime argument.  ``MapOf(inner)`` is the
    factory to use for map-valued maps so serde can round-trip the type.
    """

    def __init__(self, inner: Callable[[], Any]):
        self.inner = inner

    def __call__(self):
        from ..scalar.map import Map

        return Map(self.inner)

    def __eq__(self, other):
        return isinstance(other, MapOf) and self.inner == other.inner

    def __repr__(self):
        return f"MapOf({self.inner!r})"


def _val_type_registry() -> Dict[str, Any]:
    from ..scalar.gcounter import GCounter
    from ..scalar.map import Map
    from ..scalar.mvreg import MVReg
    from ..scalar.orswot import Orswot
    from ..scalar.pncounter import PNCounter
    from ..scalar.vclock import VClock

    return {
        "GCounter": GCounter,
        "MVReg": MVReg,
        "Orswot": Orswot,
        "PNCounter": PNCounter,
        "VClock": VClock,
        "Map": Map,
    }


# -- encoder ----------------------------------------------------------------


def _encode(out: io.BytesIO, obj: Any) -> None:
    from ..scalar.ctx import AddCtx, ReadCtx, RmCtx
    from ..scalar.gcounter import GCounter
    from ..scalar.gset import GSet
    from ..scalar.lwwreg import LWWReg
    from ..scalar.map import Map, Nop as MapNop, Rm as MapRm, Up as MapUp
    from ..scalar.mvreg import MVReg, Put
    from ..scalar.orswot import Add, Orswot, Rm as ORm
    from ..scalar.pncounter import Dir, Op as PNOp, PNCounter
    from ..scalar.vclock import Dot, VClock

    def enc_bytes_of(o: Any) -> bytes:
        b = io.BytesIO()
        _encode(b, o)
        return b.getvalue()

    def enc_pairs_sorted(pairs):
        blobs = sorted((enc_bytes_of(k), v) for k, v in pairs)
        _write_uvarint(out, len(blobs))
        for kb, v in blobs:
            out.write(kb)
            _encode(out, v)

    def enc_items_sorted(items):
        blobs = sorted(enc_bytes_of(i) for i in items)
        _write_uvarint(out, len(blobs))
        for b in blobs:
            out.write(b)

    def enc_vclock_body(vc: VClock):
        enc_pairs_sorted(vc.dots.items())

    if obj is None:
        out.write(bytes((_T_NONE,)))
    elif obj is True:
        out.write(bytes((_T_TRUE,)))
    elif obj is False:
        out.write(bytes((_T_FALSE,)))
    elif isinstance(obj, int):
        out.write(bytes((_T_INT,)))
        _write_uvarint(out, _zigzag_big(obj))
    elif isinstance(obj, float):
        out.write(bytes((_T_FLOAT,)))
        out.write(struct.pack("<d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.write(bytes((_T_STR,)))
        _write_uvarint(out, len(raw))
        out.write(raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.write(bytes((_T_BYTES,)))
        _write_uvarint(out, len(obj))
        out.write(bytes(obj))
    elif isinstance(obj, list):
        out.write(bytes((_T_LIST,)))
        _write_uvarint(out, len(obj))
        for item in obj:
            _encode(out, item)
    elif isinstance(obj, tuple):
        out.write(bytes((_T_TUPLE,)))
        _write_uvarint(out, len(obj))
        for item in obj:
            _encode(out, item)
    elif isinstance(obj, frozenset):
        out.write(bytes((_T_FROZENSET,)))
        enc_items_sorted(obj)
    elif isinstance(obj, set):
        out.write(bytes((_T_SET,)))
        enc_items_sorted(obj)
    elif isinstance(obj, dict):
        out.write(bytes((_T_DICT,)))
        enc_pairs_sorted(obj.items())
    elif isinstance(obj, VClock):
        out.write(bytes((_T_VCLOCK,)))
        enc_vclock_body(obj)
    elif isinstance(obj, Dot):
        out.write(bytes((_T_DOT,)))
        _encode(out, obj.actor)
        _write_uvarint(out, obj.counter)
    elif isinstance(obj, GCounter):
        out.write(bytes((_T_GCOUNTER,)))
        enc_vclock_body(obj.inner)
    elif isinstance(obj, PNCounter):
        out.write(bytes((_T_PNCOUNTER,)))
        enc_vclock_body(obj.p.inner)
        enc_vclock_body(obj.n.inner)
    elif isinstance(obj, LWWReg):
        out.write(bytes((_T_LWWREG,)))
        _encode(out, obj.val)
        _encode(out, obj.marker)
    elif isinstance(obj, MVReg):
        # MVReg equality is set-equality over (clock, val) pairs
        # (`mvreg.rs:74-96`); sort the encoded pairs so equal registers
        # encode to equal bytes regardless of merge order
        out.write(bytes((_T_MVREG,)))
        pair_blobs = []
        for clock, val in obj.vals:
            b = io.BytesIO()
            blobs = sorted((enc_bytes_of(k), v) for k, v in clock.dots.items())
            _write_uvarint(b, len(blobs))
            for kb, v in blobs:
                b.write(kb)
                _encode(b, v)
            _encode(b, val)
            pair_blobs.append(b.getvalue())
        _write_uvarint(out, len(pair_blobs))
        for blob in sorted(pair_blobs):
            out.write(blob)
    elif isinstance(obj, GSet):
        out.write(bytes((_T_GSET,)))
        enc_items_sorted(obj.value)
    elif isinstance(obj, Orswot):
        out.write(bytes((_T_ORSWOT,)))
        enc_vclock_body(obj.clock)
        enc_pairs_sorted(obj.entries.items())
        _encode_deferred(out, obj.deferred, enc_bytes_of)
    elif isinstance(obj, Map):
        out.write(bytes((_T_MAP,)))
        _encode_val_type(out, obj.val_type)
        enc_vclock_body(obj.clock)
        blobs = sorted(
            (enc_bytes_of(k), e) for k, e in obj.entries.items()
        )
        _write_uvarint(out, len(blobs))
        for kb, e in blobs:
            out.write(kb)
            enc_vclock_body(e.clock)
            _encode(out, e.val)
        _encode_deferred(out, obj.deferred, enc_bytes_of)
    elif isinstance(obj, Add):
        out.write(bytes((_T_OP_ADD,)))
        _encode(out, obj.dot)
        _encode(out, obj.member)
    elif isinstance(obj, ORm):
        out.write(bytes((_T_OP_ORM,)))
        _encode(out, obj.clock)
        _encode(out, obj.member)
    elif isinstance(obj, Put):
        out.write(bytes((_T_OP_PUT,)))
        _encode(out, obj.clock)
        _encode(out, obj.val)
    elif isinstance(obj, PNOp):
        out.write(bytes((_T_OP_PN,)))
        _encode(out, obj.dot)
        out.write(bytes((1 if obj.dir is Dir.POS else 0,)))
    elif isinstance(obj, MapNop):
        out.write(bytes((_T_OP_MNOP,)))
    elif isinstance(obj, MapRm):
        out.write(bytes((_T_OP_MRM,)))
        _encode(out, obj.clock)
        _encode(out, obj.key)
    elif isinstance(obj, MapUp):
        out.write(bytes((_T_OP_MUP,)))
        _encode(out, obj.dot)
        _encode(out, obj.key)
        _encode(out, obj.op)
    elif isinstance(obj, AddCtx):
        out.write(bytes((_T_ADDCTX,)))
        _encode(out, obj.clock)
        _encode(out, obj.dot)
    elif isinstance(obj, RmCtx):
        out.write(bytes((_T_RMCTX,)))
        _encode(out, obj.clock)
    elif isinstance(obj, ReadCtx):
        out.write(bytes((_T_READCTX,)))
        _encode(out, obj.add_clock)
        _encode(out, obj.rm_clock)
        _encode(out, obj.val)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}: {obj!r}")


def _encode_deferred(out, deferred, enc_bytes_of):
    # deferred: dict[ClockKey, set[member]] — sorted for determinism
    blobs = sorted((enc_bytes_of(k), members) for k, members in deferred.items())
    _write_uvarint(out, len(blobs))
    for kb, members in blobs:
        out.write(kb)
        member_blobs = sorted(enc_bytes_of(m) for m in members)
        _write_uvarint(out, len(member_blobs))
        for mb in member_blobs:
            out.write(mb)


def _encode_val_type(out: io.BytesIO, val_type) -> None:
    registry = _val_type_registry()
    if isinstance(val_type, MapOf):
        out.write(bytes((_T_VALTYPE_MAP,)))
        _encode_val_type(out, val_type.inner)
        return
    for name, cls in registry.items():
        if val_type is cls:
            out.write(bytes((_T_VALTYPE_NAMED,)))
            raw = name.encode()
            _write_uvarint(out, len(raw))
            out.write(raw)
            return
    raise TypeError(
        f"Map val_type {val_type!r} is not serializable; use a registered "
        f"class ({sorted(_val_type_registry())}) or MapOf(...)"
    )


# -- decoder ----------------------------------------------------------------


def _decode(buf: io.BytesIO, depth: int = 0) -> Any:
    if depth > _MAX_DEPTH:
        raise ValueError(f"nesting deeper than {_MAX_DEPTH} levels")
    from ..scalar.ctx import AddCtx, ReadCtx, RmCtx
    from ..scalar.gcounter import GCounter
    from ..scalar.gset import GSet
    from ..scalar.lwwreg import LWWReg
    from ..scalar.map import Entry, Map, Nop as MapNop, Rm as MapRm, Up as MapUp
    from ..scalar.mvreg import MVReg, Put
    from ..scalar.orswot import Add, Orswot, Rm as ORm
    from ..scalar.pncounter import Dir, Op as PNOp, PNCounter
    from ..scalar.vclock import Dot, VClock

    def dec_vclock_body() -> VClock:
        n = _read_uvarint(buf)
        vc = VClock()
        for _ in range(n):
            actor = _decode(buf, depth + 1)
            counter = _decode(buf, depth + 1)
            vc.dots[actor] = counter
        return vc

    def dec_deferred():
        n = _read_uvarint(buf)
        deferred = {}
        for _ in range(n):
            clock_key = _decode(buf, depth + 1)
            m = _read_uvarint(buf)
            members = set(_decode(buf, depth + 1) for _ in range(m))
            deferred[clock_key] = members
        return deferred

    raw = buf.read(1)
    if not raw:
        raise ValueError("truncated input")
    tag = raw[0]

    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return _unzigzag(_read_uvarint(buf))
    if tag == _T_FLOAT:
        return struct.unpack("<d", _read_exact(buf, 8))[0]
    if tag == _T_STR:
        n = _read_uvarint(buf)
        return _read_exact(buf, n).decode("utf-8")
    if tag == _T_BYTES:
        n = _read_uvarint(buf)
        return _read_exact(buf, n)
    if tag == _T_LIST:
        n = _read_uvarint(buf)
        return [_decode(buf, depth + 1) for _ in range(n)]
    if tag == _T_TUPLE:
        n = _read_uvarint(buf)
        return tuple(_decode(buf, depth + 1) for _ in range(n))
    if tag == _T_SET:
        n = _read_uvarint(buf)
        return set(_decode(buf, depth + 1) for _ in range(n))
    if tag == _T_FROZENSET:
        n = _read_uvarint(buf)
        return frozenset(_decode(buf, depth + 1) for _ in range(n))
    if tag == _T_DICT:
        n = _read_uvarint(buf)
        return {_decode(buf, depth + 1): _decode(buf, depth + 1) for _ in range(n)}
    if tag == _T_VCLOCK:
        return dec_vclock_body()
    if tag == _T_DOT:
        actor = _decode(buf, depth + 1)
        counter = _read_uvarint(buf)
        return Dot(actor, counter)
    if tag == _T_GCOUNTER:
        return GCounter(dec_vclock_body())
    if tag == _T_PNCOUNTER:
        return PNCounter(GCounter(dec_vclock_body()), GCounter(dec_vclock_body()))
    if tag == _T_LWWREG:
        val = _decode(buf, depth + 1)
        marker = _decode(buf, depth + 1)
        return LWWReg(val, marker)
    if tag == _T_MVREG:
        n = _read_uvarint(buf)
        vals = []
        for _ in range(n):
            clock = dec_vclock_body()
            val = _decode(buf, depth + 1)
            vals.append((clock, val))
        return MVReg(vals)
    if tag == _T_GSET:
        n = _read_uvarint(buf)
        return GSet(set(_decode(buf, depth + 1) for _ in range(n)))
    if tag == _T_ORSWOT:
        s = Orswot()
        s.clock = dec_vclock_body()
        n = _read_uvarint(buf)
        for _ in range(n):
            member = _decode(buf, depth + 1)
            clock = _decode(buf, depth + 1)
            s.entries[member] = clock
        s.deferred = dec_deferred()
        return s
    if tag == _T_MAP:
        val_type = _decode_val_type(buf, depth + 1)
        m = Map(val_type)
        m.clock = dec_vclock_body()
        n = _read_uvarint(buf)
        for _ in range(n):
            key = _decode(buf, depth + 1)
            entry_clock = dec_vclock_body()
            val = _decode(buf, depth + 1)
            m.entries[key] = Entry(clock=entry_clock, val=val)
        m.deferred = dec_deferred()
        return m
    if tag == _T_OP_ADD:
        return Add(dot=_decode(buf, depth + 1), member=_decode(buf, depth + 1))
    if tag == _T_OP_ORM:
        return ORm(clock=_decode(buf, depth + 1), member=_decode(buf, depth + 1))
    if tag == _T_OP_PUT:
        return Put(clock=_decode(buf, depth + 1), val=_decode(buf, depth + 1))
    if tag == _T_OP_PN:
        dot = _decode(buf, depth + 1)
        dir_byte = _read_exact(buf, 1)[0]
        return PNOp(dot=dot, dir=Dir.POS if dir_byte else Dir.NEG)
    if tag == _T_OP_MNOP:
        return MapNop()
    if tag == _T_OP_MRM:
        return MapRm(clock=_decode(buf, depth + 1), key=_decode(buf, depth + 1))
    if tag == _T_OP_MUP:
        return MapUp(dot=_decode(buf, depth + 1), key=_decode(buf, depth + 1), op=_decode(buf, depth + 1))
    if tag == _T_ADDCTX:
        return AddCtx(clock=_decode(buf, depth + 1), dot=_decode(buf, depth + 1))
    if tag == _T_RMCTX:
        return RmCtx(clock=_decode(buf, depth + 1))
    if tag == _T_READCTX:
        return ReadCtx(add_clock=_decode(buf, depth + 1), rm_clock=_decode(buf, depth + 1), val=_decode(buf, depth + 1))
    raise ValueError(f"unknown tag 0x{tag:02x}")


def _decode_val_type(buf: io.BytesIO, depth: int = 0):
    if depth > _MAX_DEPTH:
        raise ValueError(f"nesting deeper than {_MAX_DEPTH} levels")
    tag = _read_exact(buf, 1)[0]
    if tag == _T_VALTYPE_MAP:
        return MapOf(_decode_val_type(buf, depth + 1))
    if tag == _T_VALTYPE_NAMED:
        n = _read_uvarint(buf)
        name = _read_exact(buf, n).decode()
        return _val_type_registry()[name]
    raise ValueError(f"unknown val_type tag 0x{tag:02x}")


# -- public API (`lib.rs:62-83`) --------------------------------------------


def to_binary(obj: Any) -> bytes:
    """Dump a CRDT (or op / ctx / primitive) to deterministic binary."""
    out = io.BytesIO()
    _encode(out, obj)
    return out.getvalue()


def to_binary_pieces(obj: dict) -> list:
    """:func:`to_binary` of a dict, as a list of pieces whose concatenation
    is those bytes.  A ``memoryview`` value encodes as the bytes it views
    and is its own piece, not copied (a snapshot's checkpoint container is
    gigabytes): the tag and length prefix go before it, and the entries
    stay sorted by encoded key."""
    pieces, out = [], io.BytesIO()
    out.write(bytes((_T_DICT,)))
    _write_uvarint(out, len(obj))
    for kb, v in sorted(((to_binary(k), v) for k, v in obj.items()), key=lambda kv: kv[0]):
        out.write(kb)
        if isinstance(v, memoryview):
            view = v.cast("B")
            out.write(bytes((_T_BYTES,)))
            _write_uvarint(out, view.nbytes)
            pieces += [out.getvalue(), view]
            out = io.BytesIO()
        else:
            _encode(out, v)
    return pieces + [out.getvalue()]


def from_binary(data: bytes) -> Any:
    """Reconstruct a value written by :func:`to_binary`.

    Raises ``ValueError`` on any malformed input.  Corrupt bytes from the
    wire can otherwise escape as arbitrary exceptions — ``TypeError`` from
    an unhashable set/dict element, ``RecursionError`` from a run of
    nesting tags (each level costs one byte, so ~1 KB of ``0x07`` outruns
    the interpreter stack), ``UnicodeDecodeError`` from a clipped UTF-8
    sequence — so the decode is normalized to the one exception type a
    transport layer has to handle (property: ``tests/test_serde.py``
    fuzz suite).
    """
    buf = io.BytesIO(data)
    try:
        obj = _decode(buf)
    except ValueError:
        raise  # includes UnicodeDecodeError; already the contract type
    except (TypeError, KeyError, IndexError, OverflowError, struct.error,
            RecursionError) as e:
        raise ValueError(f"malformed input: {type(e).__name__}: {e}") from e
    rest = buf.read()
    if rest:
        raise ValueError(f"{len(rest)} trailing bytes after decode")
    return obj
