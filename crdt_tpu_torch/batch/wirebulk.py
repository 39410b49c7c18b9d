"""The bulk wire legs on the host: blobs ⇄ unsigned numpy planes.

The port of the JAX package's ``batch/wirebulk.py``: the ORSWOT triage,
shared by :meth:`OrswotBatch.from_wire <crdt_tpu_torch.batch.OrswotBatch.
from_wire>` / ``to_wire`` and :class:`~crdt_tpu_torch.batch.wireloop.
PipelinedWireLoop`, and the shared flow of the flat types' legs
(:func:`planes_from_wire`, :func:`planes_to_wire`, and their clock-shaped
specialisations :func:`clockish_from_wire`/:func:`clockish_to_wire`).
Concatenate blobs, parse them in parallel with the host codec
(:mod:`crdt_tpu_torch.native.engine`), triage the per-blob status,
splice blobs outside the fast-path grammar in through the scalar codec,
and take the Python codec whenever the fast path cannot apply (a
universe that is not identity-interned, or u64 counters whose zigzag
exceeds the C encoder's range).  Either way the result equals the
pure-Python codec: ``from_binary`` + ``from_scalar`` on the way in,
``to_binary`` of ``to_scalar`` on the way out.

The codec is built at first use and a failed build raises; there is no
"engine missing" route.  Native and fallback blob counts, with the
reason of each fallback, are kept per leg as plain integers
(:func:`wire_counts`, :func:`reset_wire_counts`).
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ..config import counter_dtype
from ..error import WireFormatError
from ..native import engine

WIRE_TAG_VCLOCK = 0x20  # serde.py _T_VCLOCK
WIRE_TAG_GCOUNTER = 0x22  # serde.py _T_GCOUNTER
LEGS = ("orswot", "vclock", "gcounter", "pncounter", "gset", "lww", "mvreg", "map")
_DIRECTIONS = ("from_wire", "to_wire")
_TALLY_LOCK = threading.Lock()  # the wire loop parses on a thread of its own
_TALLY = {leg: {d: {"native": 0, "fallback": 0, "reasons": {}} for d in _DIRECTIONS}
          for leg in LEGS}


def _tally(direction: str, native: int = 0, fallback: int = 0,
           reason: str | None = None, leg: str = "orswot") -> None:
    """Add one bulk call's blobs to the counts of ``leg``'s ``direction``.
    Reasons: ``non_identity`` (the universe is not identity-interned),
    ``grammar`` (a blob outside the fast-path grammar, spliced in through
    the scalar codec), ``overflow_zigzag`` (u64 counters or payload ids
    at or above 2^63, past the native encoder's range)."""
    with _TALLY_LOCK:
        t = _TALLY[leg][direction]
        t["native"] += native
        t["fallback"] += fallback
        if reason is not None and fallback:
            t["reasons"][reason] = t["reasons"].get(reason, 0) + fallback


def wire_counts(leg: str = "orswot") -> dict:
    """Blobs of ``leg`` (one of :data:`LEGS`) that took the native codec
    and the Python one, per direction, since the last reset:
    ``{"from_wire": {"native": n, "fallback": n, "reasons": {reason: n}},
    "to_wire": {...}}``."""
    with _TALLY_LOCK:
        return {d: {**t, "reasons": dict(t["reasons"])} for d, t in _TALLY[leg].items()}


def reset_wire_counts() -> None:
    with _TALLY_LOCK:
        for t in (t for per in _TALLY.values() for t in per.values()):
            t["native"] = t["fallback"] = 0
            t["reasons"].clear()


def counts_since(before: dict, leg: str = "orswot") -> dict:
    """The growth of :func:`wire_counts` of ``leg`` since ``before`` (an
    earlier snapshot of it)."""
    now = wire_counts(leg)
    out = {}
    for d in _DIRECTIONS:
        b, t = before[d], now[d]
        reasons = {k: v - b["reasons"].get(k, 0) for k, v in t["reasons"].items()}
        out[d] = {"native": t["native"] - b["native"],
                  "fallback": t["fallback"] - b["fallback"],
                  "reasons": {k: v for k, v in reasons.items() if v}}
    return out


def native_fraction(counts: dict, direction: str) -> float | None:
    """Share of ``direction``'s blobs in ``counts`` that took the native
    codec, or None when there were none."""
    t = counts[direction]
    total = t["native"] + t["fallback"]
    return t["native"] / total if total else None


def concat_blobs(blobs: Sequence[bytes]):
    """``(buf, offsets)`` for the C parser: one contiguous buffer plus
    int64[n+1] blob boundaries."""
    n = len(blobs)
    buf = b"".join(blobs)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(b) for b in blobs), dtype=np.int64, count=n),
              out=offsets[1:])
    return buf, offsets


def slice_blobs(buf, offsets) -> list[bytes]:
    """Concatenated encoder output → per-object bytes (one copy per blob
    through a memoryview, no whole-buffer intermediate)."""
    mv = memoryview(buf)
    off = offsets.tolist()
    return [bytes(mv[off[i]:off[i + 1]]) for i in range(len(off) - 1)]


def planes_of_blobs(blobs, universe, index=None):
    """Unsigned numpy planes of ``blobs`` by the Python codec
    (``from_binary``, then
    :func:`~crdt_tpu_torch.batch.orswot_batch.scalar_planes`).  A blob
    that does not decode, is not an ORSWOT, or does not fit the universe
    raises :class:`WireFormatError` naming its index (``index[i]``: the
    caller's index of ``blobs[i]``)."""
    from ..utils.serde import from_binary
    from .orswot_batch import scalar_planes

    states = []
    for i, b in enumerate(blobs):
        try:
            states.append(from_binary(b))
        except ValueError as e:
            raise WireFormatError(f"blob {i if index is None else index[i]}: {e}") from e
    try:
        return scalar_planes(states, universe)
    except (ValueError, TypeError) as e:  # a capacity, an id, or not an ORSWOT
        if index is None:
            raise WireFormatError(str(e)) from e
        # scalar_planes reports indices into this sublist
        raise WireFormatError(
            f"{e} [object indices above are relative to the python-fallback "
            f"sublist; its blob indices are {index[:16]}{'...' if len(index) > 16 else ''}]"
        ) from e


def counters_overflow_zigzag(planes) -> bool:
    """True when any 8-byte counter plane holds a value at or above 2^63,
    whose zigzag encoding overflows the C emitter's uint64 (such states
    take the Python encoder).  4-byte planes never overflow and are not
    scanned."""
    for p in planes:
        if p.dtype.itemsize == 8 and p.size and int(p.max()) >= 1 << 63:
            return True
    return False


def orswot_planes_from_wire(blobs, universe, out=None):
    """Dense unsigned ORSWOT planes (host numpy) straight from wire blobs,
    with the full status triage.

    Returns ``(clock, ids, dots, d_ids, d_clocks)``, or ``None`` when the
    native fast path does not apply (a universe that is not
    identity-interned): the caller then decodes in Python.  ``out``: an
    optional preallocated plane set, reused across calls (the parser
    clears each object's rows itself).

    Hard statuses raise :class:`WireFormatError` with the caller's blob
    index; blobs outside the fast-path grammar are decoded by the scalar
    codec and their rows spliced in, so the result always equals the
    pure-Python decode."""
    cfg = universe.config
    if not universe.is_identity:
        _tally("from_wire", fallback=len(blobs), reason="non_identity")
        return None
    buf, offsets = concat_blobs(blobs)
    clock, ids, dots, d_ids, d_clocks, status = engine.orswot_ingest_wire(
        buf, offsets, cfg.num_actors, cfg.member_capacity, cfg.deferred_capacity,
        counter_dtype(cfg), out=out,
    )
    n_fb = 0
    if status.any():
        hard = np.nonzero(status > 1)[0]
        if hard.size:
            first = int(hard[0])
            code = int(status[first])
            if code == 2:
                raise WireFormatError(
                    f"object {first}: members > member_capacity {cfg.member_capacity}")
            if code == 3:
                raise WireFormatError(
                    f"object {first}: deferred rows > deferred_capacity "
                    f"{cfg.deferred_capacity}")
            raise WireFormatError(
                f"object {first}: actor outside the identity registry range "
                f"[0, {cfg.num_actors})")
        # status 1: decode those blobs in Python and splice their rows in
        # (fails exactly where the scalar path would)
        fb = np.nonzero(status == 1)[0].tolist()
        n_fb = len(fb)
        sub = planes_of_blobs([blobs[i] for i in fb], universe, index=fb)
        idx = np.asarray(fb, dtype=np.int64)
        for dst, src in zip((clock, ids, dots, d_ids, d_clocks), sub):
            dst[idx] = src
    _tally("from_wire", native=len(blobs) - n_fb, fallback=n_fb, reason="grammar")
    return clock, ids, dots, d_ids, d_clocks


def orswot_planes_to_wire(clock, ids, dots, d_ids, d_clocks, universe):
    """Wire blobs from dense unsigned host planes, byte-identical to
    ``to_binary`` of the scalar states.

    Returns the blob list, or ``None`` when the Python encoder must run
    (a universe that is not identity-interned, or the u64 zigzag guard):
    the caller serializes through ``to_binary`` then."""
    n = clock.shape[0]
    if n == 0:
        return []
    reason = None
    if not universe.is_identity:
        reason = "non_identity"
    elif counters_overflow_zigzag((clock, dots, d_clocks)):
        reason = "overflow_zigzag"
    if reason is not None:
        _tally("to_wire", fallback=n, reason=reason)
        return None
    buf, offsets = engine.orswot_encode_wire(clock, ids, dots, d_ids, d_clocks)
    _tally("to_wire", native=n)
    return slice_blobs(buf, offsets)


# ---- the flat types' legs ------------------------------------------------------


def decode_blobs(blobs, index, kind):
    """Scalar states of ``blobs[i]`` for ``i`` in ``index`` by the Python
    codec; a blob that does not decode, or is not a ``kind``, raises
    :class:`WireFormatError` naming its index."""
    from ..utils.serde import from_binary

    out = []
    for i in index:
        try:
            s = from_binary(blobs[i])
        except ValueError as e:
            raise WireFormatError(f"blob {i}: {e}") from e
        if not isinstance(s, kind):
            raise WireFormatError(f"blob {i}: a {type(s).__name__}, not a {kind.__name__}")
        out.append(s)
    return out


def planes_from_wire(blobs, universe, leg, kind, ingest, planes_of_scalars, errors=None):
    """Unsigned numpy planes (a tuple) of ``blobs`` — the shared ingest of
    the flat types.  ``ingest(buf, offsets) -> (*planes, status)`` runs
    the leg's parser; ``planes_of_scalars(states)`` packs scalar states of
    type ``kind`` into the same planes, for a universe that is not
    identity-interned and for the blobs of status 1.  A status above 1
    raises :class:`WireFormatError` with ``errors[status]`` formatted
    with the blob's index ``i`` (default: an actor out of range)."""
    def pack(index):
        states = decode_blobs(blobs, index, kind)
        try:
            return planes_of_scalars(states)
        except (ValueError, TypeError) as e:  # a capacity, an id, a counter's sign
            raise WireFormatError(f"{e} (object indices count the blobs {index[:16]})") from e

    n = len(blobs)
    if not universe.is_identity:
        _tally("from_wire", fallback=n, reason="non_identity", leg=leg)
        return pack(list(range(n)))
    *planes, status = ingest(*concat_blobs(blobs))
    fb = np.zeros(0, np.int64)
    if status.any():
        hard = np.nonzero(status > 1)[0]
        if hard.size:
            i = int(hard[0])
            msg = (errors or {}).get(int(status[i]), "object {i}: actor outside the identity "
                                     "registry range [0, {a})")
            raise WireFormatError(msg.format(i=i, a=universe.config.num_actors))
        fb = np.nonzero(status == 1)[0]
        for dst, src in zip(planes, pack(fb.tolist())):
            dst[fb] = src
    _tally("from_wire", native=n - fb.size, fallback=fb.size, reason="grammar", leg=leg)
    return tuple(planes)


def zigzag_overflow(counters=(), payload=()) -> bool:
    """The u64 egress guard on device planes: True when a 64-bit biased
    counter plane holds an unsigned value at or above 2^63 (biased >= 0)
    or a 64-bit payload plane holds an id at or above 2^63 (raw < 0).
    Reduced where the planes live; one scalar crosses to the host."""
    flags = [(c >= 0).any() for c in counters if c.dtype == torch.int64 and c.numel()]
    flags += [(p < 0).any() for p in payload if p.dtype == torch.int64 and p.numel()]
    return bool(torch.stack(flags).any()) if flags else False


def planes_to_wire(batch, n, universe, leg, encode, counters=(), payload=()):
    """Blobs of the ``n`` objects of ``batch``, byte-identical to
    ``to_binary`` of its ``to_scalar``: ``encode(batch.to_numpy())``
    returns the codec's ``(buf, offsets)``; a universe that is not
    identity-interned, or :func:`zigzag_overflow` of ``counters`` and
    ``payload``, takes the Python encoder."""
    from ..utils.serde import to_binary

    if n == 0:
        return []
    reason = None
    if not universe.is_identity:
        reason = "non_identity"
    elif zigzag_overflow(counters, payload):
        reason = "overflow_zigzag"
    if reason is not None:
        _tally("to_wire", fallback=n, reason=reason, leg=leg)
        return [to_binary(s) for s in batch.to_scalar(universe)]
    blobs = slice_blobs(*encode(batch.to_numpy()))
    _tally("to_wire", native=n, leg=leg)
    return blobs


def clockish_from_wire(blobs, universe, tag, kind, planes_of_scalars):
    """``[N, A]`` clock planes of VClock (``tag`` 0x20) or GCounter (0x22)
    blobs: :func:`planes_from_wire` through the tag-parameterised codec."""
    cfg = universe.config
    leg = "vclock" if tag == WIRE_TAG_VCLOCK else "gcounter"
    return planes_from_wire(
        blobs, universe, leg, kind,
        lambda buf, off: engine.clockish_ingest_wire(buf, off, tag, cfg.num_actors,
                                                     counter_dtype(cfg)),
        planes_of_scalars)[0]


def clockish_to_wire(batch, universe, tag):
    """Egress counterpart of :func:`clockish_from_wire` for a batch with
    ``clocks``."""
    leg = "vclock" if tag == WIRE_TAG_VCLOCK else "gcounter"
    return planes_to_wire(batch, batch.clocks.shape[0], universe, leg,
                          lambda host: engine.clockish_encode_wire(host, tag),
                          counters=(batch.clocks,))
