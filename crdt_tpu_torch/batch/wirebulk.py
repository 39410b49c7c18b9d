"""The ORSWOT bulk wire legs on the host: blobs ⇄ unsigned numpy planes.

The port of the ORSWOT legs of the JAX package's ``batch/wirebulk.py``,
shared by :meth:`OrswotBatch.from_wire <crdt_tpu_torch.batch.OrswotBatch.
from_wire>` / ``to_wire`` and :class:`~crdt_tpu_torch.batch.wireloop.
PipelinedWireLoop`: concatenate blobs, parse them in parallel with the
host codec (:mod:`crdt_tpu_torch.native.engine`), triage the per-blob
status, splice blobs outside the fast-path grammar in through the scalar
codec, and take the Python codec whenever the fast path cannot apply
(a universe that is not identity-interned, or u64 counters whose zigzag
exceeds the C encoder's range).  Either way the result equals the
pure-Python codec: ``from_binary`` + ``from_scalar`` on the way in,
``to_binary`` of ``to_scalar`` on the way out.

The codec is built at first use and a failed build raises; there is no
"engine missing" route.  Native and fallback blob counts, with the
reason of each fallback, are kept as plain integers
(:func:`wire_counts`, :func:`reset_wire_counts`).
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np

from ..config import counter_dtype
from ..error import WireFormatError
from ..native import engine

_DIRECTIONS = ("from_wire", "to_wire")
_TALLY_LOCK = threading.Lock()  # the wire loop parses on a thread of its own
_TALLY = {d: {"native": 0, "fallback": 0, "reasons": {}} for d in _DIRECTIONS}


def _tally(direction: str, native: int = 0, fallback: int = 0,
           reason: str | None = None) -> None:
    """Add one bulk call's blobs to the counts of ``direction``.
    Reasons: ``non_identity`` (the universe is not identity-interned),
    ``grammar`` (a blob outside the fast-path grammar, spliced in through
    the scalar codec), ``overflow_zigzag`` (u64 counters at or above
    2^63, past the native encoder's range)."""
    with _TALLY_LOCK:
        t = _TALLY[direction]
        t["native"] += native
        t["fallback"] += fallback
        if reason is not None and fallback:
            t["reasons"][reason] = t["reasons"].get(reason, 0) + fallback


def wire_counts() -> dict:
    """Blobs that took the native codec and the Python one, per direction,
    since the last reset: ``{"from_wire": {"native": n, "fallback": n,
    "reasons": {reason: n}}, "to_wire": {...}}``."""
    with _TALLY_LOCK:
        return {d: {**t, "reasons": dict(t["reasons"])} for d, t in _TALLY.items()}


def reset_wire_counts() -> None:
    with _TALLY_LOCK:
        for t in _TALLY.values():
            t["native"] = t["fallback"] = 0
            t["reasons"].clear()


def counts_since(before: dict) -> dict:
    """The growth of :func:`wire_counts` since ``before`` (an earlier
    snapshot of it)."""
    now = wire_counts()
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
