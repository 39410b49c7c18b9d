"""``ctypes`` bindings of the host wire codec (``wire_ingest.cpp``).

Numpy in, numpy out, on the host: the codec parses serde blobs straight
into dense planes (ORSWOT, and the flat types: MVReg, LWWReg, GSet,
VClock/GCounter, PNCounter) and encodes planes back into blobs, in
parallel over objects (a team of threads).  Every ingest returns its
planes and a ``uint8[n]`` status (0 ok, 1 outside the fast-path grammar:
decode that blob in Python; 2 and up: a hard error of the blob).  Counters cross this boundary UNSIGNED
(``uint32`` or ``uint64``, 0 = absent), as the JAX package's planes hold
them; the batch layer moves them into and out of the biased device
domain (:mod:`crdt_tpu_torch.dtypes`).  The library is built with
``g++`` at first use (:mod:`crdt_tpu_torch._build`); a failed build
raises :class:`~crdt_tpu_torch.error.KernelError`.

The size of the codec's thread team is set once for every binding by
:func:`set_threads` (0, the default, = the host's hardware threads).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

_SUFFIX = {np.dtype(np.uint32): "u32", np.dtype(np.uint64): "u64"}
_THREADS = 0


def set_threads(threads: int) -> None:
    """The codec's team size for every later call (0 = the host's
    hardware threads).  Tests hold it to 1 so that parallel test workers
    do not oversubscribe the host."""
    global _THREADS
    if threads < 0:
        raise ValueError(f"threads must be >= 0, got {threads}")
    _THREADS = int(threads)


def _fn(name: str, dtype):
    suf = _SUFFIX.get(np.dtype(dtype))
    if suf is None:
        raise TypeError(f"unsupported counter dtype {dtype!r} (uint32/uint64)")
    return getattr(_build.library("wire_ingest"), f"{name}_{suf}")


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _contig(*arrays):
    return tuple(np.ascontiguousarray(x) for x in arrays)


def _blobs(buf, offsets):
    """``(buf, offsets, n)`` as the parsers read them; raises unless the
    offsets are ``n + 1`` non-decreasing boundaries within ``buf``."""
    buf = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = offsets.shape[0] - 1
    if offsets.ndim != 1 or n < 0 or (n and (offsets[0] < 0 or offsets[-1] > buf.size
                                             or bool((np.diff(offsets) < 0).any()))):
        raise ValueError(f"offsets must be {n + 1} non-decreasing boundaries within the "
                         f"{buf.size}-byte buffer")
    return buf, offsets, n


def _check_planes(planes):
    """``(n, a, m, d, counter dtype)`` of C-contiguous planes ``(clock,
    ids, dots, d_ids, d_clocks)``; raises unless their shapes and dtypes
    agree, since the codec reads them by those sizes."""
    clock, ids, dots, d_ids, d_clocks = planes
    if clock.ndim != 2 or ids.ndim != 2 or d_ids.ndim != 2:
        raise ValueError("clock, ids and d_ids must be 2-D planes")
    n, a = clock.shape
    m, d = ids.shape[1], d_ids.shape[1]
    for name, x, shape in (("ids", ids, (n, m)), ("dots", dots, (n, m, a)),
                           ("d_ids", d_ids, (n, d)), ("d_clocks", d_clocks, (n, d, a))):
        if x.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {x.shape}")
    for name, x in (("ids", ids), ("d_ids", d_ids)):
        if x.dtype != np.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    dt = np.dtype(clock.dtype)
    for x in (dots, d_clocks):
        if np.dtype(x.dtype) != dt:
            raise TypeError(f"counter dtype mismatch: {dt} vs {x.dtype}")
    return n, a, m, d, dt


def orswot_ingest_wire(buf, offsets, a: int, m: int, d: int, dtype, out=None):
    """Parallel decode of ``n`` concatenated ORSWOT blobs straight into
    dense planes.

    ``buf``: the concatenated serde blobs (bytes or uint8 array);
    ``offsets``: int64[n+1] blob boundaries.  Identity interning is
    assumed (the caller guarantees an identity universe): actor index ==
    actor value (< ``a``), member id == member value (int32).

    ``out``: optional preallocated ``(clock, ids, dots, d_ids, d_clocks)``
    to decode into (the shapes and dtypes the call would otherwise
    allocate, C-contiguous).  The parser then clears each object's rows
    itself before writing (``clear=1``), so buffers may be REUSED across
    calls — fresh plane sets per call page-fault GBs of zeroed memory at
    fleet scale, which is what the wire loop's staging sets avoid.

    Returns ``(clock, ids, dots, d_ids, d_clocks, status)`` where
    ``status`` is uint8[n]: 0 ok, 1 outside the fast-path grammar (decode
    it in Python), 2 member overflow, 3 deferred overflow, 4 actor out of
    range.  Rows with nonzero status are left empty."""
    buf, offsets, n = _blobs(buf, offsets)
    dt = np.dtype(dtype)
    expect = (((n, a), dt), ((n, m), np.dtype(np.int32)), ((n, m, a), dt),
              ((n, d), np.dtype(np.int32)), ((n, d, a), dt))
    if out is None:
        clear = 0
        planes = tuple(np.full(shape, -1 if dt_ == np.int32 else 0, dtype=dt_)
                       for shape, dt_ in expect)
    else:
        clear = 1
        planes = tuple(out)
        for name, x, (shape, dt_) in zip(("clock", "ids", "dots", "d_ids", "d_clocks"),
                                         planes, expect):
            if (not isinstance(x, np.ndarray) or x.shape != shape or x.dtype != dt_
                    or not x.flags.c_contiguous):
                raise ValueError(
                    f"out[{name}]: need C-contiguous {dt_}{shape}, got "
                    f"{getattr(x, 'dtype', type(x))}{getattr(x, 'shape', '')}")
    status = np.zeros(n, dtype=np.uint8)
    _fn("orswot_ingest_wire", dt)(
        _ptr(buf), _ptr(offsets), n, a, m, d, *(_ptr(x) for x in planes),
        _ptr(status), clear, _THREADS,
    )
    return (*planes, status)


def _encode(fn, planes, lead, n_out):
    """The codec's two passes: blob sizes into ``offsets[1:]``, prefix
    sum, then the blobs into one buffer."""
    offsets = np.zeros(n_out + 1, dtype=np.int64)
    fn(*(_ptr(x) for x in planes), *lead, _ptr(offsets), None, _THREADS)
    np.cumsum(offsets, out=offsets)
    buf = np.empty(int(offsets[-1]), dtype=np.uint8)
    fn(*(_ptr(x) for x in planes), *lead, _ptr(offsets), _ptr(buf), _THREADS)
    return buf, offsets


def orswot_encode_wire(clock, ids, dots, d_ids, d_clocks):
    """Parallel encode of dense planes into serde blobs — the inverse of
    :func:`orswot_ingest_wire`, byte-identical to ``to_binary`` of the
    per-object scalar states (identity universes).

    Returns ``(buf, offsets)``: concatenated blobs and int64[n+1]
    boundaries (blob i is ``buf[offsets[i]:offsets[i+1]]``)."""
    planes = _contig(clock, ids, dots, d_ids, d_clocks)
    n, a, m, d, dt = _check_planes(planes)
    return _encode(_fn("orswot_encode_wire", dt), planes, (n, a, m, d), n)


def _parse(fn, buf, offsets, shapes, dtype, *lead):
    """Run the parser ``fn`` over the blobs into zeroed planes of
    ``shapes`` (``n`` leading each) and return ``(*planes, status)``."""
    buf, offsets, n = _blobs(buf, offsets)
    planes = tuple(np.zeros((n, *shape), dtype=dtype) for shape in shapes)
    status = np.zeros(n, dtype=np.uint8)
    fn(_ptr(buf), _ptr(offsets), n, *lead, *(_ptr(x) for x in planes), _ptr(status),
       _THREADS)
    return (*planes, status)


def _same_dtype(*arrays):
    dt = np.dtype(arrays[0].dtype)
    if any(np.dtype(x.dtype) != dt for x in arrays[1:]):
        raise TypeError(f"counter dtype mismatch: {[str(x.dtype) for x in arrays]}")
    return dt


def mvreg_ingest_wire(buf, offsets, k: int, a: int, dtype):
    """MVReg blobs → ``(clocks [n, k, a], vals [n, k], status)``; status 2:
    more than ``k`` values, 4: an actor outside ``[0, a)``."""
    return _parse(_fn("mvreg_ingest_wire", dtype), buf, offsets, ((k, a), (k,)), dtype, k, a)


def mvreg_encode_wire(clocks, vals):
    """``(buf, offsets)`` of MVReg blobs from ``clocks [n, k, a]`` and
    ``vals [n, k]`` (one unsigned dtype)."""
    clocks, vals = _contig(clocks, vals)
    n, k, a = clocks.shape
    if vals.shape != (n, k):
        raise ValueError(f"vals: expected shape {(n, k)}, got {vals.shape}")
    return _encode(_fn("mvreg_encode_wire", _same_dtype(clocks, vals)), (clocks, vals),
                   (n, k, a), n)


def lww_ingest_wire(buf, offsets):
    """LWWReg blobs → ``(vals, markers, status)``, both ``uint64[n]``."""
    return _parse(_build.library("wire_ingest").lww_ingest_wire_u64, buf, offsets,
                  ((), ()), np.uint64)


def lww_encode_wire(vals, markers):
    """``(buf, offsets)`` of LWWReg blobs from ``uint64[n]`` columns."""
    vals, markers = _contig(vals, markers)
    if vals.ndim != 1 or markers.shape != vals.shape:
        raise ValueError(f"vals and markers must be one [n] shape, got {vals.shape}, "
                         f"{markers.shape}")
    if _same_dtype(vals, markers) != np.uint64:
        raise TypeError(f"lww_encode_wire needs uint64 columns, got {vals.dtype}")
    return _encode(_build.library("wire_ingest").lww_encode_wire_u64, (vals, markers),
                   (vals.shape[0],), vals.shape[0])


def gset_ingest_wire(buf, offsets, u: int):
    """GSet blobs → ``(bits bool[n, u], status)``; status 2: a member id
    at or above ``u``."""
    return _parse(_build.library("wire_ingest").gset_ingest_wire, buf, offsets, ((u,),),
                  np.bool_, u)


def gset_encode_wire(bits):
    """``(buf, offsets)`` of GSet blobs from ``bits bool[n, u]``."""
    (bits,) = _contig(np.asarray(bits, dtype=np.bool_).view(np.uint8))
    n, u = bits.shape
    return _encode(_build.library("wire_ingest").gset_encode_wire, (bits,), (n, u), n)


def clockish_ingest_wire(buf, offsets, tag: int, a: int, dtype):
    """VClock (tag 0x20) or GCounter (0x22) blobs → ``(clocks [n, a],
    status)``."""
    return _parse(_fn("clockish_ingest_wire", dtype), buf, offsets, ((a,),), dtype, tag, a)


def clockish_encode_wire(clocks, tag: int):
    """``(buf, offsets)`` of clock blobs under ``tag`` from ``[n, a]``."""
    (clocks,) = _contig(clocks)
    n, a = clocks.shape
    return _encode(_fn("clockish_encode_wire", clocks.dtype), (clocks,), (n, tag, a), n)


def pncounter_ingest_wire(buf, offsets, a: int, dtype):
    """PNCounter blobs → ``(planes [n, 2, a], status)`` (P = plane 0)."""
    return _parse(_fn("pncounter_ingest_wire", dtype), buf, offsets, ((2, a),), dtype, a)


def pncounter_encode_wire(planes):
    """``(buf, offsets)`` of PNCounter blobs from ``[n, 2, a]`` planes."""
    (planes,) = _contig(planes)
    n, two, a = planes.shape
    if two != 2:
        raise ValueError(f"PNCounter planes must be [N, 2, A], got {planes.shape}")
    return _encode(_fn("pncounter_encode_wire", planes.dtype), (planes,), (n, a), n)


# ---- the Map legs: the map's planes around each key slot's value planes ----


def _map_shapes(a: int, k: int, d: int, value):
    """``(shape, holds ids)`` per plane of a Map: ``clock [a]``, ``keys
    [k]``, ``eclocks [k, a]``, the value's planes under the key axis,
    ``d_keys [d]``, ``d_clocks [d, a]``."""
    return [((a,), False), ((k,), True), ((k, a), False),
            *(((k, *s), ids) for s, ids in value), ((d,), True), ((d, a), False)]


def _mvreg_shapes(a, kv):
    return [((kv, a), False), ((kv,), False)]


def _orswot_shapes(a, m, d):
    return [((a,), False), ((m,), True), ((m, a), False), ((d,), True), ((d, a), False)]


def _map_parse(name, buf, offsets, shapes, dtype, *lead):
    """Run Map ingest ``name`` into fresh planes of ``shapes`` (ids filled
    with -1, counters zeroed): ``(*planes, status)``."""
    buf, offsets, n = _blobs(buf, offsets)
    planes = tuple(np.full((n, *s), -1, np.int32) if ids else np.zeros((n, *s), dtype)
                   for s, ids in shapes)
    status = np.zeros(n, dtype=np.uint8)
    _fn(name, dtype)(_ptr(buf), _ptr(offsets), n, *lead, *(_ptr(x) for x in planes),
                     _ptr(status), _THREADS)
    return (*planes, status)


def _map_encode(name, planes, shapes_of, lead):
    """``(buf, offsets)`` of Map encoder ``name`` over ``planes``, after
    checking them against ``shapes_of`` (their sizes ``lead``)."""
    planes = _contig(*planes)
    n = planes[0].shape[0]
    dt = _same_dtype(*(x for x in planes if x.dtype != np.int32))
    for i, (x, (s, ids)) in enumerate(zip(planes, shapes_of, strict=True)):
        if x.shape != (n, *s) or (x.dtype == np.int32) != ids:
            raise ValueError(f"plane {i}: expected {'int32' if ids else dt}{(n, *s)}, got "
                             f"{x.dtype}{x.shape}")
    return _encode(_fn(name, dt), planes, (n, *lead), n)


def map_mvreg_ingest_wire(buf, offsets, a: int, k: int, d: int, kv: int, dtype):
    """Map<K, MVReg> blobs → ``(clock, keys, eclocks, vclocks [n, k, kv, a],
    vvals [n, k, kv], d_keys, d_clocks, status)``; status 2: keys > ``k``,
    3: deferred rows > ``d``, 4: an actor out of range, 5: an antichain
    wider than ``kv``."""
    return _map_parse("map_mvreg_ingest_wire", buf, offsets,
                      _map_shapes(a, k, d, _mvreg_shapes(a, kv)), dtype, a, k, d, kv)


def map_mvreg_encode_wire(clock, keys, eclocks, vclocks, vvals, d_keys, d_clocks):
    """``(buf, offsets)`` of Map<K, MVReg> blobs, byte-identical to
    ``to_binary`` of the scalar maps."""
    (n, a), k, d, kv = clock.shape, keys.shape[1], d_keys.shape[1], vvals.shape[2]
    return _map_encode("map_mvreg_encode_wire",
                       (clock, keys, eclocks, vclocks, vvals, d_keys, d_clocks),
                       _map_shapes(a, k, d, _mvreg_shapes(a, kv)), (a, k, d, kv))


def map_orswot_ingest_wire(buf, offsets, a: int, k: int, d: int, mv: int, dv: int, dtype):
    """Map<K, Orswot> blobs → ``(clock, keys, eclocks, vclock, vids, vdots,
    vdids, vdclocks, d_keys, d_clocks, status)``; status 5: a value set's
    members > ``mv`` or deferred rows > ``dv``."""
    return _map_parse("map_orswot_ingest_wire", buf, offsets,
                      _map_shapes(a, k, d, _orswot_shapes(a, mv, dv)), dtype, a, k, d, mv, dv)


def map_orswot_encode_wire(clock, keys, eclocks, vclock, vids, vdots, vdids, vdclocks,
                           d_keys, d_clocks):
    """``(buf, offsets)`` of Map<K, Orswot> blobs."""
    (n, a), k, d = clock.shape, keys.shape[1], d_keys.shape[1]
    mv, dv = vids.shape[2], vdids.shape[2]
    return _map_encode("map_orswot_encode_wire",
                       (clock, keys, eclocks, vclock, vids, vdots, vdids, vdclocks, d_keys,
                        d_clocks),
                       _map_shapes(a, k, d, _orswot_shapes(a, mv, dv)), (a, k, d, mv, dv))


def map_map_mvreg_ingest_wire(buf, offsets, a: int, k: int, d: int, k2: int, d2: int,
                              kv: int, dtype):
    """Map<K, Map<K2, MVReg>> blobs → the outer map's planes around the
    inner map's (``iclock, ikeys, ieclocks, vclocks, vvals, id_keys,
    id_clocks``, each under the outer key axis) and ``status``; status 5:
    an inner map's keys > ``k2``, deferred rows > ``d2`` or an antichain
    wider than ``kv``."""
    inner = _map_shapes(a, k2, d2, _mvreg_shapes(a, kv))
    return _map_parse("map_map_mvreg_ingest_wire", buf, offsets,
                      _map_shapes(a, k, d, inner), dtype, a, k, d, k2, d2, kv)


def map_map_mvreg_encode_wire(*planes):
    """``(buf, offsets)`` of Map<K, Map<K2, MVReg>> blobs from the twelve
    planes of :func:`map_map_mvreg_ingest_wire`."""
    (n, a), k, d = planes[0].shape, planes[1].shape[1], planes[10].shape[1]
    k2, d2, kv = planes[4].shape[2], planes[8].shape[2], planes[7].shape[3]
    return _map_encode("map_map_mvreg_encode_wire", planes,
                       _map_shapes(a, k, d, _map_shapes(a, k2, d2, _mvreg_shapes(a, kv))),
                       (a, k, d, k2, d2, kv))
