"""Per-object fingerprints computed from the dense planes (the port of
the JAX package's ``sync/digest.py``, u64 lanes only).

One u64 lane per object, a function of the CRDT state only: every cell
hashes to a lane keyed by its semantic coordinates (actor-name salt,
member-name salt, counter, plane tag), never its slot, and lanes
combine by XOR, so the digest is invariant to slot order and capacity
padding.  Two replicas exchange digest vectors and ship only the rows
that differ (:mod:`crdt_tpu_torch.sync.delta`).

The lanes are byte-equal to the JAX package's.  In torch they are
int64 holding the u64 bits: the multiply and add wrap mod 2^64 as the
unsigned ones do, each logical right shift is an arithmetic ``>>``
masked after (torch has no ``>>`` for ``uint64`` on the CPU), and the
XOR reduction folds an axis by halving (torch has no XOR reduction).
The value hashed is the unbiased counter, zero-extended to 64 bits; a
cell is populated when it differs from the biased zero.  The ``[N, M,
A]`` lane temporaries are 8 bytes a cell, so :func:`orswot_digest` runs
in row chunks (a row's digest does not depend on its neighbours).

Name-keyed salts (:func:`actor_salt_table`, :func:`member_salt_table`,
numpy and hashlib on the host) make two processes that interned the
same names in different orders produce the same digest vectors.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import weakref

import numpy as np
import torch

from ..dtypes import EMPTY, zero_of

# plane tags keep the per-plane lane families disjoint
_T_CLOCK = 0x9E3779B97F4A7C15
_T_ENTRY = 0xC2B2AE3D27D4EB4F
_T_DOT = 0x165667B19E3779F9
_T_DREF = 0x27D4EB2F165667C5
_T_DCLK = 0x85EBCA77C2B2AE63
_T_COUNTER = 0x2545F4914F6CDD1D
_T_LWW = 0x9E3779B185EBCA87

_K1 = 0xFF51AFD7ED558CCD  # actor-lane multiplier
_K2 = 0xC4CEB9FE1A85EC53  # member-lane multiplier

# salt-domain tags: actor-name and member-name salts in disjoint families
_T_ASALT = 0x6C62272E07BB0142
_T_MSALT = 0x27220A95FE7D4D7C

_U64 = (1 << 64) - 1

#: cells of one row chunk's ``[rows, M, A]`` lane temporaries
_CHUNK_CELLS = 1 << 24


def _splitmix64_host(x: np.ndarray) -> np.ndarray:
    """The SplitMix64 finalizer on host u64 arrays (the device
    :func:`mix`)."""
    x = np.asarray(x, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def stable_name_salt(value, domain: int) -> int:
    """A process-independent u64 salt for one registered name: integers
    through SplitMix64 (as the identity route computes on the device),
    ``str``/``bytes`` through blake2b, anything else through its
    ``repr``."""
    if isinstance(value, bool) or not isinstance(value, int):
        if isinstance(value, str):
            data = b"s:" + value.encode("utf-8")
        elif isinstance(value, (bytes, bytearray, memoryview)):
            data = b"b:" + bytes(value)
        else:
            data = b"r:" + repr(value).encode("utf-8")
        h = int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
        return int(_splitmix64_host(np.uint64((h ^ domain) & _U64))[()])
    return int(_splitmix64_host(np.uint64((value + domain) & _U64))[()])


@functools.lru_cache(maxsize=64)
def _default_actor_salts(num_actors: int) -> np.ndarray:
    """Salts of an identity actor registry: the column index is the name."""
    return _splitmix64_host(np.arange(num_actors, dtype=np.uint64) + np.uint64(_T_ASALT))


#: salt tables per universe, weakref'd; interning a new name changes the
#: registry size the entry is stamped with
_SALT_LOCK = threading.Lock()
_SALT_TABLES: dict = {}


def _salt_cache_entry(universe) -> dict:
    key = id(universe)
    with _SALT_LOCK:
        ent = _SALT_TABLES.get(key)
        if ent is None or ent["ref"]() is not universe:
            ent = {"ref": weakref.ref(universe)}
            _SALT_TABLES[key] = ent
            if len(_SALT_TABLES) > 64:
                for k in [k for k, e in _SALT_TABLES.items() if e["ref"]() is None]:
                    del _SALT_TABLES[k]
        return ent


def actor_salt_table(universe=None, num_actors: int | None = None) -> np.ndarray:
    """``uint64[A]`` name-keyed actor salts of ``universe`` (the
    index-keyed default when None, which is what an identity universe
    derives).  Columns past the interned count salt on their index."""
    if universe is None:
        return _default_actor_salts(int(num_actors))
    a = universe.config.num_actors
    if getattr(universe.actors, "identity", False):
        return _default_actor_salts(a)
    ent = _salt_cache_entry(universe)
    n = len(universe.actors)
    cached = ent.get("actors")
    if cached is not None and cached[0] == n:
        return cached[1]
    salts = np.array([stable_name_salt(universe.actors.lookup(i), _T_ASALT)
                      for i in range(min(n, a))], dtype=np.uint64)
    if n < a:
        salts = np.concatenate([salts, _default_actor_salts(a)[n:]])
    ent["actors"] = (n, salts)
    return salts


def member_salt_table(universe=None):
    """``uint64[R]`` name-keyed member salts of an interned universe (R
    the registered count padded to a power of two, at least 8), or None
    for identity universes, whose salts are computed from the id itself."""
    if universe is None or getattr(universe.members, "identity", False):
        return None
    ent = _salt_cache_entry(universe)
    n = len(universe.members)
    cached = ent.get("members")
    if cached is not None and cached[0] == n:
        return cached[1]
    r = max(8, 1 << max(0, (max(1, n) - 1).bit_length()))
    salts = np.zeros(r, dtype=np.uint64)
    for i in range(n):
        salts[i] = stable_name_salt(universe.members.lookup(i), _T_MSALT)
    ent["members"] = (n, salts)
    return salts


# -- u64 lanes in int64 --------------------------------------------------------


def _s64(v: int) -> int:
    """A u64 constant as the int64 holding its bits."""
    v &= _U64
    return v - (1 << 64) if v >> 63 else v


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix(x: torch.Tensor) -> torch.Tensor:
    """The SplitMix64 finalizer on int64 lanes."""
    x = (x ^ _lsr(x, 30)) * _s64(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _s64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def _lane(value, key, tag):
    """One cell's lane: mix the coordinate key, fold the counter in, mix."""
    return mix(value ^ mix(key + _s64(tag)))


def xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis by halving (zero, the XOR identity, pads
    an odd width)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return x[..., 0]


def _masked_fold(h, live, dims: int = 1):
    """XOR of the lanes ``h`` where ``live``, over the last ``dims`` axes."""
    h = torch.where(live, h, torch.zeros((), dtype=h.dtype, device=h.device))
    return xor_fold(h.flatten(-dims) if dims > 1 else h)


def counter_lanes(t: torch.Tensor) -> torch.Tensor:
    """Biased counters → their unsigned values as int64 lanes (a u32
    counter zero-extended, as the JAX package's ``astype(uint64)``)."""
    u = t ^ zero_of(t.dtype)
    return u.to(torch.int64) & 0xFFFFFFFF if t.dtype == torch.int32 else u


def _salts_tensor(salts: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(salts, dtype=np.uint64).view(np.int64)).to(device)


def _member_salts(ids, mtable):
    """Per-slot member salts: the name-keyed table (interned universes,
    ids clipped into it) or SplitMix of the id itself (identity)."""
    if mtable is None:
        return mix(ids.to(torch.int64) + _s64(_T_MSALT))
    return mtable[ids.to(torch.int64).clamp(0, mtable.shape[0] - 1)]


def _orswot_rows(clock, ids, dots, d_ids, d_clocks, asalts, mtable):
    akey = asalts * _s64(_K1)
    z = zero_of(clock.dtype)
    out = _masked_fold(_lane(counter_lanes(clock), akey, _T_CLOCK), clock != z)
    live = ids != EMPTY
    mkey = _member_salts(ids, mtable) * _s64(_K2)
    out ^= _masked_fold(mix(mkey + _s64(_T_ENTRY)), live)
    hd = _lane(counter_lanes(dots), mkey[..., None] + akey, _T_DOT)
    out ^= _masked_fold(hd, dots != z, 2)
    dkey = _member_salts(d_ids, mtable) * _s64(_K2)
    out ^= _masked_fold(mix(dkey + _s64(_T_DREF)), d_ids != EMPTY)
    hh = _lane(counter_lanes(d_clocks), dkey[..., None] + akey, _T_DCLK)
    return out ^ _masked_fold(hh, d_clocks != z, 2)


def _host_u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def orswot_digest(clock, ids, dots, d_ids, d_clocks, universe=None) -> np.ndarray:
    """``uint64[N]`` fingerprints of N ORSWOT states from their biased
    planes, computed where the planes live in row chunks."""
    return _host_u64(orswot_digest_rows(clock, ids, dots, d_ids, d_clocks, universe))


def orswot_digest_rows(clock, ids, dots, d_ids, d_clocks, universe=None) -> torch.Tensor:
    """The fingerprints of :func:`orswot_digest` as an int64 tensor (the
    u64 bits) where the planes live: the per-row body the mesh step
    digests each rank's rows with before it gathers them."""
    dev = clock.device
    asalts = _salts_tensor(actor_salt_table(universe, num_actors=clock.shape[-1]), dev)
    mt = member_salt_table(universe)
    mtable = None if mt is None else _salts_tensor(mt, dev)
    n = clock.shape[0]
    per_row = max(1, (ids.shape[-1] + d_ids.shape[-1]) * clock.shape[-1])
    step = max(1, _CHUNK_CELLS // per_row)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, step):
        out[s:s + step] = _orswot_rows(*(p[s:s + step] for p in (clock, ids, dots, d_ids,
                                                                  d_clocks)), asalts, mtable)
    return out


def _counter_cell_salts(universe, tail_shape, num_actors: int) -> np.ndarray:
    """Per-cell salts of counter planes: the actor-name salt per column,
    domain-shifted per leading plane (the PNCounter P/N split)."""
    asalts = actor_salt_table(universe, num_actors=num_actors)
    width = int(np.prod(tail_shape[:-1], dtype=np.int64))
    if width == 1:
        return asalts
    shift = np.arange(width, dtype=np.uint64)[:, None] * np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        cells = _splitmix64_host(asalts[None, :] + shift)
    return cells.reshape(-1)


def counter_digest(planes, universe=None) -> np.ndarray:
    """``uint64[N]`` fingerprints of biased counter planes, ``[N, A]``
    (VClock, GCounter) or ``[N, 2, A]`` (PNCounter)."""
    cells = _salts_tensor(_counter_cell_salts(universe, tuple(planes.shape[1:]),
                                              int(planes.shape[-1])), planes.device)
    flat = planes.reshape(planes.shape[0], -1)
    h = _lane(counter_lanes(flat), cells * _s64(_K1), _T_COUNTER)
    return _host_u64(_masked_fold(h, flat != zero_of(flat.dtype)))


def lww_digest(vals, markers, universe=None) -> np.ndarray:
    """``uint64[N]`` fingerprints of N LWW registers: raw payload ids
    (salted through the member table) and biased markers."""
    mt = member_salt_table(universe)
    if mt is None:
        vkey = _member_salts(vals, None)
    else:
        mtable = _salts_tensor(mt, vals.device)
        # the payload id's unsigned order: an id at or above 2^63 clips high
        v = vals.to(torch.int64)
        vkey = mtable[torch.where(v < 0, mt.shape[0] - 1, v.clamp(max=mt.shape[0] - 1))]
    return _host_u64(mix(counter_lanes(markers) ^ mix(vkey * _s64(_K2) + _s64(_T_LWW))))


def digest_of(batch, universe=None) -> np.ndarray:
    """Per-object digest vector (host ``uint64[N]``) of an ORSWOT,
    PNCounter, GCounter, VClock or LWWReg batch, computed from the
    planes as they are now.  ``universe`` selects the name-keyed salts;
    None is what an identity universe derives."""
    if hasattr(batch, "d_ids"):
        return orswot_digest(batch.clock, batch.ids, batch.dots, batch.d_ids, batch.d_clocks,
                             universe)
    if hasattr(batch, "planes"):
        return counter_digest(batch.planes, universe)
    if hasattr(batch, "clocks") and batch.clocks.dim() == 2:
        return counter_digest(batch.clocks, universe)
    if hasattr(batch, "markers"):
        return lww_digest(batch.vals, batch.markers, universe)
    raise TypeError(f"no digest for {type(batch).__name__} "
                    "(supported: Orswot/PNCounter/GCounter/VClock/LWWReg batches)")


def digest_tree_of(batch, universe=None, k: int | None = None):
    """The digest tree over ``digest_of(batch)``
    (:func:`crdt_tpu_torch.sync.tree.build_tree`, on the batch's device)."""
    from . import tree as tree_mod

    dev = next(getattr(batch, f) for f in ("clock", "planes", "clocks", "markers")
               if hasattr(batch, f)).device
    return tree_mod.build_tree(digest_of(batch, universe),
                               k=tree_mod.TREE_K if k is None else k, device=dev)


def _clock_plane(batch):
    """The clock plane of an ORSWOT, PNCounter, GCounter or VClock
    batch, or None for LWW."""
    if hasattr(batch, "d_ids"):
        return batch.clock
    if hasattr(batch, "planes"):
        return batch.planes
    if hasattr(batch, "clocks") and batch.clocks.dim() == 2:
        return batch.clocks
    if hasattr(batch, "markers"):
        return None
    raise TypeError(f"no version vector for {type(batch).__name__}")


def version_vector(batch) -> np.ndarray | None:
    """The fleet's version-vector summary: the pointwise max of every
    object's clock (``uint64[A]``, ``[2*A]`` for PNCounter), or None for
    LWW.  The max runs in the biased domain (whose order is the unsigned
    one) and is unbiased on the way out."""
    clocks = _clock_plane(batch)
    if clocks is None:
        return None
    if clocks.shape[0] == 0:
        return np.zeros(clocks.shape[1:], dtype=np.uint64).reshape(-1)
    vv = (clocks.amax(dim=0) ^ zero_of(clocks.dtype)).cpu().numpy()
    return vv.view(np.uint32 if vv.dtype == np.int32 else np.uint64).astype(np.uint64).reshape(-1)


def fleet_summary(digests: np.ndarray) -> tuple[int, int]:
    """``(xor_fold, count)`` of a digest vector."""
    d = np.asarray(digests, dtype=np.uint64)
    fold = int(np.bitwise_xor.reduce(d)) if d.size else 0
    return fold, int(d.size)
