"""Checkpoint and resume of dense batch states: the port's copy of the JAX
package's ``utils/checkpoint.py``, writing the same bytes.

A batch (any of the eight ``*Batch`` types of :mod:`crdt_tpu_torch.batch`)
and its :class:`~crdt_tpu_torch.utils.interning.Universe` go into one
numpy ``.npz`` container: ``__meta__`` (the format version, the batch
type, the static fields and the leafless ones, serde-encoded), then
``__universe__`` (the config and the registries), then each field in
dataclass order as the JAX package's unsigned planes, a nested tuple
field (``MapBatch.vals``) under ``name__i_j_k`` leaves in depth-first
order.  The counters the port holds biased in signed types are written
unsigned through the batches' ``to_numpy`` and biased again on load
through ``from_numpy(..., device=)``; ``MapBatch``'s value kernel goes
into the meta as :func:`~crdt_tpu_torch.batch.val_kernels.kernel_to_spec`.
``np.savez`` stores members uncompressed under a fixed 1980 timestamp,
so equal states give equal bytes in both packages.

The port's ``CrdtConfig`` has no ``merge_impl`` field: the universe blob
carries the JAX package's default (``"auto"``) so that its bytes match,
and a loaded one is checked and dropped.  Every decode fault raises
:class:`~crdt_tpu_torch.error.CheckpointFormatError` (a missing file
stays ``FileNotFoundError``).
"""

from __future__ import annotations

import dataclasses
import io
import os
import zipfile
import zlib
from typing import Any, Tuple

import numpy as np

from ..config import MERGE_IMPLS, CrdtConfig
from ..error import CheckpointFormatError
from . import serde
from .interning import IdentityRegistry, Registry, Universe

FORMAT_VERSION = 1

#: fields held as metadata, not arrays (``MapBatch``'s value kernel)
_STATIC_FIELDS = ("kernel",)

#: the JAX config's field the port lacks, at the JAX default
_MERGE_IMPL_DEFAULT = "auto"


def _batch_types() -> dict:
    from .. import batch

    return {name: getattr(batch, name) for name in batch.__all__ if name.endswith("Batch")}


def _universe_blob(universe: Universe) -> bytes:
    cfg = universe.config
    config = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    config["merge_impl"] = _MERGE_IMPL_DEFAULT
    return serde.to_binary({
        "config": config,
        "actors": universe.actors.values(),
        "members": universe.members.values(),
        "identity": [isinstance(universe.actors, IdentityRegistry),
                     isinstance(universe.members, IdentityRegistry)],
    })


def _universe_from_blob(blob: bytes) -> Universe:
    payload = serde.from_binary(bytes(blob))
    config = dict(payload["config"])
    impl = config.pop("merge_impl", _MERGE_IMPL_DEFAULT)
    if impl != _MERGE_IMPL_DEFAULT and impl not in MERGE_IMPLS:
        raise ValueError(f"unknown merge_impl {impl!r}")
    cfg = CrdtConfig(**config)
    ident = payload.get("identity", False)
    if isinstance(ident, bool):  # blobs from before the per-registry marker
        ident = [ident, ident]
    id_actors, id_members = ident
    actors = IdentityRegistry(capacity=cfg.num_actors) if id_actors \
        else Registry(capacity=cfg.num_actors)
    universe = Universe(cfg, actors=actors,
                        members=IdentityRegistry() if id_members else Registry())
    if not id_actors:
        universe.actors.intern_all(payload["actors"])
    if not id_members:
        universe.members.intern_all(payload["members"])
    return universe


def _leaves(value, path=()):
    """``(index path, leaf)`` of a nested tuple, depth first (a plain
    array is one leaf at the empty path)."""
    if isinstance(value, (tuple, list)):
        for i, v in enumerate(value):
            yield from _leaves(v, path + (i,))
    elif value is not None:
        yield path, value


def _rebuild_tuple(rows):
    """A nested tuple from ``(index path, leaf)`` rows."""
    if len(rows) == 1 and rows[0][0] == ():
        return rows[0][1]
    groups: dict = {}
    for path, leaf in rows:
        groups.setdefault(path[0], []).append((path[1:], leaf))
    return tuple(_rebuild_tuple(groups[i]) for i in range(len(groups)))


def _as_pure_tuples(value):
    """Nested sequences → nested tuples (serde gives them back as lists)."""
    if isinstance(value, (tuple, list)):
        return tuple(_as_pure_tuples(v) for v in value)
    return value


def host_arrays(batch_state: Any, universe: Universe) -> dict:
    """The npz members of a checkpoint, in order: ``__meta__``,
    ``__universe__``, then the planes copied to the host once, through the
    batch's ``to_numpy``."""
    from ..batch.val_kernels import kernel_to_spec

    cls_name = type(batch_state).__name__
    if cls_name not in _batch_types():
        raise TypeError(f"not a checkpointable batch type: {cls_name}")
    names = [f.name for f in dataclasses.fields(batch_state) if f.name not in _STATIC_FIELDS]
    planes = batch_state.to_numpy()
    if len(names) == 1:
        planes = (planes,)
    arrays, static, empty = {}, {}, {}
    for name, value in zip(names, planes):
        leaves = list(_leaves(value))
        if not leaves:
            empty[name] = _as_pure_tuples(value)  # a leafless field writes no member
        for idx, leaf in leaves:
            key = f"{name}__{'_'.join(map(str, idx))}" if idx else name
            arrays[key] = np.asarray(leaf)
    for name in _STATIC_FIELDS:
        if hasattr(batch_state, name):
            static[name] = kernel_to_spec(getattr(batch_state, name))
    meta = serde.to_binary({"version": FORMAT_VERSION, "type": cls_name, "static": static,
                            "empty": empty})
    return {"__meta__": np.frombuffer(meta, dtype=np.uint8),
            "__universe__": np.frombuffer(_universe_blob(universe), dtype=np.uint8), **arrays}


def npz_buffer(arrays: dict) -> memoryview:
    """:func:`host_arrays`' members written as an npz into memory, as a view
    of the buffer they were written to (no second copy)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getbuffer()


def save(path, batch_state: Any, universe: Universe) -> None:
    """Write ``batch_state`` and its universe to ``path`` (a filename, which
    gets ``.npz`` appended when it lacks it, or a file-like object)."""
    if isinstance(path, (str, os.PathLike)):
        p = os.fspath(path)
        if not p.endswith(".npz"):
            path = p + ".npz"
    np.savez(path, **host_arrays(batch_state, universe))


def save_bytes(batch_state: Any, universe: Universe) -> bytes:
    """:func:`save` into a byte string."""
    return bytes(npz_buffer(host_arrays(batch_state, universe)))


def decode_host(z) -> tuple:
    """The host half of a decode: ``(cls, fields, universe)`` of an open
    npz container, ``fields`` the JAX package's numpy planes by name and
    the static fields rebuilt.  Every fault raises
    :class:`CheckpointFormatError`."""
    from ..batch.val_kernels import kernel_from_spec

    try:
        meta = serde.from_binary(z["__meta__"].tobytes())
        if not isinstance(meta, dict) or meta.get("version") != FORMAT_VERSION:
            raise CheckpointFormatError(
                "unsupported checkpoint version: "
                f"{(meta.get('version') if isinstance(meta, dict) else meta)!r}")
        cls = _batch_types().get(meta.get("type"))
        if cls is None:
            raise CheckpointFormatError(f"unknown batch type in checkpoint: {meta.get('type')!r}")
        universe = _universe_from_blob(z["__universe__"].tobytes())
        static = meta.get("static", {})
        fields = {}
        for f in dataclasses.fields(cls):
            if f.name in _STATIC_FIELDS:
                fields[f.name] = kernel_from_spec(static[f.name])
            elif f.name in z:
                fields[f.name] = z[f.name]
            else:
                prefix = f.name + "__"
                rows = [(tuple(int(s) for s in key[len(prefix):].split("_")), z[key])
                        for key in z.files if key.startswith(prefix)]
                if rows:
                    fields[f.name] = _rebuild_tuple(sorted(rows, key=lambda r: r[0]))
                elif f.name in meta.get("empty", {}):
                    fields[f.name] = _as_pure_tuples(meta["empty"][f.name])
                else:
                    raise CheckpointFormatError(f"checkpoint missing arrays for field {f.name!r}")
    except CheckpointFormatError:
        raise
    except (KeyError, AttributeError, TypeError, IndexError, ValueError, zipfile.BadZipFile,
            zlib.error, EOFError) as e:
        # npz members read lazily: a corrupt member raises here, at z[key]
        raise CheckpointFormatError(f"malformed checkpoint: {type(e).__name__}: {e}") from e
    return cls, fields, universe


def to_batch(decoded: tuple, device=None):
    """The device half: ``(batch, universe)`` from :func:`decode_host`'s
    result, biased and copied to ``device`` (default ``"cuda"``)."""
    cls, fields, universe = decoded
    planes = [v for k, v in fields.items() if k not in _STATIC_FIELDS]
    static = {k: v for k, v in fields.items() if k in _STATIC_FIELDS}
    try:
        return cls.from_numpy(*planes, **static, device=device), universe
    except (TypeError, ValueError, IndexError) as e:  # planes of the wrong dtype or shape
        raise CheckpointFormatError(f"malformed checkpoint: {type(e).__name__}: {e}") from e


def decode_checkpoint(z, device=None) -> Tuple[Any, Universe]:
    """``(batch, universe)`` of an open npz container, on ``device``."""
    return to_batch(decode_host(z), device)


def _open(path):
    try:
        container = np.load(path)
    except (FileNotFoundError, PermissionError, IsADirectoryError):
        raise  # real I/O failures are not data corruption
    except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
        raise CheckpointFormatError(f"not a checkpoint container: {e}") from e
    if not isinstance(container, np.lib.npyio.NpzFile):
        raise CheckpointFormatError(f"not a checkpoint container: expected npz, got "
                                    f"{type(container).__name__}")
    return container


def load_host(path) -> tuple:
    """:func:`decode_host` of a file (``.npz`` appended as :func:`save`
    does) or a file-like object."""
    if isinstance(path, (str, os.PathLike)):
        p = os.fspath(path)
        if not p.endswith(".npz") and (os.path.exists(p + ".npz") or not os.path.exists(p)):
            path = p + ".npz"
    with _open(path) as z:
        return decode_host(z)


def load(path, device=None) -> Tuple[Any, Universe]:
    """Load a checkpoint written by :func:`save` (either package's) onto
    ``device``: ``(batch, universe)`` with bit-exact planes."""
    return to_batch(load_host(path), device)


def load_bytes(data, device=None) -> Tuple[Any, Universe]:
    """Inverse of :func:`save_bytes`."""
    return to_batch(load_host(io.BytesIO(data)), device)
