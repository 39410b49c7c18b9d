"""The biased counter domain.

PyTorch has no ``maximum``, ``le`` or ``sub`` for unsigned 32- and
64-bit tensors on the CPU, so counter planes live on the device biased
into the signed type of the same width: ``x ^ 0x8000_0000`` for u32 →
int32, ``x ^ (1 << 63)`` for u64 → int64.  The XOR bias is an
order-preserving bijection, and the ORSWOT merge only compares, maxes
and selects counters (it never adds them), so the signed domain is exact
over the full unsigned range.  Counter 0 becomes the type's minimum,
:func:`zero_of` (the kernels' ``ZERO``).  Member ids stay int32 with
``EMPTY = -1``.

Payload ids — the values of MVReg and LWWReg registers, interned
member ids — are not counters: they are only compared with ``==`` and
``!=``.  They are held raw, the unsigned id's bits viewed in the signed
type of its width with no bias (:func:`payload_to_device`,
:func:`payload_to_numpy`), so a cleared payload slot is 0 as in the JAX
package, while a cleared counter is :func:`zero_of`.

The bias is applied and removed only at the package edge:
:meth:`OrswotBatch.from_numpy <crdt_tpu_torch.batch.OrswotBatch.from_numpy>`
and ``to_numpy`` (and so ``from_wire`` and ``to_wire``, whose host codec
reads and writes unsigned counters), and around the copies of
:class:`~crdt_tpu_torch.batch.wireloop.PipelinedWireLoop` (biased on the
device after each host-to-device copy, unbiased before the copy back).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

EMPTY = -1
ZERO32 = -(2**31)  # biased counter 0 at 32 bits (the kernels' ZERO)
ZERO64 = -(2**63)
INT32_MAX = 2**31 - 1

_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}
_UNSIGNED = {torch.int32: np.uint32, torch.int64: np.uint64}


def torch_counter_dtype(bits: int) -> torch.dtype:
    """The device counter dtype for ``counter_bits``."""
    if bits == 32:
        return torch.int32
    if bits == 64:
        return torch.int64
    raise ValueError(f"counter_bits must be 32 or 64, got {bits!r}")


def zero_of(dtype: torch.dtype) -> int:
    """Biased counter 0 of a device counter dtype."""
    return torch.iinfo(dtype).min


def bias_np(x: np.ndarray) -> np.ndarray:
    """Unsigned numpy counters → biased signed numpy counters."""
    x = np.asarray(x)
    signed = _SIGNED.get(x.dtype)
    if signed is None:
        raise TypeError(f"counter planes must be uint32 or uint64, got {x.dtype}")
    return np.ascontiguousarray(x).view(signed) ^ signed(np.iinfo(signed).min)


def unbias_np(x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`bias_np`."""
    x = np.ascontiguousarray(x)
    signed = x.dtype.type
    unsigned = np.uint32 if x.dtype == np.int32 else np.uint64
    return (x ^ signed(np.iinfo(signed).min)).view(unsigned)


_H2D_LOCK = threading.Lock()
_H2D_BYTES = [0]


def to_device(x: np.ndarray, device) -> torch.Tensor:
    """Biased (or id) numpy plane → a contiguous tensor on ``device`` that
    owns its memory (never a view of the caller's array).  Bytes copied
    to a CUDA device are counted (:func:`h2d_bytes`)."""
    t = torch.tensor(np.ascontiguousarray(x), device=device)
    if t.device.type == "cuda":
        with _H2D_LOCK:
            _H2D_BYTES[0] += t.numel() * t.element_size()
    return t


def h2d_bytes() -> int:
    """Bytes that :func:`to_device` has copied to a CUDA device so far
    (the batches' host-to-device copies: dense planes or COO columns)."""
    with _H2D_LOCK:
        return _H2D_BYTES[0]


def as_counters(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Counters for a plane of ``dtype`` on ``device``: a tensor is taken
    as already biased; anything else as unsigned counters, cast to the
    plane's width (wrapping, as numpy's ``astype``), biased and copied."""
    if isinstance(x, torch.Tensor):
        if x.dtype != dtype:
            raise TypeError(f"biased counters must be {dtype}, got {x.dtype}")
        return x.to(device)
    return to_device(bias_np(np.asarray(x).astype(_UNSIGNED[dtype])), device)


def payload_to_device(x, device) -> torch.Tensor:
    """Unsigned numpy payload ids → raw signed ids on ``device``."""
    x = np.ascontiguousarray(x)
    if x.dtype not in _SIGNED:
        raise TypeError(f"payload ids must be uint32 or uint64, got {x.dtype}")
    return to_device(x.view(_SIGNED[x.dtype]), device)


def as_payload(x, like: torch.Tensor) -> torch.Tensor:
    """Payload ids for a plane ``like``: a tensor is taken as raw ids;
    anything else as unsigned ids, cast to the plane's width."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device, like.dtype)
    return payload_to_device(np.asarray(x).astype(_UNSIGNED[like.dtype]), like.device)


def payload_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Raw signed payload ids → unsigned numpy ids (inverse of
    :func:`payload_to_device`)."""
    return t.detach().cpu().numpy().view(_UNSIGNED[t.dtype])


def counters_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Biased device counter plane → unsigned numpy plane (unbiased where
    the plane lives, then copied to the host once)."""
    if t.dtype not in _UNSIGNED:
        raise TypeError(f"biased counter planes are int32 or int64, got {t.dtype}")
    return (t.detach() ^ zero_of(t.dtype)).cpu().numpy().view(_UNSIGNED[t.dtype])


def bias_torch_u32(x: torch.Tensor) -> torch.Tensor:
    """``torch.uint32`` tensor → biased int32 (the kernels' domain)."""
    if x.dtype != torch.uint32:
        raise TypeError(f"expected a torch.uint32 counter plane, got {x.dtype}")
    return x.contiguous().view(torch.int32) ^ ZERO32


def unbias_torch_u32(x: torch.Tensor) -> torch.Tensor:
    """Biased int32 → ``torch.uint32`` (inverse of :func:`bias_torch_u32`)."""
    if x.dtype != torch.int32:
        raise TypeError(f"expected a biased int32 counter plane, got {x.dtype}")
    return (x ^ ZERO32).view(torch.uint32)
