"""Session-consistency modes as admission predicates over version
vectors (the port of the JAX package's ``serve/consistency.py``; host
numpy).

``eventual`` is always admitted; ``ryw`` (read-your-writes) and
``monotonic`` are admitted once the visible clock covers the request's
floor (a writer's ack vector, or the token of the client's last frame);
``frontier`` needs a stability frontier
(:mod:`crdt_tpu_torch.obs.stability`), and rows whose add clock exceeds
their subtree's frontier clock are stamped ``ST_NOT_STABLE``.  Version
vectors compare zero-padded (implied-0 counters, `vclock.rs:206-210`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .query import ST_NOT_STABLE, ST_OK

MODE_EVENTUAL = "eventual"
MODE_RYW = "ryw"
MODE_MONOTONIC = "monotonic"
MODE_FRONTIER = "frontier"

MODES = (MODE_EVENTUAL, MODE_RYW, MODE_MONOTONIC, MODE_FRONTIER)

#: wire code per mode (and back)
MODE_CODES = {m: i for i, m in enumerate(MODES)}
CODE_MODES = {i: m for i, m in enumerate(MODES)}


def _pad(v, width: int) -> np.ndarray:
    v = np.asarray(v, np.uint64).reshape(-1)
    if v.size < width:
        v = np.concatenate([v, np.zeros(width - v.size, np.uint64)])
    return v


def covers(visible, require) -> bool:
    """``visible >= require`` pointwise after zero-padding."""
    if require is None:
        return True
    require = np.asarray(require, np.uint64).reshape(-1)
    if require.size == 0:
        return True
    visible = np.asarray(visible, np.uint64).reshape(-1)
    w = max(visible.size, require.size)
    return bool((_pad(visible, w) >= _pad(require, w)).all())


class Admission(NamedTuple):
    """One admission ruling: admitted, or why not (``not_visible``:
    may park; ``no_frontier``: terminal)."""

    admitted: bool
    reason: Optional[str] = None


def admit(mode: str, require, visible_vv, frontier_vv=None) -> Admission:
    """Rule on one read batch."""
    if mode not in MODES:
        raise ValueError(f"unknown consistency mode {mode!r} (modes: {MODES})")
    if mode == MODE_EVENTUAL:
        return Admission(True)
    if mode == MODE_FRONTIER:
        return Admission(True) if frontier_vv is not None else Admission(False, "no_frontier")
    if covers(visible_vv, require):
        return Admission(True)
    return Admission(False, "not_visible")


def stability_statuses(frame, subtree_clocks, span: int) -> np.ndarray:
    """The uint8 status column of a gathered frame: ``ST_OK`` where a
    row's add clock is at or below its subtree's frontier clock,
    ``ST_NOT_STABLE`` elsewhere."""
    b = len(frame)
    if b == 0 or subtree_clocks is None:
        return np.zeros(b, np.uint8)
    subtree_clocks = np.asarray(subtree_clocks, np.uint64)
    sub = np.minimum(frame.obj // max(int(span), 1), subtree_clocks.shape[0] - 1)
    floor = subtree_clocks[sub]
    add = np.asarray(frame.add_clock, np.uint64)
    w = max(add.shape[1], floor.shape[1])

    def widen(m):
        return np.pad(m, ((0, 0), (0, w - m.shape[1])))

    ok = (widen(add) <= widen(floor)).all(axis=1)
    return np.where(ok, ST_OK, ST_NOT_STABLE).astype(np.uint8)
