"""Host-level join executor — elastic recovery for device batches.

The reference's fault tolerance is algebraic: idempotent merge makes
redelivery safe (`traits.rs:36`).  Dense batches add two failure modes
and their recoveries:

* **capacity overflow** — a join's survivors outgrow the padded member
  or deferred slot axes.  The kernels report a per-object overflow
  bitmap; recovery regrows only the axis that overflowed
  (``with_capacity``) and re-runs the join, which is safe because the
  regrown batch is the same CRDT state.
* **transient device failure** — a ``RuntimeError`` whose message marks
  it as transient (device out of memory, a lost connection).  Recovery
  requeues the same join up to ``max_retries`` times.  A kernel that does
  not build or launch (:class:`~crdt_tpu_torch.error.KernelError`) is
  deterministic and is never requeued.

The executor joins a queue of batches into one state — as a left fold,
or, on CUDA by default, as the type's pairwise-tree reduction with
recovery at whole-tree granularity — finishing with a defer-plunger
self-merge so buffered removes flush.  What happened is counted in
:class:`JoinStats`, and each regrow and transient retry leaves an
``executor.regrow`` / ``executor.transient_retry`` flight-recorder event
(:meth:`~crdt_tpu_torch.obs.capacity.CapacityTracker.regrow_timeline`).
Under a profiler a join is an ``executor/join_all`` span, each pairwise
merge of the fold an ``executor/merge`` and each regrow an
``executor/regrow`` (:func:`~crdt_tpu_torch.utils.tracing.span`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

from ..error import CapacityOverflowError, KernelError
from ..obs import events as obs_events
from ..utils.tracing import span


@dataclasses.dataclass
class JoinStats:
    """What happened during a ``join_all`` run."""

    joins: int = 0
    overflow_regrows: int = 0
    transient_retries: int = 0
    final_member_capacity: Optional[int] = None
    final_deferred_capacity: Optional[int] = None


class JoinError(RuntimeError):
    """A join could not be completed within the executor's limits."""


# substrings that mark a RuntimeError as plausibly transient
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline",
    "aborted",
    "cancelled",
    "preempt",
    "connection",
    "socket",
    "device gone",
    "device lost",
    "out of memory",
    "resource exhausted",
)


def _is_transient(err: BaseException) -> bool:
    if isinstance(err, (JoinError, KernelError)):
        return False
    msg = str(err).lower()
    return any(marker in msg for marker in _TRANSIENT_MARKERS)


def _capacities(batch):
    return getattr(batch, "member_capacity", None), getattr(batch, "deferred_capacity", None)


@dataclasses.dataclass
class JoinExecutor:
    """Joins batches, with overflow regrowth and transient retry.

    ``strategy``: ``"sequential"`` (left fold, recovery per pair merge),
    ``"tree"`` (the batch type's ``join_fleet``, recovery re-runs the
    whole tree) or ``"auto"`` (tree for batches on a CUDA device — the
    launch shape the card wants — sequential elsewhere).
    ``max_capacity`` bounds geometric regrowth (x``grow_factor`` per
    overflow); ``max_retries`` bounds requeues of a transient failure.
    """

    max_capacity: int = 1 << 16
    max_retries: int = 2
    grow_factor: int = 2
    retry_backoff_s: float = 0.5  # doubles per retry; 0 disables sleeping
    strategy: str = "auto"

    def join_all(self, batches: Sequence[Any], plunger: bool = True,
                 stats: Optional[JoinStats] = None) -> Any:
        """Fold ``batches`` into one joined batch (anti-entropy)."""
        if not batches:
            raise ValueError("join_all needs at least one batch")
        stats = stats if stats is not None else JoinStats()
        with span("executor/join_all"):
            if self._use_tree(batches):
                return self._join_tree(list(batches), plunger, stats)
            acc = batches[0]
            for nxt in batches[1:]:
                acc, nxt = self._equalize(acc, nxt)
                acc = self._merge_recovering(acc, nxt, stats)
            if plunger:
                acc = self._merge_recovering(acc, acc, stats)
            stats.final_member_capacity, stats.final_deferred_capacity = _capacities(acc)
            return acc

    def _use_tree(self, batches: Sequence[Any]) -> bool:
        if self.strategy not in ("sequential", "tree", "auto"):
            raise ValueError(
                f"unknown strategy {self.strategy!r}; use 'sequential', 'tree' or 'auto'"
            )
        if self.strategy == "sequential" or len(batches) < 2:
            return False
        if not hasattr(type(batches[0]), "join_fleet"):
            if self.strategy == "tree":
                raise ValueError(
                    f"strategy='tree' requires {type(batches[0]).__name__} to "
                    "implement join_fleet; use 'sequential' or 'auto'"
                )
            return False
        if self.strategy == "tree":
            return True
        device = getattr(batches[0], "device", None)
        return getattr(device, "type", None) == "cuda"

    def _grown(self, cur: int, hit: bool) -> int:
        if not hit:
            return cur
        # never shrink: a batch may already exceed max_capacity
        return max(cur, min(max(1, cur) * self.grow_factor, self.max_capacity))

    def _regrow(self, overflow: CapacityOverflowError, batch, schedule: str, stats):
        """New (member, deferred) capacities after ``overflow``; raises
        :class:`JoinError` when ``max_capacity`` leaves no room."""
        m, d = batch.member_capacity, batch.deferred_capacity
        new_m = self._grown(m, overflow.member)
        new_d = self._grown(d, overflow.deferred)
        if new_m == m and new_d == d:
            raise JoinError(
                f"{schedule} join overflowed at max_capacity={self.max_capacity} "
                f"(member_capacity={m}, deferred_capacity={d})"
            ) from overflow
        stats.overflow_regrows += 1
        # before/after stamps: obs.capacity's regrow_timeline reads them
        obs_events.record("executor.regrow", schedule=schedule, member_capacity_before=m,
                          deferred_capacity_before=d, member_capacity=new_m,
                          deferred_capacity=new_d)
        return new_m, new_d

    def _retry(self, err: RuntimeError, retries: int, schedule: str, stats) -> int:
        """Count one transient retry (sleeping the backoff) or re-raise."""
        if not _is_transient(err):
            raise err
        retries += 1
        if retries > self.max_retries:
            raise JoinError(f"{schedule} join failed after {self.max_retries} retries") from err
        stats.transient_retries += 1
        obs_events.record("executor.transient_retry", schedule=schedule, attempt=retries,
                          error=str(err)[:200])
        if self.retry_backoff_s > 0:
            time.sleep(self.retry_backoff_s * (2 ** (retries - 1)))
        return retries

    def _join_tree(self, batches: list, plunger: bool, stats: JoinStats) -> Any:
        """Whole-tree join with the same two recoveries as the fold."""
        if hasattr(batches[0], "with_capacity"):
            m = max(b.member_capacity for b in batches)
            d = max(b.deferred_capacity for b in batches)
            batches = [
                b if (b.member_capacity, b.deferred_capacity) == (m, d)
                else b.with_capacity(m, d)
                for b in batches
            ]
        retries = 0
        while True:
            try:
                out = type(batches[0]).join_fleet(batches, check=True, plunger=plunger)
                stats.joins += len(batches) - 1 + (1 if plunger else 0)
                stats.final_member_capacity, stats.final_deferred_capacity = _capacities(out)
                return out
            except CapacityOverflowError as overflow:
                if not hasattr(batches[0], "with_capacity"):
                    raise
                with span("executor/regrow"):
                    new_m, new_d = self._regrow(overflow, batches[0], "tree", stats)
                    batches = [b.with_capacity(new_m, new_d) for b in batches]
            except RuntimeError as err:
                retries = self._retry(err, retries, "tree", stats)

    def _equalize(self, a: Any, b: Any):
        """Bring two batches to a common capacity before merging."""
        if not hasattr(a, "with_capacity") or not hasattr(b, "with_capacity"):
            return a, b
        m = max(a.member_capacity, b.member_capacity)
        d = max(a.deferred_capacity, b.deferred_capacity)
        if (a.member_capacity, a.deferred_capacity) == (m, d) == (
            b.member_capacity, b.deferred_capacity,
        ):
            return a, b
        return a.with_capacity(m, d), b.with_capacity(m, d)

    def _merge_recovering(self, acc: Any, nxt: Any, stats: JoinStats) -> Any:
        retries = 0
        while True:
            try:
                with span("executor/merge"):
                    out = acc.merge(nxt, check=True)
                stats.joins += 1
                return out
            except CapacityOverflowError as overflow:
                if not hasattr(acc, "with_capacity"):
                    raise
                with span("executor/regrow"):
                    new_m, new_d = self._regrow(overflow, acc, "sequential", stats)
                    acc = acc.with_capacity(new_m, new_d)
                    nxt = nxt.with_capacity(new_m, new_d)
            except RuntimeError as err:
                retries = self._retry(err, retries, "sequential", stats)


def join_all(batches: Sequence[Any], **kwargs: Any) -> Any:
    """One-shot convenience: ``JoinExecutor(...).join_all(batches)``."""
    executor_kwargs = {
        k: kwargs.pop(k)
        for k in ("max_capacity", "max_retries", "grow_factor", "retry_backoff_s", "strategy")
        if k in kwargs
    }
    return JoinExecutor(**executor_kwargs).join_all(batches, **kwargs)
