"""GCounterBatch — N grow-only counters (`gcounter.rs`): the clock rows
of :mod:`~crdt_tpu_torch.batch.vclock_batch` under the GCounter wire tag,
with ``inc`` and the unbiased ``value``."""

from __future__ import annotations

from ..ops import clock_ops, counter_ops
from ..scalar.gcounter import GCounter
from .vclock_batch import _ClockRows
from .wirebulk import WIRE_TAG_GCOUNTER


class GCounterBatch(_ClockRows):
    _TAG = WIRE_TAG_GCOUNTER
    _KIND = GCounter

    @staticmethod
    def _inner(state):
        return state.inner

    @staticmethod
    def _outer(vc):
        return GCounter(vc)

    def inc(self, actor_idx) -> "GCounterBatch":
        """One increment per counter at ``actor_idx`` (`gcounter.rs:71-73`)."""
        idx = self._rows(actor_idx)
        counter = clock_ops.inc_counter(self.clocks, idx)
        return GCounterBatch(clock_ops.witness(self.clocks, idx, counter))

    def value(self):
        """int64 ``[N]``: the bits of the unsigned sum (`gcounter.rs:76-78`)."""
        return counter_ops.gcounter_value(self.clocks)
