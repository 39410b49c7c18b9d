"""Seeded key streams for read and write traffic (the port of the JAX
package's ``utils/workload.py``; host numpy, the same keys for the same
seed).

``zipf_s`` skews object ranks (rank r drawn with weight 1/(r+1)^s, 0 is
uniform), ``burst_len`` holds each drawn key for that many draws,
``read_frac`` flags a share of draws as reads off a stream of its own,
and ``permute_ranks`` scatters the ranking over the object axis.
"""

from __future__ import annotations

import numpy as np


class WorkloadGen:
    """Deterministic key-skew and burst workload over ``n_objects`` keys."""

    def __init__(self, n_objects: int, *, seed: int = 0, zipf_s: float = 0.0,
                 burst_len: int = 1, permute_ranks: bool = False, read_frac: float = 0.0):
        if n_objects < 1:
            raise ValueError(f"n_objects {n_objects} < 1")
        if zipf_s < 0.0:
            raise ValueError(f"zipf_s {zipf_s} < 0")
        if burst_len < 1:
            raise ValueError(f"burst_len {burst_len} < 1")
        if not 0.0 <= read_frac <= 1.0:
            raise ValueError(f"read_frac {read_frac} not in [0, 1]")
        self.n_objects = int(n_objects)
        self.zipf_s = float(zipf_s)
        self.burst_len = int(burst_len)
        self.read_frac = float(read_frac)
        self._rng = np.random.RandomState(seed)
        # the read coin and the hot-object pick have streams of their own,
        # so neither knob shifts the key sequence
        self._read_rng = np.random.RandomState(seed ^ 0x0EAD)
        self._hot_rng = np.random.RandomState(seed ^ 0x407)
        self._hot_obj: int | None = None
        self._next_member = 0
        if zipf_s == 0.0:
            self._cdf = None
        else:
            w = 1.0 / np.power(np.arange(1, n_objects + 1, dtype=np.float64), zipf_s)
            self._cdf = np.cumsum(w / w.sum())
        self._rank_to_obj = (np.random.RandomState(seed ^ 0x5EED).permutation(n_objects)
                             .astype(np.int64) if permute_ranks else None)
        self._burst_left = 0
        self._burst_key = 0

    def _ranks(self, count: int) -> np.ndarray:
        if self._cdf is None:
            return self._rng.randint(0, self.n_objects, size=count).astype(np.int64)
        u = self._rng.random_sample(count)
        return np.searchsorted(self._cdf, u, side="right").astype(np.int64)

    def _to_objects(self, ranks: np.ndarray) -> np.ndarray:
        return ranks if self._rank_to_obj is None else self._rank_to_obj[ranks]

    def draw(self, count: int) -> np.ndarray:
        """``int64[count]`` keys, each held for ``burst_len`` draws (bursts
        carry across calls)."""
        out = np.empty(count, dtype=np.int64)
        i = 0
        while i < count:
            if self._burst_left == 0:
                self._burst_key = int(self._to_objects(self._ranks(1))[0])
                self._burst_left = self.burst_len
            take = min(self._burst_left, count - i)
            out[i:i + take] = self._burst_key
            self._burst_left -= take
            i += take
        return out

    def draw_mixed(self, count: int) -> tuple[np.ndarray, np.ndarray]:
        """``(keys, is_read)``: the keys of :meth:`draw`, ``read_frac`` of
        them flagged as reads."""
        keys = self.draw(count)
        if self.read_frac == 0.0:
            return keys, np.zeros(count, dtype=bool)
        return keys, self._read_rng.random_sample(count) < self.read_frac

    def hot_object_members(self, count: int) -> tuple[int, np.ndarray]:
        """``(hot_object, members)``: ``count`` distinct ascending member
        ids on one seed-stable hot object, continuing across calls."""
        if self._hot_obj is None:
            if self._cdf is None:
                self._hot_obj = int(self._hot_rng.randint(0, self.n_objects))
            else:
                self._hot_obj = int(self._to_objects(np.zeros(1, dtype=np.int64))[0])
        members = np.arange(self._next_member, self._next_member + int(count), dtype=np.int64)
        self._next_member += int(count)
        return self._hot_obj, members

    def sample_rows(self, k: int) -> np.ndarray:
        """``k`` distinct rows, ascending, sampled by the same skew (Gumbel
        top-k over the Zipf weights)."""
        k = min(int(k), self.n_objects)
        if k <= 0:
            return np.zeros(0, dtype=np.int64)
        if self._cdf is None:
            return np.sort(self._rng.choice(self.n_objects, size=k, replace=False).astype(np.int64))
        w = np.diff(self._cdf, prepend=0.0)
        g = np.log(w) + self._rng.gumbel(size=self.n_objects)
        ranks = np.argpartition(-g, k - 1)[:k].astype(np.int64)
        return np.sort(self._to_objects(ranks))
