"""Anti-entropy rejoin: replicas that diverged during a partition are
joined whole, round after round, through ``JoinExecutor.join_all``.

Set-up makes the ``replicas`` states once from the seed; every round
hands the same inputs to the program and keeps nothing of the round
before.  ``per_round`` says how much one round joins: ``node`` (every
object the chip holds) or ``vnode`` (one vnode's share, cycling over the
config's ``vnodes``).  A round ends when the joined state is on the
device and the device has finished.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import fleets, yardstick
from ..reference import orswot as ref_orswot
from ..reference import scalar as ref_scalar
from . import Answers

#: rows per call of the ORSWOT reference (its transients grow with the
#: square of the member slots)
REF_ROWS = 8192


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rows(state, idx):
    """A state's rows ``idx`` (nested tuples kept)."""
    return tuple(_rows(x, idx) if isinstance(x, tuple) else x[idx] for x in state)


def _leaves(state):
    return [y for x in state for y in (_leaves(x) if isinstance(x, tuple) else [x])]


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from crdt_tpu_torch import JoinExecutor, JoinStats

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.crdt = cfg["crdt"]
        sizes = cfg["sizes"]
        r = sizes["replicas"]
        if self.crdt == "orswot":
            from crdt_tpu_torch import OrswotBatch

            self.reps = fleets.orswot_replicas(
                seed, device, n=sizes["objects"], a=sizes["num_actors"],
                m=sizes["member_capacity"], d=sizes["deferred_capacity"], r=r, n_val=cfg["n_val"],
                **cfg["fleet"])
            self.caps = (sizes["member_capacity"], sizes["deferred_capacity"])
            make = OrswotBatch
        elif self.crdt == "map":
            from crdt_tpu_torch import MapBatch, MapKernel, OrswotKernel

            self.reps = fleets.map_replicas(
                seed, device, n=sizes["objects"], a=sizes["num_actors"], k=sizes["key_capacity"],
                d=sizes["deferred_capacity"], m=sizes["member_capacity"],
                dv=sizes["set_deferred_capacity"], r=r, n_val=cfg["n_val"], **cfg["fleet"])
            kernel = MapKernel(
                key_capacity=sizes["key_capacity"], deferred_capacity=sizes["deferred_capacity"],
                num_actors=sizes["num_actors"], counter_bits=32,
                val_kernel=OrswotKernel(sizes["member_capacity"], sizes["set_deferred_capacity"],
                                        sizes["num_actors"], 32))
            self.caps = (sizes["key_capacity"], sizes["deferred_capacity"],
                         sizes["member_capacity"], sizes["set_deferred_capacity"])

            def make(*state):
                return MapBatch.from_state(state, kernel)
        else:
            raise ValueError(f"no rejoin for crdt {self.crdt!r}")
        n = sizes["objects"]
        parts = 1 if mix["per_round"] == "node" else cfg["vnodes"]
        if n % parts:
            raise ValueError(f"{n} objects do not split into {parts} vnodes")
        self.span = n // parts
        self.units = [[make(*_rows(rep, slice(v * self.span, (v + 1) * self.span)))
                       for rep in self.reps] for v in range(parts)]
        self.executor = JoinExecutor()
        self._stats_cls = JoinStats
        self.out = None
        self.last_unit = 0

    @property
    def merges_per_round(self) -> int:
        return self.span * len(self.reps)

    def join(self, unit: int, stats=None):
        out = self.executor.join_all(self.units[unit], stats=stats)
        _sync(self.device)
        return out

    def warm(self) -> None:
        self.join(0)

    def window(self, seconds: float, join=None) -> dict:
        """Rounds until ``seconds`` have passed; ``join`` replaces the
        program's join (the fault tests)."""
        join = join or self.join
        stats = self._stats_cls()
        walls, i = [], 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            t = time.perf_counter()
            self.out = None  # no round holds the one before
            self.last_unit = i % len(self.units)
            self.out = join(self.last_unit, stats)
            walls.append(time.perf_counter() - t)
            i += 1
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t0
        return {"window_s": window_s, "round_walls": walls, "rounds": len(walls),
                "attempted": len(walls), "failed": 0,
                "merges": len(walls) * self.merges_per_round,
                "regrows": stats.overflow_regrows, "retries": stats.transient_retries}

    def traced(self, tracer) -> dict:
        """``traced_units`` rounds under ``tracer``."""
        units = self.mix["traced_units"]
        with tracer:
            for i in range(units):
                self.out = None
                self.last_unit = i % len(self.units)
                self.out = self.join(self.last_unit)
        return {"rounds": units}

    def end_to_end(self, res: dict) -> dict:
        return {"merge_rate": res["merges"] / res["window_s"],
                "round_p95_ms": yardstick.p95(res["round_walls"]) * 1e3}

    def checks(self, seed: int, res: dict) -> list:
        """``(name, value, limit)``: the last round's output against the
        reference on the sampled rows, bit for bit."""
        rows = self.sample(seed)
        got = self.judged(rows)
        want, over = self.reference(rows)
        return [("rows_differing", rows_differing(got, want), 0),
                ("ref_overflow_rows", over, 0), ("regrows", res["regrows"], 0)]

    def sample(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng([int(seed), 0x5A])
        return np.sort(rng.choice(self.span, min(self.span, self.mix["sample"]), replace=False))

    def judged(self, rows: np.ndarray):
        """The last round's output at ``rows`` (planes for sets, canonical
        maps for maps); frees the program's state."""
        out, self.out, self.units = self.out, None, None
        if isinstance(out, Answers):
            return out.at(rows)
        idx = torch.as_tensor(rows, device=self.device)
        if self.crdt == "map":
            state = _rows(out.state, idx)
            return [m.canonical() for m in ref_scalar.maps(_numpy(state))]
        return _rows((out.clock, out.ids, out.dots, out.d_ids, out.d_clocks), idx)

    def reference(self, rows: np.ndarray, narrow_bits: int | None = None):
        """The reference join of the last round's inputs at ``rows``:
        ``(answers, overflow rows)``; with ``narrow_bits`` the control, its
        counters cut to that width."""
        idx = torch.as_tensor(rows + self.last_unit * self.span, device=self.device)
        if self.crdt == "map":
            reps = [ref_scalar.maps(_numpy(_rows(rep, idx)), bits=narrow_bits)
                    for rep in self.reps]
            joined = [ref_scalar.join(list(objs), self.caps) for objs in zip(*reps)]
            return [m.canonical() for m, _ in joined], sum(o for _, o in joined)
        outs, over = [], 0
        for lo in range(0, idx.shape[0], REF_ROWS):
            part = [_rows(rep, idx[lo:lo + REF_ROWS]) for rep in self.reps]
            if narrow_bits:
                part = [ref_orswot.narrowed(p, narrow_bits) for p in part]
            state, o = ref_orswot.join(part, *self.caps)
            over += int(o.any(dim=-1).sum())
            outs.append(state)
        return tuple(torch.cat(x) for x in zip(*outs)), over


def _numpy(state):
    return tuple(_numpy(x) if isinstance(x, tuple) else x.cpu().numpy() for x in state)


def rows_differing(got, want) -> int:
    """Rows where ``got`` differs from ``want``: canonical objects, or
    planes compared row by row."""
    if isinstance(want, list):
        return sum(g != w for g, w in zip(got, want))
    bad = None
    for g, w in zip(_leaves(got), _leaves(want)):
        d = (g != w.to(g.device)).reshape(g.shape[0], -1).any(dim=1)
        bad = d if bad is None else bad | d
    return int(bad.sum())
