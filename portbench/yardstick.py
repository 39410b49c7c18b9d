"""The yardstick: the card's peak, the bytes each cell's work needs, and
the statistics of a window.  Later changes to the program cannot move
these.

Bytes count each input plane read once and each output plane written
once, from the cell's shapes (int32 planes, 4 bytes a lane), whatever a
kernel reads again.
"""

from __future__ import annotations

import statistics

#: NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s.  Every kernel of these
#: cells moves far more bytes than it computes, so the bytes bound binds.
HBM_BYTES_PER_S = 3.35e12


def orswot_bytes(rows: int, a: int, m: int, d: int) -> int:
    """One ORSWOT state: clock, ids, dots, deferred ids and clocks."""
    return 4 * rows * (a + m + m * a + d + d * a)


def set_merge_bytes(rows: int, a: int, m: int, d: int, inputs: int = 2) -> int:
    """A set merge: ``inputs`` states in (one for a state merged with
    itself), one state and the overflow pair (int32) out."""
    return (inputs + 1) * orswot_bytes(rows, a, m, d) + 8 * rows


def map_bytes(rows: int, a: int, k: int, d: int, m: int, dv: int) -> int:
    """One Map-of-sets state: clock, keys, entry clocks, a set per key
    slot, deferred keys and clocks."""
    return 4 * rows * (a + k + k * a + d + d * a) + k * orswot_bytes(rows, a, m, dv)


def map_merge_bytes(rows: int, a: int, k: int, d: int, m: int, dv: int,
                    inputs: int = 2) -> int:
    return (inputs + 1) * map_bytes(rows, a, k, d, m, dv)


#: causal truncates of the nested sets in one Map merge, each over the 2K
#: aligned key slots: by the deleters, and by the replayed deferred
#: removes (besides the merge of the aligned values)
TRUNCATES_PER_MAP_MERGE = 2


def round_bytes(cfg: dict, rows: int) -> dict:
    """Bytes one rejoin round of ``rows`` objects needs: ``k2`` (the set
    merges) and ``merge`` (the whole joins).  ``R`` replicas join in
    ``R - 1`` pairwise merges and the plunger self-merge, whose input is
    read once."""
    s = cfg["sizes"]
    pairwise = s["replicas"] - 1
    if cfg["crdt"] == "orswot":
        def one(inputs):
            return set_merge_bytes(rows, s["num_actors"], s["member_capacity"],
                                   s["deferred_capacity"], inputs)
        k2 = pairwise * one(2) + one(1)
        return {"k2": k2, "merge": k2}
    k = s["key_capacity"]

    def sets(inputs):
        """The aligned values' merge, and the truncates, each of which
        reads one set and a clock a slot."""
        slots = rows * 2 * k
        size = (slots, s["num_actors"], s["member_capacity"], s["set_deferred_capacity"])
        truncate = set_merge_bytes(*size, 1) + 4 * slots * s["num_actors"]
        return set_merge_bytes(*size, inputs) + TRUNCATES_PER_MAP_MERGE * truncate

    def whole(inputs):
        return map_merge_bytes(rows, s["num_actors"], k, s["deferred_capacity"],
                               s["member_capacity"], s["set_deferred_capacity"], inputs)
    return {"k2": pairwise * sets(2) + sets(1), "merge": pairwise * whole(2) + whole(1)}


def roofline_pct(nbytes: float, device_s: float):
    """Share of the bytes bound: the least time, ``nbytes`` at the peak,
    over the device time; None where no device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]

