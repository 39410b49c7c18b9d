"""The whole Map join (``ops/map_ops`` and ``batch/map_batch`` with the
nested set merges) as a share of the HBM bytes bound: the bytes the
traced rounds' map merges need at 3.35 TB/s, over the device's busy
time in those rounds."""


def read(ctx):
    rounds = ctx["traced"].get("rounds")
    busy = ctx["trace"].busy_s
    if ctx["cfg"]["crdt"] != "map" or not rounds or not busy:
        return None
    y = ctx["yardstick"]
    return y.roofline_pct(y.round_bytes(ctx["cfg"], ctx["span"])["merge"] * rounds, busy)
