"""Device idle time per op frame inside ``oplog/apply`` (``OpApplier.apply_ops``):
the time the applier's host work and syncs held the card, in the traced
frames."""

from portbench import spans


def read(ctx):
    frames = ctx["traced"].get("frames")
    found = spans.of(ctx)
    if not frames or found is None or not found.device or not found.count("oplog/apply"):
        return None
    return found.idle_s("oplog/apply") / frames * 1e3
