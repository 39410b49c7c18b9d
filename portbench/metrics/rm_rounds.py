"""Remove rounds per op frame in the traced frames: the ``oplog/remove_round``
spans of ``OpApplier._fold_removes``, one whole-fleet ``apply_remove``
each."""

from portbench import spans


def read(ctx):
    frames = ctx["traced"].get("frames")
    found = spans.of(ctx)
    if not frames or found is None or not found.count("oplog/apply"):
        return None
    return found.count("oplog/remove_round") / frames
