"""Device time per op frame launched under ``oplog/removes``: the remove
rounds of ``OpApplier._fold_removes``, in the traced frames."""

from portbench import spans


def read(ctx):
    frames = ctx["traced"].get("frames")
    found = spans.of(ctx)
    if not frames or found is None or not found.device or not found.count("oplog/apply"):
        return None
    return found.device_s("oplog/removes") / frames * 1e3
