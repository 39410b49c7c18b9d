"""Device time per op frame in the traced frames (``oplog/apply``'s
folds: the add scatters, the deferred replay, the remove rounds, and the
copies of the op columns)."""


def read(ctx):
    frames = ctx["traced"].get("frames")
    if not frames or not ctx["trace"].busy_s:
        return None
    return ctx["trace"].busy_s / frames * 1e3
