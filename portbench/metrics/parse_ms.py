"""Frame decode per op frame (``oplog/wire`` on the loop's decode
thread): the loop's own ``stage_s["parse"]`` over the untraced window."""


def read(ctx):
    w = ctx["window"]
    if not w.get("frames"):
        return None
    return w["parse_s"] / w["frames"] * 1e3
