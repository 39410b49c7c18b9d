"""The device's idle share of the traced rejoin rounds."""


def read(ctx):
    t = ctx["trace"]
    if not ctx["traced"].get("rounds") or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
