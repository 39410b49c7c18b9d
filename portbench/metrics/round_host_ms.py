"""Host time per round that no device work covers: the traced window
less the device's busy time, per round."""


def read(ctx):
    rounds = ctx["traced"].get("rounds")
    t = ctx["trace"]
    if not rounds or not t.busy_s:
        return None
    return (t.window_s - t.busy_s) / rounds * 1e3
