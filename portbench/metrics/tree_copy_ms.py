"""Device time per round of the copies around the join tree (the stack of
the replicas, the strided halves made contiguous, the odd replica's
carry): kernels and device-to-device copies whose name says copy."""


def read(ctx):
    rounds = ctx["traced"].get("rounds")
    if not rounds or not ctx["trace"].device_events:
        return None
    copy_s = sum(d for name, _, d in ctx["trace"].device_events
                 if "copy" in name.lower() or "dtod" in name.lower())
    return copy_s / rounds * 1e3
