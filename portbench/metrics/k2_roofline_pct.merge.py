"""The merge kernel K2 (``csrc/orswot_merge.cu``) as a share of the HBM
bytes bound: the bytes its set merges need in the traced rounds (each
input read once, each output written once) at 3.35 TB/s, over the
device time of its launches."""


def read(ctx):
    k2_s = sum(d for name, _, d in ctx["trace"].device_events if "orswot_merge" in name)
    rounds = ctx["traced"].get("rounds")
    if not rounds or not k2_s:
        return None
    y = ctx["yardstick"]
    return y.roofline_pct(y.round_bytes(ctx["cfg"], ctx["span"])["k2"] * rounds, k2_s)
