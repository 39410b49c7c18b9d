"""Device time per round of the Map merge's torch passes: launched under
``map/merge`` (``map_ops.merge``, the nested value kernel's truncates
included), less the merge kernel K2's own records (``orswot_merge``), in
the traced rounds."""

from portbench import spans


def read(ctx):
    rounds = ctx["traced"].get("rounds")
    found = spans.of(ctx)
    if not rounds or found is None or not found.device or not found.count("map/merge"):
        return None
    passes = sum(d for name, _, d, _ in found.under("map/merge") if "orswot_merge" not in name)
    return passes / rounds * 1e3
