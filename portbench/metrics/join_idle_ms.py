"""Device idle time per round inside ``executor/join_all``
(``JoinExecutor.join_all``): the executor's host work and its overflow
check's sync, apart from the harness between rounds."""

from portbench import spans


def read(ctx):
    rounds = ctx["traced"].get("rounds")
    found = spans.of(ctx)
    if not rounds or found is None or not found.device or not found.count("executor/join_all"):
        return None
    return found.idle_s("executor/join_all") / rounds * 1e3
