"""Run one cell of the port's benchmark once.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``); the mix's ``kind`` picks the module in
``portbench/kinds/`` that runs the window, and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  Set-up makes the inputs on the card
from the seed and warms up every shape; the window then runs for
``--seconds``; with ``--trace 1`` a short profiled sub-window follows.
Once the window has closed and the peak memory is read, the program's
output is compared with the plain reference under
``portbench/reference/``.  The last line of standard output is the result
as one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: top-level modules that must not be loaded when the result is printed:
#: the JAX package is the port's reference, never part of the run
FORBIDDEN = ("jax", "jaxlib", "flax", "crdt_tpu")


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout.  The program builds
    its CUDA libraries into ``build/crdt_tpu_torch/`` itself; these two
    hold whatever Triton or a ``torch.utils.cpp_extension`` build would
    cache, since a later change to the program may not edit this file."""
    build = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def load_spec(workload: str) -> dict:
    """The cell's entry, its configuration, its mix and its metrics, by
    name from ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {"cell": cell, "cfg": cfg, "mix": mix, "chips": cell["chips"],
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(name: str):
    """The ``read(ctx)`` of per-layer metric ``name``."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_cell(spec: dict, seed: int, device):
    kind = importlib.import_module(f"portbench.kinds.{spec['mix']['kind']}")
    return kind.Cell(spec["cfg"], spec["mix"], seed, device)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unread ({e.__class__.__name__})"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             fault=None) -> dict:
    """Set-up, window, optional traced sub-window, then the checks.
    ``fault(cell)`` may return a replacement for the window's step (the
    fault tests).  Returns the result object without printing it."""
    import torch

    from portbench import trace as trace_mod
    from portbench import yardstick

    cuda = device.type == "cuda"
    cell = make_cell(spec, seed, device)
    cell.warm()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    res = cell.window(seconds, fault(cell)) if fault else cell.window(seconds)
    e2e = cell.end_to_end(res)
    e2e["setup_s"] = setup_s
    out = {"correct": False, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": {}, "device": {}}
    tracer = None
    if trace:
        tracer = trace_mod.Tracer(device)
        traced = cell.traced(tracer)
        ctx = {"cfg": spec["cfg"], "mix": spec["mix"], "window": res, "traced": traced,
               "trace": tracer, "yardstick": yardstick, "span": getattr(cell, "span", None)}
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            out["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark runs the port alone")
    out["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": spec["chips"],
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    if tracer is not None:
        out["device"].update(busy_s=tracer.busy_s, window_s=tracer.window_s)
        out["breakdown"] = {
            "device_ops": trace_mod.device_ops(tracer.device_events),
            "idle_gaps": trace_mod.idle_gaps(tracer.device_events, tracer.host_events)}
    checks = cell.checks(seed, res)
    out["correct"] = all(v <= limit for _, v, limit in checks)
    out["window"] = {k: v for k, v in res.items() if isinstance(v, (int, float))}
    out["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    spec = load_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: the cell needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    card = card_line()
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), device, T_START)
    out["card"] = card
    checks = out.pop("checks")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
