"""The port's ``replicate_tcp`` tool (``crdt_tpu_torch.tools.replicate_tcp``)
against the JAX package, on the CPU:

* the fleet generator (straight into planes) against the JAX example's
  ``_build_fleet``, blob for blob against ``to_binary`` and slot for slot
  against the JAX scalars packed by the port's ``from_scalar``;
* two peers in process over loopback TCP in every session mode, their
  converged blobs against ``to_binary`` of the JAX scalar merge;
* the tool as users run it, in subprocesses (two at a time): the
  two-process demo, the live exporter, gossip (its fleet fingerprint
  against the JAX digest of the scalar three-way join, the same under a
  window of 16 and stop-and-wait), the durable kill -9 drill, reads, GC,
  the digest tree and heat together, and the mesh (its predicted loads
  against the JAX planner's);
* the default device without a card.

The JAX oracle is ``crdt_tpu.scalar``, ``crdt_tpu.utils.serde`` and the
JAX digest (never ``crdt_tpu.native``); the JAX example is imported, not
run."""

import importlib.util
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from crdt_tpu.batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.sync.digest import digest_of as jax_digest_of
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import to_binary
from crdt_tpu_torch import DeviceUnavailableError
from crdt_tpu_torch.tools import replicate_tcp as rt
from crdt_tpu_torch.tools import run_all

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOL = [sys.executable, "-m", "crdt_tpu_torch.tools.replicate_tcp", "--device", "cpu"]
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
RUN_TIMEOUT_S = 240
PARALLEL = 2


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_replicate_tcp",
                                                  REPO / "examples" / "replicate_tcp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JRT = _jax_example()
#: the tools' universe in the JAX package
JAX_UNI = JaxUniverse.identity(JaxConfig(num_actors=8, member_capacity=32, deferred_capacity=8,
                                         counter_bits=32))


def _jax_join(n, actors, seed=42):
    """The JAX scalar merge of the actors' fleets, object by object."""
    fleets = [JRT._build_fleet(n, a, 0.05, seed) for a in actors]
    for objs in zip(*fleets):
        for other in objs[1:]:
            objs[0].merge(other)
    return fleets[0]


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


# -- the fleets --------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("actor", [1, 2])
def test_fleets_equal_the_jax_example_blob_for_blob(n, actor):
    uni = rt.identity_universe()
    fleet = JRT._build_fleet(n, actor, 0.05, 42)
    planes = rt.build_batch(n, actor, 0.05, 42, uni, "cpu")
    assert planes.to_wire(uni) == [to_binary(o) for o in fleet]
    scalar = JaxOrswotBatch.from_scalar(fleet, JAX_UNI)
    for name, got in zip(("clock", "ids", "dots", "d_ids", "d_clocks"), planes.to_numpy()):
        assert np.array_equal(np.asarray(getattr(scalar, name)), got), name  # the same slots


# -- two peers in process ------------------------------------------------------------


@pytest.mark.parametrize("mode", [{}, {"full_state": True}, {"window": 16}, {"window": 0}],
                         ids=["delta", "full-state", "window16", "window0"])
def test_peers_in_process_converge_on_the_jax_scalar_merge(mode):
    n, port, out = 200, _free_port(), {}

    def run(role):
        out[role] = rt.peer(role, port, n, "cpu", **mode)

    legs = [threading.Thread(target=run, args=(role,), daemon=True)
            for role in ("server", "client")]
    for t in legs:
        t.start()
    for t in legs:
        t.join(timeout=120)
    want = [to_binary(o) for o in _jax_join(n, (1, 2))]
    uni = rt.identity_universe()
    assert set(out) == {"server", "client"}
    for role, (report, batch) in out.items():
        assert report.converged, role
        if mode.get("full_state"):
            assert report.full_state_fallback and report.full_bytes_sent > 0
        else:  # 5% of 200 rows, shipped as deltas
            assert (report.diverged, report.delta_objects_sent, report.full_bytes_sent) \
                == (10, 10, 0)
        assert batch.to_wire(uni) == want, role


# -- the tool as users run it --------------------------------------------------------


RUNS = {
    "demo64": ["--objects", "64"],
    "demo256": ["--objects", "256"],
    "gossip_w16": ["--gossip", "3", "--objects", "24", "--window", "16"],
    "gossip_w0": ["--gossip", "3", "--objects", "24", "--window", "0"],
    "durable": ["--gossip", "3", "--objects", "48", "--ops", "10", "--durable", "{tmp}"],
    "modes": ["--gossip", "3", "--objects", "64", "--ops", "60", "--reads", "30", "--gc",
              "--digest-tree", "--heat", "--zipf", "1.2", "--fleet-port", "0"],
    "mesh": ["--mesh", "4", "--objects", "96"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of :data:`RUNS`, :data:`PARALLEL` at a time (the suite's
    other workers share the cores): name -> (rc, stdout, stderr)."""
    tmp = tmp_path_factory.mktemp("runs")
    names, done = list(RUNS), {}
    for i in range(0, len(names), PARALLEL):
        batch = names[i:i + PARALLEL]
        results, _ = run_all([TOOL + [a.format(tmp=tmp / "durable") for a in RUNS[name]]
                              for name in batch], RUN_TIMEOUT_S, capture=True, env=ENV)
        done.update((name, res[:3]) for name, res in zip(batch, results))
    return done


def _ok(runs, name) -> str:
    rc, out, err = runs[name]
    assert rc == 0, (name, out[-1500:], err[-1500:])
    return out


def _evidence(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"role"')]


@pytest.mark.parametrize("name", ["demo64", "demo256"])
def test_demo_converges_in_two_processes(runs, name):
    out = _ok(runs, name)
    assert "demo: CONVERGED" in out and "DIVERGED" not in out
    lines = [ln for ln in out.splitlines() if "mode=delta" in ln]
    assert len(lines) == 2 and all("full=0B" in ln for ln in lines), lines
    ev = _evidence(out)
    assert sorted(e["role"] for e in ev) == ["client", "server"]
    n = int(RUNS[name][1])
    joined = JaxOrswotBatch.from_scalar(_jax_join(n, (1, 2)), JAX_UNI)
    want = rt.digest_sha(jax_digest_of(joined, JAX_UNI))
    assert {e["digest_sha256"] for e in ev} == {want}


@pytest.mark.parametrize("name", ["gossip_w16", "gossip_w0"])
def test_gossip_fingerprint_is_the_jax_three_way_join(runs, name):
    out = _ok(runs, name)
    assert "gossip: 3 peers x 24 objects" in out and "CONVERGED" in out
    window = RUNS[name][-1]
    assert f"transport: window={window if window != '0' else 1}" in out
    sha = re.search(r"fleet digest sha256=([0-9a-f]+)", out).group(1)
    joined = JaxOrswotBatch.from_scalar(_jax_join(24, (1, 2, 3)), JAX_UNI)
    assert sha == rt.digest_sha(jax_digest_of(joined, JAX_UNI))
    assert _evidence(out) == [{"role": "gossip", "k2_launches": 0, "wide_merges": 0,
                               "digest_sha256": sha}]


def test_gossip_durable_kill9_recovers_and_rejoins_by_delta(runs):
    out = _ok(runs, "durable")
    for line in ("kill: n1 killed -9 at sweep 2", "recovery: n1 restored generation",
                 "full-state fallbacks=0", "gossip: 3 peers x 48 objects"):
        assert line in out, line
    assert out.rstrip().splitlines()[-2].endswith("CONVERGED")


def test_gossip_reads_gc_tree_and_heat_converge(runs):
    out = _ok(runs, "modes")
    for pattern in (r"fleet: merged observatory on http://127\.0\.0\.1:\d+/fleet",
                    r"ops: \d+ live writes ingested .* fleet CONVERGED",
                    r"reads: \d+ live reads served .* ryw probes [1-9]\d* \(0 violations",
                    r"reads: quiescent frontier-mode sweep all-rows-stable on every node",
                    r"stability: frontier == fleet VV min .* violations=0",
                    r"heat: \d+ attributed rows across \d+ subtree\(s\)",
                    r"heat: plan mesh:3: imbalance=", r"heat: plan ring:3,k=2: skew=",
                    r"heat: zipf s_hat=",
                    r"tree: descents=[1-9]\d* cutover=\d+ fallbacks=0",
                    r"gossip: 3 peers x 64 objects  sweeps=\d+  CONVERGED"):
        assert re.search(pattern, out), pattern
    gc = re.findall(r"gc: n\d reclaimed=(\d+)B over (\d+) pass\(es\)  member_capacity=(\d+)",
                    out)
    assert len(gc) == 3 and all(int(b) > 0 and int(m) == 32 for b, _, m in gc), gc
    (ev,) = _evidence(out)
    # the planes start over-provisioned at M=128: merges take the wide path until GC shrinks
    assert ev["wide_merges"] > 0 and ev["digest_sha256"]


def test_mesh_is_byte_identical_and_prices_as_the_jax_planner(runs):
    from crdt_tpu.mesh import choose_layout
    from crdt_tpu.obs.heat import score_plan
    from crdt_tpu.obs.stability import subtree_layout

    out = _ok(runs, "mesh")
    assert "digest parity vs unsharded control: BYTE-IDENTICAL (96 lanes" in out
    n, shards = 96, 4
    rng = np.random.RandomState(7)
    probs = np.arange(1, n + 1, dtype=np.float64) ** -1.1
    writes = rng.choice(n, size=4096, p=probs / probs.sum())
    _, span = subtree_layout(n)
    heat = np.bincount(writes // span, minlength=-(-n // span)).astype(np.float64)
    granule = choose_layout(n, shards, heat=heat, span=span).granule
    want = score_plan(f"mesh:{shards}", heat, n=n, span=span, granule=granule)
    assert f"planner granule {granule} (predicted imbalance {want['imbalance']})" in out
    rows = [ln.split() for ln in out.splitlines() if re.match(r"\s+\d+\s+\d+\s+[\d.]+\s", ln)]
    assert [r[2] for r in rows] == [f"{x:.1f}" for x in want["loads"]]
    (ev,) = _evidence(out)
    assert ev["role"] == "mesh" and ev["digest_sha256"]


def test_metrics_exporter_serves_the_live_session():
    """A server peer with ``--metrics-port --linger``: ``/metrics`` carries
    the session counts and the per-peer convergence gauges, and
    ``/events`` the session's phases under its printed id."""
    port, mport = _free_port(), _free_port()
    common = ["--port", str(port), "--objects", "64"]
    srv = subprocess.Popen(TOOL + ["server"] + common + ["--metrics-port", str(mport),
                                                         "--linger", "60"],
                           cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    cli = subprocess.Popen(TOOL + ["client"] + common, cwd=REPO, env=ENV,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base, text, events = f"http://127.0.0.1:{mport}", "", None
    try:
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline and srv.poll() is None:
            try:
                with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
                    text = r.read().decode()
                with urllib.request.urlopen(f"{base}/events?kind=sync.phase", timeout=5) as r:
                    events = json.loads(r.read().decode())
                if "crdt_tpu_sync_peer_client_delta_ratio" in text and any(
                        e["fields"]["phase"] == "converged" for e in events["events"]):
                    break
            except OSError:
                pass
            time.sleep(0.2)
    finally:
        out_s, err_s = srv.communicate(timeout=120)
        out_c, err_c = cli.communicate(timeout=120)
    assert srv.returncode == 0 and cli.returncode == 0, (err_s[-800:], err_c[-800:])
    assert "crdt_tpu_sync_sessions_total 1" in text
    assert "crdt_tpu_sync_peer_client_delta_ratio" in text
    assert re.search(r"server: metrics exporter on http://127\.0\.0\.1:\d+/metrics", out_s)
    sid = re.search(r"session=(\S+)", out_s).group(1)
    phases = [e["fields"]["phase"] for e in events["events"] if e.get("session") == sid]
    assert "digest_exchange" in phases and "converged" in phases, phases


# -- no card -------------------------------------------------------------------------


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--gossip", "3"], ["--mesh", "4"], ["server", "--port", "1"]):
        with pytest.raises(DeviceUnavailableError):
            rt.main(argv)


def test_default_device_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    proc = subprocess.run([sys.executable, "-m", "crdt_tpu_torch.tools.replicate_tcp"],
                          cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "DeviceUnavailableError" in proc.stderr
    assert "demo:" not in proc.stdout  # nothing was spawned
