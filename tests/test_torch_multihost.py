"""The port's multi-process backend (``crdt_tpu_torch.parallel.multihost``)
against the JAX package's single-process contracts, and its CLI at two
gloo ranks.

``initialize`` is a no-op with one process and no configuration, safe
to call twice alike and raises when called again with another world; ``make_multihost_mesh`` leads with its DCN dims;
``local_shard`` tiles the objects exactly, as JAX's does;
``python -m crdt_tpu_torch.tools.multihost --device cpu`` joins fleets
across two processes in both topologies, and its default device (one
NCCL rank per card) refuses a missing card and more ranks than cards.  The gloo joins at 1-8 ranks are
``test_torch_collective.py``'s.
"""

import pathlib
import subprocess
import sys
import weakref

import pytest
import torch
import torch.distributed as dist

from crdt_tpu.parallel import local_shard as j_local_shard
from crdt_tpu_torch import DeviceUnavailableError
from crdt_tpu_torch.parallel import (
    global_batch_from_local, initialize, local_shard, make_mesh, make_multihost_mesh, topology,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def world_of_one():
    """A world of one over an in-memory store, torn down after the test."""
    assert not dist.is_initialized()
    store = dist.HashStore()
    initialize(num_processes=1, process_id=0, store=store)
    try:
        yield store
    finally:
        dist.destroy_process_group()


def test_initialize_single_process_noop():
    assert not dist.is_initialized()
    topo = initialize()  # nothing configured: no process group
    assert topo == topology() == {"processes": 1, "process_id": 0, "devices": 1,
                                  "local_devices": 1}
    assert not dist.is_initialized()
    assert initialize() == topo


def test_initialize_twice_keeps_the_group(world_of_one):
    group = dist.group.WORLD
    assert initialize(num_processes=1, process_id=0, store=world_of_one) == topology()
    assert initialize() == initialize(num_processes=1) == topology()
    assert dist.group.WORLD is group
    assert "gloo" in str(dist.get_backend())
    for kw in ({"store": dist.HashStore()}, {"num_processes": 2, "process_id": 1},
               {"coordinator_address": "localhost:1"}):
        with pytest.raises(RuntimeError, match="already"):
            initialize(**kw)
    assert dist.group.WORLD is group


def test_initialize_after_a_mesh_of_one_raises():
    """``make_mesh`` with no group joins a world of one; a later
    ``initialize`` asking for two ranks must raise, not hand back that
    world, whose joins would only ever return this rank's own state."""
    assert not dist.is_initialized()
    try:
        make_mesh({"replicas": 1}, device="cpu")
        with pytest.raises(RuntimeError, match="rank 0 of a group of 1 already"):
            initialize(num_processes=2, process_id=0, store=dist.HashStore())
        assert initialize() == topology()
    finally:
        dist.destroy_process_group()


def test_a_mesh_reuses_its_groups(world_of_one):
    """A second mesh of one grid shape gets the first one's groups: no
    new communicator per call."""
    first = make_mesh({"replicas": 1}, device="cpu")
    again = make_mesh({"objects": 1}, device="cpu")
    assert again.get_group("objects") is first.get_group("replicas")
    other = make_multihost_mesh({"replicas": 1}, {"objects": 1}, device="cpu")
    assert other.get_group("objects") is not first.get_group("replicas")


def test_groups_go_with_the_destroyed_default_group():
    """Once the default group is destroyed, no group that ``initialize``
    or a mesh made outlives it: a communicator left to the interpreter's
    exit is torn down after the runtime under it."""
    assert not dist.is_initialized()
    initialize(num_processes=1, process_id=0, store=dist.HashStore())
    try:
        mesh = make_multihost_mesh({"replicas": 1}, {"objects": 1}, device="cpu")
        groups = [weakref.ref(g) for g in (dist.group.WORLD, *mesh.get_all_groups())]
        del mesh
    finally:
        dist.destroy_process_group()
    assert [g() for g in groups] == [None] * 3


def test_make_multihost_mesh_single_process_merges_axes(world_of_one):
    mesh = make_multihost_mesh({"replicas": 1, "objects": 1}, {"pods": 1}, device="cpu")
    assert mesh.mesh_dim_names == ("pods", "replicas", "objects")
    assert tuple(mesh.mesh.shape) == (1, 1, 1)
    assert make_multihost_mesh({"replicas": 1}, device="cpu").mesh_dim_names == ("replicas",)
    assert make_mesh(device="cpu").mesh_dim_names == ("objects",)
    for name in ("pods", "replicas", "objects"):
        assert str(dist.get_backend(mesh.get_group(name))) == "gloo"
    with pytest.raises(ValueError, match="need 4 ranks, have 1"):
        make_multihost_mesh({"replicas": 2}, {"objects": 2}, device="cpu")


def test_global_batch_from_local_spans_the_whole_axis(world_of_one):
    mesh = make_mesh({"objects": 1}, device="cpu")
    planes = (torch.arange(12).reshape(6, 2), torch.zeros(6, 3, dtype=torch.int32))
    part = global_batch_from_local(mesh, planes)
    assert (part.axis, part.span, part.size) == ("objects", slice(0, 6), 6)
    assert all(torch.equal(a, b) for a, b in zip(part.value, planes))


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        make_mesh({"replicas": 1})
    assert not dist.is_initialized()


@pytest.mark.parametrize("n,k", [(10, 3), (8, 8), (7, 2), (5, 6), (64, 4), (1, 1)])
def test_local_shard_tiles_exactly_as_jax(n, k):
    covered = []
    for i in range(k):
        s = local_shard(n, k, i)
        assert s == j_local_shard(n, k, i)
        covered.extend(range(n)[s])
    assert covered == list(range(n))
    sizes = [len(range(n)[local_shard(n, k, i)]) for i in range(k)]
    assert max(sizes) - min(sizes) <= 1


def test_multihost_tool_both_topologies_at_two_ranks():
    """Both topologies run at once, each two gloo ranks of its own."""
    runs = {topology: subprocess.Popen(
        [sys.executable, "-m", "crdt_tpu_torch.tools.multihost", "--device", "cpu", "--ranks",
         "2", "--topology", topology], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for topology in ("replicas", "hybrid")}
    for topology, proc in runs.items():
        try:
            out = proc.communicate(timeout=180)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, out
        for rank in range(2):
            assert (f"rank {rank}: topology={topology} objects=8 processes=2 "
                    "MULTIHOST OK") in out, out
        assert "launcher: MULTIHOST OK" in out


def test_multihost_tool_default_device_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    proc = subprocess.run([sys.executable, "-m", "crdt_tpu_torch.tools.multihost"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "DeviceUnavailableError" in proc.stderr
    assert "launcher:" not in proc.stdout  # nothing was spawned


def test_multihost_tool_refuses_more_ranks_than_cards(monkeypatch, capsys):
    from crdt_tpu_torch.tools import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost, "spawn_ranks", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(SystemExit) as e:
        multihost.main(["--ranks", "2"])
    assert e.value.code == 2
    assert "--ranks 2 needs 2 cards, 1 visible" in capsys.readouterr().err


def test_multihost_tool_defaults_to_one_rank_per_card(monkeypatch, capsys):
    from crdt_tpu_torch.tools import multihost

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost, "spawn_ranks", lambda module, ranks, args: calls.append(
        (module, ranks, args)) or 0)
    assert multihost.main([]) == 0
    assert calls == [("crdt_tpu_torch.tools.multihost", 1, [
        "--device", "cuda", "--ranks", "1", "--topology", "replicas", "--objects", "8"])]
    assert "launcher: MULTIHOST OK" in capsys.readouterr().out
