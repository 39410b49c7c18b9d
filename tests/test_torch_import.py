"""Import hygiene of the PyTorch port: ``crdt_tpu_torch`` and
``chip_smoke.py`` stand alone (no JAX, nothing of ``crdt_tpu``), and the
entry points default to the card and raise without one."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "crdt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_leaves_jax_package_out():
    code = (
        "import sys\n"
        "import crdt_tpu_torch\n"
        "import crdt_tpu_torch.ops.orswot_fold_aligned, crdt_tpu_torch.utils.testdata\n"
        "bad = sorted(m for m in sys.modules if m == 'crdt_tpu' or m.startswith('crdt_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_jax_package(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "crdt_tpu"), f"{path.name} imports {name}"


def test_scan_covers_every_module():
    names = {p.name for p in PORT_FILES}
    assert {"orswot_ops.py", "orswot_tile.py", "orswot_fold_aligned.py", "executor.py",
            "orswot_batch.py", "_build.py", "chip_smoke.py", "map_ops.py", "map_batch.py",
            "val_kernels.py", "digest.py", "tree.py", "delta.py", "occupancy.py", "policy.py",
            "watermark.py", "compact.py", "repack.py", "query.py", "consistency.py",
            "stability.py", "heat.py", "kernels.py", "capacity.py", "workload.py",
            "session.py", "events.py", "latency.py", "transport.py", "faults.py",
            "membership.py", "gossip.py", "checkpoint.py", "wal.py", "snapshot.py",
            "recover.py", "manager.py"} <= names


@pytest.mark.parametrize("entry", ["resolve_device", "from_numpy", "zeros", "build_fleet_planes",
                                   "map_zeros", "map_from_scalar", "build_tree",
                                   "heat_tracker", "device_memory", "recover"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(entry, monkeypatch):
    from crdt_tpu_torch import (
        CapacityTracker, CrdtConfig, DeviceUnavailableError, HeatTracker, MapBatch, MVRegKernel,
        OrswotBatch, Universe,
    )
    from crdt_tpu_torch.device import resolve_device
    from crdt_tpu_torch.durable import recover
    from crdt_tpu_torch.sync import build_tree
    from crdt_tpu_torch.utils.testdata import build_fleet_planes, fleet_columns

    # the suite runs on card-less machines; pin that state so the test
    # means the same thing everywhere
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    uni = Universe(CrdtConfig(num_actors=4, member_capacity=2, deferred_capacity=1))
    calls = {
        "resolve_device": lambda: resolve_device(),
        "from_numpy": lambda: OrswotBatch.from_numpy(
            np.zeros((1, 4), np.uint32), np.full((1, 2), -1, np.int32),
            np.zeros((1, 2, 4), np.uint32), np.full((1, 1), -1, np.int32),
            np.zeros((1, 1, 4), np.uint32)),
        "zeros": lambda: OrswotBatch.zeros(3, uni),
        "build_fleet_planes": lambda: build_fleet_planes(
            fleet_columns(np.random.RandomState(0), 4, 4, 4, 1, 2, base=1, novel=1),
            a=4, m_cap=4, d=1, base=1, novel=1),
        "map_zeros": lambda: MapBatch.zeros(3, uni, MVRegKernel.from_config(uni.config)),
        "map_from_scalar": lambda: MapBatch.from_scalar([], uni,
                                                        MVRegKernel.from_config(uni.config)),
        "build_tree": lambda: build_tree(np.arange(4, dtype=np.uint64)),
        "heat_tracker": lambda: HeatTracker(),
        "device_memory": lambda: CapacityTracker().sample_device_memory(),
        "recover": lambda: recover(REPO / "no-such-durable-dir"),
    }
    with pytest.raises(DeviceUnavailableError, match="cuda"):
        calls[entry]()


def test_cpu_is_explicit_and_works():
    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe

    uni = Universe(CrdtConfig(num_actors=4, member_capacity=2, deferred_capacity=1))
    batch = OrswotBatch.zeros(3, uni, device="cpu")
    assert batch.device.type == "cpu"
    assert batch.member_count().tolist() == [0, 0, 0]
