"""Tests of the port's benchmark: ``python -m pytest portbench/tests``.
They run on the CPU at tiny sizes; those marked ``cuda`` need a card and
skip without one."""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: tests that need an NVIDIA card; they skip without one")


def tiny_spec(workload: str) -> dict:
    """The cell's spec at a size the CPU holds in a second: fewer objects
    and shorter frames, every width and share as in the cell."""
    from portbench import run

    spec = copy.deepcopy(run.load_spec(workload))
    sizes, mix = spec["cfg"]["sizes"], spec["mix"]
    sizes["objects"] = 512 if spec["cfg"]["crdt"] == "orswot" else 64
    if mix["kind"] == "writes":
        mix.update(ops_per_frame=256, pool_frames=8, chunk_frames=1, swap_period=4,
                   swap_offset=1, sample=10**6, hot_sample=2, warm_ops=64)
    else:
        mix.update(sample=10**6, traced_units=1)
    return spec


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
