"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program either: compared by whole
top-level module names, since the port's name begins with the JAX
package's."""

import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "crdt_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_the_benchmark(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_is_independent_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"crdt_tpu_torch"})


def test_run_time_check_compares_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "crdt_tpu_torch_like", sys)
    assert "crdt_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "crdt_tpu.fake", sys)
    assert run.forbidden_modules() == ["crdt_tpu"]
