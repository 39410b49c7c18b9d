"""The lint budget: the AST nodes in crdtlint's reach and the lint's time,
for two trees of this repository in turns.

    python tests/lint_budget.py PARENT CHANGE [--order PCCPPCCP]

``PARENT`` and ``CHANGE`` are unpacked trees (``git archive <tree> | tar
-x -C DIR``).  For each letter of ``--order`` (``P`` the parent, ``C``
the change) it runs ``python -m crdt_tpu.analysis --json`` in that tree
(the lint of ``tests/test_analysis.py::test_repo_lint_clean_fast_and_jax_free``)
and prints the tree, its AST nodes (every ``.py`` the lint walks, as
``crdt_tpu.analysis.core.default_targets`` lists them, each counted by
``ast.walk``), the lint's ``ok`` and its ``elapsed_s``; one JSON line
with every run last.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys


def nodes(root: str) -> int:
    """The AST nodes of every ``.py`` the lint walks under ``root``."""
    code = ("import ast, json, sys\n"
            "from crdt_tpu.analysis.core import default_targets\n"
            "print(json.dumps(default_targets(sys.argv[1])))\n")
    paths = json.loads(subprocess.run([sys.executable, "-c", code, root], cwd=root, check=True,
                                      capture_output=True, text=True).stdout)
    return sum(sum(1 for _ in ast.walk(ast.parse(open(p, encoding="utf-8").read())))
               for p in paths)


def lint(root: str) -> dict:
    """The lint's JSON report, run in ``root``."""
    proc = subprocess.run([sys.executable, "-m", "crdt_tpu.analysis", "--json"], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return json.loads(proc.stdout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="PCCPPCCP")
    args = ap.parse_args(argv)
    trees = {"P": os.path.abspath(args.parent), "C": os.path.abspath(args.change)}
    counts = {k: nodes(v) for k, v in trees.items()}
    runs = []
    for k in args.order:
        out = lint(trees[k])
        runs.append({"tree": k, "nodes": counts[k], "ok": out["ok"], "files": out["files"],
                     "elapsed_s": out["elapsed_s"]})
        print(f"{k} nodes {counts[k]} ok {out['ok']} files {out['files']} "
              f"elapsed_s {out['elapsed_s']}", flush=True)
    print(json.dumps({"nodes": counts, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
