"""Command-line tools of the port, each run as ``python -m
crdt_tpu_torch.tools.<name>`` with ``--device`` (default ``cuda``):
``replicate_tcp`` (two-process sync, the gossip fleet, the mesh),
``wire_zoo``, ``pprint``, ``anti_entropy`` and ``multihost``.  A tool
that merges ends with :func:`evidence`'s JSON line."""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def say(*parts) -> None:
    """``print`` for processes that share a stdout (a demo's children, a
    launcher's ranks): the line and its newline go out in one write, so
    two processes' lines never run together."""
    sys.stdout.write(" ".join(map(str, parts)) + "\n")
    sys.stdout.flush()


def digest_sha(digests) -> str:
    """A fleet's fingerprint: the first 16 hex digits of the sha256 of its
    ``uint64`` digest vector's bytes."""
    return hashlib.sha256(np.asarray(digests, dtype=np.uint64).tobytes()).hexdigest()[:16]


def evidence(role: str, digests=None) -> None:
    """Print the process's JSON evidence line: its role, the merge kernel's
    launches, the merges that took the wide path (member tables above 64
    slots, which no kernel serves) and the converged digest fingerprint
    (null where there is none)."""
    from .. import _build

    counts = _build.launch_counts()
    say(json.dumps({"role": role, "k2_launches": counts["orswot_merge"],
                    "wide_merges": counts[_build.WIDE_MERGES],
                    "digest_sha256": None if digests is None else digest_sha(digests)}))


def run_all(cmds: list, timeout_s: float, *, capture: bool = False, meanwhile=None,
            env=None) -> tuple:
    """Start every command at once from the repository root, call
    ``meanwhile()`` while they run, and wait for them all.  Returns
    ``([(exit code, stdout, stderr, wall seconds)], what meanwhile
    returned)``, the outputs None without ``capture``.  A command still
    running after ``timeout_s`` is killed and its exit code is None.
    Should ``meanwhile`` raise, every command still running is killed
    first."""
    t0 = time.monotonic()
    files = [[tempfile.TemporaryFile("w+") if capture else None for _ in "oe"] for _ in cmds]
    procs, walls, mid = [], [None] * len(cmds), None
    try:
        for cmd, (out, err) in zip(cmds, files):
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, text=True, stdout=out,
                                          stderr=err))
        if meanwhile is not None:
            mid = meanwhile()
        while time.monotonic() - t0 < timeout_s:
            for i, p in enumerate(procs):
                if walls[i] is None and p.poll() is not None:
                    walls[i] = time.monotonic() - t0
            if None not in walls:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = [[_drain(f) for f in pair] for pair in files]
    rcs = [None if w is None else p.returncode for p, w in zip(procs, walls)]
    return [(rc, out, err, w) for rc, (out, err), w in zip(rcs, texts, walls)], mid


def _drain(f):
    if f is None:
        return None
    with f:
        f.seek(0)
        return f.read()
