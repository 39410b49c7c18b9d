"""The port's smaller tools against the JAX package, on the CPU:
``wire_zoo`` (every family's merged blobs against ``to_binary`` of the
JAX scalar merge of the same states), ``pprint`` (its lines against the
JAX scalars' Display forms), ``anti_entropy`` (the walkthrough, steps 4
and 5 over eight gloo ranks, and their skip lines below eight cards), and
every tool's default device without a card.  The JAX oracle is
``crdt_tpu.scalar`` and ``crdt_tpu.utils.serde``."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from crdt_tpu import MVReg as JaxMVReg
from crdt_tpu import Orswot as JaxOrswot
from crdt_tpu import VClock as JaxVClock
from crdt_tpu.utils import serde as jax_serde
from crdt_tpu_torch import DeviceUnavailableError
from crdt_tpu_torch.tools import anti_entropy, multihost, pprint, replicate_tcp, wire_zoo
from crdt_tpu_torch.utils.serde import to_binary

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_wire_zoo_blobs_are_the_jax_scalar_merge(capsys):
    merged = wire_zoo.run(torch.device("cpu"))
    out = capsys.readouterr().out
    assert "wire zoo: all 9 type families converged" in out
    site_a, site_b = wire_zoo.build_sites()
    assert list(merged) == list(site_a) and len(merged) == 9
    for name, blobs in merged.items():
        want = []
        for a, b in zip(site_a[name], site_b[name]):
            ja, jb = (jax_serde.from_binary(to_binary(s)) for s in (a, b))
            ja.merge(jb)
            want.append(jax_serde.to_binary(ja))
        assert blobs == want, name
        assert f"{name:>14}: converged, byte-faithful" in out


def test_pprint_lines_are_the_jax_display_forms():
    vclock = JaxVClock()
    for actor, counter in ((31231, 2), (4829, 9), (87132, 32)):
        vclock.witness(actor, counter)
    reg = JaxMVReg()
    ops = [reg.set(v, reg.read().derive_add_ctx(a))
           for v, a in (("some val", 9742820), ("some other val", 648572))]
    for op in ops:
        reg.apply(op)
    sets = []
    for items in (["apple", "pear"], ["plum"]):
        s = JaxOrswot()
        for actor, member in enumerate(items):
            s.apply(s.add(member, s.value().derive_add_ctx(actor)))
        sets.append(", ".join(sorted(map(str, s.value().val))))
    assert pprint.lines(torch.device("cpu")) == [
        f"vclock:\t{vclock}", f"reg:\t{reg}", *(f"orswot[{i}]:\t{{{v}}}"
                                                for i, v in enumerate(sets))]


def test_anti_entropy_walkthrough_with_eight_gloo_ranks():
    proc = subprocess.run([sys.executable, "-m", "crdt_tpu_torch.tools.anti_entropy",
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=240)
    assert proc.returncode == 0, (proc.stdout[-1500:], proc.stderr[-1500:])
    for line in ("1. op replication over the wire: ['apple', 'pear']",
                 "2. deferred remove resolved after anti-entropy: ['fig', 'pear']",
                 "3. batched join: 8 fleets × 256 objects",
                 "4. collective join over a 8-device mesh axis matches the batched join",
                 "5. typed collective joins: LWW marker-argmax winner 'edit-7'; MVReg keeps all "
                 "8 concurrent values",
                 "6. elastic regrowth: capacity 2 → 8", "byte-identical to the scalar codec",
                 "ingest native_fraction=1.0; all replica digest vectors converged",
                 "9. causal GC: member capacity 32 -> 8", "anti-entropy walkthrough: OK"):
        assert line in proc.stdout, line
    assert proc.stdout.count("4. collective join") == 1  # rank 0 alone prints


def test_anti_entropy_skips_the_collectives_below_eight_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    anti_entropy.collective_joins(torch.device("cuda"))
    assert capsys.readouterr().out.splitlines() == [
        "4. collective join skipped (1 devices < 8)",
        "5. typed collective joins skipped (1 devices < 8)"]


@pytest.mark.parametrize("tool", [replicate_tcp, wire_zoo, pprint, anti_entropy, multihost],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_default_device_without_a_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        tool.main([])
