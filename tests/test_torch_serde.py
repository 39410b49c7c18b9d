"""Parity of the port's scalar engine and serde codec
(``crdt_tpu_torch.scalar``, ``crdt_tpu_torch.utils.serde``) with the JAX
package's: the same seeded ops build the same states in both packages,
the two ``to_binary`` give the same bytes for every type the codec
covers, ``from_binary`` round-trips, and malformed bytes fail the same
way in both."""

import numpy as np
import pytest
import torch

import crdt_tpu.scalar as jax_scalar
import crdt_tpu.utils.serde as jax_serde
import crdt_tpu_torch.scalar as port_scalar
import crdt_tpu_torch.utils.serde as port_serde
from crdt_tpu.scalar import map as jax_map, mvreg as jax_mvreg, orswot as jax_orswot
from crdt_tpu.scalar import pncounter as jax_pn
from crdt_tpu_torch.scalar import map as port_map, mvreg as port_mvreg
from crdt_tpu_torch.scalar import orswot as port_orswot, pncounter as port_pn

torch.set_num_threads(1)

MEMBERS = (0, 1, 7, 63, 64, 300, 2**20, "a", "bé", (1, "t"))
SEEDS = range(4)


class _Pkg:
    """One package's scalar types and codec under one namespace."""

    def __init__(self, scalar, serde, orswot, mvreg, pn, map_):
        self.s, self.serde = scalar, serde
        self.ORm, self.Put, self.PNOp, self.Dir = orswot.Rm, mvreg.Put, pn.Op, pn.Dir
        self.MapNop, self.MapRm = map_.Nop, map_.Rm


JAX = _Pkg(jax_scalar, jax_serde, jax_orswot, jax_mvreg, jax_pn, jax_map)
PORT = _Pkg(port_scalar, port_serde, port_orswot, port_mvreg, port_pn, port_map)


def _actor(rng):
    return [0, 1, 5, 64, "x", "actor-2"][rng.randint(6)]


def _member(rng):
    return MEMBERS[rng.randint(len(MEMBERS))]


def _orswot(p, rng, n_ops=12):
    s = p.s.Orswot()
    for _ in range(n_ops):
        member, actor, roll = _member(rng), _actor(rng), rng.rand()
        if roll < 0.6:
            s.apply(s.add(member, s.value().derive_add_ctx(actor)))
        elif roll < 0.8:
            s.apply(s.remove(member, s.contains(member).derive_rm_ctx()))
        else:  # a remove from the causal future: deferred
            s.apply(s.remove(member, p.s.RmCtx(
                clock=p.s.Dot(actor, int(rng.randint(1, 9))).to_vclock())))
    return s


def _mvreg(p, rng):
    regs = [p.s.MVReg() for _ in range(3)]
    for _ in range(6):
        r = regs[rng.randint(3)]
        r.apply(r.set(int(rng.randint(-50, 50)), r.read().derive_add_ctx(_actor(rng))))
    regs[0].merge(regs[1])
    return regs[0]


def _map(p, rng, nested):
    m = p.s.Map(p.serde.MapOf(p.s.MVReg) if nested else p.s.MVReg)
    for _ in range(6):
        key, actor = int(rng.randint(0, 4)), _actor(rng)
        if rng.rand() < 0.75:
            val = int(rng.randint(0, 99))
            if nested:
                op = m.update(key, m.get(key).derive_add_ctx(actor),
                              lambda mm, c, v=val: mm.update(
                                  v % 3, c, lambda r, c2, v=v: r.set(v, c2)))
            else:
                op = m.update(key, m.get(key).derive_add_ctx(actor),
                              lambda r, c, v=val: r.set(v, c))
        else:
            op = m.rm(key, m.get(key).derive_rm_ctx())
        m.apply(op)
    return m


def _build(p, kind, seed):
    """Objects of ``kind`` from one seeded op sequence, in package ``p``."""
    rng = np.random.RandomState(seed)
    s = p.s
    if kind == "primitives":
        return [None, True, False, 0, -1, 2**64 + seed, -(2**70), "héllo", b"by\x00tes",
                [1, [2, "x"]], (1, "a", None), {1: "a", "b": [2]}, {3, 1, seed},
                frozenset({4, "f"}), 3.25 + seed, float("-inf")]
    if kind == "vclock":
        return [s.VClock.from_iter([(_actor(rng), int(rng.randint(1, 2**40)))
                                    for _ in range(rng.randint(0, 6))]) for _ in range(4)]
    if kind == "dot":
        return [s.Dot(_actor(rng), int(rng.randint(0, 2**33))) for _ in range(4)]
    if kind == "gcounter":
        g = s.GCounter()
        for _ in range(8):
            g.apply(g.inc(_actor(rng)))
        return [g, s.GCounter()]
    if kind == "pncounter":
        c = s.PNCounter()
        for _ in range(8):
            actor = _actor(rng)
            c.apply(c.inc(actor) if rng.rand() < 0.6 else c.dec(actor))
        return [c, s.PNCounter()]
    if kind == "lwwreg":
        return [s.LWWReg(val=_member(rng), marker=int(rng.randint(0, 2**40))) for _ in range(3)]
    if kind == "gset":
        return [s.GSet({_member(rng) for _ in range(rng.randint(0, 6))}) for _ in range(3)]
    if kind == "mvreg":
        return [_mvreg(p, rng), s.MVReg()]
    if kind == "orswot":
        return [_orswot(p, rng) for _ in range(4)] + [s.Orswot()]
    if kind == "map":
        return [_map(p, rng, nested=False), _map(p, rng, nested=True)]
    if kind == "ops":
        a = _orswot(p, rng, 4)
        m = s.Map(s.MVReg)
        return [
            a.add(_member(rng), a.value().derive_add_ctx(_actor(rng))),
            a.remove(_member(rng), a.value().derive_rm_ctx()),
            p.ORm(clock=s.Dot(_actor(rng), 3).to_vclock(), member=_member(rng)),
            p.Put(clock=s.Dot(_actor(rng), 1).to_vclock(), val=int(rng.randint(0, 99))),
            p.PNOp(dot=s.Dot(_actor(rng), 2), dir=p.Dir.POS),
            p.PNOp(dot=s.Dot(_actor(rng), 2), dir=p.Dir.NEG),
            p.MapNop(),
            p.MapRm(clock=s.Dot(_actor(rng), 1).to_vclock(), key=int(rng.randint(0, 9))),
            m.update(5, m.get(5).derive_add_ctx(_actor(rng)), lambda r, c: r.set(7, c)),
        ]
    if kind == "ctxs":
        a = _orswot(p, rng, 6)
        read = a.value()
        return [read, read.derive_add_ctx(_actor(rng)), read.derive_rm_ctx(),
                a.contains(_member(rng))]
    raise ValueError(kind)


KINDS = ("primitives", "vclock", "dot", "gcounter", "pncounter", "lwwreg", "gset", "mvreg",
         "orswot", "map", "ops", "ctxs")


@pytest.mark.parametrize("kind", KINDS)
def test_to_binary_matches_jax_package(kind):
    for seed in SEEDS:
        want = [jax_serde.to_binary(x) for x in _build(JAX, kind, seed)]
        got = [port_serde.to_binary(x) for x in _build(PORT, kind, seed)]
        assert got == want, (kind, seed)


@pytest.mark.parametrize("kind", KINDS)
def test_from_binary_round_trips(kind):
    for seed in SEEDS:
        for x, jax_blob in zip(_build(PORT, kind, seed),
                               (jax_serde.to_binary(y) for y in _build(JAX, kind, seed))):
            blob = port_serde.to_binary(x)
            back = port_serde.from_binary(blob)
            assert port_serde.to_binary(back) == blob
            if kind not in ("ops", "ctxs"):  # value types compare by value
                assert back == x
            mod = type(back).__module__
            assert not mod.startswith("crdt_tpu."), mod  # the port's own types
            # the JAX package's bytes decode in the port to the same bytes
            assert port_serde.to_binary(port_serde.from_binary(jax_blob)) == jax_blob


def _outcome(serde, data):
    try:
        return "ok", serde.to_binary(serde.from_binary(data))
    except Exception as e:  # the class by name is the contract under test
        return "raise", type(e).__name__


def _malformed():
    """Truncations of every prefix, flipped bytes, unknown tags, overlong
    varints, trailing bytes and deep nesting."""
    rng = np.random.RandomState(11)
    blobs = [jax_serde.to_binary(x) for kind in ("orswot", "map", "mvreg", "ops", "primitives")
             for x in _build(JAX, kind, 0)]
    out = []
    for b in blobs[::3]:
        out += [b[:k] for k in range(len(b))]
        for _ in range(4):
            flipped = bytearray(b)
            if flipped:
                flipped[rng.randint(len(flipped))] ^= 1 << rng.randint(8)
            out.append(bytes(flipped))
        out.append(b + b"\x00")
    out += [b"", b"\xff", b"\x7f\x00", b"\x03" + b"\x80" * 3000, b"\x07" * 300 + b"\x00",
            b"\x26\x05", b"\x05\x02\xff\xfe"]
    return out


def test_malformed_bytes_fail_alike():
    for data in _malformed():
        assert _outcome(port_serde, data) == _outcome(jax_serde, data), data


@pytest.mark.parametrize("name", ["vclock", "gcounter", "pncounter", "lwwreg", "mvreg", "gset",
                                  "orswot", "map"])
def test_port_scalar_doctests(name):
    """The copies keep the JAX package's runnable examples, and pass them."""
    import doctest
    import importlib

    module = importlib.import_module(f"crdt_tpu_torch.scalar.{name}")
    result = doctest.testmod(module, verbose=False)
    assert result.attempted > 0 and result.failed == 0
