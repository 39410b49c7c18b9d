#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``crdt_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, the full main path

Phases, in order; any failure ends the run with a nonzero exit:

1. environment — card name and power limit, torch, CUDA and nvcc versions;
2. build — every kernel under ``crdt_tpu_torch/csrc`` with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card
   (bit for bit, overflow flags included) on seeded inputs: the
   north-star shapes, a ragged object count, full-range u32 counters,
   forced member/union overflow, and the prebiased round trip; K1, K2
   and K3 in every instantiation and by both copy routes (odd widths,
   u_cap=32, M=32 at u_cap=16, three objects, ragged-N views, unaligned
   planes, duplicate ids; K3 also M=8 into m_cap=16, R=1 and forced
   overflow, with the plunger on and off) through each alignment path
   (one match or the loop), and K2's and K3's direct routes for widths
   too wide for shared memory (A=256, M=64); then, at the main path's
   own shapes, each kernel against its plain version again, K3's peak
   device memory per call, and their times beside the kernel's bound;
4. main path — the north-star anti-entropy fold (A=64, M=16, D=2, R=8,
   1.25M objects in 62,500-object chunks) built on the device from
   seeded columns and folded with ``orswot_ops.fold_merge(impl="pallas")``
   (the union-aligned kernel); the first chunk is also folded by the
   sequential pairwise fold (the merge kernel), by the sequential fold
   kernel and by ``JoinExecutor().join_all`` on eight ``OrswotBatch``
   fleets, and all must agree;
5. regrow — a forced member-overflow ladder (m 2→4→8) through
   ``JoinExecutor`` on the card;
6. wire leg — the north-star fleets as wire blobs: each chunk's R
   replica fleets, built on the device, are encoded by
   ``OrswotBatch.to_wire``; then ``PipelinedWireLoop(uni,
   device="cuda")`` (parse on a thread, H2D on a copy stream, the merge
   kernel, D2H, encode) folds every chunk, two rounds each, in one run
   per mode: overlapped and serial in the order O S X S O, X the
   overlapped loop with the codec's thread team at half the cores.
   Every run's blobs must equal ``to_wire`` of the union-aligned fold of
   the same planes, which must equal, on 64 sampled objects, the scalar
   engine's fold (``from_binary`` → left ``merge`` → plunger →
   ``to_binary``); ``from_wire(to_wire(x))`` must equal ``x`` plane for
   plane, every blob must take the host codec, and a truncated blob must
   raise ``WireFormatError``.  At least 2 chunks, and all 20 while their
   encoding stays inside its time budget.

6b. wire routes — one chunk of those fleets through ``from_wire`` and
   ``to_scalar`` by both routes (dense planes, or COO columns expanded
   and compacted on the card), timed, with the bytes each copies to the
   card; both must give the blobs back, and the COO planes must equal the
   dense planes' self-merge (ascending-id slots);
7. op path — a 1.25M-object fleet (A=64, M=16, D=2, u32) built on the
   card and self-merged; 32 frames of 65,536 ops (~90% adds, ~10%
   removes, some ahead of the clock, one frame early) folded by
   ``PipelinedOpLoop`` overlapped, serial, serial, overlapped, and once
   profiled.  Both self-merges must equal the plain merge, every run must
   give the same planes, re-delivering every frame must change nothing,
   2,048 sampled objects must equal the scalar engine applying the same
   ops in causal order, and ``from_coo(to_coo(x))`` must equal ``x``;
   then the device times of the op path's torch bodies and their bounds.

8. flat types — VClock (1k and 1M x 64), GCounter (2 replicas x 4
   actors), PNCounter (1M x [2, 32]), LWWReg (10M), GSet (1M x 1024) and
   MVReg (250k x K=8 x A=64) fleets, u64, generated on the card from a
   seed: R replicas folded through the batch ``merge`` (timed by CUDA
   events, beside the bytes bound), the fold held against the same
   merges on the CPU (MVReg: its first 32,768 objects) and, on 512
   sampled objects (MVReg 256), against the scalar engine; a wire round
   on at most 62,500 objects of each (``to_wire`` of each replica,
   ``from_wire`` → fold → ``to_wire``,
   byte-equal to ``to_wire`` of the device fold, every blob through the
   host codec, a truncated blob raising
   ``WireFormatError``); then 16 op frames of 65,536 ``inc``/``dec``/``set``
   ops through ``encode_ops_frame``/``decode_ops_frame`` into the
   GCounter, PNCounter and LWWReg fleets (frame 11 before frame 10, every
   frame delivered twice, a sample against the scalar engine; planted
   LWW conflicts raise and match the bitmap).  One ``flat_types`` JSON
   line carries every number.  The phase launches no kernel: its bodies
   are torch ops, as the JAX package's are ``jnp``.

9. Map — ``Map<K, Orswot>`` and ``Map<K, MVReg>`` (65,536 objects in
   chunks of 8,192) and ``Map<K, Map<K2, MVReg>>`` (1,024 in chunks of
   256) at the config-default widths (A=64, K=16, M=32, D=8,
   mv_capacity 8; u32): each chunk's R=4 replica fleets, built on the card
   by seeded ``apply_up``/``apply_rm`` rounds (the nested maps from seeded
   scalar maps through ``from_wire``), joined by ``JoinExecutor`` and
   truncated by a seeded clock; the nested sets merge through the merge
   kernel, three launches per Map merge.  Chunk 0 of each composition is
   held against the same join on the CPU (its first 512 objects, 128 of
   ``Map<K, Orswot>``, 16 of the nested maps) and, on 64 sampled
   objects, the port's scalar engine, and makes a wire round through its
   codec leg (blobs ``to_binary`` of the scalar result, codec share
   1.0); each of the merge kernel's three launches in one Map<K, Orswot>
   merge is held against ``merge_reference`` at the nested shape it was
   handed and timed there, and that merge is profiled once (device busy
   time, idle share, top ops).  One ``maps`` JSON line carries the numbers.

10. sync and GC — two replicas of 1.25M objects at the north-star widths
   (``bench.py::bench_sync``'s shape: ``anti_entropy_fleets(base=4,
   novel=0, deferred_frac=0.25)`` in 62,500-object chunks, one plunger
   self-merge), each with one add on its own seeded 1% of the rows; the
   digests of both (CUDA events, beside their bytes bound), both digest
   trees and ``simulate_descent``, whose set must equal
   ``diverged_indices`` and the planted rows; then the two replicas
   reconcile as ``bench.py::bench_sync`` does, through ``sync_pair`` of
   two ``SyncSession``s (hello, eager digests, delta frames both ways,
   the merge kernel on the diverged rows, the verify), after which both
   reports must show the planted rows, two digest rounds and no
   fallback, each side's ``delta_ratio`` must stay at or under 0.10 of
   the full state's ``to_wire`` bytes (its first chunk's times 20), each
   replica must equal the merge kernel's full-fleet merge of the two and
   64 sampled rows the scalar engine; an idle re-sync of the converged replicas with the digest
   tree must be one root frame each way; one replica regrown to M=32, D=8 and
   collected by ``GcEngine`` (watermark from both version vectors,
   settle, repack to M=16, D=2, an op log of 4 frames of 65,536 ops
   compacted), whose reclaimed bytes must equal the planes' difference
   and whose join with the other replica must digest as the un-collected
   join; ``truncate_orswot`` at the watermark on one chunk against the
   plain (rank) path.  Every launch of the merge kernel in the phase is
   held against ``merge_reference``.  One ``sync_gc`` JSON line carries
   the numbers.

11. read front-end — phase 10's replica P (1.25M objects, A=64, M=16,
   D=2) read by ``bench.py::bench_reads``'s traffic: ``WorkloadGen(seed
   29, zipf_s=1.1, burst_len=4, read_frac=0.5).draw_mixed``, 40 batches of
   8,192 reads through ``serve.gather`` (a quarter ``value()`` reads, the
   rest ``contains()`` probes on members below 2M; each frame held against
   the same reads on a CPU copy of their rows), every batch into
   ``HeatTracker.record_reads`` (one in 8 under the ``frontier`` mode, its
   statuses stamped from the frontier), the write half folded in 4 chunks
   by ``derive_add_ctx`` + ``OpApplier.apply_ops``; two peers' evidence
   (one equal to the fleet, one lagging on subtree 0) before each frontier
   batch, the frontier held against a numpy min over the peers; the heat
   totals against the stream's bincount, the sketch's top 8 and error
   bounds against the true counts; 4,096 reads against the scalar
   ``ReadCtx`` loop; ``StabilityTracker.audit`` of 4,096 rows (the merge
   kernel, held against ``merge_reference``); ``CapacityTracker`` samples
   and ``GcEngine.due``; the kernel observatory timing every launch; then
   one batch of each other kind on a small fleet against the CPU.  One
   ``reads`` JSON line carries the numbers.

12. cluster transport — phase 11's replica P as it stands (1.25M objects,
   A=64, M=16, D=2) after one plunger self-merge (phase 11's op writes
   leave member slots out of ascending-id order, which a session keeps
   on the rows it does not touch and the full-fleet merge it is checked
   against sorts), and Q = P, each with one add on its own seeded 1% of
   the rows (phase 10's ``diverge``); a listener on 127.0.0.1:0 dialed
   through ``FlappingDialer(schedule=(False, False, True))`` with each
   attempt recorded in a ``Membership(suspect_after=2)`` (the peer must
   go alive → suspect → alive); each end ``ResilientTransport(
   FaultyTransport(TcpTransport(sock), plan))`` with ``bench_sync``'s
   policy (30 s deadlines, 0.1 s first timer, 2 s backoff cap, a budget
   of 256, window 16) and a seeded plan per side of 2% drops, duplicates,
   truncations and delays; two flat ``SyncSession``s on two threads (v4,
   streaming at window 16), then both ends closed.  Phase 10's session
   checks (converged on the planted rows, no fallback, ``delta_ratio`` ≤
   0.10, each replica equal to the merge kernel's full-fleet merge, 64
   rows against the scalar engine), every launch of the merge kernel
   against ``merge_reference``, each planned fault kind injected at least
   once across the two sides and the ARQ's retransmits, duplicates and
   corrupt envelopes non-zero.  One ``cluster`` JSON line carries the
   numbers: the frames and bytes each side put on its socket (counted by
   ``SocketCount``, retransmits included), each side's ARQ counts, RTT
   estimate and injected faults, the roster's transitions, the merge
   kernel's launches and device time, peak memory.

13. gossip fleet — three ``ClusterNode``s on the card, n0 holding phase
   12's reconciled replica P and n1, n2 copies of it (1.25M objects, A=64,
   M=16, D=2, u32), each with the digest tree, its own lag, stability and
   heat trackers, a loopback TCP listener accepting through
   ``ResilientTransport(TcpTransport)`` (window 16, no faults), a roster of
   the other two and a ``GossipScheduler(fanout=2, seed=i)``.  A fleet
   round runs the three schedulers' ``run_round`` in turn; before each of
   the first two rounds each node takes 5,461 writes of phase 11's key
   stream (writer actor i + 1, members 200-203), minted on the main
   thread by ``derive_add_ctx(node.write_clock())`` and ``submit_ops``.  A
   reader thread meanwhile serves batches of 8,192 reads (a quarter
   ``value()``, the rest ``contains()`` on members below 32) through
   ``serve_frames`` on the nodes in turn: read-your-writes batches carry
   the node's ``write_vv()`` and probe its acknowledged writes, monotonic
   ones the node's last token, one in 8 runs under ``frontier``; parks
   wait up to 10 s.  Rounds run until the digests agree and a whole round
   finds no divergence (at most 8).  Checks: no failed session leg (a
   refusal by a node's busy bound is counted apart), no rejected RYW or
   monotonic read and every probed write read as a member, one eventual
   request frame byte-equal on all nodes, the rows no write touched equal
   to the start, each node self-merged equal to the merge kernel's join
   of the start with each node's op batches applied by ``OpApplier``, and
   every merge-kernel launch against ``merge_reference``.  One ``gossip``
   JSON line carries the numbers: rounds and their walls, each session
   leg's wall and profile split, the merge kernel's launches and device
   time, writes and reads per second with the serve stages, parks and
   rejections per mode, peak memory.

14. durability — two ``ClusterNode``s on the card, n0 on phase 12's
   replica P and n1 on a copy, phase 13's listeners and dialers with a
   ``GossipScheduler(fanout=1)`` each; n1 has ``Durability(<dir>,
   interval_rounds=1, retain=2, fsync=True)`` in ``build/`` of the
   checkout (the phase fails, printing both, when the filesystem cannot
   hold one generation).  Each node takes 5,461 writes (phase 13's stream,
   members 200-203), n1's WAL-appended before the fold; one round, whose
   end on n1 writes generation 1; n1 takes 5,461 more writes, then dies
   in a further ``submit_ops`` at the crash point ``oplog.fold.n1``
   (after its WAL append, before the fold); the kill stops its scheduler,
   closes its listener and drops every reference, and the device memory
   allocated must fall by the replica's 6.17 GB with no cyclic
   collection; n0 takes 5,461 writes; ``recover(<dir>, device="cuda")``
   restores and replays; n1 is rebuilt with the recovered applier, the
   restored stability frontier and a ``Durability`` whose cadence writes
   no second snapshot; rounds run until the digests agree and a round
   finds nothing.  Checks: the restored generation's digest vector equal
   to n1's at its checkpoint, every WAL'd op replayed (the killed batch
   too), every write n1 acknowledged read back as a member through
   ``serve.gather`` before the rejoin and every write of either node on
   both after it, no rejoin leg shipping full state, the merge kernel
   launched by the rejoin and each launch against ``merge_reference``;
   the checkpoint bytes of a pinned batch are compared with the JAX
   package's (a reported field).  The durable directory is removed at
   the end.  One ``durable`` JSON line: the snapshot's bytes and the
   checkpoint's split (drain, digest, ``to_numpy`` and D2H, npz, CRC,
   write and fsync, rename and directory fsync, WAL roll and truncate),
   the WAL's frames, bytes and append ms (a probe of 128 fsync'd frames:
   p50, p99), acknowledged writes/s per batch on n1 (WAL'd) and n0, the
   restore's split (read, CRC, decode, H2D, root verify, replay) and
   report, the rejoin's rounds, leg walls, rows diverged and delta bytes
   against the full state's, K2 launches, peak device memory and host
   RSS, free disk and host memory before the phase, and its wall time.

Launch counts are reset just before phase 4 and read just after, and
again around phases 5, 6, 6b, 7, 8, 9 and 11, around phase 12's sessions,
around phase 13's rounds and reads, around phase 14's rounds, writes,
kill and rejoin, and around each step of phase 10's
main path (the replicas' plunger, the
session step, the GC pass and the truncate; the checks between them are
not counted).  The last lines are the kernel table (JSON), the card's
name and power limit, and ``{"ok": true, "device": ...}``.  Needs one
CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
# north-star shapes (BASELINE.md ★)
N_TOTAL, A, M, D, R, CHUNK = 1_250_000, 64, 16, 2, 8, 62_500
BASE, NOVEL, DEFERRED_FRAC = 6, 1, 0.25
U_CAP = 16
CHECK_N = 4096
WIRE_MIN_CHUNKS, WIRE_PREP_S, WIRE_SAMPLE, WIRE_ROUNDS = 2, 75.0, 64, 2
# the wire loop's runs over every chunk: (label, overlap, codec team)
WIRE_RUNS = (("overlapped", True, "all"), ("serial", False, "all"),
             ("overlapped, half team", True, "half"), ("serial", False, "all"),
             ("overlapped", True, "all"))
# the op path (phase 7): frames of ops, the frame delivered early, the sample
OP_FRAMES, OP_FRAME_OPS, OP_SWAP, OP_SAMPLE = 32, 65_536, 10, 2048
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")
# the flat types (phase 8), u64: BASELINE.md configs 1, 2 (1k and 1M
# clocks), 3 and 5, a 1M x 1024 GSet and a 250k x K=8 MVReg fleet; the op
# frames of bench.py::bench_oplog's largest batch
FLAT_A, FLAT_PN_A, FLAT_N, FLAT_LWW_N, FLAT_U, FLAT_K, FLAT_MV_N = (
    64, 32, 1_000_000, 10_000_000, 1024, 8, 250_000)
FLAT_WIRE_R, FLAT_SAMPLE, FLAT_ITERS, FLAT_FRAMES, FLAT_FRAME_OPS = 2, 2048, 5, 16, 65_536
# the chip budget's cut 1 (the script ran 719 s on an H100 whose host ran
# every phase ~25% slower than the run before): MVReg's scalar check
# samples FLAT_MVREG_SAMPLE objects (the other folds FLAT_SAMPLE), and its
# CPU plain-path check takes its first FLAT_MVREG_CPU objects
FLAT_MVREG_SAMPLE, FLAT_MVREG_CPU = 256, 32_768
# the chip budget's cut 5 (the script ran 649 s with phase 14 on an H100,
# against its 600 s ground rule): the wire round of a fleet larger than
# FLAT_WIRE_N objects (the 1M, 10M and 250k fleets) takes the first
# FLAT_WIRE_N objects of its FLAT_WIRE_R replicas
FLAT_WIRE_N = 62_500
# the Map phase (9), u32 at the config defaults: A=64, K=16, M=32, D=8,
# mv_capacity 8; Map<K, Orswot> and Map<K, MVReg> 65,536 objects in chunks
# of 8,192, Map<K, Map<K2, MVReg>> 1,024 in chunks of 256; R=4 replicas of
# 12 actors each (the base's are 0-11), built by 4 shared and 3 own op rounds
MAP_A, MAP_K, MAP_M, MAP_D, MAP_KV = 64, 16, 32, 8, 8
# MAP_NESTED_N is the chip budget's cut 3 (2,048 before) and
# MAP_ORSWOT_CPU its cut 2 (512 before): see FLAT_MVREG_SAMPLE
MAP_N, MAP_CHUNK, MAP_NESTED_N, MAP_NESTED_CHUNK = 65_536, 8_192, 1_024, 256
MAP_ORSWOT_CPU = 128
MAP_R, MAP_ACTORS, MAP_MEMBERS, MAP_ROUNDS, MAP_SAMPLE = 4, 12, 64, (4, 3), 64
MAP_K2_SETS = 16_384  # sets per call of the merge kernel's plain version
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# the data sheet gives no INT32 rate: 64 INT32 lanes x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 16.7e12

REPLACES = {
    "orswot_fold_aligned": "crdt_tpu/ops/orswot_fold_aligned.py:282",
    "orswot_merge": "crdt_tpu/ops/orswot_pallas.py:457",
    "orswot_fold": "crdt_tpu/ops/orswot_pallas.py:559",
}
SOURCES = {
    "orswot_fold_aligned": "crdt_tpu_torch/csrc/orswot_fold_aligned.cu",
    "orswot_merge": "crdt_tpu_torch/csrc/orswot_merge.cu",
    "orswot_fold": "crdt_tpu_torch/csrc/orswot_fold.cu",
}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after one warm-up,
    by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(in_bytes: int, out_bytes: int, ops: float):
    """The least time the card could take: bytes moved once over the
    memory rate, or integer operations over the INT32 rate."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired planes (flags included)."""
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def rows_of(x, dev):
    """Host row indices → an int64 index tensor on ``dev``."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(dev)


def same_planes(got, want, what: str):
    """Raise unless every plane of batch ``got`` equals ``want``'s."""
    import torch

    for name in PLANES:
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"{what}: {name} differs")


def to_dev(planes, dev):
    """Unsigned numpy planes → biased device planes (the package domain)."""
    import torch

    from crdt_tpu_torch.dtypes import bias_np

    return tuple(
        torch.from_numpy(np.ascontiguousarray(bias_np(x) if i in (0, 2, 4) else x)).to(dev)
        for i, x in enumerate(planes)
    )


def stack_np(reps):
    return tuple(np.stack([rep[k] for rep in reps]) for k in range(5))


def full_range(rng, planes):
    """Rewrite every nonzero counter to one of 1, 2^31-1, 2^31, 2^32-1
    (and some set-clock lanes to 2^32-1), keeping clocks covering dots."""
    clock, ids, dots, d_ids, d_clocks = (np.array(x) for x in planes)
    vals = np.array([1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
    for x in (dots, d_clocks):
        nz = x != 0
        x[nz] = vals[rng.randint(0, len(vals), size=int(nz.sum()))]
    clock = np.maximum(clock, dots.max(axis=-2))
    top = rng.rand(*clock.shape) < 0.05
    clock[top] = np.uint32(2**32 - 1)
    return clock, ids, dots, d_ids, d_clocks


def shifted(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: the kernels must stage it by per-lane cp.async."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# -- phase 3 -------------------------------------------------------------------


def check_kernels(dev):
    """Each kernel against its plain version on the card; returns the
    largest difference seen per kernel (0 is required)."""
    import torch

    from crdt_tpu_torch.ops import orswot_fold_aligned as fa, orswot_tile as tile
    from crdt_tpu_torch.utils.testdata import anti_entropy_fleets, random_orswot_arrays

    rng = np.random.RandomState(SEED)
    worst = {name: 0 for name in REPLACES}
    over_seen = {"member": 0, "deferred": 0, "union": 0}

    def cmp(name, got, want, what):
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version on {what}: {err}")
        worst[name] = max(worst[name], err)

    def check_fold(st, what, u_cap=U_CAP, m_cap=M, d_cap=D):
        got = fa.fold_merge(*st, m_cap, d_cap, u_cap=u_cap, prebiased=True)
        want = fa.fold_merge_reference(*st, m_cap, d_cap, u_cap=u_cap)
        cmp("orswot_fold_aligned", got, want, what)
        got3 = tile.fold_merge(*st, m_cap, d_cap, prebiased=True)
        want3 = tile.fold_merge_reference(*st, m_cap, d_cap)
        cmp("orswot_fold", got3, want3, what)
        return got, got3

    def check_merge(sa, sb, what, m_cap=M, d_cap=D):
        got = tile.merge(*sa, *sb, m_cap, d_cap, prebiased=True)
        want = tile.merge_reference(*sa, *sb, m_cap, d_cap)
        cmp("orswot_merge", got, want, what)
        return got

    # north-star shapes
    fleets = anti_entropy_fleets(rng, CHECK_N, A, M, D, R, base=BASE, novel=NOVEL,
                                 deferred_frac=DEFERRED_FRAC)
    st = to_dev(stack_np(fleets), dev)
    check_fold(st, "north-star fleets")
    check_merge(tuple(x[0] for x in st), tuple(x[1] for x in st), "north-star pair")
    half = tuple(x[0::2].contiguous() for x in st), tuple(x[1::2].contiguous() for x in st)
    check_merge(*half, "tree level [4, N]")

    # ragged N (not a multiple of the 4-object block)
    n_rag = CHECK_N + 3
    a_np = random_orswot_arrays(rng, n_rag, A, M, D, deferred_frac=0.5, max_counter=8)
    b_np = random_orswot_arrays(rng, n_rag, A, M, D, deferred_frac=0.5, max_counter=8)
    sa, sb = to_dev(a_np, dev), to_dev(b_np, dev)
    check_merge(sa, sb, "ragged N")
    rag = to_dev(stack_np(anti_entropy_fleets(
        rng, n_rag, A, M, D, R, base=BASE, novel=NOVEL, deferred_frac=0.5)), dev)
    check_fold(rag, "ragged N fleets")

    # full-range u32 counters
    fr_a = to_dev(full_range(rng, a_np), dev)
    fr_b = to_dev(full_range(rng, b_np), dev)
    check_merge(fr_a, fr_b, "full-range counters")
    fr_st = to_dev(stack_np([full_range(rng, f) for f in anti_entropy_fleets(
        rng, n_rag, A, M, D, R, base=BASE, novel=NOVEL, deferred_frac=0.5)]), dev)
    check_fold(fr_st, "full-range fleets")

    # forced member overflow (m_cap below the survivors) and union overflow
    out = check_merge(sa, sb, "member overflow", m_cap=4)
    over_seen["member"] = int(out[5][:, 0].sum())
    out = check_merge(sa, sb, "deferred overflow", d_cap=1)
    over_seen["deferred"] = int(out[5][:, 1].sum())
    got, _ = check_fold(st, "union overflow u_cap=8", u_cap=8)
    over_seen["union"] = int(got[5][:, 0].sum())
    if min(over_seen.values()) == 0:
        raise AssertionError(f"forced overflow not flagged: {over_seen}")

    # prebiased round trip: uint32 in and out vs biased int32 in and out
    u32 = tuple(tile.from_kernel_domain(x) if i in (0, 2, 4) else x for i, x in enumerate(st))
    for name, plain_call, biased_call in (
        ("orswot_fold_aligned",
         lambda: fa.fold_merge(*u32, M, D, u_cap=U_CAP),
         lambda: fa.fold_merge(*st, M, D, u_cap=U_CAP, prebiased=True)),
        ("orswot_fold",
         lambda: tile.fold_merge(*u32, M, D),
         lambda: tile.fold_merge(*st, M, D, prebiased=True)),
        ("orswot_merge",
         lambda: tile.merge(*(x[0] for x in u32), *(x[1] for x in u32), M, D),
         lambda: tile.merge(*(x[0] for x in st), *(x[1] for x in st), M, D, prebiased=True)),
    ):
        got = plain_call()
        if got[0].dtype != torch.uint32:
            raise AssertionError(f"{name}: prebiased=False returned {got[0].dtype}")
        back = tile.to_kernel_domain(got[:5]) + (got[5],)
        cmp(name, back, biased_call(), "prebiased round trip")
    torch.cuda.synchronize()
    log(f"overflow rows flagged (forced): {over_seen}")
    check_routes(dev, rng, cmp)
    return worst


def check_routes(dev, rng, cmp):
    """K1, K2 and K3 in every instantiation (accumulator in registers or
    in shared memory; actor width at compile or run time), by every copy
    route (bulk copies, per-lane cp.async; K2 and K3 also the direct route
    for widths too wide for shared memory) and through each alignment
    path, K1 and K3 with the plunger on and off, bit for bit against their
    plain versions; raises unless every combination was taken."""
    from crdt_tpu_torch.ops import orswot_fold_aligned as fa, orswot_tile as tile
    from crdt_tpu_torch.utils.testdata import anti_entropy_fleets, random_orswot_arrays

    seen = {"orswot_fold_aligned": set(), "orswot_merge": set(), "orswot_fold": set()}

    def fleets(n, a, m, d, r, base, novel):
        return to_dev(stack_np(anti_entropy_fleets(rng, n, a, m, d, r, base=base, novel=novel,
                                                   deferred_frac=0.5)), dev)

    def fold(st, m, d, u_cap, what):
        plan = fa.fold_plan(st, d, u_cap)
        seen["orswot_fold_aligned"].add((plan["union_slots"] > 0, plan["bulk"], plan["align"]))
        for plunger in (True, False):
            got = fa.fold_merge(*st, m, d, u_cap=u_cap, plunger=plunger, prebiased=True)
            want = fa.fold_merge_reference(*st, m, d, u_cap=u_cap, plunger=plunger)
            cmp("orswot_fold_aligned", got, want, f"{what} {plan}")

    def fold3(st, m_cap, d_cap, what):
        plan = tile.fold_merge_plan(st, m_cap, d_cap)
        flags = 0
        for plunger in (True, False):
            if st[0].shape[0] == 1 and not plunger and (st[1].shape[-1], st[3].shape[-1]) != (
                    m_cap, d_cap):
                continue  # a one-replica fold without plunger keeps the input capacities
            seen["orswot_fold"].add((plan["actors_per_lane"] > 0, plan["route"], plan["align"],
                                     plunger))
            got = tile.fold_merge(*st, m_cap, d_cap, plunger=plunger, prebiased=True)
            want = tile.fold_merge_reference(*st, m_cap, d_cap, plunger=plunger)
            cmp("orswot_fold", got, want, f"{what} plunger={plunger} {plan}")
            flags = max(flags, int(got[5].any(0).sum()))
        return flags

    def merge(sa, sb, m_cap, d_cap, what):
        plan = tile.merge_plan(sa, sb, m_cap)
        seen["orswot_merge"].add((plan["actors_per_lane"] > 0, plan["route"], plan["align"]))
        got = tile.merge(*sa, *sb, m_cap, d_cap, prebiased=True)
        cmp("orswot_merge", got, tile.merge_reference(*sa, *sb, m_cap, d_cap), f"{what} {plan}")

    def pair(n, a, m, d, **kw):
        return (to_dev(random_orswot_arrays(rng, n, a, m, d, max_counter=6, deferred_frac=0.6,
                                            **kw), dev),
                to_dev(random_orswot_arrays(rng, n, a, m, d, max_counter=6, deferred_frac=0.6,
                                            **kw), dev))

    ns = fleets(CHECK_N, A, M, D, R, BASE, NOVEL)
    fold(ns, M, D, U_CAP, "north-star fleets")
    fold(tuple(shifted(x) for x in ns), M, D, U_CAP, "north-star fleets, unaligned")
    fold(tuple(x[:, :3].contiguous() for x in ns), M, D, U_CAP, "n=3")
    odd = fleets(CHECK_N + 3, 37, 5, 3, 3, 2, 1)
    fold(odd, 5, 3, 10, "A=37 M=5 D=3")
    wide = fleets(CHECK_N, A, 32, D, 4, 20, 3)
    fold(wide, 32, D, 32, "u_cap=32 M=32 m_cap=32")
    fold(tuple(shifted(x) for x in wide), 32, D, 32, "u_cap=32 M=32 m_cap=32, unaligned")
    rag = fleets(CHECK_N + 3, A, M, D, R + 1, BASE, NOVEL)
    view = tuple(x[1:] for x in rag)  # d_ids starts only 8-byte aligned
    if view[3].data_ptr() % 16 != 8:
        raise AssertionError("ragged view is not 8-byte aligned")
    fold(view, M, D, U_CAP, "ragged-N view")
    # a replica holding one id in two rows (invalid state): alignment joins
    # them; at M=32 with u_cap=16 too (register accumulator, 32 member rows)
    for st, m, what in ((ns, M, ""), (fleets(CHECK_N, A, 32, D, 4, 8, 2), 32, " M=32 u_cap=16")):
        dup = [x.clone() for x in st]
        dup[1][3, ::2, 1] = dup[1][3, ::2, 0]
        fold(tuple(dup), m, D, U_CAP, "duplicate ids in a replica" + what)
        fold(tuple(shifted(x) for x in dup), m, D, U_CAP,
             "duplicate ids in a replica" + what + ", unaligned")

    # K3 (sequential fold): staged by bulk copies or per-lane cp.async, or
    # direct; compile-time or run-time A; one match or the loops
    fold3(ns, M, D, "north-star fleets")
    fold3(tuple(shifted(x) for x in ns), M, D, "north-star fleets, unaligned")
    fold3(view, M, D, "ragged-N view")
    fold3(tuple(x[:, :3].contiguous() for x in ns), M, D, "n=3")
    fold3(odd, 5, 3, "A=37 M=5 D=3")
    fold3(fleets(CHECK_N, A, 8, D, 3, 4, 1), 16, 3, "M=8 into m_cap=16 d_cap=3")
    fold3(tuple(x[:1].contiguous() for x in ns), M, D, "R=1")
    dup = [x.clone() for x in ns]
    dup[1][3, ::2, 1] = dup[1][3, ::2, 0]
    fold3(tuple(dup), M, D, "duplicate ids in a replica")
    fold3(tuple(shifted(x) for x in dup), M, D, "duplicate ids in a replica, unaligned")
    randoms = to_dev(stack_np([random_orswot_arrays(rng, CHECK_N, A, M, D, max_counter=6,
                                                    deferred_frac=0.6) for _ in range(3)]), dev)
    if fold3(randoms, 4, 1, "forced overflow m_cap=4 d_cap=1") < 2:
        raise AssertionError("K3: forced member and deferred overflow not both flagged")
    fold3(wide, 32, D, "M=32 m_cap=32")
    fold3(tuple(shifted(x) for x in wide), 32, D, "M=32 m_cap=32, unaligned")
    fold3(fleets(CHECK_N + 3, 36, 8, 2, 3, 4, 1), 8, 2, "A=36 M=8 D=2")
    fold3(fleets(CHECK_N + 3, 37, 20, 3, 3, 8, 2), 20, 3, "A=37 M=20 D=3")
    fold3(fleets(CHECK_N + 3, 36, 20, 2, 3, 8, 2), 20, 2, "A=36 M=20 D=2")
    # footprint too wide for shared memory: the direct route
    fold3(fleets(67, 256, 64, D, 3, 24, 4), 64, D, "A=256 M=64 m_cap=64")

    sa, sb = pair(CHECK_N, A, M, D)
    merge(sa, sb, M, D, "north-star pair")
    merge(tuple(shifted(x) for x in sa), tuple(shifted(x) for x in sb), M, D,
          "north-star pair, unaligned")
    merge(tuple(x[:3].contiguous() for x in sa), tuple(x[:3].contiguous() for x in sb), M, D,
          "n=3")
    merge(*pair(CHECK_N + 3, 37, 5, 3), 5, 3, "A=37 M=5 D=3")
    merge(*pair(CHECK_N + 3, 36, 8, 2), 8, 2, "A=36 M=8 D=2")
    wide = pair(CHECK_N, A, 32, D)
    merge(*wide, 32, D, "M=32 m_cap=32")
    merge(*(tuple(shifted(x) for x in s) for s in wide), 32, D, "M=32 m_cap=32, unaligned")
    merge(*pair(CHECK_N + 3, 37, 20, 3), 20, 3, "A=37 M=20 D=3")
    merge(*pair(CHECK_N + 3, 36, 20, 2), 20, 2, "A=36 M=20 D=2")
    # stages too wide for shared memory: the direct route
    merge(*pair(67, 256, 64, D, min_live=24), 64, D, "A=256 M=64 m_cap=64")
    merge(tuple(x[1] for x in rag), tuple(x[2] for x in rag), M, D, "ragged-N view")
    # two live slots of one side with one id: the slow path of the rank
    # selection (ids summed as id + 1, rows maxed)
    dup_a = list(pair(CHECK_N, A, M, D, min_live=4)[0])
    ids = dup_a[1].clone()
    ids[::2, 1] = ids[::2, 0]
    dup_a[1] = ids
    merge(tuple(dup_a), sb, M, D, "duplicate live ids")

    # (registers or compile-time A, copy route, alignment path): every
    # instantiation by both copy routes through each alignment path it has
    want = {
        "orswot_fold_aligned": {(regs, bulk, align) for regs in (True, False)
                                for bulk in (True, False)
                                for align in (("match", "loop") if regs else ("loop",))},
        "orswot_merge": {(apl, route, align) for apl in (True, False)
                         for route in ("bulk", "words") for align in ("match", "loop")}
        | {(False, "direct", "loop")},
        "orswot_fold": {(apl, route, align, plunger) for apl in (True, False)
                        for route in ("bulk", "words") for align in ("match", "loop")
                        for plunger in (True, False)}
        | {(False, "direct", "loop", plunger) for plunger in (True, False)},
    }
    for name, got in seen.items():
        if got != want[name]:
            raise AssertionError(f"{name}: instantiation x route combinations taken {got}")
    log("  K1, K2 and K3: every instantiation by both copy routes and both alignment paths "
        "bit-equal to the plain versions (A=37 M=5 D=3, u_cap=32, M=32 u_cap=16, n=3, "
        "ragged-N views, unaligned copies, duplicate ids, duplicate live ids; K3 also M=8 "
        "into m_cap=16, R=1 and forced overflow, plunger on and off), K2's and K3's direct "
        "routes at A=256 M=64")


# Integer operations per actor column of one staged merge
# (csrc/orswot_merge_body.cuh), counted from its per-slot instruction
# stream, where the set clocks and the slot's row and aligned dot sit in
# registers (loads, stores, shuffles and votes are not counted).  An
# a-slot: the keep1/p2 pass (two compares, two ORs), then the closed-form
# rule (the select of oc, the e1 == e2 compare and select, two sub1 of a
# compare and a select each, one max) and the liveness compare and OR:
# 14.  A b-only slot: one sub1 and the liveness compare and OR, 4.  The
# clock join: one max.  Each valid deferred row's still-ahead test: a
# max, a compare and an AND, 3.
K3_OPS = {"a_slot": 14, "b_only": 4, "clock": 1, "d_row": 3}


def k3_ops(st, m_cap: int, d_cap: int, plunger: bool = True) -> int:
    """The integer operations K3 does on these biased ``[R, N, ...]``
    planes: for each merge of the sequential fold (the accumulator
    against replica r, then the plunger), ``K3_OPS`` times the valid
    a-slots, b-only slots, objects and deferred rows this data gives that
    step, over the actor columns; the steps' accumulators come from the
    plain fold."""
    import torch

    from crdt_tpu_torch.dtypes import EMPTY
    from crdt_tpu_torch.ops import orswot_tile as tile

    a = st[0].shape[-1]
    n = st[0].shape[1]

    def step_ops(sa, sb):
        va, vb = sa[1] != EMPTY, sb[1] != EMPTY
        matched = (vb[..., :, None] & va[..., None, :]
                   & (sb[1][..., :, None] == sa[1][..., None, :])).any(-1)
        d_rows = int((sa[3] != EMPTY).sum()) + int((sb[3] != EMPTY).sum())
        per_col = (K3_OPS["a_slot"] * int(va.sum()) + K3_OPS["b_only"] * int((vb & ~matched).sum())
                   + K3_OPS["clock"] * n + K3_OPS["d_row"] * d_rows)
        return a * per_col

    acc = tuple(x[0] for x in st)
    ops = 0
    for r in range(1, st[0].shape[0]):
        rep = tuple(x[r] for x in st)
        ops += step_ops(acc, rep)
        acc, _ = tile._merge_tile(acc, rep, m_cap, d_cap)
    if plunger:
        ops += step_ops(acc, acc)
    del acc
    torch.cuda.empty_cache()
    return ops


def time_kernels(dev, planes, worst):
    """Each kernel against its plain version at the main path's shapes —
    one 62,500-object chunk: the R-way folds on ``[8, 62500, …]``, the
    merge kernel on one pairwise ``[62500, …]`` merge and on a
    ``[4, 62500, …]`` tree level — bit for bit, raising ``worst`` to the
    largest difference seen; then kernel and plain times with each
    kernel's bound."""
    import torch

    from crdt_tpu_torch.ops import orswot_fold_aligned as fa, orswot_tile as tile

    st = planes
    pair = tuple(x[0] for x in st), tuple(x[1] for x in st)
    level = (tuple(x[0::2].contiguous() for x in st),
             tuple(x[1::2].contiguous() for x in st))
    n = st[0].shape[1]
    s_ab = 2 * M  # candidate member slots of one pairwise merge
    out_state = nbytes([st[k][0] for k in range(5)]) + n * 2 * 4
    rows = {}
    specs = {
        "orswot_fold_aligned": (
            lambda: fa.fold_merge(*st, M, D, u_cap=U_CAP, prebiased=True),
            lambda: fa.fold_merge_reference(*st, M, D, u_cap=U_CAP),
            nbytes(st), n * (R * U_CAP * A * 12 + R * M * A * 2),
        ),
        "orswot_fold": (
            lambda: tile.fold_merge(*st, M, D, prebiased=True),
            lambda: tile.fold_merge_reference(*st, M, D),
            nbytes(st), k3_ops(st, M, D),
        ),
        "orswot_merge": (
            lambda: tile.merge(*pair[0], *pair[1], M, D, prebiased=True),
            lambda: tile.merge_reference(*pair[0], *pair[1], M, D),
            nbytes(pair[0]) + nbytes(pair[1]), n * s_ab * A * 12,
        ),
    }
    checks = [(name, kernel, plain, f"main-path shapes {list(shape)}")
              for (name, (kernel, plain, _, _)), shape in zip(
                  specs.items(), (st[0].shape[:-1], st[0].shape[:-1], pair[0][0].shape[:-1]))]
    checks.append((
        "orswot_merge",
        lambda: tile.merge(*level[0], *level[1], M, D, prebiased=True),
        lambda: tile.merge_reference(*level[0], *level[1], M, D),
        f"tree level {list(level[0][0].shape[:-1])}",
    ))
    for name, kernel, plain, what in checks:
        err = max_abs_err(kernel(), plain())
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version on {what}: {err}")
        worst[name] = max(worst[name], err)
        log(f"  {name}: bit-equal to its plain version on {what}")
    del level
    torch.cuda.empty_cache()
    # K3's device memory per call above its inputs: the outputs only, where
    # the first design also allocated its accumulator scratch (2 states
    # per object)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = specs["orswot_fold"][0]()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del got
    log(f"  orswot_fold: peak device memory per call {peak / 1e6:.1f} MB above its inputs "
        f"(its outputs: {out_state / 1e6:.1f} MB)")
    for name, (kernel, plain, in_bytes, ops) in specs.items():
        ms = cuda_ms(kernel, 10)
        plain_ms = cuda_ms(plain, 2)
        torch.cuda.empty_cache()
        b_ms, by = bound_ms(in_bytes, out_state, ops)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}
        log(f"  {name}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound {b_ms:.4f} ms "
            f"({by}; {in_bytes + out_state} B, {ops:.4g} integer operations)")
    return rows


# -- phase 4 -------------------------------------------------------------------


def main_path(dev, n_chunks: int):
    import torch

    from crdt_tpu_torch import CrdtConfig, JoinExecutor, OrswotBatch, Universe
    from crdt_tpu_torch.ops import orswot_ops, orswot_tile as tile
    from crdt_tpu_torch.utils.testdata import build_fleet_planes, fleet_columns

    rng = np.random.RandomState(SEED + 1)
    uni = Universe.identity(CrdtConfig.gpu_default(
        num_actors=A, member_capacity=M, deferred_capacity=D))
    fold_ms = []
    first = None
    for c in range(n_chunks):
        cols = fleet_columns(rng, CHUNK, A, M, D, R, base=BASE, novel=NOVEL,
                             deferred_frac=DEFERRED_FRAC)
        planes = build_fleet_planes(cols, a=A, m_cap=M, d=D, base=BASE, novel=NOVEL,
                                    device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orswot_ops.fold_merge(*planes, M, D, impl="pallas", u_cap=U_CAP)
        torch.cuda.synchronize()
        fold_ms.append((time.perf_counter() - t0) * 1e3)
        if out[1].shape != (CHUNK, M) or out[2].shape != (CHUNK, M, A):
            raise AssertionError(f"chunk {c}: bad output shapes")
        if bool(out[5].any()):
            raise AssertionError(f"chunk {c}: {int(out[5].any(-1).sum())} rows overflowed")
        if c == 0:
            first = (planes, out)
        del planes, out

    planes, k1 = first
    # the sequential pairwise fold through the merge kernel, and the fold kernel
    seq = orswot_ops.fold_merge_sequential(*planes, M, D, impl="unrolled")
    k3 = tile.fold_merge(*planes, M, D, prebiased=True)
    for name, got in (("sequential pairwise fold", seq), ("fold kernel", k3)):
        if bool(got[5].any()):
            raise AssertionError(f"{name} flagged overflow on the first chunk")
        err = max_abs_err(got[:5], k1[:5])
        if err:
            raise AssertionError(f"union-aligned fold != {name} (max diff {err})")
    log(f"  first chunk: union-aligned fold == sequential pairwise fold == fold kernel "
        f"(all {CHUNK} rows, no overflow)")

    # the user entry point: JoinExecutor over eight OrswotBatch fleets (tree, K2)
    fleets = [OrswotBatch(*(x[r] for x in planes)) for r in range(R)]
    joined = JoinExecutor().join_all(fleets)
    sample = torch.from_numpy(np.sort(rng.choice(CHUNK, CHECK_N, replace=False))).to(dev)
    for name, got, want in (("clock", joined.clock, k1[0]), ("ids", joined.ids, k1[1])):
        if not torch.equal(got[sample], want[sample]):
            raise AssertionError(f"JoinExecutor {name} != union-aligned fold on the sample")
    want_sets = OrswotBatch(*(x[sample] for x in k1[:5])).value_sets(uni)
    got_sets = OrswotBatch(*(x[sample] for x in (joined.clock, joined.ids, joined.dots,
                                                  joined.d_ids, joined.d_clocks))).value_sets(uni)
    if got_sets != want_sets:
        raise AssertionError("JoinExecutor value_sets != union-aligned fold on the sample")
    log(f"  JoinExecutor (tree) == union-aligned fold on {CHECK_N} sampled objects "
        "(clock, ids, value_sets)")
    return fold_ms


def regrow_ladder(dev):
    """Four fleets whose objects hold 2 members each, all distinct: the
    join needs 8 member slots and starts at 2, so it regrows twice."""
    from crdt_tpu_torch import CrdtConfig, JoinExecutor, JoinStats, OrswotBatch, Universe

    rng = np.random.RandomState(SEED + 2)
    n, fleets_np = CHECK_N, []
    base = rng.randint(0, 1 << 20, size=n)
    for f in range(4):
        ids = np.stack([base + 2 * f, base + 2 * f + 1], axis=1).astype(np.int32)
        dots = np.zeros((n, 2, A), np.uint32)
        for j in range(2):
            # each fleet writes through its own actors, so no fleet's
            # clock covers another's dots and every member survives
            actor = 16 * f + rng.randint(0, 16, size=n)
            dots[np.arange(n), j, actor] = rng.randint(1, 50, size=n)
        fleets_np.append((dots.max(axis=1), ids, dots, np.full((n, 1), -1, np.int32),
                          np.zeros((n, 1, A), np.uint32)))
    fleets = [OrswotBatch.from_numpy(*p, device=dev) for p in fleets_np]
    stats = JoinStats()
    out = JoinExecutor().join_all(fleets, stats=stats)
    want = [set(int(b) + k for k in range(8)) for b in base]
    if out.value_sets(Universe.identity(CrdtConfig.gpu_default(num_actors=A))) != want:
        raise AssertionError("regrown join lost members")
    return stats


# -- phase 6 -------------------------------------------------------------------


def wire_leg(dev, card: str):
    """Blobs → fold on the card → blobs over the north-star chunks; returns
    the merge kernel's launches by the wire loop and the first chunk's R
    blob lists.

    First each chunk's R fleets are built on the device and encoded by
    ``to_wire`` (the encoder under test), beside the byte oracle:
    ``to_wire`` of the union-aligned fold of the same planes, itself held
    against the scalar engine's fold on a sample and through a
    ``from_wire``/``to_wire`` round trip.  Then the loop folds every
    chunk, two rounds each, in one run per entry of ``WIRE_RUNS``: the
    overlapped and the serial pipeline in the order O S X S O, where X is
    the overlapped pipeline with the codec's team at half the host's
    cores, so that the parse and the encode running at once share the
    cores instead of each taking them all."""
    import os

    import torch

    from crdt_tpu_torch import (
        CrdtConfig, OrswotBatch, PipelinedWireLoop, Universe, WireFormatError, _build,
    )
    from crdt_tpu_torch.batch import wirebulk
    from crdt_tpu_torch.native import engine
    from crdt_tpu_torch.ops import orswot_ops
    from crdt_tpu_torch.utils.serde import from_binary, to_binary
    from crdt_tpu_torch.utils.testdata import build_fleet_planes, fleet_columns

    rng = np.random.RandomState(SEED + 4)
    uni = Universe.identity(CrdtConfig.gpu_default(
        num_actors=A, member_capacity=M, deferred_capacity=D))
    loop = PipelinedWireLoop(uni, device=dev)
    to_wire_s, bytes_in, bytes_out = 0.0, 0, 0
    wirebulk.reset_wire_counts()
    n_max = N_TOTAL // CHUNK
    t_phase = time.perf_counter()
    fleets, oracles = [], []
    while len(fleets) < n_max:
        c = len(fleets)
        cols = fleet_columns(rng, CHUNK, A, M, D, R, base=BASE, novel=NOVEL,
                             deferred_frac=DEFERRED_FRAC)
        planes = build_fleet_planes(cols, a=A, m_cap=M, d=D, base=BASE, novel=NOVEL,
                                    device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep_blobs = [OrswotBatch(*(x[r] for x in planes)).to_wire(uni) for r in range(R)]
        to_wire_s += time.perf_counter() - t0
        bytes_in += sum(len(b) for blobs in rep_blobs for b in blobs)
        # the byte oracle: the union-aligned fold of the same planes
        k1 = orswot_ops.fold_merge(*planes, M, D, impl="pallas", u_cap=U_CAP)
        if bool(k1[5].any()):
            raise AssertionError(f"chunk {c}: the union-aligned fold overflowed")
        want = OrswotBatch(*k1[:5]).to_wire(uni)
        del k1, planes
        bytes_out += sum(len(b) for b in want)
        # the scalar engine's fold on a sample
        for i in rng.choice(CHUNK, WIRE_SAMPLE, replace=False).tolist():
            acc = from_binary(rep_blobs[0][i])
            for r in range(1, R):
                acc.merge(from_binary(rep_blobs[r][i]))
            acc.merge(acc.clone())
            if to_binary(acc) != want[i]:
                raise AssertionError(f"chunk {c}: object {i}: the scalar fold != "
                                     "to_wire(union-aligned fold)")
        # round trip through the codec, plane for plane
        x = OrswotBatch.from_wire(want, uni, device=dev, via_device=False)
        y = OrswotBatch.from_wire(x.to_wire(uni), uni, device=dev, via_device=False)
        same_planes(y, x, f"chunk {c}: from_wire(to_wire(x)) against x")
        del x, y
        torch.cuda.empty_cache()
        fleets.append(rep_blobs)
        oracles.append(want)
        if len(fleets) >= WIRE_MIN_CHUNKS and time.perf_counter() - t_phase > WIRE_PREP_S:
            break
    chunks = len(fleets)
    log(f"  {chunks} chunks encoded and their oracles checked in "
        f"{time.perf_counter() - t_phase:.1f} s")

    profile_loop(loop, fleets[0], card)  # also sizes the loop's buffers
    rounds = [rep_blobs for rep_blobs in fleets for _ in range(WIRE_ROUNDS)]
    want = [out for out in oracles for _ in range(WIRE_ROUNDS)]
    half = max(1, len(os.sched_getaffinity(0)) // 2)
    stages = ("parse", "h2d", "fold", "stall", "d2h", "encode")
    sums: dict = {}
    k2_launches = 0
    for label, overlap, threads in WIRE_RUNS:
        threads = half if threads == "half" else 0
        engine.set_threads(threads)
        before = _build.launch_counts()["orswot_merge"]
        try:
            res = loop.run(rounds, overlap=overlap)
        finally:
            engine.set_threads(0)
        k2 = _build.launch_counts()["orswot_merge"] - before
        if k2 < R * len(rounds):
            raise AssertionError(f"wire loop launched the merge kernel {k2} times, "
                                 f"< R={R} per round")
        k2_launches += k2
        for f in ("ingest_native_fraction", "egress_native_fraction"):
            if res[f] != 1.0:
                raise AssertionError(f"wire loop {f} = {res[f]} ({res['wire_counters']})")
        if res["fold_path"] != "k2" or res["merges"] != CHUNK * R * len(rounds):
            raise AssertionError(f"wire loop: {res['fold_path']}, {res['merges']} merges")
        for k, (got, exp) in enumerate(zip(res["out_blobs"], want)):
            if got != exp:
                raise AssertionError(f"{label} run, round {k}: wire loop != "
                                     "to_wire(union-aligned fold)")
        per = sums.setdefault(label, dict.fromkeys(stages + ("e2e",), 0.0))
        for k in stages:
            per[k] += res["stage_s"][k]
        per["e2e"] += res["e2e_s"]
        per["runs"] = per.get("runs", 0) + 1
        log(f"  {label} run ({len(rounds)} rounds, codec team "
            f"{threads or 'all cores'}): e2e {res['e2e_s']:.4f} s [{card}]")
        del res
    counts = wirebulk.wire_counts()
    for direction, c in counts.items():
        if c["fallback"] or not c["native"]:
            raise AssertionError(f"{direction}: not every blob took the host codec ({c})")
    blob = OrswotBatch.zeros(1, uni, device=dev).to_wire(uni)[0]
    try:
        OrswotBatch.from_wire([blob[:-1]], uni, device=dev)
    except WireFormatError as e:
        log(f"  truncated blob: WireFormatError ({e})")
    else:
        raise AssertionError("a truncated blob did not raise WireFormatError")

    objects = chunks * CHUNK
    log(f"  {chunks} chunks of {CHUNK} objects, R={R}: every check passed (every run's "
        f"blobs == to_wire(union-aligned fold) == the scalar fold on {WIRE_SAMPLE} sampled "
        f"objects per chunk, from_wire(to_wire(x)) == x, native fraction 1.0 both ways: "
        f"{counts})")
    log(f"  wire bytes per object: {bytes_in / (objects * R):.1f} in (per replica), "
        f"{bytes_out / objects:.1f} out; to_wire of the R input fleets "
        f"{to_wire_s / chunks:.4f} s per chunk [{card}]")
    log(f"  host cores: {os.cpu_count()} online, {len(os.sched_getaffinity(0))} in this "
        f"process's affinity; split team {half}")
    for label, per in sums.items():
        n_rounds = per.pop("runs") * len(rounds)
        per = {k: v / n_rounds for k, v in per.items()}
        log(f"  loop {label}: per round of a chunk (mean of {n_rounds} rounds) "
            + ", ".join(f"{k} {v:.4f} s" for k, v in per.items())
            + f"; {CHUNK * R / per['e2e'] / 1e6:.3f}M merges/s end to end [{card}]")
    return k2_launches, fleets[0]


def profile_loop(loop, rep_blobs, card: str):
    """One more run of the loop under ``torch.profiler``: the device time of
    its kernels and of its copies against the run's wall time."""
    profiled(lambda: loop.run([rep_blobs] * WIRE_ROUNDS, overlap=True),
             f"{WIRE_ROUNDS} rounds of one chunk, overlapped", card)


def profiled(run, label: str, card: str):
    """``run()`` under ``torch.profiler``: the device time of its kernels
    and of its copies against its wall time.  A measurement only: a
    profiler that sees no device time is logged, not fatal."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a host op (aten::copy_) also reports the
    # device time of the copy it started
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    copies = sum(t for k, t, _ in rows if "memcpy" in k.lower() or "memset" in k.lower())
    kernels = sum(t for _, t, _ in rows) - copies
    if not rows:
        log("  profiler: no device time recorded (not measured)")
        return
    log(f"  profiler ({label}): wall {wall:.4f} s, device "
        f"kernels {kernels / 1e6:.4f} s ({kernels / 1e6 / wall:.2%} of wall), copies "
        f"{copies / 1e6:.4f} s ({copies / 1e6 / wall:.2%}); SMs idle "
        f"{1 - kernels / 1e6 / wall:.2%} of the wall time [{card}]")
    for key, t, count in rows[:8]:
        log(f"    {t / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


# -- phase 6b ------------------------------------------------------------------


def wire_routes(dev, card: str, rep_blobs):
    """``from_wire`` and ``to_scalar`` by both routes on one chunk of the
    wire leg's fleets: dense planes copied whole, or COO columns that the
    card expands (``via_device=True``, the JAX package's route on an
    accelerator) and compacts."""
    import torch

    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
    from crdt_tpu_torch.dtypes import h2d_bytes
    from crdt_tpu_torch.utils.serde import to_binary

    uni = Universe.identity(CrdtConfig.gpu_default(
        num_actors=A, member_capacity=M, deferred_capacity=D))
    blobs = rep_blobs[0]  # replica 0 holds the planted deferred rows
    batches = {}
    for via in (False, True):
        torch.cuda.synchronize()
        b0, t0 = h2d_bytes(), time.perf_counter()
        batches[via] = OrswotBatch.from_wire(blobs, uni, device=dev, via_device=via)
        torch.cuda.synchronize()
        log(f"  from_wire(via_device={via}): {time.perf_counter() - t0:.4f} s, "
            f"{h2d_bytes() - b0} B host->device for {len(blobs)} objects "
            f"({sum(len(b) for b in blobs)} B of blobs) [{card}]")
    for via, batch in batches.items():
        if batch.to_wire(uni) != blobs:
            raise AssertionError(f"to_wire(from_wire(blobs, via_device={via})) != blobs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = batch.to_scalar(uni, via_device=via)
        log(f"  to_scalar(via_device={via}): {time.perf_counter() - t0:.4f} s [{card}]")
        if [to_binary(x) for x in states] != blobs:
            raise AssertionError(f"to_binary(to_scalar(via_device={via})) != blobs")
    # replica 1 has no deferred rows, so its states are fixpoints of the
    # merge and the self-merge only puts member slots in ascending-id order
    dense = OrswotBatch.from_wire(rep_blobs[1], uni, device=dev, via_device=False)
    coo = OrswotBatch.from_wire(rep_blobs[1], uni, device=dev, via_device=True)
    same_planes(coo, dense.merge(dense), "from_wire(via_device=True) against the dense "
                "route's self-merge")
    log(f"  both routes: to_wire byte-equal to the blobs, to_scalar equal to them too; the "
        f"COO route's planes == the dense route's K2 self-merge ({CHUNK} objects)")


# -- phase 7 -------------------------------------------------------------------


def op_traffic(fleet, rng):
    """``OP_FRAMES`` frames of ``OP_FRAME_OPS`` ops against ``fleet``,
    minted in causal order: ~90% adds (objects and actors uniform, 70% of
    members already present; dots from ``derive_add_ctx``), ~10% removes
    of a live member (``derive_rm_ctx``, 2% one dot ahead) on objects with
    no deferred row, 5% of those objects removed twice (a second round;
    deferral stays within D=2).  Returns ``(frames, [(adds, removes)])``;
    frame ``OP_SWAP + 1`` is delivered before its predecessor."""
    from crdt_tpu_torch.dtypes import as_counters
    from crdt_tpu_torch.oplog import OpBatch, derive_add_ctx, derive_rm_ctx, encode_ops_frame

    n, clock = fleet.clock.shape[0], fleet.clock.clone()
    ids = fleet.ids.cpu().numpy()  # canonical: live slots first
    live = (ids != -1).sum(axis=1)
    free = (fleet.d_ids == -1).all(dim=1).cpu().numpy() & (live >= 2)
    pool = rng.permutation(np.nonzero(free)[0])
    n_rm = OP_FRAME_OPS // 10
    n_add, n_twice = OP_FRAME_OPS - n_rm, n_rm // 20
    n_once = n_rm - n_twice
    frames, causal = [], []
    for f in range(OP_FRAMES):
        obj, actor = rng.randint(0, n, n_add), rng.randint(0, A, n_add)
        known = (rng.rand(n_add) < 0.7) & (live[obj] > 0)
        slot = (rng.rand(n_add) * live[obj]).astype(np.int64)
        member = np.where(known, ids[obj, slot], rng.randint(1 << 24, (1 << 24) + (1 << 20), n_add))
        adds, _ = derive_add_ctx(clock, obj, actor, member=member)
        clock.view(-1).scatter_reduce_(0, rows_of(adds.obj * A + adds.actor, clock.device),
                                       as_counters(adds.counter, clock.dtype, clock.device), "amax")
        robj = pool[f * n_once:(f + 1) * n_once]
        robj = np.concatenate([robj, robj[:n_twice]])
        j = (rng.rand(robj.shape[0]) * live[robj]).astype(np.int64)
        j[n_once:] = (j[:n_twice] + 1) % live[robj[:n_twice]]  # another member
        rms = derive_rm_ctx(clock, robj, ids[robj, j])
        ahead = np.nonzero(rng.rand(robj.shape[0]) < 0.02)[0]
        rms.rm_clocks[ahead, rng.randint(0, A, ahead.shape[0])] += 1
        causal.append((adds, rms))
        frames.append(encode_ops_frame(OpBatch.concat([adds, rms])))
    frames[OP_SWAP], frames[OP_SWAP + 1] = frames[OP_SWAP + 1], frames[OP_SWAP]
    return frames, causal


def scalar_oracle(fleet, causal, sample, uni):
    """The sampled objects' states by the port's scalar engine: their
    initial states, then each op on them, one at a time, in causal order."""
    from crdt_tpu_torch import OrswotBatch
    from crdt_tpu_torch.scalar.orswot import Add, Rm
    from crdt_tpu_torch.scalar.vclock import Dot, VClock

    rows = rows_of(sample, fleet.device)
    states = OrswotBatch(*(getattr(fleet, k)[rows] for k in PLANES)).to_scalar(uni)
    where = {int(o): k for k, o in enumerate(sample)}
    for adds, rms in causal:
        for r in np.nonzero(np.isin(adds.obj, sample))[0].tolist():
            dot = Dot(int(adds.actor[r]), int(adds.counter[r]))
            states[where[int(adds.obj[r])]].apply(Add(dot=dot, member=int(adds.member[r])))
        for r in np.nonzero(np.isin(rms.obj, sample))[0].tolist():
            clock = VClock({a: int(v) for a, v in enumerate(rms.rm_clocks[r]) if v})
            states[where[int(rms.obj[r])]].apply(Rm(clock=clock, member=int(rms.member[r])))
    return states


def check_self_merge(src, out, what: str):
    """``out = src.merge(src)``, the merge kernel's full-size output,
    against the plain merge of the same rows, ``CHUNK`` objects at a time
    (the merge is row-independent); any difference fails."""
    from crdt_tpu_torch.ops import orswot_tile as tile

    n = src.clock.shape[0]
    for s in range(0, n, CHUNK):
        rows = tuple(getattr(src, k)[s:s + CHUNK] for k in PLANES)
        want = tile.merge_reference(*rows, *rows, M, D)
        got = tuple(getattr(out, k)[s:s + CHUNK] for k in PLANES)
        if bool(want[5].any()) or max_abs_err(got, want[:5]):
            raise AssertionError(f"{what}: the merge kernel != its plain version at objects {s}+")
    log(f"  {what}: the merge kernel's [{n}, ...] output == its plain version, bit for bit")


def op_bodies(fleet, causal, card: str):
    """Device times (CUDA events) of the op path's plain-torch bodies on
    frame 0's ops at the fleet's size, beside their bytes bound."""
    import torch

    from crdt_tpu_torch.dtypes import as_counters, zero_of
    from crdt_tpu_torch.ops import orswot_ops
    from crdt_tpu_torch.oplog.apply import _scatter_max
    from crdt_tpu_torch.oplog.records import _derive_body

    dev, dt = fleet.device, fleet.clock.dtype
    (adds, rms), planes = causal[0], tuple(getattr(fleet, k) for k in PLANES)
    obj, actor, cnt = rows_of(adds.obj, dev), rows_of(adds.actor, dev), as_counters(adds.counter, dt, dev)
    member = torch.full((fleet.clock.shape[0],), -2, dtype=torch.int32, device=dev)
    member[rows_of(rms.obj, dev)] = torch.from_numpy(rms.member).to(dev)
    rm_clock = torch.full_like(fleet.clock, zero_of(dt))
    rm_clock[rows_of(rms.obj, dev)] = as_counters(rms.rm_clocks, dt, dev)
    rest = nbytes(planes[1:])  # the planes a whole-fleet body reads and writes
    for name, fn, moved in (
        ("derive_add_ctx (sort, [B, A] cumsum, gathers)",
         lambda: _derive_body(fleet.clock, obj, actor), obj.numel() * (16 + 8 * A)),
        ("scatter-max of the adds (clock, dots; slot 0)",
         lambda: (_scatter_max(fleet.clock, obj * A + actor, cnt),
                  _scatter_max(fleet.dots, obj * (M * A) + actor, cnt)),
         2 * nbytes((fleet.clock, fleet.dots))),
        ("deferred replay (_apply_deferred, whole fleet)",
         lambda: orswot_ops._apply_deferred(*planes), nbytes(planes) + rest),
        ("remove round (apply_remove, whole fleet)",
         lambda: orswot_ops.apply_remove(*planes, rm_clock, member),
         nbytes(planes) + rest + nbytes((rm_clock, member))),
    ):
        ms = cuda_ms(fn, 5)
        log(f"  {name}: {ms:.3f} ms, bound {moved / HBM_BYTES_PER_S * 1e3:.3f} ms "
            f"(bytes, {moved} B) [{card}]")


def op_path(dev, card: str):
    """The op-based write path at full width: op frames folded into a
    1.25M-object fleet through ``PipelinedOpLoop`` (O S S O from the same
    fleet), one profiled run, re-delivery, the scalar engine on a sample,
    a ``to_coo``/``from_coo`` round trip, and both self-merges against
    the plain merge.  Returns the merge kernel's launches of the phase."""
    import torch

    from crdt_tpu_torch import CrdtConfig, OrswotBatch, PipelinedOpLoop, Universe, _build
    from crdt_tpu_torch.utils.serde import to_binary
    from crdt_tpu_torch.utils.testdata import build_fleet_planes, fleet_columns

    rng = np.random.RandomState(SEED + 7)
    uni = Universe.identity(CrdtConfig.gpu_default(
        num_actors=A, member_capacity=M, deferred_capacity=D))
    t0 = time.perf_counter()
    cols = fleet_columns(rng, N_TOTAL, A, M, D, 1, base=BASE, novel=NOVEL,
                         deferred_frac=DEFERRED_FRAC)
    built = OrswotBatch(*(x[0] for x in build_fleet_planes(
        cols, a=A, m_cap=M, d=D, base=BASE, novel=NOVEL, device=dev)))
    fleet = built.merge(built)  # canonical: ascending-id slots, deferred replayed
    if _build.launch_counts()["orswot_merge"] == 0:
        raise AssertionError("the fleet's self-merge did not launch the merge kernel")
    torch.cuda.synchronize()
    log(f"  fleet: {N_TOTAL} objects, {nbytes([getattr(fleet, k) for k in PLANES]) / 1e9:.3f} GB "
        f"of planes on the card, built and self-merged in {time.perf_counter() - t0:.1f} s")
    check_self_merge(built, fleet, "the fleet's self-merge")
    del built
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    frames, causal = op_traffic(fleet, rng)
    n_ops = sum(len(a) + len(r) for a, r in causal)
    log(f"  traffic: {len(frames)} frames, {n_ops} ops ({sum(len(r) for _, r in causal)} "
        f"removes), {sum(map(len, frames)) / n_ops:.2f} wire B/op, frame {OP_SWAP + 1} "
        f"before frame {OP_SWAP}; minted and encoded in {time.perf_counter() - t0:.1f} s")

    final = None
    for overlap in (True, False, False, True):  # each mode both before and after the other
        loop = PipelinedOpLoop(uni)
        torch.cuda.reset_peak_memory_stats()
        out, st = loop.run(fleet, frames, overlap=overlap)
        c = loop.applier.counts
        log(f"  {st['pipeline']} run: {n_ops / st['e2e_s'] / 1e6:.3f}M ops/s end to end; {st}; "
            f"applier {c}, {c['rm_rounds'] / len(frames):.2f} remove rounds per frame; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
        if st["applied"] != n_ops or st["still_parked"] or not 0 < c["parked"] == c["released"]:
            raise AssertionError(f"op loop counts: {st}, {c}")
        final = out if final is None else final
        same_planes(out, final, f"{st['pipeline']} run against the first run")
        del out
    profiled(lambda: PipelinedOpLoop(uni).run(fleet, frames, overlap=True),
             f"{len(frames)} op frames, overlapped", card)
    again, st = PipelinedOpLoop(uni).run(final, frames)
    same_planes(again, final, "re-delivering every frame")
    if st["duplicates"] != sum(len(a) for a, _ in causal) or st["still_parked"]:
        raise AssertionError(f"re-delivery applied adds again: {st}")
    del again
    log(f"  re-delivery of every frame: planes unchanged ({st['duplicates']} duplicate adds)")

    touched = np.unique(np.concatenate([a.obj for a, _ in causal] + [r.obj for _, r in causal]))
    sample = np.sort(rng.choice(touched, OP_SAMPLE, replace=False))
    want = [to_binary(s) for s in scalar_oracle(fleet, causal, sample, uni)]
    rows = rows_of(sample, dev)
    got = OrswotBatch(*(getattr(final, k)[rows] for k in PLANES)).to_scalar(uni)
    if [to_binary(s) for s in got] != want:
        raise AssertionError("op loop != the scalar engine on the sampled objects")
    log(f"  {OP_SAMPLE} sampled touched objects == the scalar engine applying the same ops "
        "in causal order")

    canon = final.merge(final)
    check_self_merge(final, canon, "the final fleet's self-merge")
    del final
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clock, dots, q, h = canon.to_coo()
    t1 = time.perf_counter()
    back = OrswotBatch.from_coo(N_TOTAL, uni, clock_coords=clock, dot_coords=dots,
                                deferred_members=q, deferred_coords=h, device=dev)
    torch.cuda.synchronize()
    same_planes(back, canon, "from_coo(to_coo(x)) against x")
    log(f"  to_coo -> from_coo of the self-merged final fleet: bit-equal; to_coo "
        f"{t1 - t0:.4f} s, from_coo {time.perf_counter() - t1:.4f} s ({len(dots[0])} dot cells) "
        f"[{card}]")
    del back, canon
    op_bodies(fleet, causal, card)
    return _build.launch_counts()["orswot_merge"]


# -- phase 8 -------------------------------------------------------------------


def flat_planes(b):
    """The tensors of a flat batch, in field order."""
    import dataclasses

    return tuple(getattr(b, f.name) for f in dataclasses.fields(b))


def flat_rows(b, rows):
    return type(b)(*(x[rows] for x in flat_planes(b)))


def left_fold(reps):
    acc = reps[0]
    for b in reps[1:]:
        acc = acc.merge(b)
    return acc


def same_flat(got, want, what: str):
    import torch

    for g, w in zip(flat_planes(got), flat_planes(want)):
        if not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{what}: planes differ")


def flat_fleets(dev):
    """Seeded replica fleets, generated on the card (``bench.py``'s dense
    clocks: counters uniform in [0, 1000)), one type at a time."""
    import torch

    from crdt_tpu_torch import (
        GCounterBatch, GSetBatch, LWWRegBatch, MVRegBatch, PNCounterBatch, VClockBatch,
    )
    from crdt_tpu_torch.dtypes import ZERO64

    gen = torch.Generator(device=dev)

    def ints(shape, hi, seed):
        gen.manual_seed(seed)
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int64)

    def clocks(shape, seed):
        return ints(shape, 1000, seed) ^ ZERO64

    def mvreg(r):
        base = ints((FLAT_MV_N, 1, FLAT_A), 1000, SEED + 80)
        c = (base + ints((FLAT_MV_N, FLAT_K, FLAT_A), 3, SEED + 81 + r)) ^ ZERO64
        live = torch.arange(FLAT_K, device=dev) < 1 + ints((FLAT_MV_N, 1), 2, SEED + 90 + r)
        c = torch.where(live[..., None], c, ZERO64)
        return MVRegBatch(c, torch.where(live, 1 + ints((FLAT_MV_N, FLAT_K), 1 << 30, SEED + 95 + r), 0))

    def gset(r):
        gen.manual_seed(SEED + 70 + r)
        return GSetBatch(torch.rand((FLAT_N, FLAT_U), generator=gen, device=dev) < 0.05)

    def lww(r):
        return LWWRegBatch(ints((FLAT_LWW_N,), 1 << 31, SEED + 50 + r),
                           (ints((FLAT_LWW_N,), 1 << 40, SEED + 60 + r) * 8 + r) ^ ZERO64)

    # name: (class, replica r -> batch, replicas, replicas in the wire round,
    # from_wire's extra arguments, actors)
    return {
        "gcounter_2x4": (GCounterBatch, lambda r: GCounterBatch(clocks((1, 4), SEED + 10 + r)),
                         2, 2, (), 4),
        "vclock_1k": (VClockBatch, lambda r: VClockBatch(clocks((1000, FLAT_A), SEED + 20 + r)),
                      8, 8, (), FLAT_A),
        "vclock_1m": (VClockBatch, lambda r: VClockBatch(clocks((FLAT_N, FLAT_A), SEED + 30 + r)),
                      8, FLAT_WIRE_R, (), FLAT_A),
        "pncounter_1m": (PNCounterBatch,
                         lambda r: PNCounterBatch(clocks((FLAT_N, 2, FLAT_PN_A), SEED + 40 + r)),
                         8, FLAT_WIRE_R, (), FLAT_PN_A),
        "lwwreg_10m": (LWWRegBatch, lww, 8, FLAT_WIRE_R, (), FLAT_A),
        "gset_1m": (GSetBatch, gset, 8, FLAT_WIRE_R, (FLAT_U,), FLAT_A),
        "mvreg_250k": (MVRegBatch, mvreg, 4, FLAT_WIRE_R, (), FLAT_A),
    }


def flat_sample_check(reps, fold, uni, what: str, sample: int):
    """``sample`` objects of the device fold against the port's scalar
    engine folding the same states (``to_binary`` bytes equal)."""
    from crdt_tpu_torch.utils.serde import to_binary

    n = flat_planes(fold)[0].shape[0]
    rows = rows_of(np.random.RandomState(SEED + 5).choice(n, min(n, sample), replace=False),
                   flat_planes(fold)[0].device)
    acc = flat_rows(reps[0], rows).to_scalar(uni)
    for b in reps[1:]:
        for s, o in zip(acc, flat_rows(b, rows).to_scalar(uni)):
            s.merge(o)
    got = flat_rows(fold, rows).to_scalar(uni)
    if [to_binary(s) for s in got] != [to_binary(s) for s in acc]:
        raise AssertionError(f"{what}: the device fold != the scalar engine's on the sample")


def flat_wire_round(cls, reps, extra, uni, leg: str, what: str):
    """``to_wire`` of every replica, then ``from_wire`` → fold → ``to_wire``:
    byte-equal to ``to_wire`` of the device fold; native fractions; a
    truncated blob raises.  Returns the round's numbers."""
    import torch

    from crdt_tpu_torch import WireFormatError
    from crdt_tpu_torch.batch import wirebulk

    dev = flat_planes(reps[0])[0].device
    before = wirebulk.wire_counts(leg)
    t0 = time.perf_counter()
    blobs = [b.to_wire(uni) for b in reps]
    t1 = time.perf_counter()
    parsed = [cls.from_wire(bl, uni, *extra, device=dev) for bl in blobs]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = left_fold(parsed).to_wire(uni)
    t3 = time.perf_counter()
    if out != left_fold(reps).to_wire(uni):
        raise AssertionError(f"{what}: the wire round's blobs != to_wire of the device fold")
    grew = wirebulk.counts_since(before, leg)
    frac = {d: wirebulk.native_fraction(grew, d) for d in ("from_wire", "to_wire")}
    if frac != {"from_wire": 1.0, "to_wire": 1.0}:
        raise AssertionError(f"{what}: not every blob took the host codec ({grew})")
    try:
        cls.from_wire([blobs[0][0][:-1]], uni, *extra, device=dev)
    except WireFormatError:
        pass
    else:
        raise AssertionError(f"{what}: a truncated blob did not raise WireFormatError")
    n = len(blobs[0])
    return {"wire_replicas": len(reps), "wire_objects": n, "encode_s": t1 - t0,
            "parse_s": t2 - t1,
            "fold_encode_s": t3 - t2, "wire_bytes_per_object": sum(map(len, blobs[0])) / n,
            "native_fraction": frac}


def flat_fold(name, cls, reps, wire_r, extra, uni, card: str):
    """Fold the replicas through the batch ``merge`` (timed), check the
    fold on a sample against the scalar engine and in full against the
    same merges on the CPU, and run a wire round."""
    import torch

    n = flat_planes(reps[0])[0].shape[0]
    t0 = time.perf_counter()
    fold = left_fold(reps)
    ms = cuda_ms(lambda: left_fold(reps), FLAT_ITERS)
    t1 = time.perf_counter()
    # one merge reads two states and writes one (plus its conflict or
    # overflow flags); MVReg's dominance tests compare [n, K, K, A]
    # counters twice (an int64 compare counted as 2 INT32 operations)
    state = nbytes(flat_planes(reps[0]))
    flags = n if cls.__name__ in ("LWWRegBatch", "MVRegBatch") else 0
    ops = 4 * n * FLAT_K * FLAT_K * FLAT_A if cls.__name__ == "MVRegBatch" else 0
    b_ms, b_by = bound_ms(2 * state, state + flags, ops)
    merge_ms = ms / (len(reps) - 1)
    mv = cls.__name__ == "MVRegBatch"
    k = min(n, FLAT_MVREG_CPU) if mv else n
    sample = min(n, FLAT_MVREG_SAMPLE if mv else FLAT_SAMPLE)
    cpu = left_fold([cls(*(x[:k].cpu() for x in flat_planes(b))) for b in reps])
    same_flat(flat_rows(fold, slice(0, k)), cpu,
              f"{name}: the device fold against the CPU plain path")
    t2 = time.perf_counter()
    flat_sample_check(reps, fold, uni, name, sample)
    t3 = time.perf_counter()
    leg = {"GCounterBatch": "gcounter", "VClockBatch": "vclock", "PNCounterBatch": "pncounter",
           "LWWRegBatch": "lww", "GSetBatch": "gset", "MVRegBatch": "mvreg"}[cls.__name__]
    wire = flat_wire_round(cls, [flat_rows(b, slice(0, FLAT_WIRE_N)) for b in reps[:wire_r]],
                           extra, uni, leg, name)
    row = {"objects": n, "replicas": len(reps), "fold_ms": ms, "merge_ms": merge_ms,
           "merges_per_s": n * len(reps) / (ms / 1e3), "bound_ms_per_merge": b_ms,
           "bound_by": b_by, "share_of_bound": b_ms / merge_ms, "state_bytes": state,
           "cpu_checked": k, "sampled": sample, **wire,
           "phase_s": {"fold_timing": t1 - t0, "cpu_check": t2 - t1, "sample_check": t3 - t2,
                       "wire_round_and_checks": time.perf_counter() - t3}}
    log(f"  {name}: {n} objects x {len(reps)} replicas, fold {ms:.4f} ms ({merge_ms:.4f} ms per "
        f"merge, bound {b_ms:.4f} ms by {b_by}, {row['merges_per_s'] / 1e6:.2f}M merges/s); "
        f"device == CPU plain path on {k}, {sample} sampled == scalar engine; wire round "
        f"({wire['wire_replicas']} replicas of {wire['wire_objects']} objects): encode "
        f"{wire['encode_s']:.3f} s, parse "
        f"{wire['parse_s']:.3f} s, fold+encode {wire['fold_encode_s']:.3f} s, "
        f"{wire['wire_bytes_per_object']:.1f} B/object, codec share 1.0 [{card}]")
    del cpu
    torch.cuda.synchronize()
    return fold, row


def flat_op_traffic(fleet, kind: str, rng):
    """``FLAT_FRAMES`` frames of ``FLAT_FRAME_OPS`` ops, objects and actors
    uniform: ``inc`` dots (``dec`` too for PNCounter) carrying each
    actor's running total, or LWW ``set``s with unique markers above
    every register's."""
    from crdt_tpu_torch.dtypes import counters_to_numpy
    from crdt_tpu_torch.oplog import OP_DEC, OP_INC, OP_SET, OpBatch

    total = FLAT_FRAMES * FLAT_FRAME_OPS
    if kind == "lww":
        n = fleet.vals.shape[0]
        obj = rng.randint(0, n, size=total)
        top = int(counters_to_numpy(fleet.markers.max()))
        marker = np.uint64(top + 1) + rng.permutation(total).astype(np.uint64)
        cols = (np.full(total, OP_SET), obj, np.zeros(total), marker,
                rng.randint(0, 1 << 31, size=total))
    else:
        plane = fleet.planes if kind == "pncounter" else fleet.clocks[:, None]
        n, p, a = plane.shape
        obj, actor = rng.randint(0, n, size=total), rng.randint(0, a, size=total)
        dec = rng.rand(total) < 0.5 if p == 2 else np.zeros(total, bool)
        key = (obj * p + dec) * a + actor
        order = np.argsort(key, kind="stable")
        rank = np.empty(total, np.uint64)
        rank[order] = np.arange(total) - np.searchsorted(key[order], key[order])
        base = counters_to_numpy(plane.reshape(-1)[rows_of(key, plane.device)])
        cols = (np.where(dec, OP_DEC, OP_INC), obj, actor, base + rank + np.uint64(1),
                np.full(total, -1))
    ops = OpBatch(*(np.asarray(c, dt) for c, dt in zip(
        cols, (np.uint8, np.int64, np.int32, np.uint64, np.int32))))
    return [ops.select(np.arange(f * FLAT_FRAME_OPS, (f + 1) * FLAT_FRAME_OPS))
            for f in range(FLAT_FRAMES)]


def flat_op_fold(kind, fleet, uni, card: str):
    """The op frames through ``encode_ops_frame``/``decode_ops_frame`` into
    ``fleet``, frame 11 before frame 10, then every frame again: the
    re-delivery changes nothing, and a sample equals the scalar engine
    witnessing the same ops.  LWW also folds a frame of planted
    equal-marker conflicts."""
    import torch

    from crdt_tpu_torch import ConflictingMarker
    from crdt_tpu_torch.oplog import (
        OP_DEC, OpBatch, apply_gcounter_ops, apply_lww_ops, apply_pncounter_ops,
        decode_ops_frame, encode_ops_frame,
    )
    from crdt_tpu_torch.scalar import Dir, Dot, PNOp
    from crdt_tpu_torch.utils.serde import to_binary

    apply = {"gcounter": apply_gcounter_ops, "pncounter": apply_pncounter_ops,
             "lww": apply_lww_ops}[kind]
    a = flat_planes(fleet)[0].shape[-1] if kind != "lww" else 1
    rng = np.random.RandomState(SEED + 7)
    t_traffic = time.perf_counter()
    frames = [encode_ops_frame(ops) for ops in flat_op_traffic(fleet, kind, rng)]
    t_traffic = time.perf_counter() - t_traffic
    order = list(range(FLAT_FRAMES))
    order[OP_SWAP], order[OP_SWAP + 1] = order[OP_SWAP + 1], order[OP_SWAP]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fleet
    for f in order:
        out = apply(out, decode_ops_frame(frames[f], num_actors=a))
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    again = out
    for f in order:
        again = apply(again, decode_ops_frame(frames[f], num_actors=a))
    same_flat(again, out, f"{kind} ops: the second delivery")
    n = flat_planes(fleet)[0].shape[0]
    sample = np.random.RandomState(SEED + 8).choice(n, FLAT_SAMPLE, replace=False)
    rows = rows_of(sample, flat_planes(fleet)[0].device)
    states = flat_rows(fleet, rows).to_scalar(uni)
    where = {int(o): k for k, o in enumerate(sample)}
    for f in order:
        ops = decode_ops_frame(frames[f], num_actors=a)
        for r in np.nonzero(np.isin(ops.obj, sample))[0].tolist():
            s, c = states[where[int(ops.obj[r])]], int(ops.counter[r])
            if kind == "lww":
                s.update(int(ops.member[r]), c)
            elif kind == "gcounter":
                s.apply(Dot(int(ops.actor[r]), c))
            else:
                s.apply(PNOp(Dot(int(ops.actor[r]), c),
                             Dir.NEG if ops.kind[r] == OP_DEC else Dir.POS))
    got = flat_rows(out, rows).to_scalar(uni)
    if [to_binary(s) for s in got] != [to_binary(s) for s in states]:
        raise AssertionError(f"{kind} ops: the fold != the scalar engine on the sample")
    row = {"ops": FLAT_FRAMES * FLAT_FRAME_OPS, "frames": FLAT_FRAMES, "e2e_s": e2e,
           "traffic_s": t_traffic,
           "ops_per_s": FLAT_FRAMES * FLAT_FRAME_OPS / e2e,
           "wire_bytes_per_op": sum(map(len, frames)) / (FLAT_FRAMES * FLAT_FRAME_OPS)}
    if kind == "lww":
        planted = rng.choice(n, 96, replace=False)
        ops = decode_ops_frame(frames[0])
        top = int(ops.counter.max()) + 10
        clash = OpBatch.concat([ops, OpBatch(
            np.full(192, ops.kind[0], np.uint8), np.repeat(planted, 2), np.zeros(192, np.int32),
            np.repeat(np.arange(96, dtype=np.uint64) + np.uint64(top), 2),
            np.tile(np.array([1, 2], np.int32), 96))])
        try:
            apply_lww_ops(out, clash)
        except ConflictingMarker:
            pass
        else:
            raise AssertionError("lww ops: planted conflicts did not raise ConflictingMarker")
        _, bitmap = apply_lww_ops(out, clash, check=False)
        if set(np.nonzero(bitmap)[0].tolist()) != set(planted.tolist()):
            raise AssertionError("lww ops: the conflict bitmap != the planted set")
        row["planted_conflicts"] = 96
    log(f"  {kind} ops: {row['ops']} ops in {FLAT_FRAMES} frames into {n} objects, "
        f"{e2e:.4f} s ({row['ops_per_s'] / 1e6:.3f}M ops/s, {row['wire_bytes_per_op']:.2f} wire "
        f"B/op); re-delivery unchanged; {FLAT_SAMPLE} sampled == scalar engine [{card}]")
    return row


def flat_types(dev, card: str):
    """Phase 8: the flat types at BASELINE.md's sizes (u64)."""
    import torch

    from crdt_tpu_torch import CrdtConfig, GCounterBatch, Universe

    cfgs = {a: Universe.identity(CrdtConfig(num_actors=a, mv_capacity=FLAT_K)) for a in
            (4, FLAT_PN_A, FLAT_A)}
    report = {"card": card}
    folds = {}
    t0 = time.perf_counter()
    for name, (cls, make, r, wire_r, extra, a) in flat_fleets(dev).items():
        reps = [make(i) for i in range(r)]
        folds[name], report[name] = flat_fold(name, cls, reps, wire_r, extra, cfgs[a], card)
        if name == "gcounter_2x4":
            log(f"  gcounter_2x4 value {folds[name].value().tolist()} (the scalar engine's: "
                f"{[s.value() for s in folds[name].to_scalar(cfgs[a])]})")
        del reps
        torch.cuda.empty_cache()
    gcount = GCounterBatch(folds["vclock_1m"].clocks)
    for kind, fleet, uni in (("gcounter", gcount, cfgs[FLAT_A]),
                             ("pncounter", folds["pncounter_1m"], cfgs[FLAT_PN_A]),
                             ("lww", folds["lwwreg_10m"], cfgs[FLAT_A])):
        report[f"{kind}_ops"] = flat_op_fold(kind, fleet, uni, card)
    report["phase_s"] = time.perf_counter() - t0
    print("flat_types " + json.dumps(report), flush=True)


# -- phase 9 -------------------------------------------------------------------


def map_rows(b, rows):
    """Rows ``rows`` of a MapBatch (an index tensor or a slice)."""
    from crdt_tpu_torch.batch.map_batch import MapBatch
    from crdt_tpu_torch.ops.map_ops import _tree_map

    return MapBatch.from_state(_tree_map(lambda x: x[rows], b.state), b.kernel)


def map_op_fleets(uni, vk, op: str, n: int, seed: int, dev):
    """``MAP_R`` replica fleets of ``n`` maps built on the card by seeded op
    rounds: ``MAP_ROUNDS[0]`` rounds of ``Op::Up`` (a nested ``op`` under
    a fresh dot of a base actor) and one of ``Op::Rm``, shared; then each
    replica's own ``MAP_ROUNDS[1]`` up rounds and one remove round through
    actors of its own.  A remove round removes a key under the map clock
    in 15% of the objects and buffers one ahead of it in 10%."""
    import torch

    from crdt_tpu_torch.batch.map_batch import MapBatch
    from crdt_tpu_torch.dtypes import zero_of
    from crdt_tpu_torch.ops import clock_ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def ints(hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev, dtype=torch.int64)

    def up(b, group):
        actor = group * MAP_ACTORS + ints(MAP_ACTORS)
        counter = clock_ops.inc_counter(b.clock, actor)
        if op == "apply_add":
            args = (actor, counter, ints(MAP_MEMBERS))
        else:  # a put whose context is the map clock: it covers the slot's values
            args = (b.clock.scatter(-1, actor[:, None], counter[:, None]), 1 + ints(1 << 30))
        return b.apply_up(actor, counter, ints(MAP_K), op, args)

    def rm(b, group):
        u = torch.rand(n, generator=gen, device=dev)
        actor = (group * MAP_ACTORS + ints(MAP_ACTORS))[:, None]
        z = zero_of(b.clock.dtype)
        ahead = torch.full_like(b.clock, z).scatter(-1, actor, b.clock.gather(-1, actor) + 1)
        clock = torch.where((u < 0.1)[:, None], ahead,
                            torch.where((u < 0.25)[:, None], b.clock, z))
        return b.apply_rm(clock, torch.where(u < 0.25, ints(MAP_K), 1 << 20))

    base = MapBatch.zeros(n, uni, vk, device=dev)
    for _ in range(MAP_ROUNDS[0]):
        base = up(base, 0)
    base = rm(base, 0)
    reps = []
    for r in range(MAP_R):
        b = base
        for _ in range(MAP_ROUNDS[1]):
            b = up(b, r + 1)
        reps.append(rm(b, r + 1))
    return reps


def map_wire_fleets(uni, vk, n: int, seed: int, dev):
    """``MAP_R`` replica fleets of ``n`` nested maps: seeded scalar maps
    (``testdata.random_map``, a shared base and each replica's own ops
    through its own actors) through ``to_binary`` and ``from_wire``."""
    from crdt_tpu_torch.batch.map_batch import MapBatch
    from crdt_tpu_torch.utils.serde import to_binary
    from crdt_tpu_torch.utils.testdata import random_map

    rng = np.random.RandomState(seed)
    kw = dict(n_keys=MAP_K, n_actors=MAP_ACTORS, rm_p=0.15)
    base = [random_map(rng, "map", max_ops=8, **kw) for _ in range(n)]
    return [MapBatch.from_wire(
        [to_binary(random_map(rng, "map", m=m.clone(), max_ops=6, actor0=MAP_ACTORS * (r + 1),
                              **kw)) for m in base], uni, vk, device=dev)
            for r in range(MAP_R)]


def map_truncate_clock(b, seed: int):
    """One truncate clock per object: the map clock on ~20% of the actors
    of half the objects, zero elsewhere."""
    import torch

    from crdt_tpu_torch.dtypes import zero_of

    gen = torch.Generator(device=b.device)
    gen.manual_seed(seed)
    n, a = b.clock.shape
    pick = (torch.rand((n, a), generator=gen, device=b.device) < 0.2) & (
        torch.rand((n, 1), generator=gen, device=b.device) < 0.5)
    return torch.where(pick, b.clock, zero_of(b.clock.dtype))


def map_join(reps, seed: int):
    """The Map phase's main path on one chunk: ``JoinExecutor`` folds the
    replicas (R - 1 merges and the plunger), then a truncate."""
    from crdt_tpu_torch import JoinExecutor, JoinStats

    stats = JoinStats()
    joined = JoinExecutor().join_all(reps, stats=stats)
    if stats.overflow_regrows:
        raise AssertionError(f"the Map join regrew ({stats})")
    tclock = map_truncate_clock(joined, seed)
    return joined.truncate(tclock), tclock


def map_checks(name, reps, tclock, out, uni, cpu_n: int, card: str):
    """Chunk 0 of a composition: its first ``cpu_n`` objects bit for bit
    against the same join and truncate on the CPU, ``MAP_SAMPLE`` sampled
    objects against the port's scalar engine, and a wire round (codec
    share 1.0, the blobs ``to_binary`` of the scalar result)."""
    import torch

    from crdt_tpu_torch import JoinExecutor
    from crdt_tpu_torch.batch import wirebulk
    from crdt_tpu_torch.batch.map_batch import MapBatch, _leaves
    from crdt_tpu_torch.batch.vclock_batch import row_to_vclock
    from crdt_tpu_torch.dtypes import counters_to_numpy
    from crdt_tpu_torch.ops.map_ops import _tree_map
    from crdt_tpu_torch.utils.serde import to_binary

    t0 = time.perf_counter()
    cpu = [MapBatch.from_state(_tree_map(lambda x: x[:cpu_n].cpu(), r.state), r.kernel)
           for r in reps]
    want = JoinExecutor().join_all(cpu).truncate(tclock[:cpu_n].cpu())
    for g, w in zip(_leaves(map_rows(out, slice(0, cpu_n)).state), _leaves(want.state)):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"{name}: the card's join != the CPU plain path's")
    t1 = time.perf_counter()
    n = out.clock.shape[0]
    rows = rows_of(np.sort(np.random.RandomState(SEED + 9).choice(n, MAP_SAMPLE, replace=False)),
                   out.device)
    acc = map_rows(reps[0], rows).to_scalar(uni)
    for r in reps[1:]:
        for s, o in zip(acc, map_rows(r, rows).to_scalar(uni)):
            s.merge(o)
    for s, t in zip(acc, counters_to_numpy(tclock[rows])):
        s.merge(s.clone())
        s.truncate(row_to_vclock(t, uni))
    want_blobs = [to_binary(s) for s in acc]
    if [to_binary(s) for s in map_rows(out, rows).to_scalar(uni)] != want_blobs:
        raise AssertionError(f"{name}: the card's join != the scalar engine's on the sample")
    t2 = time.perf_counter()
    before = wirebulk.wire_counts("map")
    blobs = out.to_wire(uni)
    t3 = time.perf_counter()
    back = MapBatch.from_wire(blobs, uni, out.kernel.val_kernel, device=out.device)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    if [blobs[i] for i in rows.tolist()] != want_blobs or back.to_wire(uni) != blobs:
        raise AssertionError(f"{name}: the wire round's blobs differ")
    # the round gives key slots, values and deferred rows in wire order: the
    # bytes above hold the content, the planes the clocks and key sets
    if not (torch.equal(back.clock, out.clock) and torch.equal(
            back.keys.sort(-1).values, out.keys.sort(-1).values)):
        raise AssertionError(f"{name}: from_wire(to_wire(x)) != x")
    grew = wirebulk.counts_since(before, "map")
    frac = {d: wirebulk.native_fraction(grew, d) for d in ("from_wire", "to_wire")}
    if frac != {"from_wire": 1.0, "to_wire": 1.0}:
        raise AssertionError(f"{name}: not every blob took the host codec ({grew})")
    log(f"  {name}: first {cpu_n} objects == CPU plain path ({t1 - t0:.1f} s), {MAP_SAMPLE} "
        f"sampled == scalar engine ({t2 - t1:.1f} s); wire round of {n} objects: encode "
        f"{t3 - t2:.3f} s, parse {t4 - t3:.3f} s, {sum(map(len, blobs)) / n:.1f} B/object, "
        f"codec share 1.0 [{card}]")
    return {"cpu_check_s": t1 - t0, "sample_check_s": t2 - t1, "encode_s": t3 - t2,
            "parse_s": t4 - t3, "wire_bytes_per_object": sum(map(len, blobs)) / n}


def map_k2(reps, card: str):
    """The merge kernel at the nested shapes a Map<K, Orswot> merge hands
    it: every launch of ``reps[0].merge(reps[1])`` (the value merge, the
    body's truncate and the deferred settle's, each an ``[N, 2K]`` batch
    of sets) bit for bit against ``merge_reference`` on the card, with its
    plan and its time beside the bytes bound."""
    import torch

    from crdt_tpu_torch.ops import orswot_tile as tile

    seen = []
    launch = tile.merge

    def capture(*args, **kw):
        seen.append(args)
        return launch(*args, **kw)

    # the merge body reaches the kernel through this module attribute; the
    # capture records each launch's inputs as the main path built them
    tile.merge = capture
    try:
        reps[0].merge(reps[1])
    finally:
        tile.merge = launch
    what = ("value merge", "truncate", "deferred settle")
    if len(seen) != len(what):
        raise AssertionError(f"a Map<K, Orswot> merge launched the merge kernel {len(seen)} "
                             f"times, not {len(what)}")
    rows = []
    for name, args in zip(what, seen):
        sa, sb, (m_cap, d_cap) = args[:5], args[5:10], args[10:12]
        got = tile.merge(*sa, *sb, m_cap, d_cap, prebiased=True)
        shape = list(sa[0].shape[:-1])
        n = got[0].shape[:-1].numel()
        # the plain version's [n, M, M, A] alignment runs over set chunks
        flat = [x.reshape(n, *x.shape[len(shape):]) for x in (*sa, *sb)]

        def plain():
            return [torch.cat(p) for p in zip(*(
                tile.merge_reference(*(x[i:i + MAP_K2_SETS] for x in flat), m_cap, d_cap)
                for i in range(0, n, MAP_K2_SETS)))]

        err = max_abs_err([x.reshape(n, *x.shape[len(shape):]) for x in got], plain())
        if err:
            raise AssertionError(f"orswot_merge != merge_reference at the Map's {name} ({err})")
        plan = tile.merge_plan(sa, sb, m_cap)
        ms = cuda_ms(lambda: tile.merge(*sa, *sb, m_cap, d_cap, prebiased=True), 10)
        plain_ms = cuda_ms(plain, 1)
        in_b, out_b = nbytes(sa) + nbytes(sb), nbytes(got[:5]) + got[5].numel() * 4
        b_ms, by = bound_ms(in_b, out_b, n * (2 * m_cap) * sa[0].shape[-1] * 12)
        log(f"  orswot_merge at the Map's {name}, nested shape {shape} (M={sa[1].shape[-1]}, "
            f"D={sa[3].shape[-1]}, A={sa[0].shape[-1]}): bit-equal to merge_reference, plan "
            f"{plan}; {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound {b_ms:.4f} ms ({by}; "
            f"{in_b + out_b} B) [{card}]")
        rows.append({"launch": name, "shape": shape, "plan": plan, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                     "bytes": in_b + out_b})
        del got
    return rows


def map_profile(reps, merge_ms: float, card: str):
    """One pairwise Map merge under ``torch.profiler``: the device's busy
    time (every kernel's), its idle share against ``merge_ms`` (the same
    merge timed by CUDA events), the kernels launched, and the top torch
    ops and kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps[0].merge(reps[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reps[0].merge(reps[1])
        torch.cuda.synchronize()
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    ops = [e for e in ev if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3

    def top(es):
        es = sorted(es, key=lambda e: -e.self_device_time_total)[:10]
        return [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in es]

    out = {"busy_ms": busy or None, "idle_share": 1 - busy / merge_ms if busy else None,
           "kernel_launches": sum(e.count for e in kernels), "top_ops": top(ops),
           "top_kernels": top(kernels)}
    log(f"  map_orswot merge profile: device busy {busy:.3f} ms of {merge_ms:.3f} ms "
        f"(idle share {out['idle_share']}), {out['kernel_launches']} kernels; top ops "
        f"{[(k, c, round(t, 3)) for k, c, t in out['top_ops']]} [{card}]")
    return out


def map_phase(dev, card: str):
    """Phase 9: Map<K, Orswot>, Map<K, MVReg> and Map<K, Map<K2, MVReg>> at
    the config-default widths (u32).  Returns the merge kernel's launches
    on the phase's main path."""
    import torch

    from crdt_tpu_torch import (
        CrdtConfig, MapKernel, MVRegKernel, OrswotKernel, Universe, _build,
    )
    from crdt_tpu_torch.batch.map_batch import _leaves

    uni = Universe.identity(CrdtConfig.gpu_default(
        num_actors=MAP_A, key_capacity=MAP_K, member_capacity=MAP_M, deferred_capacity=MAP_D,
        mv_capacity=MAP_KV))
    cfg = uni.config
    comps = {
        "map_orswot": (OrswotKernel.from_config(cfg), MAP_N, MAP_CHUNK, MAP_ORSWOT_CPU,
                       lambda vk, n, s: map_op_fleets(uni, vk, "apply_add", n, s, dev)),
        "map_mvreg": (MVRegKernel.from_config(cfg), MAP_N, MAP_CHUNK, 512,
                      lambda vk, n, s: map_op_fleets(uni, vk, "apply_put", n, s, dev)),
        "map_map_mvreg": (MapKernel.from_config(cfg, MVRegKernel.from_config(cfg)),
                          MAP_NESTED_N, MAP_NESTED_CHUNK, 16,
                          lambda vk, n, s: map_wire_fleets(uni, vk, n, s, dev)),
    }
    report, kept = {"card": card}, {}
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for k, (name, (vk, n_total, chunk, _, build)) in enumerate(comps.items()):
        build_s, join_ms = 0.0, []
        for c in range(n_total // chunk):
            t0 = time.perf_counter()
            reps = build(vk, chunk, SEED + 900 + 10 * k + c)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, tclock = map_join(reps, SEED + 950 + 10 * k + c)
            torch.cuda.synchronize()
            build_s += t1 - t0
            join_ms.append((time.perf_counter() - t1) * 1e3)
            if c == 0:
                kept[name] = (reps, tclock, out)
            del reps, out
        live = kept[name][2].len_counts().float().mean().item() / MAP_K
        deferred = (kept[name][2].d_keys != -1).any(-1).float().mean().item()
        report[name] = {"objects": n_total, "chunk": chunk, "replicas": MAP_R,
                        "join_ms_per_chunk": join_ms, "build_s": build_s,
                        "live_key_share": live, "deferred_object_share": deferred}
        log(f"  {name}: {n_total} objects in chunks of {chunk}, R={MAP_R}: join + truncate ms "
            f"per chunk {[round(t, 2) for t in join_ms]} (R - 1 merges and the plunger); "
            f"fleets built in {build_s:.1f} s; {live:.2%} of the key slots live, deferred rows "
            f"in {deferred:.2%} of objects [{card}]")
    launches = _build.launch_counts()["orswot_merge"]
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches {_build.launch_counts()}; peak device memory "
        f"{report['peak_memory_gb']:.2f} GB [{card}]")
    if launches == 0:
        raise AssertionError("the Map phase never launched the merge kernel")
    for name, (reps, tclock, out) in kept.items():
        report[name].update(map_checks(name, reps, tclock, out, uni, comps[name][3], card))
        # a merge reads two states and writes one (and one overflow flag per object)
        state = nbytes(_leaves(reps[0].state))
        ms = report[name]["merge_ms"] = cuda_ms(lambda: reps[0].merge(reps[1]), 3)
        b_ms, by = bound_ms(2 * state, state + reps[0].clock.shape[0], 0)
        report[name].update(state_bytes=state, bound_ms_per_merge=b_ms, bound_by=by)
        log(f"  {name}: one pairwise merge of {reps[0].clock.shape[0]} objects {ms:.3f} ms "
            f"(CUDA events), bound {b_ms:.4f} ms by {by} ({state} B per state) [{card}]")
    report["map_orswot"]["profile"] = map_profile(
        kept["map_orswot"][0], report["map_orswot"]["merge_ms"], card)
    report["orswot_merge"] = map_k2(kept["map_orswot"][0], card)
    print("maps " + json.dumps(report), flush=True)
    return launches


# -- phase 10 ------------------------------------------------------------------

# sync and GC: bench.py::bench_sync's replica shape (base=4, novel=0,
# deferred_frac=0.25, one plunger self-merge) at the north-star widths and
# fleet; each replica diverges on its own seeded 1% of the rows; GC regrows
# one replica to M=32, D=8 and compacts an op log of 4 frames of 65,536 ops
SYNC_BASE, SYNC_DIV, SYNC_SAMPLE, SYNC_DONE_BAR = 4, 0.01, 64, 0.10
GC_M, GC_D, GC_FRAMES, GC_FRAME_OPS = 32, 8, 4, 65_536
K2_CHECK_CELLS = 1 << 29  # [sets, m_cap, Ma + Mb, A] cells per plain-merge check


class K2Launches:
    """While installed, records every launch of the merge kernel's wrapper
    with its inputs and outputs; :meth:`check` holds each recorded launch
    against ``merge_reference`` (row chunks: the merge is row-independent)
    and forgets it."""

    def __enter__(self):
        from crdt_tpu_torch.ops import orswot_tile

        self.tile, self.launch, self.seen, self.checked = orswot_tile, orswot_tile.merge, [], []

        def capture(*args, **kw):
            out = self.launch(*args, **kw)
            self.seen.append((args, out))
            return out

        # orswot_ops.merge reaches the kernel through this module attribute
        orswot_tile.merge = capture
        return self

    def __exit__(self, *exc):
        self.tile.merge = self.launch

    def check(self, what: str):
        for args, out in self.seen:
            sa, sb, (m_cap, d_cap) = args[:5], args[5:10], args[10:12]
            n, a = sa[0].shape[0], sa[0].shape[-1]
            step = max(1, K2_CHECK_CELLS // (m_cap * (sa[1].shape[-1] + sb[1].shape[-1]) * a))
            for s in range(0, n, step):
                want = self.tile.merge_reference(*(x[s:s + step] for x in (*sa, *sb)), m_cap,
                                                 d_cap)
                if max_abs_err([x[s:s + step] for x in out], want):
                    raise AssertionError(f"{what}: the merge kernel != merge_reference at "
                                         f"sets {s}+ of a [{n}, M={sa[1].shape[-1]}|"
                                         f"{sb[1].shape[-1]}] launch")
            self.checked.append([n, sa[1].shape[-1], sb[1].shape[-1], m_cap, d_cap])
        self.seen.clear()


def timed_ms(fn):
    """``(fn(), device ms by CUDA events, wall ms)``."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def diverge(base, rng, actor: int, member: int, dev):
    """``base`` (unchanged) with one add of ``actor`` (member ``member``,
    the next dot) on its own seeded ``SYNC_DIV`` share of the rows, and
    those rows: the divergence phases 10 and 12 plant."""
    import torch

    from crdt_tpu_torch.sync import delta

    n = base.clock.shape[0]
    k = int(n * SYNC_DIV)
    rows = np.sort(rng.choice(n, k, replace=False))
    idx = rows_of(rows, dev)
    sub = delta.take_rows(base, idx)
    full = torch.full((k,), actor, device=dev)
    # the biased order is the unsigned one: max + 1 is the next dot
    sub = sub.apply_add(full, sub.clock.amax(dim=-1) + 1, torch.full_like(full, member))
    return delta.put_rows(base, idx, sub), rows


def sync_replicas(dev, rng):
    """Replica P (62,500-object chunks of ``anti_entropy_fleets``, one
    plunger self-merge) and replica Q = P; then each takes one add on its
    own seeded 1% of the rows.  Returns ``(P, Q, rows_p, rows_q, seconds)``."""
    import torch

    from crdt_tpu_torch import OrswotBatch
    from crdt_tpu_torch.utils.testdata import anti_entropy_fleets

    t0 = time.perf_counter()
    parts = []
    for _ in range(N_TOTAL // CHUNK):
        (planes,) = anti_entropy_fleets(rng, CHUNK, A, M, D, 1, base=SYNC_BASE, novel=0,
                                        deferred_frac=DEFERRED_FRAC)
        parts.append(OrswotBatch.from_numpy(*planes, device=dev))
    built = OrswotBatch(*(torch.cat([getattr(b, k) for b in parts]) for k in PLANES))
    del parts
    base = built.merge(built)
    (p, rows_p), (q, rows_q) = (diverge(base, rng, 1, 1 << 20, dev),
                                diverge(base, rng, 0, 1 << 21, dev))
    torch.cuda.synchronize()
    return p, q, rows_p, rows_q, time.perf_counter() - t0


def full_state_bytes(p, uni, estimate: bool = False) -> tuple[int, float]:
    """The bytes of ``p``'s full state on the wire (``to_wire``, chunk by
    chunk) and the seconds the encode took.  With ``estimate``, the first
    chunk's bytes times the chunks (the chip budget's cut 4 for phase 10,
    whose replicas are uniform: the whole fleet's encode takes 3.6-4.6 s;
    phase 11's skewed writes make phase 12's first chunk no sample)."""
    from crdt_tpu_torch import OrswotBatch

    t0 = time.perf_counter()
    stop = CHUNK if estimate else N_TOTAL
    full = sum(sum(map(len, OrswotBatch(*(getattr(p, k)[s:s + CHUNK] for k in PLANES))
                       .to_wire(uni))) for s in range(0, stop, CHUNK))
    return full * (N_TOTAL // stop), time.perf_counter() - t0


def session_step(p, q, uni, full_bytes: int, card: str) -> tuple:
    """Step 3 of phase 10: ``sync_pair`` of two sessions, as
    ``bench.py::bench_sync`` drives them, timed by the kernel observatory.
    Returns both sessions, both reports and the step's numbers."""
    import torch

    from crdt_tpu_torch import SyncSession, _build, kernel_observatory, sync_pair

    obs = kernel_observatory()
    obs.reset()
    torch.cuda.synchronize()
    earlier_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    sa = SyncSession(p, uni, full_state_bytes=full_bytes, peer="q")
    sb = SyncSession(q, uni, full_state_bytes=full_bytes, peer="p")
    obs.set_enabled(True)
    try:
        t0 = time.perf_counter()
        ra, rb = sync_pair(sa, sb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        obs.set_enabled(False)
    k2 = obs.table()["orswot_merge"]
    out = {"wall_s": wall, "k2_launches": _build.launch_counts()["orswot_merge"],
           "k2_device_ms": k2["device_ms_total"], "k2_timed": k2["timed"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "earlier_peak_gb": earlier_peak}
    for side, r in (("p", ra), ("q", rb)):
        prof = r.profile
        out[side] = {
            "wall_s": prof.wall_ns / 1e9,
            "split_s": {c: getattr(prof, f"{c}_ns") / 1e9
                        for c in ("serialize", "network", "kernel", "other", "unaccounted")},
            "bytes": {k: getattr(r, f"{k}_bytes_sent") for k in ("hello", "digest", "delta",
                                                                  "full", "tree")},
            "bytes_received": r.bytes_received, "delta_ratio": r.delta_ratio(full_bytes),
            "diverged": r.diverged, "digest_rounds": r.digest_rounds,
            "frames": [prof.frames_sent, prof.frames_received]}
        log(f"  session {side}: {out[side]['wall_s']:.3f} s wall "
            f"({ {c: round(v, 4) for c, v in out[side]['split_s'].items()} }); bytes sent "
            f"{out[side]['bytes']}, received {r.bytes_received}; delta_ratio "
            f"{out[side]['delta_ratio']:.5f} [{card}]")
    log(f"  sync_pair {wall:.3f} s; the merge kernel launched {out['k2_launches']} times, "
        f"{out['k2_device_ms']:.3f} ms on the device (observatory); peak device memory "
        f"{out['peak_memory_gb']:.2f} GB [{card}]")
    return sa, sb, ra, rb, out


def session_checks(p, q, sa, sb, reports, ids, uni, rng, k2, card: str,
                   self_merge: bool = False) -> None:
    """The session step's checks: both converged on the planted rows
    without a fallback, within the done-bar; each replica equals the merge
    kernel's full-fleet merge of the two (local first); sampled rows equal
    the scalar engine.  With ``self_merge`` (replicas whose member slots
    are out of ascending-id order, which the merge sorts and a row the
    session does not ship keeps), each replica's rows outside ``ids`` are
    first held bit for bit against the replica before the session, and the
    replica is self-merged before it is held against the full-fleet merge."""
    import torch

    from crdt_tpu_torch.sync import delta
    from crdt_tpu_torch.utils.serde import from_binary, to_binary

    for r, what in zip(reports, ("P", "Q")):
        if not (r.converged and r.diverged == ids.size and not r.full_state_fallback
                and r.digest_rounds == 2 and not r.tree_mode):
            raise AssertionError(f"session {what}: {r}")
        if r.delta_ratio(sa.full_state_bytes) > SYNC_DONE_BAR:
            raise AssertionError(f"session {what}: delta_ratio "
                                 f"{r.delta_ratio(sa.full_state_bytes):.4f} > {SYNC_DONE_BAR}")
    k2.check("the sessions' delta applies")
    if self_merge:
        kept = torch.ones(p.clock.shape[0], dtype=torch.bool, device=p.clock.device)
        kept[rows_of(ids, p.clock.device)] = False
    for got, (x, y), what in ((sa.batch, (p, q), "P"), (sb.batch, (q, p), "Q")):
        if self_merge:
            for lo in range(0, kept.shape[0], CHUNK):
                rows = kept[lo:lo + CHUNK]
                for name in PLANES:
                    if not torch.equal(getattr(got, name)[lo:lo + CHUNK][rows],
                                       getattr(x, name)[lo:lo + CHUNK][rows]):
                        raise AssertionError(f"{what} after the session: {name} differs from "
                                             f"{what} before it on a row it did not ship")
            got = got.merge(got)
            k2.check("the self-merge")
        same_planes(got, x.merge(y), f"{what} after the session against K2's full-fleet merge")
        k2.check("the full-fleet merge")
    sample = np.sort(rng.choice(ids, SYNC_SAMPLE, replace=False))
    blobs = {k: delta.gather_blobs(b, sample, uni) for k, b in
             (("p", p), ("q", q), ("p_new", sa.batch), ("q_new", sb.batch))}
    for mine, theirs, new in (("p", "q", "p_new"), ("q", "p", "q_new")):
        for i in range(SYNC_SAMPLE):
            s = from_binary(blobs[mine][i])
            s.merge(from_binary(blobs[theirs][i]))
            if to_binary(s) != blobs[new][i]:
                raise AssertionError(f"{new} != the scalar engine at object {sample[i]}")
    log(f"  after the session: P == merge(P, Q) and Q == merge(Q, P) (K2, full fleet"
        f"{', after a self-merge; the rows not shipped unchanged' if self_merge else ''}), "
        f"{SYNC_SAMPLE} sampled rows == the scalar engine [{card}]")


def idle_resync(a, b, uni, full_bytes: int, card: str) -> dict:
    """An idle re-sync of the converged replicas with the digest tree on
    both sides: one root frame each way, no delta and no full state."""
    import torch

    from crdt_tpu_torch import SyncSession, sync_pair

    sa = SyncSession(a, uni, full_state_bytes=full_bytes, peer="q", digest_tree=True)
    sb = SyncSession(b, uni, full_state_bytes=full_bytes, peer="p", digest_tree=True)
    t0 = time.perf_counter()
    reports = sync_pair(sa, sb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reports:
        if not (r.converged and r.tree_mode and r.tree_frames_sent == 1 and r.diverged == 0
                and r.delta_bytes_sent == r.full_bytes_sent == r.digest_bytes_sent == 0):
            raise AssertionError(f"the idle tree re-sync was not one root frame: {r}")
    out = {"wall_s": wall, "tree_bytes": [r.tree_bytes_sent for r in reports],
           "profile_wall_s": [r.profile.wall_ns / 1e9 for r in reports],
           "kernel_s": [r.profile.kernel_ns / 1e9 for r in reports]}
    log(f"  idle re-sync (digest tree): one root frame each way, {out['tree_bytes']} B, "
        f"{wall:.3f} s (kernel {out['kernel_s']}) [{card}]")
    return out


def sync_gc_phase(dev, card: str):
    """Phase 10: two 1.25M-object replicas reconciled by two sync sessions,
    and a causal-GC pass (A=64, M=16, D=2, u32).  Returns the merge
    kernel's launches on the phase's main path (the plunger, the sessions'
    applies, the reference truncate), replica P and the diverged rows,
    which phase 11 reads."""
    import torch

    from crdt_tpu_torch import (
        CrdtConfig, GcEngine, GcPolicy, OrswotBatch, OrswotKernel, Universe, _build,
    )
    from crdt_tpu_torch.dtypes import as_counters
    from crdt_tpu_torch.gc import compact
    from crdt_tpu_torch.obs import convergence
    from crdt_tpu_torch.oplog import OP_ADD, OpApplier, OpBatch, OpLog, decode_ops_frame
    from crdt_tpu_torch.oplog import encode_ops_frame
    from crdt_tpu_torch.sync import delta, digest, tree
    from crdt_tpu_torch.utils.testdata import plant_dominated_deferred

    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=A, member_capacity=M,
                                                   deferred_capacity=D))
    rng = np.random.RandomState(SEED + 10)
    rep = {"card": card, "objects": N_TOTAL, "shape": [A, M, D], "divergence": SYNC_DIV}
    torch.cuda.reset_peak_memory_stats()
    launches = 0
    with K2Launches() as k2:
        # 1. two replicas
        _build.reset_launch_counts()
        p, q, rows_p, rows_q, rep["build_s"] = sync_replicas(dev, rng)
        launches += _build.launch_counts()["orswot_merge"]
        k2.check("the plunger")
        torch.cuda.empty_cache()
        planted = np.union1d(rows_p, rows_q)
        fleet_bytes = nbytes([getattr(p, k) for k in PLANES])
        log(f"  replicas: {N_TOTAL} objects each, {fleet_bytes / 1e9:.3f} GB of planes, "
            f"{len(rows_p)} + {len(rows_q)} rows diverged by one add each ({len(planted)} "
            f"distinct), built in {rep['build_s']:.1f} s")

        # 2. find the diverged rows: digests, trees, descent
        _build.reset_launch_counts()
        d_p, ms_p, wall_p = timed_ms(lambda: digest.digest_of(p, uni))
        d_q, ms_q, wall_q = timed_ms(lambda: digest.digest_of(q, uni))
        (t_p, t_q), tree_ms, _ = timed_ms(lambda: (tree.build_tree(d_p, device=dev),
                                                   tree.build_tree(d_q, device=dev)))
        t0 = time.perf_counter()
        found, stats = tree.simulate_descent(t_p, t_q)
        descent_ms = (time.perf_counter() - t0) * 1e3
        ids = delta.diverged_indices(d_p, d_q)
        if not (np.array_equal(found, ids) and np.array_equal(ids, planted)):
            raise AssertionError(f"descent {found.size}, diverged {ids.size} and planted "
                                 f"{planted.size} rows disagree")
        b_ms, _ = bound_ms(fleet_bytes, 8 * N_TOTAL, 0)
        rep.update(digest_ms=[ms_p, ms_q], digest_wall_ms=[wall_p, wall_q],
                   digest_bound_ms=b_ms, tree_build_ms_both=tree_ms, descent_ms=descent_ms,
                   descent=dataclasses.asdict(stats), diverged=int(ids.size))
        log(f"  digests: {ms_p:.2f} / {ms_q:.2f} ms per fleet (CUDA events; wall {wall_p:.1f} / "
            f"{wall_q:.1f} ms), bytes bound {b_ms:.3f} ms; trees {tree_ms:.2f} ms for both; "
            f"descent {descent_ms:.1f} ms, {stats.levels} levels, {stats.payload_bytes} B per "
            f"side: {ids.size} rows == diverged_indices == the planted rows [{card}]")

        # 3. the exchange: two sessions through sync_pair, then an idle re-sync
        rep["full_state_bytes"], rep["full_state_encode_s"] = full_state_bytes(p, uni,
                                                                                 estimate=True)
        _build.reset_launch_counts()
        sa, sb, ra, rb, rep["session"] = session_step(p, q, uni, rep["full_state_bytes"], card)
        launches += _build.launch_counts()["orswot_merge"]
        rep["delta_ratio"] = max(ra.delta_ratio(rep["full_state_bytes"]),
                                 rb.delta_ratio(rep["full_state_bytes"]))
        session_checks(p, q, sa, sb, (ra, rb), ids, uni, rng, k2, card)
        rep["session"]["idle_resync"] = idle_resync(sa.batch, sb.batch, uni,
                                                    rep["full_state_bytes"], card)
        chunk = OrswotBatch(*(getattr(sa.batch, k)[:CHUNK].clone() for k in PLANES))
        del sa, sb
        torch.cuda.empty_cache()

        # 4. GC: Q regrown as after a burst, the watermark from both vectors
        _build.reset_launch_counts()
        big = q.with_capacity(GC_M, GC_D)
        del q
        # tombstones to settle: dominated deferred removes on a seeded 1% of
        # the rows, a tenth of them duplicated
        k = int(N_TOTAL * SYNC_DIV)
        tombs = plant_dominated_deferred(big, np.sort(rng.choice(N_TOTAL, k, replace=False)),
                                         dup=k // 10)
        trk = convergence.tracker()
        trk.reset()
        trk.observe_version_vector("p", digest.version_vector(p))
        trk.observe_version_vector("q", digest.version_vector(big))
        oplog = OpLog(uni, capacity=GC_FRAMES * GC_FRAME_OPS)
        for _ in range(GC_FRAMES):
            ops = OpBatch(kind=np.full(GC_FRAME_OPS, OP_ADD, np.uint8),
                          obj=rng.randint(0, N_TOTAL, GC_FRAME_OPS),
                          actor=rng.randint(0, A, GC_FRAME_OPS),
                          counter=rng.randint(1, 200, GC_FRAME_OPS),
                          member=rng.randint(0, 1 << 24, GC_FRAME_OPS))
            oplog.append(decode_ops_frame(encode_ops_frame(ops), num_actors=A))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gcd, report = GcEngine(GcPolicy(interval_rounds=1), tracker=trk).collect(
            big, universe=uni, oplog=oplog, applier=OpApplier(uni), peers=["p", "q"])
        torch.cuda.synchronize()
        gc_s = time.perf_counter() - t0
        # 6. the reference truncate at the watermark, one chunk
        wm = report.watermark.clock
        trunc, trunc_ms, _ = timed_ms(lambda: compact.truncate_orswot(chunk, wm))
        launches += _build.launch_counts()["orswot_merge"]

        plane_diff = nbytes([getattr(big, k) for k in PLANES]) - nbytes(
            [getattr(gcd, k) for k in PLANES])
        if (report.member_capacity, report.deferred_capacity) != ((GC_M, M), (GC_D, D)):
            raise AssertionError(f"GC shrank to {report.member_capacity}, "
                                 f"{report.deferred_capacity}")
        if report.tombstones_cleared < tombs + k // 10 or report.members_freed < tombs:
            raise AssertionError(f"GC cleared {report.tombstones_cleared} tombstones and freed "
                                 f"{report.members_freed} members of {tombs} planted rows")
        if report.reclaimed_bytes - report.oplog_bytes_reclaimed != plane_diff:
            raise AssertionError(f"reclaimed {report.reclaimed_bytes} B != the planes' "
                                 f"{plane_diff} B + the op log's")
        rep["gc"] = {"seconds": report.seconds, "wall_s": gc_s,
                     "tombstone_rows_planted": tombs, "duplicates_planted": k // 10,
                     "tombstones_cleared": report.tombstones_cleared,
                     "members_freed": report.members_freed,
                     "member_capacity": report.member_capacity,
                     "deferred_capacity": report.deferred_capacity,
                     "reclaimed_bytes": report.reclaimed_bytes,
                     "plane_bytes_reclaimed": plane_diff,
                     "oplog_ops": GC_FRAMES * GC_FRAME_OPS,
                     "oplog_ops_dropped": report.oplog_ops_dropped,
                     "watermark_max_counter": report.watermark.max_counter,
                     "watermark_peers": report.watermark.peers, "truncate_ms": trunc_ms}
        log(f"  GC pass over Q regrown to M={GC_M}, D={GC_D}: {gc_s:.3f} s (steps "
            f"{ {step: round(v, 4) for step, v in report.seconds.items()} }); tombstones cleared "
            f"{report.tombstones_cleared} ({tombs} rows planted, {k // 10} duplicated), members "
            f"freed {report.members_freed}, shrink {report.member_capacity} / "
            f"{report.deferred_capacity}, {plane_diff} plane bytes reclaimed, "
            f"{report.oplog_ops_dropped} of {GC_FRAMES * GC_FRAME_OPS} logged ops dropped "
            f"below the watermark (max counter {report.watermark.max_counter}) [{card}]")

        # 5. the GC property at full width
        want = digest.digest_of(big.merge(p), uni)
        k2.check("merge(Q, P)")
        got = digest.digest_of(gcd.merge(p), uni)
        k2.check("merge(GC'd Q, P)")
        if not np.array_equal(got, want):
            raise AssertionError("merge(GC'd Q, P) and merge(Q, P) digest differently")
        # 6. the truncate against the plain path (the rank merge, on the card)
        kern = OrswotKernel(M, D, A, 32, merge_impl="rank")
        clock = as_counters(np.broadcast_to(wm, (CHUNK, A)), torch.int32, dev)
        plain, over = kern.truncate_full(tuple(getattr(chunk, k) for k in PLANES), clock)
        if bool(over.any()) or max_abs_err([getattr(trunc, k) for k in PLANES], plain):
            raise AssertionError("truncate_orswot through the merge kernel != the plain path")
        k2.check("the truncate")
        rep["k2_launches_checked"] = k2.checked
    rep["peak_memory_gb"] = max(torch.cuda.max_memory_allocated() / 1e9,
                                rep["session"]["peak_memory_gb"], rep["session"]["earlier_peak_gb"])
    log(f"  merge(GC'd Q, P) == merge(Q, P) by digest; truncate at the watermark "
        f"{trunc_ms:.3f} ms == the plain path; {len(k2.checked)} merge-kernel launches "
        f"bit-equal to merge_reference; peak device memory {rep['peak_memory_gb']:.2f} GB "
        f"[{card}]")
    print("sync_gc " + json.dumps(rep), flush=True)
    return launches, p, ids


# -- phase 11 ------------------------------------------------------------------

# the read front-end: bench.py::bench_reads's traffic (WorkloadGen seed 29,
# Zipf 1.1, bursts of 4, half reads) at the north-star fleet; 8,192-row
# read batches, a quarter value() reads and the rest contains() probes on
# members below 2M, one batch in 8 under the frontier mode; the write half
# folded in 4 chunks through derive_add_ctx + OpApplier; then one batch of
# each other kind at phase 8's (u64, 65,536 objects) and phase 9's (u32,
# Map<K, MVReg>, 8,192 objects) widths
READ_B, READ_NB, READ_FRONTIER_EVERY, READ_WRITE_CHUNKS = 8192, 40, 8, 4
READ_PARITY, READ_AUDIT, READ_KIND_N, READ_TIMED = 4096, 4096, 65_536, 10


def read_traffic(rng):
    """``(read objects, read members, write objects)`` of the mixed stream."""
    from crdt_tpu_torch.serve import NO_MEMBER
    from crdt_tpu_torch.utils.workload import WorkloadGen

    gen = WorkloadGen(N_TOTAL, seed=29, zipf_s=1.1, burst_len=4, read_frac=0.5)
    keys, is_read = gen.draw_mixed(2 * READ_B * READ_NB + 20_000)
    robj = keys[is_read][:READ_B * READ_NB]
    if robj.size < READ_B * READ_NB:
        raise AssertionError(f"the stream drew {robj.size} reads")
    member = rng.randint(0, 2 * M, robj.size).astype(np.int32)
    member[rng.random_sample(robj.size) < 0.25] = NO_MEMBER
    return robj, member, keys[~is_read]


def same_frame(got, want, what: str):
    """Raise unless two frames agree on every value, clock and extras column."""
    for f in ("val", "add_clock", "rm_clock"):
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{what}: {f} differs")
    for k, w in want.extras.items():
        if got.extras[k].dtype != w.dtype or not np.array_equal(got.extras[k], w):
            raise AssertionError(f"{what}: {k} differs")


def cpu_frame(fleet, obj, member):
    """The same reads through the plain path on a CPU copy of their rows."""
    from crdt_tpu_torch.serve import gather
    from crdt_tpu_torch.sync import delta

    uniq, inv = np.unique(obj, return_inverse=True)
    rows = delta.take_rows(fleet, rows_of(uniq, fleet.clock.device))
    return gather(dataclasses.replace(rows, **{k: getattr(rows, k).cpu() for k in PLANES}),
                  inv, member=member)


def np_svv(clock, span):
    """Per-subtree max of a host ``[N, W]`` clock plane (numpy)."""
    return np.stack([clock[s:s + span].max(axis=0) for s in range(0, clock.shape[0], span)])


def refresh_frontier(trk, conv, fleet, prev, span):
    """Evidence from peer "eq" (the fleet as it is) and peer "lag" (the
    fleet with subtree 0's clocks as of ``prev``, the last refresh), then
    the frontier on the card; held against a numpy min over the peers.
    Returns ``(report, fold ms, this refresh's host svv)``."""
    import torch

    from crdt_tpu_torch import VClockBatch
    from crdt_tpu_torch.dtypes import counters_to_numpy
    from crdt_tpu_torch.sync import digest

    lag = VClockBatch(clocks=torch.cat([prev[1][:span], fleet.clock[span:]]))
    for peer, b in (("eq", fleet), ("lag", lag)):
        trk.observe_converged(peer, b)
        conv.observe_version_vector(peer, digest.version_vector(b))
    report, ms, _ = timed_ms(lambda: trk.frontier(fleet, peers=["eq", "lag"]))
    now = np_svv(counters_to_numpy(fleet.clock), span).astype(np.uint64)
    lag_svv = np.concatenate([prev[0][:1], now[1:]])
    fleet_min = np.minimum(now.max(axis=0), lag_svv.max(axis=0))
    want = np.maximum(np.minimum(now, lag_svv), fleet_min)
    if not (np.array_equal(report.clock, fleet_min)
            and np.array_equal(report.subtree_clocks, want)):
        raise AssertionError("the frontier != the numpy min over the peers")
    return report, ms, now


def kind_fleets(dev, rng):
    """A fleet of each other read kind, from seeded numpy planes, on the
    card and on the CPU: GCounter (64 actors), PNCounter ([2, 32]), LWW
    and MVReg (K=8 x 64) at phase 8's widths, u64, 65,536 objects;
    Map<K, MVReg> at phase 9's (A=64, K=16, D=8, mv 8), u32, 8,192."""
    import torch

    from crdt_tpu_torch import (CrdtConfig, GCounterBatch, LWWRegBatch, MapBatch, MapKernel,
                                MVRegBatch, MVRegKernel, PNCounterBatch)
    from crdt_tpu_torch.dtypes import bias_np
    from crdt_tpu_torch.serve import K_GCOUNTER, K_LWW, K_MAP, K_MVREG, K_PNCOUNTER

    n = READ_KIND_N

    def c64(*shape):
        x = rng.randint(0, 1 << 40, size=shape).astype(np.uint64) << np.uint64(20)
        x[rng.random_sample(shape) < 0.5] = 0
        return x

    g, pn, lv, lm = c64(n, FLAT_A), c64(n, 2, FLAT_PN_A), c64(n), c64(n)
    mc = c64(n, FLAT_K, FLAT_A) * (rng.random_sample((n, FLAT_K, 1)) < 0.5)
    mv = c64(n, FLAT_K) * mc.any(axis=-1)
    mn = READ_B
    cfg = CrdtConfig(num_actors=MAP_A, key_capacity=MAP_K, deferred_capacity=MAP_D,
                     mv_capacity=MAP_KV, counter_bits=32)
    mk = MapKernel.from_config(cfg, MVRegKernel.from_config(cfg))
    keys = np.where(rng.random_sample((mn, MAP_K)) < 0.6, np.arange(MAP_K) * 5, -1)
    mclock = (c64(mn, MAP_A) >> np.uint64(40)).astype(np.uint32)
    eclocks = (c64(mn, MAP_K, MAP_A) >> np.uint64(40)).astype(np.uint32) * (keys >= 0)[..., None]

    def build(d):
        m = MapBatch.from_state(mk.zeros((mn,), d), mk)
        for plane, x in ((m.clock, bias_np(mclock)), (m.keys, keys.astype(np.int32)),
                         (m.entry_clocks, bias_np(eclocks))):
            plane.copy_(torch.from_numpy(np.ascontiguousarray(x)).to(d))
        return {K_GCOUNTER: GCounterBatch.from_numpy(g, device=d),
                K_PNCOUNTER: PNCounterBatch.from_numpy(pn, device=d),
                K_LWW: LWWRegBatch.from_numpy(lv, lm, device=d),
                K_MVREG: MVRegBatch.from_numpy(mc, mv, device=d), K_MAP: m}

    return build(dev), build("cpu"), keys


def read_kinds(dev, rng, card: str) -> dict:
    """One 8,192-row batch of each other kind on the card, against the CPU."""
    from crdt_tpu_torch.serve import KIND_NAMES, K_MAP, NO_MEMBER, gather

    t0 = time.perf_counter()
    on_card, on_cpu, keys = kind_fleets(dev, rng)
    out = {"build_s": time.perf_counter() - t0}
    for kind, batch in on_card.items():
        n = (READ_B if kind == K_MAP else READ_KIND_N)
        obj = rng.randint(0, n, READ_B)
        member = None
        if kind == K_MAP:
            member = keys[obj, rng.randint(0, MAP_K, READ_B)].astype(np.int32)
            member[rng.random_sample(READ_B) < 0.25] = NO_MEMBER
        gather(batch, obj, member=member)  # the first call loads the ops' device code
        frame, _, wall = timed_ms(lambda: gather(batch, obj, member=member))
        same_frame(frame, gather(on_cpu[kind], obj, member=member), KIND_NAMES[kind])
        out[KIND_NAMES[kind]] = {"objects": n, "gather_wall_ms": wall}
    log(f"  other kinds, one {READ_B}-row batch each on the card == the CPU path: "
        + ", ".join(f"{k} {v['gather_wall_ms']:.2f} ms" for k, v in out.items() if k != "build_s")
        + f" (fleets built in {out['build_s']:.1f} s) [{card}]")
    return out


def read_phase(dev, card: str, fleet, diverged):
    """Phase 11: the read front-end on the north-star fleet (phase 10's
    replica P).  Returns the merge kernel's launches on the phase's path
    (the auditor's self-merge) and the fleet with the writes folded in,
    which phase 12 reconciles."""
    import torch

    from crdt_tpu_torch import (CapacityTracker, CrdtConfig, GcEngine, GcPolicy, HeatTracker,
                                StabilityTracker, Universe, _build, kernel_observatory)
    from crdt_tpu_torch.obs import convergence, heat as heat_mod, stability
    from crdt_tpu_torch.dtypes import counters_to_numpy
    from crdt_tpu_torch.oplog import OpApplier, derive_add_ctx
    from crdt_tpu_torch.serve import (K_ORSWOT, NO_MEMBER, ST_NOT_STABLE, admit, gather, query,
                                      stability_statuses)
    from crdt_tpu_torch.sync import delta
    from crdt_tpu_torch.utils.serde import from_binary

    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=A, member_capacity=M,
                                                   deferred_capacity=D))
    rng = np.random.RandomState(SEED + 11)
    t_phase = time.perf_counter()
    rep = {"card": card, "objects": N_TOTAL, "shape": [A, M, D], "batch": READ_B,
           "fleet": "phase 10's replica P"}
    torch.cuda.reset_peak_memory_stats()
    obs = kernel_observatory()
    with K2Launches() as k2:
        t0 = time.perf_counter()
        robj, rmember, wobj = read_traffic(rng)
        rep["draw_s"] = time.perf_counter() - t0
        subtrees, span = stability.subtree_layout(N_TOTAL)
        conv = convergence.ConvergenceTracker()
        trk = StabilityTracker(tracker=conv, seed=SEED)
        trk.observe_descent("q", diverged, N_TOTAL)
        heat = HeatTracker(device=dev)
        applier = OpApplier(uni)
        chunks = np.array_split(wobj, READ_WRITE_CHUNKS)
        prev = None  # (host svv, clock plane) at the last frontier refresh
        _build.reset_launch_counts()
        obs.reset()
        obs.set_enabled(True)
        walls, rec_ms, write_s, fold_ms, checks_s = [], [], [], [], 0.0
        not_stable = [0] * subtrees
        report = None
        for i in range(READ_NB):
            if i % (READ_NB // READ_WRITE_CHUNKS) == 0:
                if prev is None:  # the evidence point before any write
                    prev = (np_svv(counters_to_numpy(fleet.clock), span).astype(np.uint64),
                            fleet.clock)
                w = chunks[i // (READ_NB // READ_WRITE_CHUNKS)]
                t0 = time.perf_counter()
                ops, _ = derive_add_ctx(fleet.clock, w, rng.randint(0, A, w.size).astype(np.int32),
                                        member=rng.randint(1 << 16, (1 << 16) + 4, w.size)
                                        .astype(np.int32))
                fleet, _ = applier.apply_ops(fleet, ops)
                heat.record_writes(w, N_TOTAL)
                torch.cuda.synchronize()
                write_s.append(time.perf_counter() - t0)
            sl = slice(i * READ_B, (i + 1) * READ_B)
            obj, member = robj[sl], rmember[sl]
            mode = "frontier" if i % READ_FRONTIER_EVERY == 0 else "eventual"
            if mode == "frontier":
                report, ms, now = refresh_frontier(trk, conv, fleet, prev, span)
                prev = (now, fleet.clock)
                fold_ms.append(ms)
            if not admit(mode, None, conv.version_vectors()["eq"][0],
                         None if report is None else report.clock).admitted:
                raise AssertionError(f"a {mode} read batch was not admitted")
            t0 = time.perf_counter()
            frame = gather(fleet, obj, member=member)
            walls.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            heat.record_reads(obj, N_TOTAL, mode)
            torch.cuda.synchronize()
            rec_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            same_frame(frame, cpu_frame(fleet, obj, member), f"read batch {i}")
            if mode == "frontier":
                frame.status = stability_statuses(frame, trk.subtree_frontier_clocks(), span)
                floor = report.subtree_clocks[obj // span]
                want = np.where((frame.add_clock <= floor).all(axis=1), 0, ST_NOT_STABLE)
                if not np.array_equal(frame.status, want):
                    raise AssertionError(f"read batch {i}: the statuses != the numpy frontier")
                for s in range(subtrees):
                    not_stable[s] += int((frame.status[obj // span == s] != 0).sum())
            checks_s += time.perf_counter() - t0
        torch.cuda.synchronize()
        if not_stable[0] == 0 or any(not_stable[1:]):
            raise AssertionError(f"ST_NOT_STABLE rows by subtree {not_stable}: want some in the "
                                 "lagging subtree 0 and none elsewhere")

        n_reads = READ_B * READ_NB
        rep.update(reads=n_reads, writes=int(wobj.size), gather_wall_ms=walls,
                   reads_per_s=n_reads / (sum(walls) / 1e3), heat_record_ms=rec_ms,
                   write_fold_s=write_s, frontier_ms=fold_ms, checks_s=checks_s,
                   not_stable_by_subtree=not_stable)
        log(f"  {READ_NB} ORSWOT read batches of {READ_B} ({n_reads} reads, {wobj.size} writes "
            f"folded in {READ_WRITE_CHUNKS} chunks of {[round(t, 3) for t in write_s]} s): "
            f"{rep['reads_per_s'] / 1e6:.3f}M reads/s end to end (gather wall per batch "
            f"{min(walls):.2f}-{max(walls):.2f} ms, median {np.median(walls):.2f}); heat record "
            f"median {np.median(rec_ms):.2f} ms per batch; each frame == the CPU path; frontier "
            f"batches' statuses == the numpy frontier, ST_NOT_STABLE by subtree {not_stable} "
            f"[{card}]")

        # the gather's device time and bytes bound, and its copy back
        dev_ms, d2h_ms, moved, bounds = [], [], [], []
        for i in range(READ_TIMED):
            sl = slice(i * READ_B, (i + 1) * READ_B)
            obj_t, mem_t = query._upload(robj[sl], rmember[sl], dev)
            b = obj_t.shape[0]
            out, ms, _ = timed_ms(lambda: query.KERNELS[K_ORSWOT](fleet, obj_t, mem_t))
            t0 = time.perf_counter()
            host = query._download(out)
            d2h_ms.append((time.perf_counter() - t0) * 1e3)
            hits = int(((rmember[sl] >= 0) & (host[0] == 1)).sum())
            in_b = b * (16 + 4 * (A + M)) + hits * 4 * A
            out_b = sum(x.nbytes for x in (*host[:3], *host[3].values()))
            dev_ms.append(ms)
            moved.append(out_b)
            bounds.append(bound_ms(in_b, out_b, 0)[0])
        # the heat tracker's two device passes on one batch, and the frontier fold
        ids_t = torch.from_numpy(np.stack(heat_mod._pad_pow2(robj[:READ_B]))).to(dev)
        sketch_ms = cuda_ms(lambda: heat_mod.sketch_update(*heat._table(), ids_t[0], ids_t[1]), 5)
        hfold_ms = cuda_ms(lambda: heat_mod.subtree_fold(ids_t[0], ids_t[1], subtrees, span), 5)
        front_ms = cuda_ms(lambda: stability.subtree_fold(fleet.clock, subtrees, span), 10)
        front_bound = bound_ms(nbytes([fleet.clock]), subtrees * A * 4, 0)[0]
        rep.update(gather_device_ms=dev_ms, gather_bound_ms=bounds, d2h_ms=d2h_ms,
                   d2h_bytes=moved, sketch_ms=sketch_ms, heat_fold_ms=hfold_ms,
                   frontier_fold_ms=front_ms, frontier_fold_bound_ms=front_bound)
        log(f"  ORSWOT gather: device {np.median(dev_ms):.4f} ms per batch (CUDA events, median "
            f"of {READ_TIMED}) against a bytes bound of {np.median(bounds):.4f} ms; copy back "
            f"{np.median(d2h_ms):.3f} ms for {moved[0]} B; heat sketch {sketch_ms:.4f} ms, heat "
            f"fold {hfold_ms:.4f} ms; frontier fold {front_ms:.4f} ms against a bound of "
            f"{front_bound:.4f} ms (refresh with evidence {np.median(fold_ms):.1f} ms) [{card}]")

        # heat: the subtree totals and the sketch against the stream itself
        snap = heat.snapshot()
        for cls, ids in (("reads", robj), ("writes", wobj)):
            got = [s[cls] for s in snap["subtree"]]
            if got != np.bincount(ids // span, minlength=subtrees).tolist():
                raise AssertionError(f"heat {cls} by subtree {got} != the stream's bincount")
        true = np.bincount(np.concatenate([robj, wobj]), minlength=N_TOTAL)
        top = np.argsort(-true, kind="stable")[:9]
        hot = heat.hot(8)
        if sorted(true[[h["obj"] for h in hot]].tolist()) != sorted(true[top[:8]].tolist()) or (
                true[top[7]] > true[top[8]] and {h["obj"] for h in hot} != set(top[:8].tolist())):
            raise AssertionError(f"the sketch's top 8 {hot} != the stream's {top[:8]}")
        for h in snap["hot"]:
            if not h["count"] - h["err"] <= true[h["obj"]] <= h["count"]:
                raise AssertionError(f"sketch entry {h} against a true count {true[h['obj']]}")
        rep.update(hot=hot, s_hat=snap["zipf"]["s_hat"], zipf_r2=snap["zipf"]["r2"],
                   reads_by_mode=snap["reads_by_mode"])
        log(f"  heat: subtree totals == the stream's bincount; the sketch's top 8 == the "
            f"stream's, every decoded count within [count - err, count]; s_hat "
            f"{snap['zipf']['s_hat']:.4f} (r2 {snap['zipf']['r2']:.4f}) beside zipf_s 1.1; reads "
            f"by mode {snap['reads_by_mode']}")

        # 4,096 reads against the scalar ReadCtx loop (bench_reads' parity gate)
        t0 = time.perf_counter()
        pobj = rng.randint(0, N_TOTAL, READ_PARITY)
        uniq, inv = np.unique(pobj, return_inverse=True)
        ids = delta.take_rows(fleet, rows_of(uniq, dev)).ids.cpu().numpy()
        pmember = ids[inv, rng.randint(0, M, READ_PARITY)]
        pick = rng.random_sample(READ_PARITY)
        pmember[pick < 0.25] = NO_MEMBER
        pmember[(pick >= 0.25) & (pick < 0.5)] = rng.randint(1 << 24, 1 << 25, int(
            ((pick >= 0.25) & (pick < 0.5)).sum()))
        frame = gather(fleet, pobj, member=pmember)
        scal = [from_binary(b) for b in delta.gather_blobs(fleet, uniq, uni)]
        for i in range(READ_PARITY):
            s = scal[inv[i]]
            rc = s.value() if pmember[i] < 0 else s.contains(int(pmember[i]))
            got = frame.read_ctx(i, uni)
            want_val = len(rc.val) if pmember[i] < 0 else int(bool(rc.val))
            if (got.val, got.add_clock.dots, got.rm_clock.dots) != (
                    want_val, rc.add_clock.dots, rc.rm_clock.dots):
                raise AssertionError(f"read {i} of object {pobj[i]} != the scalar ReadCtx")
        rep["parity_s"] = time.perf_counter() - t0
        log(f"  {READ_PARITY} ORSWOT reads ({int((pmember >= 0).sum())} contains probes, "
            f"{int(frame.val[pmember >= 0].sum())} hits) == the scalar ReadCtx loop "
            f"({rep['parity_s']:.1f} s)")

        # the auditor: a sampled self-merge through the wire codec and K2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audit = trk.audit(fleet, uni, sample=READ_AUDIT)
        torch.cuda.synchronize()
        rep["audit_s"] = time.perf_counter() - t0
        if not audit.ok or audit.sampled != READ_AUDIT:
            raise AssertionError(f"audit: {audit.violations}, {audit.sampled} sampled")
        k2.check("the auditor's self-merge")
        rep["k2_launches_checked"] = k2.checked

        # capacity, device memory, and GcEngine.due driven by the tracker
        cap = CapacityTracker(device=dev)
        cap.sample(fleet)
        cap.sample_gap_buffer(applier)
        mem = cap.sample_device_memory()
        eng = GcEngine(GcPolicy(interval_rounds=8, utilization_trigger="warn"),
                       capacity_tracker=cap)
        wm = cap.watermark()
        fires = wm["state"] != "ok"
        if [eng.due(1), eng.due(8)] != [fires, True]:
            raise AssertionError(f"GcEngine.due against the watermark {wm['state']}")
        obs.set_enabled(False)
        table = obs.table()["orswot_merge"]
        launches = _build.launch_counts()["orswot_merge"]
        if launches == 0 or len(k2.checked) != launches or table["timed"] != launches:
            raise AssertionError(f"the merge kernel launched {launches} times, "
                                 f"{len(k2.checked)} checked, observed {table}")
        rep.update(audit_checks=audit.checks, k2=table, capacity=wm, device_memory=mem,
                   gc_due=[eng.due(1), eng.due(8)], stability=trk.snapshot()["aging"])
        log(f"  audit of {READ_AUDIT} rows: 0 violations in {rep['audit_s']:.3f} s, the merge "
            f"kernel {launches} launch(es) ({table['device_ms_total']:.3f} ms on the card, "
            f"{len(k2.checked)} bit-equal to merge_reference); capacity {wm['state']} (live_max "
            f"{wm['planes']['orswot']['live_max']}), device memory {mem}; GcEngine.due "
            f"{rep['gc_due']} [{card}]")
        rep["kinds"] = read_kinds(dev, rng, card)
    rep["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"  peak device memory {rep['peak_memory_gb']:.2f} GB; phase 11 {rep['phase_s']:.1f} s "
        f"[{card}]")
    print("reads " + json.dumps(rep, default=lambda x: x.tolist() if hasattr(x, "tolist")
                                else str(x)), flush=True)
    return launches, fleet


# -- phase 12 ------------------------------------------------------------------

# cluster transport: phase 11's replica P against a copy, each diverged on
# its own seeded 1% of the rows, reconciled by two flat sessions over
# loopback TCP through the ARQ (bench.py::bench_sync's policy: 30 s
# deadlines, 0.1 s first timer, 2 s backoff cap, a budget of 256, window
# 16) with 2% of each fault kind injected under it on both sides; the dial
# goes through a flapping dialer that refuses twice, which takes the peer
# to suspect in a roster that suspects after 2 failures
CLUSTER_FAULTS = dict(drop=0.02, duplicate=0.02, truncate=0.02, delay=0.02)
CLUSTER_POLICY = dict(send_deadline_s=30.0, recv_deadline_s=30.0, ack_timeout_s=0.1,
                      max_backoff_s=2.0, retry_budget=256, window=16)
CLUSTER_DIAL = (False, False, True)
CLUSTER_JOIN_S = 180.0


class SocketCount:
    """A transport that counts the frames and bytes it puts on its socket
    (each frame's 4-byte length prefix included): under the fault
    injector, so retransmits and injected duplicates count and drops do
    not."""

    def __init__(self, inner):
        self.inner, self.frames, self.bytes = inner, 0, 0

    def send(self, frame):
        self.inner.send(frame)
        self.frames += 1
        self.bytes += 4 + len(frame)

    def recv(self, timeout=None):
        return self.inner.recv(timeout)

    def close(self):
        self.inner.close()


def dial_through_roster(card: str):
    """Step 2 of phase 12: a listener on 127.0.0.1:0 and a dial to it
    through ``FlappingDialer(schedule=CLUSTER_DIAL)``, each attempt
    recorded in a ``Membership(suspect_after=2)``.  Returns both connected
    sockets, the roster, the refusals' ``cluster.peer_state`` events and
    the flight recorder's last sequence number before the dial."""
    import socket

    from crdt_tpu_torch.cluster import FlappingDialer, Membership, SUSPECT
    from crdt_tpu_torch.error import PeerUnavailableError
    from crdt_tpu_torch.obs import convergence, events

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(30.0)
    roster = Membership(suspect_after=2, tracker=convergence.ConvergenceTracker())
    roster.add("q", address=srv.getsockname())
    dialer = FlappingDialer(lambda peer: socket.create_connection(peer.address, timeout=30.0),
                            CLUSTER_DIAL)
    before = events.recorder().snapshot()
    mark = before[-1]["seq"] if before else 0
    sock = None
    for _ in CLUSTER_DIAL:
        try:
            sock = dialer(roster.get("q"))
        except PeerUnavailableError:
            roster.record_failure("q")
            continue
        break
    conn, _ = srv.accept()
    srv.close()
    if sock is None or dialer.refused != 2 or roster.get("q").state != SUSPECT:
        raise AssertionError(f"the flapping dial: {dialer.refused} refused, roster "
                             f"{roster.snapshot()}")
    for x in (sock, conn):  # a frame-at-a-time link: no Nagle delay on the acks
        x.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    refusals = [e["fields"] for e in events.recorder().snapshot("cluster.peer_state")
                if e["seq"] > mark and e["fields"]["peer"] == "q"]
    log(f"  dial: {dialer.refused} refusals, then connected; roster {roster.snapshot()['q']} "
        f"[{card}]")
    return sock, conn, roster, refusals, mark


def cluster_sessions(sa, sb, ra, rb):
    """Run ``sa`` over ``ra`` here and ``sb`` over ``rb`` on a thread.
    Whichever finishes first lingers on its link until the other has
    returned (``cluster.linger``); then each side closes its own end.  Returns both reports, the seconds
    of the syncs and of the whole exchange with the closes, and each
    link's ``counts()`` when its session returned."""
    import threading

    from crdt_tpu_torch.cluster import linger

    out, err, done = {}, [], threading.Event()
    t0 = time.perf_counter()

    def run_b():
        try:
            out["b"] = sb.sync(rb)
            out["b_s"], out["b_counts"] = time.perf_counter() - t0, rb.counts()
            linger(rb, done.is_set, CLUSTER_JOIN_S)
            rb.close()
        except BaseException as e:  # re-raised in the caller's thread
            err.append(e)

    t = threading.Thread(target=run_b, name="phase12-q", daemon=True)
    t.start()
    try:
        out["a"] = sa.sync(ra)
        out["a_s"], out["a_counts"] = time.perf_counter() - t0, ra.counts()
    finally:
        done.set()
        linger(ra, lambda: not t.is_alive(), CLUSTER_JOIN_S)
        t.join(timeout=CLUSTER_JOIN_S)
        ra.close()
    if t.is_alive():
        raise AssertionError("the peer session over TCP hung")
    if err:
        raise err[0]
    return (out["a"], out["b"], max(out["a_s"], out["b_s"]), time.perf_counter() - t0,
            (out["a_counts"], out["b_counts"]))


def cluster_phase(dev, card: str, fleet):
    """Phase 12: phase 11's replica P and a copy, each diverged on its own
    1% of the rows, reconciled over loopback TCP by two flat sessions
    through ``ResilientTransport(FaultyTransport(TcpTransport))`` with
    faults injected on both sides (A=64, M=16, D=2, u32).  Returns the
    merge kernel's launches on the phase's path (the sessions' applies)
    and the reconciled replica P, which phase 13 gossips."""
    import torch

    from crdt_tpu_torch import CrdtConfig, SyncSession, Universe, _build, kernel_observatory
    from crdt_tpu_torch.cluster import ALIVE, FaultPlan, FaultyTransport, ResilientTransport
    from crdt_tpu_torch.cluster import RetryPolicy, TcpTransport
    from crdt_tpu_torch.obs import events

    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=A, member_capacity=M,
                                                   deferred_capacity=D))
    rng = np.random.RandomState(SEED + 12)
    t_phase = time.perf_counter()
    rep = {"card": card, "objects": N_TOTAL, "shape": [A, M, D], "divergence": SYNC_DIV,
           "fleet": "phase 11's replica P as it stands", "faults": CLUSTER_FAULTS, "policy": CLUSTER_POLICY}
    torch.cuda.reset_peak_memory_stats()
    with K2Launches() as k2:
        # 1. the second replica: P as phase 11 left it (its op writes leave
        # member slots out of ascending-id order) and its copy Q each take
        # their own adds
        p, rows_p = diverge(fleet, rng, 1, 1 << 20, dev)
        q, rows_q = diverge(fleet, rng, 0, 1 << 21, dev)
        del fleet
        planted = np.union1d(rows_p, rows_q)
        rep["full_state_bytes"], rep["full_state_encode_s"] = full_state_bytes(p, uni)
        torch.cuda.synchronize()
        rep["build_s"] = time.perf_counter() - t_phase
        log(f"  replicas: P and Q = P, {len(rows_p)} + {len(rows_q)} rows diverged by one add "
            f"each ({len(planted)} distinct); full state {rep['full_state_bytes']} B")

        # 2. the link, dialed through the roster
        sock, conn, roster, refusals, mark = dial_through_roster(card)
        ends, taps = [], []
        for k, (x, name) in enumerate(((sock, "p"), (conn, "q"))):
            wire = SocketCount(TcpTransport(x, default_timeout=60.0))
            faulty = FaultyTransport(wire, FaultPlan(seed=SEED + 120 + k, **CLUSTER_FAULTS),
                                     name=f"faulty-{name}")
            ends.append(ResilientTransport(faulty, RetryPolicy(**CLUSTER_POLICY), name=name,
                                           seed=SEED + 122 + k))
            taps.append((wire, faulty))

        # 3. the sessions: v4, flat, streaming at the negotiated window
        obs = kernel_observatory()
        obs.reset()
        sa = SyncSession(p, uni, full_state_bytes=rep["full_state_bytes"], peer="q")
        sb = SyncSession(q, uni, full_state_bytes=rep["full_state_bytes"], peer="p")
        _build.reset_launch_counts()
        obs.set_enabled(True)
        try:
            ra, rb, sync_s, link_s, at_sync = cluster_sessions(sa, sb, *ends)
            torch.cuda.synchronize()
        finally:
            obs.set_enabled(False)
        launches = _build.launch_counts()["orswot_merge"]
        table = obs.table()["orswot_merge"]
        if ra.converged and rb.converged:
            roster.record_success("q")
        transitions = refusals + [e["fields"] for e in events.recorder().snapshot(
            "cluster.peer_state") if e["seq"] > mark and e["fields"]["peer"] == "q"
            and e["fields"] not in refusals]
        if [(e["old"], e["new"]) for e in transitions] != [("alive", "suspect"),
                                                           ("suspect", "alive")] \
                or roster.get("q").state != ALIVE:
            raise AssertionError(f"the peer's transitions {transitions}")

        # 4. the checks: phase 10's, streaming at window 16, the faults and
        # their recovery, every merge-kernel launch against merge_reference
        for r, what in ((ra, "P"), (rb, "Q")):
            if not (r.streaming and r.window == CLUSTER_POLICY["window"]):
                raise AssertionError(f"session {what} over TCP: streaming {r.streaming}, "
                                     f"window {r.window}")
        if launches == 0 or len(k2.seen) != launches:
            raise AssertionError(f"the merge kernel launched {launches} times in the sessions, "
                                 f"{len(k2.seen)} captured")
        session_checks(p, q, sa, sb, (ra, rb), planted, uni, rng, k2, card, self_merge=True)
        injected = {kind: sum(f.injected[kind] for _, f in taps) for kind in CLUSTER_FAULTS}
        counts = [e.counts() for e in ends]
        recovered = {k: sum(c[k] for c in counts) for k in ("retransmits", "duplicates",
                                                            "corrupt")}
        if not all(injected.values()) or not all(recovered.values()):
            raise AssertionError(f"injected {injected}, recovered {recovered}")
        rep["k2_launches_checked"] = len(k2.checked)
    rep.update(
        sync_s=sync_s, link_s=link_s, k2_launches=launches,
        k2_device_ms=table["device_ms_total"], k2_timed=table["timed"],
        delta_ratio=max(r.delta_ratio(rep["full_state_bytes"]) for r in (ra, rb)),
        transitions=transitions, roster=roster.snapshot(), injected_total=injected,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    for side, r, end, (wire, faulty), synced in (("p", ra, ends[0], taps[0], at_sync[0]),
                                                  ("q", rb, ends[1], taps[1], at_sync[1])):
        prof = r.profile
        rep[side] = {
            "wall_s": prof.wall_ns / 1e9,
            "split_s": {c: getattr(prof, f"{c}_ns") / 1e9
                        for c in ("serialize", "network", "kernel", "other", "unaccounted")},
            "bytes": {k: getattr(r, f"{k}_bytes_sent") for k in ("hello", "digest", "delta",
                                                                  "full")},
            "delta_chunks": r.delta_chunks_sent, "diverged": r.diverged,
            "socket_frames": wire.frames, "socket_bytes": wire.bytes,
            "counts": synced, "counts_closed": end.counts(), "rtt": end.rtt.snapshot(),
            "rto_s": end.current_rto(), "injected": faulty.injected}
        split = {c: round(v, 4) for c, v in rep[side]["split_s"].items()}
        log(f"  session {side} over TCP: {rep[side]['wall_s']:.3f} s wall ({split}); "
            f"{r.delta_chunks_sent} delta chunks; on the socket {wire.frames} frames, "
            f"{wire.bytes} B; ARQ {synced}; srtt {rep[side]['rtt']['srtt_s']} s over "
            f"{rep[side]['rtt']['samples']} samples, RTO {end.current_rto():.4f} s; injected "
            f"{faulty.injected} [{card}]")
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"  sessions over TCP {sync_s:.3f} s (with the serve and close {link_s:.3f} s); the merge "
        f"kernel {launches} launches, {table['device_ms_total']:.3f} ms on the device "
        f"(observatory), each bit-equal to merge_reference; peer q {transitions[0]['old']} -> "
        f"{transitions[0]['new']} -> {transitions[1]['new']}; peak device memory "
        f"{rep['peak_memory_gb']:.2f} GB; phase 12 {rep['phase_s']:.1f} s [{card}]")
    print("cluster " + json.dumps(rep), flush=True)
    return launches, sa.batch


# -- phase 13 ------------------------------------------------------------------

# the gossip fleet: three ClusterNodes on the card, each a 1.25M-object
# replica (phase 12's P and two copies) with the digest tree, its own lag,
# stability and heat trackers, a loopback TCP listener accepting through
# ResilientTransport(TcpTransport) at window 16 (no faults) and a
# GossipScheduler(fanout=2, seed=i) over a roster of the other two.  Rounds
# run the three schedulers in turn; before each of the first
# GOSSIP_WRITE_ROUNDS rounds every node takes GOSSIP_WRITES // 3 writes of
# phase 11's key stream (writer actor i + 1), minted on the main thread by
# derive_add_ctx(node.write_clock()) and submit_ops.  Members are 200 to
# 200 + GOSSIP_MEMBERS - 1: after phases 10-12 a row holds up to 10 members
# (4 of its own, 4 of phase 11's writes, 2 of phase 12's), and the stream's
# Zipf-hot rows take writes of every member, so 16 members would overflow
# M=16.  A reader thread serves GOSSIP_READ_B-row batches through
# serve_frames on the nodes in turn, GOSSIP_FRAMES_PER_CALL frames a call,
# GOSSIP_READ_PAUSE_S apart: an offered load, not a closed loop (a reader
# that never pauses holds the interpreter's lock for most of a round, and
# the sessions' digests, dispatched op by op from Python, then run at half
# their speed: the phase took 83.2 s so on an H100).
GOSSIP_NODES, GOSSIP_WRITES, GOSSIP_WRITE_ROUNDS, GOSSIP_MAX_ROUNDS = 3, 16_384, 2, 8
GOSSIP_MEMBER0, GOSSIP_MEMBERS = 200, 4
GOSSIP_READ_B, GOSSIP_FRAMES_PER_CALL, GOSSIP_PARK_S, GOSSIP_RYW_ROWS = 8192, 4, 10.0, 6144
GOSSIP_READ_PAUSE_S = 0.2
# one batch in 8 under each mode of this cycle (index: batch number mod 8)
GOSSIP_MODES = ("frontier", "ryw", "monotonic", "eventual", "ryw", "monotonic", "eventual",
                "ryw")
GOSSIP_POLICY = dict(send_deadline_s=60.0, recv_deadline_s=60.0, ack_timeout_s=0.1,
                     max_backoff_s=2.0, retry_budget=256, window=16)
GOSSIP_BUSY_S, GOSSIP_JOIN_S = 30.0, 180.0


class GossipMember:
    """One node of the phase 13 and 14 fleets: the ``ClusterNode`` (with
    ``node_kw``, e.g. ``durability=``), a listener on 127.0.0.1:0 whose
    accepted links run the acceptor's leg through
    ``ResilientTransport(TcpTransport)``, a dialer of the same stack and
    the node's scheduler.  Accepted sessions land in ``inbound`` as
    ``(peer, report or exception, wall seconds)``."""

    def __init__(self, i: int, batch, uni, **node_kw):
        import socket
        import threading

        from crdt_tpu_torch.cluster import ClusterNode

        self.i, self.name = i, f"n{i}"
        self.node = ClusterNode(self.name, batch, uni, digest_tree=True,
                                busy_timeout_s=GOSSIP_BUSY_S, **node_kw)
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.srv.settimeout(0.2)
        self.stop = threading.Event()
        self.inbound, self.threads, self.links = [], [], 0
        self.listener = threading.Thread(target=self._listen, name=f"listen-{self.name}",
                                         daemon=True)
        self.listener.start()

    def link(self, sock):
        import socket

        from crdt_tpu_torch.cluster import ResilientTransport, RetryPolicy, TcpTransport

        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.links += 1
        return ResilientTransport(TcpTransport(sock, default_timeout=60.0),
                                  RetryPolicy(**GOSSIP_POLICY), name=self.name,
                                  seed=SEED + 130 + 100 * self.i + self.links)

    def _listen(self):
        import socket
        import threading

        while not self.stop.is_set():
            try:
                sock, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(sock,), daemon=True,
                                 name=f"accept-{self.name}")
            self.threads.append(t)
            t.start()

    def _serve(self, sock):
        from crdt_tpu_torch.cluster import hello_accept

        link = self.link(sock)
        peer, t0 = "?", time.perf_counter()
        try:
            peer = hello_accept(link, timeout=30.0)
            self.inbound.append((peer, self.node.accept(link, peer_id=peer),
                                 time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 - recorded, and the phase fails on it
            self.inbound.append((peer, e, time.perf_counter() - t0))
        finally:
            link.close()

    def scheduler(self, fleet, fanout: int = 2):
        import socket

        from crdt_tpu_torch.cluster import GossipScheduler, Membership, hello_dial
        from crdt_tpu_torch.error import PeerUnavailableError

        roster = Membership()
        for other in fleet:
            if other is not None and other is not self:
                roster.add(other.name, address=other.srv.getsockname())

        def dial(peer):
            try:
                sock = socket.create_connection(peer.address, timeout=10.0)
            except OSError as e:
                raise PeerUnavailableError(f"dial {peer.peer_id}: {e}") from e
            link = self.link(sock)
            hello_dial(link, self.name)
            return link

        self.sched = GossipScheduler(self.node, roster, dial, fanout=fanout,
                                     session_timeout_s=GOSSIP_JOIN_S, seed=self.i)

    def close(self):
        self.stop.set()
        self.listener.join(timeout=GOSSIP_JOIN_S)
        for t in self.threads:
            t.join(timeout=GOSSIP_JOIN_S)
        self.srv.close()
        if self.listener.is_alive() or any(t.is_alive() for t in self.threads):
            raise AssertionError(f"{self.name}: a listener or an accepted session hung")


class GossipReader:
    """The phase 13 reader: a thread serving read frames through
    ``serve_frames`` (overlapped) on the nodes in turn until stopped.
    ``acks[i]`` is node i's ``(write_vv, written objects, members)`` after
    its last acknowledged writes, set by the main thread; RYW batches
    carry that floor and probe up to ``GOSSIP_RYW_ROWS`` of those writes,
    which must read as members; monotonic batches carry the token of the
    node's last frame."""

    def __init__(self, members, robj, rmember):
        import threading

        self.members, self.robj, self.rmember = members, robj, rmember
        self.acks = [None] * len(members)
        self.tokens = [None] * len(members)
        self.stop = threading.Event()
        self.errors, self.calls = [], []
        self.batches = self.ryw_checked = 0
        self.thread = threading.Thread(target=self._run, name="gossip-reader", daemon=True)

    def _request(self, k: int, b: int):
        from crdt_tpu_torch.serve import ReadRequest

        n = self.robj.size // GOSSIP_READ_B
        sl = slice((b % n) * GOSSIP_READ_B, (b % n + 1) * GOSSIP_READ_B)
        obj, member = self.robj[sl].copy(), self.rmember[sl].copy()
        mode, require, probe = GOSSIP_MODES[b % len(GOSSIP_MODES)], None, 0
        if mode == "ryw" and self.acks[k] is not None:
            require, wobj, wmem = self.acks[k]
            probe = min(GOSSIP_RYW_ROWS, wobj.size)
            obj[:probe], member[:probe] = wobj[-probe:], wmem[-probe:]
        elif mode == "ryw":
            mode = "eventual"  # no write acknowledged on this node yet
        if mode == "monotonic":
            require = self.tokens[k] if self.tokens[k] is not None \
                else self.members[k].node.read_token()
        return ReadRequest.reads(obj, member=member, mode=mode, require=require), probe

    def _run(self):
        from crdt_tpu_torch.serve import decode_result_frame, encode_read_request

        call = 0
        try:
            while not self.stop.is_set():
                k = call % len(self.members)
                reqs = [self._request(k, self.batches + j) for j in range(GOSSIP_FRAMES_PER_CALL)]
                self.batches += len(reqs)
                loop = self.members[k].node.serve_loop()
                out, stats = loop.serve_frames([encode_read_request(r) for r, _ in reqs])
                self.calls.append(stats)
                for (req, probe), frame in zip(reqs, out):
                    if frame is None:
                        continue
                    res = decode_result_frame(frame)
                    if req.mode != "frontier":
                        self.tokens[k] = res.token
                    if probe and not (res.val[:probe] == 1).all():
                        raise AssertionError(
                            f"n{k}: a read-your-writes read missed "
                            f"{int((res.val[:probe] != 1).sum())} acknowledged writes")
                    self.ryw_checked += probe
                call += 1
                self.stop.wait(GOSSIP_READ_PAUSE_S)
        except BaseException as e:  # re-raised in the main thread
            self.errors.append(e)


def gossip_writes(member, wobj, rng, kept):
    """Mint ``GOSSIP_WRITES // GOSSIP_NODES`` adds on ``member``'s node from
    the write stream (actor i + 1) and submit them; returns their seconds."""
    import torch

    from crdt_tpu_torch.oplog import derive_add_ctx

    node, i = member.node, member.i
    k = GOSSIP_WRITES // GOSSIP_NODES
    obj = wobj[:k]
    mem = (GOSSIP_MEMBER0 + rng.randint(0, GOSSIP_MEMBERS, k)).astype(np.int32)
    torch.cuda.empty_cache()  # the fold's whole-fleet temporaries want contiguous room
    t0 = time.perf_counter()
    ops, _ = derive_add_ctx(node.write_clock(), obj, np.full(k, i + 1, np.int32), member=mem)
    node.submit_ops(ops)
    ack = node.write_vv()
    secs = time.perf_counter() - t0
    kept[i].append(ops)
    return secs, ack, obj, mem


def gossip_round(fleet, r: int) -> dict:
    """One fleet round: each scheduler's ``run_round`` in turn.  Returns the
    round's record: wall seconds, each session leg's report (dialed and
    accepted), each scheduler's health view, the failed legs, and the
    refusals by a node's busy bound with the failures they caused (a
    refused dial's other leg fails with a transport error; that is the
    bound's designed behaviour, counted apart)."""
    from crdt_tpu_torch.obs import events

    marks = [len(m.inbound) for m in fleet]
    t0 = time.perf_counter()
    reports, failed, busy, health = [], [], set(), {}
    for m in fleet:
        seen = events.recorder().snapshot()
        mark = seen[-1]["seq"] if seen else 0
        rep = m.sched.run_round()
        health[m.name] = rep.health
        reports += [(m.name, peer, "dial", x) for peer, x in rep.reports.items()]
        for e in events.recorder().snapshot("cluster.session"):
            f = e["fields"]
            if e["seq"] > mark and f["outcome"] == "failed":
                failed.append((m.name, f["peer"], "dial", f["error"]))
    wall = time.perf_counter() - t0
    for m, mark in zip(fleet, marks):
        for peer, res, _ in m.inbound[mark:]:
            if isinstance(res, BaseException):
                failed.append((peer, m.name, "accept", f"{type(res).__name__}: {res}"))
            else:
                reports.append((m.name, peer, "accept", res))
    for dialer, acceptor, _, err in failed:
        if "busy with another session" in err:
            busy.add((dialer, acceptor))
    refused = [f for f in failed if (f[0], f[1]) in busy]
    return {"round": r, "wall_s": wall, "reports": reports, "health": health,
            "failed": [f for f in failed if (f[0], f[1]) not in busy], "busy": refused,
            "diverged": sum(x[3].diverged for x in reports)}


def gossip_checks(fleet, start_host, kept, written, k2, dev, card: str):
    """Phase 13's plane checks: the rows no write touched equal the starting
    replica on every node, bit for bit; every node's batch, self-merged,
    equals the first node's, which equals the merge kernel's join of the
    starting replica with each node's kept op batches applied by
    ``OpApplier`` (the three nodes start from one replica).  The join is
    built after the nodes are dropped (three replicas, the start, the join
    and an op fold's whole-fleet temporaries do not fit the card at once).
    Each merge-kernel launch is held against ``merge_reference``.  Closes
    the fleet."""
    import torch

    from crdt_tpu_torch import OrswotBatch
    from crdt_tpu_torch.oplog import OpApplier, OpBatch

    uni = fleet[0].node.universe
    kept_rows = np.ones(N_TOTAL, bool)
    kept_rows[np.unique(written)] = False
    batches = [m.node.batch for m in fleet]
    for lo in range(0, N_TOTAL, CHUNK):
        rows = torch.from_numpy(kept_rows[lo:lo + CHUNK]).to(dev)
        for name in PLANES:
            ref = start_host[name][lo:lo + CHUNK].to(dev)[rows]
            for m, batch in zip(fleet, batches):
                if not torch.equal(getattr(batch, name)[lo:lo + CHUNK][rows], ref):
                    raise AssertionError(f"{m.name}: {name} changed on a row no write touched")
    del batches
    merged = None
    for m in fleet:
        batch = m.node.batch
        own = batch.merge(batch)
        k2.check("a node's self-merge")
        if merged is None:
            merged = own
        else:
            same_planes(own, merged, f"{m.name} self-merged against {fleet[0].name} self-merged")
        del own, batch
    for m in fleet:
        m.close()
    fleet.clear()
    gc.collect()  # the members' scheduler and dialer refer to each other
    torch.cuda.empty_cache()
    start = OrswotBatch(*(start_host[k].to(dev) for k in PLANES))
    join = None
    for ops in kept:
        applied, _ = OpApplier(uni).apply_ops(start, OpBatch.concat(ops))
        join = applied if join is None else join.merge(applied)
        k2.check("the oracle's join")
        del applied
        torch.cuda.empty_cache()
    same_planes(merged, join, "the nodes self-merged against the merge kernel's join of the "
                "starting replica and every node's writes")
    log(f"  every node self-merged == K2's join of the start and the {len(kept)} nodes' op "
        f"batches; the {int(kept_rows.sum())} rows no write touched == the start, on every "
        f"node [{card}]")


def gossip_phase(dev, card: str, start):
    """Phase 13: three ``ClusterNode``s on the card (phase 12's replica P
    and two copies) gossip by their schedulers over loopback TCP while they
    take writes and a reader thread serves reads, until the nodes' digests
    agree and a whole round finds no divergence.  Returns the merge
    kernel's launches on the phase's path (the sessions' applies and the
    auditor's self-merges)."""
    import torch

    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe, _build, kernel_observatory
    from crdt_tpu_torch.serve import ReadRequest, encode_read_request, visible_vv

    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 13)
    rep = {"card": card, "objects": N_TOTAL, "shape": [A, M, D], "nodes": GOSSIP_NODES,
           "fleet": "phase 12's replica P and two copies", "policy": GOSSIP_POLICY,
           "writes_per_round": GOSSIP_WRITES, "write_rounds": GOSSIP_WRITE_ROUNDS,
           "members": [GOSSIP_MEMBER0, GOSSIP_MEMBER0 + GOSSIP_MEMBERS - 1],
           "read_batch": GOSSIP_READ_B, "read_pause_s": GOSSIP_READ_PAUSE_S,
           "park_timeout_s": GOSSIP_PARK_S}
    torch.cuda.reset_peak_memory_stats()
    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=A, member_capacity=M,
                                                   deferred_capacity=D))
    robj, rmember, wobj = read_traffic(rng)
    # the start stays on the host for the checks: n0 holds its planes only
    # until its first fold replaces them
    start_host = {k: getattr(start, k).cpu() for k in PLANES}
    fleet, kept, written, rounds, write_s = [], [[] for _ in range(GOSSIP_NODES)], [], [], 0.0
    with K2Launches() as k2:
        try:
            for i in range(GOSSIP_NODES):
                batch = start if i == 0 else OrswotBatch(*(getattr(start, k).clone()
                                                           for k in PLANES))
                fleet.append(GossipMember(i, batch, uni))
            del start, batch
            for m in fleet:
                m.scheduler(fleet)
                m.node.serve_loop().park_timeout_s = GOSSIP_PARK_S
            torch.cuda.synchronize()
            rep["build_s"] = time.perf_counter() - t_phase
            reader = GossipReader(fleet, robj, rmember)
            obs = kernel_observatory()
            obs.reset()
            _build.reset_launch_counts()
            obs.set_enabled(True)
            t_rounds = time.perf_counter()
            reader.thread.start()
            try:
                for r in range(1, GOSSIP_MAX_ROUNDS + 1):
                    for m in fleet[:GOSSIP_NODES if r <= GOSSIP_WRITE_ROUNDS else 0]:
                        k = GOSSIP_WRITES // GOSSIP_NODES
                        off = ((r - 1) * GOSSIP_NODES + m.i) * k
                        secs, ack, obj, mem = gossip_writes(m, wobj[off:off + k], rng, kept)
                        write_s += secs
                        written.append(obj)
                        prev = reader.acks[m.i]
                        reader.acks[m.i] = (ack, obj, mem) if prev is None else (
                            ack, np.concatenate([prev[1], obj]), np.concatenate([prev[2], mem]))
                    x = gossip_round(fleet, r)
                    # the digests decide only a round that can end the phase
                    x["digests_equal"] = None
                    if x["diverged"] == 0 and r > GOSSIP_WRITE_ROUNDS:
                        digests = [m.node.digest() for m in fleet]
                        x["digests_equal"] = all(np.array_equal(d, digests[0])
                                                 for d in digests[1:])
                    x["allocated_gb"] = torch.cuda.memory_allocated() / 1e9
                    rounds.append(x)
                    legs = [(a, b, c, y.diverged, round(y.profile.wall_ns / 1e9, 3),
                             round(y.profile.kernel_ns / 1e9, 3),
                             round(y.profile.network_ns / 1e9, 3))
                            for a, b, c, y in x["reports"]]
                    equal = "not compared" if x["digests_equal"] is None else x["digests_equal"]
                    log(f"  round {r}: {x['wall_s']:.3f} s, {len(x['reports'])} session legs ok, "
                        f"{len(x['failed'])} failed, {len(x['busy'])} refused by a busy bound; "
                        f"diverged rows found {x['diverged']}; digests equal: {equal}; "
                        f"{x['allocated_gb']:.2f} GB allocated; legs (node, peer, leg, diverged, "
                        f"wall s, kernel s, network s): {legs} [{card}]")
                    if x["failed"]:
                        raise AssertionError(f"round {r}: failed session legs {x['failed']}")
                    if x["digests_equal"]:
                        break
            finally:
                reader.stop.set()
                reader.thread.join(timeout=GOSSIP_JOIN_S)
            torch.cuda.synchronize()
            rounds_s = time.perf_counter() - t_rounds
            obs.set_enabled(False)
            launches = _build.launch_counts()["orswot_merge"]
            table = obs.table()["orswot_merge"]
            if reader.thread.is_alive():
                raise AssertionError("the reader thread hung")
            if reader.errors:
                raise reader.errors[0]
            if not rounds[-1]["digests_equal"]:
                raise AssertionError(f"no convergence in {len(rounds)} rounds")
            if launches == 0 or len(k2.seen) != launches:
                raise AssertionError(f"the merge kernel launched {launches} times in the phase, "
                                     f"{len(k2.seen)} captured")
            k2.check("phase 13's session applies and audits")
            rep["k2_launches_checked"] = len(k2.checked)

            counts = [m.node.serve_loop().counts() for m in fleet]
            modes = ("eventual", "ryw", "monotonic", "frontier")
            rejected = {md: sum(c["reject"].get(md, 0) for c in counts) for md in modes}
            parked = {md: sum(c["park"].get(md, 0) for c in counts) for md in modes}
            if rejected["ryw"] or rejected["monotonic"]:
                raise AssertionError(f"read-your-writes or monotonic reads rejected: {rejected}")
            if not reader.ryw_checked:
                raise AssertionError("no read-your-writes read probed an acknowledged write")
            req = encode_read_request(ReadRequest.reads(robj[:GOSSIP_READ_B],
                                                        member=rmember[:GOSSIP_READ_B]))
            frames = [m.node.serve_loop().serve_frames([req])[0][0] for m in fleet]
            if any(f is None or f != frames[0] for f in frames):
                raise AssertionError("one eventual request: the nodes' result frames differ")
            log(f"  after convergence one eventual request frame gives {len(frames[0])}-byte "
                f"result frames, byte-equal on the {len(fleet)} nodes")
            # visible_vv: no memo, so every serve and every parked poll pays it
            vv_ms = [timed_ms(lambda: visible_vv(fleet[0].node.batch))[1:] for _ in range(10)]
            rep["visible_vv_ms"] = {"device": sum(v[0] for v in vv_ms) / 10,
                                    "wall": sum(v[1] for v in vv_ms) / 10,
                                    "bound": N_TOTAL * A * 4 / HBM_BYTES_PER_S * 1e3}
            log(f"  visible_vv on one node: {rep['visible_vv_ms']['device']:.4f} ms on the device, "
                f"{rep['visible_vv_ms']['wall']:.4f} ms wall (mean of 10; bytes bound "
                f"{rep['visible_vv_ms']['bound']:.4f} ms) [{card}]")
            rep["scheduler_counts"] = {m.name: m.sched.counts() for m in fleet}
            gossip_checks(fleet, start_host, kept, np.concatenate(written), k2, dev, card)
        finally:
            for m in fleet:
                m.close()

    calls = reader.calls
    rows = sum(c["rows"] for c in calls)
    e2e = sum(c["e2e_s"] for c in calls)
    stage = {k: sum(c["stage_s"][k] for c in calls) for k in ("decode", "serve", "encode")}
    sessions = [{"round": x["round"], "node": node, "peer": peer, "leg": leg,
                 "diverged": r.diverged, "tree": r.tree_mode, "wall_s": r.profile.wall_ns / 1e9,
                 "split_s": {c: getattr(r.profile, f"{c}_ns") / 1e9 for c in
                             ("serialize", "network", "kernel", "other", "unaccounted")},
                 "bytes_sent": r.bytes_sent}
                for x in rounds for node, peer, leg, r in x["reports"]]
    n_writes = int(sum(o.size for o in written))
    rep.update(
        rounds=len(rounds), rounds_s=rounds_s, round_wall_s=[x["wall_s"] for x in rounds],
        sessions_ok=[len(x["reports"]) for x in rounds],
        sessions_failed=[len(x["failed"]) for x in rounds],
        busy_refused=[len(x["busy"]) for x in rounds],
        busy_refusals=[f for x in rounds for f in x["busy"]],
        diverged_per_round=[x["diverged"] for x in rounds],
        health=[x["health"] for x in rounds], sessions=sessions,
        k2_launches=launches, k2_device_ms=table["device_ms_total"], k2_timed=table["timed"],
        writes=n_writes, write_s=write_s, writes_per_s=n_writes / write_s,
        reads=rows, read_calls=len(calls), read_batches=reader.batches,
        reads_per_s=rows / e2e if e2e else None, read_e2e_s=e2e, read_stage_s=stage,
        ryw_probed=reader.ryw_checked, parked=parked, rejected=rejected,
        park_wait_s=sum(c["park_wait_s"] for c in counts),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    rep["phase_s"] = time.perf_counter() - t_phase
    walls = [round(s["wall_s"], 3) for s in sessions if s["diverged"]]
    log(f"  {len(rounds)} rounds in {rounds_s:.3f} s ({[round(w, 3) for w in rep['round_wall_s']]}"
        f" s); session legs ok per round {rep['sessions_ok']}, failed {rep['sessions_failed']}, "
        f"refused by a busy bound {rep['busy_refused']}; diverged legs' walls {walls} s [{card}]")
    log(f"  writes: {n_writes} acknowledged at {rep['writes_per_s']:.0f}/s (mint + submit); "
        f"reads: {rows} rows in {len(calls)} serve_frames calls at {rep['reads_per_s'] or 0:.0f} "
        f"rows/s end to end, stage_s { {k: round(v, 3) for k, v in stage.items()} }; parked "
        f"{parked}, rejected {rejected}; {reader.ryw_checked} RYW probes of acknowledged writes "
        f"read as members [{card}]")
    log(f"  the merge kernel {launches} launches, {table['device_ms_total']:.3f} ms on the device "
        f"(observatory), each bit-equal to merge_reference; peak device memory "
        f"{rep['peak_memory_gb']:.2f} GB; phase 13 {rep['phase_s']:.1f} s [{card}]")
    print("gossip " + json.dumps(rep, default=lambda x: x.tolist() if hasattr(x, "tolist")
                                 else str(x)), flush=True)
    return launches


# -- phase 14 ------------------------------------------------------------------

# durability: n0 on phase 12's replica P and n1 on a copy, phase 13's members
# (digest tree, loopback TCP through ResilientTransport(TcpTransport), window
# 16, no faults) with GossipScheduler(fanout=1); n1 durable in DURABLE_DIR
# (under the checkout's gitignored build/, on the checkout's filesystem) with
# Durability(interval_rounds=1, retain=2, fsync=True).  Every batch of writes
# is GOSSIP_WRITES // GOSSIP_NODES = 5,461 adds of phase 13's write stream
# (writer actor i + 1, members 200-203).  The WAL probe appends
# DURABLE_PROBE_FRAMES frames of one such batch to a WalWriter of its own.
DURABLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_durable")
DURABLE_MAX_ROUNDS, DURABLE_PROBE_FRAMES = 6, 128
# sha256 of save_bytes of a pinned 16-object batch, as the JAX package and
# the port write it with numpy 2.0.2: the card host's numpy must give the
# same bytes for its snapshots to be the JAX package's
NPZ_PIN = "5880742f84dacbe589c7786cd012c6bc0f9d4e26be0690f3a96676504d14e337"


def host_available() -> int:
    """The host's available memory in bytes (``MemAvailable``), -1 unknown."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return -1


def durable_room() -> tuple:
    """``(free bytes on DURABLE_DIR's filesystem, host available bytes)``."""
    import shutil

    os.makedirs(DURABLE_DIR, exist_ok=True)
    return shutil.disk_usage(DURABLE_DIR).free, host_available()


def npz_pin_matches() -> bool:
    """Whether this host's numpy writes the pinned checkpoint's bytes
    (:data:`NPZ_PIN`), twice alike."""
    import hashlib

    from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
    from crdt_tpu_torch.utils import checkpoint
    from crdt_tpu_torch.utils.testdata import random_orswot_arrays

    uni = Universe.identity(CrdtConfig(num_actors=8, member_capacity=4, deferred_capacity=2,
                                       counter_bits=32))
    batch = OrswotBatch.from_numpy(*random_orswot_arrays(np.random.RandomState(0), 16, 8, 4, 2),
                                   device="cpu")
    blobs = [checkpoint.save_bytes(batch, uni) for _ in range(2)]
    if blobs[0] != blobs[1]:
        raise AssertionError("save_bytes of one batch gave two different byte strings")
    return hashlib.sha256(blobs[0]).hexdigest() == NPZ_PIN


def read_back(batch, writes, what: str) -> int:
    """Every ``(objects, members)`` write reads as a member of ``batch``
    through ``serve.gather``; returns the reads."""
    from crdt_tpu_torch.serve import gather

    n = 0
    for obj, mem in writes:
        val = gather(batch, obj, member=mem).val
        if not (val == 1).all():
            raise AssertionError(f"{what}: {int((val != 1).sum())} of {obj.size} acknowledged "
                                 "writes do not read as members")
        n += obj.size
    return n


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if len(xs) else float("nan")


def schedule(fleet):
    """Each member's ``GossipScheduler(fanout=1)`` over the others."""
    for m in fleet:
        m.scheduler(fleet, fanout=1)


def durable_phase(dev, card: str, start):
    """Phase 14: a durable node on the card takes fsync'd WAL writes,
    checkpoints the 1.25M-object replica at round end, is killed in the
    middle of a fold, is restored from its snapshot and WAL onto the card
    and rejoins its peer by delta sync.  Returns the merge kernel's
    launches on the phase's path (the sessions' applies and audits)."""
    import resource
    import shutil

    import torch

    from crdt_tpu_torch import CrdtConfig, OrswotBatch, StabilityTracker, Universe, _build
    from crdt_tpu_torch.cluster import CrashPlan, InjectedCrash, arm_crashes, disarm_crashes
    from crdt_tpu_torch.durable import Durability, WalWriter, recover
    from crdt_tpu_torch.oplog import derive_add_ctx, encode_ops_frame

    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 14)
    k = GOSSIP_WRITES // GOSSIP_NODES
    replica_bytes = nbytes([getattr(start, f) for f in PLANES])
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    free, avail = durable_room()
    rep = {"card": card, "objects": N_TOTAL, "shape": [A, M, D], "replica_bytes": replica_bytes,
           "fleet": "phase 12's replica P and a copy", "writes_per_batch": k,
           "durability": {"interval_rounds": 1, "retain": 2, "fsync": True},
           "disk_free_bytes": free, "host_available_bytes": avail,
           "numpy": np.__version__, "npz_bytes_match_pin": npz_pin_matches()}
    log(f"  durable directory {DURABLE_DIR}: {free / 1e9:.2f} GB free; host memory available "
        f"{avail / 1e9:.2f} GB; one generation needs ~{replica_bytes / 1e9:.2f} GB [{card}]")
    if free < 1.05 * replica_bytes:
        raise AssertionError(f"the durable directory's filesystem has {free} bytes free, less "
                             f"than one generation ({replica_bytes} bytes of planes); host "
                             f"memory available {avail} bytes")
    torch.cuda.reset_peak_memory_stats()
    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=A, member_capacity=M,
                                                   deferred_capacity=D))
    wobj = read_traffic(rng)[2]
    fleet, kept, acked, rounds, write_s = [], [[], []], [[], []], [], [[], []]
    off = 0

    def writes(m):
        nonlocal off
        secs, _, obj, mem = gossip_writes(m, wobj[off:off + k], rng, kept)
        off += k
        acked[m.i].append((obj, mem))
        write_s[m.i].append(secs)

    def run_round(r, what):
        x = gossip_round(fleet, r)
        legs = [(a, b, c, y.diverged, round(y.profile.wall_ns / 1e9, 3)) for a, b, c, y in
                x["reports"]]
        log(f"  {what} round {r}: {x['wall_s']:.3f} s, legs (node, peer, leg, diverged, wall "
            f"s) {legs}; {len(x['failed'])} failed, {len(x['busy'])} refused by a busy bound "
            f"[{card}]")
        if x["failed"]:
            raise AssertionError(f"{what} round {r}: failed session legs {x['failed']}")
        return x

    with K2Launches() as k2:
        try:
            fleet.append(GossipMember(0, start, uni))
            copy = OrswotBatch(*(getattr(start, f).clone() for f in PLANES))
            del start
            fleet.append(GossipMember(1, copy, uni, durability=Durability(
                DURABLE_DIR, interval_rounds=1, retain=2, fsync=True)))
            del copy
            schedule(fleet)
            torch.cuda.synchronize()
            rep["build_s"] = time.perf_counter() - t_phase
            _build.reset_launch_counts()
            t_path = time.perf_counter()
            # 1. writes on both nodes, n1's WAL-appended before the fold
            writes(fleet[0])
            writes(fleet[1])
            # 2. a round; n1's round end writes generation 1
            for r in (1, 2):
                x = run_round(r, "checkpoint")
                x["phase"] = "checkpoint"
                rounds.append(x)
                if fleet[1].node.last_snapshot is not None:
                    break  # a session racing the round end defers the checkpoint
            snap = fleet[1].node.last_snapshot
            if snap is None or snap.generation != 1:
                raise AssertionError(f"n1 wrote no generation 1 at round end: {snap}")
            ck_digests, ck_root = snap.digests, snap.root
            rep["checkpoint"] = {"generation": snap.generation, "wal_seq": snap.wal_seq,
                                 "bytes": snap.nbytes, "split_s": dict(snap.split_s),
                                 "wall_s": sum(snap.split_s.values())}
            k2_round1 = _build.launch_counts()["orswot_merge"]
            # 3. more writes on n1: WAL frames above generation 1's sequence
            writes(fleet[1])
            # 4. the kill: n1 dies in its fold, after the WAL append
            obj = wobj[off:off + k]
            off += k
            mem = (GOSSIP_MEMBER0 + rng.randint(0, GOSSIP_MEMBERS, k)).astype(np.int32)
            ops = derive_add_ctx(fleet[1].node.write_clock(), obj, np.full(k, 2, np.int32),
                                 member=mem)[0]
            state = arm_crashes(CrashPlan(at={"oplog.fold.n1": 1}))
            try:
                fleet[1].node.submit_ops(ops)
            except InjectedCrash:
                pass
            finally:
                disarm_crashes()
            if state.fired != ["oplog.fold.n1"]:
                raise AssertionError(f"the crash plan fired {state.fired}")
            killed = (obj, mem)
            del ops
            wal = fleet[1].node.durability
            rep["wal"] = {**wal.counts(), **wal.snapshot(),
                          "append_ms": [s * 1e3 for s in wal.wal.append_seconds()]}
            del wal
            # 5. the kill drops every reference to n1: its scheduler, its
            # listener and its node, with no cyclic collection
            k2.check("phase 14's checkpoint round")
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            fleet[1].close()
            fleet[1].sched = None
            fleet[1] = None
            freed = before - torch.cuda.memory_allocated()
            rep["kill_freed_bytes"] = freed
            log(f"  n1 killed in its fold after {rep['wal']['wal_frames']} WAL frames; device "
                f"memory fell {freed / 1e9:.3f} GB (one replica {replica_bytes / 1e9:.3f} GB)")
            if freed < replica_bytes:
                raise AssertionError(f"dropping n1 freed {freed} bytes of device memory, less "
                                     f"than its replica's {replica_bytes}: a reference survives")
            # 6. n0 writes while n1 is down
            writes(fleet[0])
            # 7. restore from the snapshot and the WAL onto the card
            t0 = time.perf_counter()
            rec = recover(DURABLE_DIR, device="cuda")
            torch.cuda.synchronize()
            rep["restore"] = {"wall_s": time.perf_counter() - t0, "split_s": dict(rec.split_s),
                              "report": dataclasses.asdict(rec.report)}
            if rec.report.generation != 1 or not np.array_equal(rec.snapshot_digests,
                                                                 ck_digests):
                raise AssertionError("the restored generation's digests differ from n1's at "
                                     "its checkpoint")
            if rec.report.replayed_ops < 2 * k:
                raise AssertionError(f"the replay folded {rec.report.replayed_ops} ops, fewer "
                                     f"than the {2 * k} WAL'd above the snapshot")
            rep["read_back_before_rejoin"] = read_back(rec.batch, acked[1] + [killed],
                                                       "the recovered n1")
            stability = StabilityTracker()
            if rec.frontier is not None:
                stability.restore(rec.frontier)
            fleet[1] = GossipMember(1, rec.batch, rec.universe, applier=rec.applier,
                                    stability_tracker=stability, durability=Durability(
                                        DURABLE_DIR, interval_rounds=DURABLE_MAX_ROUNDS + 1,
                                        retain=2, fsync=True))
            del rec, stability
            schedule(fleet)
            # 8. the rejoin: rounds until the digests agree and a round finds nothing
            for r in range(1, DURABLE_MAX_ROUNDS + 1):
                x = run_round(r, "rejoin")
                x["phase"], x["digests_equal"] = "rejoin", None
                if x["diverged"] == 0:
                    digests = [m.node.digest() for m in fleet]
                    x["digests_equal"] = np.array_equal(digests[0], digests[1])
                rounds.append(x)
                if x["digests_equal"]:
                    break
            torch.cuda.synchronize()
            rep["path_s"] = time.perf_counter() - t_path
            launches = _build.launch_counts()["orswot_merge"]
            if not rounds[-1]["digests_equal"]:
                raise AssertionError(f"no convergence in {len(rounds)} rounds")
            if launches - k2_round1 == 0:
                raise AssertionError("the rejoin never launched the merge kernel")
            if len(k2.seen) != launches - len(k2.checked):
                raise AssertionError(f"the merge kernel launched {launches} times in the "
                                     f"phase, {len(k2.seen) + len(k2.checked)} captured")
            k2.check("phase 14's rejoin applies")
            rejoin = [y for x in rounds if x["phase"] == "rejoin" for *_, y in x["reports"]]
            if any(y.full_state_fallback or y.full_bytes_sent for y in rejoin):
                raise AssertionError("a rejoin session shipped full state")
            everyone = acked[0] + acked[1] + [killed]
            rep["read_back_after_rejoin"] = sum(read_back(m.node.batch, everyone, m.name)
                                                for m in fleet)
            full, _ = full_state_bytes(fleet[0].node.batch, uni)
            rep["rejoin"] = {
                "rounds": sum(x["phase"] == "rejoin" for x in rounds),
                "leg_wall_s": [y.profile.wall_ns / 1e9 for y in rejoin],
                "diverged": [y.diverged for y in rejoin],
                "delta_bytes": sum(y.delta_bytes_sent for y in rejoin),
                "bytes_sent": sum(y.bytes_sent for y in rejoin),
                "full_state_bytes": full, "k2_launches": launches - k2_round1}
            rep["k2_launches"], rep["k2_launches_checked"] = launches, len(k2.checked)
            # per batch, in order: n0 before the round and while n1 is
            # down; n1 (WAL'd) before the round and after it
            rep["ack_writes_per_s"] = {"n0": [k / s for s in write_s[0]],
                                       "n1_wal": [k / s for s in write_s[1]]}
            # the WAL's append latency with fsync on, on a writer of its own
            probe = WalWriter(os.path.join(DURABLE_DIR, "probe"), fsync=True)
            frame = encode_ops_frame(kept[1][0])
            for _ in range(DURABLE_PROBE_FRAMES):
                probe.append(frame)
            probe.close()
            secs = probe.append_seconds()
            rep["wal_probe"] = {"frames": len(secs), "frame_bytes": len(frame),
                                "append_ms_p50": pct(secs, 50), "append_ms_p99": pct(secs, 99)}
        finally:
            for m in fleet:
                if m is not None:
                    m.close()
            shutil.rmtree(DURABLE_DIR, ignore_errors=True)

    rep.update(peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_host_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
               rounds=[{"phase": x["phase"], "round": x["round"], "wall_s": x["wall_s"],
                        "diverged": x["diverged"]} for x in rounds],
               phase_s=time.perf_counter() - t_phase)
    c, s_ = rep["checkpoint"], rep["restore"]
    log(f"  checkpoint: generation 1, {c['bytes']} bytes on disk in {c['wall_s']:.3f} s "
        f"({ {k_: round(v, 3) for k_, v in c['split_s'].items()} }); restore {s_['wall_s']:.3f} s "
        f"({ {k_: round(v, 3) for k_, v in s_['split_s'].items()} }), replayed "
        f"{s_['report']['replayed_frames']} frames, {s_['report']['replayed_ops']} ops "
        f"[{card}]")
    log(f"  rejoin: {rep['rejoin']['rounds']} rounds, rows diverged {rep['rejoin']['diverged']}, "
        f"{rep['rejoin']['delta_bytes']} delta bytes against {rep['rejoin']['full_state_bytes']} "
        f"of full state; WAL append p50 {rep['wal_probe']['append_ms_p50']:.3f} ms, p99 "
        f"{rep['wal_probe']['append_ms_p99']:.3f} ms; K2 {rep['k2_launches']} launches, each "
        f"equal to merge_reference; peak device memory {rep['peak_memory_gb']:.2f} GB, host RSS "
        f"{rep['peak_host_rss_gb']:.2f} GB; phase 14 {rep['phase_s']:.1f} s [{card}]")
    print("durable " + json.dumps(rep, default=lambda x: x.tolist() if hasattr(x, "tolist")
                                  else str(x)), flush=True)
    return rep["k2_launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from crdt_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: environment")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"  nvcc: {nvcc}")
    free, avail = durable_room()
    log(f"  disk free under {DURABLE_DIR}: {free / 1e9:.2f} GB; host memory available "
        f"{avail / 1e9:.2f} GB")

    log("== phase 2: build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s (per source: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    for name, info in _build.BUILD_LOG.items():
        entry = ""
        for line in info["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '\S*?(orswot_\w*?kernel)(I.*?E)?E", line)
            if m:  # the kernel, and its instantiation's template arguments, e.g. <16,2>
                targs = re.findall(r"Li(\d+)E", m.group(2) or "")
                entry = (f"<{','.join(targs)}>" if targs else "") + (
                    " direct" if "direct" in m.group(1) else "")
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}{entry}]: {line.strip()}")

    log("== phase 3: kernels vs plain versions")
    worst = check_kernels(dev)
    from crdt_tpu_torch.utils.testdata import build_fleet_planes, fleet_columns

    cols = fleet_columns(np.random.RandomState(SEED + 3), CHUNK, A, M, D, R, base=BASE,
                         novel=NOVEL, deferred_frac=DEFERRED_FRAC)
    timed = time_kernels(dev, build_fleet_planes(cols, a=A, m_cap=M, d=D, base=BASE,
                                                 novel=NOVEL, device=dev), worst)
    torch.cuda.empty_cache()
    for name, err in worst.items():
        log(f"  {name}: max abs diff {err} over every check (bit-equal, overflow flags equal)")

    n_chunks = N_TOTAL // CHUNK
    log(f"== phase 4: main path ({n_chunks} chunks of {CHUNK} objects, "
        f"A={A} M={M} D={D} R={R})")
    _build.reset_launch_counts()
    fold_ms = main_path(dev, n_chunks)
    launches = _build.launch_counts()
    for name in REPLACES:
        if launches[name] == 0:
            raise AssertionError(f"main path never launched {name}")
    merges = CHUNK * R
    mean_ms = sum(fold_ms) / len(fold_ms)
    log(f"  fold wall ms per chunk: {[round(t, 3) for t in fold_ms]}")
    log(f"  mean fold {mean_ms:.3f} ms/chunk (first {fold_ms[0]:.3f}), "
        f"{merges / (mean_ms / 1e3) / 1e6:.2f}M merges/s, total fold "
        f"{sum(fold_ms):.1f} ms for {n_chunks * CHUNK} objects; launches {launches} "
        f"[{card}]")

    log("== phase 5: regrow ladder")
    _build.reset_launch_counts()
    stats = regrow_ladder(dev)
    log(f"  overflow_regrows={stats.overflow_regrows} "
        f"final_member_capacity={stats.final_member_capacity} "
        f"joins={stats.joins} launches {_build.launch_counts()}")
    if (stats.overflow_regrows, stats.final_member_capacity) != (2, 8):
        raise AssertionError(f"unexpected regrow ladder: {stats}")

    log("== phase 6: wire leg (blobs -> fold on the card -> blobs)")
    _build.reset_launch_counts()
    wire_k2, chunk_blobs = wire_leg(dev, card)
    wire_launches = _build.launch_counts()
    log(f"  launches {wire_launches} (the merge kernel {wire_k2} by the wire loop; the "
        "union-aligned fold only as the byte oracle)")
    if wire_k2 == 0:
        raise AssertionError("the wire loop never launched the merge kernel")
    torch.cuda.empty_cache()

    log("== phase 6b: from_wire and to_scalar, dense planes against COO columns")
    _build.reset_launch_counts()
    wire_routes(dev, card, chunk_blobs)
    log(f"  launches {_build.launch_counts()}")
    if _build.launch_counts()["orswot_merge"] == 0:
        raise AssertionError("phase 6b never launched the merge kernel")
    del chunk_blobs
    torch.cuda.empty_cache()

    log(f"== phase 7: op path ({OP_FRAMES} frames of {OP_FRAME_OPS} ops into {N_TOTAL} "
        f"objects, A={A} M={M} D={D})")
    _build.reset_launch_counts()
    op_k2 = op_path(dev, card)
    log(f"  launches {_build.launch_counts()} (the merge kernel: the fleet's and the final "
        "fleet's self-merges; the op bodies are torch ops)")
    if op_k2 == 0:
        raise AssertionError("the op path never launched the merge kernel")
    torch.cuda.empty_cache()

    log("== phase 8: flat types (fold, wire round and op frames on the card)")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    flat_types(dev, card)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s; launches {_build.launch_counts()} "
        "(the flat types' bodies are torch ops)")
    torch.cuda.empty_cache()

    log("== phase 9: Map (merge, truncate and wire rounds on the card)")
    t0 = time.perf_counter()
    map_k2_launches = map_phase(dev, card)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("== phase 10: sync and GC (digests, descent, two sync sessions, GC pass)")
    t0 = time.perf_counter()
    sync_k2, fleet, diverged = sync_gc_phase(dev, card)
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s; the merge kernel launched "
        f"{sync_k2} times on its main path")
    if sync_k2 == 0:
        raise AssertionError("phase 10 never launched the merge kernel")
    torch.cuda.empty_cache()

    log("== phase 11: the read front-end (gathers, consistency, frontier, heat, audit, capacity)")
    read_k2, fleet = read_phase(dev, card, fleet, diverged)
    if read_k2 == 0:
        raise AssertionError("phase 11 never launched the merge kernel")
    torch.cuda.empty_cache()

    log("== phase 12: cluster transport (two sessions over loopback TCP through the ARQ, "
        "faults injected)")
    cluster_k2, fleet = cluster_phase(dev, card, fleet)
    torch.cuda.empty_cache()

    log("== phase 13: a gossip fleet (three cluster nodes over loopback TCP taking writes and "
        "serving reads)")
    gossip_k2 = gossip_phase(dev, card, fleet)
    torch.cuda.empty_cache()

    log("== phase 14: durability (a checkpointed node killed mid-fold, restored from its "
        "snapshot and WAL, rejoining by delta sync)")
    durable_k2 = durable_phase(dev, card, fleet)
    del fleet
    torch.cuda.empty_cache()

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "wire_launches": wire_k2 if name == "orswot_merge" else 0,
         "op_launches": op_k2 if name == "orswot_merge" else 0,
         "map_launches": map_k2_launches if name == "orswot_merge" else 0,
         "sync_launches": sync_k2 if name == "orswot_merge" else 0,
         "read_launches": read_k2 if name == "orswot_merge" else 0,
         "cluster_launches": cluster_k2 if name == "orswot_merge" else 0,
         "gossip_launches": gossip_k2 if name == "orswot_merge" else 0,
         "durable_launches": durable_k2 if name == "orswot_merge" else 0,
         "max_abs_err": worst[name], "ms": timed[name]["ms"],
         "plain_ms": timed[name]["plain_ms"], "bound_ms": timed[name]["bound_ms"],
         "bound_by": timed[name]["bound_by"], "library_ms": None}
        for name in REPLACES
    ]}
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
