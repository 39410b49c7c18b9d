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
   card; both must give the blobs back (``to_wire``, every object;
   ``to_binary`` of ``to_scalar``, every 8th), and the COO planes must
   equal the dense planes' self-merge (ascending-id slots);
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
   heat trackers, its own metrics registry, ``FleetObservatory`` (every
   session leg swaps FLEET frames) and exporter on 127.0.0.1:0, a
   loopback TCP listener accepting through
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
   rejections per mode, peak memory.  After every round the main thread
   scrapes the seven routes of every node's exporter (and an unknown one,
   404) while the reader runs: ``/metrics`` and ``/kernels`` parse as
   Prometheus text naming only families of the publisher's table,
   ``/kernels``' merge-kernel calls equal ``launch_counts()`` and the
   launches the wrapper capture saw, and
   ``/healthz``' reads match ``ServeLoop.counts()`` (exactly once the
   reader stopped).  After convergence one more, idle round runs, its
   first scheduler's round under ``tracing.profile`` (the device's busy
   share of that round; a profiler that fails or sees no device time
   fails the phase; the trace is removed).  Then every node's
   ``/fleet`` must list the three nodes with its own slice's scheduler
   counts and the fleet's session legs the slices' sum, the merged hot
   list of fresh captures must equal ``merge_hot`` of the nodes'
   sketches, and each ``/heat?plan=mesh:8`` report ``score_plan`` of
   the node's heat.  The ``gossip`` line adds FLEET bytes per leg, the
   observatories' encode and merge seconds and their share of the legs'
   walls, each route's scrape ms (p50, max), the merged snapshot's bytes
   and nodes, and the profiled round.

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

15. collectives — ``anti_entropy(impl="pallas", max_rounds=3)`` over the
   north-star fleet (phase 4's shapes, 20 chunks of 62,500 objects, built
   on the card from seeded columns): the union-aligned fold kernel folds
   each chunk and the merge kernel runs the self-merges; rounds and wall
   time per chunk.  Chunk 0 must equal the fold kernel's
   ``fold_merge(plunger=True)`` followed by the same number of further
   self-merges, the merge kernel's route (``impl=None``, rounds too) and,
   on its first 512 objects, the plain version on the CPU; every launch
   of the merge kernel is held against ``merge_reference`` and every
   launch of the union-aligned fold against its plain version.  Then one
   rank joins an NCCL process group of world size one (a ``FileStore`` in
   a temporary directory): the clock join on the chunk's eight clock
   planes, the ORSWOT join on the folded chunk (and with
   ``object_axis`` on a 1x1 mesh), the Map, LWW, MVReg and GSet joins on
   4,096-object fleets and ``allgather_fleet_snapshots`` must each give
   this rank's state back, and a CPU tensor must not reach the NCCL
   group; the group is destroyed at the end.  One ``collectives`` JSON
   line carries the numbers.

16. the mesh-sharded fleet — at world size one over NCCL: a Zipf 1.1
   history of 4,096 writes into a ``HeatTracker`` (its subtree totals
   held against the history's bincount), binned at 4,096-row subtrees;
   ``choose_layout`` prices the granule for 8 shards; the north-star
   fleet P (A=64, M=16, D=2, u32, 1.25M objects) and Q, P with one add on
   a seeded 1% of the rows, laid out by ``ShardedBatch.shard``;
   ``anti_entropy_step`` (timed by CUDA events), whose digests, version
   vector and live members must equal ``digest_of``, ``version_vector``
   and the live slots of K2's merge of P and Q; then Q diverged on 1% of
   shard 3's rows only and repaired by ``ClusterNode.sync_shard_subset``
   between two in-process nodes (1 shard synced, 7 skipped, the rows
   diverged, the digests equal after), timed beside ``sync_pair`` of the
   same pair; member sharding: 62,500 sets of up to 64 members (renamed so
   that each of 4 member shards holds at most 16 of a row, deferred
   removes on one replica) partitioned, merged by ``member_sharded_merge``
   (K2 at M=16), an add on every set by ``sharded_apply_add``,
   ``rebroadcast_clock`` and a self-merge, ``unpartition_dense`` against
   the same steps on the dense M=64 planes by the plain merge (digests,
   sorted ids and clocks equal); ``MeshSnapshotStore`` at 8 shards writes
   and restores the first 250,000 objects of a fresh fleet under the
   durable directory (restored digests and the manifest's roots equal the
   written ones).  Every launch of the merge kernel is held against
   ``merge_reference``.  One ``mesh`` JSON line carries the numbers.

17. the tools as users run them — each a child process on the card
   (``python -m crdt_tpu_torch.tools.<tool> --device cuda``), all started
   together, each with a timeout; a child that fails fails the phase:
   ``replicate_tcp`` at 1.25M objects (A=8, M=32, D=8, u32, 5%
   divergence: two OS processes, default framing, each side 62,500 delta
   objects and no full state), its gossip fleet (3 nodes of 62,500
   objects, ``--ops 4096 --reads 512 --gc --durable <dir> --window 16``:
   the kill and recovery lines, no full-state fallback, CONVERGED) and its
   mesh (8 shards of 250,000 objects, BYTE-IDENTICAL); ``wire_zoo``,
   ``pprint``, ``anti_entropy`` (its skip lines for steps 4 and 5 on one
   card) and ``multihost --ranks 1``.  Each child that merges must report
   merge-kernel launches.  While they run, one merge of the gossip's
   over-provisioned planes (M=128, the plain wide path; 4,096 objects) is
   held against the same merge on the CPU, and both demo fleets are rebuilt
   in process by the tool's fleet code; after they exit, those fleets are
   merged by the merge kernel (timed alone on the card), held against
   ``merge_reference``, and the merge's digest fingerprint must equal both
   children's.  One ``tools`` JSON line: each run's wall, its children's
   launches and wide merges, the gossip's sweeps, the in-process merge.

Launch counts are reset just before phase 4 and read just after, around
phase 5, around each of phases 6 to 17 (and within phase 10 around each
step of its main path: the replicas' plunger, the session step, the GC
pass and the truncate; within phases 12 to 14 around their sessions,
rounds, writes, kill and rejoin; the checks between them are not
counted).  Every phase prints one JSON line (``environment``,
``main_path``, ``wire``, ``wire_routes``, ``op``, ``flat_types``,
``maps``, ``sync_gc``, ``reads``, ``cluster``, ``gossip``, ``durable``,
``collectives``, ``mesh``, ``tools``) with its wall seconds, peak device memory and
the card.  The last lines are the kernel table (JSON), the card's name
and power limit, and ``{"ok": true, "device": ...}``.  Needs one CUDA
card; exits nonzero without one.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import gc
import hashlib
import json
import os
import re
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import urllib.error
import urllib.request
from time import perf_counter as now

import numpy as np
import torch
import torch.distributed as dist

from crdt_tpu_torch import (
    _build, CapacityTracker, ClusterNode, ConflictingMarker, CrdtConfig, GcEngine,
    GCounterBatch, GcPolicy, GSetBatch, HeatTracker, JoinExecutor, JoinStats,
    kernel_observatory, LWWRegBatch, MapBatch, MapKernel, mesh, MVRegBatch, MVRegKernel,
    OrswotBatch, OrswotKernel, PipelinedOpLoop, PipelinedWireLoop, PNCounterBatch,
    StabilityTracker, sync_pair, SyncSession, Universe, VClockBatch, WireFormatError,
)
from crdt_tpu_torch.batch import wirebulk
from crdt_tpu_torch.batch.vclock_batch import row_to_vclock
from crdt_tpu_torch.cluster import (
    ALIVE, arm_crashes, CrashPlan, disarm_crashes, FaultPlan, FaultyTransport, FlappingDialer,
    GossipScheduler, hello_accept, hello_dial, InjectedCrash, linger, Membership,
    ResilientTransport, RetryPolicy, SUSPECT, TcpTransport,
)
from crdt_tpu_torch.dtypes import (
    as_counters, bias_np, counters_to_numpy, EMPTY, h2d_bytes, ZERO64, zero_of,
)
from crdt_tpu_torch.durable import Durability, recover, WalWriter
from crdt_tpu_torch.error import PeerUnavailableError
from crdt_tpu_torch.gc import compact
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.obs import (
    convergence, events, FleetObservatory, heat as heat_mod, metrics, MetricsRegistry, publish,
    stability,
)
from crdt_tpu_torch.obs.export import start_metrics_server
from crdt_tpu_torch.obs.fleet import encode_snapshot, FleetSnapshot
from crdt_tpu_torch.oplog import (
    apply_gcounter_ops, apply_lww_ops, apply_pncounter_ops, decode_ops_frame, derive_add_ctx,
    derive_rm_ctx, encode_ops_frame, OP_ADD, OP_DEC, OP_INC, OP_SET, OpApplier, OpBatch, OpLog,
)
from crdt_tpu_torch.ops import (
    clock_ops, orswot_fold_aligned as fa, orswot_ops, orswot_tile as tile,
)
from crdt_tpu_torch.parallel import (
    all_reduce_clock_join, allgather_join_gset, allgather_join_lww, allgather_join_map,
    allgather_join_mvreg, allgather_join_orswot, anti_entropy, initialize, make_mesh,
    make_multihost_mesh, member_sharded_merge, partition_dense, rebroadcast_clock,
    sharded_apply_add, unpartition_dense,
)
from crdt_tpu_torch.parallel.collective import allgather_fleet_snapshots
from crdt_tpu_torch.parallel.mesh import tree_leaves, tree_map
from crdt_tpu_torch.scalar import Dir, Dot, PNOp
from crdt_tpu_torch.scalar.orswot import Add, Rm
from crdt_tpu_torch.scalar.vclock import VClock
from crdt_tpu_torch.serve import (
    admit, decode_result_frame, encode_read_request, gather, K_GCOUNTER, K_LWW, K_MAP, K_MVREG,
    K_ORSWOT, K_PNCOUNTER, KIND_NAMES, NO_MEMBER, query, ReadRequest, ST_NOT_STABLE,
    stability_statuses,
)
from crdt_tpu_torch.sync import delta, digest, tree
from crdt_tpu_torch.sync.digest import digest_of, version_vector
from crdt_tpu_torch.utils import checkpoint, tracing
from crdt_tpu_torch.utils.serde import from_binary, to_binary
from crdt_tpu_torch.utils.testdata import (
    anti_entropy_fleets, build_fleet_planes, fleet_columns, plant_dominated_deferred,
    random_map, random_orswot_arrays,
)
from crdt_tpu_torch.utils.workload import WorkloadGen

SEED = 0
# north-star shapes (BASELINE.md ★)
N_TOTAL, A, M, D, R, CHUNK = 1_250_000, 64, 16, 2, 8, 62_500
BASE, NOVEL, DEFERRED_FRAC = 6, 1, 0.25
U_CAP = 16
CHECK_N = 4096
# phase 6 encodes chunks until WIRE_PREP_S (at least WIRE_MIN_CHUNKS): the chip
# budget's cut 6 (ROADMAP.md, section C) took it from 75 s to 40 s, and cut 9
# (the script ran 627 s with phase 17 on an H100) to 30 s
WIRE_MIN_CHUNKS, WIRE_PREP_S, WIRE_SAMPLE, WIRE_ROUNDS = 2, 30.0, 64, 2
# cut 8 (the same run): phase 6b holds to_binary of to_scalar against the
# blobs on every WIRE_ROUTES_STRIDE-th object (the serde oracle took ~60 s
# of the phase's 70.7 s); to_scalar itself runs on all of them
WIRE_ROUTES_STRIDE = 8
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
# the chip budget's cut 7 (the script ran 670.5 s with phase 16 on an H100,
# against its 600 s ground rule): the other folds' scalar checks sample
# FLAT_FOLD_SAMPLE objects, not FLAT_SAMPLE (the op folds keep FLAT_SAMPLE)
FLAT_FOLD_SAMPLE = 512
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


def sync():
    """Wait for the card."""
    torch.cuda.synchronize()


def seeded(k: int):
    """The numpy generator of seed ``SEED + k``."""
    return np.random.RandomState(SEED + k)


def k2_count() -> int:
    """The merge kernel's launches since the counts were reset."""
    return _build.launch_counts()["orswot_merge"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after one warm-up,
    by CUDA events."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
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
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def rows_of(x, dev):
    """Host row indices → an int64 index tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(dev)


def same_planes(got, want, what: str):
    """Raise unless every plane of batch ``got`` equals ``want``'s (on
    ``got``'s device)."""
    for k, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        if not torch.equal(g, w.to(g.device)):
            raise AssertionError(f"{what}: plane {k} differs")


def star_universe():
    """The north-star shapes' identity universe (A actors, M members, D
    deferred rows)."""

    return Universe.identity(CrdtConfig.gpu_default(
        num_actors=A, member_capacity=M, deferred_capacity=D))


def to_dev(planes, dev):
    """Unsigned numpy planes → biased device planes (the package domain)."""

    return tuple(
        torch.from_numpy(np.ascontiguousarray(bias_np(x) if i in (0, 2, 4) else x)).to(dev)
        for i, x in enumerate(planes)
    )


def stack_np(reps):
    return tuple(np.stack([rep[k] for rep in reps]) for k in range(5))


def star_planes(rng, dev, n: int = CHUNK, r: int = R):
    """``r`` seeded north-star replica fleets of ``n`` objects, built on
    ``dev`` as biased ``[r, n, ...]`` planes."""

    cols = fleet_columns(rng, n, A, M, D, r, base=BASE, novel=NOVEL, deferred_frac=DEFERRED_FRAC)
    return build_fleet_planes(cols, a=A, m_cap=M, d=D, base=BASE, novel=NOVEL, device=dev)


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
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# -- phase 3 -------------------------------------------------------------------


def check_kernels(dev):
    """Each kernel against its plain version on the card; returns the
    largest difference seen per kernel (0 is required)."""

    rng = seeded(0)
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
    sync()
    check_routes(dev, rng, cmp)
    return worst


def check_routes(dev, rng, cmp):
    """K1, K2 and K3 in every instantiation (accumulator in registers or
    in shared memory; actor width at compile or run time), by every copy
    route (bulk copies, per-lane cp.async; K2 and K3 also the direct route
    for widths too wide for shared memory) and through each alignment
    path, K1 and K3 with the plunger on and off, bit for bit against their
    plain versions; raises unless every combination was taken."""

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
    del level
    torch.cuda.empty_cache()
    # K3's device memory per call above its inputs: the outputs only, where
    # the first design also allocated its accumulator scratch (2 states
    # per object)
    sync()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = specs["orswot_fold"][0]()
    sync()
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
    return rows


# -- phase 4 -------------------------------------------------------------------


def main_path(dev, n_chunks: int):
    rng = seeded(1)
    uni = star_universe()
    fold_ms = []
    first = None
    for c in range(n_chunks):
        planes = star_planes(rng, dev)
        sync()
        t0 = now()
        out = orswot_ops.fold_merge(*planes, M, D, impl="pallas", u_cap=U_CAP)
        sync()
        fold_ms.append((now() - t0) * 1e3)
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
    return fold_ms


def regrow_ladder(dev):
    """Four fleets whose objects hold 2 members each, all distinct: the
    join needs 8 member slots and starts at 2, so it regrows twice."""

    rng = seeded(2)
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


def wire_leg(dev):
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

    rng = seeded(4)
    uni = star_universe()
    loop = PipelinedWireLoop(uni, device=dev)
    to_wire_s, bytes_in, bytes_out = 0.0, 0, 0
    wirebulk.reset_wire_counts()
    n_max = N_TOTAL // CHUNK
    t_phase = now()
    fleets, oracles = [], []
    while len(fleets) < n_max:
        c = len(fleets)
        planes = star_planes(rng, dev)
        sync()
        t0 = now()
        rep_blobs = [OrswotBatch(*(x[r] for x in planes)).to_wire(uni) for r in range(R)]
        to_wire_s += now() - t0
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
        if len(fleets) >= WIRE_MIN_CHUNKS and now() - t_phase > WIRE_PREP_S:
            break
    chunks = len(fleets)
    rep = {"chunks": chunks, "prep_s": now() - t_phase, "runs": [],
           "bytes_in_per_object_replica": bytes_in / (chunks * CHUNK * R),
           "bytes_out_per_object": bytes_out / (chunks * CHUNK),
           "to_wire_s_per_chunk": to_wire_s / chunks,
           "cores": [os.cpu_count(), len(os.sched_getaffinity(0))],
           # one more run under the profiler, which also sizes the loop's buffers
           "profile": profiled(lambda: loop.run([fleets[0]] * WIRE_ROUNDS, overlap=True))}
    rounds = [rep_blobs for rep_blobs in fleets for _ in range(WIRE_ROUNDS)]
    want = [out for out in oracles for _ in range(WIRE_ROUNDS)]
    half = max(1, len(os.sched_getaffinity(0)) // 2)
    k2_launches = 0
    for label, overlap, threads in WIRE_RUNS:
        threads = half if threads == "half" else 0
        engine.set_threads(threads)
        before = k2_count()
        try:
            res = loop.run(rounds, overlap=overlap)
        finally:
            engine.set_threads(0)
        k2 = k2_count() - before
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
        # each run: its mode, codec team, seconds end to end and by stage
        rep["runs"].append([label, threads, res["e2e_s"], res["stage_s"]])
        del res
    counts = wirebulk.wire_counts()
    for direction, c in counts.items():
        if c["fallback"] or not c["native"]:
            raise AssertionError(f"{direction}: not every blob took the host codec ({c})")
    blob = OrswotBatch.zeros(1, uni, device=dev).to_wire(uni)[0]
    try:
        OrswotBatch.from_wire([blob[:-1]], uni, device=dev)
    except WireFormatError:
        pass
    else:
        raise AssertionError("a truncated blob did not raise WireFormatError")
    rep.update(rounds_per_run=len(rounds), half_team=half, wire_counts=counts,
               k2_launches=k2_launches)
    return k2_launches, rep, fleets[0]


def _annotation(e) -> bool:
    """A program span (``utils.tracing.span``) or its copy on the device
    timeline: a ``key_averages()`` row or a raw record that marks a range
    and is no device work of its own."""
    probe = getattr(e, "is_user_annotation", False)
    return bool(probe() if callable(probe) else probe)


def profiled(run, ref_ms=None) -> dict:
    """``run()`` under ``torch.profiler``: the device time of its kernels
    and of its copies against its wall time (or ``ref_ms``, the same work
    timed by CUDA events), and the top kernels and host ops by device
    time.  A measurement only: a profiler that sees no device time gives
    ``None`` shares (not measured), not a failure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = now()
        run()
        sync()
        wall = now() - t0
    ev = [e for e in prof.key_averages() if not _annotation(e)]
    # device-side events only: a host op (aten::copy_) also reports the
    # device time of the copy it started
    dev_ev = [e for e in ev if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    copies = sum(e.self_device_time_total for e in dev_ev
                 if "memcpy" in e.key.lower() or "memset" in e.key.lower()) / 1e6
    kernels = sum(e.self_device_time_total for e in dev_ev) / 1e6 - copies
    ref = ref_ms / 1e3 if ref_ms else wall

    def top(es):
        es = sorted(es, key=lambda e: -e.self_device_time_total)[:8]
        return [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in es]

    return {"wall_s": wall, "kernels_s": kernels, "copies_s": copies,
            "idle_share": 1 - kernels / ref if dev_ev else None,
            "kernel_launches": sum(e.count for e in dev_ev), "top_kernels": top(dev_ev),
            "top_ops": top([e for e in ev if e.device_type == DeviceType.CPU
                            and e.self_device_time_total > 0])}


# -- phase 6b ------------------------------------------------------------------


def wire_routes(dev, rep_blobs):
    """``from_wire`` and ``to_scalar`` by both routes on one chunk of the
    wire leg's fleets: dense planes copied whole, or COO columns that the
    card expands (``via_device=True``, the JAX package's route on an
    accelerator) and compacts."""

    uni = star_universe()
    blobs = rep_blobs[0]  # replica 0 holds the planted deferred rows
    batches, rep = {}, {"blob_bytes": sum(map(len, blobs))}
    for via in (False, True):
        sync()
        b0, t0 = h2d_bytes(), now()
        batches[via] = OrswotBatch.from_wire(blobs, uni, device=dev, via_device=via)
        sync()
        rep[f"from_wire_via_{via}"] = [now() - t0, h2d_bytes() - b0]
    for via, batch in batches.items():
        if batch.to_wire(uni) != blobs:
            raise AssertionError(f"to_wire(from_wire(blobs, via_device={via})) != blobs")
        sync()
        t0 = now()
        states = batch.to_scalar(uni, via_device=via)
        rep[f"to_scalar_via_{via}_s"] = now() - t0
        if [to_binary(x) for x in states[::WIRE_ROUTES_STRIDE]] != blobs[::WIRE_ROUTES_STRIDE]:
            raise AssertionError(f"to_binary(to_scalar(via_device={via})) != blobs")
    # replica 1 has no deferred rows, so its states are fixpoints of the
    # merge and the self-merge only puts member slots in ascending-id order
    dense = OrswotBatch.from_wire(rep_blobs[1], uni, device=dev, via_device=False)
    coo = OrswotBatch.from_wire(rep_blobs[1], uni, device=dev, via_device=True)
    same_planes(coo, dense.merge(dense), "from_wire(via_device=True) against the dense "
                "route's self-merge")
    return None, rep


# -- phase 7 -------------------------------------------------------------------


def op_traffic(fleet, rng):
    """``OP_FRAMES`` frames of ``OP_FRAME_OPS`` ops against ``fleet``,
    minted in causal order: ~90% adds (objects and actors uniform, 70% of
    members already present; dots from ``derive_add_ctx``), ~10% removes
    of a live member (``derive_rm_ctx``, 2% one dot ahead) on objects with
    no deferred row, 5% of those objects removed twice (a second round;
    deferral stays within D=2).  Returns ``(frames, [(adds, removes)])``;
    frame ``OP_SWAP + 1`` is delivered before its predecessor."""

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

    rows = rows_of(sample, fleet.device)
    states = flat_rows(fleet, rows).to_scalar(uni)
    where = {int(o): k for k, o in enumerate(sample)}
    for adds, rms in causal:
        for r in np.nonzero(np.isin(adds.obj, sample))[0].tolist():
            dot = Dot(int(adds.actor[r]), int(adds.counter[r]))
            states[where[int(adds.obj[r])]].apply(Add(dot=dot, member=int(adds.member[r])))
        for r in np.nonzero(np.isin(rms.obj, sample))[0].tolist():
            clock = VClock({a: int(v) for a, v in enumerate(rms.rm_clocks[r]) if v})
            states[where[int(rms.obj[r])]].apply(Rm(clock=clock, member=int(rms.member[r])))
    return states


def op_path(dev):
    """The op-based write path at full width: op frames folded into a
    1.25M-object fleet through ``PipelinedOpLoop`` (O S S O from the same
    fleet), one profiled run, re-delivery, the scalar engine on a sample,
    a ``to_coo``/``from_coo`` round trip, and both self-merges against
    the plain merge.  Returns the merge kernel's launches of the phase."""

    rng = seeded(7)
    uni = star_universe()
    t0 = now()
    built = OrswotBatch(*(x[0] for x in star_planes(rng, dev, N_TOTAL, 1)))
    with K2Launches() as k2:  # the self-merges, each launch against its plain version
        fleet = built.merge(built)  # canonical: ascending-id slots, deferred replayed
        sync()
        rep = {"build_s": now() - t0, "runs": []}
        if not k2.seen:
            raise AssertionError("the fleet's self-merge did not launch the merge kernel")
        k2.check("the fleet's self-merge")
    del built
    torch.cuda.empty_cache()
    t0 = now()
    frames, causal = op_traffic(fleet, rng)
    n_ops = sum(len(a) + len(r) for a, r in causal)
    rep.update(traffic_s=now() - t0, ops=n_ops, removes=sum(len(r) for _, r in causal),
               wire_bytes_per_op=sum(map(len, frames)) / n_ops)

    final = None
    for overlap in (True, False, False, True):  # each mode both before and after the other
        loop = PipelinedOpLoop(uni)
        torch.cuda.reset_peak_memory_stats()
        out, st = loop.run(fleet, frames, overlap=overlap)
        c = loop.applier.counts
        rep["runs"].append({"ops_per_s": n_ops / st["e2e_s"], **st, "applier": c,
                            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        if st["applied"] != n_ops or st["still_parked"] or not 0 < c["parked"] == c["released"]:
            raise AssertionError(f"op loop counts: {st}, {c}")
        final = out if final is None else final
        same_planes(out, final, f"{st['pipeline']} run against the first run")
        del out
    rep["profile"] = profiled(lambda: PipelinedOpLoop(uni).run(fleet, frames, overlap=True))
    again, st = PipelinedOpLoop(uni).run(final, frames)
    same_planes(again, final, "re-delivering every frame")
    if st["duplicates"] != sum(len(a) for a, _ in causal) or st["still_parked"]:
        raise AssertionError(f"re-delivery applied adds again: {st}")
    del again

    touched = np.unique(np.concatenate([a.obj for a, _ in causal] + [r.obj for _, r in causal]))
    sample = np.sort(rng.choice(touched, OP_SAMPLE, replace=False))
    want = [to_binary(s) for s in scalar_oracle(fleet, causal, sample, uni)]
    rows = rows_of(sample, dev)
    got = flat_rows(final, rows).to_scalar(uni)
    if [to_binary(s) for s in got] != want:
        raise AssertionError("op loop != the scalar engine on the sampled objects")

    with K2Launches() as k2:
        canon = final.merge(final)
        k2.check("the final fleet's self-merge")
    del final
    sync()
    t0 = now()
    clock, dots, q, h = canon.to_coo()
    t1 = now()
    back = OrswotBatch.from_coo(N_TOTAL, uni, clock_coords=clock, dot_coords=dots,
                                deferred_members=q, deferred_coords=h, device=dev)
    sync()
    same_planes(back, canon, "from_coo(to_coo(x)) against x")
    rep.update(coo_s=[t1 - t0, now() - t1], dot_cells=len(dots[0]))
    del back, canon
    return k2_count(), rep


# -- phase 8 -------------------------------------------------------------------


def flat_rows(b, rows):
    """Rows ``rows`` of any batch (an index tensor or a slice)."""
    return tree_map(lambda x: x[rows], b)


def left_fold(reps):
    acc = reps[0]
    for b in reps[1:]:
        acc = acc.merge(b)
    return acc


def flat_fleets(dev):
    """Seeded replica fleets, generated on the card (``bench.py``'s dense
    clocks: counters uniform in [0, 1000)), one type at a time."""

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

    n = tree_leaves(fold)[0].shape[0]
    rows = rows_of(seeded(5).choice(n, min(n, sample), replace=False),
                   tree_leaves(fold)[0].device)
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

    dev = tree_leaves(reps[0])[0].device
    before = wirebulk.wire_counts(leg)
    t0 = now()
    blobs = [b.to_wire(uni) for b in reps]
    t1 = now()
    parsed = [cls.from_wire(bl, uni, *extra, device=dev) for bl in blobs]
    sync()
    t2 = now()
    out = left_fold(parsed).to_wire(uni)
    t3 = now()
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


def flat_fold(name, cls, reps, wire_r, extra, uni):
    """Fold the replicas through the batch ``merge`` (timed), check the
    fold on a sample against the scalar engine and in full against the
    same merges on the CPU, and run a wire round."""
    n = tree_leaves(reps[0])[0].shape[0]
    t0 = now()
    fold = left_fold(reps)
    ms = cuda_ms(lambda: left_fold(reps), FLAT_ITERS)
    t1 = now()
    # one merge reads two states and writes one (plus its conflict or
    # overflow flags); MVReg's dominance tests compare [n, K, K, A]
    # counters twice (an int64 compare counted as 2 INT32 operations)
    state = nbytes(tree_leaves(reps[0]))
    flags = n if cls.__name__ in ("LWWRegBatch", "MVRegBatch") else 0
    ops = 4 * n * FLAT_K * FLAT_K * FLAT_A if cls.__name__ == "MVRegBatch" else 0
    b_ms, b_by = bound_ms(2 * state, state + flags, ops)
    merge_ms = ms / (len(reps) - 1)
    mv = cls.__name__ == "MVRegBatch"
    k = min(n, FLAT_MVREG_CPU) if mv else n
    sample = min(n, FLAT_MVREG_SAMPLE if mv else FLAT_FOLD_SAMPLE)
    cpu = left_fold([cls(*(x[:k].cpu() for x in tree_leaves(b))) for b in reps])
    same_planes(flat_rows(fold, slice(0, k)), cpu,
              f"{name}: the device fold against the CPU plain path")
    t2 = now()
    flat_sample_check(reps, fold, uni, name, sample)
    t3 = now()
    leg = {"GCounterBatch": "gcounter", "VClockBatch": "vclock", "PNCounterBatch": "pncounter",
           "LWWRegBatch": "lww", "GSetBatch": "gset", "MVRegBatch": "mvreg"}[cls.__name__]
    wire = flat_wire_round(cls, [flat_rows(b, slice(0, FLAT_WIRE_N)) for b in reps[:wire_r]],
                           extra, uni, leg, name)
    row = {"objects": n, "replicas": len(reps), "fold_ms": ms, "merge_ms": merge_ms,
           "merges_per_s": n * len(reps) / (ms / 1e3), "bound_ms_per_merge": b_ms,
           "bound_by": b_by, "share_of_bound": b_ms / merge_ms, "state_bytes": state,
           "cpu_checked": k, "sampled": sample, **wire,
           "phase_s": {"fold_timing": t1 - t0, "cpu_check": t2 - t1, "sample_check": t3 - t2,
                       "wire_round_and_checks": now() - t3}}
    del cpu
    sync()
    return fold, row


def flat_op_traffic(fleet, kind: str, rng):
    """``FLAT_FRAMES`` frames of ``FLAT_FRAME_OPS`` ops, objects and actors
    uniform: ``inc`` dots (``dec`` too for PNCounter) carrying each
    actor's running total, or LWW ``set``s with unique markers above
    every register's."""

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


def flat_op_fold(kind, fleet, uni):
    """The op frames through ``encode_ops_frame``/``decode_ops_frame`` into
    ``fleet``, frame 11 before frame 10, then every frame again: the
    re-delivery changes nothing, and a sample equals the scalar engine
    witnessing the same ops.  LWW also folds a frame of planted
    equal-marker conflicts."""

    apply = {"gcounter": apply_gcounter_ops, "pncounter": apply_pncounter_ops,
             "lww": apply_lww_ops}[kind]
    a = tree_leaves(fleet)[0].shape[-1] if kind != "lww" else 1
    rng = seeded(7)
    t_traffic = now()
    frames = [encode_ops_frame(ops) for ops in flat_op_traffic(fleet, kind, rng)]
    t_traffic = now() - t_traffic
    order = list(range(FLAT_FRAMES))
    order[OP_SWAP], order[OP_SWAP + 1] = order[OP_SWAP + 1], order[OP_SWAP]
    sync()
    t0 = now()
    out = fleet
    for f in order:
        out = apply(out, decode_ops_frame(frames[f], num_actors=a))
    sync()
    e2e = now() - t0
    again = out
    for f in order:
        again = apply(again, decode_ops_frame(frames[f], num_actors=a))
    same_planes(again, out, f"{kind} ops: the second delivery")
    n = tree_leaves(fleet)[0].shape[0]
    sample = seeded(8).choice(n, FLAT_SAMPLE, replace=False)
    rows = rows_of(sample, tree_leaves(fleet)[0].device)
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
    return row


def flat_types(dev):
    """Phase 8: the flat types at BASELINE.md's sizes (u64)."""

    cfgs = {a: Universe.identity(CrdtConfig(num_actors=a, mv_capacity=FLAT_K)) for a in
            (4, FLAT_PN_A, FLAT_A)}
    report, folds = {}, {}
    for name, (cls, make, r, wire_r, extra, a) in flat_fleets(dev).items():
        reps = [make(i) for i in range(r)]
        folds[name], report[name] = flat_fold(name, cls, reps, wire_r, extra, cfgs[a])
        del reps
        torch.cuda.empty_cache()
    gcount = GCounterBatch(folds["vclock_1m"].clocks)
    for kind, fleet, uni in (("gcounter", gcount, cfgs[FLAT_A]),
                             ("pncounter", folds["pncounter_1m"], cfgs[FLAT_PN_A]),
                             ("lww", folds["lwwreg_10m"], cfgs[FLAT_A])):
        report[f"{kind}_ops"] = flat_op_fold(kind, fleet, uni)
    return None, report


# -- phase 9 -------------------------------------------------------------------


def map_op_fleets(uni, vk, op: str, n: int, seed: int, dev):
    """``MAP_R`` replica fleets of ``n`` maps built on the card by seeded op
    rounds: ``MAP_ROUNDS[0]`` rounds of ``Op::Up`` (a nested ``op`` under
    a fresh dot of a base actor) and one of ``Op::Rm``, shared; then each
    replica's own ``MAP_ROUNDS[1]`` up rounds and one remove round through
    actors of its own.  A remove round removes a key under the map clock
    in 15% of the objects and buffers one ahead of it in 10%."""

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

    gen = torch.Generator(device=b.device)
    gen.manual_seed(seed)
    n, a = b.clock.shape
    pick = (torch.rand((n, a), generator=gen, device=b.device) < 0.2) & (
        torch.rand((n, 1), generator=gen, device=b.device) < 0.5)
    return torch.where(pick, b.clock, zero_of(b.clock.dtype))


def map_join(reps, seed: int):
    """The Map phase's main path on one chunk: ``JoinExecutor`` folds the
    replicas (R - 1 merges and the plunger), then a truncate."""

    stats = JoinStats()
    joined = JoinExecutor().join_all(reps, stats=stats)
    if stats.overflow_regrows:
        raise AssertionError(f"the Map join regrew ({stats})")
    tclock = map_truncate_clock(joined, seed)
    return joined.truncate(tclock), tclock


def map_checks(name, reps, tclock, out, uni, cpu_n: int):
    """Chunk 0 of a composition: its first ``cpu_n`` objects bit for bit
    against the same join and truncate on the CPU, ``MAP_SAMPLE`` sampled
    objects against the port's scalar engine, and a wire round (codec
    share 1.0, the blobs ``to_binary`` of the scalar result)."""

    t0 = now()
    cpu = [tree_map(lambda x: x[:cpu_n].cpu(), r) for r in reps]
    want = JoinExecutor().join_all(cpu).truncate(tclock[:cpu_n].cpu())
    for g, w in zip(tree_leaves(flat_rows(out, slice(0, cpu_n))), tree_leaves(want)):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"{name}: the card's join != the CPU plain path's")
    t1 = now()
    n = out.clock.shape[0]
    rows = rows_of(np.sort(seeded(9).choice(n, MAP_SAMPLE, replace=False)),
                   out.device)
    acc = flat_rows(reps[0], rows).to_scalar(uni)
    for r in reps[1:]:
        for s, o in zip(acc, flat_rows(r, rows).to_scalar(uni)):
            s.merge(o)
    for s, t in zip(acc, counters_to_numpy(tclock[rows])):
        s.merge(s.clone())
        s.truncate(row_to_vclock(t, uni))
    want_blobs = [to_binary(s) for s in acc]
    if [to_binary(s) for s in flat_rows(out, rows).to_scalar(uni)] != want_blobs:
        raise AssertionError(f"{name}: the card's join != the scalar engine's on the sample")
    t2 = now()
    before = wirebulk.wire_counts("map")
    blobs = out.to_wire(uni)
    t3 = now()
    back = MapBatch.from_wire(blobs, uni, out.kernel.val_kernel, device=out.device)
    sync()
    t4 = now()
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
    return {"cpu_check_s": t1 - t0, "sample_check_s": t2 - t1, "encode_s": t3 - t2,
            "parse_s": t4 - t3, "wire_bytes_per_object": sum(map(len, blobs)) / n}


def map_k2(reps):
    """The merge kernel at the nested shapes a Map<K, Orswot> merge hands
    it: every launch of ``reps[0].merge(reps[1])`` (the value merge, the
    body's truncate and the deferred settle's, each an ``[N, 2K]`` batch
    of sets) bit for bit against ``merge_reference`` on the card, with its
    plan and its time beside the bytes bound."""
    with K2Launches() as k2:  # each launch's inputs as the main path built them
        reps[0].merge(reps[1])
    what = ("value merge", "truncate", "deferred settle")
    if len(k2.seen) != len(what):
        raise AssertionError(f"a Map<K, Orswot> merge launched the merge kernel {len(k2.seen)} "
                             f"times, not {len(what)}")
    rows = []
    for name, (args, _) in zip(what, k2.seen):
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
        rows.append({"launch": name, "shape": shape, "plan": plan, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                     "bytes": in_b + out_b})
        del got
    return rows


def map_phase(dev):
    """Phase 9: Map<K, Orswot>, Map<K, MVReg> and Map<K, Map<K2, MVReg>> at
    the config-default widths (u32).  Returns the merge kernel's launches
    on the phase's main path."""

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
    report, kept = {}, {}
    for k, (name, (vk, n_total, chunk, _, build)) in enumerate(comps.items()):
        build_s, join_ms = 0.0, []
        for c in range(n_total // chunk):
            t0 = now()
            reps = build(vk, chunk, SEED + 900 + 10 * k + c)
            sync()
            t1 = now()
            out, tclock = map_join(reps, SEED + 950 + 10 * k + c)
            sync()
            build_s += t1 - t0
            join_ms.append((now() - t1) * 1e3)
            if c == 0:
                kept[name] = (reps, tclock, out)
            del reps, out
        live = kept[name][2].len_counts().float().mean().item() / MAP_K
        deferred = (kept[name][2].d_keys != -1).any(-1).float().mean().item()
        report[name] = {"objects": n_total, "chunk": chunk, "replicas": MAP_R,
                        "join_ms_per_chunk": join_ms, "build_s": build_s,
                        "live_key_share": live, "deferred_object_share": deferred}
    launches = k2_count()
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if launches == 0:
        raise AssertionError("the Map phase never launched the merge kernel")
    for name, (reps, tclock, out) in kept.items():
        report[name].update(map_checks(name, reps, tclock, out, uni, comps[name][3]))
        # a merge reads two states and writes one (and one overflow flag per object)
        state = nbytes(tree_leaves(reps[0]))
        report[name]["merge_ms"] = cuda_ms(lambda: reps[0].merge(reps[1]), 3)
        b_ms, by = bound_ms(2 * state, state + reps[0].clock.shape[0], 0)
        report[name].update(state_bytes=state, bound_ms_per_merge=b_ms, bound_by=by)
    # one pairwise Map<K, Orswot> merge profiled (warm: cuda_ms ran it)
    reps = kept["map_orswot"][0]
    report["map_orswot"]["profile"] = profiled(lambda: reps[0].merge(reps[1]),
                                               report["map_orswot"]["merge_ms"])
    report["orswot_merge"] = map_k2(kept["map_orswot"][0])
    return launches, report


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
        self.launch, self.seen, self.checked = tile.merge, [], []

        def capture(*args, **kw):
            out = self.launch(*args, **kw)
            self.seen.append((args, out))
            return out

        # orswot_ops.merge reaches the kernel through this module attribute
        tile.merge = capture
        return self

    def __exit__(self, *exc):
        tile.merge = self.launch

    def check(self, what: str):
        for args, out in self.seen:
            sa, sb, (m_cap, d_cap) = args[:5], args[5:10], args[10:12]
            n, a = sa[0].shape[0], sa[0].shape[-1]
            step = max(1, K2_CHECK_CELLS // (m_cap * (sa[1].shape[-1] + sb[1].shape[-1]) * a))
            for s in range(0, n, step):
                want = tile.merge_reference(*(x[s:s + step] for x in (*sa, *sb)), m_cap,
                                                 d_cap)
                if max_abs_err([x[s:s + step] for x in out], want):
                    raise AssertionError(f"{what}: the merge kernel != merge_reference at "
                                         f"sets {s}+ of a [{n}, M={sa[1].shape[-1]}|"
                                         f"{sb[1].shape[-1]}] launch")
            self.checked.append([n, sa[1].shape[-1], sb[1].shape[-1], m_cap, d_cap])
        self.seen.clear()


def session_row(r, **extra) -> dict:
    """A session report's wall, profile split and bytes sent by frame
    kind, with ``extra`` fields."""
    return {"wall_s": r.profile.wall_ns / 1e9, "diverged": r.diverged,
            "split_s": {c: getattr(r.profile, f"{c}_ns") / 1e9
                        for c in ("serialize", "network", "kernel", "other", "unaccounted")},
            "bytes": {k: getattr(r, f"{k}_bytes_sent")
                      for k in ("hello", "digest", "delta", "full", "tree")}, **extra}


def timed_ms(fn):
    """``(fn(), device ms by CUDA events, wall ms)``."""
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = now()
    start.record()
    out = fn()
    end.record()
    sync()
    return out, start.elapsed_time(end), (now() - t0) * 1e3


def diverge(base, rng, actor: int, member: int, dev, lo: int = 0, hi=None):
    """``base`` (unchanged) with one add of ``actor`` (member ``member``,
    the next dot) on its own seeded ``SYNC_DIV`` share of the rows
    ``[lo, hi)`` (default all), and those rows: the divergence phases 10,
    12 and 16 plant."""

    hi = base.clock.shape[0] if hi is None else hi
    k = int((hi - lo) * SYNC_DIV)
    rows = lo + np.sort(rng.choice(hi - lo, k, replace=False))
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

    t0 = now()
    parts = []
    for _ in range(N_TOTAL // CHUNK):
        (planes,) = anti_entropy_fleets(rng, CHUNK, A, M, D, 1, base=SYNC_BASE, novel=0,
                                        deferred_frac=DEFERRED_FRAC)
        parts.append(OrswotBatch.from_numpy(*planes, device=dev))
    built = tree_map(lambda *xs: torch.cat(xs), *parts)
    del parts
    base = built.merge(built)
    (p, rows_p), (q, rows_q) = (diverge(base, rng, 1, 1 << 20, dev),
                                diverge(base, rng, 0, 1 << 21, dev))
    sync()
    return p, q, rows_p, rows_q, now() - t0


def full_state_bytes(p, uni, estimate: bool = False) -> tuple[int, float]:
    """The bytes of ``p``'s full state on the wire (``to_wire``, chunk by
    chunk) and the seconds the encode took.  With ``estimate``, the first
    chunk's bytes times the chunks (the chip budget's cut 4 for phase 10,
    whose replicas are uniform: the whole fleet's encode takes 3.6-4.6 s;
    phase 11's skewed writes make phase 12's first chunk no sample)."""

    t0 = now()
    stop = CHUNK if estimate else N_TOTAL
    full = sum(sum(map(len, flat_rows(p, slice(s, s + CHUNK))
                       .to_wire(uni))) for s in range(0, stop, CHUNK))
    return full * (N_TOTAL // stop), now() - t0


def session_step(p, q, uni, full_bytes: int) -> tuple:
    """Step 3 of phase 10: ``sync_pair`` of two sessions, as
    ``bench.py::bench_sync`` drives them, timed by the kernel observatory.
    Returns both sessions, both reports and the step's numbers."""

    obs = kernel_observatory()
    obs.reset()
    sync()
    earlier_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    sa = SyncSession(p, uni, full_state_bytes=full_bytes, peer="q")
    sb = SyncSession(q, uni, full_state_bytes=full_bytes, peer="p")
    obs.set_enabled(True)
    try:
        t0 = now()
        ra, rb = sync_pair(sa, sb)
        sync()
        wall = now() - t0
    finally:
        obs.set_enabled(False)
    k2 = obs.table()["orswot_merge"]
    out = {"wall_s": wall, "k2_launches": k2_count(),
           "k2_device_ms": k2["device_ms_total"], "k2_timed": k2["timed"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "earlier_peak_gb": earlier_peak}
    for side, r in (("p", ra), ("q", rb)):
        out[side] = session_row(r, bytes_received=r.bytes_received, digest_rounds=r.digest_rounds,
                                delta_ratio=r.delta_ratio(full_bytes),
                                frames=[r.profile.frames_sent, r.profile.frames_received])
    return sa, sb, ra, rb, out


def session_checks(p, q, sa, sb, reports, ids, uni, rng, k2,
                   self_merge: bool = False) -> None:
    """The session step's checks: both converged on the planted rows
    without a fallback, within the done-bar; each replica equals the merge
    kernel's full-fleet merge of the two (local first); sampled rows equal
    the scalar engine.  With ``self_merge`` (replicas whose member slots
    are out of ascending-id order, which the merge sorts and a row the
    session does not ship keeps), each replica's rows outside ``ids`` are
    first held bit for bit against the replica before the session, and the
    replica is self-merged before it is held against the full-fleet merge."""

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
                sl, rows = slice(lo, lo + CHUNK), kept[lo:lo + CHUNK]
                same_planes(flat_rows(flat_rows(got, sl), rows), flat_rows(flat_rows(x, sl), rows),
                            f"{what} after the session against {what} before it, on a row it "
                            "did not ship")
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


def idle_resync(a, b, uni, full_bytes: int) -> dict:
    """An idle re-sync of the converged replicas with the digest tree on
    both sides: one root frame each way, no delta and no full state."""

    sa = SyncSession(a, uni, full_state_bytes=full_bytes, peer="q", digest_tree=True)
    sb = SyncSession(b, uni, full_state_bytes=full_bytes, peer="p", digest_tree=True)
    t0 = now()
    reports = sync_pair(sa, sb)
    sync()
    wall = now() - t0
    for r in reports:
        if not (r.converged and r.tree_mode and r.tree_frames_sent == 1 and r.diverged == 0
                and r.delta_bytes_sent == r.full_bytes_sent == r.digest_bytes_sent == 0):
            raise AssertionError(f"the idle tree re-sync was not one root frame: {r}")
    out = {"wall_s": wall, "tree_bytes": [r.tree_bytes_sent for r in reports],
           "profile_wall_s": [r.profile.wall_ns / 1e9 for r in reports],
           "kernel_s": [r.profile.kernel_ns / 1e9 for r in reports]}
    return out


def sync_gc_phase(dev):
    """Phase 10: two 1.25M-object replicas reconciled by two sync sessions,
    and a causal-GC pass (A=64, M=16, D=2, u32).  Returns the merge
    kernel's launches on the phase's main path (the plunger, the sessions'
    applies, the reference truncate), replica P and the diverged rows,
    which phase 11 reads."""

    uni = star_universe()
    rng = seeded(10)
    rep = {"objects": N_TOTAL, "shape": [A, M, D], "divergence": SYNC_DIV}
    launches = 0
    with K2Launches() as k2:
        # 1. two replicas
        _build.reset_launch_counts()
        p, q, rows_p, rows_q, rep["build_s"] = sync_replicas(dev, rng)
        launches += k2_count()
        k2.check("the plunger")
        torch.cuda.empty_cache()
        planted = np.union1d(rows_p, rows_q)
        fleet_bytes = nbytes(tree_leaves(p))

        # 2. find the diverged rows: digests, trees, descent
        _build.reset_launch_counts()
        d_p, ms_p, wall_p = timed_ms(lambda: digest.digest_of(p, uni))
        d_q, ms_q, wall_q = timed_ms(lambda: digest.digest_of(q, uni))
        (t_p, t_q), tree_ms, _ = timed_ms(lambda: (tree.build_tree(d_p, device=dev),
                                                   tree.build_tree(d_q, device=dev)))
        t0 = now()
        found, stats = tree.simulate_descent(t_p, t_q)
        descent_ms = (now() - t0) * 1e3
        ids = delta.diverged_indices(d_p, d_q)
        if not (np.array_equal(found, ids) and np.array_equal(ids, planted)):
            raise AssertionError(f"descent {found.size}, diverged {ids.size} and planted "
                                 f"{planted.size} rows disagree")
        b_ms, _ = bound_ms(fleet_bytes, 8 * N_TOTAL, 0)
        rep.update(digest_ms=[ms_p, ms_q], digest_wall_ms=[wall_p, wall_q],
                   digest_bound_ms=b_ms, tree_build_ms_both=tree_ms, descent_ms=descent_ms,
                   descent=dataclasses.asdict(stats), diverged=int(ids.size))

        # 3. the exchange: two sessions through sync_pair, then an idle re-sync
        rep["full_state_bytes"], rep["full_state_encode_s"] = full_state_bytes(p, uni,
                                                                                 estimate=True)
        _build.reset_launch_counts()
        sa, sb, ra, rb, rep["session"] = session_step(p, q, uni, rep["full_state_bytes"])
        launches += k2_count()
        rep["delta_ratio"] = max(ra.delta_ratio(rep["full_state_bytes"]),
                                 rb.delta_ratio(rep["full_state_bytes"]))
        session_checks(p, q, sa, sb, (ra, rb), ids, uni, rng, k2)
        rep["session"]["idle_resync"] = idle_resync(sa.batch, sb.batch, uni,
                                                    rep["full_state_bytes"])
        chunk = tree_map(lambda x: x[:CHUNK].clone(), sa.batch)
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
        sync()
        t0 = now()
        gcd, report = GcEngine(GcPolicy(interval_rounds=1), tracker=trk).collect(
            big, universe=uni, oplog=oplog, applier=OpApplier(uni), peers=["p", "q"])
        sync()
        gc_s = now() - t0
        # 6. the reference truncate at the watermark, one chunk
        wm = report.watermark.clock
        trunc, trunc_ms, _ = timed_ms(lambda: compact.truncate_orswot(chunk, wm))
        launches += k2_count()

        plane_diff = nbytes(tree_leaves(big)) - nbytes(tree_leaves(gcd))
        if (report.member_capacity, report.deferred_capacity) != ((GC_M, M), (GC_D, D)):
            raise AssertionError(f"GC shrank to {report.member_capacity}, "
                                 f"{report.deferred_capacity}")
        if report.tombstones_cleared < tombs + k // 10 or report.members_freed < tombs:
            raise AssertionError(f"GC cleared {report.tombstones_cleared} tombstones and freed "
                                 f"{report.members_freed} members of {tombs} planted rows")
        if report.reclaimed_bytes - report.oplog_bytes_reclaimed != plane_diff:
            raise AssertionError(f"reclaimed {report.reclaimed_bytes} B != the planes' "
                                 f"{plane_diff} B + the op log's")
        rep["gc"] = {**dataclasses.asdict(report), "wall_s": gc_s, "truncate_ms": trunc_ms,
                     "tombstone_rows_planted": tombs, "duplicates_planted": k // 10,
                     "plane_bytes_reclaimed": plane_diff, "oplog_ops": GC_FRAMES * GC_FRAME_OPS}

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
        plain, over = kern.truncate_full(tuple(tree_leaves(chunk)), clock)
        if bool(over.any()) or max_abs_err(tree_leaves(trunc), plain):
            raise AssertionError("truncate_orswot through the merge kernel != the plain path")
        k2.check("the truncate")
        rep["k2_launches_checked"] = k2.checked
    rep["peak_memory_gb"] = max(torch.cuda.max_memory_allocated() / 1e9,
                                rep["session"]["peak_memory_gb"], rep["session"]["earlier_peak_gb"])
    return launches, rep, p, ids


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

    uniq, inv = np.unique(obj, return_inverse=True)
    rows = delta.take_rows(fleet, rows_of(uniq, fleet.clock.device))
    return gather(tree_map(torch.Tensor.cpu, rows),
                  inv, member=member)


def np_svv(clock, span):
    """Per-subtree max of a host ``[N, W]`` clock plane (numpy)."""
    return np.stack([clock[s:s + span].max(axis=0) for s in range(0, clock.shape[0], span)])


def refresh_frontier(trk, conv, fleet, prev, span):
    """Evidence from peer "eq" (the fleet as it is) and peer "lag" (the
    fleet with subtree 0's clocks as of ``prev``, the last refresh), then
    the frontier on the card; held against a numpy min over the peers.
    Returns ``(report, fold ms, this refresh's host svv)``."""

    lag = VClockBatch(clocks=torch.cat([prev[1][:span], fleet.clock[span:]]))
    for peer, b in (("eq", fleet), ("lag", lag)):
        trk.observe_converged(peer, b)
        conv.observe_version_vector(peer, digest.version_vector(b))
    report, ms, _ = timed_ms(lambda: trk.frontier(fleet, peers=["eq", "lag"]))
    svv = np_svv(counters_to_numpy(fleet.clock), span).astype(np.uint64)
    lag_svv = np.concatenate([prev[0][:1], svv[1:]])
    fleet_min = np.minimum(svv.max(axis=0), lag_svv.max(axis=0))
    want = np.maximum(np.minimum(svv, lag_svv), fleet_min)
    if not (np.array_equal(report.clock, fleet_min)
            and np.array_equal(report.subtree_clocks, want)):
        raise AssertionError("the frontier != the numpy min over the peers")
    return report, ms, svv


def kind_fleets(dev, rng):
    """A fleet of each other read kind, from seeded numpy planes, on the
    card and on the CPU: GCounter (64 actors), PNCounter ([2, 32]), LWW
    and MVReg (K=8 x 64) at phase 8's widths, u64, 65,536 objects;
    Map<K, MVReg> at phase 9's (A=64, K=16, D=8, mv 8), u32, 8,192."""

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


def read_kinds(dev, rng) -> dict:
    """One 8,192-row batch of each other kind on the card, against the CPU."""

    t0 = now()
    on_card, on_cpu, keys = kind_fleets(dev, rng)
    out = {"build_s": now() - t0}
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
    return out


def read_phase(dev, fleet, diverged):
    """Phase 11: the read front-end on the north-star fleet (phase 10's
    replica P).  Returns the merge kernel's launches on the phase's path
    (the auditor's self-merge) and the fleet with the writes folded in,
    which phase 12 reconciles."""

    uni = star_universe()
    rng = seeded(11)
    rep = {"objects": N_TOTAL, "shape": [A, M, D], "batch": READ_B,
           "fleet": "phase 10's replica P"}
    obs = kernel_observatory()
    with K2Launches() as k2:
        t0 = now()
        robj, rmember, wobj = read_traffic(rng)
        rep["draw_s"] = now() - t0
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
                t0 = now()
                ops, _ = derive_add_ctx(fleet.clock, w, rng.randint(0, A, w.size).astype(np.int32),
                                        member=rng.randint(1 << 16, (1 << 16) + 4, w.size)
                                        .astype(np.int32))
                fleet, _ = applier.apply_ops(fleet, ops)
                heat.record_writes(w, N_TOTAL)
                sync()
                write_s.append(now() - t0)
            sl = slice(i * READ_B, (i + 1) * READ_B)
            obj, member = robj[sl], rmember[sl]
            mode = "frontier" if i % READ_FRONTIER_EVERY == 0 else "eventual"
            if mode == "frontier":
                report, ms, svv = refresh_frontier(trk, conv, fleet, prev, span)
                prev = (svv, fleet.clock)
                fold_ms.append(ms)
            if not admit(mode, None, conv.version_vectors()["eq"][0],
                         None if report is None else report.clock).admitted:
                raise AssertionError(f"a {mode} read batch was not admitted")
            t0 = now()
            frame = gather(fleet, obj, member=member)
            walls.append((now() - t0) * 1e3)
            t0 = now()
            heat.record_reads(obj, N_TOTAL, mode)
            sync()
            rec_ms.append((now() - t0) * 1e3)
            t0 = now()
            same_frame(frame, cpu_frame(fleet, obj, member), f"read batch {i}")
            if mode == "frontier":
                frame.status = stability_statuses(frame, trk.subtree_frontier_clocks(), span)
                floor = report.subtree_clocks[obj // span]
                want = np.where((frame.add_clock <= floor).all(axis=1), 0, ST_NOT_STABLE)
                if not np.array_equal(frame.status, want):
                    raise AssertionError(f"read batch {i}: the statuses != the numpy frontier")
                for s in range(subtrees):
                    not_stable[s] += int((frame.status[obj // span == s] != 0).sum())
            checks_s += now() - t0
        sync()
        if not_stable[0] == 0 or any(not_stable[1:]):
            raise AssertionError(f"ST_NOT_STABLE rows by subtree {not_stable}: want some in the "
                                 "lagging subtree 0 and none elsewhere")

        n_reads = READ_B * READ_NB
        rep.update(reads=n_reads, writes=int(wobj.size), gather_wall_ms=walls,
                   reads_per_s=n_reads / (sum(walls) / 1e3), heat_record_ms=rec_ms,
                   write_fold_s=write_s, frontier_ms=fold_ms, checks_s=checks_s,
                   not_stable_by_subtree=not_stable)

        # the gather's device time and bytes bound, and its copy back
        dev_ms, d2h_ms, moved, bounds = [], [], [], []
        for i in range(READ_TIMED):
            sl = slice(i * READ_B, (i + 1) * READ_B)
            obj_t, mem_t = query._upload(robj[sl], rmember[sl], dev)
            b = obj_t.shape[0]
            out, ms, _ = timed_ms(lambda: query.KERNELS[K_ORSWOT](fleet, obj_t, mem_t))
            t0 = now()
            host = query._download(out)
            d2h_ms.append((now() - t0) * 1e3)
            hits = int(((rmember[sl] >= 0) & (host[0] == 1)).sum())
            in_b = b * (16 + 4 * (A + M)) + hits * 4 * A
            out_b = sum(x.nbytes for x in (*host[:3], *host[3].values()))
            dev_ms.append(ms)
            moved.append(out_b)
            bounds.append(bound_ms(in_b, out_b, 0)[0])
        # the frontier fold's device time (the heat tracker's passes are in
        # heat_record_ms, end to end)
        rep.update(gather_device_ms=dev_ms, gather_bound_ms=bounds, d2h_ms=d2h_ms,
                   d2h_bytes=moved, frontier_fold_bound_ms=bound_ms(
                       nbytes([fleet.clock]), subtrees * A * 4, 0)[0],
                   frontier_fold_ms=cuda_ms(
                       lambda: stability.subtree_fold(fleet.clock, subtrees, span), 10))

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

        # 4,096 reads against the scalar ReadCtx loop (bench_reads' parity gate)
        t0 = now()
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
        rep["parity_s"] = now() - t0

        # the auditor: a sampled self-merge through the wire codec and K2
        sync()
        t0 = now()
        audit = trk.audit(fleet, uni, sample=READ_AUDIT)
        sync()
        rep["audit_s"] = now() - t0
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
        launches = k2_count()
        if launches == 0 or len(k2.checked) != launches or table["timed"] != launches:
            raise AssertionError(f"the merge kernel launched {launches} times, "
                                 f"{len(k2.checked)} checked, observed {table}")
        rep.update(audit_checks=audit.checks, k2=table, capacity=wm, device_memory=mem,
                   gc_due=[eng.due(1), eng.due(8)], stability=trk.snapshot()["aging"])
        rep["kinds"] = read_kinds(dev, rng)
    return launches, rep, fleet


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


def dial_through_roster():
    """Step 2 of phase 12: a listener on 127.0.0.1:0 and a dial to it
    through ``FlappingDialer(schedule=CLUSTER_DIAL)``, each attempt
    recorded in a ``Membership(suspect_after=2)``.  Returns both connected
    sockets, the roster, the refusals' ``cluster.peer_state`` events and
    the flight recorder's last sequence number before the dial."""

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
    return sock, conn, roster, refusals, mark


def cluster_sessions(sa, sb, ra, rb):
    """Run ``sa`` over ``ra`` here and ``sb`` over ``rb`` on a thread.
    Whichever finishes first lingers on its link until the other has
    returned (``cluster.linger``); then each side closes its own end.  Returns both reports, the seconds
    of the syncs and of the whole exchange with the closes, and each
    link's ``counts()`` when its session returned."""

    out, err, done = {}, [], threading.Event()
    t0 = now()

    def run_b():
        try:
            out["b"] = sb.sync(rb)
            out["b_s"], out["b_counts"] = now() - t0, rb.counts()
            linger(rb, done.is_set, CLUSTER_JOIN_S)
            rb.close()
        except BaseException as e:  # re-raised in the caller's thread
            err.append(e)

    t = threading.Thread(target=run_b, name="phase12-q", daemon=True)
    t.start()
    try:
        out["a"] = sa.sync(ra)
        out["a_s"], out["a_counts"] = now() - t0, ra.counts()
    finally:
        done.set()
        linger(ra, lambda: not t.is_alive(), CLUSTER_JOIN_S)
        t.join(timeout=CLUSTER_JOIN_S)
        ra.close()
    if t.is_alive():
        raise AssertionError("the peer session over TCP hung")
    if err:
        raise err[0]
    return (out["a"], out["b"], max(out["a_s"], out["b_s"]), now() - t0,
            (out["a_counts"], out["b_counts"]))


def cluster_phase(dev, fleet):
    """Phase 12: phase 11's replica P and a copy, each diverged on its own
    1% of the rows, reconciled over loopback TCP by two flat sessions
    through ``ResilientTransport(FaultyTransport(TcpTransport))`` with
    faults injected on both sides (A=64, M=16, D=2, u32).  Returns the
    merge kernel's launches on the phase's path (the sessions' applies)
    and the reconciled replica P, which phase 13 gossips."""

    uni = star_universe()
    rng = seeded(12)
    t_phase = now()
    rep = {"objects": N_TOTAL, "shape": [A, M, D], "divergence": SYNC_DIV,
           "fleet": "phase 11's replica P as it stands", "faults": CLUSTER_FAULTS,
           "policy": CLUSTER_POLICY}
    with K2Launches() as k2:
        # 1. the second replica: P as phase 11 left it (its op writes leave
        # member slots out of ascending-id order) and its copy Q each take
        # their own adds
        p, rows_p = diverge(fleet, rng, 1, 1 << 20, dev)
        q, rows_q = diverge(fleet, rng, 0, 1 << 21, dev)
        del fleet
        planted = np.union1d(rows_p, rows_q)
        rep["full_state_bytes"], rep["full_state_encode_s"] = full_state_bytes(p, uni)
        sync()
        rep["build_s"] = now() - t_phase

        # 2. the link, dialed through the roster
        sock, conn, roster, refusals, mark = dial_through_roster()
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
            sync()
        finally:
            obs.set_enabled(False)
        launches = k2_count()
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
        session_checks(p, q, sa, sb, (ra, rb), planted, uni, rng, k2, self_merge=True)
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
        transitions=transitions, roster=roster.snapshot(), injected_total=injected)
    for side, r, end, (wire, faulty), synced in (("p", ra, ends[0], taps[0], at_sync[0]),
                                                  ("q", rb, ends[1], taps[1], at_sync[1])):
        rep[side] = session_row(
            r, delta_chunks=r.delta_chunks_sent, socket_frames=wire.frames,
            socket_bytes=wire.bytes, counts=synced, counts_closed=end.counts(),
            rtt=end.rtt.snapshot(), rto_s=end.current_rto(), injected=faulty.injected)
    return launches, rep, sa.batch


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
# the telemetry plane: each node publishes into its own registry, gossips a
# FleetObservatory and serves an exporter on 127.0.0.1:0; after every round
# the main thread scrapes these routes of every node (and one unknown
# route, which must answer 404); one idle round after convergence runs
# under tracing.profile into GOSSIP_PROFILE_DIR (removed at the end)
GOSSIP_ROUTES = ("/metrics", "/events?kind=sync", "/fleet?format=json", "/kernels",
                 "/stability", "/heat?plan=mesh:8", "/healthz")
GOSSIP_PROFILE_DIR = os.path.join("build", "chip_smoke_profile_13")


def prom_name_patterns() -> dict:
    """kind -> the compiled patterns of every Prometheus family name the
    port's publisher can render (``*`` segments as identifiers)."""

    out = {}
    for pattern, kind in publish.names():
        body = "[A-Za-z0-9_]+".join(re.escape(metrics.sanitize(p)) for p in pattern.split("*"))
        suffix = "_total" if kind == "counter" else ""
        out.setdefault(kind, []).append(re.compile(f"{metrics.PROM_PREFIX}_{body}{suffix}"))
    return out


def parse_prom(text: str, patterns: dict, what: str) -> dict:
    """Every line of a text exposition parsed: ``# TYPE`` lines name
    families the publisher's table can render, sample lines belong to a
    declared family (a histogram's ``_bucket``/``_sum``/``_count``) and
    carry a number.  Returns ``{sample name with labels: value}``."""
    kinds, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            if not any(p.fullmatch(name) for p in patterns.get(kind, ())):
                raise AssertionError(f"{what}: family {name} ({kind}) is not in the name table")
            kinds[name] = kind
            continue
        name, value = line.rsplit(" ", 1)
        base = name.split("{", 1)[0]
        if base not in kinds and not any(
                base == f + sfx and kinds[f] == "histogram" for f in kinds
                for sfx in ("_bucket", "_sum", "_count")):
            raise AssertionError(f"{what}: sample {line!r} of no declared family")
        samples[name] = float(value.replace("+Inf", "inf").replace("-Inf", "-inf"))
    return samples


def http_get(server, path: str) -> tuple:
    """``(status, body text, ms)`` of one GET against an exporter."""

    t0 = now()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}", timeout=60) as r:
            status, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    return status, body, (now() - t0) * 1e3


def gossip_scrape(fleet, patterns: dict, route_ms: dict, exact: bool, k2_calls: int) -> list:
    """Scrape every route of every node's exporter and check it: each
    answers 200 and an unknown route 404; ``/metrics`` and ``/kernels``
    parse and name only table families; ``/kernels``' merge-kernel calls
    equal ``launch_counts()`` read before and after, and ``k2_calls``, the
    launches the wrapper capture saw since the counts were reset (an
    independent count); ``/healthz``' reads
    lie between the node's ``ServeLoop.counts()`` before and after (equal
    to it when ``exact``: the reader stopped).  Returns each node's
    ``/fleet?format=json`` body."""

    fleets = []
    for m in fleet:
        before = (k2_count(), m.node.serve_loop().counts())
        bodies = {}
        for route in GOSSIP_ROUTES:
            status, body, ms = http_get(m.server, route)
            route_ms.setdefault(route.split("?")[0], []).append(ms)
            if status != 200:
                raise AssertionError(f"{m.name} {route}: HTTP {status}: {body[:300]}")
            bodies[route] = body
        after = (k2_count(), m.node.serve_loop().counts())
        status, body, _ = http_get(m.server, "/no-such-route")
        if status != 404 or not body.startswith("not found"):
            raise AssertionError(f"{m.name}: an unknown route answered {status}")
        parse_prom(bodies["/metrics"], patterns, f"{m.name} /metrics")
        kern = parse_prom(bodies["/kernels"], patterns, f"{m.name} /kernels")
        calls = kern.get("crdt_tpu_kernel_orswot_merge_calls_total")
        if not before[0] == calls == after[0] == k2_calls:
            raise AssertionError(f"{m.name} /kernels: orswot_merge calls {calls}, launch_counts "
                                 f"{before[0]} before and {after[0]} after, {k2_calls} launches "
                                 f"captured")
        reads = json.loads(bodies["/healthz"])["serve"]["reads"]
        lo, hi = before[1]["reads"], after[1]["reads"]
        if not lo <= reads <= hi or (exact and not lo == reads == hi):
            raise AssertionError(f"{m.name} /healthz: serve reads {reads}, ServeLoop.counts() "
                                 f"{lo} before and {hi} after")
        m.last_bodies = bodies
        fleets.append(json.loads(bodies["/fleet?format=json"]))
    return fleets


def gossip_fleet_checks(fleet, fleets: list) -> dict:
    """The telemetry plane after the reader stopped: every node's
    ``/fleet`` lists the three nodes, its own slice carries its scheduler's
    counts, and the fleet counter of the schedulers' session legs is the
    sum of the slices'; the fleet-merged hot list of a fresh capture of
    each node agrees in ``(obj, count)`` with ``merge_hot`` of the nodes'
    sketches, and each node's ``/heat?plan=mesh:8`` report equals
    ``score_plan`` of its heat vector.  Returns the merged snapshot's bytes
    and nodes."""

    names = [m.name for m in fleet]
    for m, view in zip(fleet, fleets):
        if view["nodes"] != names:
            raise AssertionError(f"{m.name} /fleet lists {view['nodes']}, not {names}")
        own = view["slices"][m.name]["counters"]
        sched = m.sched.counts()
        if (own.get("cluster.sessions.ok"), own.get("cluster.rounds")) != \
                (sched["sessions_ok"], sched["rounds"]):
            raise AssertionError(f"{m.name}: its slice's scheduler counts differ from {sched}")
        legs = sum(sl["counters"].get("cluster.sessions.ok", 0) for sl in view["slices"].values())
        if view["fleet"]["counters"].get("cluster.sessions.ok") != legs:
            raise AssertionError(f"{m.name} /fleet: the fleet's session legs are not the sum of "
                                 f"its slices'")
        report = json.loads(m.last_bodies["/heat?plan=mesh:8"])["report"]
        layout = m.node.heat.snapshot()["layout"]
        want = heat_mod.score_plan("mesh:8", m.node.heat.heat_vector(),
                                   n=max(layout["objects"], 1), span=layout["span"])
        if report != json.loads(json.dumps(want)):
            raise AssertionError(f"{m.name} /heat?plan=mesh:8 differs from score_plan")
    snap = FleetSnapshot()
    for m in fleet:
        m.node.heat.publish()
        snap = snap.merge(m.observatory.capture())
    got = [(h["obj"], h["count"]) for h in snap.fleet_heat()["hot"]]
    want = [(h["obj"], h["count"]) for h in heat_mod.merge_hot([m.node.heat.hot()
                                                                for m in fleet])]
    if not got or got != want:
        raise AssertionError(f"fleet_heat's hot list {got[:4]}... differs from merge_hot's "
                             f"{want[:4]}...")
    frame = encode_snapshot(snap)
    return {"bytes": len(frame), "nodes": len(snap.slices), "hot_objects": len(got)}


def profiled_round(fleet, r: int) -> tuple:
    """One more fleet round, its first scheduler's round (that node's two
    legs, and their acceptors' on the peers) under ``tracing.profile``:
    the record, and the device's busy share of that scheduler round's wall
    (the kernels' device time over the wall).  A profiler that did not
    start or stop, wrote no trace or saw no device time fails the phase.
    The busy time is summed over the profiler's raw device events:
    ``key_averages()`` builds an object per event, far slower for a
    round's ~10^5 kernels and their host ops."""

    from torch.autograd import DeviceType

    unavailable = tracing.unavailable_count()
    try:
        x = gossip_round(fleet, r, profile_dir=GOSSIP_PROFILE_DIR)
        prof, wall = x.pop("profile")
        if prof is None or tracing.unavailable_count() != unavailable:
            failed = events.recorder().snapshot("obs.profiler_unavailable")
            raise AssertionError(f"the profiler failed in round {r}: "
                                 f"{failed[-1]['fields'] if failed else 'it yielded None'}")
        trace = sum(os.path.getsize(os.path.join(GOSSIP_PROFILE_DIR, f))
                    for f in os.listdir(GOSSIP_PROFILE_DIR))
        device = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not _annotation(e)]
        busy = sum(e.duration_ns() for e in device) / 1e6
    finally:
        shutil.rmtree(GOSSIP_PROFILE_DIR, ignore_errors=True)
    if not trace or not device or busy <= 0:
        raise AssertionError(f"the profiled round {r} recorded {len(device)} device events, "
                             f"{busy} ms busy, {trace} B of trace")
    out = {"node": fleet[0].name, "wall_s": wall, "fleet_round_wall_s": x["wall_s"],
           "busy_ms": busy, "busy_share": busy / (wall * 1e3), "kernels": len(device),
           "trace_bytes": trace}
    return x, out


class GossipMember:
    """One node of the phase 13 and 14 fleets: the ``ClusterNode`` (with
    ``node_kw``, e.g. ``durability=``), a listener on 127.0.0.1:0 whose
    accepted links run the acceptor's leg through
    ``ResilientTransport(TcpTransport)``, a dialer of the same stack and
    the node's scheduler.  Accepted sessions land in ``inbound`` as
    ``(peer, report or exception, wall seconds)``."""

    def __init__(self, i: int, batch, uni, **node_kw):
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
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.links += 1
        return ResilientTransport(TcpTransport(sock, default_timeout=60.0),
                                  RetryPolicy(**GOSSIP_POLICY), name=self.name,
                                  seed=SEED + 130 + 100 * self.i + self.links)

    def _listen(self):
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
        link = self.link(sock)
        peer, t0 = "?", now()
        try:
            peer = hello_accept(link, timeout=30.0)
            self.inbound.append((peer, self.node.accept(link, peer_id=peer),
                                 now() - t0))
        except Exception as e:  # noqa: BLE001 - recorded, and the phase fails on it
            self.inbound.append((peer, e, now() - t0))
        finally:
            link.close()

    def scheduler(self, fleet, fanout: int = 2):
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
        self.members, self.robj, self.rmember = members, robj, rmember
        self.acks = [None] * len(members)
        self.tokens = [None] * len(members)
        self.stop = threading.Event()
        self.errors, self.calls = [], []
        self.batches = self.ryw_checked = 0
        self.thread = threading.Thread(target=self._run, name="gossip-reader", daemon=True)

    def _request(self, k: int, b: int):
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

    node, i = member.node, member.i
    k = GOSSIP_WRITES // GOSSIP_NODES
    obj = wobj[:k]
    mem = (GOSSIP_MEMBER0 + rng.randint(0, GOSSIP_MEMBERS, k)).astype(np.int32)
    torch.cuda.empty_cache()  # the fold's whole-fleet temporaries want contiguous room
    t0 = now()
    ops, _ = derive_add_ctx(node.write_clock(), obj, np.full(k, i + 1, np.int32), member=mem)
    node.submit_ops(ops)
    ack = node.write_vv()
    secs = now() - t0
    kept[i].append(ops)
    return secs, ack, obj, mem


def gossip_round(fleet, r: int, profile_dir=None) -> dict:
    """One fleet round: each scheduler's ``run_round`` in turn.  Returns the
    round's record: wall seconds, each session leg's report (dialed and
    accepted), each scheduler's health view, the failed legs, and the
    refusals by a node's busy bound with the failures they caused (a
    refused dial's other leg fails with a transport error; that is the
    bound's designed behaviour, counted apart).  With ``profile_dir`` the
    first scheduler's round runs under ``tracing.profile``: the record's
    ``profile`` is ``(profiler or None, that round's wall seconds)``."""

    marks = [len(m.inbound) for m in fleet]
    t0 = now()
    reports, failed, busy, health, profiled = [], [], set(), {}, None
    for m in fleet:
        seen = events.recorder().snapshot()
        mark = seen[-1]["seq"] if seen else 0
        if profile_dir is not None and profiled is None:
            with tracing.profile(profile_dir) as prof:
                t_prof = now()
                rep = m.sched.run_round()
                profiled = (prof, now() - t_prof)
        else:
            rep = m.sched.run_round()
        health[m.name] = rep.health
        reports += [(m.name, peer, "dial", x) for peer, x in rep.reports.items()]
        for e in events.recorder().snapshot("cluster.session"):
            f = e["fields"]
            if e["seq"] > mark and f["outcome"] == "failed":
                failed.append((m.name, f["peer"], "dial", f["error"]))
    wall = now() - t0
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
            "diverged": sum(x[3].diverged for x in reports), "profile": profiled}


def gossip_checks(fleet, start_host, kept, written, k2, dev):
    """Phase 13's plane checks: the rows no write touched equal the starting
    replica on every node, bit for bit; every node's batch, self-merged,
    equals the first node's, which equals the merge kernel's join of the
    starting replica with each node's kept op batches applied by
    ``OpApplier`` (the three nodes start from one replica).  The join is
    built after the nodes are dropped (three replicas, the start, the join
    and an op fold's whole-fleet temporaries do not fit the card at once).
    Each merge-kernel launch is held against ``merge_reference``.  Closes
    the fleet."""

    uni = fleet[0].node.universe
    kept_rows = np.ones(N_TOTAL, bool)
    kept_rows[np.unique(written)] = False
    batches = [m.node.batch for m in fleet]
    for lo in range(0, N_TOTAL, CHUNK):
        sl, rows = slice(lo, lo + CHUNK), torch.from_numpy(kept_rows[lo:lo + CHUNK]).to(dev)
        ref = flat_rows(tree_map(lambda x: x[sl].to(dev), start_host), rows)
        for m, batch in zip(fleet, batches):
            same_planes(flat_rows(flat_rows(batch, sl), rows), ref,
                        f"{m.name} on a row no write touched, against the start")
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
    start = tree_map(lambda x: x.to(dev), start_host)
    join = None
    for ops in kept:
        applied, _ = OpApplier(uni).apply_ops(start, OpBatch.concat(ops))
        join = applied if join is None else join.merge(applied)
        k2.check("the oracle's join")
        del applied
        torch.cuda.empty_cache()
    same_planes(merged, join, "the nodes self-merged against the merge kernel's join of the "
                "starting replica and every node's writes")


def gossip_phase(dev, start):
    """Phase 13: three ``ClusterNode``s on the card (phase 12's replica P
    and two copies) gossip by their schedulers over loopback TCP while they
    take writes and a reader thread serves reads, until the nodes' digests
    agree and a whole round finds no divergence.  Returns the merge
    kernel's launches on the phase's path (the sessions' applies and the
    auditor's self-merges)."""

    t_phase = now()
    rng = seeded(13)
    patterns, route_ms, servers, profiled = prom_name_patterns(), {}, [], None
    rep = {"objects": N_TOTAL, "shape": [A, M, D], "nodes": GOSSIP_NODES,
           "fleet": "phase 12's replica P and two copies", "policy": GOSSIP_POLICY,
           "writes_per_round": GOSSIP_WRITES, "write_rounds": GOSSIP_WRITE_ROUNDS,
           "members": [GOSSIP_MEMBER0, GOSSIP_MEMBER0 + GOSSIP_MEMBERS - 1],
           "read_batch": GOSSIP_READ_B, "read_pause_s": GOSSIP_READ_PAUSE_S,
           "park_timeout_s": GOSSIP_PARK_S}
    uni = star_universe()
    robj, rmember, wobj = read_traffic(rng)
    # the start stays on the host for the checks: n0 holds its planes only
    # until its first fold replaces them
    start_host = tree_map(torch.Tensor.cpu, start)
    fleet, kept, written, rounds, write_s = [], [[] for _ in range(GOSSIP_NODES)], [], [], 0.0
    with K2Launches() as k2:
        try:
            for i in range(GOSSIP_NODES):
                batch = start if i == 0 else tree_map(torch.clone, start)
                reg = MetricsRegistry()
                fleet.append(GossipMember(i, batch, uni, registry=reg,
                                          observatory=FleetObservatory(f"n{i}", registry=reg),
                                          capacity_tracker=CapacityTracker(device=dev)))
            del start, batch
            for m in fleet:
                m.scheduler(fleet)
                m.node.serve_loop().park_timeout_s = GOSSIP_PARK_S
                m.observatory = m.node.observatory
                m.server = start_metrics_server(
                    port=0, registry=m.node.registry, tracker=convergence.tracker(),
                    observatory=m.observatory, capacity=m.node.capacity_tracker,
                    stability=m.node.stability, heat=m.node.heat)
                servers.append(m.server)
            sync()
            rep["build_s"] = now() - t_phase
            reader = GossipReader(fleet, robj, rmember)
            obs = kernel_observatory()
            obs.reset()
            _build.reset_launch_counts()
            k2_mark = len(k2.seen)
            obs.set_enabled(True)
            t_rounds = now()
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
                    if x["failed"]:
                        raise AssertionError(f"round {r}: failed session legs {x['failed']}")
                    gossip_scrape(fleet, patterns, route_ms, exact=False,
                                  k2_calls=len(k2.seen) - k2_mark)
                    if x["digests_equal"]:
                        break
                if rounds[-1]["digests_equal"]:
                    # one more round, idle, under the profiler
                    x, profiled = profiled_round(fleet, len(rounds) + 1)
                    x["digests_equal"] = None
                    rounds.append(x)
                    if x["failed"] or x["diverged"]:
                        raise AssertionError(f"the profiled idle round: failed {x['failed']}, "
                                             f"diverged {x['diverged']}")
            finally:
                reader.stop.set()
                reader.thread.join(timeout=GOSSIP_JOIN_S)
            sync()
            rounds_s = now() - t_rounds
            obs.set_enabled(False)
            launches = k2_count()
            table = obs.table()["orswot_merge"]
            if reader.thread.is_alive():
                raise AssertionError("the reader thread hung")
            if reader.errors:
                raise reader.errors[0]
            if profiled is None:
                raise AssertionError(f"no convergence in {len(rounds)} rounds")
            fleets = gossip_scrape(fleet, patterns, route_ms, exact=True,
                                   k2_calls=len(k2.seen) - k2_mark)
            rep["fleet_snapshot"] = gossip_fleet_checks(fleet, fleets)
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
            rep["scheduler_counts"] = {m.name: m.sched.counts() for m in fleet}
            obs_counts = {m.name: m.observatory.counts() for m in fleet}
            gossip_checks(fleet, start_host, kept, np.concatenate(written), k2, dev)
        finally:
            for server in servers:
                server.stop()
            for m in fleet:
                m.close()

    calls = reader.calls
    rows = sum(c["rows"] for c in calls)
    e2e = sum(c["e2e_s"] for c in calls)
    stage = {k: sum(c["stage_s"][k] for c in calls) for k in ("decode", "serve", "encode")}
    sessions = [session_row(r, round=x["round"], node=node, peer=peer, leg=leg,
                            tree=r.tree_mode, fleet_bytes_sent=r.fleet_bytes_sent,
                            fleet_nodes=r.fleet_nodes, bytes_sent=r.bytes_sent)
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
        park_wait_s=sum(c["park_wait_s"] for c in counts))
    leg_wall = sum(s["wall_s"] for s in sessions)
    obs_s = {k: sum(c[k] for c in obs_counts.values()) for k in ("encode_s", "merge_s")}
    rep["observatory"] = {
        "per_node": {n: {k: c[k] for k in ("encodes", "encode_s", "decoded", "merge_s", "merges",
                                           "nodes", "rejected")} for n, c in obs_counts.items()},
        **obs_s, "share_of_leg_walls": (obs_s["encode_s"] + obs_s["merge_s"]) / leg_wall,
        "fleet_bytes_per_leg": [s["fleet_bytes_sent"] for s in sessions]}
    rep["scrape_ms"] = {route: {"p50": float(np.median(ms)), "max": max(ms), "n": len(ms)}
                        for route, ms in route_ms.items()}
    rep["profiled_round"] = profiled
    return launches, rep


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

    os.makedirs(DURABLE_DIR, exist_ok=True)
    return shutil.disk_usage(DURABLE_DIR).free, host_available()


def npz_pin_matches() -> bool:
    """Whether this host's numpy writes the pinned checkpoint's bytes
    (:data:`NPZ_PIN`), twice alike."""

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


def durable_phase(dev, start):
    """Phase 14: a durable node on the card takes fsync'd WAL writes,
    checkpoints the 1.25M-object replica at round end, is killed in the
    middle of a fold, is restored from its snapshot and WAL onto the card
    and rejoins its peer by delta sync.  Returns the merge kernel's
    launches on the phase's path (the sessions' applies and audits)."""

    t_phase = now()
    rng = seeded(14)
    k = GOSSIP_WRITES // GOSSIP_NODES
    replica_bytes = nbytes(tree_leaves(start))
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    free, avail = durable_room()
    rep = {"objects": N_TOTAL, "shape": [A, M, D], "replica_bytes": replica_bytes,
           "fleet": "phase 12's replica P and a copy", "writes_per_batch": k,
           "durability": {"interval_rounds": 1, "retain": 2, "fsync": True},
           "disk_free_bytes": free, "host_available_bytes": avail,
           "numpy": np.__version__, "npz_bytes_match_pin": npz_pin_matches()}
    if free < 1.05 * replica_bytes:
        raise AssertionError(f"the durable directory's filesystem has {free} bytes free, less "
                             f"than one generation ({replica_bytes} bytes of planes); host "
                             f"memory available {avail} bytes")
    uni = star_universe()
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
        if x["failed"]:
            raise AssertionError(f"{what} round {r}: failed session legs {x['failed']}")
        return x

    with K2Launches() as k2:
        try:
            fleet.append(GossipMember(0, start, uni))
            copy = tree_map(torch.clone, start)
            del start
            fleet.append(GossipMember(1, copy, uni, durability=Durability(
                DURABLE_DIR, interval_rounds=1, retain=2, fsync=True)))
            del copy
            schedule(fleet)
            sync()
            rep["build_s"] = now() - t_phase
            _build.reset_launch_counts()
            t_path = now()
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
            ck_digests = snap.digests
            rep["checkpoint"] = {"generation": snap.generation, "wal_seq": snap.wal_seq,
                                 "bytes": snap.nbytes, "split_s": dict(snap.split_s),
                                 "wall_s": sum(snap.split_s.values())}
            k2_round1 = k2_count()
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
            sync()
            before = torch.cuda.memory_allocated()
            fleet[1].close()
            fleet[1].sched = None
            fleet[1] = None
            freed = before - torch.cuda.memory_allocated()
            rep["kill_freed_bytes"] = freed
            if freed < replica_bytes:
                raise AssertionError(f"dropping n1 freed {freed} bytes of device memory, less "
                                     f"than its replica's {replica_bytes}: a reference survives")
            # 6. n0 writes while n1 is down
            writes(fleet[0])
            # 7. restore from the snapshot and the WAL onto the card
            t0 = now()
            rec = recover(DURABLE_DIR, device="cuda")
            sync()
            rep["restore"] = {"wall_s": now() - t0, "split_s": dict(rec.split_s),
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
            sync()
            rep["path_s"] = now() - t_path
            launches = k2_count()
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

    rep.update(peak_host_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
               rounds=[{"phase": x["phase"], "round": x["round"], "wall_s": x["wall_s"],
                        "diverged": x["diverged"]} for x in rounds])
    return rep["k2_launches"], rep


# -- phase 15 ------------------------------------------------------------------

AE_MAX_ROUNDS, AE_CPU_N, NCCL_SMALL_N = 3, 512, 4096


def collectives_phase(dev):
    """Phase 15: ``anti_entropy`` over the north-star fleet's 20 chunks
    (the pairwise fold, then self-merges: every merge the merge kernel),
    chunk 0 held against the fold kernel's plunger fold and the CPU, its
    fold and one self-merge timed alone; then each collective join over
    NCCL at world size one.  Returns each kernel's launches on the
    phase's path."""

    rng = seeded(15)
    rep = {"objects": N_TOTAL, "chunk": CHUNK, "shape": [A, M, D, R],
           "max_rounds": AE_MAX_ROUNDS, "rounds": [], "ms": [], "wall_ms": []}
    with K2Launches() as k2:
        for c in range(N_TOTAL // CHUNK):
            planes = star_planes(rng, dev)
            (merged, rounds), ms, wall = timed_ms(lambda: anti_entropy(
                OrswotBatch(*planes), AE_MAX_ROUNDS))
            rep["ms"].append(ms)
            rep["wall_ms"].append(wall)
            rep["rounds"].append(rounds)
            k2.check(f"phase 15 chunk {c}")
            if c == 0:
                first = (planes, tree_leaves(merged), rounds)
            del planes, merged
        launches = _build.launch_counts()
        if not launches["orswot_merge"] or launches["orswot_fold_aligned"] + launches[
                "orswot_fold"]:
            raise AssertionError(f"anti_entropy did not run through the merge kernel: {launches}")

        planes, got, rounds = first
        # the fold kernel's plunger fold is rounds 1 and 2: a third round
        # runs when the plunger changed the fold, and adds one self-merge
        fold, want = (orswot_ops.fold_merge(*planes, M, D, plunger=p, impl="pallas",
                                            u_cap=U_CAP) for p in (False, True))
        if bool(fold[5].any() or want[5].any()):
            raise AssertionError("chunk 0: the fold kernel flagged overflow")
        ref_rounds = 2 if not max_abs_err(fold[:5], want[:5]) else AE_MAX_ROUNDS
        want = want[:5]
        for _ in range(ref_rounds - 2):
            want = orswot_ops.merge(*want, *want, M, D)[:5]
        cpu, rep["cpu_rounds"] = anti_entropy(OrswotBatch(*(
            x[:, :AE_CPU_N].cpu() for x in planes)), AE_MAX_ROUNDS)
        for what, x, y in (
                (f"fold_merge(plunger=True) + self-merges, {ref_rounds} rounds", want, ref_rounds),
                (f"the CPU on its first {AE_CPU_N} objects", tree_leaves(cpu), rounds)):
            if max_abs_err(x, [p[:x[0].shape[0]].to(x[0].device) for p in got]) or y != rounds:
                raise AssertionError(f"chunk 0: anti_entropy ({rounds} rounds) != {what}")
        k2.check("phase 15 chunk 0 cross-checks")
        rep["k2_checked"] = len(k2.checked)
    # anti_entropy's two parts on chunk 0, by CUDA events, past the count
    fold = orswot_ops.fold_merge_sequential(*planes, M, D, plunger=False)
    rep["fold_ms"] = cuda_ms(lambda: orswot_ops.fold_merge_sequential(*planes, M, D,
                                                                      plunger=False), 5)
    rep["self_merge_ms"] = cuda_ms(lambda: orswot_ops.merge(*fold[:5], *fold[:5], M, D), 5)

    with tempfile.TemporaryDirectory() as tmp:
        initialize(num_processes=1, process_id=0, store=dist.FileStore(f"{tmp}/store", 1))
        try:
            rep["nccl_ms"] = nccl_joins(dev, planes, got)
        finally:
            dist.destroy_process_group()
    rep["launches"] = launches
    return None, rep, launches


def nccl_joins(dev, planes, merged) -> dict:
    """Each collective join over NCCL at world size one must give this
    rank's state back, and a CPU tensor must not reach the NCCL group.
    Returns each join's device ms, first call (the group's NCCL set-up)
    and second."""

    mesh = make_mesh({"replicas": 1}, device="cuda")
    hybrid = make_multihost_mesh({"replicas": 1}, {"objects": 1}, device="cuda")
    if str(dist.get_backend(mesh.get_group("replicas"))) != "nccl":
        raise AssertionError("the CUDA mesh's group is not NCCL")
    rng, n = seeded(16), NCCL_SMALL_N
    uni = Universe(CrdtConfig.gpu_default(num_actors=A))
    orswot = OrswotBatch(*(x[None] for x in merged))
    lww = LWWRegBatch.from_numpy(rng.randint(0, 9, n), rng.randint(1, 99, n), device=dev)
    gset = GSetBatch(torch.from_numpy(rng.rand(n, 1024) < 0.3).to(dev))
    mvreg, mp = MVRegBatch.zeros(n, uni, dev), MapBatch.zeros(
        n, uni, MVRegKernel.from_config(uni.config), dev)
    ms = {}
    for name, fn, want in (
            ("clock", lambda: all_reduce_clock_join(planes[0], mesh),
             planes[0].amax(dim=0, keepdim=True).expand(planes[0].shape)),
            ("orswot", lambda: allgather_join_orswot(orswot, mesh), orswot),
            ("orswot_object_axis", lambda: allgather_join_orswot(
                orswot, hybrid, object_axis="objects"), orswot),
            ("map", lambda: allgather_join_map(mp, mesh), mp),
            ("lww", lambda: allgather_join_lww(lww, mesh)[0], lww),
            ("mvreg", lambda: allgather_join_mvreg(mvreg, mesh), mvreg),
            ("gset", lambda: allgather_join_gset(gset, mesh), gset)):
        ms[name] = [timed_ms(fn)[1] for _ in range(2)]
        if not all(map(torch.equal, tree_leaves(fn()), tree_leaves(want))):
            raise AssertionError(f"NCCL {name} join != the local state")
    try:
        all_reduce_clock_join(planes[0].cpu(), mesh)
    except ValueError:
        pass
    else:
        raise AssertionError("a CPU tensor reached the NCCL group")
    if allgather_fleet_snapshots(FleetObservatory("chip")).nodes() != ["chip"]:
        raise AssertionError("allgather_fleet_snapshots lost the local slice")
    return ms


# -- phase 16 ------------------------------------------------------------------

# the mesh-sharded fleet, at world size one over NCCL: the north-star fleet
# (A=64, M=16, D=2, u32) laid out in MESH_S shards by the placement planner
# over a Zipf 1.1 history of MESH_WRITES writes, its heat binned at
# MESH_SPAN (the digest tree's span three levels over the leaves: at 1.25M
# objects the level below the root spans 2^20 rows, a granule that would
# pad the fleet 6.4-fold); member sharding at MESH_MS_N objects of logical
# M=64 over 4 member shards of M=16; fleet snapshots of the first
# MESH_SNAP_N objects (a cut by depth: the whole fleet's 6.17 GB take ~22 s
# each way, phase 14)
MESH_S, MESH_SPAN, MESH_WRITES = 8, 4096, 4096
MESH_MS_N, MESH_MS_M, MESH_MS_SHARDS, MESH_SNAP_N = 62_500, 64, 4, 250_000


def member_fleets(rng):
    """Two replicas of ``MESH_MS_N`` sets of up to ``MESH_MS_M`` members
    (``anti_entropy_fleets``, deferred removes on the first) whose members
    are renamed ``row * MESH_MS_M + rank in the row's union``: each member
    shard then owns at most ``MESH_MS_M / MESH_MS_SHARDS`` of a row."""

    reps = anti_entropy_fleets(rng, MESH_MS_N, A, MESH_MS_M, D, 2, base=MESH_MS_M - 8, novel=4,
                               deferred_frac=DEFERRED_FRAC)
    row = np.arange(MESH_MS_N, dtype=np.int64)[:, None] << 32
    ids = [r[1] for r in reps] + [reps[0][3]]
    keys = [np.where(x >= 0, row + x, -1) for x in ids]
    uniq = np.unique(np.concatenate([k[k >= 0] for k in keys]))
    first = np.searchsorted(uniq, row[:, 0])
    for rep, x, k in zip((reps[0], reps[1], reps[0]), (1, 1, 3), keys):
        rank = np.searchsorted(uniq, k) - first[:, None]
        rep[x][...] = np.where(k >= 0, (row >> 32) * MESH_MS_M + rank, -1)
    return reps


def mesh_phase(dev):
    """Phase 16: the mesh-sharded fleet at world size one over NCCL.
    Returns the merge kernel's launches on the phase's path (the step, the
    repairs and the member-sharded merge)."""

    uni, rng = star_universe(), seeded(160)
    rep = {"objects": N_TOTAL, "shape": [A, M, D], "shards": MESH_S}
    tmp = tempfile.mkdtemp()
    initialize(num_processes=1, process_id=0, store=dist.FileStore(f"{tmp}/store", 1))
    try:
        with K2Launches() as k2:
            # 1. the layout: the planner prices granules against the history's heat
            writes = WorkloadGen(N_TOTAL, seed=SEED + 161, zipf_s=1.1).draw(MESH_WRITES)
            heat = HeatTracker(device=dev)
            heat.record_writes(writes, N_TOTAL)
            fine = np.bincount(writes // MESH_SPAN, minlength=-(-N_TOTAL // MESH_SPAN))
            span = heat.snapshot()["layout"]["span"]
            if heat.heat_vector().tolist() != np.add.reduceat(fine, np.arange(
                    0, fine.size, span // MESH_SPAN)).tolist():
                raise AssertionError("the heat tracker's subtree totals != the history's")
            p = OrswotBatch(*(x[0] for x in star_planes(rng, dev, N_TOTAL, 1)))
            q, _ = diverge(p, rng, 0, 1 << 21, dev)
            sa, sb = (mesh.ShardedBatch.shard(x, uni, shards=MESH_S, heat=fine, span=MESH_SPAN)
                      for x in (p, q))
            lay = sa.layout
            rep["layout"] = {**lay.to_json(), "padding_share": 1 - lay.n / lay.padded,
                             "loads": mesh.shard_loads(lay, fine, MESH_SPAN)}

            # 2. one step against the unsharded control, K2 on both
            before = k2_count()
            res, rep["step_ms"], rep["step_wall_ms"] = timed_ms(
                lambda: mesh.anti_entropy_step(sa, sb))
            step_launches = k2_count() - before
            control = p.merge(q)
            if not (step_launches and np.array_equal(res.digests, digest_of(control, uni))
                    and np.array_equal(res.version_vector, version_vector(control))
                    and res.live_members == int((control.ids != EMPTY).sum())):
                raise AssertionError("the mesh step != the unsharded K2 control")
            k2.check("the step and its control")
            del sa, sb, res, control

            # 3. one shard diverged: its rows repaired alone, beside sync_pair
            lo, hi = lay.ranges()[3]
            q, rows = diverge(p, rng, 2, 1 << 22, dev, lo, hi)
            n0, n1 = ClusterNode("m0", p, uni), ClusterNode("m1", q, uni)
            st, _, rep["subset_sync_ms"] = timed_ms(lambda: n0.sync_shard_subset(n1, lay))
            if (st.shards_synced, st.shards_skipped, st.objects) != (1, MESH_S - 1, rows.size) \
                    or not np.array_equal(digest_of(n0.batch, uni), digest_of(q, uni)):
                raise AssertionError(f"the shard-subset sync: {st}")
            rep["sync_pair_ms"] = timed_ms(lambda: sync_pair(SyncSession(p, uni, peer="m1"),
                                                             SyncSession(q, uni, peer="m0")))[2]
            rep["subset_sync"] = {**dataclasses.asdict(st), "object_ids": None}
            k2.check("the repairs")
            del n0, n1, p, q

            # 4. member sharding: logical M=64 over 4 member shards of M=16;
            # the merge, an add on every set, the clock rebroadcast, then a
            # self-merge (the add can make a deferred remove of another shard due)
            mesh_m = make_mesh({"members": 1}, device=dev)
            reps = member_fleets(rng)
            sa, sb = (tuple(tree_leaves(OrswotBatch.from_numpy(*partition_dense(
                *r, MESH_MS_SHARDS, MESH_MS_M // MESH_MS_SHARDS, D), device=dev))) for r in reps)
            actor = torch.from_numpy(rng.randint(0, A, MESH_MS_N).astype(np.int32)).to(dev)
            member = torch.arange(MESH_MS_N, dtype=torch.int32, device=dev) * MESH_MS_M + 63
            counter = torch.from_numpy(bias_np(np.full(MESH_MS_N, 1000, np.uint32))).to(dev)
            got, rep["member_merge_ms"], _ = timed_ms(lambda: member_sharded_merge(sa, sb, mesh_m))
            got = rebroadcast_clock(sharded_apply_add(got, actor, counter, member, mesh_m), mesh_m)
            got = member_sharded_merge(got, got, mesh_m)
            k2.check("the member-sharded merges")
            step = K2_CHECK_CELLS // (MESH_MS_M * 2 * MESH_MS_M * A)

            def plain(x, y):  # the unsharded plain merge, in set chunks
                return [torch.cat(z) for z in zip(*(tile.merge_reference(
                    *(p[s:s + step] for p in (*x, *y)), MESH_MS_M, D)[:5]
                    for s in range(0, MESH_MS_N, step)))]
            dense = [tree_leaves(OrswotBatch.from_numpy(*r, device=dev)) for r in reps]
            want = orswot_ops.apply_add(*plain(*dense[:2]), actor, counter, member)[:5]
            want = OrswotBatch(*plain(want, want))
            back = OrswotBatch.from_numpy(*unpartition_dense(*OrswotBatch(*got).to_numpy(),
                                                             m_cap=MESH_MS_M, d_cap=D), device=dev)
            if not (np.array_equal(digest_of(back, uni), digest_of(want, uni)) and torch.equal(
                    back.ids.sort(-1).values, want.ids.sort(-1).values)
                    and torch.equal(back.clock, want.clock)):
                raise AssertionError("the member-sharded merge != the unsharded plain merge")
            del sa, sb, got, dense, want, back

            # 5. fleet snapshots of the first MESH_SNAP_N objects, S shards
            part = OrswotBatch(*(x[0] for x in star_planes(rng, dev, MESH_SNAP_N, 1)))
            shutil.rmtree(DURABLE_DIR, ignore_errors=True)
            store = mesh.MeshSnapshotStore(DURABLE_DIR, mesh.choose_layout(
                MESH_SNAP_N, MESH_S, span=MESH_SPAN))
            manifest, _, write_ms = timed_ms(lambda: store.write_fleet(part, uni, node_id="m0"))
            (back, _), _, rep["snapshot_load_ms"] = timed_ms(lambda: store.load_fleet(uni, dev))
            rep["snapshot_write_ms"] = write_ms
            digests = digest_of(part, uni)
            if not (np.array_equal(digest_of(back, uni), digests) and manifest["roots"]
                    == mesh.shard_roots(digests, store.layout, dev).tolist()):
                raise AssertionError("the restored fleet's digests != the written fleet's")
            shutil.rmtree(DURABLE_DIR, ignore_errors=True)
            launches = k2_count()
            if launches != len(k2.checked):
                raise AssertionError(f"{launches} merge-kernel launches, {len(k2.checked)} checked")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    rep.update(counts=mesh.mesh_counts(), k2_launches=launches)
    return launches, rep


# phase 17: the tools as children on the card (each run: tool, arguments);
# the wide-merge check's fleet (M=128, as the gossip's --gc planes start)
TOOLS_DEMO_N, TOOLS_GOSSIP_N, TOOLS_MESH_N, TOOLS_TIMEOUT_S = N_TOTAL, 62_500, 250_000, 480
TOOLS_WIDE_N = 4096
TOOLS_RUNS = {
    "demo": ("replicate_tcp", "--objects", str(TOOLS_DEMO_N)),
    "gossip": ("replicate_tcp", "--gossip", "3", "--objects", str(TOOLS_GOSSIP_N), "--ops", "4096",
               "--reads", "512", "--gc", "--durable", DURABLE_DIR, "--window", "16"),
    "mesh": ("replicate_tcp", "--mesh", "8", "--objects", str(TOOLS_MESH_N)),
    "wire_zoo": ("wire_zoo",), "pprint": ("pprint",), "anti_entropy": ("anti_entropy",),
    "multihost": ("multihost", "--ranks", "1"),
}
# what each run's output must hold (regular expressions)
TOOLS_LINES = {
    "demo": [rf"{role}: {TOOLS_DEMO_N} objects  mode=delta .* delta_objects={TOOLS_DEMO_N // 20} "
             r".* full=0B  CONVERGED" for role in ("client", "server")] + [r"demo: CONVERGED"],
    "gossip": [r"kill: n1 killed -9", r"recovery: n1 restored generation",
               r"full-state fallbacks=0", r"reads: quiescent frontier-mode sweep all-rows-stable",
               rf"gossip: 3 peers x {TOOLS_GOSSIP_N} objects  sweeps=\d+  CONVERGED"],
    "mesh": [rf"digest parity vs unsharded control: BYTE-IDENTICAL \({TOOLS_MESH_N} lanes"],
    "wire_zoo": [r"wire zoo: all 9 type families converged"],
    "pprint": [r"orswot\[0\]:\t\{apple, pear\}", r"orswot\[1\]:\t\{plum\}"],
    "anti_entropy": [r"4\. collective join skipped \(1 devices < 8\)",
                     r"5\. typed collective joins skipped \(1 devices < 8\)",
                     r"anti-entropy walkthrough: OK"],
    "multihost": [r"rank 0: topology=replicas objects=8 processes=1 MULTIHOST OK "
                  r"k2_launches=[1-9]", r"launcher: MULTIHOST OK"],
}


def run_children(runs: dict, timeout_s: float, meanwhile=None) -> tuple:
    """Start every run at once as ``python -m crdt_tpu_torch.tools.<tool>
    --device cuda ...``, call ``meanwhile()`` while they run; returns
    ``(name -> (stdout, wall seconds), what meanwhile returned)``.  A
    child that exits non-zero or outlives ``timeout_s`` fails the phase."""
    from crdt_tpu_torch.tools import run_all

    done, mid = run_all([[sys.executable, "-m", f"crdt_tpu_torch.tools.{tool}", "--device",
                          "cuda", *args] for tool, *args in runs.values()], timeout_s,
                        capture=True, meanwhile=meanwhile)
    for name, (rc, out, err, _) in zip(runs, done):
        if rc != 0:
            raise AssertionError(f"tool run {name} exited {rc} (None: outlived {timeout_s} s):\n"
                                 f"{out[-3000:]}\n{err[-3000:]}")
    return {name: (out, wall) for name, (_, out, _, wall) in zip(runs, done)}, mid


def tools_phase(dev):
    """Phase 17: the tools as children on the card.  Returns the merge
    kernel's launches the children reported."""
    from crdt_tpu_torch.tools import digest_sha
    from crdt_tpu_torch.tools import replicate_tcp as rt

    uni = rt.identity_universe()

    def meanwhile():
        """While the children run: the demo's fleets again, in process,
        and one merge on the gossip's over-provisioned planes (M=128, the
        plain wide path) held against the same merge on the CPU."""
        a, b = (rt.build_batch(TOOLS_WIDE_N, actor, 0.05, 42, uni, dev).with_capacity(
            4 * uni.config.member_capacity, 4 * uni.config.deferred_capacity) for actor in (1, 2))
        before = _build.launch_counts()
        got = a.merge(b)
        after = _build.launch_counts()
        if (after[_build.WIDE_MERGES] - before[_build.WIDE_MERGES], after["orswot_merge"]
                - before["orswot_merge"]) != (1, 0):
            raise AssertionError(f"the M=128 merge did not take the wide path: {after}")
        cpu = [OrswotBatch(*(x.cpu() for x in tree_leaves(p))) for p in (a, b)]
        if got.to_wire(uni) != cpu[0].merge(cpu[1]).to_wire(uni):
            raise AssertionError("the wide merge on the card != the same merge on the CPU")
        return [rt.build_batch(TOOLS_DEMO_N, actor, 0.05, 42, uni, dev) for actor in (1, 2)]

    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    os.makedirs(DURABLE_DIR)
    try:
        done, (a, b) = run_children(TOOLS_RUNS, TOOLS_TIMEOUT_S, meanwhile)
    finally:
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    # after the children exit, so the card is this process's alone: the
    # demo's fleets merged by K2 (held against its plain version), the
    # fingerprint both children must print
    with K2Launches() as held:
        merged, merge_ms, _ = timed_ms(lambda: a.merge(b))
        held.check("the demo fleets' merge")
    if not held.checked:
        raise AssertionError("the demo fleets' merge never launched the merge kernel")
    sha = digest_sha(digest_of(merged, uni))
    rep, launches = {"runs": {}, "merge_ms": merge_ms, "wide_check_n": TOOLS_WIDE_N}, 0
    for name, (out, wall) in done.items():
        for pattern in TOOLS_LINES[name]:
            if not re.search(pattern, out):
                raise AssertionError(f"tool run {name}: no line /{pattern}/:\n{out[-3000:]}")
        ev = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"role"')]
        k2 = sum(e["k2_launches"] for e in ev) if ev else int(
            re.search(r"k2_launches=(\d+)", out).group(1)) if name == "multihost" else 0
        if name != "pprint" and not k2:
            raise AssertionError(f"tool run {name} never launched the merge kernel")
        launches += k2
        rep["runs"][name] = {"wall_s": wall, "k2_launches": k2, "evidence": ev}
    rep["gossip_sweeps"] = int(re.search(r"sweeps=(\d+)  CONVERGED", done["gossip"][0]).group(1))
    rep["gossip_wide_merges"] = rep["runs"]["gossip"]["evidence"][0]["wide_merges"]

    shas = {e["digest_sha256"] for e in rep["runs"]["demo"]["evidence"]}
    if shas != {sha}:
        raise AssertionError(f"the demo children's fingerprints {shas} != the merge's {sha}")
    rep["demo_sha256"], rep["children_k2_launches"] = sha, launches
    return launches, rep


def main() -> int:
    # a native fault or abort prints every thread's Python stack first
    faulthandler.enable()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phases 1 and 2: environment and build")
    card = card_line()
    log(f"  card: {card}")
    t0 = now()
    secs = _build.build_all()
    print("environment " + json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "nvcc": subprocess.run(
            [_build._nvcc(), "--version"], capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[-1],
        "disk_free_and_host_available_bytes": durable_room(), "build_s": now() - t0,
        "build_s_per_source": secs,
        # each kernel instantiation's (mangled) entry, registers and spills
        "ptxas": {name: [ln.strip() for ln in info["ptxas"].splitlines()
                         if re.search("entry function|registers|spill", ln)]
                  for name, info in _build.BUILD_LOG.items()}}), flush=True)

    log("== phase 3: kernels vs plain versions")
    worst = check_kernels(dev)
    timed = time_kernels(dev, star_planes(seeded(3), dev), worst)
    torch.cuda.empty_cache()

    log("== phase 4: main path (the north-star fleets folded in chunks)")
    _build.reset_launch_counts()
    fold_ms = main_path(dev, N_TOTAL // CHUNK)
    launches = _build.launch_counts()
    for name in REPLACES:
        if launches[name] == 0:
            raise AssertionError(f"main path never launched {name}")
    print("main_path " + json.dumps({"card": card, "fold_wall_ms": fold_ms,
                                     "launches": launches}), flush=True)

    log("== phase 5: regrow ladder")
    _build.reset_launch_counts()
    stats = regrow_ladder(dev)
    if (stats.overflow_regrows, stats.final_member_capacity) != (2, 8):
        raise AssertionError(f"unexpected regrow ladder: {stats}")

    k2 = {}  # the merge kernel's launches on each phase's path, by table key

    def run(key, title, fn, *args):
        """One phase: counts reset before it; it returns the merge kernel's
        launches on its path (which must not be 0 under ``key``), its report
        and what later phases take; the report, its wall time and peak
        device memory are printed as one JSON line named ``key``."""
        log(f"== phase {title}")
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = now()
        launches, rep, *rest = fn(*args)
        rep.setdefault("peak_memory_gb", torch.cuda.max_memory_allocated() / 1e9)
        rep.update(card=card, phase_s=now() - t0, launches_after=_build.launch_counts())
        print(f"{key} " + json.dumps(rep, default=lambda x: x.tolist() if hasattr(x, "tolist")
                                     else str(x)), flush=True)
        if launches is not None:
            k2[key] = launches
            if not launches:
                raise AssertionError(f"phase {title} never launched the merge kernel")
        torch.cuda.empty_cache()
        return rest[0] if len(rest) == 1 else rest

    chunk_blobs = run("wire", "6: wire leg (blobs -> fold on the card -> blobs; the "
                      "union-aligned fold only as the byte oracle)", wire_leg, dev)
    run("wire_routes", "6b: from_wire and to_scalar, dense planes against COO columns",
        wire_routes, dev, chunk_blobs)
    if k2_count() == 0:
        raise AssertionError("phase 6b never launched the merge kernel")
    del chunk_blobs
    run("op", f"7: op path ({OP_FRAMES} frames of {OP_FRAME_OPS} ops into {N_TOTAL} objects; "
        "the merge kernel self-merges, the op bodies are torch ops)", op_path, dev)
    run("flat_types", "8: flat types (fold, wire round and op frames on the card; torch ops)",
        flat_types, dev)
    run("maps", "9: Map (merge, truncate and wire rounds on the card)", map_phase, dev)
    fleet, diverged = run("sync_gc", "10: sync and GC (digests, descent, two sync sessions, GC "
                          "pass)", sync_gc_phase, dev)
    fleet = run("reads", "11: the read front-end (gathers, consistency, frontier, heat, audit, "
                "capacity)", read_phase, dev, fleet, diverged)
    fleet = run("cluster", "12: cluster transport (two sessions over loopback TCP through "
                "the ARQ, faults injected)", cluster_phase, dev, fleet)
    run("gossip", "13: a gossip fleet (three cluster nodes over loopback TCP taking writes and "
        "serving reads)", gossip_phase, dev, fleet)
    run("durable", "14: durability (a checkpointed node killed mid-fold, restored from its "
        "snapshot and WAL, rejoining by delta sync)", durable_phase, dev, fleet)
    del fleet
    collective = run("collectives", "15: collectives (anti_entropy over the north-star fleet, "
                     "the joins over NCCL)", collectives_phase, dev)
    run("mesh", "16: the mesh-sharded fleet (layout, step, shard-subset sync, member "
        "sharding, fleet snapshots)", mesh_phase, dev)
    run("tools", "17: the tools as users run them (replicate_tcp's demo, gossip and mesh; "
        "wire_zoo, pprint, anti_entropy, multihost), children on the card", tools_phase, dev)
    log("  threads alive at the end: "
        f"{[t.name for t in threading.enumerate() if t is not threading.main_thread()]}")

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         **{f"{key}_launches": n if name == "orswot_merge" else 0 for key, n in k2.items()},
         "collective_launches": collective[name],
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
