"""Pipelined wire replication loop: blobs in → fold on the card → blobs out.

The port of the JAX package's ``batch/wireloop.py``.  A deployment does
not start from planes built on the device: it ingests wire blobs (one
list per replica fleet), folds them to fixpoint (left fold plus the
defer-plunger self-merge) and emits blobs.  :class:`PipelinedWireLoop`
runs that loop with every stage overlapped where it can be:

* **staging sets** — a pool of host plane sets (pinned on a CUDA
  device) that a background thread parses each fleet's blobs into with
  the host codec (``out=``, ``clear=1``: no allocation in steady state;
  fresh plane sets per call page-fault GBs at fleet scale);
* **H2D on a copy stream** — each staged set is copied to its device
  twin on a stream of its own, with one event per set; the fold stream
  waits on that event, and the parser does not write a set again until
  its copy has completed, nor does a copy overwrite a device twin that
  the fold still reads;
* **the bias on the device** — the parser writes unsigned counters; the
  fold stream biases them into the kernels' signed domain after the copy
  (:mod:`crdt_tpu_torch.dtypes`);
* **the fold** — ``acc ⊔ fleet_k`` through the pairwise merge kernel
  (K2, ``ops/orswot_tile.merge`` with ``prebiased=True``, so the fold
  never leaves the kernel domain), then the plunger ``acc ⊔ acc``; the
  overflow flags are ORed on the device and checked once per round;
* **egress** — unbias on the device, one D2H into a pinned egress set,
  then the host codec's encoder; the parse thread meanwhile fills the
  next round's fleets.

With ``device="cpu"`` the same loop runs on host tensors and the merge
kernel's plain version (``merge_reference``).  u64 fleets fold through
the plain rank merge (the kernel is exact for 32-bit counters only).
Per-stage wall times and the wire counts go into the returned dict; the
loop declares no metrics.

:class:`PipelinedOpLoop` is the op path's sibling: it decodes op frames
on a thread one frame ahead of the fold (:class:`~crdt_tpu_torch.oplog.
OpApplier`), through a bounded queue.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import torch_counter_dtype, zero_of
from ..error import raise_for_overflow
from ..utils.tracing import span
from . import wirebulk
from .orswot_batch import planes_to_wire

_SENTINEL = object()
_COUNTER_PLANES = (0, 2, 4)


class _Staging:
    """One staged fleet: host planes (pinned on CUDA), their unsigned
    numpy views for the parser, the device twin, and the events that
    order the parser, the copy and the fold around them."""

    __slots__ = ("host", "views", "dev", "copied", "consumed")

    def __init__(self, shapes, dtypes, device):
        cuda = device.type == "cuda"
        self.host = tuple(torch.empty(s, dtype=t, pin_memory=cuda) for s, t in zip(shapes, dtypes))
        self.views = tuple(
            h.numpy().view(np.uint32 if h.dtype == torch.int32 else np.uint64)
            if i in _COUNTER_PLANES else h.numpy()
            for i, h in enumerate(self.host))
        self.dev = tuple(torch.empty(s, dtype=t, device=device) for s, t in zip(shapes, dtypes))
        self.copied = torch.cuda.Event() if cuda else None
        self.consumed = torch.cuda.Event() if cuda else None


class PipelinedWireLoop:
    """ORSWOT wire replication: blobs in → fold → blobs out, with the host
    parse overlapped against the copies and the fold on the device.

    One instance owns the staging and egress buffers for a fixed
    ``universe`` (identity universes take the host codec; any other
    universe works through the Python codec, without the zero-allocation
    steady state).  Buffers are sized on first use and reused across
    rounds and across ``run`` calls.  ``device`` defaults to ``"cuda"``."""

    def __init__(self, universe, device=None, staging_sets: int = 3):
        if staging_sets < 2:
            raise ValueError("pipelining needs at least 2 staging sets")
        self.universe = universe
        self.cfg = universe.config
        self.device = resolve_device(device)
        self._staging_sets = staging_sets
        self._staging: list[_Staging] = []
        self._egress: tuple = ()
        self._n: Optional[int] = None
        self._dtype = torch_counter_dtype(self.cfg.counter_bits)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._overflow = None  # ORed bool[2] flags of the round, on the device
        self._h2d_events: list = []  # (start, end) of the round's copies
        if self._dtype == torch.int32:
            self.fold_path = "k2" if self._cuda else "merge_reference"
        else:
            self.fold_path = "rank"

    # -- buffers -------------------------------------------------------------

    def _shapes(self, n: int):
        a, m, d = self.cfg.num_actors, self.cfg.member_capacity, self.cfg.deferred_capacity
        return ((n, a), (n, m), (n, m, a), (n, d), (n, d, a))

    def _ensure_buffers(self, n: int) -> None:
        if self._n == n:
            return
        self._n = None
        self._staging, self._egress = [], ()
        shapes = self._shapes(n)
        dtypes = tuple(torch.int32 if i not in _COUNTER_PLANES else self._dtype
                       for i in range(5))
        self._staging = [_Staging(shapes, dtypes, self.device)
                         for _ in range(self._staging_sets)]
        self._egress = tuple(torch.empty(s, dtype=t, pin_memory=self._cuda)
                             for s, t in zip(shapes, dtypes))
        self._n = n

    # -- stages --------------------------------------------------------------

    def _parse_into(self, blobs: Sequence[bytes], st: _Staging) -> None:
        """Decode ``blobs`` into the host planes of ``st`` (the host codec
        with its per-blob triage, or the Python codec when the universe
        is not identity-interned)."""
        if st.copied is not None:
            st.copied.synchronize()  # the last copy out of these planes is done
        planes = wirebulk.orswot_planes_from_wire(blobs, self.universe, out=st.views)
        if planes is None:
            for dst, src in zip(st.views, wirebulk.planes_of_blobs(blobs, self.universe)):
                np.copyto(dst, src)

    def _upload(self, st: _Staging) -> tuple:
        """The staged planes on the device, biased, ordered before the
        fold stream's next work."""
        if self._cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(st.consumed)  # the fold is done with st.dev
                start.record(self._copy_stream)
                for dst, src in zip(st.dev, st.host):
                    dst.copy_(src, non_blocking=True)
                end.record(self._copy_stream)
                st.copied.record(self._copy_stream)
            self._h2d_events.append((start, end))
            torch.cuda.current_stream(self.device).wait_event(st.copied)
        else:
            for dst, src in zip(st.dev, st.host):
                dst.copy_(src)
        z = zero_of(self._dtype)
        for i in _COUNTER_PLANES:
            st.dev[i].bitwise_xor_(z)
        return st.dev

    def _release(self, st: _Staging) -> None:
        if self._cuda:
            st.consumed.record(torch.cuda.current_stream(self.device))

    def _merge(self, acc: tuple, rhs: tuple) -> tuple:
        """One pairwise merge in the biased domain; its overflow flags are
        ORed into the round's, on the device (no host sync)."""
        m, d = self.cfg.member_capacity, self.cfg.deferred_capacity
        if self._dtype == torch.int32:
            from ..ops import orswot_tile

            out = orswot_tile.merge(*acc, *rhs, m, d, prebiased=True)
        else:
            from ..ops import orswot_ops

            out = orswot_ops.merge(*acc, *rhs, m, d, impl="rank")
        ov = out[5].reshape(-1, 2).any(dim=0)
        self._overflow = ov if self._overflow is None else self._overflow | ov
        return out[:5]

    def _download(self, acc: tuple) -> tuple:
        """Unbias on the device, copy into the pinned egress set, wait;
        returns the unsigned numpy views of the egress set."""
        z = zero_of(self._dtype)
        for i, (dst, src) in enumerate(zip(self._egress, acc)):
            dst.copy_(src ^ z if i in _COUNTER_PLANES else src, non_blocking=self._cuda)
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        unsigned = np.uint32 if self._dtype == torch.int32 else np.uint64
        return tuple(x.numpy().view(unsigned) if i in _COUNTER_PLANES else x.numpy()
                     for i, x in enumerate(self._egress))

    # -- the loop ------------------------------------------------------------

    def run(self, rounds: Iterable[Sequence[Sequence[bytes]]], *, overlap: bool = True) -> dict:
        """Process ``rounds`` of replica-fleet blobs through parse → H2D →
        fold to fixpoint (left fold + defer-plunger self-merge) → D2H →
        encode.

        Each round is a sequence of ``r`` blob lists (one per replica
        fleet, all of one length).  With ``overlap=True`` a background
        thread parses ahead of the fold; ``overlap=False`` runs the same
        stages serially.

        Returns ``{"out_blobs", "rounds", "merges", "objects", "pipeline",
        "fold_path", "device", "stage_s", "e2e_s", "wire_counters",
        "ingest_native_fraction", "egress_native_fraction"}``;
        ``out_blobs`` holds each round's output blobs, in round order.
        ``stage_s`` holds wall-clock sums in seconds: ``parse`` (the
        codec's parse, on the parse thread when overlapped), ``h2d``
        (device time of the copies, by CUDA events; 0 on the CPU),
        ``fold`` (the round's fold, from its start to its overflow check,
        waits for the parser and the copies included), ``stall`` (the part of ``fold`` spent waiting for
        the parser), ``d2h`` (unbias and copy out), ``encode`` (the
        codec's encode and the split into blobs) and ``egress`` (``d2h`` +
        ``encode``).  With overlap the stages can sum past ``e2e_s``: that
        surplus is the overlap won.  ``wire_counters`` is the growth of
        :func:`~crdt_tpu_torch.batch.wirebulk.wire_counts` over the call."""
        rounds = [list(rnd) for rnd in rounds]
        stage_s = dict.fromkeys(("parse", "h2d", "fold", "stall", "d2h", "encode", "egress"),
                                0.0)
        before = wirebulk.wire_counts()
        out_blobs: list = []
        merges = objects = 0
        t_all0 = time.perf_counter()
        fleet_stream = [blobs for rnd in rounds for blobs in rnd]
        if any(len(rnd) == 0 for rnd in rounds):
            raise ValueError("every round needs at least one fleet")
        if not fleet_stream:
            return self._result([], 0, 0, 0, overlap, stage_s, 0.0, before)
        n = len(fleet_stream[0])
        if any(len(b) != n for b in fleet_stream):
            raise ValueError("all fleets must hold the same object count")
        self._ensure_buffers(n)
        self._overflow, self._h2d_events = None, []

        free_q: "queue.Queue" = queue.Queue()
        parsed_q: "queue.Queue" = queue.Queue()
        for st in self._staging:
            free_q.put(st)
        parse_s = [0.0]  # written by whichever thread parses

        def parse_one(blobs, st):
            t0 = time.perf_counter()
            self._parse_into(blobs, st)
            parse_s[0] += time.perf_counter() - t0

        def worker():
            try:
                for blobs in fleet_stream:
                    st = free_q.get()
                    if st is _SENTINEL:
                        return
                    parse_one(blobs, st)
                    parsed_q.put(st)
            except BaseException as e:  # raised again in the main thread
                parsed_q.put(e)

        stream_iter = iter(fleet_stream)

        def next_staged():
            if overlap:
                t0 = time.perf_counter()
                item = parsed_q.get()
                stage_s["stall"] += time.perf_counter() - t0
                if isinstance(item, BaseException):
                    raise item
                return item
            st = free_q.get()
            parse_one(next(stream_iter), st)
            return st

        thread = None
        if overlap:
            thread = threading.Thread(target=worker, daemon=True, name="wireloop-parse")
            thread.start()
        try:
            for rnd in rounds:
                t0 = time.perf_counter()
                used = []
                acc = None
                for _ in rnd:
                    st = next_staged()
                    planes = self._upload(st)
                    used.append(st)
                    if acc is None:
                        acc = planes
                        continue
                    acc = self._merge(acc, planes)
                    # both inputs of this merge are read by work already queued
                    for done in used:
                        self._release(done)
                        free_q.put(done)
                    used = []
                acc = self._merge(acc, acc)  # the defer plunger
                for done in used:  # a one-fleet round: the plunger read it
                    self._release(done)
                    free_q.put(done)
                ov, self._overflow = self._overflow, None
                raise_for_overflow(ov, "wire-loop fold")  # the round's one host sync
                stage_s["fold"] += time.perf_counter() - t0
                # the fold stream waited on every copy, so all have ended
                stage_s["h2d"] += sum(a.elapsed_time(b) for a, b in self._h2d_events) / 1e3
                self._h2d_events = []
                merges += n * len(rnd)
                objects += n

                t0 = time.perf_counter()
                host = self._download(acc)
                del acc
                t1 = time.perf_counter()
                blobs_out = planes_to_wire(host, self.universe)
                t2 = time.perf_counter()
                stage_s["d2h"] += t1 - t0
                stage_s["encode"] += t2 - t1
                out_blobs.append(blobs_out)
        finally:
            if thread is not None:
                free_q.put(_SENTINEL)  # unblock a parser waiting for a set
                thread.join(timeout=30)
                if thread.is_alive():
                    # a parser still writing a set: orphan the pool so the
                    # next run allocates fresh buffers
                    self._staging, self._egress, self._n = [], (), None
            if self._cuda:
                # a round cut short leaves merges reading the device twins
                # without their release events: let them end before the
                # next run copies into the twins
                torch.cuda.synchronize(self.device)
        stage_s["parse"] = parse_s[0]
        stage_s["egress"] = stage_s["d2h"] + stage_s["encode"]
        return self._result(out_blobs, len(rounds), merges, objects, overlap, stage_s,
                            time.perf_counter() - t_all0, before)

    def _result(self, blobs, n_rounds, merges, objects, overlap, stage_s, e2e_s, before):
        deltas = wirebulk.counts_since(before)
        return {
            "out_blobs": blobs, "rounds": n_rounds, "merges": merges, "objects": objects,
            "pipeline": "overlapped" if overlap else "serial", "fold_path": self.fold_path,
            "device": str(self.device), "stage_s": stage_s, "e2e_s": e2e_s,
            "wire_counters": deltas,
            "ingest_native_fraction": wirebulk.native_fraction(deltas, "from_wire"),
            "egress_native_fraction": wirebulk.native_fraction(deltas, "to_wire"),
        }


class PipelinedOpLoop:
    """Pipelined op-frame ingest: decode op frames on a background thread
    while the main thread folds the batches already decoded (the port of
    the JAX package's ``PipelinedOpLoop``).  The decode queue holds at
    most ``depth`` batches, so a slow fold holds the decoder back instead
    of growing host memory."""

    def __init__(self, universe, *, depth: int = 4):
        from ..oplog.apply import OpApplier

        if depth < 2:
            raise ValueError("pipelining needs a decode queue depth >= 2")
        self.universe = universe
        self.applier = OpApplier(universe)
        self.depth = depth

    def run(self, batch, frames: Iterable[bytes], *, overlap: bool = True) -> tuple:
        """Fold every op frame of ``frames`` into ``batch`` (decode, then
        ``apply_ops``, per frame; with ``overlap`` the decode runs one
        frame ahead on a thread).  Returns ``(folded_batch, stats)``,
        ``stats = {"frames", "ops", "applied", "duplicates",
        "still_parked", "pipeline", "stage_s": {parse, fold,
        stall}, "e2e_s"}``: ``parse`` is the decode, ``fold`` the
        ``apply_ops`` calls, ``stall`` the fold's waits on the decoder
        (host clock); ``e2e_s`` ends after the device has finished.
        Under a profiler each frame is an ``oploop/frame`` span on the
        folding thread, from asking for its ops to the end of its fold, and
        each wait on the decoder an ``oploop/stall`` inside it."""
        from ..oplog.wire import decode_ops_frame

        frames = list(frames)
        stage_s = {"parse": 0.0, "fold": 0.0, "stall": 0.0}
        stats = {"frames": len(frames), "ops": 0, "applied": 0, "duplicates": 0}
        t_all0 = time.perf_counter()
        num_actors = self.universe.config.num_actors

        def decode_one(frame):
            t0 = time.perf_counter()
            ops = decode_ops_frame(frame, num_actors=num_actors)
            stage_s["parse"] += time.perf_counter() - t0
            return ops

        thread = None
        if overlap:
            parsed_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
            stop = threading.Event()

            def worker():
                try:
                    for frame in frames:
                        if stop.is_set():
                            return
                        parsed_q.put(decode_one(frame))
                    parsed_q.put(_SENTINEL)
                except BaseException as e:  # raised again in the main thread
                    parsed_q.put(e)

            def staged():
                while True:
                    with span("oploop/stall"):
                        t0 = time.perf_counter()
                        item = parsed_q.get()
                        stage_s["stall"] += time.perf_counter() - t0
                    if item is _SENTINEL:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item

            thread = threading.Thread(target=worker, daemon=True, name="oploop-decode")
            thread.start()
            stream = staged()
        else:
            stream = (decode_one(f) for f in frames)

        try:
            # one item a frame: a frame's span runs from asking for its ops
            # (the decode, or the wait on the decoder) to the end of its fold
            for _ in frames:
                with span("oploop/frame"):
                    ops = next(stream)
                    t0 = time.perf_counter()
                    batch, report = self.applier.apply_ops(batch, ops)
                    stage_s["fold"] += time.perf_counter() - t0
                stats["ops"] += report.ops
                stats["applied"] += report.applied
                stats["duplicates"] += report.duplicates
        finally:
            if thread is not None:
                # drain until the decoder has seen the stop flag, so that it
                # never blocks on a full queue
                stop.set()
                while thread.is_alive():
                    try:
                        parsed_q.get(timeout=0.05)
                    except queue.Empty:
                        pass
                thread.join()
        if batch.device.type == "cuda":
            torch.cuda.synchronize(batch.device)
        stats["still_parked"] = len(self.applier.parked)
        stats["pipeline"] = "overlapped" if overlap else "serial"
        stats["stage_s"] = stage_s
        stats["e2e_s"] = time.perf_counter() - t_all0
        return batch, stats
