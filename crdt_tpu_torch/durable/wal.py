"""Op-log write-ahead segments: the durability layer above the snapshot
(the port of the JAX package's ``durable/wal.py``, the same files).

Every op batch a node ingests (a local ``submit_ops``, a peer's session
piggyback) is appended to the open segment as one op frame, the codec of
:mod:`crdt_tpu_torch.oplog.wire` verbatim, and fsync'd before the fold,
so a kill -9 at any point loses nothing that was acknowledged.  Recovery
replays the frames above the snapshot's sequence through
:class:`~crdt_tpu_torch.oplog.OpApplier`; a frame the snapshot already
folded replays as a no-op, so the bound only has to be conservative.

Segment files (``wal-<first seq, 10 digits>.log``) are plain
concatenations of frames, each self-delimited by its header's payload
length.  A torn tail (kill -9 mid-append) parses as "stop here": the
complete prefix replays, and the torn bytes are counted
(:func:`torn_count`) and recorded (``durable.wal_torn``); the ops they
carried were never acknowledged and come back by delta sync.  Segments
wholly below a snapshot's sequence go through
:meth:`WalWriter.truncate_below`, so the WAL holds one checkpoint interval
of writes.
"""

from __future__ import annotations

import collections
import os
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

from ..error import DurabilityError
from ..obs import events as obs_events

#: the op-frame envelope (``oplog/wire.py``): the WAL stores frames
#: verbatim, so its framing must match the codec's header
_FRAME_HEADER = struct.Struct("<BBIQ")

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"

_TORN_LOCK = threading.Lock()
_TORN = [0]


def torn_count() -> int:
    """Torn tails met so far in this process, by writers resuming and by
    replays."""
    with _TORN_LOCK:
        return _TORN[0]


def _torn(path: str, torn: int, kept: int) -> None:
    with _TORN_LOCK:
        _TORN[0] += 1
    obs_events.record("durable.wal_torn", segment=os.path.basename(path), torn_bytes=torn,
                      frames_kept=kept)


def split_frames(data: bytes) -> Tuple[List[bytes], int]:
    """``(frames, torn_bytes)``: the complete op frames at the head of
    ``data`` and how many trailing bytes belong to an incomplete one.
    Framing only: the frames' CRC and grammar are checked at decode."""
    frames: List[bytes] = []
    off, n = 0, len(data)
    while n - off >= _FRAME_HEADER.size:
        end = off + _FRAME_HEADER.size + _FRAME_HEADER.unpack_from(data, off)[3]
        if end > n:
            break
        frames.append(data[off:end])
        off = end
    return frames, n - off


def _segment_first_seq(name: str) -> Optional[int]:
    if name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX):
        body = name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]
        if body.isdigit():
            return int(body)
    return None


def _segments(dirpath: str) -> List[Tuple[int, str]]:
    out = []
    for name in os.listdir(dirpath):
        seq = _segment_first_seq(name)
        if seq is not None:
            out.append((seq, os.path.join(dirpath, name)))
    return sorted(out)


class WalWriter:
    """Appends op frames to fsync'd segment files under one directory.

    ``segment_bytes`` rolls to a new segment once the open one exceeds it
    (a checkpoint rolls too, so truncation works on whole files);
    ``fsync=False`` is a benchmark knob.  Any thread may :meth:`append`.
    ``head_seq`` is the sequence of the next frame; sequences are global
    across segments and continue where a dead writer stopped.  Counts are
    :meth:`counts` (frames and bytes appended, segments dropped);
    :meth:`append_seconds` holds the latest appends' write-and-fsync
    seconds."""

    def __init__(self, dirpath, *, segment_bytes: int = 4 << 20, fsync: bool = True):
        if segment_bytes < 1:
            raise ValueError(f"segment_bytes {segment_bytes} < 1")
        self.dirpath = os.fspath(dirpath)
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        os.makedirs(self.dirpath, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = None
        self._open_first_seq: Optional[int] = None
        self._open_bytes = 0
        self._counts = {"frames": 0, "bytes": 0, "segments_dropped": 0}
        self._append_s = collections.deque(maxlen=4096)
        # resume where the previous process died: a torn tail is cut back
        # to the last frame boundary (those bytes were never acknowledged,
        # and left in place they would stop every later replay), loudly,
        # and the segment reopens for append so sequences stay contiguous
        head = 0
        segs = _segments(self.dirpath)
        if segs:
            first, path = segs[-1]
            with open(path, "rb") as f:
                data = f.read()
            frames, torn = split_frames(data)
            if torn:
                with open(path, "r+b") as f:
                    f.truncate(len(data) - torn)
                _torn(path, torn, len(frames))
            head = first + len(frames)
            self._fh = open(path, "ab")
            self._open_first_seq = first
            self._open_bytes = len(data) - torn
        self._head_seq = head

    @property
    def head_seq(self) -> int:
        with self._lock:
            return self._head_seq

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def append_seconds(self) -> list:
        """Write-and-fsync seconds of the latest appends (up to 4,096)."""
        with self._lock:
            return list(self._append_s)

    def pending(self) -> Tuple[int, int]:
        """``(frames, bytes)`` across the retained segments: the replay a
        recovery would face now."""
        frames = nbytes = 0
        for _, path in _segments(self.dirpath):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                continue  # truncation raced us
            frames += len(split_frames(data)[0])
            nbytes += len(data)
        return frames, nbytes

    def append(self, frame) -> int:
        """Append one encoded op frame (or an
        :class:`~crdt_tpu_torch.oplog.OpBatch`, encoded here) and fsync it.
        Returns its sequence; once this returns the ops are durable."""
        from ..cluster import faults as cluster_faults

        if not isinstance(frame, (bytes, bytearray, memoryview)):
            from ..oplog.wire import encode_ops_frame

            frame = encode_ops_frame(frame)
        frame = bytes(frame)
        with self._lock:
            cluster_faults.crash_point("durable.wal.append")
            if self._fh is None or self._open_bytes >= self.segment_bytes:
                if self._fh is not None:
                    self._fh.close()
                self._fh = self._open_segment(self._head_seq)
                self._open_first_seq = self._head_seq
                self._open_bytes = 0
            t = time.perf_counter()
            self._fh.write(frame)
            self._fh.flush()
            if self.fsync:
                # fsync-before-ack inside the lock is the durability
                # contract: sequence order and disk order must agree
                os.fsync(self._fh.fileno())  # crdtlint: disable=hold-and-block — fsync-before-ack: seq order must match disk order
            self._append_s.append(time.perf_counter() - t)
            self._open_bytes += len(frame)
            seq = self._head_seq
            self._head_seq += 1
            self._counts["frames"] += 1
            self._counts["bytes"] += len(frame)
        return seq

    def _open_segment(self, first: int):
        """A fresh segment whose name pins its first sequence."""
        path = os.path.join(self.dirpath, f"{_SEG_PREFIX}{first:010d}{_SEG_SUFFIX}")
        if os.path.exists(path):
            # a previous process left a torn tail in this very segment:
            # appending behind it would stop replay, so recover first
            raise DurabilityError(f"WAL segment {path} already exists at head seq {first} "
                                  "(torn tail not truncated?) — run recovery first")
        return open(path, "ab")

    def roll(self) -> None:
        """Close the open segment, so that the next append starts a file."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def truncate_below(self, seq: int) -> int:
        """Delete the closed segments whose every frame has a sequence below
        ``seq``.  Returns how many it deleted."""
        dropped = 0
        with self._lock:
            open_first = self._open_first_seq if self._fh is not None else None
            segs = _segments(self.dirpath)
            for i, (first, path) in enumerate(segs):
                if first == open_first:
                    continue
                # a segment's frames end where the next begins (the head for the last)
                next_first = segs[i + 1][0] if i + 1 < len(segs) else self._head_seq
                if next_first <= seq:
                    try:
                        os.unlink(path)
                        dropped += 1
                    except FileNotFoundError:
                        pass
            self._counts["segments_dropped"] += dropped
        return dropped

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def replay_frames(dirpath, from_seq: int = 0) -> Iterator[Tuple[int, bytes]]:
    """``(seq, frame)`` for every complete frame with ``seq >= from_seq``,
    oldest first.  A torn tail stops the iteration loudly (counted and
    recorded): nothing after it was durable.  Payloads are not checked
    here; the replayer's ``decode_ops_frame`` rejects a corrupt one."""
    dirpath = os.fspath(dirpath)
    if not os.path.isdir(dirpath):
        return
    for first, path in _segments(dirpath):
        with open(path, "rb") as f:
            data = f.read()
        frames, torn = split_frames(data)
        for i, frame in enumerate(frames):
            if first + i >= from_seq:
                yield first + i, frame
        if torn:
            _torn(path, torn, len(frames))
            return  # nothing after a torn segment is trustworthy
