"""Append-only segmented write-ahead log for graph-stream mutations.

Port of ``src/repro/stream/wal.py`` (pure numpy and stdlib): the record
layout, segment header, file names and append protocol are the reference's
byte for byte, so a log written by either package replays in the other.
Replay finds each segment's commit, advance and merge records with numpy
where the reference steps through every record in Python.

Durability contract (see DESIGN.md §13): every LOGICAL mutation —
ingest / delete / explicit window advance / merge — is appended here
*before* the device dispatch, so the stream state is always
``newest checkpoint + WAL suffix``.  Watermark-driven *auto* advances are
NOT logged: they are a pure function of the logged event times and are
re-derived bit-identically during replay.

Layout
------
Fixed-size 40-byte little-endian records (:data:`WAL_RECORD`)::

    seq u8 | event_time f8 | tenant i4 | src u4 | dst u4 | weight f4 | op u4 | pad u4

grouped into *segments* ``wal-<start_seq>.seg``, each opened by a 16-byte
header (``GSWAL001`` magic + u8 start seq).  An ingest/delete of B edges
is B ``OP_EDGE`` records followed by one ``OP_COMMIT`` record whose
``src`` field carries the edge count and whose ``dst`` carries the
source key (watermark lane); explicit advances and merge barriers are
single self-committing records.  ``seq`` is a global monotone record
counter — the commit record's seq is the mutation's durable position.

Crash safety: appends are the only writes, so a crash leaves at most a
torn tail — a trailing partial record (dropped by size) or a trailing
edge run with no commit record (dropped by the replay scanner).  A
mutation is replayed iff its commit record is fully on disk.

fsync batching: ``fsync_every=N`` fsyncs every N-th committed mutation
(and on :meth:`sync`, which checkpointing always calls), trading a
bounded window of recent mutations for append throughput.

Segment rotation is keyed to checkpoint steps: the session rotates right
after each checkpoint saves, so a segment never straddles a checkpoint
boundary and :meth:`gc` can drop exactly the segments whose records are
all covered by the OLDEST retained checkpoint (``CheckpointManager`` GC
never strands a needed suffix).
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Iterator, List, Optional, Union

import numpy as np

MAGIC = b"GSWAL001"
HEADER_SIZE = 16  # 8-byte magic + u8 start_seq

#: One fixed-size WAL record (little-endian, 40 bytes).
WAL_RECORD = np.dtype(
    [
        ("seq", "<u8"),
        ("event_time", "<f8"),
        ("tenant", "<i4"),
        ("src", "<u4"),
        ("dst", "<u4"),
        ("weight", "<f4"),
        ("op", "<u4"),
        ("pad", "<u4"),
    ]
)
RECORD_SIZE = WAL_RECORD.itemsize

OP_EDGE = 1      # one edge of an ingest/delete batch (weight signed)
OP_COMMIT = 2    # batch commit marker: src=n_edges, dst=source_key
OP_ADVANCE = 3   # explicit advance_window() (self-committing)
OP_MERGE = 4     # merge barrier (self-committing; replay refuses past it)


@dataclasses.dataclass(frozen=True)
class EdgeMutation:
    """One replayable ingest/delete batch (weights carry the sign)."""

    seq: int                      # commit record's seq
    src: np.ndarray               # uint32 keys (post-codec)
    dst: np.ndarray               # uint32 keys
    weights: np.ndarray           # float32, signed
    timestamps: Optional[np.ndarray]  # float64 event times, or None
    source_key: int               # watermark lane (0 = default source)
    tenant: int = 0


@dataclasses.dataclass(frozen=True)
class AdvanceMutation:
    """One explicit ``advance_window()``."""

    seq: int


@dataclasses.dataclass(frozen=True)
class MergeMutation:
    """A merge barrier: state entered the session outside this log."""

    seq: int


Mutation = Union[EdgeMutation, AdvanceMutation, MergeMutation]


class WalCorruptError(RuntimeError):
    """A segment failed structural validation (bad magic / seq gap)."""


def _segment_path(directory: Path, start_seq: int) -> Path:
    return directory / f"wal-{start_seq:020d}.seg"


def _parse_start_seq(path: Path) -> int:
    return int(path.name[len("wal-"):-len(".seg")])


class WriteAheadLog:
    """Segmented append-only WAL (one per session, or one per tenant lane)."""

    def __init__(self, directory: Union[str, Path], fsync_every: int = 1):
        if fsync_every < 1:
            raise ValueError(f"fsync_every must be >= 1, got {fsync_every}")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync_every = int(fsync_every)
        self._fh = None          # open segment file handle (append mode)
        self._since_sync = 0
        self._next_seq = 1
        segs = self.segments()
        if segs:
            # Resume numbering after everything on disk, committed or torn —
            # seqs must stay monotone even past records replay will skip.
            records = _read_segment(segs[-1])
            if records.size:
                self._next_seq = int(records["seq"][-1]) + 1
            else:
                self._next_seq = _parse_start_seq(segs[-1])

    # -- append path ---------------------------------------------------------

    @property
    def last_seq(self) -> int:
        """Seq of the last appended record (0 = empty log)."""
        return self._next_seq - 1

    def segments(self) -> List[Path]:
        """Segment paths, oldest first."""
        return sorted(self.dir.glob("wal-*.seg"), key=_parse_start_seq)

    def _ensure_open(self, start_seq: int):
        if self._fh is None:
            path = _segment_path(self.dir, start_seq)
            self._fh = open(path, "ab")
            if self._fh.tell() == 0:
                self._fh.write(MAGIC + np.uint64(start_seq).tobytes())

    def _append(self, records: np.ndarray) -> int:
        self._ensure_open(int(records["seq"][0]))
        self._fh.write(records.tobytes())
        self._fh.flush()
        self._since_sync += 1
        if self._since_sync >= self.fsync_every:
            os.fsync(self._fh.fileno())
            self._since_sync = 0
        return int(records["seq"][-1])

    def append_edges(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weights: np.ndarray,
        timestamps: Optional[np.ndarray] = None,
        source_key: int = 0,
        tenant: int = 0,
    ) -> int:
        """Append one ingest/delete batch + its commit marker.  Returns the
        commit seq (the mutation's durable position)."""
        n = int(np.asarray(src).shape[0])
        records = np.zeros(n + 1, WAL_RECORD)
        records["seq"] = np.arange(self._next_seq, self._next_seq + n + 1, dtype=np.uint64)
        records["op"][:n] = OP_EDGE
        records["src"][:n] = np.asarray(src, np.uint32)
        records["dst"][:n] = np.asarray(dst, np.uint32)
        records["weight"][:n] = np.asarray(weights, np.float32)
        records["tenant"][:] = tenant
        if timestamps is not None:
            records["event_time"][:n] = np.asarray(timestamps, np.float64)
        else:
            records["event_time"][:n] = np.nan
        commit = records[-1:]
        commit["op"] = OP_COMMIT
        commit["src"] = n
        commit["dst"] = np.uint32(source_key)
        self._next_seq += n + 1
        return self._append(records)

    def _append_marker(self, op: int, tenant: int = 0) -> int:
        record = np.zeros(1, WAL_RECORD)
        record["seq"] = self._next_seq
        record["op"] = op
        record["tenant"] = tenant
        record["event_time"] = np.nan
        self._next_seq += 1
        return self._append(record)

    def append_advance(self, tenant: int = 0) -> int:
        """Append one explicit window advance (self-committing)."""
        return self._append_marker(OP_ADVANCE, tenant)

    def append_merge_barrier(self, tenant: int = 0) -> int:
        """Append a merge barrier: replay cannot cross it (the merged-in
        state never went through this log) — checkpoint right after."""
        return self._append_marker(OP_MERGE, tenant)

    def sync(self) -> None:
        """Force fsync of the open segment (checkpointing calls this)."""
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._since_sync = 0

    def rotate(self) -> None:
        """Close the current segment; the next append opens a fresh one.
        Called right after a checkpoint commits so segment boundaries align
        with checkpoint steps (the GC contract)."""
        if self._fh is not None:
            self.sync()
            self._fh.close()
            self._fh = None

    def close(self) -> None:
        self.rotate()

    # -- retention -----------------------------------------------------------

    def gc(self, covered_seq: int) -> int:
        """Drop segments whose records are ALL <= ``covered_seq`` (i.e.
        already folded into every retained checkpoint).  Pass the minimum
        ``wal_seq`` across retained checkpoint manifests.  Returns the
        number of segments removed — never the open segment, and never a
        segment the newest manifest still needs."""
        removed = 0
        segs = self.segments()
        for i, path in enumerate(segs):
            nxt_start = (
                _parse_start_seq(segs[i + 1]) if i + 1 < len(segs) else None
            )
            if nxt_start is None:
                break  # the newest (possibly open) segment always stays
            if nxt_start - 1 <= covered_seq:
                path.unlink()
                removed += 1
            else:
                break  # segments are seq-ordered; later ones are needed too
        return removed

    # -- replay --------------------------------------------------------------

    def replay(self, after_seq: int = 0) -> Iterator[Mutation]:
        """Yield committed mutations with commit seq > ``after_seq``,
        oldest first.  Torn tails (partial trailing record, or a trailing
        edge run with no commit marker) are silently ignored — by the
        append protocol they were never acknowledged."""
        for path in self.segments():
            # A fresh run per segment: a batch never spans segments (the
            # append protocol only rotates between batches), so an edge run
            # still pending at a segment's end is a torn, unacknowledged
            # tail from a crash — dropped, like trailing partial bytes.
            for rec in _group_mutations(_read_segment(path)):
                if rec.seq > after_seq:
                    yield rec

    def record_count(self) -> int:
        """Total records currently on disk (diagnostics)."""
        return sum(int(_read_segment(p).size) for p in self.segments())


def _read_segment(path: Path) -> np.ndarray:
    raw = path.read_bytes()
    if len(raw) < HEADER_SIZE or raw[:8] != MAGIC:
        raise WalCorruptError(f"bad WAL segment header: {path}")
    body = raw[HEADER_SIZE:]
    usable = (len(body) // RECORD_SIZE) * RECORD_SIZE  # drop torn tail bytes
    return np.frombuffer(body[:usable], WAL_RECORD)


def _group_mutations(records: np.ndarray) -> Iterator[Mutation]:
    """Group one segment's records into committed logical mutations: a
    commit takes the edge run since the previous non-edge record; advances
    and merge barriers stand alone and drop any run before them; a run
    still open at the segment's end is a torn tail, dropped.  The non-edge
    records are found with numpy, so a segment of millions of edge records
    costs no Python step per record."""
    ops = records["op"]
    start = 0
    for i in np.flatnonzero(ops != OP_EDGE):
        op, seq = int(ops[i]), int(records["seq"][i])
        if op == OP_COMMIT:
            run = records[start:i]
            n = int(records["src"][i])
            if run.size != n:
                raise WalCorruptError(
                    f"commit record seq={seq} claims {n} edges but {run.size} are on disk"
                )
            ts = run["event_time"].astype(np.float64)
            has_ts = run.size > 0 and not np.any(np.isnan(ts))
            yield EdgeMutation(
                seq=seq,
                src=run["src"].astype(np.uint32),
                dst=run["dst"].astype(np.uint32),
                weights=run["weight"].astype(np.float32),
                timestamps=ts if has_ts else None,
                source_key=int(records["dst"][i]),
                tenant=int(records["tenant"][i]),
            )
        elif op == OP_ADVANCE:
            yield AdvanceMutation(seq=seq)
        elif op == OP_MERGE:
            yield MergeMutation(seq=seq)
        else:
            raise WalCorruptError(f"unknown WAL op {op} at seq {seq}")
        start = i + 1
