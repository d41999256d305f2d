"""`GraphStream` — the one session facade over the paper's summary S.

Port of ``src/repro/api/stream.py`` (arrival-ordered local sessions).  It
wraps the ingest plane (:class:`~repro_torch.core.ingest.IngestEngine`,
with a bounded queue of batches in flight), the query plane
(:class:`~repro_torch.core.query_engine.QueryEngine`, planned and fused by
:mod:`repro_torch.api.planner`) and the standing-query plane
(:mod:`repro_torch.api.subscription`) behind one handle::

    from repro_torch.api import GraphStream, Query

    gs = GraphStream.open("smoke")           # CUDA; device="cpu" to opt out
    gs.ingest(["alice", "bob"], ["bob", "carol"])
    res = gs.query(Query.edge("alice", "bob"), Query.reach("alice", "carol"))
    sub = gs.subscribe(Query.in_flow("carol"), every=4)

The summary is updated IN PLACE on the device (the counterpart of the
reference's buffer donation); ``sketch`` hands out a copy, so nothing given
to a caller aliases the live counters.  Query answers come back as numpy.

``ingest_backend="fused"`` opens a fused session: each batch goes through
the one-pass fused ingest (``GLavaSketch.update_fused_``), which updates the
counters, both registers and a (d, w_r) touched-row bitmap on the device, so
the incremental closure refresh needs no host pass over the keys.  A fused
session on the card hands the kernel its raw batches; a local session on the
card's kernels collapses a large batch's duplicate pairs on the card
(``GLavaSketch.update_collapsed_``).  Both keep their touched rows as the
bitmap.  Other sessions collapse on the host (``preaggregate_host``).

``window_slices=K`` opens a windowed session over a ring of K slices
(:class:`~repro_torch.core.window.SlidingWindowSketch`): ingest lands in the
active slice IN PLACE (the ingest kernel scatters straight into the ring's
slot), ``advance_window`` expires the oldest slice, and queries read the
materialized window (the sum of the live slices, computed once per
mutation).  ``slice_width=``/``max_lateness=`` make it an event-time
session: each ingest carries per-edge ``timestamps``, a watermark tracker
(:mod:`repro_torch.stream.watermark`) drives the window's advances, late but
in-bound edges land in the slice their time belongs to (one ingest dispatch
per distinct slot), and too-late edges are dropped or retracted per
``late_policy``.

Durability: ``wal_dir=`` appends every logical mutation to the write-ahead
log (:mod:`repro_torch.stream.wal`, the reference's byte format) BEFORE any
device dispatch; ``checkpoint_dir=`` enables :meth:`GraphStream.checkpoint`
and :meth:`GraphStream.restore` (:mod:`repro_torch.checkpoint.manager`, the
reference's file format); :meth:`GraphStream.recover` restores the newest
checkpoint and replays the WAL suffix, with exactly-once subscription
delivery.

``mesh=`` (a :class:`~repro_torch.distributed.mesh.Mesh` of
``torch.distributed`` ranks) opens a MESH session, one per rank, each
driven with the same calls (paper §6.3): the rank holds its rows of the
counters (split over the mesh's ``model`` axis) and the whole flow
registers; each ingest goes through
:func:`~repro_torch.core.distributed.distributed_ingest` (the batch split
over the ``("pod", "data")`` axes), and queries through a
:class:`~repro_torch.core.distributed.MeshQueryEngine`, so every family
gives the local session's answer and subscriptions tick as locally.  An
undirected sketch ingests each batch and its mirror, as a local session
does.  ``checkpoint()`` writes the assembled state in the local format from
rank 0 and ``restore()`` gives every rank its rows, so checkpoints move
between mesh and local sessions of either package.

A mesh session is durable as a local one is.  The ranks share one
``wal_dir``, which holds one log of the GLOBAL stream, written by rank 0
alone and byte-identical to the log a local session writes for the same
calls.  After each append rank 0's commit seq goes to every rank, which
waits for it on the host, so no rank acknowledges a batch before rank 0's
append has returned, and receipts and ``wal_seq`` are the local session's
on every rank.  The other ranks only read the log, in ``recover()``, which
restores each rank's rows and replays the shared log's suffix through
``distributed_ingest`` on every rank; opening and recovering check that the
ranks see one log.  ``merge()`` takes a mesh session on either side: shard plus shard on
one mesh layout, a local summary's rows into a mesh session, or a mesh
session's gathered summary into a local one.  The reference's refusals
stand: a mesh with a window, a mesh with fused ingest.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.api.codec import encode_label, encode_labels
from repro_torch.api.planner import execute
from repro_torch.api.query import (
    ErrorBound,
    Query,
    QueryBatch,
    QueryResult,
    error_bound_for,
    validate_theta,
)
from repro_torch.api.subscription import (
    DEFAULT_MAX_PENDING,
    Subscription,
    SubscriptionEvent,
    sub_progress_key,
)
from repro_torch.checkpoint.manager import CheckpointCorruptError, CheckpointManager
from repro_torch.core import distributed as dist_mod
from repro_torch.core import queries as queries_mod
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.ingest import (
    pad_bucket,
    preaggregate_host,
    resolve_backend,
    resolve_preagg,
    touched_row_keys,
)
from repro_torch.core.query_engine import QueryEngine
from repro_torch.core.sketch import GLavaSketch, SketchConfig
from repro_torch.core.window import SlidingWindowSketch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import sketch_plane_shardings
from repro_torch.kernels.preagg.ops import CollapseTables
from repro_torch.stream.events import EventFeed
from repro_torch.stream.wal import AdvanceMutation, EdgeMutation, WriteAheadLog
from repro_torch.stream.watermark import DEFAULT_SOURCE, WatermarkTracker, slice_of, slices_of

# Session-wide event feed bound (per-subscription queues have their own).
EVENT_LOG_MAXLEN = 4096

LATE_POLICIES = ("retract", "drop")


@dataclasses.dataclass
class StreamStats:
    """Session counters (ingest/query throughput, closure refreshes,
    subscription ticks).  Times are host wall-clock seconds
    (:func:`repro_torch.telemetry.now_ns`).  ``ingest_s`` runs from after
    the codec to the batch's launch, plus every flush's wait; ``query_s``
    covers the queries and ticks after their flush."""

    edges_ingested: int = 0
    ingest_s: float = 0.0
    queries_served: int = 0
    query_s: float = 0.0
    closure_refreshes: int = 0
    closure_incremental_refreshes: int = 0
    subscription_ticks: int = 0
    auto_advances: int = 0
    # Batches collapsed on the card (``GLavaSketch.update_collapsed_``).
    device_collapses: int = 0

    def summary(self) -> Dict[str, float]:
        """The counters and two rates.  ``ingest_edges_per_s`` is edges over
        ``ingest_s``, the host's dispatch time alone: not the codec, not the
        ticks, not the device's work, so not a rate the session sustains."""
        return {
            "edges_ingested": self.edges_ingested,
            "ingest_edges_per_s": self.edges_ingested / max(self.ingest_s, 1e-9),
            "queries_served": self.queries_served,
            "queries_per_s": self.queries_served / max(self.query_s, 1e-9),
            "closure_refreshes": self.closure_refreshes,
            "closure_incremental_refreshes": self.closure_incremental_refreshes,
            "subscription_ticks": self.subscription_ticks,
            "auto_advances": self.auto_advances,
        }


@dataclasses.dataclass(frozen=True)
class IngestReceipt:
    """What one ``ingest`` call did: the post-batch epoch, the batch size,
    and the batch's touched-key set — the unique uint32 node keys whose
    sketch ROWS the batch wrote.  ``None`` means "no usable delta" (negative
    weights, the row-width cap overflowed, or tracking already stopped),
    which forces the next closure sync to rebuild from scratch.

    Fused sessions (``ingest_backend="fused"``) report the delta as
    ``touched_rows`` instead: the (d, w_r) bool row-bucket bitmap the
    one-pass kernel wrote, on the session device (``None`` for a batch with
    negative weights).  So do local sessions on a CUDA device's kernels,
    for every batch: the bitmap of the card collapse's second launch, or of
    the rows a batch too small to collapse wrote.  ``touched_keys`` is
    ``None`` for those receipts."""

    epoch: int
    n_edges: int
    touched_keys: Optional[np.ndarray]
    touched_rows: Optional[torch.Tensor] = None
    # Event-time plane (None / 0 for arrival-ordered sessions): the batch's
    # event-time span, the session watermark after folding it, how many
    # edges the lateness policy dropped/retracted, how many slice advances
    # the watermark drove, and the batch's durable WAL commit seq (None
    # when the session has no WAL).
    event_time_min: Optional[float] = None
    event_time_max: Optional[float] = None
    watermark: Optional[float] = None
    late_dropped: int = 0
    late_retracted: int = 0
    auto_advances: int = 0
    wal_seq: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What :meth:`GraphStream.recover` did: the checkpoint step it
    restored (None = no checkpoint, full-genesis replay), how many WAL
    mutations it replayed, and the session epoch / WAL position after."""

    step: Optional[int]
    mutations_replayed: int
    epoch: int
    wal_seq: int


def _preset(name: str) -> SketchConfig:
    from repro_torch.configs import glava

    presets = {
        "smoke": glava.SMOKE,
        "base": glava.BASE,
        "web": glava.WEB,
        "nonsquare": glava.NONSQUARE,
    }
    if name not in presets:
        raise ValueError(f"unknown preset {name!r} (want {sorted(presets)})")
    return presets[name]


class GraphStream:
    """One graph-stream session: a summary plus its ingest/query engines.

    Construct via :meth:`open`.  Every mutation bumps the sketch *epoch*,
    which tags the query engine's transitive-closure cache."""

    def __init__(
        self,
        config: SketchConfig,
        *,
        seed: int = 0,
        device: DeviceLike = None,
        sketch: Union[GLavaSketch, SlidingWindowSketch, None] = None,
        window_slices: Optional[int] = None,
        ingest_backend: str = "auto",
        query_backend: str = "auto",
        checkpoint_dir: Optional[str] = None,
        keep: int = 3,
        mesh=None,
        double_buffer: bool = True,
        max_inflight: int = 2,
        preagg: str = "auto",
        wal_dir: Optional[str] = None,
        wal_fsync_every: int = 1,
        slice_width: Optional[float] = None,
        max_lateness: Optional[float] = None,
        late_policy: str = "retract",
        events_policy: str = "drop_oldest",
    ):
        if isinstance(sketch, SlidingWindowSketch):
            if window_slices not in (None, sketch.n_slices):
                raise ValueError(f"window_slices={window_slices} but the window has {sketch.n_slices} slices")
            window_slices = sketch.n_slices
        elif sketch is not None and window_slices:
            raise ValueError("a windowed session opens on a SlidingWindowSketch, not a GLavaSketch")
        if mesh is not None and window_slices:
            raise ValueError("windowed + distributed sessions are not supported yet")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a repro_torch.distributed.mesh.Mesh, got {type(mesh).__name__}")
            if "model" not in mesh.shape:
                raise ValueError(f"a mesh session splits its rows over a 'model' axis; the mesh has {mesh.axis_names}")
        # Event-time plane: slice_width maps event times onto the window
        # ring; max_lateness bounds out-of-orderness (how far behind the
        # per-source maximum the watermark trails).
        if late_policy not in LATE_POLICIES:
            raise ValueError(f"unknown late_policy {late_policy!r} (want one of {LATE_POLICIES})")
        self._late_policy = late_policy
        self._tracker: Optional[WatermarkTracker] = None
        self._slice_width: Optional[float] = None
        self._lead = 0
        self._head_slice: Optional[int] = None
        # Host mirror of the ring's current slot: slot(b) for an absolute
        # slice b is (b - head_slice + ring_pos) % K, an invariant because
        # the head and the ring only ever advance together.
        self._ring_pos = 0
        if max_lateness is not None and slice_width is None:
            raise ValueError("max_lateness needs slice_width= (event-time slicing)")
        if slice_width is not None:
            if not window_slices:
                raise ValueError("slice_width needs window_slices= (a sliding window)")
            slice_width = float(slice_width)
            if not (slice_width > 0.0) or not math.isfinite(slice_width):
                raise ValueError(f"slice_width must be finite and > 0, got {slice_width}")
            lateness = float(max_lateness) if max_lateness is not None else 0.0
            self._tracker = WatermarkTracker(lateness)
            self._slice_width = slice_width
            # Head slices the ring must keep open AHEAD of the watermark: an
            # in-bound edge (t >= W) from the watermark-defining source sits
            # at most max_lateness past W, i.e. <= lead slices ahead.
            self._lead = int(math.ceil(lateness / slice_width))
            if self._lead + 1 > window_slices:
                raise ValueError(
                    f"max_lateness={lateness:g} spans {self._lead} slices of "
                    f"width {slice_width:g} — it must fit inside the "
                    f"window ring (window_slices={window_slices}); widen the "
                    f"slices or deepen the window"
                )
        if device is None and sketch is not None:
            device = sketch.device
        self.device = resolve_device(device)
        self.config = config
        if sketch is not None and sketch.config != config:
            raise ValueError(f"sketch config {sketch.config} != session config {config}")
        # The session mutates its summary in place: take a private copy.
        self._sketch: Optional[GLavaSketch] = None
        self._window: Optional[SlidingWindowSketch] = None
        # A mesh session holds its rank's shard (its rows of the counters).
        self._mesh: Optional[Mesh] = mesh
        self._stream_axes: Tuple[str, ...] = ()
        if mesh is not None:
            _, stream = sketch_plane_shardings(mesh)
            self._stream_axes = stream.spec[0]
            self._sketch = (
                dist_mod.shard_sketch(mesh, sketch).to(self.device) if sketch is not None
                else dist_mod.empty_shard(mesh, config, seed, self.device)
            )
        elif window_slices:
            self._window = (
                sketch.to(self.device) if sketch is not None
                else SlidingWindowSketch.empty(config, window_slices, seed, self.device)
            )
            self._ring_pos = self._window.current
        elif sketch is not None:
            self._sketch = sketch.to(self.device)
        else:
            self._sketch = GLavaSketch.empty(config, seed, self.device)
        # The materialized window (sum of the live slices), computed at most
        # once per mutation: every write to the ring clears it.
        self._window_sum: Optional[GLavaSketch] = None
        self.window_sums = 0
        # "fused" is a session-level mode, not an IngestEngine backend: the
        # one-pass kernel updates counters, registers and the touched-row
        # bitmap together, which only a plain local session can consume.
        self._fused = ingest_backend == "fused"
        if self._fused and (mesh is not None or window_slices):
            raise ValueError("fused ingest needs a plain local session")
        self.ingest_backend = (
            "fused" if self._fused else resolve_backend(ingest_backend, self.device)
        )
        self._preagg = preagg
        # No session on the card collapses on the host.  A local one on the
        # card's kernels collapses its batches there (``update_collapsed_``),
        # in tables it keeps between batches; a fused one sends the raw batch
        # through the one-pass kernel.  Mesh sessions and the plain backend
        # collapse on the host.
        on_card = self.device.type == "cuda" and mesh is None
        self._device_collapse = on_card and self.ingest_backend == "cuda"
        self._host_collapse = not (self._device_collapse or (on_card and self._fused))
        self._collapse_tables = CollapseTables()
        self.engine = QueryEngine(query_backend) if mesh is None else dist_mod.MeshQueryEngine(mesh, query_backend)
        self.stats = StreamStats()
        self._epoch = 0
        # Standing-query plane: registered subscriptions, the session-wide
        # event feed, and the touched-key accumulator feeding the
        # incremental closure refresh (None = "not additions-only since the
        # last closure sync; full rebuild required"): key arrays, or for a
        # fused session or one that collapses on the card one device bitmap,
        # the OR of its batches' bitmaps.
        self._subs: Dict[int, Subscription] = {}
        self._next_sub_id = 0
        self._event_log = EventFeed(EVENT_LOG_MAXLEN, events_policy)
        self._touched: Optional[List[Union[np.ndarray, torch.Tensor]]] = []
        self._touched_count = 0
        self._monitor_subs: Dict[Tuple[int, float], Subscription] = {}
        # Bounded in-flight ingest: kernel launches are asynchronous, so the
        # host stages the next batch while the device folds the previous
        # one; one CUDA event per batch bounds how many may be outstanding.
        self._max_inflight = max_inflight if double_buffer else 0
        self._inflight: collections.deque = collections.deque()
        # Durability: the WAL (appended before any dispatch) and checkpoints.
        # A mesh session's log is written by rank 0 alone and read by all.
        self._wal = WriteAheadLog(wal_dir, fsync_every=wal_fsync_every) if wal_dir is not None else None
        self._wal_seq = None if self._wal is None else self._wal.last_seq
        self._replaying = False
        self._last_restore_meta: Dict = {}
        self._ckpt = CheckpointManager(checkpoint_dir, keep=keep) if checkpoint_dir is not None else None
        if self._wal is not None and mesh is not None:
            # Also a barrier: every rank has read where the log ends before
            # rank 0 can append again.
            self._check_shared_log()

    # -- construction ---------------------------------------------------------

    @classmethod
    def open(
        cls,
        config: Union[SketchConfig, str, None] = None,
        *,
        epsilon: Optional[float] = None,
        delta: Optional[float] = None,
        sketch: Union[GLavaSketch, SlidingWindowSketch, None] = None,
        **kwargs,
    ) -> "GraphStream":
        """Open a session from a :class:`SketchConfig`, a preset name
        ("smoke" / "base" / "web" / "nonsquare"), a target (ε, δ) pair sized
        per paper Thm 1 / Lemma 5.2, or an existing ``sketch`` (for example
        one converted from the reference by ``repro_torch.convert``; a
        :class:`SlidingWindowSketch` opens a windowed session on its ring).
        Remaining kwargs go to the constructor (seed, device, window_slices,
        ingest_backend, query_backend, checkpoint_dir, wal_dir, ...).  The
        device defaults to CUDA."""
        if isinstance(config, str):
            config = _preset(config)
        elif config is None:
            if sketch is not None:
                config = sketch.config
            elif epsilon is None or delta is None:
                raise ValueError("open() needs a config, a preset, a sketch, or (epsilon, delta)")
            else:
                config = SketchConfig.for_error(epsilon, delta)
        elif not isinstance(config, SketchConfig):
            raise TypeError(f"config must be SketchConfig or preset name, got {config!r}")
        return cls(config, sketch=sketch, **kwargs)

    # -- cost-plane sizing hooks -------------------------------------------------

    @classmethod
    def _probe_session(cls, width: int, depth: int, device, backend: str, **kwargs) -> "GraphStream":
        return cls.open(
            SketchConfig(depth=depth, width_rows=width, width_cols=width), device=device,
            ingest_backend=backend, query_backend=backend, **kwargs,
        )

    @staticmethod
    def _probe_batch(batch: int, device, weight: float = 1.0):
        src = np.arange(batch, dtype=np.uint32)
        return (keys_to_tensor(src, device), keys_to_tensor(src + np.uint32(batch), device),
                torch.full((batch,), weight, dtype=torch.float32, device=device))

    @classmethod
    def cost_probe_update(cls, *, width: int = 64, depth: int = 2, batch: int = 64, negative: bool = False,
                          device: DeviceLike = "cpu", backend: str = "cuda"):
        """The session's in-place device dispatch of an arrival batch
        (:meth:`_update`, what :meth:`ingest` runs after the codec) on a new
        session at (w, d, B): the sizing hook of the cost plane
        (``repro_torch.analysis``), as the reference's ``cost_probe_update``
        (``src/repro/api/stream.py:428``).  ``negative=True`` probes the
        turnstile delete (the same dispatch, negative weights).  ``backend``
        names the ingest and query backends: ``cuda`` takes the kernel
        wrappers, which run their plain versions on CPU tensors.  Returns
        ``(fn, args, counters_shape)``."""
        gs = cls._probe_session(width, depth, device, backend)
        args = cls._probe_batch(batch, gs.device, -1.0 if negative else 1.0)
        return gs._update, args, tuple(gs._sketch.counters.shape)

    @classmethod
    def cost_probe_advance(cls, *, width: int = 64, depth: int = 2, slices: int = 4,
                           device: DeviceLike = "cpu", backend: str = "cuda"):
        """One in-place window advance (expiry of the oldest slice) of a new
        windowed session at (w, d, K).  Returns ``(fn, args, slices_shape)``."""
        gs = cls._probe_session(width, depth, device, backend, window_slices=slices)
        return gs._advance_once, (), tuple(gs._window.slices.shape)

    @classmethod
    def cost_probe_update_slice(cls, *, width: int = 64, depth: int = 2, slices: int = 4, batch: int = 64,
                                device: DeviceLike = "cpu", backend: str = "cuda"):
        """The event-time dispatch of one batch into one ring slot
        (:meth:`_update_slot`) of a new windowed session at (w, d, K, B),
        the slot an argument.  Returns ``(fn, args, slices_shape)``."""
        gs = cls._probe_session(width, depth, device, backend, window_slices=slices)
        return gs._update_slot, (0, *cls._probe_batch(batch, gs.device)), tuple(gs._window.slices.shape)

    # -- state ---------------------------------------------------------------

    @property
    def epoch(self) -> int:
        """Mutation counter; tags the engine's closure cache."""
        return self._epoch

    @property
    def watermark(self) -> Optional[float]:
        """The event-time low watermark (None on arrival-ordered sessions;
        -inf before the first timestamped batch)."""
        return None if self._tracker is None else self._tracker.watermark

    @property
    def late_dropped(self) -> int:
        """Too-late edges dropped by ``late_policy="drop"`` (monotone)."""
        return 0 if self._tracker is None else self._tracker.late_dropped

    @property
    def late_retracted(self) -> int:
        """Too-late edges backed out via the turnstile-delete path by
        ``late_policy="retract"`` (monotone)."""
        return 0 if self._tracker is None else self._tracker.late_retracted

    @property
    def events_dropped(self) -> int:
        """Session-feed events lost to the overflow policy (monotone)."""
        return self._event_log.dropped

    @property
    def wal_seq(self) -> Optional[int]:
        """The WAL's last durable record seq (None without a WAL)."""
        return self._wal_seq

    @property
    def sketch(self) -> GLavaSketch:
        """A SNAPSHOT of the summary (for a windowed session, of the
        materialized window): a copy that later ingests do not touch."""
        self.flush()
        if self._mesh is not None:
            return dist_mod.gather_rows(self._mesh, self._sketch).clone()
        return self._live().clone()

    def _live(self) -> GLavaSketch:
        """The summary queries read: the live sketch, or the window's sum,
        materialized once after each write to the ring."""
        if self._window is None:
            return self._sketch
        if self._window_sum is None:
            self._window_sum = self._window.window_sketch()
            self.window_sums += 1
        return self._window_sum

    def _ring_written(self) -> None:
        """Drop the materialized window after a write to the ring."""
        self._window_sum = None

    def error_bound(self, family: str = "edge") -> ErrorBound:
        """The (ε, δ) annotation this session attaches to ``family`` results."""
        return error_bound_for(family, self.config)

    # -- ingest ---------------------------------------------------------------

    def _tensor(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the session device (uint32 keys become int64)."""
        if host.dtype == np.uint32:
            return keys_to_tensor(host, self.device)
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device, non_blocking=True)

    def _mark_inflight(self) -> None:
        """Record the batch just launched; wait for the oldest past the bound."""
        if self.device.type != "cuda":
            return  # CPU ops complete before they return
        event = torch.cuda.Event()
        event.record()
        self._inflight.append(event)
        if len(self._inflight) > self._max_inflight:
            with telemetry.span("ingest.wait"):
                while len(self._inflight) > self._max_inflight:
                    self._inflight.popleft().synchronize()

    def ingest(self, src, dst, weights=None, *, timestamps=None, source=None) -> IngestReceipt:
        """Fold one edge batch into the summary.  ``src``/``dst`` are label
        batches (str or int, encoded here by the key codec).  Returns as
        soon as the batch is launched — UNLESS a subscription comes due on
        this mutation, in which case the standing queries re-evaluate
        before returning.

        ``timestamps`` is the per-edge EVENT-TIME column (float seconds).
        An event-time session (opened with ``slice_width=``) requires it:
        the watermark tracker folds the batch, advances the window when the
        watermark crosses a slice boundary, routes late-but-in-bound edges
        into their slice, and drops or retracts too-late edges per
        ``late_policy``.  ``source`` names the emitting stream for the
        per-source low-watermark merge."""
        with telemetry.span("ingest") as call:
            with telemetry.span("ingest.codec"):
                s_np = np.atleast_1d(encode_labels(src))
                d_np = np.atleast_1d(encode_labels(dst))
                if s_np.shape != d_np.shape:
                    raise ValueError(f"src/dst shape mismatch: {s_np.shape} vs {d_np.shape}")
                n_edges = int(s_np.shape[0])
                w_np = (
                    np.ones(n_edges, np.float32)
                    if weights is None
                    else np.atleast_1d(np.asarray(weights, np.float32))
                )
                ts_np = None
                if timestamps is not None:
                    ts_np = np.atleast_1d(np.asarray(timestamps, np.float64))
                    if ts_np.shape != s_np.shape:
                        raise ValueError(f"timestamps/src shape mismatch: {ts_np.shape} vs {s_np.shape}")
                    if ts_np.size and not np.all(np.isfinite(ts_np)):
                        raise ValueError("event timestamps must be finite")
                elif self._tracker is not None:
                    raise ValueError(
                        "event-time session (opened with slice_width=/max_lateness=) "
                        "requires timestamps= on every ingest"
                    )
                source_key = DEFAULT_SOURCE if source is None else int(encode_label(source))
            receipt = self._ingest_encoded(s_np, d_np, w_np, ts_np, source_key)
            call.tag(self._epoch)
        return receipt

    def _log(self, append: Callable[[], int]) -> int:
        """Append to the WAL (``append()`` returns the commit seq) and return
        the seq.  On a mesh session rank 0 alone appends (and fsyncs per
        ``wal_fsync_every``); then every rank takes rank 0's seq through a
        collective over all axes that returns to the host only after rank 0
        has entered it.  So no rank dispatches the mutation, or acknowledges
        it, before rank 0's append has returned; and an append that fails on
        rank 0 raises on every rank."""
        if self._mesh is None:
            self._wal_seq = append()
            return self._wal_seq
        seq, error = -1, None
        if self._mesh.rank == 0:
            try:
                seq = append()
            except Exception as exc:  # told to every rank, then re-raised
                error = exc
        (seq,) = self._mesh.from_rank0([seq])
        if error is not None:
            raise error
        if seq < 0:
            raise RuntimeError("rank 0 failed to append to the write-ahead log; the mutation was not applied")
        self._wal_seq = seq
        return seq

    def _check_shared_log(self, after_seq: int = 0) -> None:
        """Raise on every rank of a mesh session unless all read one log:
        the same commit seq, segments (start seqs and sizes on disk) and,
        in ``recover()``, the same checkpointed position to replay from."""
        segs = self._wal.segments()
        layout = hashlib.blake2b(repr([(p.name, p.stat().st_size) for p in segs]).encode(), digest_size=7)
        mine = [self._wal_seq, after_seq, len(segs), int.from_bytes(layout.digest(), "little")]
        if not self._mesh.agree(mine):
            raise RuntimeError(
                f"the ranks of a mesh session read different write-ahead logs (rank {self._mesh.rank} reads "
                f"seq {self._wal_seq}, {len(segs)} segments and replays after seq {after_seq} from "
                f"{self._wal.dir}); open every rank on one shared wal_dir and checkpoint_dir"
            )

    def _ingest_encoded(
        self,
        s_np: np.ndarray,
        d_np: np.ndarray,
        w_np: np.ndarray,
        ts_np: Optional[np.ndarray],
        source_key: int,
    ) -> IngestReceipt:
        """Post-codec ingest, the path WAL replay re-enters (keys are
        already uint32, the source label already hashed).  Appends to the
        WAL FIRST, before any device dispatch, so an acknowledged batch is
        always recoverable."""
        t0 = telemetry.now_ns()
        n_edges = int(s_np.shape[0])
        wal_seq = None
        if self._wal is not None and not self._replaying:
            wal_seq = self._log(lambda: self._wal.append_edges(s_np, d_np, w_np, ts_np, source_key=source_key))
        ev_min = ev_max = None
        if ts_np is not None and n_edges:
            ev_min, ev_max = float(ts_np.min()), float(ts_np.max())
        if self._tracker is not None:
            return self._ingest_eventtime(
                t0, s_np, d_np, w_np, ts_np, source_key, ev_min=ev_min, ev_max=ev_max, wal_seq=wal_seq
            )
        additive = not bool(np.any(w_np < 0))
        # Heavy-tail fast path: collapse duplicate (src, dst) pairs, so the
        # device scatters one slot per distinct pair and the flow registers
        # one slot per distinct endpoint.  Exact for signed weights.  A
        # local session on the card collapses there, a fused one on the card
        # not at all (its one-pass kernel takes the raw batch), others on
        # the host.
        pre = None
        collapse = resolve_preagg(self._preagg, batch=n_edges)
        on_card = collapse and self._device_collapse
        if collapse and self._host_collapse:
            with telemetry.span("ingest.preaggregate"):
                pre = preaggregate_host(s_np, d_np, w_np)
        # Only pay the host-side unique scan while a touched-key delta can
        # still be consumed; the collapsed batch gives the unique sources
        # for free.  Fused sessions and those that collapse on the card skip
        # all of this: their delta is a device bitmap, for every batch.
        bitmap = self._fused or self._device_collapse
        track = self._touched is not None and additive
        touched = None
        if track and not bitmap:
            with telemetry.span("ingest.touched"):
                if pre is not None:
                    if self.config.directed:
                        touched = pre.src_unique
                    else:
                        touched = np.unique(np.concatenate([pre.src_unique, pre.dst_unique]))
                    if touched.size > self.config.width_rows:
                        touched = None
                else:
                    touched = touched_row_keys(
                        s_np, None if self.config.directed else d_np, cap=self.config.width_rows
                    )
        touched_rows = None
        if self._mesh is not None:
            self._mesh_ingest(s_np, d_np, w_np, pre)
        elif self._fused:
            with telemetry.span("ingest.copy"):
                if pre is not None:
                    # Collapsed pairs through the kernel.  The padding slots
                    # (key 0, weight 0) are valid slots: they add nothing but
                    # mark row_hash(0), as in the reference.
                    s, d, w = (self._tensor(pad_bucket(x)) for x in (pre.src, pre.dst, pre.weights))
                else:
                    s, d, w = self._tensor(s_np), self._tensor(d_np), self._tensor(w_np)
            _, touched_rows = self._sketch.update_fused_(s, d, w)
            if not additive:
                touched_rows = None
        elif on_card:
            touched_rows = self._collapse_on_card(s_np, d_np, w_np, track)
        elif pre is not None:
            # Arrays are padded to power-of-two buckets (zero weights are the
            # identity), so batch shapes stay on a short ladder.
            with telemetry.span("ingest.copy"):
                arrays = [self._tensor(pad_bucket(x)) for x in (
                    pre.src, pre.dst, pre.weights, pre.src_unique, pre.src_totals, pre.dst_unique, pre.dst_totals,
                )]
            self._update_pre(*arrays)
        else:
            with telemetry.span("ingest.copy"):
                arrays = [self._tensor(x) for x in (s_np, d_np, w_np)]
            self._update(*arrays)
            if bitmap and track:
                touched_rows = self._rows_bitmap(arrays[0], arrays[1])
        self._ring_written()
        self._mark_inflight()
        self.stats.edges_ingested += n_edges
        self.stats.ingest_s += (telemetry.now_ns() - t0) / 1e9
        self._epoch += 1
        self._note_touched(touched_rows if bitmap else touched)
        receipt = IngestReceipt(
            epoch=self._epoch,
            n_edges=n_edges,
            touched_keys=touched,
            touched_rows=touched_rows,
            event_time_min=ev_min,
            event_time_max=ev_max,
            wal_seq=wal_seq,
        )
        self._after_mutation()
        return receipt

    def _update(self, src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> None:
        """The in-place device dispatch of an arrival batch on a local
        session: into the summary, or the window's active slice (a view of
        the ring)."""
        live = self._sketch if self._window is None else self._window
        live.update_(src, dst, weights, backend=self.ingest_backend)

    def _collapse_on_card(self, s_np, d_np, w_np, track_rows: bool) -> Optional[torch.Tensor]:
        """One batch of a local session on the card: the raw columns copied
        once, as one (3, B) int32 tensor (the keys and the weights' float32
        bits), then collapsed and folded in there (``update_collapsed_``:
        registers and bitmap in the ``ingest.preaggregate`` span, then B1 on
        the pairs), into the summary or the window's active slice.  Returns
        the batch's touched-row bitmap when ``track_rows``, else ``None``."""
        with telemetry.span("ingest.copy"):
            packed = np.empty((3, s_np.shape[0]), np.uint32)
            packed[0], packed[1], packed[2] = s_np, d_np, w_np.view(np.uint32)
            batch = self._tensor(packed.view(np.int32))
        live = self._sketch if self._window is None else self._window
        _, touched = live.update_collapsed_(
            batch, self._collapse_tables, track_rows, backend=self.ingest_backend,
            collapse_scope=lambda: telemetry.span("ingest.preaggregate"),
        )
        self.stats.device_collapses += 1
        return touched

    def _rows_bitmap(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """The (d, w_r) bool bitmap of the rows a raw batch wrote (its
        sources', and in an undirected sketch its destinations' too), on the
        device: the delta form of a session that collapses on the card, for
        the batches it does not collapse."""
        family = (self._sketch if self._window is None else self._window.template).row_hash
        rows = family(src if self.config.directed else torch.cat([src, dst]))
        bitmap = torch.zeros((rows.shape[0], self.config.width_rows), dtype=torch.bool, device=self.device)
        return bitmap.scatter_(1, rows, True)

    def _update_pre(self, *arrays: torch.Tensor) -> None:
        """The in-place device dispatch of a host-collapsed batch (the seven
        padded arrays of ``preaggregate_host``) on a local session."""
        live = self._sketch if self._window is None else self._window
        live.update_preaggregated_(*arrays, backend=self.ingest_backend)

    def _mesh_ingest(self, s_np, d_np, w_np, pre) -> None:
        """One batch of a mesh session through ``distributed_ingest``, as the
        reference's mesh branch does it: flush, then the batch, or its
        collapsed pairs with their marginals.  An undirected sketch ingests
        the mirrored batch too, as ``update_`` does."""
        self.flush()
        if pre is not None:
            s, d, w, su, st, du, dt = (self._tensor(x) for x in (
                pre.src, pre.dst, pre.weights, pre.src_unique, pre.src_totals, pre.dst_unique, pre.dst_totals,
            ))
            passes = [(s, d, (su, st, du, dt)), (d, s, (du, dt, su, st))]
        else:
            s, d, w = self._tensor(s_np), self._tensor(d_np), self._tensor(w_np)
            passes = [(s, d, None), (d, s, None)]
        for a, b, marginals in passes[: 1 if self.config.directed else 2]:
            dist_mod.distributed_ingest(
                self._mesh, self._sketch, a, b, w,
                stream_axes=self._stream_axes, backend=self.ingest_backend, preagg_marginals=marginals,
            )

    def _dispatch_update_slice(self, s_np, d_np, w_np, slot: int) -> None:
        """One event-time dispatch into ring slot ``slot``: the slot's view
        through the ingest engine (one ingest-kernel launch on the card, a
        second for an undirected sketch's mirrored edges).  Arrays are
        padded to power-of-two buckets (zero weights are the identity)."""
        with telemetry.span("ingest.copy"):
            arrays = [self._tensor(pad_bucket(x)) for x in (s_np, d_np, w_np)]
        self._update_slot(slot, *arrays)
        self._ring_written()

    def _update_slot(self, slot: int, src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> None:
        """The in-place device dispatch of one batch into ring slot ``slot``."""
        self._window.update_at_(slot, src, dst, weights, backend=self.ingest_backend)

    def _ingest_eventtime(
        self,
        t0: int,
        s_np: np.ndarray,
        d_np: np.ndarray,
        w_np: np.ndarray,
        ts_np: np.ndarray,
        source_key: int,
        *,
        ev_min: Optional[float],
        ev_max: Optional[float],
        wal_seq: Optional[int],
    ) -> IngestReceipt:
        """Event-time ingest: watermark fold -> auto-advance -> slice
        routing -> late-edge policy, all driven by the batch's event-time
        column.  Deterministic given the mutation sequence, which is what
        makes WAL replay bit-identical."""
        K = self._window.n_slices
        width = self._slice_width
        late_dropped = late_retracted = auto_adv = 0
        watermark = None
        additive = not bool(np.any(w_np < 0))
        late_mask = None
        floor_slot = 0
        if n_edges := int(s_np.shape[0]):
            # Lateness is judged against the watermark PROMISED before this
            # batch arrived: the batch's own maximum must not retroactively
            # declare its earlier edges late, or an in-order batch spanning
            # more than max_lateness would retract its own head.
            promised = self._tracker.watermark
            watermark = self._tracker.observe(source_key, ev_max)
            b = slices_of(ts_np, width)
            late_mask = ts_np < promised
            # New ring head: the watermark keeps `lead` slices open past
            # itself; an in-bound burst ahead of a lagging source can push
            # the head further.  Monotone by construction.
            target = slice_of(watermark, width) + self._lead
            if not late_mask.all():
                target = max(target, int(b[~late_mask].max()))
            prev = self._head_slice if self._head_slice is not None else target
            target = max(target, prev)
            auto_adv = target - prev
            self._head_slice = target
            for _ in range(auto_adv):
                self._advance_once()
            self.stats.auto_advances += auto_adv
            # Oldest live slice after the advances; in-bound-by-watermark
            # edges that still land below the ring (a fast source far ahead
            # of a slow one) are operationally late too.  Ring slots are
            # addressed RELATIVE to the head.
            slot_off = (self._ring_pos - self._head_slice) % K
            floor_slice = self._head_slice - K + 1
            floor_slot = int((floor_slice + slot_off) % K)
            late_mask = late_mask | (b < floor_slice)
            n_late = int(late_mask.sum())
            if n_late and self._late_policy == "drop":
                keep = ~late_mask
                s_np, d_np, w_np, b = s_np[keep], d_np[keep], w_np[keep], b[keep]
                late_dropped = n_late
                self._tracker.late_dropped += n_late
            elif n_late:
                # Retract path: the whole batch lands (late edges clamped to
                # the oldest live slice), then the late subset is backed out
                # through the turnstile-delete path: same slot, negated
                # weights.
                b = np.where(late_mask, floor_slice, b)
                late_retracted = n_late
                self._tracker.late_retracted += n_late
            touched = None
            if self._touched is not None and additive and late_retracted == 0:
                touched = touched_row_keys(
                    s_np, None if self.config.directed else d_np, cap=self.config.width_rows
                )
            slots = (b + slot_off) % K
            for slot in np.unique(slots):
                m = slots == slot
                self._dispatch_update_slice(s_np[m], d_np[m], w_np[m], int(slot))
            if late_retracted:
                m = late_mask
                self._dispatch_update_slice(s_np[m], d_np[m], -w_np[m], floor_slot)
                additive = False  # the retraction is a turnstile delete
            self._mark_inflight()
        else:
            touched = np.zeros(0, np.uint32) if self._touched is not None else None
        self.stats.edges_ingested += n_edges
        self.stats.ingest_s += (telemetry.now_ns() - t0) / 1e9
        self._epoch += 1
        self._note_touched(touched if additive else None)
        receipt = IngestReceipt(
            epoch=self._epoch,
            n_edges=n_edges,
            touched_keys=touched if additive else None,
            event_time_min=ev_min,
            event_time_max=ev_max,
            watermark=watermark,
            late_dropped=late_dropped,
            late_retracted=late_retracted,
            auto_advances=auto_adv,
            wal_seq=wal_seq,
        )
        self._after_mutation()
        return receipt

    def delete(self, src, dst, weights=None, *, timestamps=None, source=None) -> IngestReceipt:
        """Turnstile deletion: negative-weight ingest (paper Section 6.1.1).
        Not additions-only, so the receipt's touched set is ``None`` and any
        cached reachability closure rebuilds from scratch on next use.
        Event-time sessions route the retraction into the slice the original
        edge's ``timestamps`` place it in."""
        if weights is None:
            weights = np.ones(len(np.atleast_1d(np.asarray(src))), np.float32)
        return self.ingest(src, dst, -np.asarray(weights), timestamps=timestamps, source=source)

    def flush(self) -> None:
        """Block until every launched ingest batch has landed on the device."""
        if not self._inflight:
            return
        t0 = telemetry.now_ns()
        while self._inflight:
            self._inflight.popleft().synchronize()
        self.stats.ingest_s += (telemetry.now_ns() - t0) / 1e9

    # -- queries --------------------------------------------------------------

    def query(self, *queries) -> Union[QueryResult, List[QueryResult]]:
        """Answer queries against the live summary: one :class:`Query`
        (returns one :class:`QueryResult`), several, or one
        :class:`QueryBatch` (returns a request-ordered list).  The planner
        fuses the batch into at most one engine dispatch per family."""
        single = len(queries) == 1 and isinstance(queries[0], Query)
        if len(queries) == 1 and isinstance(queries[0], QueryBatch):
            batch = queries[0]
        else:
            batch = QueryBatch(queries)
        if len(batch) == 0:
            return []
        self.flush()
        t0 = telemetry.now_ns()
        if any(q.family == "reach" for q in batch):
            # Sync the closure cache from the touched-key delta so one-shot
            # reach pulls ride the same incremental refresh as subscriptions.
            self._ensure_closure()
        results = execute(self.engine, self._live(), batch, epoch=self._epoch)
        self.stats.query_s += (telemetry.now_ns() - t0) / 1e9
        self._count_served(results)
        self._sync_engine_stats()
        return results[0] if single else results

    # -- standing queries (subscriptions) -------------------------------------

    def subscribe(
        self,
        *queries,
        every: int = 1,
        on_result: Optional[Callable[[SubscriptionEvent], None]] = None,
        alarm: Optional[Callable[[List[QueryResult]], bool]] = None,
        name: Optional[str] = None,
        max_pending: int = DEFAULT_MAX_PENDING,
        overflow: str = "drop_oldest",
    ) -> Subscription:
        """Register a standing query batch, compiled ONCE and re-evaluated
        after every ``every``-th mutation (ingest / delete / advance_window /
        merge), emitting
        :class:`SubscriptionEvent`\\ s through ``Subscription.poll()``, the
        session-wide :meth:`events` feed and ``on_result``.  ``alarm`` is a
        predicate over the request-ordered results whose value rides on
        each event.  Reach subscriptions refresh the cached closure from
        the rows touched since the last tick instead of re-squaring."""
        if len(queries) == 1 and isinstance(queries[0], QueryBatch):
            batch = queries[0]
        else:
            batch = QueryBatch(queries)
        for q in batch:
            if q.family == "heavy":
                validate_theta(q.theta)
        sub = Subscription(
            self,
            self._next_sub_id,
            batch,
            every=every,
            on_result=on_result,
            alarm=alarm,
            name=name,
            max_pending=max_pending,
            overflow=overflow,
        )
        self._next_sub_id += 1
        self._subs[sub.id] = sub
        return sub

    @property
    def subscriptions(self) -> Tuple[Subscription, ...]:
        """The active subscriptions, registration-ordered."""
        return tuple(self._subs.values())

    def events(self) -> Iterator[SubscriptionEvent]:
        """Drain the session-wide event feed (all subscriptions, emission
        order).  Non-blocking: yields the pending events and stops."""
        while self._event_log:
            yield self._event_log.popleft()

    def _unsubscribe(self, sub: Subscription) -> None:
        self._subs.pop(sub.id, None)
        if sub.plan.has_reach:
            # The cancelled plan may be the only closure consumer: drop the
            # cache so no later epoch tag can collide with a stale closure.
            self.engine.invalidate()

    def _note_touched(self, batch_delta) -> None:
        """Accumulate one batch's touched-row delta for the next closure
        sync: a unique key array (plain sessions) or a (d, w_r) bool device
        bitmap (fused sessions and those that collapse on the card).  ``None`` (non-additive batch) or
        overflowing the row width forces the next sync to rebuild from
        scratch."""
        if self._touched is None:
            return
        if batch_delta is None:
            self._touched = None
            self._touched_count = 0
            return
        if isinstance(batch_delta, torch.Tensor):
            # Bitmap: OR into one device accumulator (no sync, no overflow
            # cap), so the delta stays (d, w_r) between closure syncs.
            if self._touched:
                self._touched[0] |= batch_delta
            else:
                self._touched.append(batch_delta.clone())
            return
        self._touched.append(batch_delta)
        self._touched_count += int(batch_delta.size)
        if self._touched_count > self.config.width_rows:
            self._touched = None
            self._touched_count = 0

    def _ensure_closure(self) -> None:
        """Bring the engine's closure cache up to the current epoch — by
        touched-row refresh when the history since the last sync is
        additions-only, else by full rebuild."""
        delta = None
        if self._touched is not None:
            if not self._touched:
                delta = np.zeros(0, np.uint32)
            elif isinstance(self._touched[0], torch.Tensor):
                # The accumulated device bitmap; refresh_closure makes its
                # one host copy, and only when it refreshes incrementally.
                delta = self._touched[0]
            else:
                delta = np.unique(np.concatenate(self._touched)).astype(np.uint32)
        self.engine.refresh_closure(self._live(), delta, self._epoch)
        self._touched = []
        self._touched_count = 0

    def _after_mutation(self) -> None:
        """Re-evaluate every subscription that came due on this mutation."""
        due = [s for s in list(self._subs.values()) if s.active and s._note_mutation()]
        if not due:
            return
        with telemetry.span("tick"):
            with telemetry.span("tick.wait"):
                self.flush()
            t0 = telemetry.now_ns()
            if any(s.plan.has_reach for s in due):
                self._ensure_closure()
            sketch = self._live()
            now = telemetry.now_ns() / 1e9
            for sub in due:
                results = sub.plan.run(self.engine, sketch, epoch=self._epoch)
                event = SubscriptionEvent(
                    subscription_id=sub.id,
                    name=sub.name,
                    tick=sub.ticks + 1,
                    epoch=self._epoch,
                    timestamp=now,
                    results=tuple(results),
                    alarm=None if sub.alarm is None else bool(sub.alarm(results)),
                )
                if sub._deliver(event):
                    # Deduplicated re-emissions (the exactly-once replay floor)
                    # still advance the subscription's progress, but never
                    # re-enter the feeds or callbacks.
                    self._event_log.push(event)
                self.stats.subscription_ticks += 1
                self._count_served(results)
            self.stats.query_s += (telemetry.now_ns() - t0) / 1e9
        self._sync_engine_stats()

    def _count_served(self, results) -> None:
        for r in results:
            v = r.value
            self.stats.queries_served += (
                int(np.size(v[0])) if isinstance(v, tuple) else int(np.size(v))
            )

    def _sync_engine_stats(self) -> None:
        self.stats.closure_refreshes = self.engine.closure_refreshes
        self.stats.closure_incremental_refreshes = self.engine.closure_incremental_refreshes

    def monitor(self, src, dst, weights, watch, theta: float) -> bool:
        """Paper Section 4.2's real-time monitor as a threshold subscription:
        a standing ``Query.heavy(watch, θ)`` with an alarm on the in-flow
        bit, registered once per (watch, θ) and evaluated right after this
        batch is ingested.  Returns the alarm decision."""
        theta = validate_theta(theta)
        key = (int(np.uint32(encode_labels(watch))), theta)
        sub = self._monitor_subs.get(key)
        if sub is None or not sub.active:
            sub = self.subscribe(
                Query.heavy(watch, theta),
                every=1,
                alarm=lambda results: bool(np.asarray(results[0].value[0])),
                name=f"monitor:{key[0]}@{theta:g}",
            )
            self._monitor_subs[key] = sub
        self.ingest(src, dst, weights)
        sub.poll()  # the wrapper consumes its events; last_event remains
        return bool(sub.last_event.alarm)

    def pagerank(self, damping: float = 0.85, iters: int = 32) -> np.ndarray:
        """PageRank run directly on the summary-as-a-graph (Section 3.3
        Remark; reference ``GraphStream.pagerank``,
        ``src/repro/api/stream.py:1118``): flushes, then returns the (d, w)
        bucket ranks as numpy."""
        with telemetry.span("analytics.pagerank"):
            self.flush()
            sketch = self._live() if self._mesh is None else dist_mod.gather_rows(self._mesh, self._sketch)
            return queries_mod.sketch_pagerank(sketch, damping, iters).cpu().numpy()

    # -- convenience wrappers (vectorized) --------------------------------------

    def edge_frequency(self, src, dst) -> np.ndarray:
        return np.atleast_1d(self.query(Query.edge(src, dst)).value)

    def in_flow(self, keys) -> np.ndarray:
        return np.atleast_1d(self.query(Query.in_flow(keys)).value)

    def out_flow(self, keys) -> np.ndarray:
        return np.atleast_1d(self.query(Query.out_flow(keys)).value)

    def heavy_hitters(self, keys, theta: float) -> np.ndarray:
        in_heavy, _ = self.query(Query.heavy(keys, theta)).value
        return np.atleast_1d(in_heavy)

    def reachable(self, src, dst) -> np.ndarray:
        return np.atleast_1d(self.query(Query.reach(src, dst)).value)

    def subgraph_weight(self, src, dst) -> float:
        return float(self.query(Query.subgraph(src, dst)).value)

    # -- lifecycle ------------------------------------------------------------

    def advance_window(self) -> None:
        """Move the sliding window to the next time slice (expiring the
        oldest slice); no-op for non-windowed sessions.  Counts as a
        mutation for subscriptions; expiry removes edges, so any cached
        reachability closure rebuilds from scratch on next use.

        On an event-time session this also moves the ring head one slice
        forward (an explicit advance DECLARES a new open slice; the
        watermark keeps driving automatic ones).  Explicit advances are
        WAL-logged; watermark-driven ones are not: replay re-derives them
        from the logged event times."""
        if self._window is None:
            return
        if self._wal is not None and not self._replaying:
            self._log(self._wal.append_advance)
        if self._head_slice is not None:
            self._head_slice += 1
        self._advance_once()

    def _advance_once(self) -> None:
        """One ring advance in place: expiry + epoch bump + subscription
        tick.  Shared by explicit ``advance_window`` and the
        watermark-driven automatic path (which is NOT WAL-logged)."""
        self.flush()
        self._window.advance_()
        self._ring_written()
        self._ring_pos = (self._ring_pos + 1) % self._window.n_slices
        self._epoch += 1
        self._note_touched(None)
        self._after_mutation()

    def merge(self, other: "GraphStream") -> "GraphStream":
        """Merge another session's summary into this one (linearity; the
        paper's distributed merge-by-add).  Both must share a hash family.
        The merged summary is a new tensor: neither operand is aliased.

        Either side may be a mesh session.  Mesh into mesh on one mesh
        layout adds shard to shard and registers to registers on each rank,
        with no collective; a local summary (or a mesh session on another
        layout, gathered first) adds its rows of this rank and its whole
        registers; a mesh session into a local one is gathered first
        (``gather_rows``, a collective every rank calls)."""
        if self._window is not None or other._window is not None:
            raise ValueError("merge() runs on non-windowed sessions")
        self.flush()
        other.flush()
        if not self._sketch.same_family(other._sketch):
            raise ValueError(
                "cannot merge sketches with different hash families "
                "(open both sessions with the same config and seed)"
            )
        if self._wal is not None and not self._replaying:
            # The merged-in state never went through this WAL: log a barrier
            # replay refuses to cross, and checkpoint() right after so
            # recovery never needs to.
            self._log(self._wal.append_merge_barrier)
        theirs = other._sketch
        if other._mesh is not None and (
            self._mesh is None or (other._mesh.shape, other._mesh.axis_names) != (self._mesh.shape, self._mesh.axis_names)
        ):
            theirs = dist_mod.gather_rows(other._mesh, theirs)
        if self._mesh is not None and theirs.counters.shape != self._sketch.counters.shape:
            self._sketch = dist_mod.merge_rows(self._mesh, self._sketch, theirs)
        else:
            self._sketch = self._sketch.merge(theirs)
        self.stats.edges_ingested += other.stats.edges_ingested
        self._epoch += 1
        self._note_touched(None)  # foreign rows everywhere: full rebuild
        self._after_mutation()
        return self

    def checkpoint(self, step: Optional[int] = None) -> int:
        """Durably save the session state (requires ``checkpoint_dir``).
        Returns the step the checkpoint was saved under.

        With a WAL attached, the checkpoint also records its durable WAL
        position (``wal_seq``), the watermark-tracker state and each active
        subscription's tick progress (everything :meth:`recover` needs for
        exactly-once replay), then rotates the WAL segment and drops the
        segments every retained checkpoint already covers."""
        if self._ckpt is None:
            raise ValueError("open the session with checkpoint_dir= to checkpoint")
        self.flush()
        step = self._epoch if step is None else step
        state = self._window if self._window is not None else self._sketch
        meta: Dict = {"epoch": self._epoch}
        if self._wal is not None:
            self._wal.sync()
            meta["wal_seq"] = self._wal_seq
        if self._tracker is not None:
            meta["watermark"] = self._tracker.state()
            meta["head_slice"] = self._head_slice
        subs = {
            sub_progress_key(s): {"ticks": s.ticks, "pending": s._mutations_pending}
            for s in self._subs.values()
            if s.active
        }
        if subs:
            meta["subs"] = subs
        if self._mesh is None:
            self._ckpt.save(step, state, metadata=meta)
            self._retire_segments()
        else:
            # The assembled state, written once, in the local format; rank 0
            # alone rotates and collects the log's segments, before the
            # barrier, so no rank is still reading one it deletes.
            whole = dist_mod.gather_rows(self._mesh, self._sketch)
            if self._mesh.rank == 0:
                self._ckpt.save(step, whole, metadata=meta)
                self._retire_segments()
            del whole
            self._mesh.barrier()
        return step

    def _retire_segments(self) -> None:
        """After a checkpoint: rotate the WAL's segment and drop the segments
        every retained checkpoint covers (nothing without a WAL).  Rotation
        is keyed to the checkpoint step: the next mutation opens a fresh
        segment, so no segment straddles the boundary and GC can reason per
        whole segment."""
        if self._wal is None:
            return
        self._wal.rotate()
        covered = None
        for s in self._ckpt.all_steps():
            try:
                seq = int(self._ckpt.read_metadata(s).get("wal_seq", 0))
            except CheckpointCorruptError:
                seq = 0  # unreadable manifest: assume it covers nothing
            covered = seq if covered is None else min(covered, seq)
        if covered:
            self._wal.gc(covered)

    def restore(self, step: Optional[int] = None) -> int:
        """Restore session state from the checkpoint directory (latest step
        by default; a checkpoint written by either package).  A checkpoint
        without flow registers restores through the fill-missing path and
        its registers are rebuilt from the counters.  Returns the step."""
        if self._ckpt is None:
            raise ValueError("open the session with checkpoint_dir= to restore")
        self.flush()
        like = self._window if self._window is not None else self._sketch
        shardings = None if self._mesh is None else dist_mod.counter_placement(self._mesh)
        state, meta = self._ckpt.restore(step, like=like, shardings=shardings, fill_missing=True)
        if meta.get("filled_leaves"):
            # Registers absent from an old checkpoint: rebuild from counters.
            if self._mesh is not None:
                whole = dist_mod.gather_rows(self._mesh, state)
                state = dataclasses.replace(whole.with_counters(whole.counters), counters=state.counters)
            elif isinstance(state, GLavaSketch):
                state = state.with_counters(state.counters)
            else:
                state.row_flows = torch.sum(state.slices, dim=3)
                state.col_flows = torch.sum(state.slices, dim=2)
        if self._window is not None:
            self._window = state
            self._ring_written()
            # Re-sync the host ring-position mirror with the restored ring
            # (the head-relative slot mapping depends on it).
            self._ring_pos = state.current
        else:
            self._sketch = state
        self._epoch = int(meta.get("epoch", meta["step"]))
        if self._tracker is not None:
            wm_state = meta.get("watermark")
            if wm_state is not None:
                self._tracker = WatermarkTracker.from_state(wm_state)
                head = meta.get("head_slice")
                self._head_slice = None if head is None else int(head)
            else:
                # Pre-event-time checkpoint: start the tracker fresh.
                self._tracker = WatermarkTracker(self._tracker.max_lateness)
                self._head_slice = None
        subs_meta = meta.get("subs") or {}
        for sub in self._subs.values():
            m = subs_meta.get(sub_progress_key(sub))
            if m is not None:
                sub.ticks = int(m["ticks"])
                sub._mutations_pending = int(m["pending"])
        self.engine.invalidate()  # any cached closure predates the restore
        self._touched = []
        self._touched_count = 0
        self._last_restore_meta = meta
        return int(meta["step"])

    def recover(self, step: Optional[int] = None) -> RecoveryReport:
        """Crash recovery (requires ``wal_dir``): restore the newest usable
        checkpoint (falling back past a corrupt one, or starting from the
        empty summary when none exists), then replay the WAL suffix through
        the normal mutation path (no re-append).  Subscriptions registered
        BEFORE calling this re-evaluate during replay exactly as the
        pre-crash session did: ticks resume from the checkpointed progress,
        and events a consumer already processed are deduplicated by
        (subscription, tick) via :meth:`Subscription.seek`: together,
        exactly-once delivery.

        On a mesh session every rank restores its rows and replays the same
        suffix of the shared log through ``distributed_ingest``; the report
        is the same on every rank."""
        if self._wal is None:
            raise ValueError("open the session with wal_dir= to recover")
        restored_step = None
        after_seq = 0
        if self._ckpt is not None:
            try:
                restored_step = self.restore(step)
                after_seq = int(self._last_restore_meta.get("wal_seq", 0))
            except FileNotFoundError:
                restored_step = None  # genesis replay over the empty summary
        if self._mesh is not None:
            self._check_shared_log(after_seq)
        self._replaying = True
        replayed = 0
        try:
            for mut in self._wal.replay(after_seq=after_seq):
                if isinstance(mut, EdgeMutation):
                    self._ingest_encoded(mut.src, mut.dst, mut.weights, mut.timestamps, mut.source_key)
                elif isinstance(mut, AdvanceMutation):
                    self.advance_window()
                else:  # MergeMutation: state entered outside this log
                    raise RuntimeError(
                        f"WAL suffix crosses a merge barrier (seq {mut.seq}): "
                        f"the merged-in summary never went through this log. "
                        f"checkpoint() immediately after merge() so recovery "
                        f"never needs to replay past it"
                    )
                replayed += 1
        finally:
            self._replaying = False
        self.flush()
        if self._mesh is not None:
            # No rank appends again before every rank has read the log.
            self._mesh.barrier()
        return RecoveryReport(
            step=restored_step,
            mutations_replayed=replayed,
            epoch=self._epoch,
            wal_seq=self._wal_seq,
        )

    def summary(self) -> Dict[str, float]:
        """Flushed session stats — the only honest read of ingest throughput
        while batches are in flight."""
        self.flush()
        out = self.stats.summary()
        out["events_dropped"] = self.events_dropped
        if self._tracker is not None:
            out["watermark"] = self._tracker.watermark
            out["late_dropped"] = self._tracker.late_dropped
            out["late_retracted"] = self._tracker.late_retracted
        return out
