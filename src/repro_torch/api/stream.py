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
the incremental closure refresh needs no host pass over the keys.

Not ported yet, and raising ``NotImplementedError`` naming their ROADMAP
item: sliding windows (``window_slices``, A4), the WAL and event time
(``wal_dir``, ``slice_width``, ``max_lateness``), checkpoints
(``checkpoint_dir``, ``checkpoint``, ``restore``, ``recover``; all A7) and
the distributed plane (``mesh``, A9).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api.codec import encode_labels
from repro_torch.api.planner import execute
from repro_torch.api.query import (
    ErrorBound,
    Query,
    QueryBatch,
    QueryResult,
    error_bound_for,
    validate_theta,
)
from repro_torch.api.subscription import DEFAULT_MAX_PENDING, Subscription, SubscriptionEvent
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
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.stream.events import EventFeed

# Session-wide event feed bound (per-subscription queues have their own).
EVENT_LOG_MAXLEN = 4096


@dataclasses.dataclass
class StreamStats:
    """Session counters (ingest/query throughput, closure refreshes,
    subscription ticks).  Times are host wall-clock seconds."""

    edges_ingested: int = 0
    ingest_s: float = 0.0
    queries_served: int = 0
    query_s: float = 0.0
    closure_refreshes: int = 0
    closure_incremental_refreshes: int = 0
    subscription_ticks: int = 0

    def summary(self) -> Dict[str, float]:
        return {
            "edges_ingested": self.edges_ingested,
            "ingest_edges_per_s": self.edges_ingested / max(self.ingest_s, 1e-9),
            "queries_served": self.queries_served,
            "queries_per_s": self.queries_served / max(self.query_s, 1e-9),
            "closure_refreshes": self.closure_refreshes,
            "closure_incremental_refreshes": self.closure_incremental_refreshes,
            "subscription_ticks": self.subscription_ticks,
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
    negative weights).  ``touched_keys`` is ``None`` for those receipts."""

    epoch: int
    n_edges: int
    touched_keys: Optional[np.ndarray]
    touched_rows: Optional[torch.Tensor] = None


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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


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
        sketch: Optional[GLavaSketch] = None,
        window_slices: Optional[int] = None,
        ingest_backend: str = "auto",
        query_backend: str = "auto",
        checkpoint_dir: Optional[str] = None,
        mesh=None,
        double_buffer: bool = True,
        max_inflight: int = 2,
        preagg: str = "auto",
        wal_dir: Optional[str] = None,
        slice_width: Optional[float] = None,
        max_lateness: Optional[float] = None,
        events_policy: str = "drop_oldest",
    ):
        if window_slices:
            raise _not_ported("window_slices (sliding-window sessions)", "A4")
        if wal_dir is not None:
            raise _not_ported("wal_dir (write-ahead log)", "A7")
        if slice_width is not None or max_lateness is not None:
            raise _not_ported("slice_width/max_lateness (event time)", "A7")
        if checkpoint_dir is not None:
            raise _not_ported("checkpoint_dir (checkpoints)", "A7")
        if mesh is not None:
            raise _not_ported("mesh (distributed sessions)", "A9")
        if device is None and sketch is not None:
            device = sketch.device
        self.device = resolve_device(device)
        if sketch is not None:
            if sketch.config != config:
                raise ValueError(f"sketch config {sketch.config} != session config {config}")
            # The session mutates its summary in place: take a private copy.
            self._sketch = sketch.to(self.device)
        else:
            self._sketch = GLavaSketch.empty(config, seed, self.device)
        self.config = config
        # "fused" is a session-level mode, not an IngestEngine backend: the
        # one-pass kernel updates counters, registers and the touched-row
        # bitmap together.
        self._fused = ingest_backend == "fused"
        self.ingest_backend = (
            "fused" if self._fused else resolve_backend(ingest_backend, self.device)
        )
        self._preagg = preagg
        self.engine = QueryEngine(query_backend)
        self.stats = StreamStats()
        self._epoch = 0
        # Standing-query plane: registered subscriptions, the session-wide
        # event feed, and the touched-key accumulator feeding the
        # incremental closure refresh (None = "not additions-only since the
        # last closure sync; full rebuild required"): key arrays, or for a
        # fused session one device bitmap, the OR of its batches' bitmaps.
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

    # -- construction ---------------------------------------------------------

    @classmethod
    def open(
        cls,
        config: Union[SketchConfig, str, None] = None,
        *,
        epsilon: Optional[float] = None,
        delta: Optional[float] = None,
        sketch: Optional[GLavaSketch] = None,
        **kwargs,
    ) -> "GraphStream":
        """Open a session from a :class:`SketchConfig`, a preset name
        ("smoke" / "base" / "web" / "nonsquare"), a target (ε, δ) pair sized
        per paper Thm 1 / Lemma 5.2, or an existing ``sketch`` (for example
        one converted from the reference by ``repro_torch.convert``).
        Remaining kwargs go to the constructor (seed, device,
        ingest_backend, query_backend, ...).  The device defaults to CUDA."""
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

    # -- state ---------------------------------------------------------------

    @property
    def epoch(self) -> int:
        """Mutation counter; tags the engine's closure cache."""
        return self._epoch

    @property
    def events_dropped(self) -> int:
        """Session-feed events lost to the overflow policy (monotone)."""
        return self._event_log.dropped

    @property
    def sketch(self) -> GLavaSketch:
        """A SNAPSHOT of the summary: a copy that later ingests do not touch."""
        self.flush()
        return self._sketch.clone()

    def _live(self) -> GLavaSketch:
        return self._sketch

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
        while len(self._inflight) > self._max_inflight:
            self._inflight.popleft().synchronize()

    def ingest(self, src, dst, weights=None) -> IngestReceipt:
        """Fold one edge batch into the summary.  ``src``/``dst`` are label
        batches (str or int, encoded here by the key codec).  Returns as
        soon as the batch is launched — UNLESS a subscription comes due on
        this mutation, in which case the standing queries re-evaluate
        before returning."""
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
        t0 = time.time()
        additive = not bool(np.any(w_np < 0))
        # Heavy-tail fast path: collapse duplicate (src, dst) pairs on the
        # host, so the device scatters one slot per distinct pair and the
        # flow registers one slot per distinct endpoint.  Exact for signed
        # weights.
        pre = None
        if resolve_preagg(self._preagg, batch=n_edges):
            pre = preaggregate_host(s_np, d_np, w_np)
        # Only pay the host-side unique scan while a touched-key delta can
        # still be consumed; the collapsed batch gives the unique sources
        # for free.  Fused sessions skip all of this: their delta is the
        # kernel's device bitmap.
        touched = None
        if self._touched is not None and additive and not self._fused:
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
        if self._fused:
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
        elif pre is not None:
            # Arrays are padded to power-of-two buckets (zero weights are the
            # identity), so batch shapes stay on a short ladder.
            self._sketch.update_preaggregated_(
                *(self._tensor(pad_bucket(x)) for x in (
                    pre.src, pre.dst, pre.weights,
                    pre.src_unique, pre.src_totals, pre.dst_unique, pre.dst_totals,
                )),
                backend=self.ingest_backend,
            )
        else:
            self._sketch.update_(
                self._tensor(s_np), self._tensor(d_np), self._tensor(w_np),
                backend=self.ingest_backend,
            )
        self._mark_inflight()
        self.stats.edges_ingested += n_edges
        self.stats.ingest_s += time.time() - t0
        self._epoch += 1
        self._note_touched(touched_rows if self._fused else touched)
        receipt = IngestReceipt(
            epoch=self._epoch, n_edges=n_edges, touched_keys=touched, touched_rows=touched_rows
        )
        self._after_mutation()
        return receipt

    def delete(self, src, dst, weights=None) -> IngestReceipt:
        """Turnstile deletion: negative-weight ingest (paper Section 6.1.1).
        Not additions-only, so the receipt's touched set is ``None`` and any
        cached reachability closure rebuilds from scratch on next use."""
        if weights is None:
            weights = np.ones(len(np.atleast_1d(np.asarray(src))), np.float32)
        return self.ingest(src, dst, -np.asarray(weights))

    def flush(self) -> None:
        """Block until every launched ingest batch has landed on the device."""
        if not self._inflight:
            return
        t0 = time.time()
        while self._inflight:
            self._inflight.popleft().synchronize()
        self.stats.ingest_s += time.time() - t0

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
        t0 = time.time()
        if any(q.family == "reach" for q in batch):
            # Sync the closure cache from the touched-key delta so one-shot
            # reach pulls ride the same incremental refresh as subscriptions.
            self._ensure_closure()
        results = execute(self.engine, self._live(), batch, epoch=self._epoch)
        self.stats.query_s += time.time() - t0
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
        after every ``every``-th mutation (ingest / delete / merge), emitting
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
        bitmap (fused sessions).  ``None`` (non-additive batch) or
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
        self.flush()
        t0 = time.time()
        if any(s.plan.has_reach for s in due):
            self._ensure_closure()
        sketch = self._live()
        now = time.time()
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
            sub._deliver(event)
            self._event_log.push(event)
            self.stats.subscription_ticks += 1
            self._count_served(results)
        self.stats.query_s += time.time() - t0
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
        self.flush()
        return queries_mod.sketch_pagerank(self._live(), damping, iters).cpu().numpy()

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

    def merge(self, other: "GraphStream") -> "GraphStream":
        """Merge another session's summary into this one (linearity; the
        paper's distributed merge-by-add).  Both must share a hash family.
        The merged summary is a new tensor: neither operand is aliased."""
        self.flush()
        other.flush()
        if not self._sketch.same_family(other._sketch):
            raise ValueError(
                "cannot merge sketches with different hash families "
                "(open both sessions with the same config and seed)"
            )
        self._sketch = self._sketch.merge(other._sketch)
        self.stats.edges_ingested += other.stats.edges_ingested
        self._epoch += 1
        self._note_touched(None)  # foreign rows everywhere: full rebuild
        self._after_mutation()
        return self

    def checkpoint(self, step: Optional[int] = None) -> int:
        raise _not_ported("checkpoint()", "A7")

    def restore(self, step: Optional[int] = None) -> int:
        raise _not_ported("restore()", "A7")

    def recover(self, step: Optional[int] = None):
        raise _not_ported("recover()", "A7")

    def summary(self) -> Dict[str, float]:
        """Flushed session stats — the only honest read of ingest throughput
        while batches are in flight."""
        self.flush()
        out = self.stats.summary()
        out["events_dropped"] = self.events_dropped
        return out

