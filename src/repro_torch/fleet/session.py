"""SketchFleet — the multi-tenant session plane over the stacked engines.

Port of ``src/repro/fleet/session.py``.  One fleet serves T tenants through
the ``GraphStream`` API, per tenant::

    fleet = SketchFleet.open("smoke", capacity=64, seed=0)   # CUDA by default
    fleet.tenant("acme").ingest(src, dst)
    fleet.tenant("acme").subscribe(Query.reach("a", "b"), every=4)
    res = fleet.tenant("acme").query(Query.edge("a", "b"))

    # the fleet hot path: one mixed arrival stream, ONE device dispatch
    fleet.ingest_mixed(tenant_ids, src, dst, weights)

The fleet runs on ``device`` (CUDA unless ``"cpu"`` is given; a missing card
raises).  ``ingest_backend`` and ``query_backend`` mean what they mean on
``GraphStream``: ``auto`` is the stacked ingest kernel and the closure
kernel on the card, their plain versions on the CPU; ``scatter`` and
``torch`` force the plain versions on the card too.

Residency: tenants occupy *slots* in the stacked ``FleetSketch``; an LRU of
resident tenants (touched on every ``tenant()`` access) evicts the coldest
tenant to a host-side checkpoint shard (one ``CheckpointManager`` directory
per tenant, ``tenants/<name>/``, ``keep=1``, the reference's on-disk layout
and file format) when a new tenant needs a slot, and faults it back in on
next touch.  Host-side session state — epoch, stats, standing subscriptions,
touched-key deltas — lives in the persistent :class:`TenantSession`, so
subscriptions survive eviction.  Every slot occupancy change drops the
slot's cached closure (``FleetQueryEngine.drop_closure``).

Durability: ``wal_dir=`` gives each tenant its own WAL lane
(``<wal_dir>/<name>/``, with a ``tenant.json`` naming the id), byte-identical
to the reference's, appended before the dispatch; :meth:`SketchFleet.recover`
re-opens every lane's tenant from disk, faults in its newest shard and
replays the lane's suffix.

Bit-identity: a fleet opened with seed s gives every tenant the hash family
of ``GraphStream(config, seed=s)``, ingest preserves per-tenant arrival order
(stable segment grouping), and queries gather per tenant, so each tenant is
bit-identical to an independent session fed its sub-stream.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import shutil
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.api.codec import encode_labels
from repro_torch.api.planner import execute
from repro_torch.api.query import Query, QueryBatch, QueryResult, validate_theta
from repro_torch.api.stream import EVENT_LOG_MAXLEN, IngestReceipt, RecoveryReport, StreamStats, _preset
from repro_torch.api.subscription import DEFAULT_MAX_PENDING, Subscription, SubscriptionEvent, sub_progress_key
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.hashing import fnv1a_label, keys_to_tensor
from repro_torch.core.ingest import resolve_backend, touched_row_keys
from repro_torch.core.sketch import GLavaSketch, SketchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.ingest import FleetIngestEngine, group_stream
from repro_torch.fleet.query import FleetQueryEngine
from repro_torch.fleet.stack import FleetSketch
from repro_torch.stream.events import EventFeed
from repro_torch.stream.wal import AdvanceMutation, EdgeMutation, MergeMutation, WriteAheadLog


def _tenant_dirname(tenant_id) -> str:
    """Filesystem-safe, collision-safe directory name for one tenant: a
    sanitized prefix of the id for operators plus its FNV-1a hash, so distinct
    ids that sanitize alike never share a shard or WAL directory."""
    safe = "".join(ch if ch.isalnum() or ch in "._-" else "_" for ch in str(tenant_id)[:40])
    return f"{safe}-{fnv1a_label(tenant_id):08x}"


@dataclasses.dataclass
class FleetStats:
    """Fleet-wide counters (per-tenant counters live on each session).
    ``ingest_s`` runs from a mixed batch's entry, codec included, to its
    launch, plus every flush's wait (host seconds,
    :func:`repro_torch.telemetry.now_ns`)."""

    edges_ingested: int = 0
    batches: int = 0
    ingest_s: float = 0.0
    subscription_ticks: int = 0
    evictions: int = 0
    fault_ins: int = 0

    def summary(self) -> Dict[str, float]:
        """The counters and ``ingest_edges_per_s``: edges over ``ingest_s``,
        the host's dispatch time alone (not the ticks, not the device's
        work), so not a rate the fleet sustains."""
        return {
            "edges_ingested": self.edges_ingested,
            "batches": self.batches,
            "ingest_edges_per_s": self.edges_ingested / max(self.ingest_s, 1e-9),
            "subscription_ticks": self.subscription_ticks,
            "evictions": self.evictions,
            "fault_ins": self.fault_ins,
        }


class _TenantEngineView:
    """A ``QueryEngine``-shaped adapter for one tenant: prepends the tenant's
    slot lane to every fleet engine dispatch, so the planner's
    :class:`~repro_torch.api.planner.CompiledPlan` (and so subscriptions)
    runs against the fleet unchanged."""

    def __init__(self, session: "TenantSession"):
        self._session = session

    def _slots(self, n: int) -> torch.Tensor:
        return torch.full((int(n),), self._session._slot, dtype=torch.int64, device=self._session.device)

    def _engine(self) -> FleetQueryEngine:
        return self._session._fleet.engine

    def edge(self, state, src, dst):
        return self._engine().edge(state, self._slots(src.shape[0]), src, dst)

    def in_flow(self, state, keys):
        return self._engine().in_flow(state, self._slots(keys.shape[0]), keys)

    def out_flow(self, state, keys):
        return self._engine().out_flow(state, self._slots(keys.shape[0]), keys)

    def flow(self, state, keys):
        return self._engine().flow(state, self._slots(keys.shape[0]), keys)

    def heavy_rel_vec(self, state, keys, thetas):
        return self._engine().heavy_rel_vec(state, self._slots(keys.shape[0]), keys, thetas)

    def subgraph_batch(self, state, src, dst, mask):
        return self._engine().subgraph_batch(state, self._slots(src.shape[0]), src, dst, mask)

    def reach(self, state, src, dst, epoch=None):
        sess = self._session
        slots = np.full(int(src.shape[0]), sess._slot, np.int64)
        return self._engine().reach(
            state, slots, src, dst, epochs={sess._slot: sess._epoch if epoch is None else epoch}
        )


class TenantSession:
    """One tenant's ``GraphStream``-shaped handle into the fleet.

    The session object persists across evictions: device state moves between
    its fleet slot and a host checkpoint shard, while epoch, stats,
    subscriptions and the touched-key delta stay here."""

    def __init__(self, fleet: "SketchFleet", tenant_id):
        self._fleet = fleet
        self.tenant_id = tenant_id
        self._slot: Optional[int] = None
        self._shard_step: Optional[int] = None
        self._epoch = 0
        self._subs: Dict[int, Subscription] = {}
        self._next_sub_id = 0
        self._event_log = EventFeed(EVENT_LOG_MAXLEN, fleet._events_policy)
        self._touched: Optional[list] = []
        self._touched_count = 0
        self._closed = False
        self.stats = StreamStats()
        self._view = _TenantEngineView(self)

    # -- state ----------------------------------------------------------------

    @property
    def config(self) -> SketchConfig:
        return self._fleet.config

    @property
    def device(self) -> torch.device:
        return self._fleet.device

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def resident(self) -> bool:
        return self._slot is not None

    @property
    def sketch(self) -> GLavaSketch:
        """A SNAPSHOT of this tenant's window-summed summary as a plain
        ``GLavaSketch`` (a copy that later ingests do not touch)."""
        self._touch()
        self._fleet.flush()
        return self._fleet._state.tenant_sketch(self._slot).clone()

    def _touch(self) -> "TenantSession":
        self._check_open()
        self._fleet.tenant(self.tenant_id)
        return self

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError(f"tenant session {self.tenant_id!r} is closed")

    # -- ingest ---------------------------------------------------------------

    def ingest(self, src, dst, weights=None, *, timestamps=None) -> IngestReceipt:
        """Fold one edge batch into THIS tenant's summary: the fleet's
        mixed-stream hot path with a constant tenant lane."""
        receipts = self._fleet.ingest_mixed(self.tenant_id, src, dst, weights, timestamps=timestamps)
        return receipts[self.tenant_id]

    def delete(self, src, dst, weights=None, *, timestamps=None) -> IngestReceipt:
        """Turnstile deletion (negative-weight ingest) for this tenant."""
        if weights is None:
            weights = np.ones(len(np.atleast_1d(np.asarray(src))), np.float32)
        return self.ingest(src, dst, -np.asarray(weights), timestamps=timestamps)

    def flush(self) -> None:
        self._fleet.flush()

    def advance_window(self) -> None:
        """Advance THIS tenant's sliding window (no-op for non-windowed
        fleets).  A mutation for this tenant's subscriptions; expiry is not
        additions-only, so the slot's next closure use rebuilds."""
        if self._fleet._window_slices <= 1:
            return
        self._touch()
        fleet = self._fleet
        if fleet._wal_dir is not None and not fleet._replaying:
            fleet._wal_lane(self.tenant_id).append_advance()
        fleet.flush()
        fleet._state.advance_(self._slot)
        self._epoch += 1
        self._note_touched(None)
        fleet._tick_subscriptions([self])

    # -- queries --------------------------------------------------------------

    def query(self, *queries) -> Union[QueryResult, List[QueryResult]]:
        """Answer queries against this tenant's live summary: the planner and
        semantics of ``GraphStream.query``, dispatched fleet-wide."""
        single = len(queries) == 1 and isinstance(queries[0], Query)
        if len(queries) == 1 and isinstance(queries[0], QueryBatch):
            batch = queries[0]
        else:
            batch = QueryBatch(queries)
        if len(batch) == 0:
            return []
        self._touch()
        fleet = self._fleet
        fleet.flush()
        t0 = telemetry.now_ns()
        if any(q.family == "reach" for q in batch):
            fleet.engine.refresh_closures(fleet._state, [(self._slot, self._consume_touched(), self._epoch)])
        results = execute(self._view, fleet._state, batch, epoch=self._epoch)
        self.stats.query_s += (telemetry.now_ns() - t0) / 1e9
        self._count_served(results)
        return results[0] if single else results

    # convenience wrappers (the serving engine's per-family endpoints)
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

    # -- standing queries ------------------------------------------------------

    def subscribe(
        self,
        *queries,
        every: int = 1,
        on_result: Optional[Callable[[SubscriptionEvent], None]] = None,
        alarm: Optional[Callable[[List[QueryResult]], bool]] = None,
        name: Optional[str] = None,
        max_pending: int = DEFAULT_MAX_PENDING,
    ) -> Subscription:
        """Register a standing query batch on THIS tenant: compiled once,
        re-evaluated after every ``every``-th of this tenant's mutations
        (mutations of other tenants do not tick it)."""
        self._check_open()
        if len(queries) == 1 and isinstance(queries[0], QueryBatch):
            batch = queries[0]
        else:
            batch = QueryBatch(queries)
        for q in batch:
            if q.family == "heavy":
                validate_theta(q.theta)
        sub = Subscription(
            self, self._next_sub_id, batch, every=every, on_result=on_result, alarm=alarm, name=name,
            max_pending=max_pending,
        )
        self._next_sub_id += 1
        self._subs[sub.id] = sub
        return sub

    @property
    def subscriptions(self) -> Tuple[Subscription, ...]:
        return tuple(self._subs.values())

    def events(self) -> Iterator[SubscriptionEvent]:
        """Drain this tenant's event feed (non-blocking)."""
        while self._event_log:
            yield self._event_log.popleft()

    @property
    def events_dropped(self) -> int:
        """Events lost from this tenant's feed to queue overflow."""
        return self._event_log.dropped

    def _unsubscribe(self, sub: Subscription) -> None:
        self._subs.pop(sub.id, None)
        if sub.plan.has_reach and self._slot is not None:
            # The cancelled plan may be the only consumer of this slot's
            # cached closure; epochs restart per slot occupant, so a
            # surviving entry could serve a LATER occupant whose epoch
            # collides.  Drop it now (the stale-closure fix).
            self._fleet.engine.drop_closure(self._slot)

    # -- touched-key tracking (as GraphStream) ----------------------------------

    def _note_touched(self, batch_delta) -> None:
        if self._touched is None:
            return
        if batch_delta is None:
            self._touched = None
            self._touched_count = 0
            return
        self._touched.append(batch_delta)
        self._touched_count += int(batch_delta.size)
        if self._touched_count > self.config.width_rows:
            self._touched = None
            self._touched_count = 0

    def _consume_touched(self) -> Optional[np.ndarray]:
        """The unique touched-key delta accumulated since the last closure
        sync (``None`` = unknown / not additions-only); resets tracking."""
        if self._touched is None:
            delta = None
        elif not self._touched:
            delta = np.zeros(0, np.uint32)
        else:
            delta = np.unique(np.concatenate(self._touched)).astype(np.uint32)
        self._touched = []
        self._touched_count = 0
        return delta

    def _count_served(self, results) -> None:
        for r in results:
            v = r.value
            self.stats.queries_served += int(np.size(v[0])) if isinstance(v, tuple) else int(np.size(v))

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        """Cancel subscriptions, release the slot, and forget the session.
        Idempotent; the tenant id can be re-opened as a fresh tenant."""
        if self._closed:
            return
        for sub in list(self._subs.values()):
            sub.cancel()
        fleet = self._fleet
        if fleet._wal_dir is not None:
            # Forgetting the tenant forgets its durable log too: a kept lane
            # would resurrect this tenant (or pollute a fresh one under the
            # same id) on the next recover().
            lane = fleet._wal_lanes.pop(self.tenant_id, None)
            if lane is not None:
                lane.close()
            if isinstance(self.tenant_id, (str, int, np.integer)):
                shutil.rmtree(Path(fleet._wal_dir) / _tenant_dirname(self.tenant_id), ignore_errors=True)
        if self._slot is not None:
            fleet.flush()
            fleet.engine.drop_closure(self._slot)
            fleet._state.clear_tenant_(self._slot)
            fleet._free.append(self._slot)
            fleet._resident.pop(self.tenant_id, None)
            self._slot = None
        fleet._sessions.pop(self.tenant_id, None)
        self._closed = True

    def summary(self) -> Dict[str, float]:
        self._fleet.flush()
        return self.stats.summary()


class SketchFleet:
    """T tenant sessions behind one stacked device state and one engine pair."""

    def __init__(
        self,
        config: SketchConfig,
        *,
        capacity: int = 8,
        seed: int = 0,
        window_slices: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        max_inflight: int = 2,
        pad_q: Optional[int] = None,
        wal_dir: Optional[str] = None,
        wal_fsync_every: int = 1,
        events_policy: str = "drop_oldest",
        device: DeviceLike = None,
        ingest_backend: str = "auto",
        query_backend: str = "auto",
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if window_slices is not None and window_slices < 2:
            raise ValueError("window_slices must be >= 2 (or None)")
        self.device = resolve_device(device)
        resolve_backend(ingest_backend, self.device)  # an unknown name raises here
        self.config = config
        self.capacity = capacity
        self.seed = seed
        self._window_slices = window_slices or 1
        self._state = FleetSketch.empty(config, capacity, seed, self._window_slices, self.device)
        self._ingest = FleetIngestEngine(ingest_backend, max_inflight)
        self.engine = (
            FleetQueryEngine(query_backend) if pad_q is None else FleetQueryEngine(query_backend, pad_q=pad_q)
        )
        self._sessions: Dict = {}
        self._resident: "collections.OrderedDict" = collections.OrderedDict()
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._ckpt_dir = checkpoint_dir
        self._events_policy = events_policy
        self._event_log = EventFeed(EVENT_LOG_MAXLEN, events_policy)
        self._wal_dir = wal_dir
        self._wal_fsync_every = int(wal_fsync_every)
        self._wal_lanes: Dict = {}
        self._replaying = False
        self.stats = FleetStats()

    @classmethod
    def open(
        cls,
        config: Union[SketchConfig, str, None] = None,
        *,
        epsilon: Optional[float] = None,
        delta: Optional[float] = None,
        **kwargs,
    ) -> "SketchFleet":
        """Open a fleet from a :class:`SketchConfig`, a preset name, or a
        target (ε, δ) pair — the same resolution as ``GraphStream.open``."""
        if isinstance(config, str):
            config = _preset(config)
        elif config is None:
            if epsilon is None or delta is None:
                raise ValueError("open() needs a config, a preset, or (epsilon, delta)")
            config = SketchConfig.for_error(epsilon, delta)
        elif not isinstance(config, SketchConfig):
            raise TypeError(f"config must be SketchConfig or preset name, got {config!r}")
        return cls(config, **kwargs)

    # -- residency / LRU -------------------------------------------------------

    def tenant(self, tenant_id) -> TenantSession:
        """This tenant's session: created on first touch, admitted to a slot
        (possibly evicting the coldest resident), LRU-bumped on every access."""
        sess = self._sessions.get(tenant_id)
        if sess is None:
            sess = TenantSession(self, tenant_id)
            self._sessions[tenant_id] = sess
        if sess._slot is None:
            self._admit(sess)
        else:
            self._resident.move_to_end(tenant_id)
        return sess

    @property
    def tenants(self) -> Tuple:
        """All known tenant ids (resident or evicted)."""
        return tuple(self._sessions)

    @property
    def resident_tenants(self) -> Tuple:
        """Resident tenant ids, coldest first."""
        return tuple(self._resident)

    def events(self) -> Iterator[SubscriptionEvent]:
        """Drain the fleet-wide event feed (all tenants, emission order)."""
        while self._event_log:
            yield self._event_log.popleft()

    @property
    def events_dropped(self) -> int:
        """Events lost from the fleet-wide feed to queue overflow."""
        return self._event_log.dropped

    def _admit(self, sess: TenantSession) -> None:
        slot = self._free.pop() if self._free else self._evict_coldest()
        sess._slot = slot
        self._resident[sess.tenant_id] = sess
        # Occupancy change: never let this occupant see a predecessor's
        # closure at a colliding epoch.
        self.engine.drop_closure(slot)
        if sess._shard_step is not None:
            self._restore_shard(sess)
            self.stats.fault_ins += 1

    def _evict_coldest(self) -> int:
        if self._ckpt_dir is None:
            raise ValueError(
                f"fleet is at capacity ({self.capacity} resident tenants); open the fleet with "
                "checkpoint_dir= to evict cold tenants to host shards"
            )
        tenant_id, sess = next(iter(self._resident.items()))
        self.flush()
        mgr = self._shard_manager(tenant_id)
        meta = {"epoch": sess._epoch, "edges_ingested": sess.stats.edges_ingested}
        lane = None
        if self._wal_dir is not None:
            # Valid even mid-recovery: an evictable tenant has fully replayed,
            # so its state reflects everything in its lane.
            lane = self._wal_lane(tenant_id)
            lane.sync()
            meta["wal_seq"] = lane.last_seq
        if sess._subs:
            meta["subs"] = {
                sub_progress_key(sub): {"ticks": sub.ticks, "pending": sub._mutations_pending}
                for sub in sess._subs.values()
                if sub.active
            }
        mgr.save(sess._epoch, self._state.tenant_shard(sess._slot), metadata=meta)
        sess._shard_step = sess._epoch
        if lane is not None:
            # The shard is durable: records at or below its wal_seq are
            # covered, so rotate and drop fully covered segments (keep=1:
            # this shard is the only restore point).
            lane.rotate()
            lane.gc(int(meta["wal_seq"]))
        slot = sess._slot
        self._state.clear_tenant_(slot)
        self.engine.drop_closure(slot)
        sess._slot = None
        # The accumulated delta describes a closure that no longer exists;
        # fault-in restarts from "unknown", so the next reach rebuilds.
        sess._touched = None
        sess._touched_count = 0
        del self._resident[tenant_id]
        self.stats.evictions += 1
        return slot

    def _restore_shard(self, sess: TenantSession) -> None:
        """Read the tenant's shard on the host (zero-stride ``like`` leaves
        allocate nothing) and copy it into its slot."""
        mgr = self._shard_manager(sess.tenant_id)
        st = self._state

        def like(t: torch.Tensor) -> torch.Tensor:
            return torch.zeros((), dtype=t.dtype).expand(t.shape[1:])

        shard, meta = mgr.restore(
            sess._shard_step,
            like={name: like(getattr(st, name)) for name in ("counters", "row_flows", "col_flows", "cursor")},
        )
        st.load_tenant_(sess._slot, shard)
        sess._epoch = int(meta.get("epoch", meta["step"]))

    def _shard_manager(self, tenant_id) -> CheckpointManager:
        return CheckpointManager(Path(self._ckpt_dir) / "tenants" / _tenant_dirname(tenant_id), keep=1)

    # -- per-tenant WAL lanes --------------------------------------------------

    def _wal_lane(self, tenant_id) -> WriteAheadLog:
        """This tenant's write-ahead-log lane (opened lazily).  Lane
        directories are keyed by the collision-safe name the eviction shards
        use; ``tenant.json`` records the original id, so :meth:`recover` can
        re-open sessions from disk alone."""
        lane = self._wal_lanes.get(tenant_id)
        if lane is None:
            if not isinstance(tenant_id, (str, int, np.integer)):
                raise TypeError(
                    "WAL lanes need str/int tenant ids (stored in tenant.json for recovery), got "
                    f"{type(tenant_id).__name__}"
                )
            lane_dir = Path(self._wal_dir) / _tenant_dirname(tenant_id)
            lane = WriteAheadLog(lane_dir, fsync_every=self._wal_fsync_every)
            ident = lane_dir / "tenant.json"
            if not ident.exists():
                ident.write_text(json.dumps({"tenant_id": tenant_id}))
            self._wal_lanes[tenant_id] = lane
        return lane

    def _wal_append(self, sess, s_np, d_np, w_np, ts_np) -> Optional[int]:
        """Durably log one tenant's slice of an arrival batch BEFORE its device
        dispatch; returns the commit seq (None when the WAL is off or this
        ingest is itself a replay)."""
        if self._wal_dir is None or self._replaying:
            return None
        return self._wal_lane(sess.tenant_id).append_edges(s_np, d_np, w_np, timestamps=ts_np)

    def recover(self) -> Dict:
        """Crash recovery for a freshly opened fleet (requires ``wal_dir``):
        for every WAL lane on disk, re-open its tenant (``tenant.json`` names
        the id), fault in the newest eviction shard if one exists, and replay
        the lane's suffix — records past the shard's durable ``wal_seq`` —
        through the normal mixed-ingest path.

        Re-register standing subscriptions BEFORE calling this (matched by
        name, or registration order for anonymous ones) and ``seek()`` each
        to its last consumed tick, so the replayed event stream deduplicates
        exactly-once.  Returns ``{tenant_id: RecoveryReport}``."""
        if self._wal_dir is None:
            raise ValueError("recover() requires wal_dir=")
        root = Path(self._wal_dir)
        reports: Dict = {}
        lane_dirs = sorted(root.iterdir()) if root.exists() else []
        for lane_dir in lane_dirs:
            ident = lane_dir / "tenant.json"
            if not ident.exists():
                continue
            tenant_id = json.loads(ident.read_text())["tenant_id"]
            after_seq = 0
            step = None
            shard_meta: Dict = {}
            if self._ckpt_dir is not None:
                mgr = self._shard_manager(tenant_id)
                step = mgr.latest_step()
                if step is not None:
                    shard_meta = mgr.read_metadata(step)
                    after_seq = int(shard_meta.get("wal_seq", 0))
                    sess = self._sessions.get(tenant_id)
                    if sess is None:
                        sess = TenantSession(self, tenant_id)
                        self._sessions[tenant_id] = sess
                    if sess._slot is None:
                        # Fault the shard in through the normal admission
                        # path instead of replaying from genesis.
                        sess._shard_step = step
            sess = self.tenant(tenant_id)
            subs_meta = shard_meta.get("subs") or {}
            for sub in sess._subs.values():
                m = subs_meta.get(sub_progress_key(sub))
                if m is not None:
                    sub.ticks = int(m["ticks"])
                    sub._mutations_pending = int(m["pending"])
            lane = self._wal_lane(tenant_id)
            replayed = 0
            self._replaying = True
            try:
                for mut in lane.replay(after_seq=after_seq):
                    if isinstance(mut, EdgeMutation):
                        self.ingest_mixed(tenant_id, mut.src, mut.dst, mut.weights, timestamps=mut.timestamps)
                    elif isinstance(mut, AdvanceMutation):
                        sess.advance_window()
                    elif isinstance(mut, MergeMutation):
                        raise RuntimeError(
                            "WAL contains a merge barrier past the last eviction shard — merged state "
                            "cannot be replayed from edge records; evict or checkpoint tenants "
                            "immediately after merging"
                        )
                    replayed += 1
            finally:
                self._replaying = False
            reports[tenant_id] = RecoveryReport(
                step=step, mutations_replayed=replayed, epoch=sess._epoch, wal_seq=lane.last_seq
            )
        self.flush()
        return reports

    # -- the fleet hot path ----------------------------------------------------

    def ingest_mixed(self, tenant_ids, src, dst, weights=None, *, timestamps=None) -> Dict:
        """Fold one MIXED arrival stream — ``(tenant_id, src, dst, weight)``
        records — into the whole fleet in ONE device dispatch (one stacked
        ingest launch on the card, two for an undirected sketch).

        ``tenant_ids`` is a single id (the whole batch is that tenant's) or a
        per-edge sequence.  The stream is segment-grouped by resident slot on
        the host (stable: per-tenant arrival order is kept) and scattered
        into the stack.  A batch spanning more distinct tenants than the
        fleet has slots is split into capacity-sized tenant groups, one
        dispatch per group, so LRU admission can never evict a tenant an
        in-flight group still routes to.  Returns ``{tenant_id:
        IngestReceipt}``.

        ``timestamps`` (optional per-edge event times) are recorded in each
        tenant's WAL lane: the fleet plane does not window by event time,
        but replay hands them back."""
        with telemetry.span("ingest") as call:
            receipts = self._ingest_mixed(tenant_ids, src, dst, weights, timestamps)
            call.tag(self.stats.batches)
        return receipts

    def _ingest_mixed(self, tenant_ids, src, dst, weights, timestamps) -> Dict:
        t0 = telemetry.now_ns()
        with telemetry.span("ingest.codec"):
            s_np = np.atleast_1d(encode_labels(src))
            d_np = np.atleast_1d(encode_labels(dst))
            if s_np.shape != d_np.shape:
                raise ValueError(f"src/dst shape mismatch: {s_np.shape} vs {d_np.shape}")
            n_edges = int(s_np.shape[0])
            w_np = np.ones(n_edges, np.float32) if weights is None else np.atleast_1d(np.asarray(weights, np.float32))
            if w_np.shape != (n_edges,):
                raise ValueError(f"weights/src shape mismatch: {w_np.shape} vs {(n_edges,)}")
            ts_np = None
            if timestamps is not None:
                ts_np = np.atleast_1d(np.asarray(timestamps, np.float64))
                if ts_np.shape != (n_edges,):
                    raise ValueError(f"timestamps/src shape mismatch: {ts_np.shape} vs {(n_edges,)}")
                if not np.all(np.isfinite(ts_np)):
                    raise ValueError("timestamps must be finite")
            additive = weights is None or not bool(np.any(w_np < 0))

        if isinstance(tenant_ids, (str, bytes, int, np.integer)):
            with telemetry.span("ingest.route"):
                sess = self.tenant(tenant_ids)
                wal_seqs = {id(sess): self._wal_append(sess, s_np, d_np, w_np, ts_np)}
                slot_np = np.full(n_edges, sess._slot, np.int32)
            return self._dispatch_group([(sess, 0, n_edges)], slot_np, s_np, d_np, w_np, additive, t0, wal_seqs)
        with telemetry.span("ingest.route"):
            ids = np.asarray(tenant_ids)
            if ids.shape[0] != n_edges:
                raise ValueError(f"tenant_ids/src shape mismatch: {ids.shape[0]} vs {n_edges}")
            uniq_ids, inverse = np.unique(ids, return_inverse=True)
        if uniq_ids.shape[0] <= self.capacity:
            return self._route_group(uniq_ids, inverse, s_np, d_np, w_np, ts_np, additive, t0)
        # More distinct tenants than slots: admitted one at a time, this
        # batch's own tenants would evict each other before the slot lane is
        # built.  Split into groups of at most `capacity` tenants, each fully
        # admitted, routed and dispatched before the next group's admissions
        # may evict it.
        receipts: Dict = {}
        for lo in range(0, uniq_ids.shape[0], self.capacity):
            hi = min(lo + self.capacity, uniq_ids.shape[0])
            pick = (inverse >= lo) & (inverse < hi)
            receipts.update(
                self._route_group(
                    uniq_ids[lo:hi], inverse[pick] - lo, s_np[pick], d_np[pick], w_np[pick],
                    None if ts_np is None else ts_np[pick], additive, telemetry.now_ns(),
                )
            )
        return receipts

    def _route_group(self, uniq_ids, inverse, s_np, d_np, w_np, ts_np, additive, t0) -> Dict:
        """Admit one group of at most ``capacity`` distinct tenants and
        dispatch its edges.  The cap guarantees the admission loop cannot
        evict a group member once touched (every touch rewarms the LRU and at
        most ``capacity - k`` evictions remain after the k-th touch), so every
        edge routes to a live slot."""
        with telemetry.span("ingest.route"):
            sessions = [self.tenant(t) for t in uniq_ids.tolist()]
            # Log each tenant's slice in arrival order BEFORE the dispatch (and
            # before grouping permutes the arrays): the WAL is the authority on
            # what the device state may contain.
            wal_seqs: Dict[int, Optional[int]] = {}
            for k, sess in enumerate(sessions):
                mask = inverse == k
                wal_seqs[id(sess)] = self._wal_append(
                    sess, s_np[mask], d_np[mask], w_np[mask], None if ts_np is None else ts_np[mask]
                )
            slot_np = np.asarray([s._slot for s in sessions], np.int32)[inverse]
            slot_np, s_np, d_np, w_np, uniq_slots, starts, counts = group_stream(slot_np, s_np, d_np, w_np)
            by_slot = {s._slot: s for s in sessions}
            segments = [(by_slot[int(sl)], int(st), int(ct)) for sl, st, ct in zip(uniq_slots, starts, counts)]
        return self._dispatch_group(segments, slot_np, s_np, d_np, w_np, additive, t0, wal_seqs)

    def _dispatch_group(self, segments, slot_np, s_np, d_np, w_np, additive, t0, wal_seqs=None) -> Dict:
        """One grouped device dispatch and its bookkeeping (touched-key
        deltas, receipts, stats, subscription ticks)."""
        n_edges = int(s_np.shape[0])
        wal_seqs = wal_seqs or {}
        # Per-tenant touched-key deltas (each tenant's incremental closure
        # refresh), only while that tenant's tracking is live.
        deltas: Dict[int, Optional[np.ndarray]] = {}
        with telemetry.span("ingest.touched"):
            for sess, st, ct in segments:
                if not additive:
                    sess._note_touched(None)
                elif sess._touched is not None:
                    delta = touched_row_keys(
                        s_np[st : st + ct],
                        None if self.config.directed else d_np[st : st + ct],
                        cap=self.config.width_rows,
                    )
                    deltas[id(sess)] = delta
                    sess._note_touched(delta)

        dev = self.device
        with telemetry.span("ingest.copy"):
            lanes = (
                torch.from_numpy(slot_np).to(dev, non_blocking=True),
                keys_to_tensor(s_np, dev),
                keys_to_tensor(d_np, dev),
                torch.from_numpy(np.ascontiguousarray(w_np)).to(dev, non_blocking=True),
            )
        self._ingest.dispatch(self._state, *lanes)

        dt = (telemetry.now_ns() - t0) / 1e9
        receipts: Dict = {}
        for sess, st, ct in segments:
            sess._epoch += 1
            sess.stats.edges_ingested += ct
            sess.stats.ingest_s += dt / len(segments)
            receipts[sess.tenant_id] = IngestReceipt(
                epoch=sess._epoch,
                n_edges=ct,
                touched_keys=deltas.get(id(sess)) if additive else None,
                wal_seq=wal_seqs.get(id(sess)),
            )
        self.stats.edges_ingested += n_edges
        self.stats.batches += 1
        self.stats.ingest_s += dt
        self._tick_subscriptions([sess for sess, _, _ in segments])
        return receipts

    def flush(self) -> None:
        """Block until every dispatched fleet batch has landed on the device."""
        t0 = telemetry.now_ns()
        if self._ingest.flush():
            self.stats.ingest_s += (telemetry.now_ns() - t0) / 1e9

    # -- subscription ticking --------------------------------------------------

    def _tick_subscriptions(self, sessions: List[TenantSession]) -> None:
        """Re-evaluate every standing query that came due across the mutated
        tenants: reach-bearing plans share ONE batched closure sync, then
        each plan replays its compiled dispatches."""
        due: List[Tuple[TenantSession, Subscription]] = []
        for sess in sessions:
            for sub in list(sess._subs.values()):
                if sub.active and sub._note_mutation():
                    due.append((sess, sub))
        if not due:
            return
        with telemetry.span("tick"):
            with telemetry.span("tick.wait"):
                self.flush()
            t0 = telemetry.now_ns()
            reach_sessions: Dict[int, TenantSession] = {}
            for sess, sub in due:
                if sub.plan.has_reach:
                    reach_sessions.setdefault(id(sess), sess)
            if reach_sessions:
                self.engine.refresh_closures(
                    self._state,
                    [(sess._slot, sess._consume_touched(), sess._epoch) for sess in reach_sessions.values()],
                )
            # The shared closure sync is charged evenly; each subscription then
            # pays for its own replay only.
            sync_s = (telemetry.now_ns() - t0) / 1e9 / len(due)
            now = telemetry.now_ns() / 1e9
            for sess, sub in due:
                t1 = telemetry.now_ns()
                results = sub.plan.run(sess._view, self._state, epoch=sess._epoch)
                event = SubscriptionEvent(
                    subscription_id=sub.id,
                    name=sub.name,
                    tick=sub.ticks + 1,
                    epoch=sess._epoch,
                    timestamp=now,
                    results=tuple(results),
                    alarm=None if sub.alarm is None else bool(sub.alarm(results)),
                )
                if sub._deliver(event):
                    sess._event_log.push(event)
                    self._event_log.push(event)
                sess.stats.subscription_ticks += 1
                self.stats.subscription_ticks += 1
                sess._count_served(results)
                sess.stats.query_s += sync_s + (telemetry.now_ns() - t1) / 1e9

    # -- introspection ---------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        self.flush()
        out = self.stats.summary()
        out.update(
            tenants=len(self._sessions),
            resident=len(self._resident),
            capacity=self.capacity,
            events_dropped=self._event_log.dropped,
            ingest_dispatches=self._ingest.dispatches,
            closure_builds=self.engine.closure_builds,
            closure_incremental_refreshes=self.engine.closure_incremental_refreshes,
        )
        return out
