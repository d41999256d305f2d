"""gLava serving engine: the paper's data structure as an online service.

Port of ``src/repro/serve/engine.py``.  :class:`SketchServer` wraps one
:class:`repro_torch.api.GraphStream` session, which carries the summary, the
bounded in-flight ingest path, the planned and fused query path, the sliding
window, event time, the WAL and checkpoints; or, with ``tenants=N``, one
:class:`repro_torch.fleet.SketchFleet` of N resident slots.  The server adds
the service-shaped method surface (per-family endpoints a request router
binds to).

The server runs on ``device`` (CUDA by default, ``"cpu"`` to opt out).  A
session's ingest backend defaults to ``"auto"``: the ingest kernel on the
card, the plain scatter on the CPU (the reference's ``"scatter"`` default
names its paper-faithful XLA scatter; the port's ``"scatter"`` is the plain
version).  A fleet takes ``ingest_backend`` and ``query_backend`` with the
same meaning: ``auto`` is the stacked ingest kernel and the closure kernel
on the card.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

from repro_torch.api import GraphStream, Query, SketchConfig, Subscription, SubscriptionEvent
from repro_torch.device import DeviceLike
from repro_torch.fleet import SketchFleet


class SketchServer:
    def __init__(
        self,
        config: SketchConfig,
        seed: int = 0,
        window_slices: Optional[int] = None,
        ingest_backend: str = "auto",
        query_backend: str = "auto",
        double_buffer: bool = True,
        max_inflight: int = 2,
        tenants: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        wal_dir: Optional[str] = None,
        slice_width: Optional[float] = None,
        max_lateness: Optional[float] = None,
        late_policy: str = "retract",
        device: DeviceLike = None,
    ):
        """``tenants=N`` opens the server in MULTI-SESSION (fleet) mode: one
        :class:`repro_torch.fleet.SketchFleet` with N resident slots serves
        every tenant through single stacked device dispatches; per-family
        endpoints then take a required ``tenant=`` id, :meth:`tenant`
        exposes the per-tenant session surface, and :meth:`ingest_mixed` is
        the mixed-stream hot path.  ``checkpoint_dir`` enables LRU eviction
        of cold tenants to host shards (and, in single-session mode, plain
        session checkpointing).

        ``wal_dir`` makes ingest durable (write-ahead-logged before every
        device dispatch; :meth:`recover` replays the suffix after a crash).
        ``slice_width``/``max_lateness`` switch the single session to
        event-time windowing: ingest then requires per-edge ``timestamps``
        and the watermark drives window advances (the fleet records event
        times in its WAL lanes but does not window by them, so those knobs
        are single-session only)."""
        if tenants is not None:
            if slice_width is not None or max_lateness is not None:
                raise ValueError(
                    "event-time windowing (slice_width/max_lateness) is single-session only; fleet WAL "
                    "lanes record event times but tenants window by explicit advance_window()"
                )
            self.fleet: Optional[SketchFleet] = SketchFleet.open(
                config,
                capacity=tenants,
                seed=seed,
                window_slices=window_slices,
                checkpoint_dir=checkpoint_dir,
                max_inflight=max_inflight,
                wal_dir=wal_dir,
                device=device,
                ingest_backend=ingest_backend,
                query_backend=query_backend,
            )
            self.stream = None
            return
        self.fleet = None
        self.stream = GraphStream(
            config,
            seed=seed,
            device=device,
            window_slices=window_slices,
            ingest_backend=ingest_backend,
            query_backend=query_backend,
            double_buffer=double_buffer,
            max_inflight=max_inflight,
            checkpoint_dir=checkpoint_dir,
            wal_dir=wal_dir,
            slice_width=slice_width,
            max_lateness=max_lateness,
            late_policy=late_policy,
        )

    def _session(self, tenant=None):
        """The session a request addresses: the single stream, or the
        tenant's fleet session (fleet mode requires ``tenant=``)."""
        if self.fleet is None:
            if tenant is not None:
                raise ValueError("tenant= requires a fleet server (tenants=N)")
            return self.stream
        if tenant is None:
            raise ValueError(
                "this server runs in fleet mode: pass tenant= (or use .tenant(tid) / .ingest_mixed(...))"
            )
        return self.fleet.tenant(tenant)

    def _plane(self):
        """The single stream, or the fleet."""
        return self.stream if self.fleet is None else self.fleet

    # -- multi-session (fleet) surface ----------------------------------------

    def tenant(self, tenant_id):
        """The tenant's session handle (fleet mode only)."""
        if self.fleet is None:
            raise ValueError("tenant() requires a fleet server (tenants=N)")
        return self.fleet.tenant(tenant_id)

    def ingest_mixed(self, tenant_ids, src, dst, weights=None, *, timestamps=None):
        """One mixed multi-tenant arrival batch -> one device dispatch (fleet
        mode only)."""
        if self.fleet is None:
            raise ValueError("ingest_mixed() requires a fleet server (tenants=N)")
        return self.fleet.ingest_mixed(tenant_ids, src, dst, weights, timestamps=timestamps)

    @property
    def stats(self):
        return self._plane().stats

    @property
    def engine(self):
        return self._plane().engine

    # -- ingest ---------------------------------------------------------------

    def ingest(self, src, dst, weights=None, tenant=None, *, timestamps=None):
        """Launch one edge batch; returns as soon as it is launched (call
        :meth:`flush` or any query to synchronize)."""
        self._session(tenant).ingest(src, dst, weights, timestamps=timestamps)

    def recover(self):
        """Crash recovery (requires ``wal_dir``): restore the newest
        checkpoint or shards and replay the WAL suffix (see
        :meth:`repro_torch.api.GraphStream.recover`,
        :meth:`repro_torch.fleet.SketchFleet.recover`)."""
        return self._plane().recover()

    def flush(self):
        """Block until every launched ingest batch has landed on the device."""
        self._plane().flush()

    def summary(self) -> Dict[str, float]:
        """Flushed stats: the only honest read of ingest throughput while
        batches are in flight."""
        return self._plane().summary()

    def advance_window(self, tenant=None):
        self._session(tenant).advance_window()

    # -- per-family service endpoints -----------------------------------------

    def edge_frequency(self, src, dst, tenant=None):
        return self._session(tenant).edge_frequency(src, dst)

    def in_flow(self, keys, tenant=None):
        return self._session(tenant).in_flow(keys)

    def out_flow(self, keys, tenant=None):
        return self._session(tenant).out_flow(keys)

    def heavy_hitters(self, keys, theta: float, tenant=None):
        return self._session(tenant).heavy_hitters(keys, theta)

    def reachable(self, src, dst, tenant=None):
        return self._session(tenant).reachable(src, dst)

    def subgraph_weight(self, src, dst, tenant=None):
        return self._session(tenant).subgraph_weight(src, dst)

    def query(self, *queries, tenant=None):
        """Heterogeneous mixed-family batches, planned and fused."""
        return self._session(tenant).query(*queries)

    # -- standing subscriptions -----------------------------------------------

    def subscribe(self, *queries, tenant=None, **kwargs) -> Subscription:
        """Register a standing query batch (compiled once, re-evaluated
        after every ``every``-th mutation); see
        :meth:`repro_torch.api.GraphStream.subscribe`."""
        return self._session(tenant).subscribe(*queries, **kwargs)

    def monitor(self, src, dst, weights, watch, theta: float) -> bool:
        """Threshold monitor (a heavy-hitter subscription; θ is a fraction of
        the total stream weight).  Single-session only: fleet callers register
        a per-tenant heavy subscription via ``tenant(tid).subscribe(...,
        alarm=...)``."""
        if self.fleet is not None:
            raise ValueError("monitor() is single-session; use tenant(tid).subscribe(..., alarm=...) on a fleet server")
        return self.stream.monitor(src, dst, weights, watch, theta)

    def events(self, tenant=None) -> Iterator[SubscriptionEvent]:
        """Drain the subscription event feed: the whole fleet's when no
        ``tenant`` is given on a fleet server."""
        if self.fleet is not None and tenant is None:
            return self.fleet.events()
        return self._session(tenant).events()

    # re-exported so request routers can build IR objects
    Query = Query
