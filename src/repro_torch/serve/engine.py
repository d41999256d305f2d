"""gLava serving engine: the paper's data structure as an online service.

Port of ``src/repro/serve/engine.py`` (single-session mode).
:class:`SketchServer` wraps one :class:`repro_torch.api.GraphStream`
session, which carries the summary, the bounded in-flight ingest path, the
planned and fused query path, the sliding window, event time, the WAL and
checkpoints; the server adds the service-shaped method surface (per-family
endpoints a request router binds to).

The session runs on ``device`` (CUDA by default, ``"cpu"`` to opt out), and
its ingest backend defaults to ``"auto"``: the ingest kernel on the card, the
plain scatter on the CPU (the reference's ``"scatter"`` default names its
paper-faithful XLA scatter; the port's ``"scatter"`` is the plain version).

Fleet mode (``tenants=N``, the reference's ``SketchFleet``) is not ported
yet (ROADMAP A8) and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

from repro_torch.api import GraphStream, Query, SketchConfig, Subscription, SubscriptionEvent
from repro_torch.device import DeviceLike


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
        """``wal_dir`` makes ingest durable (write-ahead-logged before every
        device dispatch; :meth:`recover` replays the suffix after a crash).
        ``slice_width``/``max_lateness`` switch the session to event-time
        windowing: ingest then requires per-edge ``timestamps`` and the
        watermark drives window advances."""
        if tenants is not None:
            raise NotImplementedError("tenants= (fleet mode) is not ported yet (ROADMAP A8)")
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

    def _session(self, tenant=None) -> GraphStream:
        if tenant is not None:
            raise ValueError("tenant= requires a fleet server (tenants=N)")
        return self.stream

    @property
    def stats(self):
        return self.stream.stats

    @property
    def engine(self):
        return self.stream.engine

    # -- ingest ---------------------------------------------------------------

    def ingest(self, src, dst, weights=None, tenant=None, *, timestamps=None):
        """Launch one edge batch; returns as soon as it is launched (call
        :meth:`flush` or any query to synchronize)."""
        self._session(tenant).ingest(src, dst, weights, timestamps=timestamps)

    def recover(self):
        """Crash recovery (requires ``wal_dir``): restore the newest
        checkpoint and replay the WAL suffix (see
        :meth:`repro_torch.api.GraphStream.recover`)."""
        return self.stream.recover()

    def flush(self):
        """Block until every launched ingest batch has landed on the device."""
        self.stream.flush()

    def summary(self) -> Dict[str, float]:
        """Flushed stats: the only honest read of ingest throughput while
        batches are in flight."""
        return self.stream.summary()

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
        the total stream weight)."""
        return self.stream.monitor(src, dst, weights, watch, theta)

    def events(self, tenant=None) -> Iterator[SubscriptionEvent]:
        """Drain the session's subscription event feed."""
        return self._session(tenant).events()

    # re-exported so request routers can build IR objects
    Query = Query
