"""Driver of one ``SketchFleet`` (configurations with ``"driver": "fleet"``):
the standing workload subscribed on each hot tenant, each mixed batch handed
to ``ingest_mixed`` (which ticks the due tenants before it returns)."""
from __future__ import annotations

import functools
import time
from typing import List, Optional

from bench.harness.drivers.session import check_state, event_values, sketch_config, workload_batch
from bench.harness.trace import Span
from bench.reference.glava import Event, Outputs


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, inputs):
        from repro_torch.fleet import SketchFleet

        self.fleet = SketchFleet.open(
            sketch_config(config), capacity=config["capacity"], seed=seed, device=device,
            ingest_backend=config["backends"]["ingest"], query_backend=config["backends"]["query"],
        )
        self.traffic, self.stream, self.standing = traffic, inputs.stream, inputs.standing
        self.events: List[Event] = []
        self.batches = 0
        self._t0 = 0
        batch = workload_batch(self.standing)
        self.subs = [
            self.fleet.tenant(t).subscribe(batch, every=self.standing.spec.get("every", 1),
                                           on_result=functools.partial(self._on_event, t), name=f"tenant-{t}")
            for t in self.standing.spec["tenants"]
        ]
        # Every tenant's summary is a plane of one stack of ``capacity``.
        check_state(config, self.fleet.tenant(self.standing.spec["tenants"][0]).sketch, config["capacity"])

    def _on_event(self, tenant: int, ev) -> None:
        lat = (time.perf_counter_ns() - self._t0) / 1e6
        self.events.append(Event(tenant, ev.epoch, event_values(self.standing, ev.results), lat))

    def _ingest(self, due_ns: Optional[int] = None) -> Span:
        span, st = self.stream.span(self.batches), self.stream
        s = time.time_ns()
        self._t0 = time.perf_counter_ns() if due_ns is None else due_ns
        self.fleet.ingest_mixed(st.tenant[span], st.src[span], st.dst[span], st.weight[span])
        self.batches += 1
        return Span(f"ingest call (batch {self.batches - 1})", s, time.time_ns())

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_batches"]):
            self._ingest()

    def step(self, due_ns: Optional[int] = None) -> List[Span]:
        return [self._ingest(due_ns)]

    def counters(self) -> dict:
        """The fleet's own counters: host seconds of ingest (``FleetStats``)
        and of ticks (the tenants' ``StreamStats``), ticks, full closure
        builds (one a tenant a build); and the batches and edges handed."""
        st = self.fleet.stats
        query_s = sum(self.fleet.tenant(t).stats.query_s for t in self.standing.spec["tenants"])
        return {"ingest_s": st.ingest_s, "query_s": query_s, "ticks": st.subscription_ticks,
                "full_builds": self.fleet.engine.closure_builds, "batches": self.batches,
                "edges": self.batches * self.stream.batch}

    def latencies_ms(self) -> List[float]:
        return [e.latency_ms for e in self.events]

    def outputs(self) -> Outputs:
        """Every tenant's final summary (a snapshot) and each hot tenant's
        last closure.  The fleet engine has no public accessor of a tenant's
        closure, so it is read from the engine's cache by the tenant's slot;
        a hot tenant with none there is judged as a closure that is all
        wrong.  The fleet's own state goes with ``close``."""
        states = {}
        for t in sorted(self.fleet.tenants):
            sk = self.fleet.tenant(t).sketch
            states[int(t)] = (sk.counters, sk.row_flows, sk.col_flows)
        closures = {}
        for t in self.standing.spec["tenants"]:
            cached = getattr(self.fleet.engine, "_closures", {}).get(getattr(self.fleet.tenant(t), "_slot", None))
            if cached is not None:
                closures[t] = (cached[1], cached[0])
        return Outputs(self.events, [], states, closures, self.batches)

    def close(self) -> None:
        for sub in self.subs:
            sub.cancel()
        del self.fleet
