"""Driver of one ``GraphStream`` session (configurations with
``"driver": "session"``): the standing workload subscribed once, each batch
handed to ``ingest`` (which runs the due ticks before it returns), and,
where the mix has a dashboard, PageRank and the triangle mass of the live
summary after every ``dashboard.every``-th batch."""
from __future__ import annotations

import time
from typing import List, Optional

from bench.harness.trace import Span
from bench.reference.glava import Dashboard, Event, Outputs


def workload_batch(standing):
    """The standing workload as one ``QueryBatch``, in the families' order."""
    from repro_torch.api import Query, QueryBatch

    qs, qd, spec = standing.qs, standing.qd, standing.spec
    make = {
        "edge": lambda n: Query.edge(qs[:n], qd[:n]),
        "in_flow": lambda n: Query.in_flow(qs[:n]),
        "heavy": lambda n: Query.heavy(qs[:n], theta=spec["heavy_theta"]),
        "reach": lambda n: Query.reach(qs[:n], qd[:n]),
    }
    return QueryBatch([make[f](n) for f, n in standing.families()])


def event_values(standing, results) -> dict:
    return {f: r.value for (f, _), r in zip(standing.families(), results)}


def check_state(config: dict, sketch, tenants: int = 1) -> None:
    """The program's summary has the configuration's counter type and, for
    ``tenants`` such summaries, its ``state_bytes``; else the run stops."""
    parts = (sketch.counters, sketch.row_flows, sketch.col_flows)
    dtypes = {str(t.dtype).removeprefix("torch.") for t in parts}
    nbytes = tenants * sum(t.numel() * t.element_size() for t in parts)
    if dtypes != {config["counter_dtype"]} or nbytes != config["state_bytes"]:
        raise RuntimeError(f"the program holds {sorted(dtypes)} state of {nbytes} bytes; the configuration "
                           f"states {config['counter_dtype']} of {config['state_bytes']}")


def sketch_config(config: dict):
    from repro_torch.api import SketchConfig

    return SketchConfig(config["depth"], config["width_rows"], config["width_cols"], config["directed"])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, inputs):
        from repro_torch.api import GraphStream

        self.gs = GraphStream.open(
            sketch_config(config), seed=seed, device=device,
            ingest_backend=config["backends"]["ingest"], query_backend=config["backends"]["query"],
        )
        check_state(config, self.gs.sketch)
        self.traffic, self.stream, self.standing = traffic, inputs.stream, inputs.standing
        self.events: List[Event] = []
        self.dashboards: List[Dashboard] = []
        self.batches = 0
        self._t0 = 0
        self.dash_every = traffic["dashboard"]["every"] if "dashboard" in traffic else 0
        self.sub = self.gs.subscribe(
            workload_batch(self.standing), every=self.standing.spec.get("every", 1), on_result=self._on_event,
            name="monitor",
        )

    def _on_event(self, ev) -> None:
        lat = (time.perf_counter_ns() - self._t0) / 1e6
        self.events.append(Event(0, ev.epoch, event_values(self.standing, ev.results), lat))

    def _ingest(self, due_ns: Optional[int] = None) -> Span:
        span = self.stream.span(self.batches)
        s = time.time_ns()
        self._t0 = time.perf_counter_ns() if due_ns is None else due_ns
        self.gs.ingest(self.stream.src[span], self.stream.dst[span], self.stream.weight[span])
        self.batches += 1
        return Span(f"ingest call (batch {self.batches - 1})", s, time.time_ns())

    def _dashboard(self) -> Span:
        """PageRank and the global triangle mass of the live summary, each
        ending in its result on the host."""
        from repro_torch.core.queries import global_triangle_estimate

        s = time.time_ns()
        pr = self.traffic["dashboard"]["pagerank"]
        ranks = self.gs.pagerank(pr["damping"], pr["iters"])
        tri = float(global_triangle_estimate(self.gs.sketch).item())
        self.dashboards.append(Dashboard(self.gs.epoch, ranks, tri))
        return Span("dashboard call", s, time.time_ns())

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_batches"]):
            self._ingest()
        if self.dash_every:
            self._dashboard()

    def step(self, due_ns: Optional[int] = None) -> List[Span]:
        spans = [self._ingest(due_ns)]
        if self.dash_every and self.batches % self.dash_every == 0:
            spans.append(self._dashboard())
        return spans

    def counters(self) -> dict:
        """The session's own counters: host seconds of ingest and of ticks,
        ticks, full closure builds; and the batches and edges handed."""
        s = self.gs.stats
        return {"ingest_s": s.ingest_s, "query_s": s.query_s, "ticks": s.subscription_ticks,
                "full_builds": self.gs.engine.closure_refreshes, "batches": self.batches,
                "edges": self.batches * self.stream.batch}

    def latencies_ms(self) -> List[float]:
        return [e.latency_ms for e in self.events]

    def outputs(self) -> Outputs:
        """The final summary (a snapshot) and, where the workload asks
        reach, the engine's closure at the final epoch through its public
        ``closure_for`` (the one the last tick built, or a build of it);
        the session's own state goes with ``close``."""
        sk = self.gs.sketch
        closures = {}
        if "reach" in dict(self.standing.families()):
            closures[0] = (self.gs.epoch, self.gs.engine.closure_for(sk, self.gs.epoch))
        return Outputs(self.events, self.dashboards, {0: (sk.counters, sk.row_flows, sk.col_flows)}, closures,
                       self.batches)

    def close(self) -> None:
        self.sub.cancel()
        del self.gs
