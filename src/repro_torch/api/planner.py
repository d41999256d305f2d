"""Plan-and-fuse execution of heterogeneous QueryBatches.

Port of ``src/repro/api/planner.py``.  A mixed-family batch is

1. **grouped** by family (request indices remembered),
2. **fused** — each family's key arrays are concatenated (subgraph edge
   lists are padded to the group's max k with a validity mask, exact under
   the revised absent-edge semantics), so the whole family is AT MOST ONE
   :class:`~repro_torch.core.query_engine.QueryEngine` dispatch,
3. **scattered** back into request order as :class:`QueryResult`\\ s with
   per-family (ε, δ) annotations.

:func:`compile_batch` does the grouping and fusing ONCE, with the fused key
arrays already on the session's device; :meth:`CompiledPlan.run` re-executes
against any (sketch, epoch), which is what standing subscriptions pay per
tick.  Answers come back to the host as numpy values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.api.query import Query, QueryBatch, QueryResult, error_bound_for
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.query_engine import QueryEngine
from repro_torch.core.sketch import GLavaSketch


def plan(batch: QueryBatch) -> Dict[str, List[Tuple[int, Query]]]:
    """Group a batch by family, preserving request indices.  Family order is
    first appearance; each family maps to its (request_index, query) list."""
    groups: Dict[str, List[Tuple[int, Query]]] = {}
    for idx, q in enumerate(batch):
        groups.setdefault(q.family, []).append((idx, q))
    return groups


def _scatter(results, items, values, sizes):
    """Slice a family's fused answer array back onto the request slots."""
    lo = 0
    for (idx, q), n in zip(items, sizes):
        vals = values[lo : lo + n]
        results[idx] = vals[0] if q.scalar else vals
        lo += n


def _host(t: torch.Tensor) -> np.ndarray:
    """One family's answers on the host: the host waits here for the device
    (in a tick, for the closure too), hence the span."""
    with telemetry.span("tick.results"):
        return t.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class _FamilyPlan:
    """One family's fused dispatch: request bookkeeping + device tensors."""

    family: str
    items: Tuple[Tuple[int, Query], ...]
    sizes: Tuple[int, ...]
    args: Tuple


class CompiledPlan:
    """A QueryBatch compiled ONCE into per-family fused dispatches, with the
    fused key (and θ / mask) tensors resident on ``device``."""

    def __init__(self, batch: QueryBatch, device: Optional[torch.device] = None):
        self.batch = batch
        self.groups = plan(batch)
        self.families = tuple(self.groups)
        self.has_reach = "reach" in self.groups
        self._plans: List[_FamilyPlan] = []

        def concat(items, attr):
            return keys_to_tensor(np.concatenate([getattr(q, attr) for _, q in items]), device)

        for family, items in self.groups.items():
            sizes = tuple(q.n_answers for _, q in items)
            if family in ("edge", "reach"):
                args = (concat(items, "u"), concat(items, "v"))
            elif family in ("in_flow", "out_flow", "flow"):
                args = (concat(items, "u"),)
            elif family == "heavy":
                thetas = np.concatenate(
                    [np.full(n, q.theta, np.float32) for (_, q), n in zip(items, sizes)]
                )
                args = (concat(items, "u"), torch.from_numpy(thetas).to(device))
            elif family == "subgraph":
                n = len(items)
                k_max = max(q.u.shape[0] for _, q in items)
                src = np.zeros((n, k_max), np.uint32)
                dst = np.zeros((n, k_max), np.uint32)
                mask = np.zeros((n, k_max), bool)
                for row, (_, q) in enumerate(items):
                    k = q.u.shape[0]
                    src[row, :k] = q.u
                    dst[row, :k] = q.v
                    mask[row, :k] = True
                args = (
                    keys_to_tensor(src, device),
                    keys_to_tensor(dst, device),
                    torch.from_numpy(mask).to(device),
                )
            else:  # pragma: no cover — Query.__post_init__ rejects unknowns
                raise ValueError(f"planner has no rule for family {family!r}")
            self._plans.append(_FamilyPlan(family, tuple(items), sizes, args))

    def __len__(self) -> int:
        return len(self.batch)

    def run(
        self, engine: QueryEngine, sketch: GLavaSketch, epoch: Optional[int] = None
    ) -> List[QueryResult]:
        """Execute the plan: one engine dispatch per family present, answers
        in request order.  ``epoch`` tags the engine's closure cache."""
        if not self._plans:
            return []
        values: List = [None] * len(self.batch)
        for fp in self._plans:
            if fp.family == "edge":
                _scatter(values, fp.items, _host(engine.edge(sketch, *fp.args)), fp.sizes)
            elif fp.family in ("in_flow", "out_flow", "flow"):
                out = _host(getattr(engine, fp.family)(sketch, *fp.args))
                _scatter(values, fp.items, out, fp.sizes)
            elif fp.family == "heavy":
                in_h, out_h = engine.heavy_rel_vec(sketch, *fp.args)
                in_h, out_h = _host(in_h), _host(out_h)
                lo = 0
                for (idx, q), n in zip(fp.items, fp.sizes):
                    i_part, o_part = in_h[lo : lo + n], out_h[lo : lo + n]
                    values[idx] = (i_part[0], o_part[0]) if q.scalar else (i_part, o_part)
                    lo += n
            elif fp.family == "reach":
                out = _host(engine.reach(sketch, *fp.args, epoch=epoch))
                _scatter(values, fp.items, out, fp.sizes)
            elif fp.family == "subgraph":
                out = _host(engine.subgraph_batch(sketch, *fp.args))
                for row, (idx, _) in enumerate(fp.items):
                    values[idx] = out[row]

        bounds = {f: error_bound_for(f, sketch.config) for f in self.groups}
        return [
            QueryResult(query=q, value=values[i], error=bounds[q.family])
            for i, q in enumerate(self.batch)
        ]


def compile_batch(batch: QueryBatch, device: Optional[torch.device] = None) -> CompiledPlan:
    """Compile a batch once for repeated execution (the subscription path)."""
    return CompiledPlan(batch, device)


def execute(
    engine: QueryEngine,
    sketch: GLavaSketch,
    batch: QueryBatch,
    epoch: Optional[int] = None,
) -> List[QueryResult]:
    """One-shot plan-and-fuse: compile on the sketch's device, run, discard."""
    return CompiledPlan(batch, sketch.device).run(engine, sketch, epoch=epoch)
