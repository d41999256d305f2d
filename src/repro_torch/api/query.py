"""The typed query IR: queries are DATA, not method calls.

Port of ``src/repro/api/query.py`` (host-side, unchanged but for imports).

The paper's pitch is one summary answering "a wide range of graph queries"
over one stream (Section 3.4's catalogue).  This module makes that mixed
workload expressible: each supported family is a :class:`Query` constructor
—

    Query.edge(u, v)          f̃_e(u → v)            weight estimate
    Query.in_flow(n)          f̃_v(n, ←)             aggregate in-flow
    Query.out_flow(n)         f̃_v(n, →)             aggregate out-flow
    Query.flow(n)             f̃_v(n, ⊥ / total)     total incident flow
    Query.heavy(n, θ)         f̃_v(n) > θ·F̃          heavy-hitter check (θ ∈ (0,1])
    Query.reach(u, v)         r̃(u → v)              reachability
    Query.subgraph(us, vs)    f̃({(us_i, vs_i)})     aggregate subgraph

— and a heterogeneous :class:`QueryBatch` is planned by
:mod:`repro_torch.api.planner` into AT MOST ONE :class:`~repro_torch.core.query_engine.
QueryEngine` dispatch per family, with answers scattered back into request
order as :class:`QueryResult`\\ s carrying the paper's (ε, δ) one-sided
error annotations (:class:`ErrorBound`, derived from ``SketchConfig``).

Node labels (str/int) are encoded at Query construction by the
:mod:`repro_torch.api.codec`, so the IR below the constructors is already in the
uint32 key space.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Tuple

import numpy as np

from repro_torch.api.codec import encode_labels

# Families a Query may carry; the planner groups a batch by these.
FAMILIES = ("edge", "in_flow", "out_flow", "flow", "heavy", "reach", "subgraph")

# Families whose answers are counts with the paper's one-sided additive
# error; the rest are booleans with one-sided (no-false-negative) error.
_COUNT_FAMILIES = frozenset({"edge", "in_flow", "out_flow", "flow", "subgraph"})


@dataclasses.dataclass(frozen=True)
class ErrorBound:
    """The paper's one-sided guarantee attached to a QueryResult.

    For count families: ``estimate <= truth + epsilon * F`` (F the total
    stream weight) with probability at least ``1 - delta``, and NEVER an
    under-estimate (Thm 1).  For boolean families (reach, heavy):
    ``epsilon`` is None and the guarantee is no false negatives, with false
    positives occurring with probability at most ``delta``-ish per query
    (hash-collision driven)."""

    epsilon: Optional[float]
    delta: float
    side: str  # "over-estimate" | "no-false-negative"

    def __str__(self) -> str:
        if self.epsilon is None:
            return f"one-sided ({self.side}), δ={self.delta:.2e}"
        return f"one-sided ({self.side}), ε={self.epsilon:.2e}, δ={self.delta:.2e}"


def error_bound_for(family: str, config) -> ErrorBound:
    """Derive the family's ErrorBound from a SketchConfig (its ``error_bound``
    is the exact inverse of ``SketchConfig.for_error`` — round-trip tested)."""
    eps, delta = config.error_bound()
    if family in _COUNT_FAMILIES:
        return ErrorBound(epsilon=eps, delta=delta, side="over-estimate")
    return ErrorBound(epsilon=None, delta=delta, side="no-false-negative")


def validate_theta(theta) -> float:
    """Validate a heavy-hitter / monitor threshold θ: a FRACTION of the
    total stream weight F̃, so ``0 < θ <= 1`` (and finite — a NaN θ would
    otherwise compare false everywhere and silently report nothing heavy).
    Raises a clear ``ValueError``; shared by ``Query.heavy``,
    ``GraphStream.monitor``, and subscription construction."""
    try:
        theta = float(theta)
    except (TypeError, ValueError):
        raise ValueError(f"theta must be a real number, got {theta!r}")
    if not (0.0 < theta <= 1.0):  # also rejects NaN (all comparisons false)
        raise ValueError(
            "theta is the heavy-hitter fraction of the total stream weight "
            f"F and must satisfy 0 < theta <= 1, got {theta!r}"
        )
    return theta


def _encode_batchable(labels) -> Tuple[np.ndarray, bool]:
    """Encode labels -> ((Q,) uint32 keys, was_scalar)."""
    keys = encode_labels(labels)
    scalar = np.ndim(keys) == 0
    keys = np.atleast_1d(keys).astype(np.uint32, copy=False)
    if keys.ndim != 1:
        raise ValueError(f"expected scalar or 1-D labels, got shape {keys.shape}")
    return keys, scalar


@dataclasses.dataclass(frozen=True)
class Query:
    """One logical query: a family tag plus encoded key payload.

    Endpoint payloads may be scalar labels (scalar result) or 1-D label
    batches (array result, one answer per element) — except ``subgraph``,
    whose (k,) edge list is ONE query with a scalar answer.  Construct via
    the family staticmethods, not directly."""

    family: str
    u: Optional[np.ndarray] = None      # (Q,) or (k,) uint32
    v: Optional[np.ndarray] = None
    theta: Optional[float] = None       # heavy-hitter threshold
    scalar: bool = True                 # unwrap the answer to a scalar

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown query family {self.family!r} (want {FAMILIES})")

    # -- constructors (the public IR) ---------------------------------------

    @staticmethod
    def edge(u, v) -> "Query":
        """Edge-frequency estimate f̃_e(u → v) (Section 4.1)."""
        ku, su = _encode_batchable(u)
        kv, sv = _encode_batchable(v)
        ku, kv = np.broadcast_arrays(ku, kv)
        return Query("edge", np.ascontiguousarray(ku), np.ascontiguousarray(kv),
                     scalar=su and sv)

    @staticmethod
    def in_flow(n) -> "Query":
        """Aggregate in-flow point query f̃_v(n, ←) (Section 4.2)."""
        k, s = _encode_batchable(n)
        return Query("in_flow", k, scalar=s)

    @staticmethod
    def out_flow(n) -> "Query":
        """Aggregate out-flow point query f̃_v(n, →) (Section 4.2)."""
        k, s = _encode_batchable(n)
        return Query("out_flow", k, scalar=s)

    @staticmethod
    def flow(n) -> "Query":
        """Total incident flow (in + out for directed streams)."""
        k, s = _encode_batchable(n)
        return Query("flow", k, scalar=s)

    @staticmethod
    def heavy(n, theta: float) -> "Query":
        """Heavy-hitter check: is f̃_v(n) > θ·F̃ (in- and out-flow), with θ a
        FRACTION of the total stream weight F̃ in (0, 1] (validated — a
        clear ValueError beats silently-all-false bits from a nonsense θ)?
        The answer is an (in_heavy, out_heavy) boolean pair per node."""
        k, s = _encode_batchable(n)
        return Query("heavy", k, theta=validate_theta(theta), scalar=s)

    @staticmethod
    def reach(u, v) -> "Query":
        """Reachability r̃(u → v) (Section 4.3); requires a square sketch."""
        ku, su = _encode_batchable(u)
        kv, sv = _encode_batchable(v)
        ku, kv = np.broadcast_arrays(ku, kv)
        return Query("reach", np.ascontiguousarray(ku), np.ascontiguousarray(kv),
                     scalar=su and sv)

    @staticmethod
    def subgraph(us, vs) -> "Query":
        """Aggregate subgraph weight f̃({(us_i, vs_i)}) for one edge list
        (Section 4.4 revised exact-match semantics): one scalar answer."""
        ku, _ = _encode_batchable(us)
        kv, _ = _encode_batchable(vs)
        if ku.shape != kv.shape:
            raise ValueError(
                f"subgraph endpoint lists must match: {ku.shape} vs {kv.shape}"
            )
        if ku.size == 0:
            raise ValueError("subgraph query needs at least one edge")
        return Query("subgraph", ku, kv, scalar=True)

    # -- plumbing -----------------------------------------------------------

    @property
    def n_answers(self) -> int:
        """How many answer slots this query occupies in its family batch."""
        return 1 if self.family == "subgraph" else int(self.u.shape[0])


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """An ordered heterogeneous batch of queries — the planner's unit.

    Results always come back in THIS order, regardless of how the planner
    groups families for dispatch."""

    queries: Tuple[Query, ...]

    def __init__(self, queries):
        object.__setattr__(self, "queries", tuple(queries))
        for q in self.queries:
            if not isinstance(q, Query):
                raise TypeError(f"QueryBatch holds Query objects, got {type(q)}")

    def __len__(self) -> int:
        return len(self.queries)

    def __iter__(self) -> Iterator[Query]:
        return iter(self.queries)

    def __getitem__(self, i) -> Query:
        return self.queries[i]

    @property
    def families(self) -> Tuple[str, ...]:
        """Distinct families present, in first-appearance order."""
        seen = dict.fromkeys(q.family for q in self.queries)
        return tuple(seen)


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One query's answer: the value, the originating query, and the paper's
    (ε, δ) one-sided error annotation."""

    query: Query
    value: Any            # scalar / ndarray; heavy -> (in_heavy, out_heavy)
    error: ErrorBound

    @property
    def family(self) -> str:
        return self.query.family
