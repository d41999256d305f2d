"""Generator ``edge_stream``: turns a traffic file's parameters and a seed
into the batches of a run and the standing queries (``Inputs``).

It draws the distributions of the reference's ``launch/serve.py``: zipf
endpoints over ``nodes`` node ids (rank r drawn with weight r^-a, node id
r - 1), integer weights in 1..``max_weight``, and, for a fleet, tenant ids
``(zipf(a) - 1) mod count``.  The draws run on the device from one
``torch.Generator`` in a few large calls and come back to the host, where
the program takes its batches; the same seed gives the same inputs.  Every
batch of a run is drawn before the window.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Stream:
    """The run's batches on the host: (N,) uint32 endpoints, float32
    weights and, for a fleet, int64 tenant ids, cut into ``batch``-edge
    batches."""

    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    tenant: Optional[np.ndarray]
    batch: int

    @property
    def n_batches(self) -> int:
        return self.src.shape[0] // self.batch

    def span(self, i: int):
        if i >= self.n_batches:
            raise RuntimeError(f"the run asked for batch {i} of {self.n_batches}: the drawn stream ran short")
        return slice(i * self.batch, (i + 1) * self.batch)


def n_batches(traffic: dict, seconds: float) -> int:
    """Batches drawn for a run: the warm-up, then twice what the window
    takes at the rate the traffic file was sized for."""
    rate = traffic["sized_for_edges_per_s"]
    return traffic["warmup_batches"] + math.ceil(2 * rate * seconds / traffic["stream"]["batch"]) + 1


def zipf_cdf(n: int, a: float, device) -> torch.Tensor:
    """CDF over ranks 1..n with weights r^-a, float64."""
    p = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** (-a)
    return torch.cumsum(p / p.sum(), 0)


def tenant_probs(count: int, a: float) -> np.ndarray:
    """P(tenant t) for ids ``(k - 1) mod count`` with k ~ zipf(a) on 1, 2, ...:
    the sum of k^-a over k = t + 1 (mod count), a Hurwitz zeta, summed to
    2^20 terms a tenant with the integral of the rest as its tail."""
    terms = 1 << 20
    j = np.arange(terms, dtype=np.float64)
    out = np.empty(count)
    for t in range(count):
        k = count * j + t + 1
        tail = (count * terms + t + 1) ** (1 - a) / (count * (a - 1))
        out[t] = np.sum(k ** (-a)) + tail
    return out / out.sum()


def _categorical(cdf: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.shape[0] - 1)


def make_stream(traffic: dict, seed: int, batches: int, device) -> Stream:
    """Draw ``batches`` batches of the traffic's stream from ``seed``."""
    spec = traffic["stream"]
    n = batches * spec["batch"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    cdf = zipf_cdf(spec["nodes"], spec["zipf_a"], device)
    src = _categorical(cdf, n, gen).to(torch.int32).cpu().numpy().view(np.uint32)
    dst = _categorical(cdf, n, gen).to(torch.int32).cpu().numpy().view(np.uint32)
    weight = torch.randint(1, spec["max_weight"] + 1, (n,), generator=gen, device=device)
    weight = weight.to(torch.float32).cpu().numpy()
    tenant = None
    if "tenant_ids" in traffic:
        ids = traffic["tenant_ids"]
        probs = torch.from_numpy(tenant_probs(ids["count"], ids["zipf_a"])).to(device)
        tenant = _categorical(torch.cumsum(probs, 0), n, gen).cpu().numpy()
    return Stream(src, dst, weight, tenant, spec["batch"])


@dataclasses.dataclass
class Standing:
    """The standing workload: keys drawn once from the seed, the same mixed
    batch re-asked at every due tick (as ``launch/serve.py`` draws them:
    edge queries on (qs, qd), in-flow and heavy on prefixes of qs, reach on
    prefixes of both)."""

    qs: np.ndarray
    qd: np.ndarray
    spec: dict

    def families(self):
        """``[(family, n)]`` in request order."""
        return [(f, self.spec[f]) for f in ("edge", "in_flow", "heavy", "reach") if self.spec.get(f)]


def standing(traffic: dict, seed: int) -> Standing:
    spec = traffic["standing"]
    n = max(spec.get(f, 0) for f in ("edge", "in_flow", "heavy", "reach"))
    rng = np.random.default_rng([int(seed), 1])
    nodes = traffic["stream"]["nodes"]
    qs = rng.integers(0, nodes, n).astype(np.uint32)
    qd = rng.integers(0, nodes, n).astype(np.uint32)
    return Standing(qs, qd, spec)


@dataclasses.dataclass
class Inputs:
    """What a run hands the program and the reference alike."""

    stream: Stream
    standing: Standing


def make(traffic: dict, seed: int, device, *, seconds: Optional[float] = None,
         batches: Optional[int] = None) -> Inputs:
    """The inputs of a run of ``seconds`` (``n_batches``), or of exactly
    ``batches`` batches."""
    if batches is None:
        batches = n_batches(traffic, seconds)
    return Inputs(make_stream(traffic, seed, batches, device), standing(traffic, seed))
