"""Reference ``glava``: the plain gLava summary, the comparison that
decides ``correct`` for the configurations that name it, and its control.

The summary does the same operations on the same batches, written from the
paper's definitions in plain PyTorch.

It imports nothing of the program and takes nothing the program made.  The
hash family is derived again from the seed by a frozen copy of the
derivation (``make_hash_family`` and ``GLavaSketch.hash_families`` of the
port, square sketches only): ``a ~ U[1, p-1]``, ``b ~ U[0, p-1]`` from a CPU
``torch.Generator`` seeded with the session seed, one family shared by rows
and columns, ``h(x) = ((a*x + b) mod p) mod w`` with ``p = 2**31 - 1``.

Every quantity is computed in float64, where the integer counts of these
streams are exact in any order.  ``Precision`` names what the control lowers
(see ``bench/control.py``): the counters' and registers' accumulation dtype,
the squarings of the closure, and the float32 products of the analytics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

P = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class Precision:
    """What the reference computes in.  ``Precision()`` is the reference;
    the control lowers each field by one step below what the configuration
    states (float32 counters: bfloat16; float32 products with TF32 off: TF32;
    a closure squared to its fixed point: one squaring short of it)."""

    state: torch.dtype = torch.float64
    analytics: str = "float64"  # or "tf32": float32 products of TF32-rounded inputs
    closure_short: bool = False  # stop one changing squaring before the fixed point


CONTROL = Precision(state=torch.bfloat16, analytics="tf32", closure_short=True)
# The analytics' step alone, on float32 counters as the program keeps them:
# it tells apart the dashboard's own limits.
CONTROL_TF32 = Precision(state=torch.float32, analytics="tf32")


def hash_family(seed: int, depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(a, b)`` coefficients, each (d,) int64 on the CPU."""
    gen = torch.Generator().manual_seed(int(seed))
    a = torch.randint(1, P, (depth,), generator=gen, dtype=torch.int64)
    b = torch.randint(0, P, (depth,), generator=gen, dtype=torch.int64)
    return a, b


def buckets(keys: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: int) -> torch.Tensor:
    """(B,) int64 keys (uint32 values) -> (d, B) int64 buckets.  Keys are
    reduced mod p first, so ``a * k < 2**62``."""
    k = (keys.to(torch.int64) % P)[None, :]
    return ((a.to(keys.device)[:, None] * k + b.to(keys.device)[:, None]) % P) % w


class Summary:
    """d hashed w x w adjacency matrices and the row and column sums, fed
    edge by edge (``ingest`` scatters a batch; the order of the adds is
    immaterial in float64)."""

    def __init__(self, seed: int, depth: int, width: int, device, dtype=torch.float64):
        self.a, self.b = hash_family(seed, depth)
        self.a, self.b = self.a.to(device), self.b.to(device)
        self.d, self.w, self.device = depth, width, torch.device(device)
        self.counters = torch.zeros((depth, width, width), dtype=dtype, device=device)
        self.rows = torch.zeros((depth, width), dtype=dtype, device=device)
        self.cols = torch.zeros((depth, width), dtype=dtype, device=device)

    def hash(self, keys: torch.Tensor) -> torch.Tensor:
        return buckets(keys.to(self.device), self.a, self.b, self.w)

    def ingest(self, src, dst, weight) -> None:
        """Add a batch of edges ``(src, dst; weight)`` (host or device arrays)."""
        src = torch.as_tensor(src).to(self.device, torch.int64)
        dst = torch.as_tensor(dst).to(self.device, torch.int64)
        wt = torch.as_tensor(weight).to(self.device, self.counters.dtype)
        r, c = self.hash(src), self.hash(dst)
        plane = torch.arange(self.d, device=self.device)[:, None] * self.w
        vals = wt.expand(self.d, -1).reshape(-1)
        self.counters.view(-1).index_add_(0, ((plane + r) * self.w + c).reshape(-1), vals)
        self.rows.view(-1).index_add_(0, (plane + r).reshape(-1), vals)
        self.cols.view(-1).index_add_(0, (plane + c).reshape(-1), vals)

    # -- the four families of the standing workload --------------------------

    def edge(self, src, dst) -> torch.Tensor:
        """min over the d matrices of the cell (h(src), h(dst))."""
        r, c = self.hash(torch.as_tensor(src)), self.hash(torch.as_tensor(dst))
        i = torch.arange(self.d, device=self.device)[:, None]
        return self.counters[i, r, c].to(torch.float64).amin(0)

    def in_flow(self, keys) -> torch.Tensor:
        """min over d of the column sum at h(key)."""
        h = self.hash(torch.as_tensor(keys))
        return torch.gather(self.cols, 1, h).to(torch.float64).amin(0)

    def out_flow(self, keys) -> torch.Tensor:
        h = self.hash(torch.as_tensor(keys))
        return torch.gather(self.rows, 1, h).to(torch.float64).amin(0)

    def total(self) -> torch.Tensor:
        """F, the stream's total weight: min over d of the row sums' sum."""
        return self.rows.to(torch.float64).sum(1).amin()

    def heavy(self, keys, theta: float):
        """``(in > theta F, out > theta F, in, out, theta F)``: the heavy
        bits with the flows and the cut they were judged against."""
        cut = theta * self.total()
        fin, fout = self.in_flow(keys), self.out_flow(keys)
        return fin > cut, fout > cut, fin, fout, cut

    def closure(self, short: bool = False) -> Tuple[torch.Tensor, int]:
        """The transitive closure of every matrix's 0/1 adjacency with self
        loops, squared to its fixed point: ``A <- A or (A.A > 0)``.  Returns
        the (d, w, w) bool closure and the number of squarings that changed
        it.  ``short`` returns the matrix one changing squaring before it."""
        a = (self.counters > 0) | torch.eye(self.w, dtype=torch.bool, device=self.device)
        before = a
        limit = max(1, math.ceil(math.log2(max(2, self.w))))
        k = 0
        for _ in range(limit):
            # 0/1 operands are exact in bfloat16 and a sum of non-negative
            # products is positive exactly when one product is.
            f = a.to(torch.bfloat16)
            nxt = a | (torch.matmul(f, f) > 0)
            del f
            if torch.equal(nxt, a):
                break
            before, a, k = a, nxt, k + 1
        return (before if short else a), k

    def reach(self, closure: torch.Tensor, src, dst) -> torch.Tensor:
        """AND over d of closure[i, h(src), h(dst)]."""
        r, c = self.hash(torch.as_tensor(src)), self.hash(torch.as_tensor(dst))
        i = torch.arange(self.d, device=self.device)[:, None]
        return closure[i, r, c].all(0)

    # -- the dashboard -----------------------------------------------------------

    def pagerank(self, damping: float, iters: int, analytics: str = "float64") -> torch.Tensor:
        """PageRank on each matrix as a graph: rows normalised to sums of 1
        (a row with no weight leaks its mass, spread uniformly), ``iters``
        steps of ``r <- damping r P + (1 - damping |r P|_1) / w``."""
        dt = torch.float64 if analytics == "float64" else torch.float32
        m = self.counters.to(dt)
        out = m.sum(2, keepdim=True)
        # A row with no weight is all zeros, and stays so divided by 1.
        p = m / torch.where(out > 0, out, torch.ones_like(out))
        del m
        lower = tf32 if analytics == "tf32" else (lambda x: x)
        p = lower(p)
        rank = torch.full((self.d, 1, self.w), 1.0 / self.w, dtype=dt, device=self.device)
        for _ in range(iters):
            step = torch.bmm(lower(rank), p)
            rank = damping * step + (1.0 - damping * step.sum(-1, keepdim=True)) / self.w
        return rank[:, 0, :].to(torch.float64)

    def triangles(self, analytics: str = "float64") -> float:
        """min over d of trace(M^3), the weighted closed 3-walks, as
        ``sum_ij (M.M)_ij M_ji``."""
        dt = torch.float64 if analytics == "float64" else torch.float32
        m = self.counters.to(dt)
        mm = tf32(m) if analytics == "tf32" else m
        m2 = torch.bmm(mm, mm)
        del mm
        return float((m2 * m.transpose(1, 2)).sum((1, 2)).amin())


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the tensor cores read float32 operands with TF32 on."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


# -- the comparison -------------------------------------------------------------
#
# What is compared (``numbers``), each against its limit in the workload file:
#
# - ``exact_miss``: entries that differ where the exact value is below 2^24,
#   where float32 sums of these integer weights are exact in any order: every
#   counter and both flow registers of every tenant at the end of the run;
#   every edge and in-flow answer of every tick; every heavy bit whose flow
#   lies clear of its cut (by more than ``HEAVY_MARGIN`` of it); every reach
#   answer of the sampled ticks.  Every answer of a due tick that emitted no
#   event counts as a miss.
# - ``rel_gap``: the widest relative gap ``|p - r| / max(|r|, 1)`` over the
#   same state entries and edge and in-flow answers; past 2^24 float32 sums
#   round in the order they are made, so only a gap is asked of them.
# - ``closure_miss``: entries of each hot tenant's closure that differ from
#   the reference's closure of that tenant's summary at that closure's epoch;
#   a hot tenant with no closure, or one at an epoch it never had, counts
#   ``d w^2``.
# - ``pagerank_gap`` and ``triangle_gap`` (dashboard cells): the widest
#   relative gap of the sampled dashboard calls' PageRank and triangle mass.
#
# The reference runs in float64 on the run's device, tenant by tenant, after
# the program's state is freed.

EXACT = float(1 << 24)
# A heavy bit is judged only where its flow lies farther from the cut than
# this share of it: the program's cut is a float32 sum of w registers, off
# by a few ulps of the total.
HEAVY_MARGIN = 1e-3


@dataclasses.dataclass
class Event:
    """One tick's answers: ``values[family]`` is a host array (heavy: a
    pair of bool arrays, in and out); ``latency_ms`` from the handing of the
    due batch to the event's results on the host."""

    tenant: int
    epoch: int
    values: Dict[str, object]
    latency_ms: float = 0.0


@dataclasses.dataclass
class Dashboard:
    epoch: int
    pagerank: np.ndarray
    triangles: float


@dataclasses.dataclass
class Outputs:
    """Everything the timed path produced that the check judges."""

    events: List[Event]
    dashboards: List[Dashboard]
    # tenant -> (counters, row sums, column sums)
    states: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    # hot tenant -> (epoch, (d, w, w) bool closure)
    closures: Dict[int, Tuple[int, torch.Tensor]]
    batches: int  # batches handed to the program, warm-up included


def tenant_batches(stream, tenant: int, batches: int, tenants: int):
    """Per batch, the slice or mask of ``tenant``'s edges (all edges for a
    single session) and whether the batch has any."""
    for i in range(batches):
        span = stream.span(i)
        if tenants == 1:
            yield span, None, True
        else:
            mask = stream.tenant[span] == tenant
            yield span, mask, bool(mask.any())


def reach_sample(seed: int, tenant: int, epochs: List[int], n: int) -> set:
    """The ticks whose reach answers are checked: ``n`` drawn from the seed
    among the tenant's events."""
    if not epochs or n <= 0:
        return set()
    rng = np.random.default_rng([int(seed), 7, tenant])
    return set(rng.choice(sorted(epochs), size=min(n, len(epochs)), replace=False).tolist())


def dashboard_sample(seed: int, epochs: List[int], n: int) -> set:
    """The dashboard calls checked: the last, and ``n - 1`` drawn from the seed."""
    if not epochs:
        return set()
    rng = np.random.default_rng([int(seed), 11])
    rest = sorted(epochs)[:-1]
    pick = rng.choice(rest, size=min(max(n - 1, 0), len(rest)), replace=False).tolist() if rest else []
    return set(pick) | {max(epochs)}


class _Tally:
    def __init__(self):
        self.exact_miss = 0
        self.rel_gap = 0.0

    def add(self, prog, ref) -> None:
        """Fold one array of program values against the exact ones."""
        p = torch.as_tensor(np.asarray(prog) if not isinstance(prog, torch.Tensor) else prog)
        p = p.to(ref.device, torch.float64)
        exact = ref.abs() < EXACT
        self.exact_miss += int(((p != ref) & exact).sum())
        if ref.numel():
            gap = ((p - ref).abs() / ref.abs().clamp_min(1.0)).max()
            self.rel_gap = max(self.rel_gap, float(gap))


def compare(cell, seed: int, inputs, out: Outputs, device) -> Tuple[Dict[str, float], Dict[str, object]]:
    """Run the reference over the batches the program took and compare.
    Returns the numbers and the reference's facts (the squarings the last
    closure needed, per hot tenant)."""
    config, traffic, workload = cell.config, cell.traffic, cell.workload
    stream, standing = inputs.stream, inputs.standing
    d, w = config["depth"], config["width_rows"]
    if w != config["width_cols"] or not config.get("directed", True):
        raise ValueError("the reference covers square directed sketches")
    tenants = config.get("tenants", 1)
    check = workload.get("check", {})
    tally = _Tally()
    closure_miss = 0
    pr_gap = tri_gap = 0.0
    facts: Dict[str, object] = {"closure_squarings": {}}
    by_tenant: Dict[int, Dict[int, Event]] = {}
    for ev in out.events:
        by_tenant.setdefault(ev.tenant, {})[ev.epoch] = ev
    fam = dict(standing.families())
    qs = torch.from_numpy(standing.qs.astype(np.int64))
    qd = torch.from_numpy(standing.qd.astype(np.int64))
    theta = standing.spec.get("heavy_theta")
    dash_epochs = dashboard_sample(seed, [x.epoch for x in out.dashboards], check.get("dashboard_calls", 4))
    dashes = {x.epoch: x for x in out.dashboards if x.epoch in dash_epochs}
    hot = set(standing.spec["tenants"])
    every = standing.spec.get("every", 1)

    for t in range(tenants):
        ref = Summary(seed, d, w, device)
        events = by_tenant.get(t, {})
        sampled = reach_sample(seed, t, list(events), check.get("reach_ticks", 3)) if "reach" in fam else set()
        want_closure = out.closures.get(t)
        epoch = 0
        if t not in hot:
            # Nothing is asked of it before the end: all its edges at once.
            n = out.batches * stream.batch
            pick = slice(0, n) if tenants == 1 else np.flatnonzero(stream.tenant[:n] == t)
            ref.ingest(torch.from_numpy(stream.src[pick].astype(np.int64)),
                       torch.from_numpy(stream.dst[pick].astype(np.int64)), torch.from_numpy(stream.weight[pick]))
            epoch = int(np.size(stream.src[pick]) > 0)
        for span, mask, any_edges in tenant_batches(stream, t, out.batches if t in hot else 0, tenants):
            if not any_edges:
                continue
            sel = (lambda x: x[span]) if mask is None else (lambda x: x[span][mask])
            ref.ingest(torch.from_numpy(sel(stream.src).astype(np.int64)),
                       torch.from_numpy(sel(stream.dst).astype(np.int64)), torch.from_numpy(sel(stream.weight)))
            epoch += 1
            if epoch % every == 0 and epoch not in events:
                tally.exact_miss += sum(fam.values())  # a due tick whose answers never came
            ev = events.get(epoch)
            if ev is not None:
                if "edge" in fam:
                    tally.add(ev.values["edge"], ref.edge(qs[: fam["edge"]], qd[: fam["edge"]]))
                if "in_flow" in fam:
                    tally.add(ev.values["in_flow"], ref.in_flow(qs[: fam["in_flow"]]))
                if "heavy" in fam:
                    hin, hout, fin, fout, cut = ref.heavy(qs[: fam["heavy"]], theta)
                    for bits, want, flow in ((ev.values["heavy"][0], hin, fin), (ev.values["heavy"][1], hout, fout)):
                        clear = (flow - cut).abs() > HEAVY_MARGIN * cut
                        got = torch.as_tensor(np.asarray(bits)).to(device)
                        tally.exact_miss += int(((got != want) & clear).sum())
                if "reach" in fam and epoch in sampled and ev.values.get("reach") is not None:
                    closure, _ = ref.closure()
                    got = torch.as_tensor(np.asarray(ev.values["reach"])).to(device)
                    tally.exact_miss += int((got != ref.reach(closure, qs[: fam["reach"]], qd[: fam["reach"]])).sum())
                    del closure
            if want_closure is not None and want_closure[0] == epoch:
                closure, k = ref.closure()
                closure_miss += int((want_closure[1].to(device) != closure).sum())
                facts["closure_squarings"][t] = k
                want_closure = None
                del closure
            if t == 0 and epoch in dashes:
                dash, pr = dashes[epoch], traffic["dashboard"]["pagerank"]
                want = ref.pagerank(pr["damping"], pr["iters"])
                got = torch.from_numpy(np.asarray(dash.pagerank, np.float64)).to(device)
                pr_gap = max(pr_gap, float(((got - want).abs() / want.abs()).max()))
                want_tri = ref.triangles()
                tri_gap = max(tri_gap, abs(dash.triangles - want_tri) / max(abs(want_tri), 1.0))
        if t in hot and "reach" in fam and (t not in out.closures or want_closure is not None):
            # A hot tenant whose closure is missing, or at an epoch it never had.
            closure_miss += d * w * w
        if t in out.states:
            for prog, want in zip(out.states.pop(t), (ref.counters, ref.rows, ref.cols)):
                tally.add(prog, want)
        elif epoch:
            # A tenant that took edges and has no state in the output.
            tally.exact_miss += int((ref.counters != 0).sum())
        del ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    numbers = {"exact_miss": tally.exact_miss, "rel_gap": tally.rel_gap}
    if "reach" in fam:
        numbers["closure_miss"] = closure_miss
    if "dashboard" in traffic:
        numbers["pagerank_gap"] = pr_gap
        numbers["triangle_gap"] = tri_gap
    return numbers, facts


def control_outputs(cell, seed: int, inputs, device, low: Precision = CONTROL) -> Outputs:
    """What the control serves in the program's place over every batch of
    ``inputs``: an event at every due tick, reach at the ticks the check
    samples, the last closure, and the dashboard at the calls the check
    samples."""
    cfg, tr = cell.config, cell.traffic
    stream, standing = inputs.stream, inputs.standing
    batches = stream.n_batches
    fam = dict(standing.families())
    qs = torch.from_numpy(standing.qs.astype(np.int64))
    qd = torch.from_numpy(standing.qd.astype(np.int64))
    tenants = cfg.get("tenants", 1)
    every = standing.spec.get("every", 1)
    check_sizes = cell.workload.get("check", {})
    warm, dash_every = tr["warmup_batches"], tr["dashboard"]["every"] if "dashboard" in tr else 0
    events, dashboards, states, closures = [], [], {}, {}
    for t in range(tenants):
        hot = t in standing.spec["tenants"]
        plan = list(tenant_batches(stream, t, batches, tenants))
        n = sum(any_edges for _, _, any_edges in plan)
        due = [e for e in range(1, n + 1) if e % every == 0] if hot else []
        sampled = reach_sample(seed, t, due, check_sizes.get("reach_ticks", 3)) if "reach" in fam else set()
        # The program asks the dashboard after the warm-up and after every
        # ``dash_every``-th batch, at the epoch it has then.
        dash = [e for e in range(1, n + 1) if e == warm or (e > warm and e % dash_every == 0)] \
            if t == 0 and dash_every else []
        picked = dashboard_sample(seed, dash, check_sizes.get("dashboard_calls", 4))
        ref = Summary(seed, cfg["depth"], cfg["width_rows"], device, dtype=low.state)
        epoch = 0
        for span, mask, any_edges in plan:
            if not any_edges:
                continue
            sel = (lambda x: x[span]) if mask is None else (lambda x: x[span][mask])
            ref.ingest(torch.from_numpy(sel(stream.src).astype(np.int64)),
                       torch.from_numpy(sel(stream.dst).astype(np.int64)), torch.from_numpy(sel(stream.weight)))
            epoch += 1
            if epoch in due:
                values = {}
                if "edge" in fam:
                    values["edge"] = ref.edge(qs[: fam["edge"]], qd[: fam["edge"]]).cpu().numpy()
                if "in_flow" in fam:
                    values["in_flow"] = ref.in_flow(qs[: fam["in_flow"]]).cpu().numpy()
                if "heavy" in fam:
                    hin, hout, *_ = ref.heavy(qs[: fam["heavy"]], standing.spec["heavy_theta"])
                    values["heavy"] = (hin.cpu().numpy(), hout.cpu().numpy())
                if epoch in sampled:
                    closure, _ = ref.closure(short=low.closure_short)
                    values["reach"] = ref.reach(closure, qs[: fam["reach"]], qd[: fam["reach"]]).cpu().numpy()
                events.append(Event(t, epoch, values))
            if epoch in dash:
                pr = tr["dashboard"]["pagerank"]
                dashboards.append(Dashboard(epoch, None, 0.0) if epoch not in picked else Dashboard(
                    epoch, ref.pagerank(pr["damping"], pr["iters"], analytics=low.analytics).cpu().numpy(),
                    ref.triangles(analytics=low.analytics)))
        if hot and "reach" in fam:
            closures[t] = (epoch, ref.closure(short=low.closure_short)[0])
        if epoch:
            states[t] = (ref.counters.float(), ref.rows.float(), ref.cols.float())
        del ref
    return Outputs(events, dashboards, states, closures, batches)


def controls(cell) -> Dict[str, Precision]:
    """The control, and where the mix has a dashboard the analytics' step
    alone, which tells apart the dashboard's own limits."""
    out = {"control": CONTROL}
    if "dashboard" in cell.traffic:
        out["control_tf32"] = CONTROL_TF32
    return out
