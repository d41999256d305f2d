"""gLava × GraphSAGE: train on a STREAMED graph where exact degrees are
unavailable — the neighbor sampler's importance weights come from sketch
point queries.

Port of ``examples/gnn_sketch_sampling.py``, run as ``python -m
repro_torch.launch.gnn_sketch_sampling [--device cpu] [--steps N]``.  It
streams a synthetic citation graph's edges through a
:class:`~repro_torch.integration.sketch_sampler.StreamingDegreeSketch` (the
ingest kernel B1 on the card), draws seeds weighted by the sketch's degree
estimates, samples fanout subgraphs on the host and trains GraphSAGE with
``torch.autograd`` gradients and ``apply_adamw``, printing the example's
lines.  It runs on the CUDA device unless ``device="cpu"`` is given.  Node
features stay on the device and each step gathers its subgraph's rows
there (the reference gathers them on the host; the values are the same).

:func:`main` takes the example's settings as keywords (the graph's size,
the sketch, the widths, fanouts and batch), so larger runs share the loop;
``params=`` and ``sketch=`` start it from given parameters and an empty
sketch of a given hash family (a parity test carries the reference's
across).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sketch import GLavaSketch, SketchConfig
from repro_torch.data.graphs import citation_graph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.integration.sketch_sampler import StreamingDegreeSketch, sketch_weighted_seeds
from repro_torch.models.gnn import graphsage
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.gnn.sampler import CSRGraph, sample_subgraph
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import value_and_grad

# The example's settings.
N, E, F, C = 2000, 12000, 32, 5
SKETCH = SketchConfig(depth=4, width_rows=512, width_cols=512)
FANOUTS = (5, 5)
BATCH = 64
STEPS = 120
OBSERVE_BATCH = 4096


@dataclasses.dataclass
class GNNRun:
    """What a run leaves: per-step losses, seed accuracies and host seconds
    (each ending in a host read of the loss), the degree estimates against
    the exact in-degrees, the trained state, and the host seconds of the
    set-up (``graph_s``, ``csr_s``, ``stream_s``: the sketch pass, ending in
    the estimates' host read)."""

    losses: List[float]
    accs: List[float]
    step_s: List[float]
    estimates: np.ndarray
    exact: np.ndarray
    corr: float
    cfg: graphsage.SAGEConfig
    params: Any
    opt: opt_mod.AdamWState
    degrees: StreamingDegreeSketch
    timings: dict


def loss_fn(cfg: graphsage.SAGEConfig, n_seeds: int) -> Callable:
    """The example's loss: cross-entropy of the seeds' logits (the first
    ``n_seeds`` nodes of the subgraph), with the logits as aux."""

    def fn(params, batch):
        logits = graphsage.forward(cfg, params, batch["graph"])[:n_seeds].to(torch.float32)
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, 1, batch["labels"][:, None].long())[:, 0]
        return torch.mean(logz - gold), logits

    return fn


def train_step(cfg, opt_cfg, params, opt, graph: GraphBatch, labels: torch.Tensor):
    """One step: ``(params, opt, loss, seed accuracy)``."""
    (loss, logits), grads = value_and_grad(loss_fn(cfg, labels.shape[0]), params, {"graph": graph, "labels": labels})
    params, opt, _ = opt_mod.apply_adamw(opt_cfg, opt, params, grads)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return params, opt, loss, acc


def device_batch(sub: dict, feats: torch.Tensor) -> GraphBatch:
    """A sampled subgraph (numpy, without features) on ``feats``'s device,
    its node features gathered there."""
    device = feats.device
    nodes = torch.from_numpy(sub["nodes"]).to(device)
    return GraphBatch(
        node_feat=feats[nodes.long()],
        edge_src=torch.from_numpy(sub["edge_src"]).to(device),
        edge_dst=torch.from_numpy(sub["edge_dst"]).to(device),
        node_mask=torch.from_numpy(sub["node_mask"]).to(device),
        edge_mask=torch.from_numpy(sub["edge_mask"]).to(device),
    )


def main(
    device: DeviceLike = None,
    steps: int = STEPS,
    *,
    n_nodes: int = N,
    n_edges: int = E,
    d_feat: int = F,
    n_classes: int = C,
    d_hidden: int = 32,
    sketch_config: SketchConfig = SKETCH,
    fanouts: Sequence[int] = FANOUTS,
    batch: int = BATCH,
    observe_batch: int = OBSERVE_BATCH,
    params: Any = None,
    sketch: Optional[GLavaSketch] = None,
    log: Callable[[str], None] = print,
) -> GNNRun:
    """The example's run: ``steps`` steps of its 120-step schedule, every
    draw from ``default_rng(0)``."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    g = citation_graph(n_nodes, n_edges, d_feat, n_classes, rng)
    t1 = time.perf_counter()
    csr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n_nodes)
    t2 = time.perf_counter()

    # --- stream the edges through a gLava sketch (one pass) -----------------
    degrees = StreamingDegreeSketch(sketch_config, device=device)
    if sketch is not None:
        degrees.sketch = sketch.to(device)
    for lo in range(0, n_edges, observe_batch):
        degrees.observe(g["edge_src"][lo:lo + observe_batch], g["edge_dst"][lo:lo + observe_batch])
    est = degrees.degree_estimates(np.arange(n_nodes, dtype=np.uint32), direction="in")
    timings = {"graph_s": t1 - t0, "csr_s": t2 - t1, "stream_s": time.perf_counter() - t2}
    exact = np.bincount(g["edge_dst"], minlength=n_nodes)
    corr = float(np.corrcoef(est, exact)[0, 1])
    log(f"[gnn] sketch degree estimates: corr(est, exact) = {corr:.3f} "
        f"(over-estimates: {np.all(est >= exact - 1e-5)})")

    # --- sketch-weighted seeds -> fanout sampling -> SAGE training ------------
    cfg = graphsage.SAGEConfig(name="sage-stream", n_layers=2, d_in=d_feat, d_hidden=d_hidden, out_dim=n_classes)
    if params is None:
        params = graphsage.init_params(cfg, torch.Generator().manual_seed(0), device)
    opt_cfg = opt_mod.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=STEPS, weight_decay=0.0)
    opt = opt_mod.init_adamw(opt_cfg, params)
    feats = torch.from_numpy(g["node_feat"]).to(device)
    labels_all = torch.from_numpy(g["labels"]).to(device)
    losses, accs, step_s = [], [], []
    acc = float("nan")
    for step in range(steps):
        t0 = time.perf_counter()
        seeds = sketch_weighted_seeds(degrees, n_nodes, batch, rng, alpha=0.5)
        sub = sample_subgraph(csr, seeds, fanouts, rng)
        labels = labels_all[torch.from_numpy(seeds).to(device).long()]
        params, opt, loss, acc_t = train_step(cfg, opt_cfg, params, opt, device_batch(sub, feats), labels)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        acc = float(acc_t)
        accs.append(acc)
        if step % 20 == 0:
            log(f"[gnn] step {step:3d} loss={losses[-1]:.3f} seed-acc={acc:.2f}")
    log(f"[gnn] final seed accuracy {acc:.2f} (chance {1 / n_classes:.2f}) — trained "
        "entirely with sketch-estimated degrees")
    return GNNRun(losses, accs, step_s, est, exact, corr, cfg, params, opt, degrees, timings)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.gnn_sketch_sampling")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


if __name__ == "__main__":
    args = build_parser().parse_args()
    main(args.device, args.steps)
