"""Roofline analysis from traced costs, the port of
``src/repro/roofline/analysis.py``.

Three terms per call, NVIDIA H100 SXM data-sheet peaks (:data:`HW`):
  compute    = work / 989e12       (bf16 dense tensor-core peak)
  memory     = bytes / 3.35e12     (HBM3)
  collective = collective bytes / 450e9   (NVLink 4, one direction)

The reference reads XLA's ``cost_analysis()`` of a compiled program and
parses collectives from the post-SPMD HLO.  The port compiles nothing: the
work and bytes come from the cost counter of
``repro_torch.analysis.costlint`` (aten ops counted per their kind, kernel
wrappers by their declared costs, :func:`traced_cost_dict`), the memory from
the counter's fresh allocations on the CPU or the caching allocator's peak
on the card (:func:`memory_dict`), and the collectives from the record each
``distributed/mesh.py::Mesh`` keeps of its all-reduces
(:func:`parse_collectives`).

:func:`model_flops_for` holds the model bundles' formulas
(``src/repro/roofline/analysis.py:265-352``: 6·N·D and 2·N·D for the LMs,
BERT4Rec's encoder and head, the GNNs' dense contractions), arithmetic on a
``launch/steps.py`` bundle's batch shapes, and the sketch plane's
(``src/repro/launch/sketch_dryrun.py:68, :96``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

# NVIDIA H100 SXM5 80GB data-sheet peaks (dense).
HW = dict(
    name="h100_sxm",
    peak_flops_bf16=989e12,   # bf16 tensor-core operations/s, dense
    peak_int8_ops=1979e12,    # int8 tensor-core operations/s, dense
    hbm_bw=3.35e12,           # HBM3 bytes/s
    nvlink_bw=450e9,          # NVLink 4 bytes/s, one direction (900 GB/s both)
    hbm_bytes=80e9,           # HBM3 capacity
)

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def traced_cost_dict(counter) -> Dict[str, float]:
    """A cost counter's totals in the reference's ``cost_analysis()`` keys:
    ``"flops"`` holds the counted work, ``"bytes accessed"`` the bytes."""
    return {"flops": float(counter.work), "bytes accessed": float(counter.bytes), "work": float(counter.work)}


def memory_dict(counter=None, *, state_bytes: int = 0, cuda_peak_bytes: Optional[int] = None) -> Dict[str, int]:
    """Memory of one traced call.  On the CPU from the counter's fresh
    allocations (``alloc_bytes`` in all, ``max_alloc_bytes`` the largest
    one, ``peak_live_bytes`` the most alive at once); on the card
    ``cuda_peak_bytes``, the rise of ``torch.cuda.max_memory_allocated``
    over the call, is the live peak.  ``peak_bytes_per_device_est`` adds the
    resident state (the counters), the counterpart of the reference's
    ``args + output - alias + temp``."""
    out: Dict[str, int] = {"state_bytes": int(state_bytes)}
    if counter is not None:
        out.update(
            alloc_bytes=int(counter.alloc_bytes),
            max_alloc_bytes=int(counter.max_alloc_bytes),
            peak_live_bytes=int(counter.peak_live_bytes),
        )
    if cuda_peak_bytes is not None:
        out["peak_live_bytes"] = int(cuda_peak_bytes)
    out["peak_bytes_per_device_est"] = out["state_bytes"] + out.get("peak_live_bytes", 0)
    return out


def parse_collectives(records: Iterable[Dict]) -> Dict[str, Dict[str, float]]:
    """Per-collective {count, bytes} of wire traffic PER RANK from a mesh's
    record of its calls (``Mesh.collectives``: each call's op, payload bytes
    S and group size g), with the reference's bandwidth-optimal ring model:
    all-reduce 2·S·(g−1)/g (a reduce-scatter then an all-gather), the other
    gathers and scatters S·(g−1)/g.  A group of one moves nothing.  The port
    runs only ``all_reduce`` (``distributed/mesh.py``)."""
    out: Dict[str, Dict[str, float]] = {k: {"count": 0, "bytes": 0.0} for k in _COLLECTIVES}
    for rec in records:
        op = rec["op"].replace("_", "-")
        g = max(int(rec["group_size"]), 1)
        nbytes = float(rec["bytes"])
        if op == "all-reduce":
            nbytes *= 2.0
        if op != "collective-permute":
            nbytes *= (g - 1) / g
        out[op]["count"] += 1
        out[op]["bytes"] += nbytes
    return out


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: Optional[float]  # None: the collectives are not modelled
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: Optional[float]
    model_flops: float
    n_chips: int
    useful_ratio: Optional[float]  # MODEL_FLOPS / (counted work × ranks)

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Roofline lower bound on the call's time (no overlap assumption: max)."""
        return max(self._terms().values())

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound spent on useful model math:
        MODEL_FLOPS / (ranks × peak × step_time_lb)."""
        if self.step_time_lb == 0:
            return 0.0
        return self.model_flops / (self.n_chips * HW["peak_flops_bf16"] * self.step_time_lb)

    def to_dict(self):
        return {
            **dataclasses.asdict(self),
            "dominant": self.dominant,
            "step_time_lb": self.step_time_lb,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_from_cost(
    cost: Dict[str, float],
    collectives: Optional[Dict[str, Dict[str, float]]],
    n_chips: int,
    model_flops: float,
) -> Roofline:
    """The three terms of one call; ``collectives=None`` (not modelled, as
    in the model dry run) leaves the collective term out, where an empty
    dict reads as 0 s."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll_bytes = None if collectives is None else sum(v["bytes"] for v in collectives.values())
    total_flops = flops * n_chips
    return Roofline(
        compute_s=flops / HW["peak_flops_bf16"],
        memory_s=nbytes / HW["hbm_bw"],
        collective_s=None if coll_bytes is None else coll_bytes / HW["nvlink_bw"],
        flops_per_chip=flops,
        bytes_per_chip=nbytes,
        collective_bytes_per_chip=coll_bytes,
        model_flops=model_flops,
        n_chips=n_chips,
        useful_ratio=(model_flops / total_flops) if total_flops else None,
    )


def model_flops_for(bundle=None, *, config=None, batch: Optional[int] = None,
                    queries: Optional[int] = None) -> float:
    """MODEL_FLOPS of a model ``bundle`` (``launch/steps.py``): 6·N·D for
    training (N = active parameters, D = tokens), 2·N·D for forward-only
    serving; BERT4Rec's encoder and head; the GNNs' dense contractions.  Of
    the sketch plane (``src/repro/launch/sketch_dryrun.py``), given its
    ``config``: an ingest batch of B edges counts the one-hot formulation
    ``2·d·B·(w_r + w_c)``, Q edge queries ``2·d·Q``."""
    if bundle is not None:
        return _bundle_model_flops(bundle)
    if config is None or (batch is None) == (queries is None):
        raise ValueError("give a bundle, or a sketch config and one of batch= or queries=")
    if batch is not None:
        return 2.0 * config.depth * batch * (config.width_rows + config.width_cols)
    return 2.0 * config.depth * queries


def _bundle_model_flops(bundle) -> float:
    cfg = bundle.config
    kind = bundle.kind
    specs = bundle.batch_specs

    def n_tokens_lm():
        if kind == "train":
            b, s1 = specs["tokens"].shape
            return b * (s1 - 1)
        if kind == "prefill":
            b, s = specs["tokens"].shape
            return b * s
        return specs["token"].shape[0]  # decode: 1 token per sequence

    if hasattr(cfg, "active_param_count"):
        n = cfg.active_param_count()
        d = n_tokens_lm()
        return (6.0 if kind == "train" else 2.0) * n * d
    if hasattr(cfg, "param_count"):  # bert4rec
        # embedding rows are GATHERED, not multiplied: count the transformer
        # math and the scoring matmul explicitly.
        b, s = specs["items"].shape
        d_model = cfg.embed_dim
        per_tok = cfg.n_blocks * (8 * d_model**2 + 16 * d_model**2 + 4 * s * d_model)
        enc = b * s * per_tok
        if kind == "recsys_train":
            m = specs["mask_positions"].shape[1]
            k = specs["negatives"].shape[0]
            head = 2.0 * b * m * (k + 1) * d_model
            return 3.0 * (enc + head)
        if kind == "recsys_retrieval":
            c = specs["candidates"].shape[1]
            return enc + 2.0 * b * c * d_model
        return enc + 2.0 * b * cfg.vocab * d_model  # score all items
    return _gnn_model_flops(bundle)


def _gnn_model_flops(bundle) -> float:
    """Analytic matmul FLOPs of the GNN forward (×3 for train: bwd ≈ 2×fwd).
    Counts dense contractions only (gather/scatter are bytes, not FLOPs)."""
    cfg = bundle.config
    g = bundle.batch_specs["graph"]
    n = g["node_feat"].shape[0]
    e = g["edge_src"].shape[0]
    name = type(cfg).__name__
    if name == "SAGEConfig":
        f = 0.0
        d_prev = cfg.d_in
        for _ in range(cfg.n_layers):
            f += 2.0 * n * d_prev * cfg.d_hidden * 2  # self + neigh
            f += e * d_prev                            # mean aggregation adds
            d_prev = cfg.d_hidden
        f += 2.0 * n * cfg.d_hidden * cfg.out_dim
    elif name == "GATConfig":
        f = 0.0
        d_prev = cfg.d_in
        for i in range(cfg.n_layers):
            d_out = cfg.out_dim if i == cfg.n_layers - 1 else cfg.d_hidden
            f += 2.0 * n * d_prev * cfg.n_heads * d_out
            f += 6.0 * e * cfg.n_heads * d_out  # scores + weighted messages
            d_prev = cfg.n_heads * d_out
    elif name == "SchNetConfig":
        d = cfg.d_hidden
        f = 0.0
        for _ in range(cfg.n_interactions):
            f += 2.0 * e * (cfg.n_rbf * d + d * d)  # filter MLP
            f += 2.0 * n * d * d                     # w_in
            f += 2.0 * e * d                         # message mult + scatter
            f += 2.0 * n * (d * d + d * d)           # out MLP
        f += 2.0 * n * (d * d // 2 + (d // 2) * cfg.out_dim)
    elif name == "DimeNetConfig":
        fdim = cfg.d_hidden
        s = cfg.n_spherical * cfg.n_radial
        t = g["triplets"]["in"].shape[0] if "triplets" in g else 0
        f = 2.0 * e * (3 * fdim * fdim + fdim * fdim + cfg.n_radial * fdim)
        for _ in range(cfg.n_blocks):
            f += 2.0 * e * fdim * fdim                     # w_msg
            f += 2.0 * e * fdim * cfg.n_bilinear           # w_down (gathered)
            f += 2.0 * t * s * cfg.n_bilinear              # bilinear (sbf)
            f += 2.0 * t * cfg.n_bilinear * fdim           # bilinear (out)
            f += 2.0 * e * 2 * fdim * fdim                 # update MLP
            f += 2.0 * e * cfg.n_radial * fdim             # rbf gates
            f += 2.0 * n * (fdim * fdim + fdim * cfg.out_dim)
    else:
        raise ValueError(name)
    return (3.0 if bundle.is_train else 1.0) * f
