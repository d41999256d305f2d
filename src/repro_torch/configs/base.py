"""Architecture registry: every assigned arch is a selectable config
(``--arch <id>``) carrying its FULL published config, a reduced SMOKE config
(same family, tiny dims), and its assigned input-shape set.

Shape cells marked ``skip`` record rule-driven inapplicability (e.g.
long_500k on pure full-attention archs) — see DESIGN.md Section 5.

Port of ``src/repro/configs/base.py``: the same ids, shape ladders and
cells; ``load_all`` imports ``repro_torch.configs.*``, whose configs are
the port's dataclasses (dtypes as ``torch.dtype``).  The triplet budget
lives in ``repro_torch/data/graphs.py`` and is imported from there.  The
registry loads every config whenever one asked for is missing: the
reference loads only when it is empty, so after ``repro.configs.glava``
alone is imported its ``get_arch("bert4rec")`` raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

from repro_torch.data.graphs import TRIPLET_CAP, TRIPLET_FACTOR, triplet_budget  # noqa: F401

ARCH_IDS = [
    "mixtral-8x22b",
    "arctic-480b",
    "qwen3-4b",
    "olmo-1b",
    "granite-8b",
    "dimenet",
    "graphsage-reddit",
    "gat-cora",
    "schnet",
    "bert4rec",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train|prefill|decode|gnn_full|gnn_minibatch|gnn_molecule|
    #                    recsys_train|recsys_serve|recsys_retrieval
    params: Dict[str, Any]
    skip: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str        # lm | gnn | recsys
    config: Any
    smoke_config: Any
    shapes: Dict[str, ShapeSpec]
    notes: str = ""

    def cells(self):
        return [(self.arch_id, s) for s in self.shapes]


# -- LM shape set (seq_len × global_batch; decode/long lower serve_step) ----


def lm_shapes(sliding_window: Optional[int]) -> Dict[str, ShapeSpec]:
    skip_long = (
        None
        if sliding_window is not None
        else "pure full-attention arch: long_500k needs sub-quadratic attention "
        "(DESIGN.md Section 5); SWA/SSM archs only"
    )
    return {
        "train_4k": ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        "prefill_32k": ShapeSpec(
            "prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)
        ),
        "decode_32k": ShapeSpec(
            "decode_32k", "decode", dict(seq_len=32768, global_batch=128)
        ),
        "long_500k": ShapeSpec(
            "long_500k", "decode", dict(seq_len=524288, global_batch=1), skip=skip_long
        ),
    }


# -- GNN shape set ----------------------------------------------------------


def gnn_shapes() -> Dict[str, ShapeSpec]:
    return {
        "full_graph_sm": ShapeSpec(
            "full_graph_sm",
            "gnn_full",
            dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
        ),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg",
            "gnn_minibatch",
            dict(
                n_graph_nodes=232_965,
                n_graph_edges=114_615_892,
                batch_nodes=1024,
                fanouts=(15, 10),
                d_feat=602,
                n_classes=41,
            ),
        ),
        "ogb_products": ShapeSpec(
            "ogb_products",
            "gnn_full",
            dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47),
        ),
        "molecule": ShapeSpec(
            "molecule",
            "gnn_molecule",
            dict(n_nodes=30, n_edges=64, batch=128),
        ),
    }


# -- RecSys shape set --------------------------------------------------------


def recsys_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "recsys_train", dict(batch=65536)),
        "serve_p99": ShapeSpec("serve_p99", "recsys_serve", dict(batch=512)),
        "serve_bulk": ShapeSpec("serve_bulk", "recsys_serve", dict(batch=262144)),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "recsys_retrieval", dict(batch=1, n_candidates=1_000_000)
        ),
    }


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def _loaded() -> bool:
    return all(a in _REGISTRY for a in (*ARCH_IDS, "glava"))


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        load_all()
    return _REGISTRY[arch_id]


def all_archs() -> Dict[str, ArchSpec]:
    """Every registered spec, in ``ARCH_IDS`` order, then ``glava``,
    whatever order their modules were imported in."""
    if not _loaded():
        load_all()
    order = [*ARCH_IDS, "glava"]
    return {a: _REGISTRY[a] for a in order + [a for a in _REGISTRY if a not in order]}


def load_all():
    for arch in ARCH_IDS:
        importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    importlib.import_module("repro_torch.configs.glava")


def all_cells(include_skipped: bool = False):
    """The 40 (arch × shape) cells; skipped cells carry their reason."""
    cells = []
    for arch_id, spec in all_archs().items():
        if arch_id == "glava":
            continue
        for shape_name, shape in spec.shapes.items():
            if shape.skip and not include_skipped:
                continue
            cells.append((arch_id, shape_name))
    return cells
