"""Carry a reference's state across to the port.

The JAX package's ``GLavaSketch`` is a pytree whose leaves, read out as
numpy arrays, are ``counters``, ``row_flows``, ``col_flows`` and the hash
coefficients ``row_hash.a``/``row_hash.b`` (plus ``col_hash.a``/``.b`` when
the sketch is non-square).  :func:`sketch_from_arrays` builds the port's
:class:`~repro_torch.core.sketch.GLavaSketch` from exactly those arrays, so
both sides hash identically; ``GraphStream.open(sketch=...)`` opens a
session on it.  :func:`sketch_shard_from_arrays` builds one rank's shard of
it for the distributed plane (its rows of the counters over a mesh's
``model`` axis).  A reference ``SlidingWindowSketch`` converts the same way
(:func:`window_from_arrays`: the ring, its registers, the current slot and
the template's hash coefficients), a reference ``FleetSketch`` too
(:func:`fleet_from_arrays`: the stacked counters, registers and cursors and
the shared hash coefficients), and so does a checkpoint, whose hash
leaves are uint32 on disk (``checkpoint/manager.py`` loads sketches and
windows through these two functions).

The four baselines convert from their leaves too
(:func:`countmin_from_arrays`, :func:`node_countmin_from_arrays`,
:func:`countsketch_from_arrays`, :func:`gsketch_from_arrays`): counters,
hash coefficients, and gSketch's widths and partition hash.

The training side converts the same way: a transformer's parameter tree
(:func:`transformer_params_from_arrays`), a GraphSAGE, GAT, SchNet,
DimeNet or BERT4Rec parameter tree (:func:`graphsage_params_from_arrays`,
:func:`gat_params_from_arrays`, :func:`schnet_params_from_arrays`,
:func:`dimenet_params_from_arrays`, :func:`bert4rec_params_from_arrays`:
the reference's names and layouts, checked leaf by leaf), an AdamW state
(:func:`adamw_state_from_arrays`) and a gradient compressor's state
(:func:`compressor_state_from_arrays`), each from the reference's leaves
read out as numpy arrays (bfloat16 leaves as float32: the widening is
exact).  This module takes numpy only and never imports the reference.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.hashing import HashFamily
from repro_torch.core.sketch import CountMin, CountSketch, GLavaSketch, GSketch, NodeCountMin, SketchConfig
from repro_torch.core.window import SlidingWindowSketch
from repro_torch.models.gnn import dimenet, gat, graphsage, schnet
from repro_torch.models.recsys import bert4rec
from repro_torch.models.recsys.bert4rec import Bert4RecConfig
from repro_torch.models.transformer import TransformerConfig, param_shapes
from repro_torch.train.compression import CompressorConfig, CompressorState
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.tree import tree_map


def sketch_from_arrays(
    config: SketchConfig,
    counters: np.ndarray,
    row_flows: np.ndarray,
    col_flows: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    col_a: Optional[np.ndarray] = None,
    col_b: Optional[np.ndarray] = None,
    device: Optional[torch.device] = None,
) -> GLavaSketch:
    """A port sketch on ``device`` from the reference's leaves.  Square
    configs share one family (``col_a``/``col_b`` must then be omitted or
    equal to the row coefficients)."""
    d, wr, wc = config.depth, config.width_rows, config.width_cols
    if np.shape(counters) != (d, wr, wc):
        raise ValueError(f"counters shape {np.shape(counters)} != {(d, wr, wc)}")
    row_hash, col_hash = _sketch_families(config, row_a, row_b, col_a, col_b, device)
    return GLavaSketch(
        _tensor(counters, torch.float32, device), row_hash, col_hash, config,
        _tensor(row_flows, torch.float32, device), _tensor(col_flows, torch.float32, device),
    )


def sketch_shard_from_arrays(
    config: SketchConfig,
    counters: np.ndarray,
    row_flows: np.ndarray,
    col_flows: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    col_a: Optional[np.ndarray] = None,
    col_b: Optional[np.ndarray] = None,
    *,
    mesh,
    model_axis: str = "model",
    device: Optional[torch.device] = None,
) -> GLavaSketch:
    """This rank's SHARD of a sketch given by the reference's leaves (the
    whole counters): its rows of the counters, split over ``mesh``'s
    ``model_axis`` (``core/distributed.py``), with the whole registers and
    the hash families, on ``device``.  Only the rank's rows are copied."""
    from repro_torch.core.distributed import counter_placement, rows_per_shard
    from repro_torch.distributed.sharding import local_shard

    d, wr, wc = config.depth, config.width_rows, config.width_cols
    if np.shape(counters) != (d, wr, wc):
        raise ValueError(f"counters shape {np.shape(counters)} != {(d, wr, wc)}")
    rows_per_shard(mesh, wr, model_axis)
    rows = local_shard(np.asarray(counters), counter_placement(mesh, model_axis))
    row_hash, col_hash = _sketch_families(config, row_a, row_b, col_a, col_b, device)
    return GLavaSketch(
        _tensor(rows, torch.float32, device), row_hash, col_hash, config,
        _tensor(row_flows, torch.float32, device), _tensor(col_flows, torch.float32, device),
    )


def _sketch_families(config: SketchConfig, row_a, row_b, col_a, col_b, device):
    """The (row, col) hash families of a gLava sketch from its coefficients;
    a square config shares one family."""
    row_hash = HashFamily.from_host(row_a, row_b, config.width_rows, device)
    if config.is_square:
        for given, want in ((col_a, row_a), (col_b, row_b)):
            if given is not None and not np.array_equal(np.asarray(given), np.asarray(want)):
                raise ValueError("a square sketch shares one hash family for rows and columns")
        return row_hash, row_hash
    if col_a is None or col_b is None:
        raise ValueError("a non-square sketch needs col_a and col_b")
    return row_hash, HashFamily.from_host(col_a, col_b, config.width_cols, device)


def window_from_arrays(
    config: SketchConfig,
    slices: np.ndarray,
    current,
    row_flows: np.ndarray,
    col_flows: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    col_a: Optional[np.ndarray] = None,
    col_b: Optional[np.ndarray] = None,
    device: Optional[torch.device] = None,
) -> SlidingWindowSketch:
    """A port sliding window on ``device`` from the reference's leaves: the
    (K, d, w_r, w_c) ring, the current slot (a 0-d int), the per-slice
    registers and the template's hash coefficients (the template's own
    counters are zeros and are not read)."""
    k = np.shape(slices)[0]
    d, wr, wc = config.depth, config.width_rows, config.width_cols
    if np.shape(slices) != (k, d, wr, wc):
        raise ValueError(f"slices shape {np.shape(slices)} != {(k, d, wr, wc)}")
    if np.shape(row_flows) != (k, d, wr) or np.shape(col_flows) != (k, d, wc):
        raise ValueError(f"register shapes {np.shape(row_flows)}, {np.shape(col_flows)} do not fit the ring")
    slot = int(np.asarray(current))
    if not 0 <= slot < k:
        raise ValueError(f"current slot {slot} outside the ring of {k}")
    row_hash, col_hash = _sketch_families(config, row_a, row_b, col_a, col_b, device)
    return SlidingWindowSketch(
        _tensor(slices, torch.float32, device),
        slot,
        SlidingWindowSketch.template_for(config, row_hash, col_hash, device),
        _tensor(row_flows, torch.float32, device),
        _tensor(col_flows, torch.float32, device),
    )


def fleet_from_arrays(
    config: SketchConfig,
    counters: np.ndarray,
    row_flows: np.ndarray,
    col_flows: np.ndarray,
    cursor: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    col_a: Optional[np.ndarray] = None,
    col_b: Optional[np.ndarray] = None,
    device: Optional[torch.device] = None,
) -> "FleetSketch":
    """A port fleet stack on ``device`` from the reference's leaves: the
    (T, K, d, w_r, w_c) counters, the (T, K, d, w_r) and (T, K, d, w_c)
    registers, the (T,) cursors and the shared hash coefficients (a square
    config shares one family)."""
    # Imported here: the fleet package imports the checkpoint manager, which
    # imports this module.
    from repro_torch.fleet.stack import FleetSketch

    t, k = np.shape(counters)[:2]
    d, wr, wc = config.depth, config.width_rows, config.width_cols
    if np.shape(counters) != (t, k, d, wr, wc):
        raise ValueError(f"counters shape {np.shape(counters)} != {(t, k, d, wr, wc)}")
    if np.shape(row_flows) != (t, k, d, wr) or np.shape(col_flows) != (t, k, d, wc):
        raise ValueError(f"register shapes {np.shape(row_flows)}, {np.shape(col_flows)} do not fit the stack")
    if np.shape(cursor) != (t,):
        raise ValueError(f"cursor shape {np.shape(cursor)} != {(t,)}")
    row_hash, col_hash = _sketch_families(config, row_a, row_b, col_a, col_b, device)
    return FleetSketch(
        _tensor(counters, torch.float32, device),
        _tensor(row_flows, torch.float32, device),
        _tensor(col_flows, torch.float32, device),
        torch.from_numpy(np.array(cursor, np.int32, copy=True)).to(device),
        row_hash,
        col_hash,
        config,
    )


def _family(a, b, w: int, depth: int, device) -> HashFamily:
    if np.shape(a) != (depth,) or np.shape(b) != (depth,):
        raise ValueError(f"hash coefficients must be ({depth},), got {np.shape(a)}, {np.shape(b)}")
    return HashFamily.from_host(a, b, w, device)


def countmin_from_arrays(counters, hash_a, hash_b, device: Optional[torch.device] = None) -> CountMin:
    """A port CountMin from the reference's (d, w) counters and hash
    coefficients (d,)."""
    d, w = np.shape(counters)
    return CountMin(_tensor(counters, torch.float32, device), _family(hash_a, hash_b, w, d, device))


def node_countmin_from_arrays(counters_out, counters_in, hash_a, hash_b,
                              device: Optional[torch.device] = None) -> NodeCountMin:
    """A port NodeCountMin from the reference's two (d, w) counters (copied
    into two tensors) and hash coefficients."""
    if np.shape(counters_out) != np.shape(counters_in):
        raise ValueError(f"counters differ in shape: {np.shape(counters_out)}, {np.shape(counters_in)}")
    d, w = np.shape(counters_out)
    return NodeCountMin(
        _tensor(counters_out, torch.float32, device),
        _tensor(counters_in, torch.float32, device),
        _family(hash_a, hash_b, w, d, device),
    )


def countsketch_from_arrays(counters, hash_a, hash_b, device: Optional[torch.device] = None) -> CountSketch:
    """A port CountSketch from the reference's (d, w) counters and hash
    coefficients."""
    d, w = np.shape(counters)
    return CountSketch(_tensor(counters, torch.float32, device), _family(hash_a, hash_b, w, d, device))


def gsketch_from_arrays(counters, hash_a, hash_b, widths, part_a, part_b,
                        device: Optional[torch.device] = None) -> GSketch:
    """A port GSketch from the reference's (k, d, w_max) partition counters,
    the partitions' hash coefficients (d,), the (k,) widths and the
    one-deep partition hash's coefficients (1,)."""
    k, d, w_max = np.shape(counters)
    if np.shape(widths) != (k,) or int(np.max(widths)) > w_max:
        raise ValueError(f"widths must be ({k},) and at most {w_max}, got {np.asarray(widths)}")
    return GSketch(
        CountMin(_tensor(counters, torch.float32, device), _family(hash_a, hash_b, w_max, d, device)),
        torch.from_numpy(np.asarray(widths).astype(np.int32)).to(device),
        _family(part_a, part_b, k, 1, device),
    )


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(np.asarray(x, np.float32), copy=True)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def transformer_params_from_arrays(
    cfg: TransformerConfig, tree: Any, device: Optional[torch.device] = None
) -> dict:
    """The port's parameter tree from the reference's (the same names,
    stacked layers and ``(in, out)`` layout), in ``cfg.param_dtype``."""
    shapes = param_shapes(cfg)
    if tree.keys() != shapes.keys() or tree["layers"].keys() != shapes["layers"].keys():
        raise ValueError(f"parameter names differ from {cfg.name}'s")
    for group, names in (("", shapes), ("layers.", shapes["layers"])):
        for name, shape in names.items():
            leaf = tree["layers"][name] if group else tree[name]
            if name != "layers" and tuple(np.shape(leaf)) != shape:
                raise ValueError(f"{group}{name} has shape {np.shape(leaf)}, {cfg.name} needs {shape}")
    return tree_map(lambda x: _tensor(x, cfg.param_dtype, device), tree)


def _check_tree(tree: Any, shapes: Any, name: str, path: str = "") -> None:
    """Raise unless ``tree`` has the structure of ``shapes`` (nested dicts
    and lists of shape tuples) and every leaf its shape."""
    where = path or "the tree"
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or tree.keys() != shapes.keys():
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{where} has {got}, {name} needs {sorted(shapes)}")
        for k, shape in shapes.items():
            _check_tree(tree[k], shape, name, f"{path}.{k}" if path else k)
    elif isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            raise ValueError(f"{where} is not a list of {len(shapes)}, as {name} needs")
        for i, (t, shape) in enumerate(zip(tree, shapes)):
            _check_tree(t, shape, name, f"{path}[{i}]")
    elif tuple(np.shape(tree)) != tuple(shapes):
        raise ValueError(f"{where} has shape {np.shape(tree)}, {name} needs {tuple(shapes)}")


def _float32_tree(shapes: Any, name: str, tree: Any, device) -> dict:
    _check_tree(tree, shapes, name)
    return tree_map(lambda x: _tensor(x, torch.float32, device), tree)


def graphsage_params_from_arrays(
    cfg: graphsage.SAGEConfig, tree: Any, device: Optional[torch.device] = None
) -> dict:
    """The port's GraphSAGE parameter tree from the reference's (the same
    names, one dict a layer, ``(in, out)`` matrices), in float32."""
    return _float32_tree(graphsage.param_shapes(cfg), cfg.name, tree, device)


def gat_params_from_arrays(cfg: gat.GATConfig, tree: Any, device: Optional[torch.device] = None) -> dict:
    """The port's GAT parameter tree from the reference's (``{"layers":
    [{"w", "a_src", "a_dst"}, ...]}``), in float32."""
    return _float32_tree(gat.param_shapes(cfg), cfg.name, tree, device)


def schnet_params_from_arrays(cfg: schnet.SchNetConfig, tree: Any, device: Optional[torch.device] = None) -> dict:
    """The port's SchNet parameter tree from the reference's (``embed`` or
    ``proj``, the ``blocks`` list, the head's MLP), in float32."""
    return _float32_tree(schnet.param_shapes(cfg), cfg.name, tree, device)


def dimenet_params_from_arrays(cfg: dimenet.DimeNetConfig, tree: Any, device: Optional[torch.device] = None) -> dict:
    """The port's DimeNet parameter tree from the reference's (``w_bil``
    as (s, n_bilinear, f)), in float32."""
    return _float32_tree(dimenet.param_shapes(cfg), cfg.name, tree, device)


def bert4rec_params_from_arrays(cfg: Bert4RecConfig, tree: Any, device: Optional[torch.device] = None) -> dict:
    """The port's BERT4Rec parameter tree from the reference's (the blocks
    stacked on a leading axis), in float32, as the reference stores it."""
    return _float32_tree(bert4rec.param_shapes(cfg), cfg.name, tree, device)


def adamw_state_from_arrays(
    cfg: AdamWConfig, step, m: Any, v: Any, device: Optional[torch.device] = None
) -> AdamWState:
    """An AdamW state from the reference's step counter and moment trees,
    the moments in ``cfg.m_dtype``/``cfg.v_dtype``."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m=tree_map(lambda x: _tensor(x, cfg.m_dtype, device), m),
        v=tree_map(lambda x: _tensor(x, cfg.v_dtype, device), v),
    )


def compressor_state_from_arrays(
    cfg: CompressorConfig,
    error,
    momentum,
    hash_a,
    hash_b,
    device: Optional[torch.device] = None,
) -> CompressorState:
    """A compressor state from the reference's error-feedback vector (n,),
    sketch momentum (d, w) and hash coefficients (d,)."""
    if np.shape(momentum) != (cfg.depth, cfg.width):
        raise ValueError(f"momentum shape {np.shape(momentum)} != {(cfg.depth, cfg.width)}")
    return CompressorState(
        error=_tensor(error, torch.float32, device),
        momentum=_tensor(momentum, torch.float32, device),
        hash=HashFamily.from_host(hash_a, hash_b, cfg.width, device),
        config=cfg,
    )
