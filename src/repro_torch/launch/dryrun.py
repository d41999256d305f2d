"""Dry run of every (architecture × input shape × mesh) cell on the
production meshes.  Port of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell's partitioned program on 512
placeholder devices (``.lower().compile()``) and reads XLA's
``memory_analysis()``, ``cost_analysis()`` and the collectives of the
post-SPMD HLO.  The port has no SPMD partitioner; each part of a record
maps as follows:

- ``modeled_memory``: the state's and the inputs' bytes a device holds,
  exact from the :class:`~repro_torch.distributed.sharding.Placement`s that
  ``resolve_tree`` gives on the abstract production mesh; the LM train
  step's remat carry estimated from the layer carry's layout
  (``act_pspec``: the mesh's own dp and model sizes; the reference divides
  by a literal 16 twice, ``src/repro/launch/dryrun.py:57``, so on
  ``pod2x16x16`` it ignores the pod axis).  The fit check is against one
  H100's memory (``fits_hbm``, ``hbm_bytes``).
- ``cost``: the step's work and bytes counted by
  ``analysis/costlint.py::CostCounter`` on ``meta`` tensors at the full
  global shapes, divided by the mesh's devices (``cost_basis`` says so).
  An LM cell is counted at depths 1 and 2 and fitted affinely to its depth
  (:func:`extrapolate_lm_cost`, as the reference does for its roofline):
  the layers are identical, so the fit is exact, and it counts 3 layers in
  place of up to 56.  The count does not depend on the mesh, so both
  meshes of a cell share one.
- ``collectives``: not modelled (``null``, with the reason), never an
  empty dict, which would read as a collective term of 0 s; the roofline's
  ``dominant`` is then chosen between compute and memory.
- ``memory``: the counter's peak of fresh allocations alive at once, for
  the global program on one device (not partitioned).
- Timing: one ``count_s`` in place of ``lower_s`` and ``compile_s``.

The reference's ``--save-hlo`` has no counterpart.  Records land in
``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` and resume cell by
cell with ``--skip-done``.  ``meta`` tensors need no card, so the dry run
runs on any host::

    python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis.costlint import CostCounter
from repro_torch.analysis.dispatch_lint import Recorder
from repro_torch.configs import all_cells, get_arch
from repro_torch.distributed.mesh import n_devices
from repro_torch.distributed.sharding import ResolveReport, resolve_tree
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.roofline.analysis import HW, model_flops_for, roofline_from_cost
from repro_torch.tree import tree_leaves

OUT = "results/dryrun_torch"
COLLECTIVES_NOTE = ("not modelled: the port has no SPMD partitioner, so no partitioned program whose collectives "
                    "could be counted")
MEMORY_NOTE = ("the cost counter's peak of fresh allocations alive at once, the global program on one device "
               "(not partitioned); the state and the batch are not in it (see modeled_memory)")


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _sharded_bytes(shape_tree, placement_tree) -> int:
    """Exact per-device bytes of a tree of tensors under its placements."""
    return sum(math.prod(pl.block_shape(t.shape)) * t.element_size()
               for t, pl in zip(tree_leaves(shape_tree), tree_leaves(placement_tree), strict=True))


def modeled_memory(bundle, state_meta, state_pl, batch_pl) -> dict:
    """Analytic per-device memory: the state and the inputs EXACT from their
    placements; the LM train step's remat carry (one (B/dp, S/model, D)
    block a layer, in the compute dtype) estimated."""
    state_b = _sharded_bytes(state_meta, state_pl)
    batch_b = _sharded_bytes(bundle.batch_specs, batch_pl)
    act_b = 0
    cfg = bundle.config
    if bundle.kind == "train" and hasattr(cfg, "n_layers") and hasattr(cfg, "d_model"):
        b, s1 = bundle.batch_specs["tokens"].shape
        carry = (b, s1 - 1, cfg.d_model)
        block = carry if cfg.act_pspec is None else cfg.act_pspec.block_shape(carry)
        itemsize = torch.empty((), dtype=cfg.compute_dtype, device="meta").element_size()
        act_b = math.prod(block) * itemsize * cfg.n_layers
    total = state_b + batch_b + act_b
    return {
        "state_bytes_per_device": state_b,
        "input_bytes_per_device": batch_b,
        "activation_bytes_per_device_est": act_b,
        "modeled_total_per_device": total,
        "hbm_bytes": HW["hbm_bytes"],
        "fits_hbm": total <= HW["hbm_bytes"],
    }


def count_step(bundle) -> Dict[str, float]:
    """One step of a ``meta`` bundle under the cost counter: its work and
    bytes (in the reference's ``cost_analysis()`` keys) and its peak of
    fresh allocations alive at once."""
    counter = CostCounter()
    with Recorder(counter):
        out = bundle.step(bundle.state_specs(), bundle.input_specs())
    del out
    return {"flops": float(counter.work), "bytes accessed": float(counter.bytes), "work": float(counter.work),
            "peak_live_bytes": float(counter.peak_live_bytes)}


def extrapolate_lm_cost(arch: str, shape: str, mesh=None, optimized: bool = False):
    """An LM step's global count at its real depth: count the model at
    ``n_layers`` 1 and 2 and fit ``a + b·L`` (the layers are identical, so
    the count is affine in L).  Returns (cost, collectives, detail); the
    collectives are not modelled (``None``)."""
    full_cfg = get_arch(arch).config
    L = full_cfg.n_layers
    costs = {}
    for k in (1, 2):
        cfg_k = dataclasses.replace(full_cfg, n_layers=k)
        b = build_step(arch, shape, mesh=mesh, config_override=cfg_k, optimized=optimized, device="meta")
        costs[k] = count_step(b)

    def fit(m1, m2):
        bb = m2 - m1
        return m1 - bb + bb * L  # a + b*L with a = m1 - b

    cost_L = {key: float(fit(costs[1][key], costs[2][key])) for key in costs[1]}
    return cost_L, None, {"depths_counted": [1, 2], "extrapolated_to": L}


def global_cost(arch: str, shape: str, mesh) -> Tuple[Dict[str, float], Optional[dict]]:
    """The cell's count on ``meta`` at the full global shapes (an LM's by
    :func:`extrapolate_lm_cost`) and the extrapolation's detail."""
    if get_arch(arch).family == "lm":
        cost, _, detail = extrapolate_lm_cost(arch, shape, mesh)
        return cost, detail
    return count_step(build_step(arch, shape, mesh=mesh, device="meta")), None


def run_cell(arch: str, shape: str, multi_pod: bool, outdir: Path, counts: Optional[dict] = None):
    """One cell's record, written to ``outdir``.  ``counts`` caches each
    (arch, shape)'s global count across meshes."""
    name = mesh_name(multi_pod)
    out_path = outdir / f"{arch}__{shape}__{name}.json"
    mesh = make_production_mesh(multi_pod=multi_pod)
    n = n_devices(mesh)
    rec = {"arch": arch, "shape": shape, "mesh": name, "n_devices": n, "status": "running"}
    sh = get_arch(arch).shapes[shape]
    if sh.skip:
        rec.update(status="skipped", skip_reason=sh.skip)
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] SKIP {arch}/{shape}: {sh.skip}")
        return rec

    bundle = build_step(arch, shape, mesh=mesh, device="meta")
    report = ResolveReport()
    state_meta = bundle.state_specs()
    state_pl = resolve_tree(bundle.state_logical, state_meta, mesh, report=report)
    batch_pl = resolve_tree(bundle.batch_logical, bundle.batch_specs, mesh, report=report)
    rec["sharding_fallbacks"] = report.fallbacks
    rec["notes"] = bundle.notes
    rec["modeled_memory"] = modeled_memory(bundle, state_meta, state_pl, batch_pl)

    counts = {} if counts is None else counts
    t0 = time.time()
    if (arch, shape) not in counts:
        counts[(arch, shape)] = global_cost(arch, shape, mesh)
    rec["count_s"] = round(time.time() - t0, 2)
    cost_global, detail = counts[(arch, shape)]
    if detail is not None:
        rec["cost_extrapolation"] = detail
    cost = {k: v / n for k, v in cost_global.items() if k != "peak_live_bytes"}
    rf = roofline_from_cost(cost, None, n, model_flops_for(bundle))
    rec.update(
        status="ok",
        memory={"peak_live_bytes": int(cost_global["peak_live_bytes"]), "note": MEMORY_NOTE},
        cost=cost,
        cost_global={k: v for k, v in cost_global.items() if k != "peak_live_bytes"},
        cost_basis=(f"aten ops counted on meta tensors at the full global shapes ("
                    + ("depths 1 and 2 fitted to the model's depth" if detail else "the whole step")
                    + f"), divided by the mesh's {n} devices"),
        collectives=None,
        collectives_note=COLLECTIVES_NOTE,
        roofline=rf.to_dict(),
    )
    out_path.write_text(json.dumps(rec, indent=2))
    mm = rec["modeled_memory"]
    print(f"[dryrun] OK {arch}/{shape}/{name}: count={rec['count_s']}s dominant={rf.dominant} "
          f"frac={rf.roofline_fraction:.3f} modeled/dev={mm['modeled_total_per_device'] / 1e9:.2f}GB "
          f"({'FITS' if mm['fits_hbm'] else 'OVER'} {HW['hbm_bytes'] / 1e9:.0f} GB)")
    return rec


def run(cells, meshes, outdir: Path, skip_done: bool = False):
    """Every (cell, mesh); a failed cell is recorded with its traceback.
    Returns (records, failures)."""
    outdir.mkdir(parents=True, exist_ok=True)
    counts: dict = {}
    records, failures = [], []
    for arch, shape in cells:
        for mp in meshes:
            name = mesh_name(mp)
            out_path = outdir / f"{arch}__{shape}__{name}.json"
            if skip_done and out_path.exists():
                try:
                    if json.loads(out_path.read_text()).get("status") in ("ok", "skipped"):
                        print(f"[dryrun] cached {arch}/{shape}/{name}")
                        continue
                except json.JSONDecodeError:
                    pass
            try:
                records.append(run_cell(arch, shape, mp, outdir, counts))
            except Exception as e:  # record the failure; it is a bug to fix
                failures.append((arch, shape, name, repr(e)))
                out_path.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": name, "status": "failed", "error": repr(e),
                    "traceback": traceback.format_exc()[-4000:],
                }, indent=2))
                print(f"[dryrun] FAIL {arch}/{shape}/{name}: {e!r}")
    return records, failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)
    cells = all_cells(include_skipped=True) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    _, failures = run(cells, meshes, Path(args.out), args.skip_done)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", *f[:3], f[3][:200])
        raise SystemExit(1)
    print("[dryrun] all requested cells OK")


if __name__ == "__main__":
    main()
