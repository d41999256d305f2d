"""Perf runner: measure one (arch × shape) cell's roofline terms under a
named variant and append the hypothesis → record to
``results/perf_torch/<arch>__<shape>.json``.  Port of
``src/repro/launch/perf.py``.

The terms come from the dry run's count on ``meta`` tensors on the
single-pod production mesh (``launch/dryrun.py``: an LM by its depth
extrapolation); the collectives are not modelled.  ``--override`` sets
config fields through ``launch/steps.py::PERF_OVERRIDES``; ``--no-fsdp``
and ``--replicate-inputs`` change the sharding rules, which in the port
move the modeled per-device memory (the count is of the global program);
``--optimized`` switches on the perf levers that run on one device (window
slicing; the sharded forms need a rank mesh)::

    python -m repro_torch.launch.perf --arch mixtral-8x22b --shape prefill_32k \\
        --variant sliced --optimized
"""
from __future__ import annotations

import argparse
import ast
import json
from pathlib import Path

from repro_torch.configs import get_arch
from repro_torch.distributed.mesh import n_devices
from repro_torch.distributed.sharding import ResolveReport, default_rules, resolve_tree
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.dryrun import count_step, extrapolate_lm_cost, modeled_memory
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.roofline.analysis import model_flops_for, roofline_from_cost

OUT = "results/perf_torch"


def measure(arch: str, shape: str, optimized: bool, no_fsdp: bool = False, replicate_inputs: bool = False):
    """(roofline, modeled memory) of one cell on the single-pod mesh."""
    mesh = make_production_mesh()
    rules = default_rules(mesh)
    if no_fsdp:
        rules["embed"] = ()  # params TP-only; opt state follows params
    if replicate_inputs:
        for k in ("nodes", "edges", "triplets"):
            rules[k] = ()
    if get_arch(arch).family == "lm":
        cost, _, _ = extrapolate_lm_cost(arch, shape, mesh, optimized=optimized)
    else:
        cost = count_step(build_step(arch, shape, mesh=mesh, device="meta"))
    n = n_devices(mesh)
    bundle = build_step(arch, shape, mesh=mesh, optimized=optimized, device="meta")
    per_device = {k: v / n for k, v in cost.items() if k != "peak_live_bytes"}
    rf = roofline_from_cost(per_device, None, n, model_flops_for(bundle))
    report = ResolveReport()
    state = bundle.state_specs()
    mem = modeled_memory(bundle, state, resolve_tree(bundle.state_logical, state, mesh, rules, report),
                         resolve_tree(bundle.batch_logical, bundle.batch_specs, mesh, rules, report))
    return rf, mem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, help="label, e.g. baseline | sliced")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true", help="replicate the embed/FSDP dim (TP-only params)")
    ap.add_argument("--replicate-inputs", action="store_true", help="GNN: replicate node/edge inputs")
    ap.add_argument("--override", action="append", default=[], help="config field override, e.g. attn_q_chunk=None")
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / f"{args.arch}__{args.shape}.json"
    log = json.loads(path.read_text()) if path.exists() else {"iterations": []}

    for ov in args.override:
        k, v = ov.split("=", 1)
        steps_mod.PERF_OVERRIDES[k] = ast.literal_eval(v)
    try:
        rf, mem = measure(args.arch, args.shape, args.optimized, args.no_fsdp, args.replicate_inputs)
    finally:
        steps_mod.PERF_OVERRIDES.clear()
    log["iterations"].append({
        "variant": args.variant,
        "optimized_flag": args.optimized,
        "no_fsdp": args.no_fsdp,
        "replicate_inputs": args.replicate_inputs,
        "overrides": args.override,
        "hypothesis": args.hypothesis,
        "roofline": rf.to_dict(),
        "collectives": None,
        "modeled_memory": mem,
    })
    path.write_text(json.dumps(log, indent=2))
    print(f"[perf] {args.arch}/{args.shape} [{args.variant}]: compute={rf.compute_s:.2f}s memory={rf.memory_s:.2f}s "
          f"collective=not modelled dominant={rf.dominant} frac={rf.roofline_fraction:.4f} "
          f"modeled/dev={mem['modeled_total_per_device'] / 1e9:.2f}GB")
    return rf, mem


if __name__ == "__main__":
    main()
