"""Roofline report generator, the port of ``src/repro/roofline/report.py``:
result JSONs -> the markdown tables of the reference (roofline, dry run,
bottlenecks).  Model-cell records (``arch``/``shape``/``mesh``) come from
``launch/dryrun.py`` (collectives ``null``: not modelled); the sketch
plane's records
(``launch/sketch_dryrun.py``) have their own schema and are skipped here,
as in the reference."""
from __future__ import annotations

import json
from pathlib import Path


def load_cells(outdir: str = "results/dryrun_torch"):
    cells = {}
    for p in sorted(Path(outdir).glob("*.json")):
        rec = json.loads(p.read_text())
        if "arch" not in rec:  # sketch-plane records have their own schema
            continue
        cells[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return cells


def fmt_s(x):
    if x is None:
        return "not modelled"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}µs"


def roofline_table(cells, mesh="pod16x16") -> str:
    """Single-mesh roofline table."""
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPS | useful | roofline frac | fits one H100 |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), rec in sorted(cells.items()):
        if m != mesh:
            continue
        if rec["status"] == "skipped":
            lines.append(
                f"| {arch} | {shape} | — | — | — | SKIP | — | — | — | "
                f"({rec['skip_reason'][:48]}…) |"
            )
            continue
        rf = rec["roofline"]
        mm = rec.get("modeled_memory", {})
        lines.append(
            "| {a} | {s} | {c} | {me} | {co} | **{dom}** | {mf:.2e} | {ur} | "
            "{frac:.3f} | {fits} |".format(
                a=arch,
                s=shape,
                c=fmt_s(rf["compute_s"]),
                me=fmt_s(rf["memory_s"]),
                co=fmt_s(rf["collective_s"]),
                dom=rf["dominant"],
                mf=rf["model_flops"],
                ur=f"{rf['useful_ratio']:.2f}" if rf["useful_ratio"] else "—",
                frac=rf["roofline_fraction"],
                fits="yes" if mm.get("fits_hbm") else "CHECK",
            )
        )
    return "\n".join(lines)


def dryrun_table(cells) -> str:
    """Every mesh's trace/memory summary."""
    lines = [
        "| arch | shape | mesh | count | modeled mem/dev | count peak (global) | "
        "collective ops | status |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), rec in sorted(cells.items()):
        if rec["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | {m} | — | — | — | — | SKIP |")
            continue
        mm = rec.get("modeled_memory", {})
        mem = rec.get("memory") or {}
        colls = rec.get("collectives")
        n_coll = "not modelled" if colls is None else sum(int(v["count"]) for v in colls.values())
        lines.append(
            "| {a} | {s} | {m} | {c}s | {mm:.2f}GB | {xa:.2f}GB | {nc} | ok |".format(
                a=arch, s=shape, m=m, c=rec.get("count_s", "—"),
                mm=mm.get("modeled_total_per_device", 0) / 1e9,
                xa=mem.get("peak_live_bytes", 0) / 1e9,
                nc=n_coll,
            )
        )
    return "\n".join(lines)


def bottleneck_summary(cells, mesh="pod16x16") -> str:
    lines = []
    for (arch, shape, m), rec in sorted(cells.items()):
        if m != mesh or rec["status"] != "ok":
            continue
        rf = rec["roofline"]
        colls = rec["collectives"]
        if colls is None:
            coll = "collectives not modelled"
        else:
            top = max(colls, key=lambda k: colls[k]["bytes"])
            coll = f"top collective: {top} {colls[top]['bytes']/1e9:.1f} GB/rank over {int(colls[top]['count'])} ops"
        lines.append(f"- **{arch}/{shape}**: {rf['dominant']}-bound (lb {fmt_s(rf['step_time_lb'])}); {coll}")
    return "\n".join(lines)


if __name__ == "__main__":
    cells = load_cells()
    print("## Roofline (pod16x16 of H100s)\n")
    print(roofline_table(cells))
    print("\n## Dry run (every mesh)\n")
    print(dryrun_table(cells))
