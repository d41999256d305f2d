"""CLI and report assembly for ``python -m repro_torch.analysis``: the port
of ``src/repro/analysis/runner.py``.

Runs the dispatch contract pass, the AST source pass and the traced-cost
pass (costlint), folds in the baseline, and renders a text or JSON report.
Exit status is 0 iff there are zero UNBASELINED violations.  Stale baseline
entries (their pass ran, no violation matched) are surfaced as warnings and
removable with ``--prune-baseline``.

``--device cuda`` runs the dispatch and cost passes on the card, on the
hand-written kernels: the dispatch pass at the fixture size and at BASE
with the sync debug mode on, the cost pass without the budgets (they are
the CPU's).  Budget maintenance: ``--update-budgets``
re-measures the cost registry on the CPU and rewrites ``budgets.json`` at
measured × margin (the ratchet); ``--cost-table PATH`` writes the exponent
table as markdown.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis.contracts import BASE_FIXTURE, FIXTURE, Violation, apply_baseline

_PASSES = ("dispatch", "source", "costlint")


def _default_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1]  # src/repro_torch


def _default_tests_dir(root: pathlib.Path) -> Optional[pathlib.Path]:
    cand = root.parents[1] / "tests" if len(root.parents) >= 2 else None
    return cand if cand is not None and cand.is_dir() else None


def run_analysis(
    passes: Iterable[str] = _PASSES,
    *,
    root: Optional[pathlib.Path] = None,
    tests_dir: Optional[pathlib.Path] = None,
    entry_points=None,
    cost_entry_points=None,
    budgets_path: Optional[pathlib.Path] = None,
    check_budgets: bool = True,
    baseline: Optional[Dict] = None,
    device: str = "cpu",
) -> Dict:
    """Run the requested passes and return the report dict:
    ``{ok, counts, checked_entry_points, cost, violations: [...]}``.
    ``ok`` is True iff no unbaselined violation survived.  On a card
    (``device="cuda"``) the dispatch pass runs at the fixture size and at
    BASE, and the budgets (the CPU's) are not checked."""
    from repro_torch.analysis.baseline import BASELINE, stale_baseline_entries

    passes = tuple(passes)
    root = pathlib.Path(root) if root is not None else _default_root()
    tests_dir = pathlib.Path(tests_dir) if tests_dir is not None else _default_tests_dir(root)
    baseline = BASELINE if baseline is None else baseline
    cuda = device != "cpu"
    if cuda and ("dispatch" in passes or "costlint" in passes):
        from repro_torch.kernels import build

        build.build(build.SOURCES)  # one nvcc a source, all at once, before any entry launches

    violations: List[Violation] = []
    checked: List[str] = []
    cost_checked: List[str] = []
    measurements: List[Dict] = []
    if "dispatch" in passes:
        from repro_torch.analysis.contracts import ENTRY_POINTS
        from repro_torch.analysis.dispatch_lint import run_dispatch_pass

        eps = ENTRY_POINTS if entry_points is None else tuple(entry_points)
        checked = [ep.name for ep in eps]
        fixtures = [dataclasses.replace(FIXTURE, device=device)] + ([BASE_FIXTURE] if cuda else [])
        for i, fx in enumerate(fixtures):
            found = run_dispatch_pass(None if entry_points is None else eps, fixture=fx, dynamic=i == 0)
            seen = {(v.rule, v.subject, v.message) for v in violations}
            violations.extend(v for v in found if (v.rule, v.subject, v.message) not in seen)
    if "source" in passes:
        from repro_torch.analysis.source_lint import lint_tree

        violations.extend(lint_tree(root, tests_dir))
    if "costlint" in passes:
        from repro_torch.analysis.contracts import COST_ENTRY_POINTS
        from repro_torch.analysis.costlint import load_budgets, run_cost_pass

        ceps = COST_ENTRY_POINTS if cost_entry_points is None else tuple(cost_entry_points)
        cost_checked = [ep.name for ep in ceps]
        cost_violations, measurements = run_cost_pass(
            None if cost_entry_points is None else ceps,
            budgets=load_budgets(budgets_path),
            check_budgets=check_budgets and not cuda,
            device=device,
        )
        violations.extend(cost_violations)

    stale = stale_baseline_entries(baseline, violations, passes)
    violations = apply_baseline(violations, baseline)
    new = [v for v in violations if not v.baselined]
    old = [v for v in violations if v.baselined]
    return {
        "ok": not new,
        "passes": list(passes),
        "device": device,
        "root": str(root),
        "checked_entry_points": checked,
        "checked_cost_entries": cost_checked,
        "counts": {
            "violations": len(new),
            "baselined": len(old),
            "entry_points": len(checked),
            "cost_entry_points": len(cost_checked),
            "stale_baseline": len(stale),
        },
        "stale_baseline": [list(k) for k in stale],
        "cost": measurements,
        "violations": [v.to_json() for v in violations],
    }


def _render_text(report: Dict) -> str:
    lines = []
    for v in report["violations"]:
        lines.append(Violation(**v).render())
    for rule, subject in report.get("stale_baseline", []):
        lines.append(
            f"WARN stale baseline entry ({rule}, {subject}) matched no current violation: remove it or run "
            "--prune-baseline"
        )
    for m in report.get("cost", []):
        fits = ", ".join(
            f"{f['axis']}:{f['measured']:.2f}/{f['declared']:g}{'' if f['ok'] else '!'}" for f in m["axes"]
        )
        lines.append(f"cost {m['entry']}: {fits} ({m['traces']} traces, peak {m['peak_bytes']} B)")
    c = report["counts"]
    lines.append(
        f"repro_torch.analysis ({report.get('device', 'cpu')}): {c['entry_points']} entry points, "
        f"{c.get('cost_entry_points', 0)} cost entries, {c['violations']} violation(s), {c['baselined']} "
        f"baselined, {c.get('stale_baseline', 0)} stale baseline"
    )
    lines.append("OK" if report["ok"] else "FAIL")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Hot-path contract checks of the port: dispatch pass + source lint + traced-cost contracts.",
    )
    parser.add_argument("--format", choices=("text", "json"), default="text", help="report format on stdout")
    parser.add_argument("--json", action="store_const", const="json", dest="format",
                        help="the same as --format json")
    parser.add_argument("--output", type=pathlib.Path, default=None, help="also write the JSON report here")
    parser.add_argument("--passes", default=",".join(_PASSES),
                        help="comma-separated subset of passes: dispatch,source,costlint")
    parser.add_argument("--root", type=pathlib.Path, default=None,
                        help="package tree to lint (default: the installed repro_torch package)")
    parser.add_argument("--tests-dir", type=pathlib.Path, default=None,
                        help="tests directory for the kernel-ref coverage rule")
    parser.add_argument("--budgets", type=pathlib.Path, default=None,
                        help="path to budgets.json (default: the committed one beside the analyzer)")
    parser.add_argument("--update-budgets", action="store_true",
                        help="re-measure the cost registry and rewrite the budgets at measured x margin, exit 0")
    parser.add_argument("--prune-baseline", action="store_true",
                        help="run the passes, delete baseline entries that match no violation, exit 0")
    parser.add_argument("--baseline", type=pathlib.Path, default=None,
                        help="path to baseline.json (default: the committed one)")
    parser.add_argument("--cost-entries", default=None,
                        help="comma-separated cost entry names to restrict costlint to")
    parser.add_argument("--cost-table", type=pathlib.Path, default=None,
                        help="write the cost exponent table (markdown) to this path")
    parser.add_argument("--device", default="cpu",
                        help="cpu (the plain versions) or cuda (the hand-written kernels on the card)")
    args = parser.parse_args(argv)

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = [p for p in passes if p not in _PASSES]
    if unknown:
        parser.error(f"unknown pass(es): {', '.join(unknown)}")

    cost_entry_points = None
    if args.cost_entries is not None:
        from repro_torch.analysis.contracts import COST_ENTRY_POINTS

        wanted = {n.strip() for n in args.cost_entries.split(",") if n.strip()}
        cost_entry_points = tuple(ep for ep in COST_ENTRY_POINTS if ep.name in wanted)
        missing = wanted - {ep.name for ep in cost_entry_points}
        if missing:
            parser.error(f"unknown cost entries: {', '.join(sorted(missing))}")

    if args.update_budgets:
        from repro_torch.analysis.costlint import budgets_from_measurements, load_budgets, run_cost_pass, write_budgets

        full = cost_entry_points is None
        violations, measurements = run_cost_pass(cost_entry_points, check_budgets=False)
        budgets = budgets_from_measurements(measurements, prior=load_budgets(args.budgets), full_registry=full)
        path = write_budgets(budgets, args.budgets)
        print(f"wrote {path}: {len(budgets['entries'])} entry ceilings, trace_count={budgets.get('trace_count')}")
        for v in violations:
            print(v.render(), file=sys.stderr)
        return 0

    baseline = None
    if args.baseline is not None:
        from repro_torch.analysis.baseline import load_baseline

        baseline = load_baseline(args.baseline)

    report = run_analysis(
        passes,
        root=args.root,
        tests_dir=args.tests_dir,
        cost_entry_points=cost_entry_points,
        budgets_path=args.budgets,
        baseline=baseline,
        device=args.device,
    )

    if args.prune_baseline:
        from repro_torch.analysis.baseline import prune_baseline

        removed = prune_baseline([tuple(k) for k in report["stale_baseline"]], args.baseline)
        print(f"pruned {removed} stale baseline entr{'y' if removed == 1 else 'ies'}")
        return 0

    if args.cost_table is not None and report.get("cost"):
        from repro_torch.analysis.costlint import cost_table_markdown

        args.cost_table.write_text(cost_table_markdown(report["cost"]))

    if args.output is not None:
        args.output.write_text(json.dumps(report, indent=2) + "\n")
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(_render_text(report))
    return 0 if report["ok"] else 1
