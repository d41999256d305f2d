"""Accepted pre-existing violations, each with a one-line justification:
the port of ``src/repro/analysis/baseline.py``.

The baseline lives in ``baseline.json`` next to this module so the CLI can
prune it (``--prune-baseline``).  Entries are keyed ``(rule, subject)``;
subjects use the spelling the passes emit (``path::scope:lineno`` for
source findings, the entry-point name for dispatch and cost findings).  A
baselined finding still appears in the report (marked ``baselined``) but
does not fail the CLI; REMOVE the entry when the code is fixed, so the gate
starts protecting it.  Every entry has its item in ``ROADMAP.md``.

Line numbers in subjects make baselines brittle on purpose: moving the code
re-surfaces the finding for review.  The staleness check runs the other
way: an entry whose pass ran but which matched no current violation is dead
weight and is flagged, and prunable.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BASELINE_PATH = pathlib.Path(__file__).with_name("baseline.json")

# Which pass emits which rule: staleness is only decidable for rules whose
# pass ran this invocation.
RULE_PASS: Dict[str, str] = {
    # source pass
    "no-compile": "source",
    "host-sync": "source",
    "torch-in-loop": "source",
    "env-read": "source",
    "kernel-ref": "source",
    # dispatch pass
    "no-host-sync": "dispatch",
    "no-wide-dtype": "dispatch",
    "no-counter-reduction": "dispatch",
    "collectives-in-distributed-plane": "dispatch",
    "no-counter-copy": "dispatch",
    "retrace": "dispatch",
    "entry-point-broken": "dispatch",
    # costlint pass
    "cost-exponent": "costlint",
    "cost-donation-memory": "costlint",
    "cost-budget": "costlint",
    "cost-entry-broken": "costlint",
}


def load_baseline(path: Optional[pathlib.Path] = None) -> Dict[Tuple[str, str], str]:
    p = pathlib.Path(path) if path is not None else BASELINE_PATH
    if not p.exists():
        return {}
    return {(e["rule"], e["subject"]): e["justification"] for e in json.loads(p.read_text())}


BASELINE: Dict[Tuple[str, str], str] = load_baseline()


def stale_baseline_entries(
    baseline: Dict[Tuple[str, str], str],
    violations: Iterable,
    passes: Sequence[str],
) -> List[Tuple[str, str]]:
    """Baseline keys whose rule's pass ran this invocation but which matched
    no violation (baselined or not): the accepted debt no longer exists, so
    the entry should go before it masks a new finding at the same site."""
    seen = {(v.rule, v.subject) for v in violations}
    return [key for key in baseline if RULE_PASS.get(key[0]) in passes and key not in seen]


def prune_baseline(stale: Sequence[Tuple[str, str]], path: Optional[pathlib.Path] = None) -> int:
    """Delete ``stale`` keys from the baseline file; returns the number of
    entries removed."""
    p = pathlib.Path(path) if path is not None else BASELINE_PATH
    if not p.exists() or not stale:
        return 0
    dead = set(stale)
    entries = json.loads(p.read_text())
    kept = [e for e in entries if (e["rule"], e["subject"]) not in dead]
    removed = len(entries) - len(kept)
    if removed:
        p.write_text(json.dumps(kept, indent=1) + "\n")
    return removed
