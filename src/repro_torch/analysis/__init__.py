"""repro_torch.analysis: the analysis and cost planes of the port, which
enforce its hot-path contracts (port of ``src/repro/analysis/``).

Three passes, one CLI (``python -m repro_torch.analysis``; ``--device
cuda`` runs the first and third on the card's kernels):

- **Pass 1, the dispatch contract checker**
  (:mod:`repro_torch.analysis.dispatch_lint` +
  :mod:`repro_torch.analysis.contracts`): runs a registry of engine entry
  points (every ingest backend, the session's in-place boundaries, every
  query family, each ``kernels/*/ops.py`` wrapper, the distributed and
  fleet planes) under a ``TorchDispatchMode`` and checks declarative
  contracts on the aten ops they run: no host sync, no wide dtype, no
  full-counter reduction in register-served families, collectives only in
  the distributed plane, no copy of the counters in a boundary that updates
  them in place; and dynamic checks of the closure cache, the incremental
  refresh and the fleet's one dispatch a batch.
- **Pass 2, source lint** (:mod:`repro_torch.analysis.source_lint`): AST
  rules for the port: no ``torch.compile``/``torch.jit``, no host syncs in
  per-query and per-kernel modules, no torch calls or kernel launches in
  Python loops in hot modules, no environment reads but ``CUDA_HOME``, and
  every CUDA source with its wrapper, plain version, CPU and card tests and
  smoke phase.
- **Pass 3, costlint** (:mod:`repro_torch.analysis.costlint` + the cost
  registry): runs each cost entry point at 2–3 geometrically spaced sizes
  under a cost counter (aten ops by kind, kernel wrappers by their declared
  costs), fits per-axis scaling exponents and checks the paper's
  complexity claims (ingest O(B·d) and O(1) in tenants, register-served
  queries O(d·Q) and free of w, closure refresh O(T_touched·w²)), the
  memory side of the in-place update, and the ceilings committed in
  ``budgets.json`` (ratcheted by ``--update-budgets``).

Pre-existing violations are either fixed or baselined with a one-line
justification in ``baseline.json`` (prunable by ``--prune-baseline``); the
CLI exits nonzero on any unbaselined violation.
"""
from repro_torch.analysis.contracts import (  # noqa: F401
    COST_ENTRY_POINTS,
    ENTRY_POINTS,
    AxisContract,
    CostEntryPoint,
    CostProbe,
    EntryPoint,
    Fixture,
    TracedEntry,
    Violation,
    apply_baseline,
)
from repro_torch.analysis.costlint import (  # noqa: F401
    budgets_from_measurements,
    cost_table_markdown,
    load_budgets,
    measure_entry,
    run_cost_pass,
)
from repro_torch.analysis.dispatch_lint import (  # noqa: F401
    Recorder,
    reduces_full_counters,
    run_dispatch_pass,
)
from repro_torch.analysis.runner import main, run_analysis  # noqa: F401
from repro_torch.analysis.source_lint import lint_file, lint_tree  # noqa: F401
