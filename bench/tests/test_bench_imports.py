"""Nothing the benchmark loads is JAX or the JAX package: every module of
``bench/`` imported in a fresh process (every metric reader loaded by file),
then the top-level names of ``sys.modules`` compared whole."""
import subprocess
import sys

from bench.harness import spec

SCRIPT = """
import importlib, sys
sys.path[:0] = [{repo!r}, {src!r}]
from pathlib import Path
from bench.harness import cell, spec
bench = Path({bench!r})
for path in sorted(bench.rglob("*.py")):
    rel = path.relative_to(bench.parent)
    if path.parent.name == "metrics":
        spec.reader(path.stem)
    elif "tests" not in rel.parts:
        importlib.import_module(".".join(rel.with_suffix("").parts).replace(".__init__", ""))
import repro_torch.api, repro_torch.fleet, repro_torch.core.queries
print(",".join(cell.forbidden_modules()))
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_and_no_reference_package():
    code = SCRIPT.format(repo=str(spec.REPO), src=str(spec.REPO / "src"), bench=str(spec.BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    forbidden, loaded = out.stdout.split("\n")[:2]
    assert forbidden == ""
    assert "repro_torch" in loaded.split(",") and "repro" not in loaded.split(",")
