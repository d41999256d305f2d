"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""
import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, (ast.Name, ast.Attribute))
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.args[0].value.split(".")[0], node.lineno


def test_port_files_exist():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()
    # The distributed plane is walked too (chip_smoke.py's spawned ranks run
    # functions of chip_smoke.py itself).
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/distributed/mesh.py", "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/distributed/spawn.py",
            "src/repro_torch/core/distributed.py"} <= names
    # So are the analysis and cost planes.
    assert {"src/repro_torch/analysis/contracts.py", "src/repro_torch/analysis/dispatch_lint.py",
            "src/repro_torch/analysis/source_lint.py", "src/repro_torch/analysis/costlint.py",
            "src/repro_torch/analysis/runner.py", "src/repro_torch/roofline/analysis.py",
            "src/repro_torch/roofline/report.py", "src/repro_torch/launch/sketch_dryrun.py"} <= names
    # So are the step builder, the pipeline and the bundle dry run.
    assert {"src/repro_torch/launch/steps.py", "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/dryrun.py", "src/repro_torch/launch/perf.py",
            "src/repro_torch/distributed/pipeline.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(mod, line) for mod, line in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import os\nimport jax.numpy as jnp\nfrom repro.core import sketch\n"
        "import importlib\nimportlib.import_module('repro.api')\nfrom . import x\n"
    )
    assert [m for m, _ in _imported_roots(probe) if m in FORBIDDEN] == ["jax", "repro", "repro"]


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """Beside no package, or where CUDA is absent, the smoke test exits
    nonzero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    scripts = [lone] if torch.cuda.is_available() else [lone, ROOT / "chip_smoke.py"]
    for script in scripts:
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True, timeout=120
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
