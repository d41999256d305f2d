"""Pass 2, AST source lint for the port's hot-path idioms: the port of
``src/repro/analysis/source_lint.py``.

Rules (scoped by path relative to the lint root, so the same rules run over
``src/repro_torch`` and over small fixture trees in the analyzer's own
tests), each mapped from the reference's:

``no-compile``     no ``torch.compile`` and no ``torch.jit`` anywhere in the
                   port: its kernels are written by hand, and a compiled
                   region would hide its ops from the dispatch and cost
                   passes.  From ``direct-jit``.
``host-sync``      no ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``
                   or ``torch.cuda.synchronize`` in the modules whose
                   functions run per query or per kernel call:
                   ``kernels/**``, ``core/queries.py``, ``core/reach.py``,
                   ``core/window.py``.
``torch-in-loop``  no ``torch.*`` (or ``torch.nn.functional``) call and no
                   call of a kernel wrapper (a function of
                   ``kernels/*/ops.py`` under ``build.costed``) inside a
                   Python ``for``/``while`` in ``core/`` and ``kernels/``:
                   each iteration launches from the host.  From
                   ``jnp-in-loop``.
``env-read``       no environment read anywhere but ``CUDA_HOME`` in
                   ``kernels/build.py`` (the toolkit's location); the
                   port's configuration is its arguments.
``kernel-ref``     every ``csrc/<name>.cu`` ships ``kernels/<name>/ops.py``
                   and ``ref.py``, a CPU parity test importing the ref (a
                   ``tests/test_torch_*.py`` other than the card's), a test
                   in ``tests/test_torch_gpu.py`` importing both, and a
                   phase of ``chip_smoke.py`` (beside ``tests/``) importing
                   its ops.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import List, Optional, Union

from repro_torch.analysis.contracts import Violation

# -- per-rule path scopes (POSIX-style, relative to the lint root) ----------

HOST_SYNC_DIRS = ("kernels",)
HOST_SYNC_FILES = ("core/queries.py", "core/reach.py", "core/window.py")
HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

TORCH_LOOP_DIRS = ("core", "kernels")

# (file, variable) pairs allowed to read the environment.
ENV_READ_ALLOW = (("kernels/build.py", "CUDA_HOME"),)

ENV_CALLS = frozenset({"os.environ.get", "os.getenv", "os.environ.setdefault", "os.environ.pop"})


def _in_dirs(rel: str, dirs) -> bool:
    return any(rel == d or rel.startswith(d + "/") for d in dirs)


def _attr_chain(node: ast.AST) -> Optional[str]:
    """'torch.nn.functional.pad' for Attribute/Name chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def kernel_wrappers(root: Union[str, pathlib.Path]) -> frozenset:
    """Names of the kernel wrappers of a tree: the functions of
    ``kernels/*/ops.py`` decorated with ``build.costed(...)``."""
    names = set()
    for path in sorted(pathlib.Path(root).glob("kernels/*/ops.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and any(
                isinstance(dec, ast.Call) and (_attr_chain(dec.func) or "").endswith("costed")
                for dec in node.decorator_list
            ):
                names.add(node.name)
    return frozenset(names)


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, wrappers: frozenset = frozenset()):
        self.rel = rel
        self.wrappers = wrappers
        self.loop_depth = 0
        self.def_stack: List[str] = []
        self.violations: List[Violation] = []
        self.torch_aliases = {"torch"}  # names bound to torch or a torch submodule

    # -- context tracking ---------------------------------------------------

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            if alias.name == "torch" or alias.name.startswith("torch."):
                self.torch_aliases.add(alias.asname or alias.name.split(".")[0])
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module and (node.module == "torch" or node.module.startswith("torch.")):
            for alias in node.names:
                self.torch_aliases.add(alias.asname or alias.name)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._visit_def(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._visit_def(node)

    def _visit_def(self, node):
        self.def_stack.append(node.name)
        outer_depth, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = outer_depth
        self.def_stack.pop()

    def visit_For(self, node: ast.For):
        self._visit_loop(node)

    def visit_While(self, node: ast.While):
        self._visit_loop(node)

    def _visit_loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    # -- rule checks --------------------------------------------------------

    def _subject(self, node) -> str:
        where = "::".join(self.def_stack) or "<module>"
        return f"{self.rel}::{where}:{node.lineno}"

    def _flag(self, rule: str, node, message: str):
        self.violations.append(
            Violation(rule=rule, subject=self._subject(node), message=message, pass_name="source")
        )

    def visit_Attribute(self, node: ast.Attribute):
        chain = _attr_chain(node)
        if chain is not None:
            root, _, rest = chain.partition(".")
            if root in self.torch_aliases and (rest == "compile" or rest == "jit" or rest.startswith("jit.")):
                self._flag("no-compile", node, f"{chain}: the port's kernels are hand-written and its ops "
                                                "stay visible to the dispatch and cost passes")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        self._check_host_sync(node)
        self._check_torch_in_loop(node)
        self._check_env_read(node)
        self.generic_visit(node)

    def _hot_for_sync(self) -> bool:
        return _in_dirs(self.rel, HOST_SYNC_DIRS) or self.rel in HOST_SYNC_FILES

    def _check_host_sync(self, node: ast.Call):
        if not self._hot_for_sync():
            return
        f = node.func
        if not isinstance(f, ast.Attribute):
            return
        chain = _attr_chain(f)
        if chain is not None and chain.split(".", 1)[0] in self.torch_aliases and chain.endswith(
                "cuda.synchronize"):
            self._flag("host-sync", node, f"{chain}() waits for the card on a hot path")
        elif f.attr in HOST_SYNC_METHODS and not node.args and not node.keywords:
            self._flag("host-sync", node, f".{f.attr}() hands device values to the host (a sync on the card)")

    def _check_torch_in_loop(self, node: ast.Call):
        if self.loop_depth == 0 or not _in_dirs(self.rel, TORCH_LOOP_DIRS):
            return
        chain = _attr_chain(node.func)
        if chain is None:
            return
        if chain.split(".", 1)[0] in self.torch_aliases and "." in chain:
            self._flag("torch-in-loop", node, f"{chain}() inside a Python loop launches per iteration "
                                              "(batch the loop or hoist the call)")
        elif chain.rsplit(".", 1)[-1] in self.wrappers:
            self._flag("torch-in-loop", node, f"kernel wrapper {chain}() inside a Python loop: one launch "
                                              "from the host an iteration")

    def _env_key(self, key_arg) -> Optional[str]:
        if isinstance(key_arg, ast.Constant) and isinstance(key_arg.value, str):
            return key_arg.value
        return None

    def _env_flag(self, node, key: Optional[str]):
        if (self.rel, key) in ENV_READ_ALLOW:
            return
        self._flag("env-read", node, f"environment read of {key or 'a computed name'} (the port reads only "
                                     "CUDA_HOME, in kernels/build.py)")

    def _check_env_read(self, node: ast.Call):
        chain = _attr_chain(node.func)
        if chain in ENV_CALLS:
            self._env_flag(node, self._env_key(node.args[0]) if node.args else None)

    def visit_Subscript(self, node: ast.Subscript):
        # os.environ["X"]
        if _attr_chain(node.value) == "os.environ":
            self._env_flag(node, self._env_key(node.slice))
        self.generic_visit(node)


def lint_file(path: Union[str, pathlib.Path], rel: Optional[str] = None,
              wrappers: frozenset = frozenset()) -> List[Violation]:
    """Lint one source file.  ``rel`` is its rule-scope path (POSIX,
    relative to the lint root); defaults to the file name.  ``wrappers``
    names the tree's kernel wrappers (:func:`kernel_wrappers`)."""
    path = pathlib.Path(path)
    rel = rel if rel is not None else path.name
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as exc:
        return [Violation(rule="syntax-error", subject=rel, message=f"unparseable: {exc}", pass_name="source")]
    visitor = _Visitor(rel, wrappers)
    visitor.visit(tree)
    return visitor.violations


def _imports(text: str, name: str, mod: str) -> bool:
    """Whether ``text`` imports ``kernels.<name>.<mod>`` (dotted, or
    ``from ...kernels.<name> import ..., <mod>``)."""
    return bool(re.search(rf"kernels\.{name}\.{mod}\b|kernels\.{name} import [^\n]*\b{mod}\b", text))


def _kernel_ref(name: str, message: str) -> Violation:
    return Violation(rule="kernel-ref", subject=f"csrc/{name}.cu", message=message, pass_name="source")


def _check_kernel_refs(root: pathlib.Path, tests_dir: Optional[pathlib.Path]) -> List[Violation]:
    out: List[Violation] = []
    csrc = root / "csrc"
    if not csrc.is_dir():
        return out
    parity, gpu = "", ""
    if tests_dir is not None:
        for p in sorted(tests_dir.glob("test_torch_*.py")):
            if p.name == "test_torch_gpu.py":
                gpu = p.read_text()
            else:
                parity += p.read_text()
    smoke_path = tests_dir.parent / "chip_smoke.py" if tests_dir is not None else None
    smoke = smoke_path.read_text() if smoke_path is not None and smoke_path.exists() else None
    for cu in sorted(csrc.glob("*.cu")):
        name = cu.stem
        for required in ("ops.py", "ref.py"):
            if not (root / "kernels" / name / required).exists():
                out.append(_kernel_ref(name, f"no kernels/{name}/{required} beside the CUDA source"))
        if tests_dir is None:
            continue
        if f"kernels.{name}.ref" not in parity:
            out.append(_kernel_ref(name, f"no CPU parity test (tests/test_torch_*.py) imports kernels.{name}.ref"))
        for mod in ("ops", "ref"):
            if not _imports(gpu, name, mod):
                out.append(_kernel_ref(name, f"tests/test_torch_gpu.py never imports kernels.{name}.{mod}: no "
                                             "card test against the plain version"))
        if smoke is not None and not _imports(smoke, name, "ops"):
            out.append(_kernel_ref(name, f"chip_smoke.py has no phase importing kernels.{name}.ops"))
    return out


def lint_tree(
    root: Union[str, pathlib.Path],
    tests_dir: Optional[Union[str, pathlib.Path]] = None,
) -> List[Violation]:
    """Run every source rule over a package tree rooted at ``root``
    (normally ``src/repro_torch``).  ``tests_dir`` enables the kernel-ref
    coverage checks against the tests (and ``chip_smoke.py`` beside them)."""
    root = pathlib.Path(root)
    tests = pathlib.Path(tests_dir) if tests_dir is not None else None
    out: List[Violation] = []
    wrappers = kernel_wrappers(root)
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("analysis/"):
            continue  # the analyzer is host-side tooling, not a hot path
        out.extend(lint_file(path, rel, wrappers))
    out.extend(_check_kernel_refs(root, tests))
    return out
