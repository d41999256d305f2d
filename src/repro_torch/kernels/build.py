"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exports a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<digest>.so`` at the root
of the checkout (the digest is of the source, so an edited source builds
anew) and loaded with ``ctypes``.  Building happens at first use, never at
import; :func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together.

:func:`costed` marks a kernel wrapper's cost scope for the cost plane
(``repro_torch.analysis``): a launch through :func:`launch` is invisible to
a ``TorchDispatchMode``, so while a listener is registered each wrapper
reports the work and bytes it declares from its operands' shapes, once a
call, whichever backend runs; with none registered the scope costs one
list check a call.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Every CUDA source of the port (``csrc/<name>.cu``).
SOURCES = ("ingest", "query", "closure", "ingest_fused", "flow", "countsketch", "sequential", "ingest_stacked",
           "preagg", "boolmm")

_loaded: Dict[str, ctypes.CDLL] = {}
# Loads of each library in this process (each should be loaded once).
load_counts: collections.Counter = collections.Counter()
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# Whether the process sees one CUDA device (then an operand's device is
# always the current one and :func:`launch` skips the guard check); set at
# the first launch.
_one_device = False


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) from the build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, in parallel.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
        load_counts[name] += 1
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared (an int return, the ``cudaGetLastError()`` of the
    launch), looked up once per process."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaGetLastError()``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")


def launch(name: str, symbol: str, dev: int, record: bytes) -> None:
    """Launch ``symbol`` of ``csrc/<name>.cu``, a C function that takes one
    packed launch record (so ctypes converts one argument) and is bound at
    its first use, for operands on CUDA device ``dev``; raise on a nonzero
    status.  The device guard is entered only for a device other than the
    current one, never checked in a process that sees one device."""
    global _one_device
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = function(name, symbol, [ctypes.c_char_p])
        _one_device = torch.cuda.device_count() == 1
    if _one_device or dev == torch._C._cuda_getDevice():
        status = fn(record)
    else:
        with torch.cuda.device(dev):
            status = fn(record)
    if status:
        check(status, symbol)


# The cost plane's listeners: objects with ``enter_kernel(name, work, nbytes)``
# and ``exit_kernel()`` (``repro_torch.analysis.costlint.CostCounter``).
cost_listeners: list = []


def costed(cost: Callable[..., Tuple[int, int]]):
    """Decorate a kernel wrapper with its cost scope.  ``cost`` takes the
    wrapper's arguments and returns its declared ``(work, bytes)`` from
    their shapes alone (no read of their values, so no host sync): the
    Bound column's formulas of ``PERF.md`` section 6 with every slot taken as
    weighted.  While a listener is registered, each call reports them to it
    and the listener leaves out the aten ops the call makes (the plain
    version's on the CPU, the launch path's on the card), so the CPU and the
    card count the same for the same call."""

    def wrap(fn):
        name = fn.__name__

        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            if not cost_listeners:
                return fn(*args, **kwargs)
            listeners = tuple(cost_listeners)
            work, nbytes = cost(*args, **kwargs)
            for listener in listeners:
                listener.enter_kernel(name, work, nbytes)
            try:
                return fn(*args, **kwargs)
            finally:
                for listener in listeners:
                    listener.exit_kernel()

        return scoped

    return wrap
