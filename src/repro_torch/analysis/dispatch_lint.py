"""Pass 1, the dispatch contract checker: the port of
``src/repro/analysis/jaxpr_lint.py``.

The reference traces each entry point with ``jax.make_jaxpr`` and walks the
jaxpr.  The port runs each entry of
:data:`repro_torch.analysis.contracts.ENTRY_POINTS` once under a
:class:`Recorder`: a ``TorchDispatchMode`` that logs every aten op (its
name, the shapes, dtypes and devices of its tensors, and which of its
outputs are fresh allocations, aliasing no input) and a
``TorchFunctionMode`` that logs the tensor methods that read values on the
host without an aten op of their own (``numpy``, ``tolist``, ``cpu``).  The
declared contracts are then checked against the log:

``no-host-sync``   ``_local_scalar_dense`` (``item``, ``bool``, ``int``,
                   ``float``), ``numpy``/``tolist``/``cpu``/``__array__``,
                   a copy from a card to the host, and ops whose output
                   shape depends on the data (``nonzero``, ``unique``,
                   ``masked_select``, ``repeat_interleave`` without an
                   output size, ``bincount``, a boolean index).  On the card
                   the pass also runs each entry under
                   ``torch.cuda.set_sync_debug_mode("warn")``, which catches
                   the blocking copies a CPU run cannot see.
``no-wide-dtype``  float64 or complex128 anywhere.  int64 is allowed in the
                   index plane: ops whose tensors are all integer or bool
                   (the hash families compute in int64, ``core/hashing.py``),
                   the index operands of indexing ops, and the index outputs
                   of ``sort``/``topk``/``argmax``-like ops.  It is flagged
                   where it meets floating-point work otherwise.  (The
                   reference bans int64 outright: under JAX's default
                   32-bit mode an int64 aval is always a promotion bug.)
``no-counter-reduction``  a reduction reading a tensor of the counters'
                   shape.
``collectives-in-distributed-plane``  a c10d op in an entry outside
                   ``distributed.*``.
``no-counter-copy``  a fresh allocation of the summary's bytes or more in a
                   boundary that updates it in place.

Kernels launched through ``kernels/build.py::launch`` are invisible to a
dispatch mode, so a kernel wrapper's call is opaque here as in the cost
pass (``kernels/build.py::costed``): the ops its plain version makes on the
CPU are left out, and the wrapper and plain-version sources are held by the
source pass (``host-sync`` over ``kernels/**``) and by the card's run.
"""
from __future__ import annotations

import traceback
import warnings
from typing import Iterable, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.contracts import (
    DYNAMIC_CHECKS,
    ENTRY_POINTS,
    FIXTURE,
    EntryPoint,
    Fixture,
    TracedEntry,
    Violation,
    one_rank_group,
)
from repro_torch.kernels import build as kernel_build

# Aten ops (by overload packet) that read a value back to the host or whose
# output shape depends on the data: each waits for the card.
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "nonzero_static", "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive", "bincount", "histc", "equal",
})
# Tensor methods that hand values to the host without an aten op of their own.
HOST_METHODS = frozenset({"numpy", "tolist", "cpu", "__array__"})
# Ops that take int64 index operands, and ops that produce int64 indices.
INDEXING_OPS = frozenset({
    "index", "_unsafe_index", "index_put", "index_put_", "_index_put_impl_", "index_add", "index_add_",
    "index_select", "gather", "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "take", "embedding", "index_fill", "index_fill_", "index_copy", "index_copy_",
    "take_along_dim", "searchsorted", "embedding_dense_backward",
})
INDEX_PRODUCING_OPS = frozenset({
    "sort", "argsort", "topk", "argmax", "argmin", "max", "min", "kthvalue", "median", "mode", "searchsorted",
    "cummax", "cummin",
})
REDUCTION_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "all", "any", "prod", "argmax", "argmin", "cumsum", "cumprod",
    "logsumexp", "norm", "linalg_vector_norm", "var", "std", "median", "nanmedian", "nansum", "count_nonzero",
    "aminmax", "var_mean", "std_mean",
})
WIDE_DTYPES = frozenset({torch.float64, torch.complex128})
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})


class OpRecord:
    """One aten op as the recorder saw it."""

    __slots__ = ("namespace", "name", "inputs", "outputs", "fresh", "aliased", "index_bool")

    def __init__(self, namespace, name, inputs, outputs, fresh, aliased, index_bool):
        self.namespace = namespace
        self.name = name                # the overload packet, e.g. "index_add_"
        self.inputs = inputs            # [(shape, dtype, device)]
        self.outputs = outputs          # [(shape, dtype, device)]
        self.fresh = fresh              # [bytes] of outputs that alias no input
        self.aliased = aliased          # every output aliases an input (a view or an in-place op)
        self.index_bool = index_bool    # a boolean index operand


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of nested args, left to right."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _storage_key(t: torch.Tensor):
    """What tells one tensor's storage from another's: its address, or on
    the ``meta`` device (every address 0) the storage object itself."""
    storage = t.untyped_storage()
    return storage._cdata if t.device.type == "meta" else storage.data_ptr()


class _OpMode(TorchDispatchMode):
    def __init__(self, sink):
        super().__init__()
        self.sink = sink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.sink.kernel_depth:
            self.sink.on_op(func, args, kwargs, out)
        return out


class _MethodMode(TorchFunctionMode):
    def __init__(self, sink):
        super().__init__()
        self.sink = sink

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_METHODS and not self.sink.kernel_depth:
            self.sink.host_calls.append(name)
        return func(*args, **(kwargs or {}))


class OpSink:
    """The log a recorder fills, and the kernel scopes it is told of."""

    def __init__(self):
        self.ops: List[OpRecord] = []
        self.host_calls: List[str] = []
        self.kernels: List[Tuple[str, int, int]] = []
        self.kernel_depth = 0

    # -- kernels/build.py::costed listener --------------------------------------

    def enter_kernel(self, name: str, work: int, nbytes: int) -> None:
        if not self.kernel_depth:
            self.kernels.append((name, int(work), int(nbytes)))
            self.on_kernel(int(work), int(nbytes))
        self.kernel_depth += 1

    def exit_kernel(self) -> None:
        self.kernel_depth -= 1

    def on_kernel(self, work: int, nbytes: int) -> None:
        pass

    # -- aten ops ---------------------------------------------------------------

    def on_op(self, func, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_storage_key(t) for t in ins}
        fresh = []
        for t in outs:
            storage = t.untyped_storage()
            if _storage_key(t) not in in_keys and storage.nbytes():
                fresh.append(storage.nbytes())
                self.on_alloc(t, storage.nbytes())
        aliased = bool(outs) and all(_storage_key(t) in in_keys for t in outs)
        packet = func.overloadpacket
        name = getattr(packet, "__name__", str(packet))
        namespace = func.namespace
        index_bool = False
        if name in ("index", "index_put", "index_put_", "_index_put_impl_", "_unsafe_index"):
            indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
            index_bool = any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                             for i in indices or ())
        rec = OpRecord(namespace, name, [(tuple(t.shape), t.dtype, t.device) for t in ins],
                       [(tuple(t.shape), t.dtype, t.device) for t in outs], fresh, aliased, index_bool)
        self.ops.append(rec)
        self.on_record(rec, func, args, kwargs, ins, outs)

    def on_alloc(self, t: torch.Tensor, nbytes: int) -> None:
        pass

    def on_record(self, rec, func, args, kwargs, ins, outs) -> None:
        pass


class Recorder:
    """Context manager: log the aten ops and host methods of the calls made
    inside it into ``self.sink`` (an :class:`OpSink`), with kernel wrappers'
    calls opaque."""

    def __init__(self, sink: Optional[OpSink] = None):
        self.sink = sink if sink is not None else OpSink()

    def __enter__(self):
        kernel_build.cost_listeners.append(self.sink)
        self._method = _MethodMode(self.sink)
        self._ops = _OpMode(self.sink)
        self._method.__enter__()
        self._ops.__enter__()
        return self.sink

    def __exit__(self, *exc):
        try:
            self._ops.__exit__(*exc)
            self._method.__exit__(*exc)
        finally:
            kernel_build.cost_listeners.remove(self.sink)
        return False


# ---------------------------------------------------------------------------
# per-contract checkers: each takes the sink, the entry and its name
# ---------------------------------------------------------------------------


def _violation(rule: str, name: str, message: str) -> Violation:
    return Violation(rule=rule, subject=name, message=message, pass_name="dispatch")


def _dedupe(found: Iterable[Tuple[str, str]], name: str) -> List[Violation]:
    seen, out = set(), []
    for rule, message in found:
        if (rule, message) not in seen:
            seen.add((rule, message))
            out.append(_violation(rule, name, message))
    return out


def check_no_host_sync(sink: OpSink, entry: TracedEntry, name: str) -> List[Violation]:
    found = []
    for m in sink.host_calls:
        found.append(("no-host-sync", f"Tensor.{m}() hands device values to the host on a hot path"))
    for op in sink.ops:
        if op.name in SYNC_OPS:
            found.append(("no-host-sync", f"{op.namespace}.{op.name} waits for the device (a value read back, "
                                          "or an output shape that depends on the data)"))
        elif op.index_bool:
            found.append(("no-host-sync", f"{op.namespace}.{op.name} with a boolean index (a data-dependent "
                                          "nonzero)"))
        elif op.name == "repeat_interleave" and len(op.inputs) == 1:
            found.append(("no-host-sync", "repeat_interleave without output_size sizes its output from data"))
        elif op.name in ("_to_copy", "copy_", "_copy_from", "_copy_from_and_resize"):
            if any(d.type != "cpu" for _, _, d in op.inputs) and any(d.type == "cpu" for _, _, d in op.outputs):
                found.append(("no-host-sync", f"{op.namespace}.{op.name} copies device data to the host"))
    return _dedupe(found, name)


def _is_wide_int(dtype) -> bool:
    return dtype in (torch.int64, torch.uint64)


def check_no_wide_dtype(sink: OpSink, entry: TracedEntry, name: str) -> List[Violation]:
    found = []
    for op in sink.ops:
        tensors = op.inputs + op.outputs
        for _, dtype, _ in tensors:
            if dtype in WIDE_DTYPES:
                found.append(("no-wide-dtype", f"{dtype} tensor around {op.namespace}.{op.name}: a float64 "
                                               "promotion doubles the bytes"))
        if not any(dt.is_floating_point or dt.is_complex for _, dt, _ in tensors):
            continue  # the index plane: integer and bool ops
        wide_in = any(_is_wide_int(dt) for _, dt, _ in op.inputs) and op.name not in INDEXING_OPS
        wide_out = any(_is_wide_int(dt) for _, dt, _ in op.outputs) and op.name not in INDEX_PRODUCING_OPS
        if wide_in or wide_out:
            found.append(("no-wide-dtype", f"int64 meets floating-point work in {op.namespace}.{op.name} "
                                           "outside the index plane"))
    return _dedupe(found, name)


def check_no_counter_reduction(sink: OpSink, entry: TracedEntry, name: str) -> List[Violation]:
    shape = entry.counters_shape
    if shape is None:
        return []
    found = []
    for op in sink.ops:
        if op.name in REDUCTION_OPS and any(s == tuple(shape) for s, _, _ in op.inputs):
            found.append(("no-counter-reduction", f"{op.namespace}.{op.name} reads the full {tuple(shape)} "
                                                  "counter tensor: register-served families must stay O(d·Q) "
                                                  "gathers"))
    return _dedupe(found, name)


def check_collectives_in_distributed_plane(sink: OpSink, entry: TracedEntry, name: str) -> List[Violation]:
    if name.startswith("distributed."):
        return []
    found = [("collectives-in-distributed-plane", f"collective {op.namespace}.{op.name} outside the "
                                                  "distributed plane")
             for op in sink.ops if op.namespace in COLLECTIVE_NAMESPACES]
    return _dedupe(found, name)


def check_no_counter_copy(sink: OpSink, entry: TracedEntry, name: str) -> List[Violation]:
    state = entry.state_bytes
    if not state:
        return [_violation("no-counter-copy", name, "entry declares the in-place contract but no state bytes")]
    found = [("no-counter-copy", f"{op.namespace}.{op.name} allocates {max(op.fresh)} bytes (>= the "
                                 f"{state} bytes of the summary): the batch copies the counters")
             for op in sink.ops if op.fresh and max(op.fresh) >= state]
    return _dedupe(found, name)


_CHECKERS = {
    "no-host-sync": check_no_host_sync,
    "no-wide-dtype": check_no_wide_dtype,
    "no-counter-reduction": check_no_counter_reduction,
    "collectives-in-distributed-plane": check_collectives_in_distributed_plane,
    "no-counter-copy": check_no_counter_copy,
}


def _where(stack) -> str:
    """The innermost frame of the port (outside this analyzer) in a stack,
    as ``path:line in function``, else the innermost frame."""
    for frame in reversed(stack):
        path = frame.filename.replace("\\", "/")
        if "/repro_torch/" in path and "/repro_torch/analysis/" not in path:
            return f"{path.split('/repro_torch/', 1)[1]}:{frame.lineno} in {frame.name}"
    frame = stack[-1]
    return f"{frame.filename}:{frame.lineno} in {frame.name}"


def _run(entry: TracedEntry, device: str) -> Tuple[OpSink, List[str]]:
    """Run ``entry`` once under a :class:`Recorder`; on the card also under
    the sync debug mode, returning where each synchronizing operation was
    called from."""
    syncs: List[str] = []
    cuda = torch.device(device).type == "cuda"
    with Recorder() as sink:
        if not cuda:
            entry.fn(*entry.args)
        else:
            torch.cuda.synchronize()

            def hook(message, category, filename, lineno, file=None, line=None):
                if "called a synchronizing" in str(message):
                    syncs.append(_where(traceback.extract_stack()[:-1]))

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = hook
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    entry.fn(*entry.args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
    return sink, syncs


def check_entry_point(ep: EntryPoint, fixture: Fixture = FIXTURE) -> List[Violation]:
    """Build and run one entry at ``fixture``; check its contracts."""
    try:
        if ep.name.startswith("distributed."):
            with one_rank_group(fixture.device):
                entry = ep.build(fixture)
                sink, syncs = _run(entry, fixture.device)
        else:
            entry = ep.build(fixture)
            sink, syncs = _run(entry, fixture.device)
    except Exception as exc:  # a broken fixture is itself a finding
        return [_violation("entry-point-broken", ep.name, f"fixture failed: {type(exc).__name__}: {exc}")]
    out: List[Violation] = []
    for contract in ep.contracts:
        out.extend(_CHECKERS[contract](sink, entry, ep.name))
    if syncs and "no-host-sync" in ep.contracts:
        out.extend(_dedupe((("no-host-sync", f"synchronizing CUDA operation at {where}") for where in syncs),
                           ep.name))
    return out


def run_dispatch_pass(
    entry_points: Optional[Iterable[EntryPoint]] = None,
    *,
    dynamic: bool = True,
    fixture: Fixture = FIXTURE,
) -> List[Violation]:
    """Check every registered entry point at ``fixture``; then run the
    dynamic checks on the live engines on its device."""
    out: List[Violation] = []
    for ep in entry_points if entry_points is not None else ENTRY_POINTS:
        out.extend(check_entry_point(ep, fixture))
    if dynamic and entry_points is None:
        for check_name, check in DYNAMIC_CHECKS.items():
            try:
                out.extend(check(fixture.device))
            except Exception as exc:
                out.append(_violation("entry-point-broken", check_name,
                                      f"dynamic check crashed: {type(exc).__name__}: {exc}"))
    return out


def reduces_full_counters(fn, counters_shape: Tuple[int, ...], *args) -> bool:
    """True iff running ``fn(*args)`` makes a reduction whose operand has
    exactly ``counters_shape``: the full counters reduced instead of served
    from the flow registers."""
    entry = TracedEntry(fn=fn, args=args, counters_shape=tuple(counters_shape))
    sink, _ = _run(entry, "cpu")
    return bool(check_no_counter_reduction(sink, entry, "<adhoc>"))

