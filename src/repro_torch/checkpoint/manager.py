"""Fault-tolerant checkpointing: atomic, async, with retention.

Port of ``src/repro/checkpoint/manager.py``, in the reference's file format,
so a checkpoint written by either package restores in the other:

- ``<dir>/step_%010d/arrays.npz`` holds one array per leaf (``leaf_i``) and
  ``manifest.json`` the ``index`` (each leaf's tree ``path``, ``key``,
  ``shape`` and ``dtype``), the caller's ``metadata``, the ``step``, the
  ``time`` and ``format: 1``.
- A leaf's path is the reference's ``jax.tree_util.keystr``: ``['k']`` for a
  dict key, ``.f`` for a named-tuple or dataclass field, ``[i]`` for a list
  or tuple item.  The port's state types flatten to the reference's own
  leaves: a :class:`GLavaSketch` to ``.counters``, ``.row_hash.a/.b``,
  ``.col_hash.a/.b``, ``.row_flows``, ``.col_flows``; a
  :class:`SlidingWindowSketch` to ``.slices``, ``.current`` (int32),
  ``.template.*`` (the template's counters and registers written as host
  zeros, no device buffer), ``.row_flows``, ``.col_flows``; a
  :class:`CompressorState` to ``.error``, ``.momentum``, ``.hash.a/.b``.
  Hash coefficients are uint32 on disk; bfloat16 tensors are written as
  float32 (exact) and cast back on restore.

- ATOMIC: writes go to ``step_<n>.tmp-<nonce>/`` and are renamed into place
  only after an fsync'd manifest lands (two-phase commit).
- ASYNC: ``save_async`` snapshots the state to host memory, then writes on a
  background thread.
- RETENTION: keep-last-k GC, which also removes orphaned ``.tmp-`` dirs.

Restoring needs ``like``, a state of the wanted structure: each leaf comes
back on ``like``'s device in ``like``'s dtype.  Sketches and windows are
rebuilt through ``repro_torch.convert`` (``sketch_from_arrays``,
``window_from_arrays``).  ``shardings`` is the reference's elastic reshard
path: a tree of :class:`~repro_torch.distributed.sharding.Placement` objects
beside ``like`` (``None`` where a leaf is whole) gives every rank its own
block of each leaf, whatever mesh the checkpoint was saved under; the
placement of a sketch is that of its counters, whose rows split over one
mesh axis (``convert.sketch_shard_from_arrays``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
import warnings
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.hashing import HashFamily
from repro_torch.core.sketch import GLavaSketch
from repro_torch.core.window import SlidingWindowSketch
from repro_torch.distributed.sharding import Placement, local_shard
from repro_torch.train.compression import CompressorState


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed to load: truncated/corrupt shard or manifest.
    Carries the offending ``step`` and ``path`` so the operator knows
    exactly which artifact to quarantine."""

    def __init__(self, step: int, path: Path, reason: str):
        self.step = int(step)
        self.path = Path(path)
        super().__init__(f"checkpoint step {step} is corrupt ({path}): {reason}")


# -- tree paths ---------------------------------------------------------------


def _sketch_leaves(sk: GLavaSketch, prefix: str):
    yield prefix + ".counters", sk.counters
    for name in ("row_hash", "col_hash"):
        fam = getattr(sk, name)
        yield f"{prefix}.{name}.a", fam.a_host
        yield f"{prefix}.{name}.b", fam.b_host
    yield prefix + ".row_flows", sk.row_flows
    yield prefix + ".col_flows", sk.col_flows


def _window_leaves(win: SlidingWindowSketch, prefix: str):
    cfg = win.config
    d, wr, wc = cfg.depth, cfg.width_rows, cfg.width_cols
    yield prefix + ".slices", win.slices
    yield prefix + ".current", np.int32(win.current)
    t = prefix + ".template"
    # The reference's template holds zero counters and registers; they are
    # written from a zero-stride host view (np.save streams it in chunks).
    yield t + ".counters", np.broadcast_to(np.zeros((), np.float32), (d, wr, wc))
    for name in ("row_hash", "col_hash"):
        fam = getattr(win.template, name)
        yield f"{t}.{name}.a", fam.a_host
        yield f"{t}.{name}.b", fam.b_host
    yield t + ".row_flows", np.zeros((d, wr), np.float32)
    yield t + ".col_flows", np.zeros((d, wc), np.float32)
    yield prefix + ".row_flows", win.row_flows
    yield prefix + ".col_flows", win.col_flows


def tree_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of ``tree`` in the reference's flatten order,
    paths as ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, GLavaSketch):
        return list(_sketch_leaves(tree, prefix))
    if isinstance(tree, SlidingWindowSketch):
        return list(_window_leaves(tree, prefix))
    if isinstance(tree, HashFamily):
        return [(prefix + ".a", tree.a_host), (prefix + ".b", tree.b_host)]
    if isinstance(tree, CompressorState):
        return (
            [(prefix + ".error", tree.error), (prefix + ".momentum", tree.momentum)]
            + tree_paths(tree.hash, prefix + ".hash")
        )
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in tree_paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in tree_paths(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _to_host(leaf: Any, copy: bool) -> np.ndarray:
    """A leaf as a host array; ``copy`` snapshots CPU tensors too, so later
    in-place updates of the live state do not reach it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()  # numpy has no bfloat16; widening is exact
        return t.to("cpu", copy=copy).numpy()
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _host_leaves(state: Any, copy: bool) -> List[Tuple[str, np.ndarray]]:
    return [(path, _to_host(leaf, copy)) for path, leaf in tree_paths(state)]


# -- restore: rebuild a state shaped like ``like`` ----------------------------

def _like_dtype(ref: Any) -> np.dtype:
    """The host dtype a leaf like ``ref`` is read as (bfloat16 as float32)."""
    if isinstance(ref, torch.Tensor):
        dtype = torch.float32 if ref.dtype == torch.bfloat16 else ref.dtype
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.asarray(ref).dtype


def _rebuild(like: Any, prefix: str, take: Callable[[str, Any], np.ndarray], sharding: Any = None) -> Any:
    """A state of ``like``'s structure whose leaves ``take(path, like_leaf)``
    supplies as host arrays; ``sharding`` (beside ``like``) cuts this rank's
    block of each leaf that has a :class:`Placement`."""
    if isinstance(like, GLavaSketch):
        a = {p[len(prefix):]: take(p, leaf) for p, leaf in tree_paths(like, prefix)}
        args = (
            like.config, a[".counters"], a[".row_flows"], a[".col_flows"],
            a[".row_hash.a"], a[".row_hash.b"], a[".col_hash.a"], a[".col_hash.b"],
        )
        if sharding is None:
            return convert.sketch_from_arrays(*args, device=like.device)
        spec = tuple(sharding.spec) + (None,) * (3 - len(sharding.spec))
        if spec[0] is not None or spec[2] is not None or not isinstance(spec[1], str):
            raise ValueError(f"a sketch's counters split over their rows along one mesh axis, not {sharding.spec}")
        return convert.sketch_shard_from_arrays(*args, mesh=sharding.mesh, model_axis=spec[1], device=like.device)
    placed = isinstance(sharding, Placement) and isinstance(like, (torch.Tensor, np.ndarray))
    if sharding is not None and not placed and not isinstance(like, (dict, list, tuple)):
        raise ValueError(f"{prefix or 'the state'}: a Placement applies to a tensor or a sketch, "
                         f"and shardings must match the state's structure")
    if isinstance(like, SlidingWindowSketch):
        t = prefix + ".template"
        return convert.window_from_arrays(
            like.config,
            take(prefix + ".slices", like.slices),
            take(prefix + ".current", np.int32(like.current)),
            take(prefix + ".row_flows", like.row_flows),
            take(prefix + ".col_flows", like.col_flows),
            take(t + ".row_hash.a", like.template.row_hash.a_host),
            take(t + ".row_hash.b", like.template.row_hash.b_host),
            take(t + ".col_hash.a", like.template.col_hash.a_host),
            take(t + ".col_hash.b", like.template.col_hash.b_host),
            device=like.device,
        )
    if isinstance(like, HashFamily):
        return HashFamily.from_host(
            take(prefix + ".a", like.a_host), take(prefix + ".b", like.b_host), like.w, like.device
        )
    if isinstance(like, CompressorState):
        return CompressorState(
            error=_rebuild(like.error, prefix + ".error", take),
            momentum=_rebuild(like.momentum, prefix + ".momentum", take),
            hash=_rebuild(like.hash, prefix + ".hash", take),
            config=like.config,
        )
    if isinstance(like, dict):
        sub = sharding or {}
        return {k: _rebuild(v, f"{prefix}[{k!r}]", take, sub.get(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(
            _rebuild(getattr(like, f), f"{prefix}.{f}", take, None if sharding is None else getattr(sharding, f))
            for f in like._fields
        ))
    if isinstance(like, (list, tuple)):
        sub = sharding or [None] * len(like)
        return type(like)(_rebuild(x, f"{prefix}[{i}]", take, sub[i]) for i, x in enumerate(like))
    arr = take(prefix, like)
    if placed:
        arr = np.ascontiguousarray(local_shard(arr, sharding))
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.asarray(arr, order="C")).to(device=like.device, dtype=like.dtype)
    return arr


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, metadata: Optional[dict] = None):
        """Synchronous atomic save."""
        self._write(step, _host_leaves(state, copy=False), metadata or {})

    def save_async(self, step: int, state: Any, metadata: Optional[dict] = None):
        """Snapshot now, write in the background.  Joins any prior pending
        save first (at most one in flight)."""
        self.wait()
        leaves = _host_leaves(state, copy=True)  # snapshot before training mutates

        def work():
            try:
                self._write(step, leaves, metadata or {})
            except Exception as e:  # surfaced by wait()
                self._pending_error = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self):
        """Join the pending background save; re-raise its failure, if any."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise err

    def _write(self, step: int, leaves: List[Tuple[str, np.ndarray]], metadata: dict):
        tmp = self.dir / f"step_{step:010d}.tmp-{uuid.uuid4().hex[:8]}"
        final = self.dir / f"step_{step:010d}"
        tmp.mkdir(parents=True)
        arrays = {}
        index = []
        for i, (path, arr) in enumerate(leaves):
            arrays[f"leaf_{i}"] = arr
            index.append({"path": path, "key": f"leaf_{i}", "shape": list(arr.shape), "dtype": str(arr.dtype)})
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {"step": step, "time": time.time(), "index": index, "metadata": metadata, "format": 1}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # two-phase commit: rename only after the manifest is durable
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
        # drop orphaned tmp dirs from crashed saves
        for p in self.dir.glob("step_*.tmp-*"):
            shutil.rmtree(p, ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.name.count(".tmp-") or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None, shardings: Any = None,
                fill_missing: bool = False):
        """Restore a checkpoint into a state shaped like ``like``.

        ``shardings`` (optional) is a tree beside ``like`` whose entries are
        :class:`~repro_torch.distributed.sharding.Placement` objects or ``None``:
        each placed leaf comes back as this rank's block under its
        placement, the counterpart of the reference's ``NamedSharding``
        re-layout for the current mesh (the elastic reshard path).

        ``fill_missing=True`` is the schema-evolution path: leaves ``like``
        has and the checkpoint lacks (e.g. the flow registers of a sketch
        saved before registers existed) are filled, NaN for float dtypes
        (a stale read fails loudly) and 0 for integers, and their paths are
        listed in ``metadata["filled_leaves"]``; the caller recomputes them.

        A truncated or corrupt checkpoint raises
        :class:`CheckpointCorruptError`.  Restoring the LATEST step
        (``step=None``) falls back past a corrupt step to the previous
        retained one, with a warning; an explicit step never substitutes.

        Returns ``(state, metadata)``; ``metadata["step"]`` is always
        present."""
        if step is not None:
            return self._load_step(step, like, shardings, fill_missing)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        first_err: Optional[CheckpointCorruptError] = None
        for s in reversed(steps):
            try:
                return self._load_step(s, like, shardings, fill_missing)
            except CheckpointCorruptError as e:
                if first_err is None:
                    first_err = e
                warnings.warn(f"{e} — falling back to the previous retained step", RuntimeWarning, stacklevel=2)
        raise first_err

    def read_metadata(self, step: int) -> dict:
        """Just a step's manifest metadata (plus ``step``), no array I/O."""
        mpath = self.dir / f"step_{step:010d}" / "manifest.json"
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(step, mpath, f"unreadable manifest: {e}")
        metadata = dict(manifest.get("metadata") or {})
        if metadata.get("step") is None:
            metadata["step"] = manifest.get("step", step)
        return metadata

    def _load_step(self, step: int, like: Any, shardings: Any, fill_missing: bool):
        d = self.dir / f"step_{step:010d}"
        if not d.exists():
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.dir}")
        mpath = d / "manifest.json"
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(step, mpath, f"unreadable manifest: {e}")
        apath = d / "arrays.npz"
        try:
            data = np.load(apath)
            keys: Dict[str, str] = {e["path"]: e["key"] for e in manifest["index"]}
            # np.load is lazy and a truncated zip member fails only when read:
            # check the archive's members now, read each one as it is taken.
            missing = set(keys.values()) - set(data.files)
            if missing:
                raise KeyError(f"members {sorted(missing)} absent")
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            raise CheckpointCorruptError(step, apath, f"truncated or corrupt shard: {e}")
        if like is None:
            raise ValueError("restore requires `like` for the tree structure")
        filled: List[str] = []

        def take(path: str, ref: Any) -> np.ndarray:
            dtype = _like_dtype(ref)
            if path not in keys:
                if not fill_missing:
                    raise KeyError(f"checkpoint missing leaf {path}")
                filled.append(path)
                return np.full(tuple(ref.shape), np.nan if np.issubdtype(dtype, np.inexact) else 0, dtype)
            try:
                arr = data[keys[path]]
            except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
                raise CheckpointCorruptError(step, apath, f"truncated or corrupt shard: {e}")
            return arr.astype(dtype, copy=False)

        with data:
            state = _rebuild(like, "", take, shardings)
        metadata = dict(manifest["metadata"])
        if filled:
            metadata["filled_leaves"] = filled
        # The manifest step is authoritative; caller metadata may omit it.
        if metadata.get("step") is None:
            metadata["step"] = manifest["step"]
        return state, metadata
