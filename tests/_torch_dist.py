"""Spawned gloo ranks for the port's distributed parity tests.

:func:`run_ranks` starts ``world`` processes through
:func:`repro_torch.distributed.spawn.run_ranks`; each joins a gloo process
group through a ``FileStore`` under the test's ``tmp_path`` (no TCP port, so
parallel test workers never collide), runs one scenario of this module and
saves what it found.  A rank that raises exits nonzero, and the parent fails
on any nonzero exit code or on a rank still running at the deadline (which
it kills).  This module imports neither ``jax`` nor ``repro``: the ranks run
the port alone, on numpy inputs the test prepared.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.distributed import spawn


def run_ranks(scenario, world: int, tmp_path: Path, timeout: float = 90.0, backend: str = "gloo", **kwargs):
    """Run ``scenario(rank, world, out_dir, **kwargs)`` on ``world`` spawned
    ranks of a ``backend`` group (gloo; NCCL for one rank on the card);
    return each rank's result, rank-ordered."""
    out = Path(tmp_path) / f"ranks-{scenario.__name__}"
    return spawn.run_ranks(scenario, world, out, kwargs=kwargs, backend=backend, timeout=timeout)


def _np(t):
    return t.detach().cpu().numpy().copy()


# -- the sketch plane: ingest and queries against the reference's shard_map -------


def sketch_plane(rank, world, out, meshes, inputs):
    """For each mesh shape and each config of ``inputs`` (an npz the test
    wrote from the reference's oracle run): open this rank's shard of the
    reference's empty sketch, run ``distributed_ingest`` on both batches,
    then the edge query and both point-query paths.  Returns the shard,
    the registers, the gathered counters and the answers."""
    from repro_torch.convert import sketch_shard_from_arrays
    from repro_torch.core import distributed as D
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.distributed.mesh import Mesh

    data = dict(np.load(inputs))
    res = {}
    for shape in meshes:
        mesh = Mesh(shape, ("data", "model"))
        for name in ("square", "nonsquare"):
            d, wr, wc = data[f"{name}/shape"]
            cfg = SketchConfig(depth=int(d), width_rows=int(wr), width_cols=int(wc))
            square = cfg.is_square
            shard = sketch_shard_from_arrays(
                cfg, np.zeros((d, wr, wc), np.float32), np.zeros((d, wr), np.float32), np.zeros((d, wc), np.float32),
                data[f"{name}/row_a"], data[f"{name}/row_b"],
                None if square else data[f"{name}/col_a"], None if square else data[f"{name}/col_b"],
                mesh=mesh,
            )
            for b in ("b1", "b2"):
                src, dst, w = (torch.from_numpy(data[f"{b}/{k}"].astype(np.int64 if k != "w" else np.float32))
                               for k in ("src", "dst", "w"))
                D.distributed_ingest(mesh, shard, src, dst, w)
            qs, qd = (torch.from_numpy(data[k].astype(np.int64)) for k in ("q/src", "q/dst"))
            pk = torch.from_numpy(data["q/keys"].astype(np.int64))
            key = f"{shape[0]}x{shape[1]}/{name}"
            res[f"{key}/shard"] = _np(shard.counters)
            res[f"{key}/row_flows"] = _np(shard.row_flows)
            res[f"{key}/col_flows"] = _np(shard.col_flows)
            res[f"{key}/whole"] = _np(D.gather_rows(mesh, shard).counters)
            res[f"{key}/edge"] = _np(D.distributed_edge_query(mesh, shard, qs, qd))
            for direction in ("in", "out"):
                for regs in (True, False):
                    res[f"{key}/{direction}/{regs}"] = _np(
                        D.distributed_point_query(mesh, shard, pk, direction, use_registers=regs))
        res[f"{shape[0]}x{shape[1]}/coords"] = (mesh.coords["data"], mesh.coords["model"])
    return res


# -- checkpoints that reshard --------------------------------------------------------


def reshard(rank, world, out):
    """The counterpart of ``tests/test_elastic_reshard.py``: a (64, 32)
    tensor placed ``("data", "model")`` on a (2, 4) mesh is assembled and
    saved, then restored under a (4, 2) mesh placed ``("model", "data")``;
    a sketch saved under (2, 4) restores its (4, 2) shard."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import distributed as D
    from repro_torch.core.sketch import GLavaSketch, SketchConfig
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import Placement, gather_block, local_shard

    mesh_a = Mesh((2, 4), ("data", "model"))
    mesh_b = Mesh((4, 2), ("data", "model"))
    w = torch.arange(64.0 * 32).reshape(64, 32)
    block_a = local_shard(w, Placement(mesh_a, ("data", "model"))).clone()
    whole = gather_block(block_a, Placement(mesh_a, ("data", "model")), (64, 32))
    cfg = SketchConfig(depth=3, width_rows=64, width_cols=48)
    sk = GLavaSketch.empty(cfg, 3)
    g = torch.Generator().manual_seed(7)
    sk.update_(torch.randint(0, 500, (300,), generator=g), torch.randint(0, 500, (300,), generator=g),
               torch.randint(1, 5, (300,), generator=g).float())
    shard_a = D.shard_sketch(mesh_a, sk)
    whole_sk = D.gather_rows(mesh_a, shard_a)
    mgr = CheckpointManager(Path(out) / "ckpt")
    if rank == 0:
        mgr.save(10, {"w": whole, "sketch": whole_sk}, {"step": 10})
    mesh_a.barrier()
    like = {"w": torch.zeros(64, 32), "sketch": D.empty_shard(mesh_b, cfg, 0)}
    sh_b = {"w": Placement(mesh_b, ("model", "data")), "sketch": D.counter_placement(mesh_b)}
    restored, meta = mgr.restore(like=like, shardings=sh_b)
    return {
        "step": meta["step"],
        "block_a": _np(block_a),
        "whole": _np(whole),
        "w_b": _np(restored["w"]),
        "sketch_shard_b": _np(restored["sketch"].counters),
        "sketch_rows_b": _np(restored["sketch"].row_flows),
        "sketch_whole": _np(sk.counters),
        "sketch_want_b": _np(D.shard_sketch(mesh_b, sk).counters),
    }


# -- mesh sessions against the reference's local session -------------------------------


def _values(results):
    out = []
    for r in results:
        v = r.value
        out.append(tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
    return out


def mesh_session(rank, world, out, mesh_shape, cases):
    """For each case (a config, the reference's empty-sketch leaves, the
    batches and the query batch, from an npz the test wrote): a mesh
    session on ``mesh_shape`` on the reference's hash family subscribes the
    query batch every mutation, ingests the batches (odd lengths, and
    batches large enough to be pre-aggregated), answers the batch once
    more, checkpoints, and a fresh mesh session restores both that
    checkpoint and the reference's."""
    from repro_torch.api import GraphStream, Query, QueryBatch
    from repro_torch.convert import sketch_from_arrays
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.distributed.mesh import Mesh

    mesh = Mesh(mesh_shape, ("data", "model"))
    res = {}
    for case in cases:
        data = dict(np.load(case))
        tag = Path(case).stem
        d, wr, wc = (int(x) for x in data["shape"])
        cfg = SketchConfig(depth=d, width_rows=wr, width_cols=wc, directed=bool(data["directed"]))
        whole = sketch_from_arrays(
            cfg, np.zeros((d, wr, wc), np.float32), np.zeros((d, wr), np.float32), np.zeros((d, wc), np.float32),
            data["row_a"], data["row_b"], data.get("col_a"), data.get("col_b"),
        )
        u, v = data["q/u"], data["q/v"]
        batch = QueryBatch([
            Query.edge(u, v), Query.in_flow(u[:16]), Query.out_flow(u[:16]), Query.heavy(u[:8], theta=0.05),
            Query.subgraph(u[:3], v[:3]), Query.subgraph(u[3:8], v[3:8]),
            *([Query.reach(u[:12], v[:12])] if cfg.is_square else []),
        ])
        ckpt = Path(out) / f"ckpt-{tag}"
        gs = GraphStream.open(sketch=whole, device="cpu", mesh=mesh, checkpoint_dir=str(ckpt))
        sub = gs.subscribe(batch, every=1, name="standing")
        receipts = []
        for i in range(int(data["n_batches"])):
            r = gs.ingest(data[f"b{i}/src"], data[f"b{i}/dst"], data[f"b{i}/w"])
            receipts.append((r.epoch, r.n_edges, None if r.touched_keys is None else r.touched_keys.copy()))
        events = [(e.tick, e.epoch, _values(e.results)) for e in sub.poll()]
        res[f"{tag}/events"] = events
        res[f"{tag}/receipts"] = receipts
        res[f"{tag}/results"] = _values(gs.query(batch))
        res[f"{tag}/refreshes"] = (gs.stats.closure_refreshes, gs.stats.closure_incremental_refreshes)
        snap = gs.sketch
        res[f"{tag}/sketch"] = [_np(getattr(snap, f)) for f in ("counters", "row_flows", "col_flows")]
        res[f"{tag}/shard_rows"] = gs._sketch.counters.shape[1]
        res[f"{tag}/step"] = gs.checkpoint()
        # The reference's local checkpoint, restored into a mesh session.
        back = GraphStream.open(sketch=whole, device="cpu", mesh=mesh, checkpoint_dir=str(data["ref_ckpt"]))
        res[f"{tag}/ref_restored_step"] = back.restore()
        rs = back.sketch
        res[f"{tag}/ref_restored"] = [_np(getattr(rs, f)) for f in ("counters", "row_flows", "col_flows")]
        res[f"{tag}/ref_restored_results"] = _values(back.query(batch))
    res["refusals"] = _mesh_refusals(mesh, Path(out))
    return res


def _mesh_refusals(mesh, out_dir):
    """What a mesh session refuses, as (kind, message) pairs: a window and
    fused ingest; then a WAL, ``recover()`` and ``merge()`` with a local
    session, which it accepts (``("none", "")``)."""
    from repro_torch.api import GraphStream

    out = []
    attempts = [
        lambda: GraphStream.open("smoke", device="cpu", mesh=mesh, window_slices=4),
        lambda: GraphStream.open("smoke", device="cpu", mesh=mesh, ingest_backend="fused"),
        lambda: GraphStream.open("smoke", device="cpu", mesh=mesh, wal_dir=str(out_dir / "wal-open")),
        lambda: GraphStream.open("smoke", device="cpu", mesh=mesh, wal_dir=str(out_dir / "wal-recover")).recover(),
        lambda: GraphStream.open("smoke", device="cpu", mesh=mesh).merge(GraphStream.open("smoke", device="cpu")),
    ]
    for attempt in attempts:
        try:
            attempt()
            out.append(("none", ""))
        except (ValueError, NotImplementedError) as e:
            out.append((type(e).__name__, str(e)))
    return out


# -- the durable mesh session, against the reference's local session ------------------
#
# The scenario functions below take a session (or a function that opens
# one) and the Query class of its package, so one function runs the
# reference's local session in the test process and the port's mesh session
# on every rank.


def event_key(ev):
    """A subscription event as plain values: name, tick, epoch, every
    answer as floats, alarm."""
    vals = tuple(float(x) for r in ev.results for x in np.asarray(r.value).ravel())
    return (ev.name, ev.tick, ev.epoch, vals, ev.alarm)


def _subscribed(gs, query):
    return gs.subscribe(query.in_flow(7), query.reach(3, 9), every=1, name="m",
                        alarm=lambda rs: bool(np.asarray(rs[0].value) > 5))


def state_of(gs):
    """A session's whole summary (gathered on a mesh) as numpy, from either
    package and any device."""
    sk = gs.sketch
    leaves = (getattr(sk, f) for f in ("counters", "row_flows", "col_flows"))
    return [x.cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x).copy() for x in leaves]


def _drive(gs, sub, batches, transcript, seqs, ckpt_every):
    for s, d, w, i in batches:
        seqs.append(gs.ingest(s, d, w).wal_seq)
        transcript.extend(event_key(e) for e in sub.poll())
        if (i + 1) % ckpt_every == 0:
            gs.checkpoint()


def crash_run(open_session, query, batches, crash_at, ckpt_every):
    """Drive ``batches`` through a durable session, checkpointing every
    ``ckpt_every`` batches; crash after ``crash_at`` (drop the session, no
    checkpoint); a fresh session subscribes, seeks to the consumed tick,
    recovers and finishes the stream.  Returns the consumed transcript,
    the report, each receipt's ``wal_seq``, the deduplicated events and the
    final state."""
    numbered = [(s, d, w, i) for i, (s, d, w) in enumerate(batches)]
    gs = open_session()
    sub = _subscribed(gs, query)
    got, seqs = [], []
    _drive(gs, sub, numbered[:crash_at], got, seqs, ckpt_every)
    consumed = sub.ticks
    del gs, sub  # the crash: no close, no last checkpoint
    gs = open_session()
    sub = _subscribed(gs, query)
    sub.seek(consumed)
    report = gs.recover()
    got.extend(event_key(e) for e in sub.poll())
    _drive(gs, sub, numbered[crash_at:], got, seqs, ckpt_every)
    return {"transcript": got, "report": (report.step, report.mutations_replayed, report.epoch, report.wal_seq),
            "seqs": seqs, "wal_seq": gs.wal_seq, "deduped": sub.events_deduped, "state": state_of(gs)}


def barrier_run(open_session, open_other, batches):
    """Ingest, merge another session in, ingest, crash; a fresh session's
    ``recover()`` must refuse to replay past the merge barrier.  Returns
    its error message (None if it recovered)."""
    gs = open_session()
    gs.ingest(*batches[0])
    other = open_other()
    other.ingest(*batches[1])
    gs.merge(other)
    gs.ingest(*batches[2])
    del gs
    try:
        open_session().recover()
    except RuntimeError as e:
        return str(e)
    return None


def merge_run(receiver, giver, batches, query):
    """``receiver`` takes the first half of ``batches``, ``giver`` the second,
    then ``receiver.merge(giver)`` and one more batch into ``receiver``.
    Returns the merged state, the giver's state before the merge and after
    the receiver's next batch (merge aliases neither operand), the
    receiver's epoch, edge count and the transcript of a subscription that
    ticks on the merge."""
    half = len(batches) // 2
    sub = _subscribed(receiver, query)
    for b in batches[:half]:
        receiver.ingest(*b)
    for b in batches[half:]:
        giver.ingest(*b)
    before = state_of(giver)
    receiver.merge(giver)
    merged = state_of(receiver)
    receiver.ingest(*batches[0])
    return {"merged": merged, "giver_before": before, "giver_after": state_of(giver),
            "after": state_of(receiver), "epoch": receiver.epoch,
            "edges": receiver.stats.edges_ingested, "transcript": [event_key(e) for e in sub.poll()]}


def family_refusal(receiver, giver):
    """The error ``receiver.merge(giver)`` raises for a foreign hash family."""
    try:
        receiver.merge(giver)
    except ValueError as e:
        return str(e)
    return None


def gc_run(open_session, batches, oldest_step):
    """Checkpoint after every batch (the session keeps 2), crash after the
    last batch, and recover from the OLDER retained checkpoint
    (``oldest_step(session)``): the WAL must still hold its suffix.  Returns
    the report and the state."""
    gs = open_session()
    for b in batches[:-1]:
        gs.ingest(*b)
        gs.checkpoint()
    gs.ingest(*batches[-1])
    del gs
    gs = open_session()
    report = gs.recover(step=oldest_step(gs))
    return {"report": (report.step, report.mutations_replayed, report.epoch, report.wal_seq),
            "state": state_of(gs)}


def durable_mesh(rank, world, out, mesh_shape, inputs):
    """The durable mesh session on ``mesh_shape`` (the reference's family,
    integer batches, from the npz ``inputs``): a crash at every batch
    boundary and recovery, the merge barrier, the three merge pairings, the
    refused foreign family, and WAL GC against a retained checkpoint.  Rank
    0 writes every log under ``out``; the test reads their bytes."""
    from repro_torch.api import GraphStream, Query
    from repro_torch.convert import sketch_from_arrays
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.distributed.mesh import Mesh

    mesh = Mesh(mesh_shape, ("data", "model"))
    data = dict(np.load(inputs))
    out = Path(out)
    d, wr, wc = (int(x) for x in data["shape"])
    cfg = SketchConfig(depth=d, width_rows=wr, width_cols=wc)
    zeros = (np.zeros((d, wr, wc), np.float32), np.zeros((d, wr), np.float32), np.zeros((d, wc), np.float32))

    def whole(tag):
        return sketch_from_arrays(cfg, *zeros, data[f"{tag}/row_a"], data[f"{tag}/row_b"])

    batches = [(data[f"b{i}/src"], data[f"b{i}/dst"], data[f"b{i}/w"]) for i in range(int(data["n_batches"]))]
    ckpt_every = int(data["ckpt_every"])

    def opener(on_mesh=True, family="a", **kw):
        def open_session():
            return GraphStream.open(sketch=whole(family), device="cpu", mesh=mesh if on_mesh else None,
                                    double_buffer=False, **kw)
        return open_session

    def durable(name, **kw):
        return opener(wal_dir=str(out / name / "wal"), checkpoint_dir=str(out / name / "ckpt"), **kw)

    res = {}
    for k in range(len(batches) + 1):
        res[f"crash{k}"] = crash_run(durable(f"crash{k}"), Query, batches, k, ckpt_every)
    res["barrier"] = barrier_run(durable("barrier"), opener(), batches)
    pairings = {
        "mesh_into_mesh": (durable("merge-mm"), opener()),
        "local_into_mesh": (durable("merge-lm"), opener(on_mesh=False)),
        "mesh_into_local": (opener(on_mesh=False), opener()),
    }
    for name, (rec, giv) in pairings.items():
        res[name] = merge_run(rec(), giv(), batches, Query)
    res["foreign"] = [
        family_refusal(opener()(), opener(family="b")()),
        family_refusal(opener()(), opener(on_mesh=False, family="b")()),
        family_refusal(opener(on_mesh=False)(), opener(family="b")()),
    ]
    res["gc"] = gc_run(durable("gc", keep=2), batches, lambda gs: gs._ckpt.all_steps()[0])
    return res


def log_guarantees(rank, world, out, mesh_shape, delay):
    """What every rank of a durable mesh session on ``mesh_shape`` waits for
    and refuses.  Rank 0's first append is held back ``delay`` seconds:
    each rank returns the wall time its ``ingest`` returned, and rank 0 the
    time its append did.  Rank 0's next append fails: each rank returns
    the error its ``ingest`` raised, and its summary after.  Then the other
    ranks open the session on a directory of their own while rank 0's holds
    a log: each rank returns the error the opening raised."""
    import time

    from repro_torch.api import GraphStream
    from repro_torch.distributed.mesh import Mesh

    mesh = Mesh(mesh_shape, ("data", "model"))
    out = Path(out)
    rng = np.random.default_rng(5)
    batch = (rng.integers(0, 100, 40).astype(np.uint32), rng.integers(0, 100, 40).astype(np.uint32),
             np.ones(40, np.float32))
    gs = GraphStream.open("smoke", device="cpu", mesh=mesh, double_buffer=False, wal_dir=str(out / "shared"))
    res = {}
    if rank == 0:
        append = gs._wal.append_edges

        def held_back(*args, **kwargs):
            time.sleep(delay)
            seq = append(*args, **kwargs)
            res["appended"] = time.time()
            return seq

        gs._wal.append_edges = held_back
    res["seq"] = gs.ingest(*batch).wal_seq
    res["returned"] = time.time()
    if rank == 0:
        def failing(*args, **kwargs):
            raise OSError("disk full")

        gs._wal.append_edges = failing
    try:
        gs.ingest(*batch)
        res["failed"] = None
    except (OSError, RuntimeError) as e:
        res["failed"] = (type(e).__name__, str(e))
    res["after"] = (gs.wal_seq, gs.stats.edges_ingested, float(gs.sketch.counters.sum()))
    own = out / ("shared" if rank == 0 else f"own-{rank}")
    try:
        GraphStream.open("smoke", device="cpu", mesh=mesh, wal_dir=str(own))
        res["own_dir"] = None
    except RuntimeError as e:
        res["own_dir"] = str(e)
    return res


# -- the data-parallel compressed step ------------------------------------------------


def _flat(tree):
    from repro_torch.tree import tree_leaves

    return np.concatenate([_np(x).ravel() for x in tree_leaves(tree)])


def compressed_steps(rank, world, out, inputs, device="cpu"):
    """The two-rank compressed step (``axis_name="data"``) from the state
    ``inputs`` holds (written by :func:`save_train_inputs`) on ``device``
    (every rank on card 0 for "cuda"): each rank takes its own batch of
    every step.  Returns per step the loss, the flat parameters, this
    rank's error feedback and the sketch momentum."""
    from repro_torch.distributed.mesh import Mesh

    if device != "cpu":
        torch.cuda.set_device(0)
    mesh = Mesh((world,), ("data",))
    state, step, batches = load_train_inputs(inputs, axis_name="data", mesh=mesh, device=device)
    steps = []
    for batch in batches:
        state, m = step(state, {k: v[rank] for k, v in batch.items()})
        steps.append((float(m["loss"]), _flat(state["params"]), _np(state["comp"].error),
                      _np(state["comp"].momentum)))
    return steps


def emulate_steps(path, device="cpu"):
    """:func:`compressed_steps`'s two workers in one process on ``device``:
    both gradients at one set of parameters, the two tables added, each
    worker's decode with its error feedback (the two decodes must agree),
    one AdamW step.  Returns what :func:`compressed_steps` returns, with
    both workers' error feedback."""
    from repro_torch.kernels.countsketch.ops import hash_indices
    from repro_torch.train import compression as comp
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    data = torch.load(path, weights_only=False)
    state, _, batches = load_train_inputs(path, device=device)
    loss_fn, ocfg = loss_for(data["kind"]), opt.AdamWConfig(**data["ocfg"])
    cstates = [state["comp"], state["comp"]]
    params, ostate = state["params"], state["opt"]
    out = []
    for batch in batches:
        losses, flats = [], []
        for k in range(2):
            (loss, _), grads = trainer.value_and_grad(loss_fn, params, {n: v[k] for n, v in batch.items()})
            flat, spec = comp.flatten_grads(grads)
            losses.append(loss)
            flats.append(flat)
        hashes = hash_indices(cstates[0].hash, flats[0].shape[0]) if device == "cpu" else None
        tables = [comp._sketch(c, f + c.error, hashes) for c, f in zip(cstates, flats)]
        updates = []
        for k in range(2):
            other = tables[1 - k]
            update, cstates[k] = comp.roundtrip(cstates[k], flats[k], lambda t, other=other: t + other)
            updates.append(update)
        assert torch.equal(updates[0], updates[1])
        params, ostate, _ = opt.apply_adamw(ocfg, ostate, params, comp.unflatten_grads(updates[0], spec))
        loss = (losses[0] + losses[1]) / 2
        out.append((float(loss), _flat(params), [_np(c.error) for c in cstates], _np(cstates[0].momentum)))
    return out


def save_train_inputs(path, kind, params, error, momentum, hash_a, hash_b, ccfg, ocfg, batches):
    """The numpy inputs of :func:`compressed_steps` (``kind`` is "tiny", the
    tiny transformer preset, or "linear", the loss ``sum(w · x)`` whose
    gradient is the batch's integer column sums)."""
    torch.save(dict(kind=kind, params=params, error=error, momentum=momentum, hash_a=hash_a, hash_b=hash_b,
                    ccfg=ccfg, ocfg=ocfg, batches=batches), path)


def loss_for(kind):
    from repro_torch.launch.train_lm import PRESETS
    from repro_torch.models import transformer as tfm

    if kind == "tiny":
        cfg = PRESETS["tiny"]
        return lambda p, b: tfm.loss_fn(cfg, p, b["tokens"])
    return lambda p, b: ((p["w"] * b["x"]).sum(), {})


def load_train_inputs(path, axis_name=None, mesh=None, device="cpu"):
    """``(state, step, batches)`` of the port from :func:`save_train_inputs`'s
    file, on ``device``: the step is
    ``compressed_data_parallel_step(axis_name=, mesh=)``."""
    from repro_torch.convert import compressor_state_from_arrays, transformer_params_from_arrays
    from repro_torch.launch.train_lm import PRESETS
    from repro_torch.train import compression as comp
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    data = torch.load(path, weights_only=False)
    if data["kind"] == "tiny":
        params = transformer_params_from_arrays(PRESETS["tiny"], data["params"], device)
    else:
        params = {k: torch.from_numpy(np.array(v)).to(device) for k, v in data["params"].items()}
    ocfg, ccfg = opt.AdamWConfig(**data["ocfg"]), comp.CompressorConfig(**data["ccfg"])
    cstate = compressor_state_from_arrays(ccfg, data["error"], data["momentum"], data["hash_a"], data["hash_b"],
                                          device)
    state = {"params": params, "opt": opt.init_adamw(ocfg, params), "comp": cstate}
    step = trainer.compressed_data_parallel_step(loss_for(data["kind"]), ocfg, ccfg, axis_name=axis_name, mesh=mesh)
    batches = [{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()} for b in data["batches"]]
    return state, step, batches


# -- the LM's sharded forms ------------------------------------------------------------


def local_block(a, mesh, seq_axis=1):
    """This rank's block of a global (B, S, ...) array: the batch over the
    data axis, the sequence over ``"model"``."""
    b, s = a.shape[0] // mesh.shape["data"], a.shape[seq_axis] // mesh.shape["model"]
    i, j = mesh.coords["data"], mesh.coords["model"]
    return a[i * b:(i + 1) * b, j * s:(j + 1) * s]


def lm_sharded(rank, world, out, meshes, moe_cases, halo_cases, forward_cases, device="cpu"):
    """On each of ``meshes`` (("data", "model") shapes): ``moe_ffn_sharded`` for
    each of ``moe_cases`` (name -> (inputs npz, MoEArgs without a mesh)),
    ``swa_attention_halo`` for each of ``halo_cases`` (name -> (npz of global
    q, k, v, window, q_chunk)), and the transformer's ``forward`` on this
    rank's tokens with ``attn_halo_mesh`` for each of ``forward_cases``
    (name -> (config without a mesh, npz of the parameter tree and tokens)).
    Returns each output (this rank's block), the aux losses, the mesh's
    collective records and the coordinates, under keys that start with the
    mesh's ``"DxM"``."""
    from repro_torch.distributed.mesh import Mesh

    if device != "cpu":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)  # four ranks share the host's cores
    res = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for shape in meshes:
        mesh = Mesh(shape, ("data", "model"))
        res.update({f"{shape[0]}x{shape[1]}/{k}": v for k, v in _lm_cases(mesh, t, moe_cases, halo_cases,
                                                                          forward_cases).items()})
    return res


def _lm_cases(mesh, t, moe_cases, halo_cases, forward_cases):
    import dataclasses

    from repro_torch.models import layers, transformer as tfm

    res = {"coords": (mesh.coords["data"], mesh.coords["model"])}

    for name, (path, args) in moe_cases.items():
        data = dict(np.load(path))
        args = dataclasses.replace(args, mesh=mesh)
        shards = layers.moe_weight_shards(*(t(data[k]) for k in ("wg", "wu", "wd")), args)
        y, aux = layers.moe_ffn_sharded(t(local_block(data["x"], mesh)), t(data["router"]), *shards, args)
        res[f"moe/{name}"], res[f"aux/{name}"] = _np(y), float(aux)
    for name, path in halo_cases.items():
        data = dict(np.load(path))
        q, k, v = (t(local_block(data[n], mesh)) for n in ("q", "k", "v"))
        o = layers.swa_attention_halo(q, k, v, sliding_window=int(data["window"]), mesh=mesh,
                                      q_chunk=int(data["q_chunk"]))
        res[f"halo/{name}"] = _np(o)
    for name, (cfg, path) in forward_cases.items():
        data = dict(np.load(path))
        cfg = dataclasses.replace(cfg, attn_halo_mesh=mesh)
        tree = {"layers": {}}
        for key, value in data.items():
            if key.startswith("layers/"):
                tree["layers"][key[7:]] = t(value)
            elif key != "tokens":
                tree[key] = t(value)
        with torch.no_grad():
            logits, aux = tfm.forward(cfg, tree, t(local_block(data["tokens"], mesh)))
        res[f"forward/{name}"] = _np(logits)
    res["collectives"] = list(mesh.collectives)
    return res


# -- on the card --------------------------------------------------------------------


def card_plane(rank, world, out, mesh_shape):
    """The plane on CUDA tensors (every rank on card 0: gloo for several
    ranks, NCCL for one): ``distributed_ingest`` on an odd batch, the edge
    query and both point-query paths, against the local sketch on the CPU;
    the kernels' launches on this rank."""
    from repro_torch.core import distributed as D
    from repro_torch.core import queries
    from repro_torch.core.sketch import GLavaSketch, SketchConfig
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.kernels.flow import ops as flow_ops
    from repro_torch.kernels.ingest import ops as ingest_ops
    from repro_torch.kernels.query import ops as query_ops

    torch.cuda.set_device(0)
    mesh = Mesh(mesh_shape, ("data", "model"))
    cfg = SketchConfig(depth=3, width_rows=256, width_cols=192)
    local = GLavaSketch.empty(cfg, 5)
    shard = D.shard_sketch(mesh, local).to("cuda")
    g = torch.Generator().manual_seed(11)
    src, dst = torch.randint(0, 5000, (4099,), generator=g), torch.randint(0, 5000, (4099,), generator=g)
    w = torch.randint(1, 9, (4099,), generator=g).float()
    launches = [f.launches for f in (ingest_ops.ingest_scatter, query_ops.edge_query_cells, flow_ops.flows)]
    D.distributed_ingest(mesh, shard, src.cuda(), dst.cuda(), w.cuda())
    local.update_(src, dst, w)
    whole = D.gather_rows(mesh, shard)
    same = {
        "counters": torch.equal(whole.counters.cpu(), local.counters),
        "registers": torch.equal(shard.row_flows.cpu(), local.row_flows)
        and torch.equal(shard.col_flows.cpu(), local.col_flows),
        "edge": torch.equal(D.distributed_edge_query(mesh, shard, src[:500].cuda(), dst[:500].cuda()).cpu(),
                            queries.edge_query(local, src[:500], dst[:500])),
    }
    for direction, fn in (("in", queries.node_in_flow), ("out", queries.node_out_flow)):
        got = D.distributed_point_query(mesh, shard, src[:300].cuda(), direction, use_registers=False)
        same[direction] = torch.equal(got.cpu(), fn(local, src[:300]))
    after = [f.launches for f in (ingest_ops.ingest_scatter, query_ops.edge_query_cells, flow_ops.flows)]
    return {"same": same, "launches": [b - a for a, b in zip(launches, after)]}


def card_durable(rank, world, out, mesh_shape, crash_at):
    """The durable mesh session on CUDA tensors (every rank on card 0): a
    crash after ``crash_at`` of 8 integer batches (a checkpoint every 3),
    recovery and the rest, against the same run of a local session on the
    CPU on the same hash family; this rank's B1 launches."""
    from repro_torch.api import GraphStream, Query
    from repro_torch.core.sketch import GLavaSketch, SketchConfig
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.kernels.ingest import ops as ingest_ops

    torch.cuda.set_device(0)
    mesh = Mesh(mesh_shape, ("data", "model"))
    whole = GLavaSketch.empty(SketchConfig(depth=3, width_rows=256, width_cols=256), 7)
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 100, n).astype(np.uint32), rng.integers(0, 100, n).astype(np.uint32),
                rng.integers(1, 5, n).astype(np.float32)) for n in (40, 40, 1100, 40, 40, 40, 40, 40)]
    out = Path(out)

    def opener(name, device, on_mesh):
        dirs = dict(wal_dir=str(out / name / "wal"), checkpoint_dir=str(out / name / "ckpt"))
        return lambda: GraphStream.open(sketch=whole, device=device, mesh=mesh if on_mesh else None, **dirs)

    before = ingest_ops.ingest_scatter.launches
    card = crash_run(opener("card", "cuda", True), Query, batches, crash_at, 3)
    launches = ingest_ops.ingest_scatter.launches - before
    host = crash_run(opener(f"cpu-{rank}", "cpu", False), Query, batches, crash_at, 3)
    card_log = {p.name: p.read_bytes() for p in sorted((out / "card" / "wal").glob("wal-*.seg"))}
    host_log = {p.name: p.read_bytes() for p in sorted((out / f"cpu-{rank}" / "wal").glob("wal-*.seg"))}
    same = {key: card[key] == host[key] for key in ("transcript", "report", "seqs", "wal_seq", "deduped")}
    same["state"] = all(np.array_equal(a, b) for a, b in zip(card["state"], host["state"]))
    same["log"] = card_log == host_log and bool(card_log)
    return {"same": same, "launches": launches, "replayed": card["report"][1]}


# -- the pipeline (distributed/pipeline.py) ---------------------------------------


def pipeline(rank, world, out, inputs, cases):
    """For each (mesh shape, axis names, microbatches) of ``cases``: the
    pipeline over the ``"pipe"`` axis of ``inputs``' stage-major weights on
    its microbatched input (the same on every rank).  Returns each case's
    output and the all-reduces its mesh recorded."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.pipeline import microbatch, pipeline_apply

    data = dict(np.load(inputs))
    res = {}
    for shape, names, n_micro in cases:
        mesh = Mesh(shape, names)
        s = mesh.size("pipe")
        ws, bs = torch.from_numpy(data[f"w{s}"]), torch.from_numpy(data[f"b{s}"])
        xm = microbatch(torch.from_numpy(data["x"]), n_micro)
        y = pipeline_apply(lambda p, h: torch.tanh(h @ p[0] + p[1]), (ws, bs), xm, mesh)
        res[f"{shape}/{n_micro}"] = (_np(y), len(mesh.collectives))
    return res
