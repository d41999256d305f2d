"""Parity of the port's distributed plane (paper §6.3) with the reference.

The port runs on gloo ranks spawned on the CPU (``tests/_torch_dist.py``).
Two oracles, as the reference's own mesh session cannot run on this host's
jax (its default ``onehot`` backend fails under ``shard_map``):

(a) the reference's ``core/distributed.py`` with ``backend="scatter"``, in a
    subprocess with 8 host devices on a ``(2, 4)`` ``("data", "model")`` mesh
    (batch lengths divisible by the data axis): counters, registers, the
    edge query and both point-query paths, and ``NamedSharding``'s block
    layout;
(b) the reference's LOCAL session, in this process, for what the
    reference's mesh session would have to equal (its own
    ``test_graphstream_mesh_matches_local``): odd and pre-aggregated
    batches, a query batch with reach, a subscription's transcript, and
    checkpoints both ways.

Integer weights: every comparison is exact.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.api import GraphStream as RefStream, Query as RefQuery, QueryBatch as RefBatch
from repro.core.sketch import SketchConfig as RefConfig

import _torch_dist
from _torch_dist import run_ranks
from repro_torch.api import GraphStream
from repro_torch.distributed.mesh import axis_groups, mesh_coords
from repro_torch.distributed.sharding import block_slices

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"square": (3, 64, 64), "nonsquare": (3, 64, 48)}
MESHES = {8: [(2, 4), (4, 2)], 2: [(1, 2), (2, 1)]}

_ORACLE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.distributed import distributed_edge_query, distributed_ingest, distributed_point_query
    from repro.core.sketch import GLavaSketch, SketchConfig
    from repro.distributed.sharding import sketch_plane_shardings

    inp = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    counter_sh, _ = sketch_plane_shardings(mesh)
    out = {}
    for name in ("square", "nonsquare"):
        d, wr, wc = (int(x) for x in inp[name + "/shape"])
        sk = GLavaSketch.empty(SketchConfig(depth=d, width_rows=wr, width_cols=wc), jax.random.key(0))
        out[name + "/row_a"], out[name + "/row_b"] = np.asarray(sk.row_hash.a), np.asarray(sk.row_hash.b)
        out[name + "/col_a"], out[name + "/col_b"] = np.asarray(sk.col_hash.a), np.asarray(sk.col_hash.b)
        sk = dataclasses.replace(sk, counters=jax.device_put(sk.counters, counter_sh))
        for b in ("b1", "b2"):
            sk = distributed_ingest(mesh, sk, *(jnp.asarray(inp[b + "/" + k]) for k in ("src", "dst", "w")),
                                    backend="scatter")
        for f in ("counters", "row_flows", "col_flows"):
            out[name + "/" + f] = np.asarray(getattr(sk, f))
        qs, qd, keys = (jnp.asarray(inp[k]) for k in ("q/src", "q/dst", "q/keys"))
        out[name + "/edge"] = np.asarray(distributed_edge_query(mesh, sk, qs, qd))
        for direction in ("in", "out"):
            for regs in (True, False):
                out[name + "/" + direction + "/" + str(regs)] = np.asarray(
                    distributed_point_query(mesh, sk, keys, direction, use_registers=regs))
    # NamedSharding's blocks: (device id, dim, start, stop) for each layout.
    devs = jax.devices()
    for shape in ((2, 4), (4, 2)):
        m = jax.sharding.Mesh(np.asarray(devs[:8]).reshape(shape), ("data", "model"))
        for tag, spec in (("dm", P("data", "model")), ("md", P("model", "data")),
                          ("rows", P(None, "model", None)), ("both", P(("data", "model")))):
            dims = (64, 32) if tag in ("dm", "md") else (3, 64, 48) if tag == "rows" else (64,)
            rows = []
            for dev, idx in NamedSharding(m, spec).devices_indices_map(dims).items():
                for i, sl in enumerate(idx):
                    rows.append((dev.id, i, sl.start or 0, dims[i] if sl.stop is None else sl.stop))
            out["layout/%dx%d/%s" % (shape + (tag,))] = np.asarray(rows)
    np.savez(sys.argv[2], **out)
    print("ORACLE_OK")
    """
)


def _batches(rng):
    """Two integer-weighted batches (256 and 4,096 edges, divisible by every
    data axis) and the query keys."""
    out = {}
    for b, n in (("b1", 256), ("b2", 4096)):
        out[f"{b}/src"] = rng.integers(0, 700, n).astype(np.uint32)
        out[f"{b}/dst"] = rng.integers(0, 700, n).astype(np.uint32)
        out[f"{b}/w"] = rng.integers(1, 5, n).astype(np.float32)
    out["q/src"] = np.concatenate([out["b2/src"][:48], rng.integers(0, 700, 16).astype(np.uint32)])
    out["q/dst"] = np.concatenate([out["b2/dst"][:48], rng.integers(0, 700, 16).astype(np.uint32)])
    out["q/keys"] = rng.integers(0, 700, 40).astype(np.uint32)
    return out


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Oracle (a): the reference's shard_map plane on the batches, plus the
    inputs the port's ranks read (the hash coefficients it drew)."""
    tmp = tmp_path_factory.mktemp("oracle")
    inputs = _batches(np.random.default_rng(0))
    for name, shape in CONFIGS.items():
        inputs[f"{name}/shape"] = np.asarray(shape)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _ORACLE, str(tmp / "inputs.npz"), str(tmp / "oracle.npz")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240,
    )
    assert proc.returncode == 0 and "ORACLE_OK" in proc.stdout, proc.stderr[-3000:]
    want = dict(np.load(tmp / "oracle.npz"))
    ranks_in = dict(inputs)
    for name in CONFIGS:
        for k in ("row_a", "row_b", "col_a", "col_b"):
            ranks_in[f"{name}/{k}"] = want[f"{name}/{k}"]
    np.savez(tmp / "ranks.npz", **ranks_in)
    return want, tmp / "ranks.npz", tmp


@pytest.fixture(scope="module")
def plane(oracle):
    """The port's plane on 8 ranks ((2, 4), (4, 2)) and on 2 ((1, 2), (2, 1))."""
    _, inputs, tmp = oracle
    return {
        world: run_ranks(_torch_dist.sketch_plane, world, tmp / f"plane{world}", timeout=120,
                         meshes=MESHES[world], inputs=str(inputs))
        for world in MESHES
    }


def _cases():
    return [(world, shape, name) for world in MESHES for shape in MESHES[world] for name in CONFIGS]


def _ids(case):
    world, shape, name = case
    return f"{shape[0]}x{shape[1]}-{name}"


@pytest.mark.parametrize("case", _cases(), ids=_ids)
def test_distributed_ingest_matches_reference(oracle, plane, case):
    """Each rank's counter rows, the replicated registers and the gathered
    counters equal the reference's shard_map ingest on a (2, 4) mesh."""
    want, _, _ = oracle
    world, shape, name = case
    key = f"{shape[0]}x{shape[1]}/{name}"
    wr = CONFIGS[name][1]
    rows = wr // shape[1]
    for res in plane[world]:
        _, model = res[f"{shape[0]}x{shape[1]}/coords"]
        np.testing.assert_array_equal(res[f"{key}/shard"], want[f"{name}/counters"][:, model * rows:(model + 1) * rows])
        np.testing.assert_array_equal(res[f"{key}/whole"], want[f"{name}/counters"])
        for f in ("row_flows", "col_flows"):
            np.testing.assert_array_equal(res[f"{key}/{f}"], want[f"{name}/{f}"])
    inputs = np.load(oracle[1])
    mass = inputs["b1/w"].sum() + inputs["b2/w"].sum()
    np.testing.assert_array_equal(want[f"{name}/counters"].sum(axis=(1, 2)), np.full(CONFIGS[name][0], mass))


@pytest.mark.parametrize("case", _cases(), ids=_ids)
def test_distributed_queries_match_reference(oracle, plane, case):
    """``distributed_edge_query`` and ``distributed_point_query`` (registers,
    and the counter reduction through the flow kernel's plain version)
    equal the reference's, on every rank."""
    want, _, _ = oracle
    world, shape, name = case
    key = f"{shape[0]}x{shape[1]}/{name}"
    for res in plane[world]:
        np.testing.assert_array_equal(res[f"{key}/edge"], want[f"{name}/edge"])
        for direction in ("in", "out"):
            for regs in (True, False):
                np.testing.assert_array_equal(res[f"{key}/{direction}/{regs}"], want[f"{name}/{direction}/{regs}"])
    assert (want[f"{name}/edge"] > 0).sum() >= 48  # the first 48 pairs were ingested


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("tag", ["dm", "md", "rows", "both"])
def test_block_layout_matches_named_sharding(oracle, shape, tag):
    """``block_slices`` gives each rank the block ``NamedSharding`` gives
    the device of the same id, and groups lay ranks out as
    ``jax.make_mesh`` lays out devices."""
    want, _, _ = oracle
    spec = {"dm": ("data", "model"), "md": ("model", "data"), "rows": (None, "model", None),
            "both": (("data", "model"),)}[tag]
    dims = (64, 32) if tag in ("dm", "md") else (3, 64, 48) if tag == "rows" else (64,)
    got = []
    for rank in range(8):
        for i, sl in enumerate(block_slices(dims, spec, shape, ("data", "model"), mesh_coords(shape, rank))):
            got.append((rank, i, sl.start, sl.stop))
    np.testing.assert_array_equal(np.asarray(sorted(got)), np.asarray(sorted(map(tuple, want[f"layout/{shape[0]}x{shape[1]}/{tag}"]))))
    grid = np.arange(8).reshape(shape)
    assert axis_groups(shape, ("data", "model"), ("model",)) == grid.tolist()
    assert axis_groups(shape, ("data", "model"), ("data",)) == grid.T.tolist()
    assert axis_groups(shape, ("data", "model"), ("data", "model")) == [list(range(8))]


def test_checkpoint_manager_reshards_across_meshes(tmp_path):
    """``CheckpointManager.restore(shardings=)``: saved under (2, 4) with
    ``("data", "model")``, restored under (4, 2) with ``("model", "data")``
    (``tests/test_elastic_reshard.py``'s case); a sketch's rows reshard too."""
    results = run_ranks(_torch_dist.reshard, 8, tmp_path, timeout=90)
    w = np.arange(64.0 * 32, dtype=np.float32).reshape(64, 32)
    for rank, res in enumerate(results):
        assert res["step"] == 10
        np.testing.assert_array_equal(res["whole"], w)
        sl = block_slices((64, 32), ("data", "model"), (2, 4), ("data", "model"), mesh_coords((2, 4), rank))
        np.testing.assert_array_equal(res["block_a"], w[sl])
        sl = block_slices((64, 32), ("model", "data"), (4, 2), ("data", "model"), mesh_coords((4, 2), rank))
        np.testing.assert_array_equal(res["w_b"], w[sl])
        np.testing.assert_array_equal(res["sketch_shard_b"], res["sketch_want_b"])
        model = mesh_coords((4, 2), rank)[1]
        np.testing.assert_array_equal(res["sketch_shard_b"], res["sketch_whole"][:, model * 32:(model + 1) * 32])
        np.testing.assert_array_equal(res["sketch_rows_b"], res["sketch_whole"].sum(axis=2))
