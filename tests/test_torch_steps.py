"""Parity of the step builder (``src/repro_torch/launch/steps.py``) and the
trainer CLI (``launch/train.py``) with the reference's
``src/repro/launch/{steps,train}.py``.

For every live cell the FULL bundle's batch and state specs (``meta``
tensors against ``ShapeDtypeStruct``s), its logical trees and its config
equal the reference's, with no compute; every SMOKE ``make_batch`` is
bit-equal for the same ``np.random.Generator`` seed (a decode cache's K/V
compared after the rounding to the compute dtype).  One step of a cell of
each kind, from the reference's parameters carried across by
``convert.py``, gives the reference's loss, metrics and updated parameters
(or outputs): every SMOKE config computes in float32, so the limits are
float32 round-off of sums taken in another order (``STEP``: the loss and
the outputs; ``PARAMS``: the parameters after AdamW, whose update divides
by ``sqrt(v) + eps`` at the first step and so magnifies a gradient's
round-off where it is near 0).  Every arch's SMOKE train loss falls over 8
steps on a fixed batch, as ``tests/test_arch_smoke.py`` asks of the
reference's.  The GSPMD constraints change no value: a forward with
``act_pspec`` and ``dispatch_pspec`` set equals the forward without them
bit for bit.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_all as ref_load_all
from repro.launch import steps as ref_steps
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, all_cells, get_arch
from repro_torch.distributed.sharding import Placement
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_leaves

from _torch_parity import numpy_tree

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bool_): torch.bool}
STEP = dict(rtol=2e-5, atol=2e-6)
PARAMS = dict(rtol=1e-4, atol=1e-6)
TRAIN_SHAPE = {"lm": "train_4k", "gnn": "full_graph_sm", "recsys": "train_batch"}


@pytest.fixture(autouse=True)
def _reference_registry():
    """The reference's registry loads only when empty (ROADMAP §C)."""
    ref_load_all()


def _plain(x):
    """Named tuples as plain tuples, through dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


def _desc(tree):
    """A spec tree as nested containers of (shape, torch dtype)."""
    if isinstance(tree, dict):
        return {k: _desc(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "dtype"):
        return [_desc(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return tuple(tree.shape), tree.dtype
    return tuple(tree.shape), DTYPES[jnp.dtype(tree.dtype)]


def _same_config(port, ref, where):
    for f in dataclasses.fields(ref):
        if f.name == "scan_layers":  # an eager loop has no scan
            continue
        pv, rv = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(rv):
            _same_config(pv, rv, f"{where}.{f.name}")
        elif isinstance(pv, torch.dtype):
            assert pv == DTYPES[jnp.dtype(rv)], f"{where}.{f.name}"
        else:
            assert pv == rv, (f"{where}.{f.name}", pv, rv)


@pytest.mark.parametrize("arch,shape", all_cells())
def test_specs_and_logical_trees_equal_the_reference(arch, shape):
    port = steps.build_step(arch, shape, device="meta")
    ref = ref_steps.build_step(arch, shape, smoke=False)
    assert (port.kind, port.is_train, port.notes) == (ref.kind, ref.is_train, ref.notes)
    assert _desc(port.input_specs()) == _desc(ref.input_specs())
    assert _desc(port.state_specs()) == _desc(ref.state_specs())
    assert _plain(port.state_logical) == _plain(ref.state_logical)
    assert _plain(port.batch_logical) == _plain(ref.batch_logical)
    assert _plain(port.out_logical) == _plain(ref.out_logical)
    _same_config(port.config, ref.config, f"{arch}/{shape}")


def test_state_specs_draw_nothing():
    """Arctic-480B's train state is 3 x 477 G elements of ``meta`` tensors:
    shapes from ``param_shapes``, nothing drawn, nothing allocated."""
    b = steps.build_step("arctic-480b", "train_4k", device="meta")
    leaves = tree_leaves(b.state_specs())
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in tree_leaves(b.state_specs()["params"]))
    assert n > 4.7e11 and sum(t.numel() for t in leaves) == 3 * n + 1
    assert b.state_specs()["opt"].m["embed"].dtype == torch.bfloat16  # > 100e9 parameters: bf16 moments


def _same_array(port, ref, where):
    ref = np.asarray(ref)
    if ref.dtype == jnp.bfloat16:  # the reference's K/V, rounded by astype
        want = torch.from_numpy(ref.view(np.uint16).astype(np.int32))
        got = torch.from_numpy(np.asarray(port, np.float32)).to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
        assert torch.equal(got, want), where
        return
    port = np.asarray(port)
    assert port.dtype == ref.dtype and port.shape == ref.shape, (where, port.dtype, ref.dtype)
    assert np.array_equal(port, ref), where


@pytest.mark.parametrize("arch,shape", all_cells(include_skipped=True))
def test_make_batch_bit_equal(arch, shape):
    port = steps.build_step(arch, shape, smoke=True, device="cpu").make_batch(np.random.default_rng(28))
    ref = ref_steps.build_step(arch, shape, smoke=True).make_batch(np.random.default_rng(28))
    flat_ref, _ = jax.tree_util.tree_flatten_with_path(ref)
    flat_port = tree_leaves(port)
    assert len(flat_port) == len(flat_ref)
    for p, (path, r) in zip(flat_port, flat_ref):
        _same_array(p, r, f"{arch}/{shape}{jax.tree_util.keystr(path)}")


_CONVERT = {
    "lm": convert.transformer_params_from_arrays,
    "gat-cora": convert.gat_params_from_arrays,
    "graphsage-reddit": convert.graphsage_params_from_arrays,
    "schnet": convert.schnet_params_from_arrays,
    "dimenet": convert.dimenet_params_from_arrays,
    "bert4rec": convert.bert4rec_params_from_arrays,
}


def _pair(arch, shape):
    """(port bundle, reference bundle, port state, reference state, port
    batch, reference batch): the reference's SMOKE parameters carried
    across, one numpy batch for both."""
    port = steps.build_step(arch, shape, smoke=True, device="cpu")
    ref = ref_steps.build_step(arch, shape, smoke=True)
    ref_state = jax.jit(ref.init_state)(jax.random.key(3))
    ref_params = ref_state["params"] if ref.is_train else ref_state
    conv = _CONVERT["lm" if get_arch(arch).family == "lm" else arch]
    params = conv(port.config, numpy_tree(ref_params))
    # every SMOKE config is below 100e9 parameters: fp32 moments
    state = {"params": params, "opt": opt_mod.init_adamw(opt_mod.AdamWConfig(), params)} if port.is_train else params
    batch = port.make_batch(np.random.default_rng(7))
    return port, ref, state, ref_state, port.to_tensors(batch), jax.tree.map(jnp.asarray, batch)


def _close(got, want, where, **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=where, **tol)


STEP_CELLS = [("olmo-1b", "train_4k"), ("qwen3-4b", "prefill_32k"), ("qwen3-4b", "decode_32k"),
              ("gat-cora", "full_graph_sm"), ("dimenet", "molecule"), ("bert4rec", "train_batch"),
              ("bert4rec", "serve_p99"), ("bert4rec", "retrieval_cand")]


@pytest.mark.parametrize("arch,shape", STEP_CELLS)
def test_one_step_matches_the_reference(arch, shape):
    port, ref, state, ref_state, batch, ref_batch = _pair(arch, shape)
    out = port.step(state, batch)
    want = jax.jit(ref.step)(ref_state, ref_batch)
    if port.is_train:
        new_state, metrics = out
        ref_new, ref_metrics = want
        assert set(metrics) == set(ref_metrics)
        for k in metrics:
            _close(metrics[k], ref_metrics[k], f"{arch}/{shape} {k}", **STEP)
        ref_leaves = jax.tree.leaves(ref_new["params"])
        for i, (p, r) in enumerate(zip(tree_leaves(new_state["params"]), ref_leaves, strict=True)):
            _close(p, r, f"{arch}/{shape} parameter {i}", **PARAMS)
        assert int(new_state["opt"].step) == int(ref_new["opt"].step) == 1
        return
    got, ref_got = (tree_leaves(out), jax.tree.leaves(want))
    assert len(got) == len(ref_got)
    for i, (g, r) in enumerate(zip(got, ref_got)):
        assert tuple(g.shape) == np.shape(r)
        _close(g, r, f"{arch}/{shape} output {i}", **STEP)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_loss_decreases(arch):
    """Eight steps of the SMOKE train shape on one batch lower the loss."""
    b = steps.build_step(arch, TRAIN_SHAPE[get_arch(arch).family], smoke=True, device="cpu")
    state = b.init_state(torch.Generator().manual_seed(0))
    batch = b.to_tensors(b.make_batch(np.random.default_rng(0)))
    losses = []
    for _ in range(8):
        state, metrics = b.step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], (arch, losses)
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state["params"]))


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b"])
def test_sharding_constraints_change_no_value(arch):
    """The production config of a SMOKE-width model on the single-pod
    layout sets ``act_pspec`` (and Mixtral's ``dispatch_pspec``); its
    forward equals the same config's without them, bit for bit."""
    smoke = get_arch(arch).smoke_config
    b = steps.build_step(arch, "train_4k", mesh=make_production_mesh(), config_override=smoke, device="cpu")
    cfg = b.config
    assert isinstance(cfg.act_pspec, Placement) and cfg.act_pspec.spec == (("data",), "model", None)
    assert cfg.remat and cfg.attn_q_chunk == 512
    bare = dataclasses.replace(cfg, act_pspec=None)
    if cfg.moe is not None:
        assert cfg.moe.dispatch_pspec.spec == (None, ("data",), None)  # Mixtral's "ffn" partition
        bare = dataclasses.replace(bare, moe=dataclasses.replace(cfg.moe, dispatch_pspec=None))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    with_c, without = tfm.forward(cfg, params, tokens), tfm.forward(bare, params, tokens)
    assert torch.equal(with_c[0], without[0]) and torch.equal(with_c[1], without[1])


def test_optimized_on_a_rank_mesh_reaches_the_sharded_forms():
    """``optimized=True`` on a rank mesh sets the sharded MoE dispatch and
    the halo attention (on an abstract mesh only the window slicing); they
    are forward only, so the train step of such a config raises instead of
    differentiating no collective."""
    from repro_torch.analysis.contracts import one_rank_group
    from repro_torch.distributed.mesh import make_host_mesh

    smoke = get_arch("mixtral-8x22b").smoke_config
    abstract = steps.build_step("mixtral-8x22b", "train_4k", mesh=make_production_mesh(), config_override=smoke,
                                optimized=True, device="cpu").config
    assert abstract.attn_window_slicing and abstract.attn_halo_mesh is None and not abstract.moe.shard_dispatch
    with one_rank_group("cpu"):
        mesh = make_host_mesh(1, 1)
        b = steps.build_step("mixtral-8x22b", "train_4k", mesh=mesh, config_override=smoke, optimized=True,
                             device="cpu")
        cfg = b.config
        assert cfg.moe.shard_dispatch and cfg.moe.mesh is mesh and cfg.attn_halo_mesh is mesh
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
        state = {"params": params, "opt": opt_mod.init_adamw(opt_mod.AdamWConfig(), params)}
        with pytest.raises(ValueError, match="forward only"):
            b.step(state, {"tokens": torch.zeros((1, 9), dtype=torch.int32)})


def test_train_cli_prints_the_reference_line_and_the_loss_falls():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", "olmo-1b", "--steps", "4"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("[train] olmo-1b/train_4k: 4 steps, loss ")]
    assert len(line) == 1, proc.stdout
    first, last = (float(x) for x in line[0].split("loss ")[1].split(" -> "))
    assert last < first


def test_train_cli_runs_on_the_card_by_default():
    """Without ``--device`` the training CLI asks for CUDA: a host with no card
    raises (no silent move to the CPU)."""
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "olmo-1b", "--steps", "1"])
