"""The data-parallel compressed step on two gloo ranks
(``compressed_data_parallel_step(axis_name="data", mesh=...)``), the port of
the reference's ``psum`` of the CountSketch tables over the data axis.

Three holds, each over 3 steps, each rank with its own batch:

- the tiny transformer against the reference's own step under
  ``shard_map(axis_name="data")`` on a 2-device host mesh (a subprocess;
  the error feedback is per worker, so it rides a leading data axis): the
  losses to rtol 1e-4, as the single-worker test does, and the parameters
  and error feedback of the first step up to the coordinates whose top-k
  selection flips (gradients of two frameworks round differently);
- the same ranks against the port's single-process emulation, which
  computes both gradients, adds the two tables and decodes: bit for bit;
- a linear loss with integer gradients against the reference's
  ``roundtrip`` with ``psum_fn = lambda t: t + other_worker_table``: the
  error feedback and the sketch momentum bit for bit, the parameters (two
  AdamW implementations) and the loss (float sums of two frameworks) to
  rtol 1e-6.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import transformer as ref_tfm
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt

import _torch_dist
from _torch_parity import numpy_tree, ref_transformer_config
from repro_torch.launch.train_lm import PRESETS

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
CCFG = dict(depth=4, width=2048, top_k=256, momentum=0.9)
STEPS = 3

_REF_STEP = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, sys.argv[3])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed.compat import shard_map
    from repro.models import transformer as ref_tfm
    from repro.train import compression as ref_comp, optimizer as ref_opt, trainer as ref_trainer
    from repro_torch.launch.train_lm import PRESETS
    from _torch_parity import ref_transformer_config

    kw = json.loads(sys.argv[4])
    tokens = np.load(sys.argv[1])["tokens"]  # (steps, workers, batch, seq + 1)
    cfg = ref_transformer_config(PRESETS["tiny"])
    ocfg, ccfg = ref_opt.AdamWConfig(**kw["opt"]), ref_comp.CompressorConfig(**kw["ccfg"])
    params = ref_tfm.init_params(cfg, jax.random.key(0))
    n = sum(x.size for x in jax.tree.leaves(params))
    cstate = ref_comp.init_compressor(ccfg, n, jax.random.key(1))
    cstate = dataclasses.replace(cstate, error=jnp.zeros((2, n), jnp.float32))
    state = {"params": params, "opt": ref_opt.init_adamw(ocfg, params), "comp": cstate}
    step = ref_trainer.compressed_data_parallel_step(
        lambda p, b: ref_tfm.loss_fn(cfg, p, b["tokens"]), ocfg, ccfg, axis_name="data")

    def body(state, toks):
        c = state["comp"]
        new, m = step(dict(state, comp=dataclasses.replace(c, error=c.error[0])), {"tokens": toks[0]})
        return dict(new, comp=dataclasses.replace(new["comp"], error=new["comp"].error[None])), m

    spec = {"params": P(), "opt": P(),
            "comp": ref_comp.CompressorState(error=P("data"), momentum=P(), hash=P(), config=ccfg)}
    f = jax.jit(shard_map(body, mesh=jax.make_mesh((2,), ("data",)), in_specs=(spec, P("data")),
                          out_specs=(spec, P()), check_vma=False))
    out = {}
    for i in range(tokens.shape[0]):
        state, m = f(state, jnp.asarray(tokens[i]))
        out["loss/%d" % i] = np.asarray(m["loss"])
        out["params/%d" % i] = np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(state["params"])])
        out["error/%d" % i] = np.asarray(state["comp"].error)
        out["momentum/%d" % i] = np.asarray(state["comp"].momentum)
    np.savez(sys.argv[2], **out)
    print("REF_STEP_OK")
    """
)


def _tiny_inputs(path):
    """The tiny transformer's reference initial state (parameters from key 0,
    compressor from key 1) and each step's two worker batches."""
    cfg = PRESETS["tiny"]
    ref_cfg = ref_transformer_config(cfg)
    params = ref_tfm.init_params(ref_cfg, jax.random.key(0))
    n = sum(x.size for x in jax.tree.leaves(params))
    cstate = ref_comp.init_compressor(ref_comp.CompressorConfig(**CCFG), n, jax.random.key(1))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (STEPS, 2, 4, 17)).astype(np.int32)
    _torch_dist.save_train_inputs(
        path, "tiny", numpy_tree(params), np.asarray(cstate.error), np.asarray(cstate.momentum),
        np.asarray(cstate.hash.a), np.asarray(cstate.hash.b), CCFG, OPT,
        [{"tokens": tokens[i]} for i in range(STEPS)],
    )
    return tokens


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The port's two ranks and the reference's shard_map step, 3 steps of
    the tiny transformer from one state."""
    tmp = tmp_path_factory.mktemp("dp-tiny")
    tokens = _tiny_inputs(tmp / "inputs.pt")
    np.savez(tmp / "tokens.npz", tokens=tokens)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_STEP, str(tmp / "tokens.npz"), str(tmp / "ref.npz"), str(ROOT / "tests"),
         json.dumps({"opt": OPT, "ccfg": CCFG})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
    )
    try:
        ranks = _torch_dist.run_ranks(_torch_dist.compressed_steps, 2, tmp, timeout=120,
                                      inputs=str(tmp / "inputs.pt"))
        out, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_STEP_OK" in out, err[-3000:]
    return ranks, dict(np.load(tmp / "ref.npz")), tmp


def test_two_rank_step_matches_reference_shard_map_step(tiny_run):
    ranks, want, _ = tiny_run
    for i in range(STEPS):
        for res in ranks:
            np.testing.assert_allclose(res[i][0], float(want[f"loss/{i}"]), rtol=1e-4)
    # Step 1: parameters and error feedback, but for near-threshold flips.
    for rank, res in enumerate(ranks):
        _, params, error, _ = res[0]
        near = np.isclose(params, want["params/0"], rtol=1e-4, atol=1e-6)
        assert near.mean() >= 0.999, near.mean()
        near = np.isclose(error, want["error/0"][rank], rtol=1e-3, atol=1e-5)
        assert near.mean() >= 0.99, near.mean()


def test_two_rank_step_equals_single_process_emulation(tiny_run):
    ranks, _, tmp = tiny_run
    for i, (loss, params, errors, momentum) in enumerate(_torch_dist.emulate_steps(tmp / "inputs.pt")):
        for rank, res in enumerate(ranks):
            got_loss, got_params, got_error, got_momentum = res[i]
            assert got_loss == loss
            np.testing.assert_array_equal(got_params, params)
            np.testing.assert_array_equal(got_error, errors[rank])
            np.testing.assert_array_equal(got_momentum, momentum)


def test_two_rank_integer_step_matches_reference_roundtrip(tmp_path):
    """Integer gradients: the ranks' error feedback and momentum equal the
    reference's ``roundtrip`` with the other worker's table added."""
    n = 3000
    rng = np.random.default_rng(9)
    xs = rng.integers(-20, 21, (STEPS, 2, 3, n)).astype(np.float32)
    ccfg = dict(depth=5, width=256, top_k=64, momentum=0.9)
    ref_ccfg = ref_comp.CompressorConfig(**ccfg)
    ref_states = [ref_comp.init_compressor(ref_ccfg, n, jax.random.key(4))] * 2
    _torch_dist.save_train_inputs(
        tmp_path / "inputs.pt", "linear", {"w": np.zeros(n, np.float32)}, np.asarray(ref_states[0].error),
        np.asarray(ref_states[0].momentum), np.asarray(ref_states[0].hash.a), np.asarray(ref_states[0].hash.b),
        ccfg, OPT, [{"x": xs[i]} for i in range(STEPS)],
    )
    ranks = _torch_dist.run_ranks(_torch_dist.compressed_steps, 2, tmp_path, timeout=90,
                                  inputs=str(tmp_path / "inputs.pt"))
    ref_ocfg = ref_opt.AdamWConfig(**OPT)
    params = {"w": jnp.zeros(n, jnp.float32)}
    ostate = ref_opt.init_adamw(ref_ocfg, params)
    for i in range(STEPS):
        grads = [jnp.asarray(xs[i, k].sum(axis=0)) for k in range(2)]
        losses = [float((params["w"] * jnp.asarray(xs[i, k])).sum()) for k in range(2)]
        tables = [ref_comp._sketch(s, g + s.error) for s, g in zip(ref_states, grads)]
        updates = []
        for k in range(2):
            other = tables[1 - k]
            update, ref_states[k] = ref_comp.roundtrip(ref_states[k], grads[k], lambda t, other=other: t + other)
            updates.append(np.asarray(update))
        np.testing.assert_array_equal(updates[0], updates[1])
        params, ostate, _ = ref_opt.apply_adamw(ref_ocfg, ostate, params, {"w": jnp.asarray(updates[0])})
        for rank, res in enumerate(ranks):
            loss, got_params, error, momentum = res[i]
            np.testing.assert_allclose(loss, (losses[0] + losses[1]) / 2, rtol=1e-6)
            np.testing.assert_array_equal(error, np.asarray(ref_states[rank].error))
            np.testing.assert_array_equal(momentum, np.asarray(ref_states[rank].momentum))
            np.testing.assert_allclose(got_params, np.asarray(params["w"]), rtol=1e-6, atol=1e-7)
    assert (updates[0] != 0).sum() >= 64

