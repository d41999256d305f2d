"""Parity of the port's training side (``data/lm.py``, ``train/trainer.py``,
``launch/train_lm.py``) with the JAX reference, and the trainer's own
behaviour: the token pipeline, compressed steps of the tiny transformer on
converted state, microbatch accumulation, convergence with compression,
error feedback, the straggler watchdog and the refusals of what is not
ported yet.

Tolerances: float32 losses rtol=1e-5 for one step and 1e-4 over three
compressed steps (gradients agree to ~1e-6 relative, and a top-k selection
can flip a coordinate that sits within rounding of the threshold, which
moves one parameter by about the learning rate); parameters and optimizer
state rtol=1e-4, atol=1e-6 on the coordinates both sides selected."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm as ref_lm
from repro.models import transformer as ref_tfm
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro.train import trainer as ref_trainer
from repro_torch.convert import adamw_state_from_arrays, transformer_params_from_arrays
from repro_torch.data import lm
from repro_torch.kernels.countsketch import ops as cs_ops
from repro_torch.launch import train_lm
from repro_torch.models import transformer as tfm
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves

from _torch_parity import compressor_to_port, numpy_tree, ref_transformer_config

OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def test_token_pipeline_matches_reference():
    a, b = lm.MarkovTokens(300, seed=4), ref_lm.MarkovTokens(300, seed=4)
    np.testing.assert_array_equal(a.succ, b.succ)
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        ta, tb = a.batch(4, 33, ra), b.batch(4, 33, rb)
        np.testing.assert_array_equal(ta, tb)
        for k, v in lm.bigram_stream(ta).items():
            want = ref_lm.bigram_stream(tb)[k]
            np.testing.assert_array_equal(v, want)
            assert v.dtype == want.dtype
    ga, gb = lm.token_batches(300, 2, 8, seed=3), ref_lm.token_batches(300, 2, 8, seed=3)
    for _ in range(2):
        np.testing.assert_array_equal(next(ga)["tokens"], next(gb)["tokens"])


def _tiny_states(ccfg_kw):
    """Reference and port train states of the tiny preset on the same
    parameters, with an AdamW and a compressor state."""
    cfg = train_lm.PRESETS["tiny"]
    ref_cfg = ref_transformer_config(cfg)
    ref_params = ref_tfm.init_params(ref_cfg, jax.random.key(0))
    ref_ocfg = ref_opt.AdamWConfig(**OPT_KW)
    ccfg = ref_comp.CompressorConfig(**ccfg_kw)
    n = sum(x.size for x in jax.tree.leaves(ref_params))
    ref_state = {
        "params": ref_params,
        "opt": ref_opt.init_adamw(ref_ocfg, ref_params),
        "comp": ref_comp.init_compressor(ccfg, n, jax.random.key(1)),
    }
    ocfg = opt.AdamWConfig(**OPT_KW)
    params = transformer_params_from_arrays(cfg, numpy_tree(ref_params))
    state = {"params": params, "opt": opt.init_adamw(ocfg, params), "comp": compressor_to_port(ref_state["comp"])}
    ref_step = ref_trainer.compressed_data_parallel_step(
        lambda p, b: ref_tfm.loss_fn(ref_cfg, p, b["tokens"]), ref_ocfg, ccfg)
    port_ccfg = comp.CompressorConfig(**ccfg_kw)
    step = trainer.compressed_data_parallel_step(
        lambda p, b: tfm.loss_fn(cfg, p, b["tokens"]), ocfg, port_ccfg)
    return cfg, ref_state, jax.jit(ref_step), state, step


def test_one_compressed_step_matches_reference():
    cfg, ref_state, ref_step, state, step = _tiny_states(dict(depth=5, width=4096, top_k=512))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 17)).astype(np.int32)
    ref_state, ref_m = ref_step(ref_state, {"tokens": jnp.asarray(tokens)})
    before = cs_ops.countsketch.launches
    state, m = step(state, {"tokens": torch.from_numpy(tokens)})
    assert cs_ops.countsketch.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    want_m = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(ref_state["opt"].m)])
    got_m = torch.cat([x.reshape(-1) for x in tree_leaves(state["opt"].m)]).numpy()
    both = (want_m != 0) & (got_m != 0)
    assert (want_m != 0).sum() >= 512
    assert ((want_m != 0) != (got_m != 0)).sum() <= 0.01 * (want_m != 0).sum()
    np.testing.assert_allclose(got_m[both], want_m[both], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-4)
    for got, want in ((state["comp"].momentum, ref_state["comp"].momentum),):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    got_p = torch.cat([x.reshape(-1) for x in tree_leaves(state["params"])]).numpy()
    want_p = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(ref_state["params"])])
    np.testing.assert_allclose(got_p[both], want_p[both], rtol=1e-4, atol=1e-6)


def test_three_compressed_steps_track_reference_loss():
    """The slice as a whole: three compressed AdamW steps of the tiny
    transformer from the same state on the same batches."""
    cfg, ref_state, ref_step, state, step = _tiny_states(dict(depth=4, width=2048, top_k=256, momentum=0.9))
    batches = lm.token_batches(cfg.vocab, 4, 16, seed=2)
    for _ in range(3):
        tokens = next(batches)["tokens"]
        ref_state, ref_m = ref_step(ref_state, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-4)
        assert float(m["lr"]) == pytest.approx(float(ref_m["lr"]), rel=1e-6)


# -- the toy least-squares problem of tests/test_trainer_ft.py --------------------

OPT = dict(lr=3e-2, warmup_steps=5, total_steps=200, weight_decay=0.0)


def _toy_batches(seed=1):
    rng = np.random.default_rng(0)
    w_true = rng.normal(0, 1, (8, 4)).astype(np.float32)
    r = np.random.default_rng(seed)
    while True:
        x = r.normal(0, 1, (32, 8)).astype(np.float32)
        yield {"x": x, "y": x @ w_true}


def _toy_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def test_compressed_step_converges():
    ocfg = opt.AdamWConfig(**OPT)
    ccfg = comp.CompressorConfig(depth=5, width=512, top_k=16, momentum=0.0)
    step = trainer.compressed_data_parallel_step(_toy_loss, ocfg, ccfg)
    params = {"w": torch.zeros((8, 4))}
    state = {
        "params": params,
        "opt": opt.init_adamw(ocfg, params),
        "comp": comp.init_compressor(ccfg, 32, torch.Generator().manual_seed(1)),
    }
    bs = _toy_batches()
    losses = []
    for _ in range(60):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in next(bs).items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.3, losses[::10]


def test_compression_roundtrip_error_feedback():
    ccfg = comp.CompressorConfig(depth=5, width=256, top_k=4, momentum=0.0)
    st = comp.init_compressor(ccfg, 64, torch.Generator().manual_seed(0))
    g = torch.from_numpy(np.random.default_rng(0).normal(0, 1, 64).astype(np.float32))
    up1, st = comp.roundtrip(st, g)
    up2, st = comp.roundtrip(st, g)
    assert float(st.error.abs().sum()) < 2 * float(g.abs().sum())
    assert int(((up1.abs() + up2.abs()) > 0).sum()) > int((up1.abs() > 0).sum())


def test_accumulated_step_matches_reference():
    rng = np.random.default_rng(3)
    w0 = rng.normal(0, 1, (8, 4)).astype(np.float32)
    bs = _toy_batches(seed=5)
    mbs = [next(bs) for _ in range(2)]
    batch = {k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]}

    def ref_loss(params, b):
        return jnp.mean((b["x"] @ params["w"] - b["y"]) ** 2), {}

    ref_step = ref_trainer.make_accum_step(ref_loss, ref_opt.AdamWConfig(**OPT), 2)
    ref_params = {"w": jnp.asarray(w0)}
    ref_state = {"params": ref_params, "opt": ref_opt.init_adamw(ref_opt.AdamWConfig(**OPT), ref_params)}
    step = trainer.make_accum_step(_toy_loss, opt.AdamWConfig(**OPT), 2)
    params = {"w": torch.from_numpy(w0.copy())}
    state = {"params": params, "opt": opt.init_adamw(opt.AdamWConfig(**OPT), params)}
    for _ in range(2):
        ref_state, ref_m = jax.jit(ref_step)(ref_state, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(state["params"]["w"].numpy(), np.asarray(ref_state["params"]["w"]), rtol=1e-5, atol=1e-6)
    # one microbatch: the step takes batch[0]
    one = trainer.make_accum_step(_toy_loss, opt.AdamWConfig(**OPT), 1)
    _, m1 = one(state, {k: torch.from_numpy(v[:1]) for k, v in batch.items()})
    assert np.isfinite(float(m1["loss"]))


def _toy_init(gen):
    params = {"w": torch.zeros((8, 4))}
    return {"params": params, "opt": opt.init_adamw(opt.AdamWConfig(**OPT), params)}


def _toy_step(state, batch):
    (loss, _), grads = trainer.value_and_grad(_toy_loss, state["params"], batch)
    p, o, m = opt.apply_adamw(opt.AdamWConfig(**OPT), state["opt"], state["params"], grads)
    return {"params": p, "opt": o}, {"loss": loss, **m}


def test_train_loop_converges_and_watchdog_flags_stragglers():
    res = trainer.train_loop(_toy_init, _toy_step, _toy_batches(), trainer.TrainerConfig(total_steps=60, log_every=0))
    assert res.history[-1]["loss"] < res.history[0]["loss"] * 0.1
    assert res.resumed_from is None and len(res.history) == 60
    flagged = trainer.train_loop(
        _toy_init, _toy_step, _toy_batches(), trainer.TrainerConfig(total_steps=30, log_every=0, watchdog_factor=1e-9)
    )
    assert len(flagged.straggler_steps) > 0
    assert all(s["duration"] > 0 for s in flagged.straggler_steps)


def test_failure_injection_and_unported_options_raise():
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer.train_loop(_toy_init, _toy_step, _toy_batches(),
                           trainer.TrainerConfig(total_steps=10, log_every=0, fail_at_step=4))
    # The all-reduce across workers is ported: axis_name names an axis of a
    # Mesh (tests/test_torch_distributed_train.py), so alone it is refused.
    with pytest.raises(ValueError, match="mesh="):
        trainer.compressed_data_parallel_step(_toy_loss, opt.AdamWConfig(), comp.CompressorConfig(), axis_name="data")


def test_train_lm_runs_compressed_on_cpu():
    before = cs_ops.countsketch.launches
    run = train_lm.main(["--device", "cpu", "--preset", "tiny", "--compress", "--steps", "3", "--batch", "2", "--seq", "16"])
    losses = [h["loss"] for h in run.result.history]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert cs_ops.countsketch.launches == before
    st = run.result.state
    assert st["comp"].error.shape[0] == sum(x.numel() for x in tree_leaves(st["params"]))
    assert run.bigrams.summary()["edges_ingested"] >= 3 * 2 * 16


def test_train_lm_refuses_what_is_not_ported():
    # --checkpoint-dir is ported (tests/test_torch_trainer_ft.py); what is
    # left is the refusal of a card that is absent.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_lm.main(["--steps", "1"])
