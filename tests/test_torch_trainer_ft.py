"""Fault-tolerance parity of the port's trainer with the reference's.

``tests/test_trainer_ft.py``'s checkpoint cases run on the port: atomic
saves that survive a half-written one, retention, restore into a state's
devices and dtypes (the reference's reshard case, whose meshes are ROADMAP
A9), a run converging with checkpoints on, and the crash-exact resume (a
failure injected at step 45, resumed from the step-30 checkpoint: the
parameters equal the uninterrupted run's bit for bit).  Across packages, the
reference's resume and the port's give the same parameters within
``rtol=1e-6, atol=1e-5``, a checkpoint of either trainer resumes in the
other, and ``launch/train_lm.py --checkpoint-dir`` resumes where it stopped.
The convergence, straggler and compression cases are in
``tests/test_torch_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.train import optimizer as ref_opt
from repro.train import trainer as ref_trainer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train_lm
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves

OPT = dict(lr=3e-2, warmup_steps=5, total_steps=200, weight_decay=0.0)


def _batches():
    """Step-deterministic batches, so a resume sees the same stream."""
    r = np.random.default_rng(2)
    out = []
    for _ in range(100):
        x = r.normal(0, 1, (32, 8)).astype(np.float32)
        out.append({"x": x, "y": x @ np.ones((8, 4), np.float32)})
    return out


def _init(gen):
    params = {"w": torch.zeros((8, 4))}
    return {"params": params, "opt": opt.init_adamw(opt.AdamWConfig(**OPT), params)}


def _loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}


def _step(state, batch):
    (loss, _), grads = trainer.value_and_grad(_loss, state["params"], batch)
    p, o, m = opt.apply_adamw(opt.AdamWConfig(**OPT), state["opt"], state["params"], grads)
    return {"params": p, "opt": o}, {"loss": loss, **m}


def _ref_init(key):
    params = {"w": jnp.zeros((8, 4), jnp.float32)}
    return {"params": params, "opt": ref_opt.init_adamw(ref_opt.AdamWConfig(**OPT), params)}


def _ref_step(state, batch):
    def loss(params, b):
        return jnp.mean((b["x"] @ params["w"] - b["y"]) ** 2), {}

    (value, _), grads = jax.value_and_grad(loss, has_aux=True)(state["params"], batch)
    p, o, m = ref_opt.apply_adamw(ref_opt.AdamWConfig(**OPT), state["opt"], state["params"], grads)
    return {"params": p, "opt": o}, {"loss": value, **m}


def _cfg(directory, **kw):
    return trainer.TrainerConfig(total_steps=60, checkpoint_dir=str(directory), checkpoint_every=30, log_every=0, **kw)


def _ref_cfg(directory, **kw):
    return ref_trainer.TrainerConfig(total_steps=60, checkpoint_dir=str(directory), checkpoint_every=30,
                                     log_every=0, **kw)


def test_train_loop_converges_with_checkpoints(tmp_path):
    res = trainer.train_loop(_init, _step, iter(_batches()), _cfg(tmp_path))
    assert res.history[-1]["loss"] < res.history[0]["loss"] * 0.1
    assert CheckpointManager(tmp_path).all_steps() == [30, 60]


def test_crash_and_resume_exact(tmp_path):
    xs = _batches()
    straight = trainer.train_loop(_init, _step, iter(xs), _cfg(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer.train_loop(_init, _step, iter(xs), _cfg(tmp_path / "b", fail_at_step=45))
    start = CheckpointManager(tmp_path / "b").latest_step()
    assert start == 30
    resumed = trainer.train_loop(_init, _step, iter(xs[start:]), _cfg(tmp_path / "b"))
    assert resumed.resumed_from == 30 and [h["step"] for h in resumed.history] == list(range(30, 60))
    assert torch.equal(straight.state["params"]["w"], resumed.state["params"]["w"])
    assert int(resumed.state["opt"].step) == 60
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in straight.history[30:]]


def test_resume_matches_reference(tmp_path):
    """The reference's crash-and-resume and the port's end at the same
    parameters, and each package resumes from the other's checkpoint."""
    xs = _batches()
    ref_xs = [{k: jnp.asarray(v) for k, v in b.items()} for b in xs]
    with pytest.raises(RuntimeError):
        ref_trainer.train_loop(_ref_init, _ref_step, iter(ref_xs), _ref_cfg(tmp_path / "ref", fail_at_step=45))
    with pytest.raises(RuntimeError):
        trainer.train_loop(_init, _step, iter(xs), _cfg(tmp_path / "port", fail_at_step=45))
    ref_res = ref_trainer.train_loop(_ref_init, _ref_step, iter(ref_xs[30:]), _ref_cfg(tmp_path / "ref"))
    port_res = trainer.train_loop(_init, _step, iter(xs[30:]), _cfg(tmp_path / "port"))
    want = np.asarray(ref_res.state["params"]["w"])
    np.testing.assert_allclose(port_res.state["params"]["w"].numpy(), want, rtol=1e-6, atol=1e-5)
    # Across: the port's step-30 checkpoint resumes in the reference, and
    # the reference's in the port.
    for src, dst in (("port", "ref_from_port"), ("ref", "port_from_ref")):
        step30 = CheckpointManager(tmp_path / src).restore(30, like=_init(None))[0]
        CheckpointManager(tmp_path / dst).save(30, step30, {"step": 30})
    ref_from_port = ref_trainer.train_loop(_ref_init, _ref_step, iter(ref_xs[30:]), _ref_cfg(tmp_path / "ref_from_port"))
    port_from_ref = trainer.train_loop(_init, _step, iter(xs[30:]), _cfg(tmp_path / "port_from_ref"))
    assert ref_from_port.resumed_from == port_from_ref.resumed_from == 30
    np.testing.assert_allclose(np.asarray(ref_from_port.state["params"]["w"]), want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(port_from_ref.state["params"]["w"].numpy(), want, rtol=1e-6, atol=1e-5)
    # The reference reads the port's own file too.
    state, meta = RefManager(tmp_path / "port").restore(30, like=_ref_init(None))
    assert meta["step"] == 30 and int(state["opt"].step) == 30


def test_checkpoint_atomicity_survives_partial_tmp(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"a": torch.arange(8.0)}
    mgr.save(1, state)
    (tmp_path / "step_0000000002.tmp-dead").mkdir()  # a crashed half-written save
    (tmp_path / "step_0000000002.tmp-dead" / "arrays.npz").write_bytes(b"junk")
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(like=state)
    assert torch.equal(restored["a"], torch.arange(8.0))
    mgr.save(2, {"a": torch.ones(8)})  # gc removes the orphan
    assert not list(tmp_path.glob("*.tmp-*"))


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor(float(s))})
    assert mgr.all_steps() == [3, 4]


def test_restore_places_leaves_like(tmp_path):
    """Each leaf comes back in ``like``'s dtype (bfloat16 written as float32)
    and a named tuple keeps its type; an async save snapshots the state."""
    mgr = CheckpointManager(tmp_path)
    w = torch.arange(16.0).reshape(4, 4)
    state = {"w": w.to(torch.bfloat16), "opt": opt.init_adamw(opt.AdamWConfig(), {"w": w})}
    mgr.save_async(5, state, {"step": 5})
    w.add_(100.0)  # the snapshot predates this
    state["opt"].m["w"].add_(1.0)
    mgr.wait()
    restored, meta = mgr.restore(like=state)
    assert meta["step"] == 5 and restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.arange(16.0).reshape(4, 4))
    assert isinstance(restored["opt"], opt.AdamWState) and restored["opt"].step.dtype == torch.int32
    assert restored["opt"].step.shape == () and int(restored["opt"].step) == 0  # a 0-d leaf stays 0-d
    assert float(restored["opt"].m["w"].abs().sum()) == 0.0


def test_train_lm_checkpoint_dir_resumes(tmp_path):
    argv = ["--device", "cpu", "--preset", "tiny", "--steps", "12", "--batch", "2", "--seq", "16",
            "--checkpoint-dir", str(tmp_path)]
    first = train_lm.main(argv)
    assert first.result.resumed_from is None and len(first.result.history) == 12
    assert CheckpointManager(tmp_path).all_steps() == [10, 12]
    again = train_lm.main(argv)
    assert again.result.resumed_from == 12 and again.result.history == []
    for a, b in zip(*(tree_leaves(r.result.state["params"]) for r in (first, again))):
        assert torch.equal(a, b)
