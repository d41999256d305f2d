"""Parity of the port's sharded LM forms (``models/layers.py``:
``moe_ffn_sharded``, ``swa_attention_halo``; ``models/transformer.py``
``forward`` with ``attn_halo_mesh``) with the JAX reference, on four gloo
ranks spawned on the CPU (``tests/_torch_dist.py::lm_sharded``) over a
(2, 2) and a (1, 4) ("data", "model") mesh, at the reference's SMOKE widths
in float32.

The reference's own sharded tests cannot serve as oracles here
(``tests/test_halo_attention.py`` fails under jax 0.9.0, ROADMAP §C), so
each form is held to the reference's unsharded functions on what each rank
should see:
- expert partition (arctic SMOKE, 8 experts) at the config's 1.25, tokens
  dropped: each rank routes its own tokens, so its block equals the
  reference's ``moe_block`` on its local tokens;
- ffn partition (mixtral SMOKE, 4 experts) at 1.25: the ``"model"`` peers
  route their gathered tokens, so a rank's block equals ``moe_block`` on its
  model group's tokens, cut to its rows;
- both at full capacity (E / k): equal to ``moe_block`` on all the tokens;
- the aux loss: the mean of those blocks' aux losses over the mesh;
- halo attention and the windowed forward against the reference's dense
  masked ``gqa_attention`` and ``forward`` on the whole sequence.
Tolerance atol 1e-5, rtol 1e-5: the gathers and all-to-alls are exact
(sums of zero-filled blocks); the ffn partition's ``psum_scatter`` adds the
F/tp partial products in gloo's order, and the matmuls sum in torch's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import arctic_480b, mixtral_8x22b
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro_torch.models import layers

import _torch_dist
from _torch_dist import run_ranks
from _torch_parity import port_transformer_config, transformer_numpy_params

MESHES = [(2, 2), (1, 4)]
B, S = 4, 32
TOL = dict(rtol=1e-5, atol=1e-5)
SMOKES = {"expert": arctic_480b.SMOKE, "ffn": mixtral_8x22b.SMOKE}
HALO = {"w8": 8, "w20": 20}  # n_halo = 1 on (2, 2); 1 and 3 on (1, 4)
FORWARD = {"halo": 8, "gathered": 20}  # on (2, 2), a window of 20 is past the halo's reach: K/V gathered


def _factor(partition, level):
    moe = SMOKES[partition].moe
    return 1.25 if level == "drop" else moe.n_experts / moe.top_k


def _moe_args(partition, level):
    moe = SMOKES[partition].moe
    return layers.MoEArgs(n_experts=moe.n_experts, top_k=moe.top_k, capacity_factor=_factor(partition, level),
                          aux_loss_coef=moe.aux_loss_coef, partition=partition)


def _moe_inputs(partition, seed):
    cfg = SMOKES[partition]
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return dict(
        x=(rng.normal(0, 1, (B, S, d)) + rng.normal(0, 1, d)).astype(np.float32),
        router=(rng.normal(0, 1, (d, e)) / np.sqrt(d)).astype(np.float32),
        wg=(rng.normal(0, 1, (e, d, f)) / np.sqrt(d)).astype(np.float32),
        wu=(rng.normal(0, 1, (e, d, f)) / np.sqrt(d)).astype(np.float32),
        wd=(rng.normal(0, 1, (e, f, d)) / np.sqrt(f)).astype(np.float32),
    )


def _forward_config(window):
    ref_cfg = dataclasses.replace(mixtral_8x22b.SMOKE, sliding_window=window)
    return dataclasses.replace(port_transformer_config(ref_cfg, attn_q_chunk=8), moe=_moe_args("ffn", "full"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_sharded")
    inputs, moe_cases, halo_cases, forward_cases = {}, {}, {}, {}
    for i, partition in enumerate(SMOKES):
        inputs[partition] = _moe_inputs(partition, seed=20 + i)
        np.savez(tmp / f"moe_{partition}.npz", **inputs[partition])
        for level in ("drop", "full"):
            moe_cases[f"{partition}/{level}"] = (str(tmp / f"moe_{partition}.npz"), _moe_args(partition, level))
    rng = np.random.default_rng(30)
    for name, window in HALO.items():
        qkv = dict(q=rng.normal(0, 1, (B, S, 4, 16)), k=rng.normal(0, 1, (B, S, 2, 16)), v=rng.normal(0, 1, (B, S, 2, 16)))
        inputs[name] = {k: v.astype(np.float32) for k, v in qkv.items()}
        np.savez(tmp / f"halo_{name}.npz", window=window, q_chunk=8, **inputs[name])
        halo_cases[name] = str(tmp / f"halo_{name}.npz")
    for name, window in FORWARD.items():
        cfg = _forward_config(window)
        tree = transformer_numpy_params(cfg, seed=40)
        tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        inputs[f"forward/{name}"] = (cfg, tree, tokens)
        flat = {k: v for k, v in tree.items() if k != "layers"}
        flat.update({f"layers/{k}": v for k, v in tree["layers"].items()})
        np.savez(tmp / f"forward_{name}.npz", tokens=tokens, **flat)
        forward_cases[name] = (cfg, str(tmp / f"forward_{name}.npz"))
    results = run_ranks(_torch_dist.lm_sharded, 4, tmp, timeout=120.0, meshes=MESHES, moe_cases=moe_cases,
                        halo_cases=halo_cases, forward_cases=forward_cases)
    return inputs, results


_ref_moe = jax.jit(ref_layers.moe_block, static_argnums=5)


def _ref_moe_args(partition, level):
    return dataclasses.replace(SMOKES[partition].moe, capacity_factor=_factor(partition, level))


def _rows(a, coords, shape):
    """The rank at ``coords`` of a ``shape`` mesh: its block of a global (B, S, ...) array."""
    b, s = B // shape[0], S // shape[1]
    return a[coords[0] * b:(coords[0] + 1) * b, coords[1] * s:(coords[1] + 1) * s]


def _weights(data):
    return tuple(jnp.asarray(data[k]) for k in ("router", "wg", "wu", "wd"))


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_expert_partition_with_drops_equals_moe_block_on_local_tokens(run, shape):
    inputs, results = run
    data = inputs["expert"]
    key = f"{shape[0]}x{shape[1]}"
    auxes, dropped = [], 0
    for res in results:
        coords = res[f"{key}/coords"]
        local = _rows(data["x"], coords, shape)
        flat = jnp.asarray(local.reshape(-1, local.shape[-1]))
        want, aux = _ref_moe(flat, *_weights(data), _ref_moe_args("expert", "drop"))
        np.testing.assert_allclose(res[f"{key}/moe/expert/drop"], np.asarray(want).reshape(local.shape), **TOL)
        auxes.append(float(aux))
        table = np.asarray(ref_layers._route_local(flat, jnp.asarray(data["router"]), 8, 2, 1.25, 0.01)[0])
        dropped += flat.shape[0] * 2 - int((table < flat.shape[0]).sum())
    assert dropped > 0  # tokens drop at 1.25
    for res in results:
        np.testing.assert_allclose(res[f"{key}/aux/expert/drop"], np.mean(auxes), rtol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_ffn_partition_with_drops_equals_moe_block_on_the_model_groups_tokens(run, shape):
    inputs, results = run
    data = inputs["ffn"]
    key = f"{shape[0]}x{shape[1]}"
    b = B // shape[0]
    auxes = []
    for res in results:
        i, j = res[f"{key}/coords"]
        group = data["x"][i * b:(i + 1) * b]  # (b, S, D): the model peers' tokens, in model order
        gathered = np.concatenate([group[:, m * (S // shape[1]):(m + 1) * (S // shape[1])].reshape(-1, group.shape[-1])
                                   for m in range(shape[1])])
        want, aux = _ref_moe(jnp.asarray(gathered), *_weights(data), _ref_moe_args("ffn", "drop"))
        t_loc = b * (S // shape[1])
        mine = np.asarray(want)[j * t_loc:(j + 1) * t_loc].reshape(b, S // shape[1], -1)
        np.testing.assert_allclose(res[f"{key}/moe/ffn/drop"], mine, **TOL)
        auxes.append(float(aux))
    for res in results:
        np.testing.assert_allclose(res[f"{key}/aux/ffn/drop"], np.mean(auxes), rtol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("partition", sorted(SMOKES))
def test_full_capacity_equals_the_unsharded_block(run, shape, partition):
    inputs, results = run
    data = inputs[partition]
    want, _ = _ref_moe(jnp.asarray(data["x"].reshape(B * S, -1)), *_weights(data), _ref_moe_args(partition, "full"))
    want = np.asarray(want).reshape(data["x"].shape)
    key = f"{shape[0]}x{shape[1]}"
    for res in results:
        np.testing.assert_allclose(res[f"{key}/moe/{partition}/full"], _rows(want, res[f"{key}/coords"], shape), **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", sorted(HALO))
def test_halo_attention_equals_dense_masked_attention(run, shape, name):
    inputs, results = run
    q, k, v = (jnp.asarray(inputs[name][n]) for n in ("q", "k", "v"))
    want = np.asarray(jax.jit(ref_layers.gqa_attention, static_argnames=("causal", "sliding_window"))(
        q, k, v, causal=True, sliding_window=HALO[name]))
    key = f"{shape[0]}x{shape[1]}"
    for res in results:
        np.testing.assert_allclose(res[f"{key}/halo/{name}"], _rows(want, res[f"{key}/coords"], shape), **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_on_a_sequence_sharded_mesh_equals_the_reference(run, shape, name):
    inputs, results = run
    cfg, tree, tokens = inputs[f"forward/{name}"]
    ref_cfg = dataclasses.replace(mixtral_8x22b.SMOKE, sliding_window=FORWARD[name],
                                  moe=_ref_moe_args("ffn", "full"))
    want, _ = jax.jit(lambda p, t: ref_tfm.forward(ref_cfg, p, t))(jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
    key = f"{shape[0]}x{shape[1]}"
    for res in results:
        np.testing.assert_allclose(res[f"{key}/forward/{name}"], _rows(np.asarray(want), res[f"{key}/coords"], shape),
                                   rtol=1e-4, atol=2e-5)


def test_every_collective_is_one_recorded_sum(run):
    _, results = run
    for res in results:
        for key in ("2x2", "1x4"):
            records = res[f"{key}/collectives"]
            assert records and all(r["op"] == "all_reduce" and r["reduce"] == "SUM" for r in records)
            assert {r["axes"] for r in records} <= {("model",), ("data",), ("data", "model")}
