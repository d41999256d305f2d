"""Parity of the port's pipeline schedule (``src/repro_torch/distributed/
pipeline.py``) with ``src/repro/distributed/pipeline.py``.

Four gloo ranks (``tests/_torch_dist.py::pipeline``) run the GPipe schedule
of the reference's test stage, ``tanh(x @ W + b)`` (``tests/test_pipeline.py``),
on a (4,) ``pipe`` mesh and on a (2, 2) mesh whose ``pipe`` axis has two
ranks; every rank's output equals a jnp composition of the stages within
1e-5 (float32 GEMMs in another order), with one all-reduce a tick and one
for the result.  ``microbatch`` and ``pipeline_bubble_fraction`` equal the
reference's exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import pipeline as ref_pipeline
from repro_torch.distributed.pipeline import microbatch, pipeline_bubble_fraction

import _torch_dist

S, M, MB, D = 4, 8, 4, 16
CASES = [((4,), ("pipe",), M), ((4,), ("pipe",), 1), ((2, 2), ("data", "pipe"), M)]


def _reference(x, ws, bs):
    h = jnp.asarray(x)
    for s in range(ws.shape[0]):
        h = jnp.tanh(h @ jnp.asarray(ws[s]) + jnp.asarray(bs[s]))
    return np.asarray(h)


def test_pipeline_on_four_ranks_matches_the_stage_composition(tmp_path):
    rng = np.random.default_rng(28)
    x = rng.normal(size=(M * MB, D)).astype(np.float32)
    arrays = {"x": x}
    for s in (2, 4):
        arrays[f"w{s}"] = (rng.normal(size=(s, D, D)) / np.sqrt(D)).astype(np.float32)
        arrays[f"b{s}"] = (rng.normal(size=(s, D)) * 0.1).astype(np.float32)
    inputs = tmp_path / "pipeline.npz"
    np.savez(inputs, **arrays)
    results = _torch_dist.run_ranks(_torch_dist.pipeline, 4, tmp_path, inputs=str(inputs), cases=CASES)
    for shape, _, n_micro in CASES:
        s = 4 if shape == (4,) else 2
        want = _reference(x, arrays[f"w{s}"], arrays[f"b{s}"]).reshape(n_micro, M * MB // n_micro, D)
        for rank, res in enumerate(results):
            got, n_reduces = res[f"{shape}/{n_micro}"]
            err = float(np.max(np.abs(got - want)))
            assert err < 1e-5, (shape, n_micro, rank, err)
            assert n_reduces == n_micro + s - 1 + 1
        outs = [res[f"{shape}/{n_micro}"][0] for res in results]
        assert all(np.array_equal(o, outs[0]) for o in outs)  # every rank holds the same result


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (1, 8), (8, 16), (4, 1), (16, 64)])
def test_bubble_fraction_equals_the_reference(n_stages, n_micro):
    assert pipeline_bubble_fraction(n_stages, n_micro) == ref_pipeline.pipeline_bubble_fraction(n_stages, n_micro)


def test_microbatch_equals_the_reference():
    x = np.arange(8 * 3 * 5, dtype=np.float32).reshape(8, 3, 5)
    for m in (1, 2, 4, 8):
        got = microbatch(torch.from_numpy(x), m).numpy()
        assert np.array_equal(got, np.asarray(ref_pipeline.microbatch(jnp.asarray(x), m)))
    with pytest.raises(ValueError):
        microbatch(torch.from_numpy(x), 3)
