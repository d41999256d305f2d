"""Parity of the port's sketch integrations (``integration/popularity.py``,
``integration/sketch_sampler.py``) with the JAX reference: each port object
holds the reference object's sketch (carried across through numpy), both
observe the same stream, and every estimate must be equal (integer weights,
so exact); the samplers then draw the same items from the same rng."""
import jax
import numpy as np
import pytest
import torch

from repro.core.sketch import SketchConfig as RefConfig
from repro.integration.popularity import InteractionPopularitySketch as RefPopularity
from repro.integration.sketch_sampler import StreamingDegreeSketch as RefDegree
from repro.integration.sketch_sampler import sketch_weighted_seeds as ref_seeds
from repro_torch.core.sketch import SketchConfig
from repro_torch.integration.popularity import InteractionPopularitySketch
from repro_torch.integration.sketch_sampler import StreamingDegreeSketch, sketch_weighted_seeds

from _torch_parity import to_port


def test_degree_sketch_matches_reference():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 300, 5000).astype(np.uint32)
    dst = rng.integers(0, 300, 5000).astype(np.uint32)
    ref = RefDegree(RefConfig(depth=4, width_rows=256, width_cols=256))
    port = StreamingDegreeSketch(SketchConfig(depth=4, width_rows=256, width_cols=256), device="cpu")
    port.sketch = to_port(ref.sketch)
    for lo in range(0, 5000, 1000):
        ref.observe(src[lo : lo + 1000], dst[lo : lo + 1000])
        port.observe(src[lo : lo + 1000], dst[lo : lo + 1000])
    nodes = np.arange(300, dtype=np.uint32)
    for direction in ("out", "in"):
        np.testing.assert_array_equal(port.degree_estimates(nodes, direction), ref.degree_estimates(nodes, direction))
    assert np.all(port.degree_estimates(nodes, "out") >= np.bincount(src, minlength=300))
    np.testing.assert_array_equal(port.seed_weights(300, chunk=128), ref.seed_weights(300, chunk=128))
    np.testing.assert_array_equal(
        sketch_weighted_seeds(port, 300, 32, np.random.default_rng(9)),
        ref_seeds(ref, 300, 32, np.random.default_rng(9)),
    )


def test_popularity_sketch_matches_reference():
    rng = np.random.default_rng(3)
    n_items = 2000
    hot = rng.integers(1, 21, 20_000).astype(np.uint32)
    cold = rng.integers(21, n_items + 1, 4_000).astype(np.uint32)
    items = np.concatenate([hot, cold])
    users = rng.integers(0, 5000, len(items)).astype(np.uint32)
    ref = RefPopularity(n_items, width_users=512, width_items=1024)
    port = InteractionPopularitySketch(n_items, width_users=512, width_items=1024, device="cpu")
    assert not port.sketch.config.is_square
    port.sketch = to_port(ref.sketch)
    ref.observe(users, items)
    port.observe(users, items)
    probe = np.arange(1, 600, dtype=np.uint32)
    np.testing.assert_array_equal(port.item_popularity(probe), ref.item_popularity(probe))
    np.testing.assert_array_equal(port.user_activity(probe), ref.user_activity(probe))
    assert port.item_popularity(probe[:20]).mean() > 10 * port.item_popularity(probe[500:520]).mean()
    negs = port.sample_negatives(512, np.random.default_rng(4))
    np.testing.assert_array_equal(negs, ref.sample_negatives(512, np.random.default_rng(4)))
    assert np.mean(negs <= 20) > 0.2


def test_integrations_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingDegreeSketch(SketchConfig(depth=2, width_rows=64, width_cols=64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InteractionPopularitySketch(100)
