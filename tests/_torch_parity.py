"""Shared helpers of the port's parity tests: carry a reference sketch across
to the port through numpy, and compare the two sides' state."""
import numpy as np

from repro_torch.convert import sketch_from_arrays
from repro_torch.core.sketch import SketchConfig


def port_config(cfg) -> SketchConfig:
    return SketchConfig(
        depth=cfg.depth, width_rows=cfg.width_rows, width_cols=cfg.width_cols,
        directed=cfg.directed,
    )


def to_port(sk, device="cpu"):
    """The port's GLavaSketch holding the reference sketch ``sk``'s leaves."""
    square = sk.config.is_square
    return sketch_from_arrays(
        port_config(sk.config),
        np.asarray(sk.counters),
        np.asarray(sk.row_flows),
        np.asarray(sk.col_flows),
        np.asarray(sk.row_hash.a),
        np.asarray(sk.row_hash.b),
        None if square else np.asarray(sk.col_hash.a),
        None if square else np.asarray(sk.col_hash.b),
        device=device,
    )


def assert_same_sketch(port, ref, exact=True, err=""):
    for name in ("counters", "row_flows", "col_flows"):
        got = getattr(port, name).cpu().numpy()
        want = np.asarray(getattr(ref, name))
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {err}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=f"{name} {err}")


def assert_same_value(got, want, exact=True):
    """Compare one QueryResult value (scalar, array, or heavy's pair)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_value(g, w, exact)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
    if exact or g.dtype == bool:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)
