"""Parity of the port's counter-side query ops with the JAX reference: the
flow reductions (``flows``, ``node_in_flow``, ``node_out_flow``) against
``repro.kernels.flow.ops`` in interpret mode (the Pallas kernel body), and
the per-sketch gather ``edge_query_cells`` against
``repro.kernels.query.ops.edge_query_cells`` in interpret mode.  Integer
counters, so every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GLavaSketch as RefSketch, SketchConfig as RefConfig
from repro.kernels.flow import ops as ref_flow_ops
from repro.kernels.flow.ref import flows_ref as ref_flows_ref
from repro.kernels.query.ops import edge_query_cells as ref_edge_query_cells
from repro_torch.core import queries
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.kernels.flow import ops as flow_ops
from repro_torch.kernels.flow.ref import flows_ref
from repro_torch.kernels.query.ops import edge_query_cells, edge_query_min
from repro_torch.kernels.query.ref import edge_query_cells_ref

from _torch_parity import to_port


@pytest.mark.parametrize("fn", [flows_ref, flow_ops.flows], ids=["plain", "wrapper-on-cpu"])
@pytest.mark.parametrize("d,wr,wc", [(1, 64, 64), (3, 256, 512), (4, 300, 200)])
def test_flows_match_reference_kernel(fn, d, wr, wc):
    counters = np.random.default_rng(d * wr).integers(0, 50, (d, wr, wc)).astype(np.float32)
    want_rs, want_cs = ref_flow_ops.flows(jnp.asarray(counters), interpret=True)
    ref_rs, ref_cs = ref_flows_ref(jnp.asarray(counters))
    rs, cs = fn(torch.from_numpy(counters))
    assert tuple(rs.shape) == (d, wr) and tuple(cs.shape) == (d, wc) and rs.dtype == cs.dtype == torch.float32
    for got, want, oracle in ((rs, want_rs, ref_rs), (cs, want_cs, ref_cs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


@pytest.mark.parametrize("wr,wc", [(200, 200), (96, 160)])
def test_node_flows_match_reference_ops_and_registers(wr, wc):
    """tests/test_kernels.py's flow point query: the flows computed from the
    counters give the same answers as the maintained registers."""
    rng = np.random.default_rng(wr)
    cfg = RefConfig(depth=3, width_rows=wr, width_cols=wc)
    src = rng.integers(0, 100, 300).astype(np.uint32)
    dst = rng.integers(0, 100, 300).astype(np.uint32)
    ref = RefSketch.empty(cfg, jax.random.key(1)).update(jnp.asarray(src), jnp.asarray(dst))
    port = to_port(ref)
    keys = np.concatenate([src[:20], dst[:20], [12345]]).astype(np.uint32)
    k = keys_to_tensor(keys)
    for port_fn, ref_fn, register_fn in (
        (flow_ops.node_in_flow, ref_flow_ops.node_in_flow, queries.node_in_flow),
        (flow_ops.node_out_flow, ref_flow_ops.node_out_flow, queries.node_out_flow),
    ):
        got = port_fn(port, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_fn(ref, jnp.asarray(keys), interpret=True)))
        assert torch.equal(got, register_fn(port, k))


@pytest.mark.parametrize("fn", [edge_query_cells_ref, edge_query_cells], ids=["plain", "wrapper-on-cpu"])
@pytest.mark.parametrize("d,wr,wc,q", [(1, 64, 64, 17), (3, 256, 512, 300), (2, 300, 200, 1000)])
def test_edge_query_cells_match_reference_kernel(fn, d, wr, wc, q):
    rng = np.random.default_rng(q)
    counters = rng.integers(0, 100, (d, wr, wc)).astype(np.float32)
    rows = rng.integers(0, wr, (d, q)).astype(np.int32)
    cols = rng.integers(0, wc, (d, q)).astype(np.int32)
    want = np.asarray(ref_edge_query_cells(*(jnp.asarray(a) for a in (counters, rows, cols)), interpret=True))
    got = fn(*(torch.from_numpy(a) for a in (counters, rows, cols)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, q)
    np.testing.assert_array_equal(got.numpy(), want)
    mins = edge_query_min(*(torch.from_numpy(a) for a in (counters, rows, cols)))
    assert torch.equal(got.amin(dim=0), mins)


def test_wrappers_refuse_devices_other_than_cuda_and_cpu():
    meta = torch.empty(1, 8, 8, device="meta")
    idx = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flow_ops.flows(meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        edge_query_cells(meta, idx, idx)


def hashed_queries(d, wr, wc, q, seed):
    """A tiny loaded reference sketch, the port's copy of it, and (d, Q) int64
    buckets from the port's ``hash_edges`` (the serve path's dtype)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 500, 2000).astype(np.uint32)
    dst = rng.integers(0, 500, 2000).astype(np.uint32)
    w = rng.integers(1, 6, 2000).astype(np.float32)
    cfg = RefConfig(depth=d, width_rows=wr, width_cols=wc)
    ref = RefSketch.empty(cfg, jax.random.key(seed)).update(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    port = to_port(ref)
    qs = np.concatenate([src[:q // 2], rng.integers(0, 500, q - q // 2)]).astype(np.uint32)
    qd = np.concatenate([dst[:q // 2], rng.integers(0, 500, q - q // 2)]).astype(np.uint32)
    rows, cols = port.hash_edges(keys_to_tensor(qs), keys_to_tensor(qd))
    return port, rows, cols


@pytest.mark.parametrize("d", [1, 3, 9])
def test_edge_query_cells_on_int64_hashed_buckets_match_reference_kernel(d):
    port, rows, cols = hashed_queries(d, 256, 200, 300, seed=d)
    assert rows.dtype == cols.dtype == torch.int64
    want = np.asarray(ref_edge_query_cells(jnp.asarray(port.counters.numpy()), jnp.asarray(rows.numpy()),
                                           jnp.asarray(cols.numpy()), interpret=True))
    got = edge_query_cells(port.counters, rows, cols)
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, 300)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(edge_query_cells(port.counters, rows.int(), cols.int()).numpy(), want)


@pytest.mark.parametrize("fn", [edge_query_cells, edge_query_min])
def test_query_wrappers_refuse_float_and_mixed_indices(fn):
    counters = torch.zeros(2, 16, 16)
    i32 = torch.zeros(2, 8, dtype=torch.int32)
    for rows, cols in ((i32.float(), i32.float()), (i32, i32.long()), (i32.long(), i32), (i32, i32.float())):
        with pytest.raises(ValueError, match="int32 or both int64"):
            fn(counters, rows, cols)
    with pytest.raises(ValueError, match="float32"):
        fn(counters.double(), i32, i32)
    with pytest.raises(ValueError, match="Q"):
        fn(counters, i32, i32[:, :5])
    # A non-contiguous index tensor is made contiguous, not refused.
    wide = torch.randint(0, 16, (2, 16), dtype=torch.int64)
    rows, cols = wide[:, ::2], wide[:, 1::2]
    assert torch.equal(fn(counters, rows, cols), fn(counters, rows.contiguous(), cols.contiguous()))
