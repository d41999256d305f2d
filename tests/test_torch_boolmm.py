"""The boolean product of ``kernels/boolmm`` and the card's touched-row
closure refresh built on it, on CPU tensors: the product's plain version
against the float path at shapes off the kernel's tile, and the card refresh
(``QueryEngine``'s and the fleet's ``cuda`` entries, which run the product's
plain version here) against the plain ``closure_refresh`` of both packages
and a full rebuild, on additions-only histories of a session, a 3-tenant
fleet and a windowed fleet."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reach as ref_reach
from repro.fleet import query as ref_fleet_query
from repro_torch.core import reach
from repro_torch.core.query_engine import _FAMILIES
from repro_torch.fleet import query as fleet_query
from repro_torch.kernels.boolmm import ops
from repro_torch.kernels.boolmm.ref import bool_product_ref

SHAPES = [(1, 1, 1), (63, 64, 65), (64, 65, 63), (65, 63, 64), (200, 1, 65), (1, 200, 64), (64, 64, 200),
          (200, 200, 200)]


@pytest.mark.parametrize("with_c0", [False, True], ids=["plain", "c0"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plain_product_equals_float_path(m, n, k, with_c0):
    """``c0 OR (a @ b > 0)`` with its transpose, against the float32 product
    and an int64 one, at M, N and K off the kernel's 128 tile."""
    rng = np.random.default_rng(m * 10_000 + n * 100 + k)
    a = torch.from_numpy((rng.random((2, m, k)) < 0.05).astype(np.uint8))
    b_t = torch.from_numpy((rng.random((2, n, k)) < 0.05).astype(np.uint8))
    c0 = torch.from_numpy((rng.random((2, m, n)) < 0.05).astype(np.uint8)) if with_c0 else None
    want = torch.matmul(a.float(), b_t.float().transpose(1, 2)) > 0
    exact = torch.from_numpy(np.asarray(a, np.int64) @ np.asarray(b_t, np.int64).transpose(0, 2, 1) > 0)
    assert torch.equal(want, exact)
    if with_c0:
        want |= c0.bool()
    assert torch.equal(bool_product_ref(a, b_t, c0), want.to(torch.uint8))
    out, out_t = torch.empty((2, m, n), dtype=torch.uint8), torch.empty((2, n, m), dtype=torch.uint8)
    got = ops.bool_product(a, b_t, c0, out=out, out_t=out_t)
    assert got.data_ptr() == out.data_ptr() and torch.equal(out, want.to(torch.uint8))
    assert torch.equal(out_t, want.transpose(1, 2).to(torch.uint8))


def _plan(rng, w, t):
    """A (T,) touched-row plan of ``w`` rows: distinct rows, duplicates of
    them, then row-0 padding, as the engines pad."""
    k = max(1, 3 * t // 4)
    pad = t // 8
    distinct = rng.choice(np.arange(1, w), k, replace=False)
    return np.concatenate([distinct, rng.choice(distinct, t - k - pad), np.zeros(pad, np.int64)])


def _add(rng, counters, rows):
    """Additions only, confined to the planned rows of each depth:
    ``counters`` (d, w, w), ``rows`` (d, T)."""
    w = counters.shape[-1]
    for j, plan in enumerate(rows):
        for r in np.unique(plan):
            counters[j, r, rng.integers(0, w, 3)] += rng.integers(1, 9, 3)


def _session(rng, w, d, t):
    before = ((rng.random((d, w, w)) < 1.0 / w) * rng.integers(1, 9, (d, w, w))).astype(np.float32)
    rows = np.stack([_plan(rng, w, t) for _ in range(d)])
    after = before.copy()
    _add(rng, after, rows)
    closure = reach.transitive_closure(torch.from_numpy(before))
    args = (closure, torch.from_numpy(after), torch.from_numpy(rows))
    want = reach.transitive_closure(torch.from_numpy(after))
    ref = ref_reach.closure_refresh(jnp.asarray(closure.numpy()), jnp.asarray(after), jnp.asarray(rows, jnp.int32))
    return _FAMILIES["closure_refresh"], args, want, ref


def _fleet(rng, w, d, t, slices):
    """Three tenants of ``slices`` slices each, refreshed together in the
    order 2, 0, 1; additions land in any slice of a planned row."""
    tenants, sel = 3, [2, 0, 1]
    before = (rng.random((tenants, slices, d, w, w)) < 0.5 / w).astype(np.float32)
    rows = np.stack([np.stack([_plan(rng, w, t) for _ in range(d)]) for _ in sel])
    after = before.copy()
    for i, s in enumerate(sel):
        grown = after[s].sum(axis=0)
        _add(rng, grown, rows[i])
        after[s, rng.integers(0, slices)] += grown - after[s].sum(axis=0)
    summed = torch.from_numpy(after[sel].sum(axis=1))
    closures = reach.transitive_closure(torch.from_numpy(before[sel].sum(axis=1)))
    args = (closures, torch.from_numpy(after), sel, torch.from_numpy(rows))
    ref = ref_fleet_query.fleet_closure_refresh(jnp.asarray(closures.numpy()), jnp.asarray(after),
                                                jnp.asarray(sel), jnp.asarray(rows, jnp.int32))
    fns = (fleet_query.fleet_closure_refresh, fleet_query.cuda_fleet_closure_refresh)
    return fns, args, reach.transitive_closure(summed), ref


@pytest.mark.parametrize("t", [1, 64, 65, 130])
@pytest.mark.parametrize("history", ["session", "fleet3", "windowed_fleet3"])
def test_card_refresh_on_cpu_equals_plain_and_reference(history, t):
    """The card refresh, its products on the plain version, element for
    element against the plain refresh, the JAX reference's refresh and a
    full rebuild of the new counters; T = 130 pads to the tile, 256."""
    rng = np.random.default_rng(t)
    w, d = 160, 3
    if history == "session":
        (plain, card), args, want, ref = _session(rng, w, d, t)
    else:
        (plain, card), args, want, ref = _fleet(rng, w, d, t, 1 if history == "fleet3" else 2)
    got = card(*args)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(plain(*args), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
