"""Card-only tests: each CUDA kernel against its plain PyTorch version on the
card, the wrappers' checks, and small sessions (plain and fused) on the card
against the same sessions on the CPU.  Marked ``gpu``; they skip where no CUDA card is
present (decided in the fixture, never at import).  Run them on the card
with ``python -m pytest -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import reach
from repro_torch.kernels.boolmm import ops as boolmm_ops
from repro_torch.kernels.boolmm.ref import bool_product_ref
from repro_torch.kernels.closure import ops as closure_ops
from repro_torch.kernels.closure.ref import closure_step_ref
from repro_torch.kernels.countsketch import ops as cs_ops
from repro_torch.core.hashing import HashFamily, make_hash_family
from repro_torch.kernels.countsketch.ref import countsketch_median_ref, countsketch_ref
from repro_torch.kernels.flow import ops as flow_ops
from repro_torch.kernels.flow.ref import flows_ref
from repro_torch.kernels.ingest import ops as ingest_ops
from repro_torch.kernels.ingest.ref import ingest_keys_ref, ingest_scatter_ref
from repro_torch.kernels.ingest_fused import ops as fused_ops
from repro_torch.kernels.ingest_fused.ref import fused_ingest_ref
from repro_torch.kernels.ingest_stacked import ops as stacked_ops
from repro_torch.kernels.ingest_stacked.ref import stacked_ingest_ref
from repro_torch.kernels.preagg import ops as preagg_ops
from repro_torch.kernels.preagg.ref import preagg_collapse_ref
from repro_torch.kernels.query import ops as query_ops
from repro_torch.kernels.query.ref import edge_query_cells_ref, edge_query_min_ref
from repro_torch.kernels.sequential import ops as seq_ops
from repro_torch.kernels.sequential.ref import sequential_update_ref
from repro_torch.launch import serve, train_lm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("d,wr,wc,b,offset", [(1, 64, 64, 33, 0), (3, 1000, 700, 5000, 0), (2, 256, 128, 4096, 256)])
def test_ingest_kernel_bit_equals_plain_version(cuda, d, wr, wc, b, offset):
    base = torch.randint(0, 1000, (d, wr, wc), generator=cuda, device="cuda").float()
    rows = torch.randint(0, wr + offset * 2, (d, b), generator=cuda, device="cuda", dtype=torch.int32)
    rows[torch.rand((d, b), generator=cuda, device="cuda") < 0.1] = -1
    cols = torch.randint(0, wc, (d, b), generator=cuda, device="cuda", dtype=torch.int32)
    w = torch.randint(0, 9, (b,), generator=cuda, device="cuda").float()
    before = ingest_ops.ingest_scatter.launches
    got = ingest_ops.ingest_scatter(base.clone(), rows, cols, w, row_offset=offset)
    assert ingest_ops.ingest_scatter.launches == before + 1
    want = ingest_scatter_ref(base.clone(), rows, cols, w, row_offset=offset)
    assert torch.equal(got, want)


def test_ingest_kernel_float_weights_close(cuda):
    rows = torch.randint(0, 128, (2, 7000), generator=cuda, device="cuda")
    cols = torch.randint(0, 128, (2, 7000), generator=cuda, device="cuda")
    w = torch.randn(7000, generator=cuda, device="cuda")
    got = ingest_ops.ingest_scatter(torch.zeros(2, 128, 128, device="cuda"), rows, cols, w)
    want = ingest_scatter_ref(torch.zeros(2, 128, 128, device="cuda"), rows, cols, w)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("d,wr,wc,q", [(1, 64, 64, 17), (3, 256, 512, 300), (5, 1024, 1024, 65536)])
def test_query_kernel_bit_equals_plain_version(cuda, d, wr, wc, q):
    counters = torch.randint(0, 100, (d, wr, wc), generator=cuda, device="cuda").float()
    rows = torch.randint(0, wr, (d, q), generator=cuda, device="cuda")
    cols = torch.randint(0, wc, (d, q), generator=cuda, device="cuda")
    got = query_ops.edge_query_min(counters, rows, cols)
    assert got.shape == (q,) and got.dtype == torch.float32
    assert torch.equal(got, edge_query_min_ref(counters, rows, cols))


# Widths past the reference's 2,048 cap (MAX_FUSED_WC) launch the kernel too.
@pytest.mark.parametrize("d,wr,wc,b", [(1, 64, 64, 33), (3, 300, 200, 1000), (2, 512, 3000, 20000)])
def test_fused_ingest_kernel_bit_equals_plain_version(cuda, d, wr, wc, b):
    def state():
        g = torch.Generator(device="cuda").manual_seed(d * b)
        return (
            torch.randint(0, 1000, (d, wr, wc), generator=g, device="cuda").float(),
            torch.randint(0, 1000, (d, wr), generator=g, device="cuda").float(),
            torch.randint(0, 1000, (d, wc), generator=g, device="cuda").float(),
        )

    rows = torch.randint(0, wr, (d, b), generator=cuda, device="cuda", dtype=torch.int32)
    rows[torch.rand((d, b), generator=cuda, device="cuda") < 0.1] = -1
    cols = torch.randint(0, wc, (d, b), generator=cuda, device="cuda", dtype=torch.int32)
    w = torch.randint(0, 9, (b,), generator=cuda, device="cuda").float()  # some weight 0
    before = fused_ops.fused_ingest.launches
    got = fused_ops.fused_ingest(*state(), rows, cols, w)
    assert fused_ops.fused_ingest.launches == before + 1
    want = fused_ingest_ref(*state(), rows, cols, w)
    assert got[3].dtype == torch.bool
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_fused_ingest_kernel_float_weights_close(cuda):
    rows = torch.randint(0, 128, (2, 7000), generator=cuda, device="cuda")
    cols = torch.randint(0, 128, (2, 7000), generator=cuda, device="cuda")
    w = torch.randn(7000, generator=cuda, device="cuda")

    def state():
        return torch.zeros(2, 128, 128, device="cuda"), torch.zeros(2, 128, device="cuda"), torch.zeros(2, 128, device="cuda")

    got = fused_ops.fused_ingest(*state(), rows, cols, w)
    want = fused_ingest_ref(*state(), rows, cols, w)
    for g, x in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, x, rtol=1e-6, atol=1e-5)
    assert torch.equal(got[3], want[3])


def _sorted_batch(pattern, d, wr, wc, seed):
    """A hashed batch as a fused session hands it to the kernel: slots in
    runs of one source (every sketch's row constant along a run), integer
    weights 1..8.  ``one_source``: one run over the whole batch; ``runs``:
    runs of 1 to a few thousand slots, crossing warp (32 slots) and block
    boundaries; ``padded``: 25,356 slots in runs, padded to 32,768 with the
    bucket of key 0 and weight 0, as ``pad_bucket`` pads; ``inert_in_runs``:
    runs with a tenth of their slots -1; ``zero_run``: runs with the longest
    one's weights all 0."""
    rng = np.random.default_rng(seed)
    b = 32_768 if pattern == "padded" else 20_000
    n = 25_356 if pattern == "padded" else b
    if pattern == "one_source":
        lengths = np.array([n])
    else:
        lengths = np.concatenate([[2_500, 1_100, 33, 31, 64, 1], rng.geometric(1 / 40, n)])
        lengths = lengths[: np.searchsorted(np.cumsum(lengths), n) + 1]
        lengths[-1] -= lengths.sum() - n
        rng.shuffle(lengths)
    run_of = np.repeat(np.arange(lengths.size), lengths)
    rows = rng.integers(0, wr, (d, lengths.size))[:, run_of]
    cols = rng.integers(0, wc, (d, n))
    w = rng.integers(1, 9, n).astype(np.float32)
    if pattern == "padded":
        rows = np.concatenate([rows, np.repeat(rng.integers(0, wr, (d, 1)), b - n, axis=1)], axis=1)
        cols = np.concatenate([cols, np.repeat(rng.integers(0, wc, (d, 1)), b - n, axis=1)], axis=1)
        w = np.concatenate([w, np.zeros(b - n, np.float32)])
    elif pattern == "inert_in_runs":
        rows[rng.random((d, b)) < 0.1] = -1
    elif pattern == "zero_run":
        w[run_of == np.argmax(lengths)] = 0.0
        w[rng.random(b) < 0.02] = 0.0
    return rows, cols, w


def _fused_state(d, wr, wc, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (
        torch.randint(0, 1000, (d, wr, wc), generator=g, device="cuda").float(),
        torch.randint(0, 1000, (d, wr), generator=g, device="cuda").float(),
        torch.randint(0, 1000, (d, wc), generator=g, device="cuda").float(),
    )


@pytest.mark.parametrize("pattern", ["one_source", "runs", "padded", "inert_in_runs", "zero_run"])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("d", [1, 5, 8])
def test_fused_ingest_kernel_bit_equal_on_sorted_runs(cuda, d, index_dtype, pattern):
    """The warp-aggregated row_flows and touched against the plain version on
    integer weights: runs of one row within and across warps and blocks."""
    wr, wc = 1024, 512
    rows, cols, w = _sorted_batch(pattern, d, wr, wc, seed=d)
    r, c = (torch.from_numpy(x).to(index_dtype).cuda() for x in (rows, cols))
    wt = torch.from_numpy(w).cuda()
    before = fused_ops.fused_ingest.launches
    got = fused_ops.fused_ingest(*_fused_state(d, wr, wc, d), r, c, wt)
    assert fused_ops.fused_ingest.launches == before + 1
    want = fused_ingest_ref(*_fused_state(d, wr, wc, d), r, c, wt)
    for name, g, x in zip(("counters", "row_flows", "col_flows", "touched"), got, want):
        assert torch.equal(g, x), name


@pytest.mark.parametrize("pattern", ["runs", "padded"])
def test_fused_ingest_kernel_float_weights_close_on_sorted_runs(cuda, pattern):
    """Float weights: a run's register sum is taken in another order than the
    plain version's, so each output is held to the rounding bound of a sum
    in any order, 2 n u sum|w| (n terms, u = 2^-24; both sides lie within
    n u sum|w| of the exact sum), not to a fixed tolerance: runs of
    thousands of slots add thousands of roundings into one register."""
    d, wr, wc = 3, 256, 256
    rows, cols, w = _sorted_batch(pattern, d, wr, wc, seed=3)
    w = np.where(w != 0, np.random.default_rng(3).normal(0, 1, w.shape), 0).astype(np.float32)
    r, c, wt = (torch.from_numpy(x).cuda() for x in (rows, cols, w))

    def zeros(dtype=torch.float32):
        return (torch.zeros(d, wr, wc, device="cuda", dtype=dtype), torch.zeros(d, wr, device="cuda", dtype=dtype),
                torch.zeros(d, wc, device="cuda", dtype=dtype))

    got = fused_ops.fused_ingest(*zeros(), r, c, wt)
    want = fused_ingest_ref(*zeros(), r, c, wt)
    mass = fused_ingest_ref(*zeros(torch.float64), r, c, wt.double().abs())[:3]
    terms = fused_ingest_ref(*zeros(torch.float64), r, c, torch.ones_like(wt, dtype=torch.float64))[:3]
    for g, x, m, n in zip(got[:3], want[:3], mass, terms):
        assert bool(((g.double() - x.double()).abs() <= 2 * n * 2.0**-24 * m).all())
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("wr,shift", [(256, 0), (255, 0), (256, 1), (255, 3)])
def test_fused_ingest_kernel_ors_into_a_given_bitmap(cuda, wr, shift):
    """The second launch of an undirected sketch: the given bitmap is ORed
    into (not zeroed) on the card, as the plain version does, also where
    the bitmap is not 4-byte aligned (``shift``) or sized (d * wr odd), so
    that its ends take byte stores; a new bitmap is zeroed first even over
    a stale allocation."""
    d, wc = 3, 128
    rows, cols, w = _sorted_batch("runs", d, wr, wc, seed=9)
    r, c, wt = (torch.from_numpy(x).cuda() for x in (rows, cols, w))
    given = torch.rand((d, wr), generator=cuda, device="cuda") < 0.3
    shifted = torch.zeros(d * wr + shift, dtype=torch.bool, device="cuda")[shift:].view(d, wr)
    shifted.copy_(given)
    state, ref_state = _fused_state(d, wr, wc, 9), _fused_state(d, wr, wc, 9)
    got = fused_ops.fused_ingest(*state, r[:, :500], c[:, :500], wt[:500], shifted)
    want = fused_ingest_ref(*ref_state, r[:, :500], c[:, :500], wt[:500], given.clone())
    assert got[3] is shifted
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    for _ in range(3):  # fresh bitmaps over reused allocations hold only their batch's rows
        fresh = fused_ops.fused_ingest(*state, r[:, :40], c[:, :40], wt[:40])[3]
        assert torch.equal(fresh, fused_ingest_ref(*ref_state, r[:, :40], c[:, :40], wt[:40])[3])
    empty = fused_ops.fused_ingest(*state, r[:, :0], c[:, :0], wt[:0])[3]
    assert empty.shape == (d, wr) and not bool(empty.any())


@pytest.mark.parametrize("offset", [0, 512])
def test_ingest_kernel_bit_equal_on_int64_buckets_with_row_offset(cuda, offset):
    d, wr, wc, b = 3, 512, 700, 20_000
    base = torch.randint(0, 1000, (d, wr, wc), generator=cuda, device="cuda").float()
    rows = torch.randint(-1, 3 * wr, (d, b), generator=cuda, device="cuda")  # int64; other shards' rows too
    cols = torch.randint(0, wc, (d, b), generator=cuda, device="cuda")
    w = torch.randint(0, 9, (b,), generator=cuda, device="cuda").float()
    got = ingest_ops.ingest_scatter(base.clone(), rows, cols, w, row_offset=offset)
    want = ingest_scatter_ref(base.clone(), rows, cols, w, row_offset=offset)
    assert torch.equal(got, want)
    assert torch.equal(ingest_ops.ingest_scatter(base.clone(), rows.int(), cols.int(), w, row_offset=offset), want)


def test_ingest_wrappers_refuse_bad_buckets_on_the_card(cuda):
    counters, rf, cf = _fused_state(2, 16, 16, 0)
    i32 = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
    w = torch.ones(8, device="cuda")
    bad = ((i32.float(), i32.float()), (i32.double(), i32.double()), (i32.short(), i32.short()),
           (i32.to(torch.uint8), i32.to(torch.uint8)), (i32, i32.long()), (i32.long(), i32))
    for rows, cols in bad:
        with pytest.raises(ValueError, match="int32 or both int64"):
            ingest_ops.ingest_scatter(counters, rows, cols, w)
        with pytest.raises(ValueError, match="int32 or both int64"):
            fused_ops.fused_ingest(counters, rf, cf, rows, cols, w)
    with pytest.raises(ValueError, match="on cuda"):
        ingest_ops.ingest_scatter(counters, i32.cpu(), i32, w)
    with pytest.raises(ValueError, match="weights"):
        fused_ops.fused_ingest(counters, rf, cf, i32, i32, w.double())


def test_ingest_kernels_launch_on_the_current_stream(cuda):
    """Both kernels, and the bitmap's zeroing, run on the caller's stream:
    their weights are written behind a sleep on a side stream, so a launch
    on another stream would read them before."""
    d, wr, wc = 2, 256, 256
    rows, cols, w = _sorted_batch("runs", d, wr, wc, seed=1)
    r, c, wt = (torch.from_numpy(x).cuda() for x in (rows, cols, w))
    state, ref_state = _fused_state(d, wr, wc, 1), _fused_state(d, wr, wc, 1)
    scattered = ref_state[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000)
        wt += 1
        got = fused_ops.fused_ingest(*state, r, c, wt)
        ingest_ops.ingest_scatter(scattered, r, c, wt)
    side.synchronize()
    want = fused_ingest_ref(*ref_state, r, c, wt)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert torch.equal(scattered, want[0])


@pytest.mark.parametrize("d,wr,wc", [(1, 64, 64), (4, 300, 200), (2, 1000, 70), (5, 1024, 8192)])
def test_flows_kernel_bit_equals_plain_version(cuda, d, wr, wc):
    counters = torch.randint(0, 1000, (d, wr, wc), generator=cuda, device="cuda").float()
    before = flow_ops.flows.launches
    rs, cs = flow_ops.flows(counters)
    assert flow_ops.flows.launches == before + 1
    want_rs, want_cs = flows_ref(counters)
    assert torch.equal(rs, want_rs) and torch.equal(cs, want_cs)


@pytest.mark.parametrize("d,wr,wc,q", [(1, 64, 64, 17), (3, 256, 512, 300), (5, 1024, 1024, 65536)])
def test_query_cells_kernel_bit_equals_plain_version(cuda, d, wr, wc, q):
    counters = torch.randint(0, 100, (d, wr, wc), generator=cuda, device="cuda").float()
    rows = torch.randint(0, wr, (d, q), generator=cuda, device="cuda")
    cols = torch.randint(0, wc, (d, q), generator=cuda, device="cuda")
    before = query_ops.edge_query_cells.launches
    got = query_ops.edge_query_cells(counters, rows, cols)
    assert query_ops.edge_query_cells.launches == before + 1
    assert got.shape == (d, q) and got.dtype == torch.float32
    assert torch.equal(got, edge_query_cells_ref(counters, rows, cols))


@pytest.mark.parametrize("q", [1, 255, 1024, 65537])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("d", [1, 2, 5, 8, 9])
def test_query_kernels_bit_equal_plain_versions_by_depth_and_index_dtype(cuda, d, index_dtype, q):
    """Both gathers at every unrolled depth (1..8) and the runtime-depth
    instantiation (9), on int32 and int64 buckets, with ragged Q."""
    counters = torch.randint(0, 1000, (d, 300, 520), generator=cuda, device="cuda").float()
    rows = torch.randint(0, 300, (d, q), generator=cuda, device="cuda").to(index_dtype)
    cols = torch.randint(0, 520, (d, q), generator=cuda, device="cuda").to(index_dtype)
    before = (query_ops.edge_query_min.launches, query_ops.edge_query_cells.launches)
    mins = query_ops.edge_query_min(counters, rows, cols)
    cells = query_ops.edge_query_cells(counters, rows, cols)
    assert (query_ops.edge_query_min.launches, query_ops.edge_query_cells.launches) == (before[0] + 1, before[1] + 1)
    assert mins.shape == (q,) and cells.shape == (d, q)
    assert torch.equal(mins, edge_query_min_ref(counters, rows, cols))
    assert torch.equal(cells, edge_query_cells_ref(counters, rows, cols))


def test_query_kernels_with_64_bit_offsets(cuda):
    """d=2, 32,768 x 32,768: 2^31 cells, past the 32-bit offset
    instantiation; the buckets point into the last rows of the last sketch."""
    d, w, q = 2, 32768, 4096
    counters = torch.zeros(d, w, w, device="cuda")
    counters[:, -64:] = torch.randint(1, 1000, (d, 64, w), generator=cuda, device="cuda").float()
    rows = torch.randint(w - 64, w, (d, q), generator=cuda, device="cuda")
    cols = torch.randint(0, w, (d, q), generator=cuda, device="cuda")
    for r, c in ((rows, cols), (rows.int(), cols.int())):
        cells = query_ops.edge_query_cells(counters, r, c)
        assert bool((cells > 0).all())
        assert torch.equal(cells, edge_query_cells_ref(counters, r, c))
        assert torch.equal(query_ops.edge_query_min(counters, r, c), edge_query_min_ref(counters, r, c))


def test_query_kernels_launch_on_the_current_stream(cuda):
    counters = torch.randint(0, 1000, (5, 256, 256), generator=cuda, device="cuda").float()
    rows = torch.randint(0, 256, (5, 1000), generator=cuda, device="cuda")
    cols = torch.randint(0, 256, (5, 1000), generator=cuda, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert torch._C._cuda_getCurrentRawStream(counters.get_device()) == torch.cuda.current_stream().cuda_stream
        assert torch.cuda.current_stream().cuda_stream == side.cuda_stream
        # The update waits behind a sleep on the side stream: a kernel
        # launched on another stream would read the counters before it.
        torch.cuda._sleep(1_000_000)
        counters += 1
        mins = query_ops.edge_query_min(counters, rows, cols)
        cells = query_ops.edge_query_cells(counters, rows, cols)
    side.synchronize()
    assert torch.equal(mins, edge_query_min_ref(counters, rows, cols))
    assert torch.equal(cells, edge_query_cells_ref(counters, rows, cols))


def test_query_wrappers_refuse_bad_indices_on_the_card(cuda):
    counters = torch.zeros(2, 16, 16, device="cuda")
    i32 = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
    for fn in (query_ops.edge_query_min, query_ops.edge_query_cells):
        for rows, cols in ((i32.float(), i32.float()), (i32, i32.long()), (i32.long(), i32)):
            with pytest.raises(ValueError, match="int32 or both int64"):
                fn(counters, rows, cols)
        with pytest.raises(ValueError, match="on cuda"):
            fn(counters, i32.cpu(), i32)


@pytest.mark.parametrize(
    "n,w,density",
    [(1, 128, 0.02), (3, 384, 0.005), (2, 1024, 0.002), (2, 256, 1.0), (2, 512, 0.0), (1, 768, 0.6)],
)
def test_closure_step_bit_equals_plain_version(cuda, n, w, density):
    """Both of the step's outputs against the plain version, at random
    densities and at all ones (every sum equals w) and all zeros."""
    a = (torch.rand((n, w, w), generator=cuda, device="cuda") < density).to(torch.uint8)
    before = closure_ops.closure_step.launches
    got, got_t = closure_ops.closure_step(a, a.transpose(1, 2).contiguous())
    assert closure_ops.closure_step.launches == before + 1
    want = closure_step_ref(a)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(got_t, want.transpose(1, 2))
    assert got.data_ptr() != a.data_ptr()


@pytest.mark.parametrize("w", [200, 256])
def test_closure_loop_matches_plain_closure(cuda, w):
    adj = (torch.rand((3, w, w), generator=cuda, device="cuda") < 2.0 / w).float() * 5
    before = closure_ops.closure_step.launches
    got = closure_ops.transitive_closure(adj)
    assert closure_ops.closure_step.launches - before == closure_ops.closure_steps(w)
    assert got.dtype == torch.bool and torch.equal(got, reach.transitive_closure(adj))


def _bits(gen, shape, density):
    return (torch.rand(shape, generator=gen, device="cuda") < density).to(torch.uint8)


@pytest.mark.parametrize("w,t", [(8192, 64), (8192, 1000), (8192, 2048), (200, 64), (384, 130)])
def test_bool_product_bit_equals_plain_version(cuda, w, t):
    """The refresh's four products at (w, T), two matrices: Δ·B with its
    transpose (sums far past 255), a squaring S OR S·S, S*·U, and B OR G·W
    with no transpose; T and w = 200 off the tile (the wrapper pads)."""
    n = 2
    delta, b, s = _bits(cuda, (n, t, w), 0.002), _bits(cuda, (n, w, w), 0.3), _bits(cuda, (n, t, t), 0.01)
    b_t = b.transpose(1, 2).contiguous()
    u_t = torch.empty((n, w, t), dtype=torch.uint8, device="cuda")
    s2_t = torch.empty((n, t, t), dtype=torch.uint8, device="cuda")
    cases = [
        ((delta, b_t), {"out_t": u_t}),
        ((s, s.transpose(1, 2).contiguous()), {"c0": s, "out_t": s2_t}),
        ((s, None), {}),
        ((None, None), {"c0": b}),
    ]
    for (a, bt), kw in cases:
        if a is None:  # B OR G·W: G is B's first T columns, W^T the last product's
            a, bt = b[:, :, :t].contiguous(), w_t
        if bt is None:  # S*·U, written as W^T
            bt, w_t = u_t.clone(), torch.empty((n, w, t), dtype=torch.uint8, device="cuda")
            kw = {"out_t": w_t}
        before = boolmm_ops.bool_product.launches
        got = boolmm_ops.bool_product(a, bt, **kw)
        assert boolmm_ops.bool_product.launches == before + 1
        want = bool_product_ref(a, bt, kw.get("c0"))
        assert got.dtype == torch.uint8 and torch.equal(got, want), (w, t, a.shape, bt.shape)
        if "out_t" in kw:
            assert torch.equal(kw["out_t"], want.transpose(1, 2))


@pytest.mark.parametrize("shape,launched", [((3, 256, 384), 1), ((1, 128, 8192), 1), ((2, 200, 128), 0)])
def test_byte_transpose_equals_torch(cuda, shape, launched):
    """The refresh's byte transpose: the kernel at tile multiples, a strided
    copy elsewhere."""
    a = _bits(cuda, shape, 0.5)
    before = boolmm_ops.byte_transpose.launches
    got = boolmm_ops.byte_transpose(a)
    assert boolmm_ops.byte_transpose.launches - before == launched
    assert torch.equal(got, a.transpose(1, 2))


def test_card_refresh_launches_and_equals_plain_refresh(cuda):
    """The session's card refresh at w = 256, T = 130 (padded to the tile,
    256): 3 + ceil(log2 256) products and 2 transposes, equal to the plain
    float refresh on the card and to a full rebuild."""
    from repro_torch.core.query_engine import _FAMILIES

    d, w = 3, 256
    before = (torch.rand((d, w, w), generator=cuda, device="cuda") < 1.5 / w).float()
    rows = torch.randint(1, w, (d, 130), generator=cuda, device="cuda")
    after = before.clone()
    after[torch.arange(d, device="cuda")[:, None], rows, torch.randint(0, w, (d, 130), generator=cuda,
                                                                         device="cuda")] += 3.0
    closure = closure_ops.transitive_closure(before)
    plain, card = _FAMILIES["closure_refresh"]
    launches = boolmm_ops.bool_product.launches, boolmm_ops.byte_transpose.launches
    got = card(closure, after, rows)
    assert boolmm_ops.bool_product.launches - launches[0] == 3 + closure_ops.closure_steps(256)
    assert boolmm_ops.byte_transpose.launches - launches[1] == 2  # the closure and S
    assert got.dtype == torch.bool and torch.equal(got, plain(closure, after, rows))
    assert torch.equal(got, reach.transitive_closure(after))


def _kernel_counts(fn):
    """{kernel name: launches} of one call of ``fn`` on the card, from the
    profiler; a warm call first, and spin kernels ahead of the traced call,
    since a trace may come back without the records of its first kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(250_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) and "spin_kernel" not in e.key}


def test_closure_and_refresh_keep_their_kernel_names(cuda):
    """B3 and the refresh's product share one device body under two kernel
    names, and the benchmark tells them apart by name (``closure_roofline``
    counts every kernel matching ``closure_step`` as B3): a closure at
    w = 256 launches ``closure_step_wgmma_kernel`` ``closure_steps(256)``
    times and no ``bool_product_wgmma_kernel``; a card refresh launches
    ``bool_product_wgmma_kernel`` 3 + ``closure_steps(256)`` times (T = 130
    padded to 256), ``byte_transpose_kernel`` twice, and nothing named
    ``closure_step``."""
    from repro_torch.core.query_engine import _FAMILIES

    def launched(counts, name):
        return sum(n for key, n in counts.items() if name in key)

    d, w = 3, 256
    before = (torch.rand((d, w, w), generator=cuda, device="cuda") < 1.5 / w).float()
    closure = closure_ops.transitive_closure(before)
    counts = _kernel_counts(lambda: closure_ops.transitive_closure(before))
    assert launched(counts, "closure_step_wgmma_kernel") == closure_ops.closure_steps(w), counts
    assert launched(counts, "bool_product_wgmma_kernel") == 0, counts

    rows = torch.randint(1, w, (d, 130), generator=cuda, device="cuda")
    after = before.clone()
    after[torch.arange(d, device="cuda")[:, None], rows, torch.randint(0, w, (d, 130), generator=cuda,
                                                                         device="cuda")] += 3.0
    card = _FAMILIES["closure_refresh"][1]
    counts = _kernel_counts(lambda: card(closure, after, rows))
    assert launched(counts, "closure_step") == 0, counts
    assert launched(counts, "bool_product_wgmma_kernel") == 3 + closure_ops.closure_steps(w), counts
    assert launched(counts, "byte_transpose_kernel") == 2, counts


def test_card_refresh_syncs_nothing(cuda):
    """The session's and the fleet's card refreshes, inputs on the card,
    under ``set_sync_debug_mode("error")``."""
    from repro_torch.core.query_engine import _FAMILIES
    from repro_torch.fleet import query as fleet_query

    d, w, t = 2, 256, 64
    counters = (torch.rand((3, 2, d, w, w), generator=cuda, device="cuda") < 1.0 / w).float()
    rows = torch.randint(0, w, (2, d, t), generator=cuda, device="cuda")
    closures = closure_ops.transitive_closure(counters[[0, 2]].sum(dim=1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one = _FAMILIES["closure_refresh"][1](closures[0], counters[0, 0], rows[0])
        two = fleet_query.cuda_fleet_closure_refresh(closures, counters, [0, 2], rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(one, reach.closure_refresh(closures[0], counters[0, 0], rows[0]))
    assert torch.equal(two, fleet_query.fleet_closure_refresh(closures, counters, [0, 2], rows))


def _zipf_batch(rng, n, nodes=3000):
    src = (rng.zipf(1.2, n) % nodes).astype(np.uint32)
    dst = (rng.zipf(1.2, n) % nodes).astype(np.uint32)
    return src, dst, rng.integers(1, 9, n).astype(np.float32)


def test_session_card_refresh_equals_cpu(cuda):
    """A session with a standing reach on the card and on the CPU, over
    small batches that refresh incrementally: the same closure after every
    batch, through the card refresh's launches."""
    from repro_torch.api import GraphStream, Query
    from repro_torch.core.sketch import SketchConfig

    cfg = SketchConfig(depth=3, width_rows=256, width_cols=256)
    rng = np.random.default_rng(1)
    q = np.arange(16, dtype=np.uint32)
    sessions = {dev: GraphStream(cfg, seed=3, device=dev) for dev in ("cuda", "cpu")}
    for gs in sessions.values():
        gs.subscribe(Query.reach(q, q[::-1]), every=1)
    launches = boolmm_ops.bool_product.launches
    for _ in range(10):
        batch = _zipf_batch(rng, 40)
        for gs in sessions.values():
            gs.ingest(*batch)
        gpu, cpu = (sessions[dev].engine._closure for dev in ("cuda", "cpu"))
        assert torch.equal(gpu.cpu(), cpu)
    engines = [sessions[dev].engine for dev in ("cuda", "cpu")]
    assert engines[0].closure_incremental_refreshes == engines[1].closure_incremental_refreshes >= 5
    assert boolmm_ops.bool_product.launches > launches


def test_fleet_card_refresh_equals_cpu(cuda):
    """A 3-tenant fleet with standing reaches on the card and on the CPU over
    20 zipf batches (zipf tenant ids): the same closures, slot by slot,
    after every batch, through the card refresh's launches."""
    from repro_torch.api import Query
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.fleet import SketchFleet

    cfg = SketchConfig(depth=3, width_rows=256, width_cols=256)
    rng = np.random.default_rng(2)
    q = np.arange(16, dtype=np.uint32)
    fleets = {dev: SketchFleet(cfg, capacity=4, seed=5, device=dev) for dev in ("cuda", "cpu")}
    for fleet in fleets.values():
        for tenant in ("a", "b", "c"):
            fleet.tenant(tenant).subscribe(Query.reach(q, q[::-1]), every=1)
    launches = boolmm_ops.bool_product.launches
    for _ in range(20):
        ids = np.array(["a", "b", "c"])[(rng.zipf(1.3, 90) - 1) % 3]
        batch = _zipf_batch(rng, 90)
        for fleet in fleets.values():
            fleet.ingest_mixed(ids, *batch)
        gpu, cpu = (fleets[dev].engine._closures for dev in ("cuda", "cpu"))
        assert gpu.keys() == cpu.keys()
        for slot, (closure, epoch) in cpu.items():
            assert gpu[slot][1] == epoch and torch.equal(gpu[slot][0].cpu(), closure)
    engines = [fleets[dev].engine for dev in ("cuda", "cpu")]
    assert engines[0].closure_incremental_refreshes == engines[1].closure_incremental_refreshes >= 20
    assert boolmm_ops.bool_product.launches > launches


def test_wrappers_refuse_bad_operands(cuda):
    a = torch.zeros(1, 128, 128, device="cuda")
    a8 = a.to(torch.uint8)
    a8_t = a8.clone()
    with pytest.raises(ValueError):
        closure_ops.closure_step(a8, a8_t, out=a8)  # must not alias
    with pytest.raises(ValueError):
        closure_ops.closure_step(a8, a8)  # nor may the transpose
    with pytest.raises(ValueError):
        odd = torch.zeros(1, 100, 100, device="cuda", dtype=torch.uint8)
        closure_ops.closure_step(odd, odd.clone())
    with pytest.raises(ValueError):
        closure_ops.closure_step(a, a.clone())  # bytes only
    with pytest.raises(ValueError):
        boolmm_ops.bool_product(a8, a8_t, out=a8)  # the output must not alias an input
    with pytest.raises(ValueError):
        boolmm_ops.bool_product(a, a.clone())  # bytes only
    idx = torch.zeros(1, 4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        query_ops.edge_query_min(a.double(), idx, idx)
    with pytest.raises(ValueError):
        ingest_ops.ingest_scatter(a.transpose(1, 2), idx, idx, torch.ones(4, device="cuda"))
    with pytest.raises(ValueError, match="Q"):
        query_ops.edge_query_cells(a, idx, torch.zeros(1, 5, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError):
        flow_ops.flows(a.transpose(1, 2))
    with pytest.raises(ValueError):  # the registers must be float32
        fused_ops.fused_ingest(a, torch.zeros(1, 128, device="cuda").double(), torch.zeros(1, 128, device="cuda"),
                               idx, idx, torch.ones(4, device="cuda"))


def test_small_session_on_card_equals_cpu(cuda):
    argv = ["--nodes", "2000", "--edges", "20000", "--batch", "5000", "--width", "256", "--depth", "3"]
    gpu, _, gpu_events = serve.main(argv)
    cpu, _, cpu_events = serve.main(argv + ["--device", "cpu"])
    assert torch.equal(gpu._live().counters.cpu(), cpu._live().counters)
    assert torch.equal(gpu._live().row_flows.cpu(), cpu._live().row_flows)
    for a, b in zip(gpu_events, cpu_events, strict=True):
        assert (a.tick, a.epoch) == (b.tick, b.epoch)
        for ra, rb in zip(a.results, b.results):
            va = ra.value if isinstance(ra.value, tuple) else (ra.value,)
            vb = rb.value if isinstance(rb.value, tuple) else (rb.value,)
            assert all(np.array_equal(x, y) for x, y in zip(va, vb))


def test_fused_session_on_card_equals_cpu(cuda):
    argv = ["--nodes", "2000", "--edges", "20000", "--batch", "5000", "--width", "256", "--depth", "3"]

    def run(device):
        args = serve.build_parser().parse_args(argv + ["--device", device])
        args.ingest_backend = "fused"
        return serve.run(args)

    before = fused_ops.fused_ingest.launches
    gpu, _, gpu_events = run("cuda")
    assert fused_ops.fused_ingest.launches - before == 4  # one per batch
    cpu, _, cpu_events = run("cpu")
    for name in ("counters", "row_flows", "col_flows"):
        assert torch.equal(getattr(gpu._live(), name).cpu(), getattr(cpu._live(), name))
    assert gpu.engine.closure_refreshes == cpu.engine.closure_refreshes
    for a, b in zip(gpu_events, cpu_events, strict=True):
        assert (a.tick, a.epoch) == (b.tick, b.epoch)
        for ra, rb in zip(a.results, b.results):
            va = ra.value if isinstance(ra.value, tuple) else (ra.value,)
            vb = rb.value if isinstance(rb.value, tuple) else (rb.value,)
            assert all(np.array_equal(x, y) for x, y in zip(va, vb))


# 16,384 and 5,000 fit a row in shared memory; 2^17 does not (global atomics).
@pytest.mark.parametrize("d,w,n", [(5, 16384, 1_000_003), (3, 5000, 77_777), (2, 1 << 17, 300_000)])
def test_countsketch_kernel_bit_equals_plain_version_on_integers(cuda, d, w, n):
    h = torch.randint(0, w, (d, n), generator=cuda, device="cuda", dtype=torch.int32)
    s = (torch.randint(0, 2, (d, n), generator=cuda, device="cuda") * 2 - 1).to(torch.int8)
    vec = torch.randint(-8, 9, (n,), generator=cuda, device="cuda").float()
    vec[torch.rand(n, generator=cuda, device="cuda") < 0.3] = 0.0  # zeros are skipped
    before = cs_ops.countsketch.launches
    for signs in (s, s.to(torch.int32)):
        got = cs_ops.countsketch(vec, h, signs, w)
        assert got.shape == (d, w) and got.dtype == torch.float32
        assert torch.equal(got, countsketch_ref(vec, h, signs, w))
    assert cs_ops.countsketch.launches == before + 2


def test_countsketch_kernel_float_values_close(cuda):
    """tests/test_kernels.py's tolerance at its shapes (about 20 terms a cell)."""
    for n, w, d in [(100, 64, 3), (5000, 256, 5), (3000, 300, 4)]:
        h = torch.randint(0, w, (d, n), generator=cuda, device="cuda", dtype=torch.int32)
        s = (torch.randint(0, 2, (d, n), generator=cuda, device="cuda") * 2 - 1).to(torch.int8)
        vec = torch.randn(n, generator=cuda, device="cuda")
        torch.testing.assert_close(cs_ops.countsketch(vec, h, s, w), countsketch_ref(vec, h, s, w), rtol=1e-6, atol=1e-4)


def test_countsketch_wrapper_refuses_bad_operands(cuda):
    vec = torch.zeros(10, device="cuda")
    h = torch.zeros(2, 10, dtype=torch.int32, device="cuda")
    s = torch.ones(2, 10, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):
        cs_ops.countsketch(vec.double(), h, s, 16)
    with pytest.raises(ValueError):
        cs_ops.countsketch(vec, h[:, :9], s, 16)
    with pytest.raises(ValueError):
        cs_ops.countsketch(vec, h, s.float(), 16)
    with pytest.raises(ValueError):
        cs_ops.countsketch(vec, h.cpu(), s, 16)
    with pytest.raises(ValueError):
        cs_ops.countsketch(vec, h, s, 0)


def _same_with_nan(a, b):
    """Equal values (``-0.0 == 0.0``) and NaN in the same positions."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(torch.where(nan, 0.0, a), torch.where(b.isnan(), 0.0, b))


def _family(d, w, seed, device="cuda"):
    """A drawn family; its first row's b = 2^31 - 2 (sign multiplier p)."""
    fam = make_hash_family(torch.Generator().manual_seed(seed), d, w)
    b = fam.b_host.copy()
    b[0] = 2**31 - 2
    return HashFamily.from_host(fam.a_host, b, w, device)


# 16,384, 5,000 and 300 fit a row in shared memory (16,384 and 2^17 take the
# power-of-two bucket, 5,000 and 300 Lemire's); 2^17 does not (global atomics).
@pytest.mark.parametrize("d,w,n", [(5, 16384, 1_000_003), (1, 5000, 77_777), (8, 300, 4_097), (2, 1 << 17, 300_000)])
def test_countsketch_family_kernel_bit_equals_plain_version_on_integers(cuda, d, w, n):
    fam = _family(d, w, n)
    vec = torch.randint(-8, 9, (n + 1,), generator=cuda, device="cuda").float()
    vec[torch.rand(n + 1, generator=cuda, device="cuda") < 0.3] = 0.0  # zeros are skipped
    before = cs_ops.countsketch.launches
    # An aligned vector and one a float past 16 bytes (scalar loads).
    for v in (vec[:n], vec[1:]):
        got = cs_ops.countsketch_family(v, fam)
        assert got.shape == (d, w) and got.dtype == torch.float32
        assert torch.equal(got, countsketch_ref(v, *cs_ops.hash_indices(fam, n), w))
    assert cs_ops.countsketch.launches == before + 2


@pytest.mark.parametrize("d", [1, 2, 4, 5, 8, 9])
@pytest.mark.parametrize("w", [16384, 300])
def test_countsketch_median_kernel_bit_equals_plain_version(cuda, d, w):
    """Integer cells with NaN, +inf and -inf planted; d = 9 takes the
    runtime-depth kernel."""
    n = 100_003
    fam = _family(d, w, d)
    table = torch.randint(-50, 51, (d, w), generator=cuda, device="cuda").float()
    flat = table.view(-1)
    cells = torch.randperm(d * w, generator=cuda, device="cuda")[:6]
    flat[cells[:2]], flat[cells[2:4]], flat[cells[4:]] = float("nan"), float("inf"), float("-inf")
    before = cs_ops.countsketch_median.launches
    got = cs_ops.countsketch_median(table, fam, n)
    want = countsketch_median_ref(table, fam, n)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert _same_with_nan(got, want) and bool(want.isnan().any())
    assert cs_ops.countsketch_median.launches == before + 1
    assert torch.equal(cs_ops.countsketch_median(table, fam, 5), want[:5])  # fewer than a block


def _expected_decode_variant(d, w):
    """``csrc/countsketch.cu::median_plan`` on this card: one CTA where its
    shared memory holds the table; a CTA pair where each of two CTAs holds
    L >= d/2 rows beside two exchange buffers of d - L floats for each of
    2,048 coordinates and 32 barriers of 8 bytes; else the staged kernel."""
    if d > 8:
        return "runtime depth"
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    if 4 * d * w <= optin:
        return "one CTA"
    for rows in range(d - 1, 0, -1):
        if 2 * rows >= d and 4 * ((rows * w + 3) // 4 * 4 + 2 * (d - rows) * 2048) + 256 <= optin:
            return "CTA pair"
    return "staged"


# Widths that straddle each variant's capacity on an H100 (232,448 bytes of
# shared memory a CTA): 14,528 fills one CTA at d = 4 and 14,529 takes a
# pair; 16,384 a pair at d = 2..6; 50,000 a pair of one row each at d = 2;
# 58,112 fills one CTA at d = 1; 2^17 fits neither (the staged kernel).
@pytest.mark.parametrize("w", [300, 14528, 14529, 16384, 50000, 58112, 1 << 17])
@pytest.mark.parametrize("d", range(1, 10))
def test_countsketch_median_variants_bit_equal_plain_version(cuda, d, w):
    """Every decode variant the shape picks, on integer cells with NaN, +inf
    and -inf planted, bit-equal to the plain version (NaN positions
    included), on a vector not a multiple of 4 and on one shorter than a
    block."""
    n = 100_003
    fam = _family(d, w, 7 * d + w)
    table = torch.randint(-50, 51, (d, w), generator=cuda, device="cuda").float()
    cells = torch.randperm(d * w, generator=cuda, device="cuda")[:6]
    flat = table.view(-1)
    flat[cells[:2]], flat[cells[2:4]], flat[cells[4:]] = float("nan"), float("inf"), float("-inf")
    assert cs_ops.median_variant(d, w) == _expected_decode_variant(d, w)
    want = countsketch_median_ref(table, fam, n)
    assert _same_with_nan(cs_ops.countsketch_median(table, fam, n), want)
    assert _same_with_nan(cs_ops.countsketch_median(table, fam, 5), want[:5])


def test_countsketch_family_and_median_refuse_bad_operands_on_the_card(cuda):
    fam = _family(2, 16, 0)
    vec = torch.zeros(10, device="cuda")
    table = torch.zeros(2, 16, device="cuda")
    for bad in (vec.double(), vec.view(2, 5), vec.cpu()):
        with pytest.raises(ValueError):
            cs_ops.countsketch_family(bad, fam)
    with pytest.raises(ValueError):
        cs_ops.countsketch_family(vec, fam.to("cpu"))  # the family on another device
    for bad in (table.double(), table[:, :15], table[:1], table.cpu()):
        with pytest.raises(ValueError):
            cs_ops.countsketch_median(bad, fam, 10)
    with pytest.raises(TypeError):
        cs_ops.countsketch_median(table, fam, 10.0)
    with pytest.raises(TypeError):
        cs_ops.countsketch(vec, torch.zeros(2, 10, dtype=torch.int32, device="cuda"),
                           torch.ones(2, 10, dtype=torch.int8, device="cuda"), 16.0)


def test_countsketch_kernel_is_deterministic_and_keeps_non_finite_cells(cuda):
    """The sketch sums in fixed point: a float vector sketches to the same
    bits on every launch and in both forms, within float32 rounding of the
    float64 sum; NaN and infinite terms give the cells float addition gives
    them (NaN beside anything or +inf beside -inf: NaN)."""
    d, w, n = 5, 16384, 1_000_003
    fam = make_hash_family(torch.Generator().manual_seed(5), d, w, "cuda")
    h, s = cs_ops.hash_indices(fam, n)
    vec = torch.randn(n, generator=cuda, device="cuda")
    first = cs_ops.countsketch_family(vec, fam)
    for again in (cs_ops.countsketch_family(vec, fam), cs_ops.countsketch(vec, h, s, w)):
        assert torch.equal(again, first)
    exact = countsketch_ref(vec.double(), h, s, w, dtype=torch.float64)
    torch.testing.assert_close(first.double(), exact, rtol=1e-6, atol=1e-4)
    # A wide dynamic range (one coordinate in 1,000 scaled by 1e9): every cell
    # keeps float32's rounding bound of its own terms, gamma_(m-1) * sum |x|.
    wide = vec.clone()
    wide[::1000] *= 1e9
    ones = torch.ones_like(h, dtype=torch.int8)
    mass = countsketch_ref(wide.abs().double(), h, ones, w, dtype=torch.float64)
    terms = countsketch_ref(torch.ones_like(wide, dtype=torch.float64), h, ones, w, dtype=torch.float64)
    ku = (terms - 1).clamp(min=0) * 2.0**-24
    err = (cs_ops.countsketch_family(wide, fam).double() - countsketch_ref(wide.double(), h, s, w, torch.float64)).abs()
    assert bool((err <= ku / (1 - ku) * mass).all())
    vec[[3, 1000, 5000]] = torch.tensor([float("nan"), float("inf"), -float("inf")], device="cuda")
    vec[[7, 8]] = float("inf")
    got, want = cs_ops.countsketch_family(vec, fam), countsketch_ref(vec, h, s, w)
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    assert int(got.isnan().sum()) >= d


def test_two_rank_compressed_step_on_the_card_equals_emulation(cuda, tmp_path):
    """The data-parallel compressed step on two gloo ranks on one card (the
    tiny transformer, 3 steps, each rank its own batch) equals its
    single-process emulation on the card bit for bit at every step: the
    loss, the parameters, the sketch momentum and each worker's error
    feedback; so the two replicas stay identical."""
    import _torch_dist
    from repro_torch.models import transformer as tfm
    from repro_torch.train import compression as comp
    from repro_torch.tree import tree_leaves, tree_map

    cfg, ccfg = train_lm.PRESETS["tiny"], dict(depth=5, width=4096, top_k=512, momentum=0.9)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    n = sum(x.numel() for x in tree_leaves(params))
    cstate = comp.init_compressor(comp.CompressorConfig(**ccfg), n, torch.Generator().manual_seed(1))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (3, 2, 4, 33)).astype(np.int32)
    path = tmp_path / "inputs.pt"
    _torch_dist.save_train_inputs(
        path, "tiny", tree_map(lambda t: t.numpy(), params), cstate.error.numpy(), cstate.momentum.numpy(),
        cstate.hash.a_host, cstate.hash.b_host, ccfg, dict(lr=1e-3, warmup_steps=2, total_steps=10),
        [{"tokens": tokens[i]} for i in range(3)],
    )
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ranks = _torch_dist.run_ranks(_torch_dist.compressed_steps, 2, tmp_path, timeout=240, inputs=str(path),
                                      device="cuda")
        want = _torch_dist.emulate_steps(path, device="cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for i, (loss, flat, errors, momentum) in enumerate(want):
        for rank, res in enumerate(ranks):
            got_loss, got_flat, got_error, got_momentum = res[i]
            assert got_loss == loss, (i, rank)
            np.testing.assert_array_equal(got_flat, flat)
            np.testing.assert_array_equal(got_momentum, momentum)
            np.testing.assert_array_equal(got_error, errors[rank])


def test_tiny_compressed_train_step_on_card_close_to_cpu(cuda):
    argv = ["--preset", "tiny", "--compress", "--steps", "2", "--batch", "4", "--seq", "32"]
    before = cs_ops.countsketch.launches, cs_ops.countsketch_median.launches
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = train_lm.main(argv)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # Two sketches and one decode a step.
    assert cs_ops.countsketch.launches - before[0] == 4
    assert cs_ops.countsketch_median.launches - before[1] == 2
    host = train_lm.main(argv + ["--device", "cpu"])
    # rtol 1e-4: float32 gradients summed in other orders (TF32 off).
    np.testing.assert_allclose([h["loss"] for h in card.result.history],
                               [h["loss"] for h in host.result.history], rtol=1e-4)
    p_card = card.result.state["params"]["layers"]["wq"].cpu()
    p_host = host.result.state["params"]["layers"]["wq"]
    torch.testing.assert_close(p_card, p_host, rtol=1e-4, atol=1e-4)


# -- the order-dependent updates (port-only kernel) and the analytics plane ---------


def _seq_batch(d, wr, wc, b, index_dtype, pattern, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    counters = torch.randint(0, 50, (d, wr, wc), generator=g, device="cuda").float()
    if pattern == "repeats":  # few cells, so edges revisit cells within the batch
        rows = torch.randint(0, 3, (d, b), generator=g, device="cuda")
        cols = torch.randint(0, 3, (d, b), generator=g, device="cuda")
    else:
        rows = torch.randint(0, wr, (d, b), generator=g, device="cuda")
        cols = torch.randint(0, wc, (d, b), generator=g, device="cuda")
    w = torch.randint(1, 9, (b,), generator=g, device="cuda").float()
    return counters, rows.to(index_dtype), cols.to(index_dtype), w


@pytest.mark.parametrize("pattern", ["uniform", "repeats"])
@pytest.mark.parametrize("conservative", [False, True], ids=["sequential", "conservative"])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("d", [1, 5, 8])
def test_sequential_kernel_bit_equals_plain_loop(cuda, d, index_dtype, conservative, pattern):
    counters, rows, cols, w = _seq_batch(d, 64, 48, 333, index_dtype, pattern, d)
    before = seq_ops.sequential_update.launches
    got = seq_ops.sequential_update(counters.clone(), rows, cols, w, conservative)
    assert seq_ops.sequential_update.launches == before + 1
    want = sequential_update_ref(counters.clone(), rows, cols, w, conservative)
    assert torch.equal(got, want)


@pytest.mark.parametrize("conservative", [False, True], ids=["sequential", "conservative"])
def test_sequential_kernel_float_weights_bit_equal(cuda, conservative):
    counters, rows, cols, _ = _seq_batch(5, 16, 16, 2000, torch.int64, "repeats", 7)
    w = torch.randn(2000, generator=cuda, device="cuda") * 3.7
    counters = counters + torch.rand(counters.shape, generator=cuda, device="cuda")
    got = seq_ops.sequential_update(counters.clone(), rows, cols, w, conservative)
    want = sequential_update_ref(counters.clone(), rows, cols, w, conservative)
    assert torch.equal(got, want)


def test_sequential_kernel_matches_ingest_in_the_counting_regime(cuda):
    counters, rows, cols, w = _seq_batch(5, 512, 512, 50_000, torch.int64, "uniform", 3)
    got = seq_ops.sequential_update(counters.clone(), rows, cols, w, False)
    assert torch.equal(got, ingest_scatter_ref(counters.clone(), rows, cols, w))


def test_sequential_kernel_refuses_bad_operands_on_the_card(cuda):
    idx = torch.zeros(33, 4, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="at most 32"):
        seq_ops.sequential_update(torch.zeros(33, 8, 8, device="cuda"), idx, idx, torch.ones(4, device="cuda"), True)
    idx = idx[:3]
    for rows, cols in ((idx.float(), idx.float()), (idx, idx.int())):
        with pytest.raises(ValueError):
            seq_ops.sequential_update(torch.zeros(3, 8, 8, device="cuda"), rows, cols, torch.ones(4, device="cuda"), True)
    # An edge with a bucket out of range is left out on the card.
    rows = torch.tensor([[0, 9, 1]], device="cuda")
    got = seq_ops.sequential_update(torch.zeros(1, 8, 8, device="cuda"), rows, rows.clone(), torch.ones(3, device="cuda"), False)
    assert float(got.sum()) == 2 and float(got[0, 0, 0]) == 1 and float(got[0, 1, 1]) == 1


def test_sequential_kernel_launches_on_the_current_stream(cuda):
    counters, rows, cols, w = _seq_batch(5, 256, 256, 20_000, torch.int32, "uniform", 4)
    side = torch.cuda.Stream()
    work = counters.clone()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        seq_ops.sequential_update(work, rows, cols, w, True)
        after = work.clone()
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(after, sequential_update_ref(counters.clone(), rows, cols, w, True))


def test_analytics_functions_on_card_equal_cpu(cuda):
    from repro_torch.core import queries
    from repro_torch.core.hashing import keys_to_tensor, mix_keys
    from repro_torch.core.ingest import preaggregate_edges
    from repro_torch.core.sketch import CountMin, CountSketch, GSketch, NodeCountMin

    argv = ["--nodes", "2000", "--edges", "20000", "--batch", "5000", "--width", "128", "--depth", "4"]
    gpu, _, _ = serve.main(argv)
    cpu, _, _ = serve.main(argv + ["--device", "cpu"])
    rng = np.random.default_rng(0)
    qs_np, qd_np = rng.integers(0, 2000, 300).astype(np.uint32), rng.integers(0, 2000, 300).astype(np.uint32)

    def run(gs, dev):
        live = gs._live()
        qs, qd = keys_to_tensor(qs_np, dev), keys_to_tensor(qd_np, dev)
        w = torch.arange(300, device=dev).float() % 7 + 1
        out = [queries.wildcard_edge_query(live, *a) for a in ((qs, qd), (qs, None), (None, qd), (None, None))]
        out += [queries.bound_wildcard_path2(live, qd, qs), queries.triangle_query(live, qs[0], qs[1], qs[2])]
        out += list(queries.heavy_hitter_buckets(live, 40.0))
        out += [reach.k_hop_reach(live.counters, k) for k in range(4)]
        alarm, new = queries.monitor_step(live, qs, qd, w, qd[0], 30.0)
        out += [alarm, new.counters, live.update_sequential(qs, qd, w).counters,
                live.update_conservative(qs, qd, w).counters]
        out += list(preaggregate_edges(qs, qd, w, 512))
        out += [CountMin.empty(3, 4096, 1, dev).update_(qs, qd, w).edge_query(qs, qd),
                NodeCountMin.empty(3, 4096, 1, dev).update_(qs, qd, w).in_flow(qd),
                CountSketch.empty(4, 4096, 1, dev).update_(mix_keys(qs, qd), w).query(mix_keys(qs, qd)),
                GSketch.from_sample(3, 4096, 4, qs_np, 1, dev).update_(qs, qd, w).edge_query(qs, qd)]
        close = [queries.global_triangle_estimate(live), queries.sketch_pagerank(live), torch.from_numpy(gs.pagerank())]
        return [t.cpu() for t in out], [t.cpu() for t in close]

    (exact_g, close_g), (exact_c, close_c) = run(gpu, "cuda"), run(cpu, "cpu")
    for i, (g, c) in enumerate(zip(exact_g, exact_c, strict=True)):
        assert g.dtype == c.dtype and torch.equal(g, c), i
    for g, c in zip(close_g, close_c, strict=True):
        torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-7)


# -- the durable, windowed serving plane ----------------------------------------


@pytest.mark.parametrize("slot", [0, 3])
def test_ingest_kernel_scatters_into_a_ring_slot(cuda, slot):
    """B1 on a ring slot's view (slots 0 and K-1 of K=4) against the plain
    scatter on the same view: bit-equal, and the other slots untouched."""
    from repro_torch.core.window import SlidingWindowSketch
    from repro_torch.core.sketch import SketchConfig

    win = SlidingWindowSketch.empty(SketchConfig(depth=3, width_rows=300, width_cols=200), 4, 0, "cuda")
    win.slices.copy_(torch.randint(0, 1000, win.slices.shape, generator=cuda, device="cuda").float())
    ref = win.slices.clone()
    rows = torch.randint(0, 300, (3, 5000), generator=cuda, device="cuda")
    cols = torch.randint(0, 200, (3, 5000), generator=cuda, device="cuda")
    w = torch.randint(0, 9, (5000,), generator=cuda, device="cuda").float()
    view = win.slice_at(slot).counters
    assert view.is_contiguous() and view.data_ptr() == win.slices[slot].data_ptr()
    before = ingest_ops.ingest_scatter.launches
    ingest_ops.ingest_scatter(view, rows, cols, w)
    assert ingest_ops.ingest_scatter.launches == before + 1
    ingest_scatter_ref(ref[slot], rows, cols, w)
    assert torch.equal(win.slices, ref)


def test_update_at_every_slot_on_card_equals_cpu(cuda):
    """``update_at_`` into each slot of a ring on the card (one B1 launch a
    call) and on the CPU; then the window sum and an advance."""
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.core.window import SlidingWindowSketch

    cfg = SketchConfig(depth=3, width_rows=256, width_cols=128)
    wins = {dev: SlidingWindowSketch.empty(cfg, 5, 3, dev) for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(0)
    before = ingest_ops.ingest_scatter.launches
    for slot in range(5):
        s, d = rng.integers(0, 10_000, 3000).astype(np.uint32), rng.integers(0, 10_000, 3000).astype(np.uint32)
        w = rng.integers(1, 9, 3000).astype(np.float32)
        for dev, win in wins.items():
            win.update_at_(slot, keys_to_tensor(s, dev), keys_to_tensor(d, dev), torch.from_numpy(w).to(dev))
    assert ingest_ops.ingest_scatter.launches == before + 5
    for dev in wins:
        wins[dev].advance_().advance_()
    for name in ("slices", "row_flows", "col_flows"):
        assert torch.equal(getattr(wins["cuda"], name).cpu(), getattr(wins["cpu"], name))
    got, want = wins["cuda"].window_sketch(), wins["cpu"].window_sketch()
    assert torch.equal(got.counters.cpu(), want.counters) and wins["cuda"].current == 2


def test_durable_windowed_session_on_card_equals_cpu(cuda, tmp_path):
    """The small windowed event-time durable session on the card and on the
    CPU: the same ring, tracker and transcript; a checkpoint written from the
    card restores on the CPU; the card's WAL replays on the CPU."""
    from repro_torch.api import GraphStream
    from repro_torch.core.sketch import SketchConfig

    argv = ["--depth", "3", "--width", "256", "--nodes", "2000", "--edges", "20000", "--batch", "5000",
            "--window-slices", "4", "--slice-width", "1.0", "--max-lateness", "1.0"]
    cfg = SketchConfig(depth=3, width_rows=256, width_cols=256)
    runs = {}
    for dev in ("cuda", "cpu"):
        args = serve.build_parser().parse_args(argv + ["--device", dev])
        gs = GraphStream.open(cfg, device=dev, window_slices=4, slice_width=1.0, max_lateness=1.0,
                              wal_dir=str(tmp_path / f"wal-{dev}"), checkpoint_dir=str(tmp_path / f"ckpt-{dev}"))
        runs[dev] = serve.drive(gs, args)
    (gpu, _, gpu_events), (cpu, _, cpu_events) = runs["cuda"], runs["cpu"]
    for name in ("slices", "row_flows", "col_flows"):
        assert torch.equal(getattr(gpu._window, name).cpu(), getattr(cpu._window, name))
    assert gpu._tracker.state() == cpu._tracker.state() and gpu.stats.auto_advances == cpu.stats.auto_advances > 0
    assert [(e.tick, e.epoch) for e in gpu_events] == [(e.tick, e.epoch) for e in cpu_events]
    for a, b in zip(gpu_events, cpu_events):
        for ra, rb in zip(a.results, b.results):
            va = ra.value if isinstance(ra.value, tuple) else (ra.value,)
            vb = rb.value if isinstance(rb.value, tuple) else (rb.value,)
            assert all(np.array_equal(x, y) for x, y in zip(va, vb))
    step = gpu.checkpoint()
    back = GraphStream.open(cfg, seed=5, device="cpu", window_slices=4, slice_width=1.0, max_lateness=1.0,
                            checkpoint_dir=str(tmp_path / "ckpt-cuda"))
    assert back.restore() == step and back.epoch == gpu.epoch and back.watermark == gpu.watermark
    for name in ("slices", "row_flows", "col_flows"):
        assert torch.equal(getattr(back._window, name), getattr(cpu._window, name))
    replay = GraphStream.open(cfg, device="cpu", window_slices=4, slice_width=1.0, max_lateness=1.0,
                              wal_dir=str(tmp_path / "wal-cuda"))
    replay.recover()
    assert torch.equal(replay._window.slices, cpu._window.slices)


# -- the stacked ingest (the fleet's one launch a batch) ----------------------------


def _stacked_batch(gen, n, d, wr, wc, b, index_dtype, plane_dtype):
    """Stacked state holding integers and a batch over its planes: a tenth of
    the rows -1, negative and zero weights among the integer ones."""
    state = (
        torch.randint(0, 1000, (n, d, wr, wc), generator=gen, device="cuda").float(),
        torch.randint(0, 1000, (n, d, wr), generator=gen, device="cuda").float(),
        torch.randint(0, 1000, (n, d, wc), generator=gen, device="cuda").float(),
    )
    plane = torch.randint(0, n, (b,), generator=gen, device="cuda").to(plane_dtype)
    rows = torch.randint(0, wr, (d, b), generator=gen, device="cuda").to(index_dtype)
    rows[torch.rand((d, b), generator=gen, device="cuda") < 0.1] = -1
    cols = torch.randint(0, wc, (d, b), generator=gen, device="cuda").to(index_dtype)
    w = torch.randint(-4, 9, (b,), generator=gen, device="cuda").float()
    return state, plane, rows, cols, w


@pytest.mark.parametrize("plane_dtype", [torch.int32, torch.int64], ids=["plane32", "plane64"])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("n,d,wr,wc,b", [(1, 1, 64, 64, 33), (6, 3, 300, 200, 5000), (16, 5, 256, 512, 50_000)])
def test_stacked_ingest_kernel_bit_equals_plain_version(cuda, n, d, wr, wc, b, index_dtype, plane_dtype):
    state, plane, rows, cols, w = _stacked_batch(cuda, n, d, wr, wc, b, index_dtype, plane_dtype)
    before = stacked_ops.stacked_ingest.launches
    got = stacked_ops.stacked_ingest(*(t.clone() for t in state), plane, rows, cols, w)
    assert stacked_ops.stacked_ingest.launches == before + 1
    want = stacked_ingest_ref(*(t.clone() for t in state), plane, rows, cols, w)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_stacked_ingest_kernel_past_2_31_cells(cuda):
    """A stack of 2^31 + 2^27 cells (64-bit offsets), planes at both ends and
    the cells at the very end of the last plane."""
    n, d, w = 17, 2, 8192  # 17 * 2 * 8192^2 cells, 9.1 GB
    counters = torch.zeros((n, d, w, w), device="cuda")
    rf, cf = torch.zeros((n, d, w), device="cuda"), torch.zeros((n, d, w), device="cuda")
    assert counters.numel() > 2**31
    b = 4096
    plane = torch.where(torch.arange(b, device="cuda") % 2 == 0, 0, n - 1)
    rows = torch.randint(0, w, (d, b), generator=cuda, device="cuda")
    cols = torch.randint(0, w, (d, b), generator=cuda, device="cuda")
    rows[:, :8], cols[:, :8] = w - 1, w - 1  # the last cell of planes 0 and n - 1
    wts = torch.randint(1, 9, (b,), generator=cuda, device="cuda").float()
    stacked_ops.stacked_ingest(counters, rf, cf, plane, rows, cols, wts)
    for p in (0, n - 1):
        m = plane == p
        want = ingest_scatter_ref(torch.zeros((d, w, w), device="cuda"), rows[:, m], cols[:, m], wts[m])
        assert torch.equal(counters[p], want)
        assert torch.equal(rf[p], want.sum(dim=2)) and torch.equal(cf[p], want.sum(dim=1))
    assert float(counters[n - 1, :, w - 1, w - 1].sum()) > 0
    assert float(counters[1 : n - 1].abs().sum()) == 0.0


def _duplicate_heavy(pattern, n, d, wr, wc, b, index_dtype, plane_dtype):
    """A batch whose slots repeat addresses within a warp: every slot in one
    row of one plane (``one_row``), in one cell (``one_cell``), on one cell of
    two planes alternating lane by lane (``alternating``), zipf(1.2) sources
    and destinations grouped by plane as a fleet hands them over (``zipf``),
    or on one cell with weights that cancel in pairs (``cancelling``); a
    tenth of the slots inert (row -1 or plane out of range)."""
    rng = np.random.default_rng(b + len(pattern))
    plane = np.zeros(b, np.int64)
    rows = np.full((d, b), 7, np.int64)
    cols = np.full((d, b), 11, np.int64)
    w = rng.integers(1, 9, b).astype(np.float32)
    if pattern == "one_row":
        cols = rng.integers(0, wc, (d, b))
    elif pattern == "alternating":
        plane = np.arange(b) % 2
    elif pattern == "zipf":
        plane = np.sort(rng.integers(0, n, b))
        src, dst = rng.zipf(1.2, b) % 1000, rng.zipf(1.2, b) % 1000
        mult = rng.integers(1, 1 << 20, (d, 1))
        rows, cols = (src[None, :] * mult) % wr, (dst[None, :] * mult) % wc
    elif pattern == "cancelling":
        w = np.where(np.arange(b) % 2 == 0, w, -np.roll(w, 1))  # slot 2k + 1 takes -w[2k]
    # Inert in pairs (2k, 2k + 1), so the cancelling pairs stay whole.
    inert, first_half = np.repeat(rng.random(b // 2) < 0.1, 2), np.arange(b) < b // 2
    rows[:, inert & first_half] = -1
    plane[inert & ~first_half] = n
    return (torch.from_numpy(plane).to("cuda", plane_dtype), torch.from_numpy(rows).to("cuda", index_dtype),
            torch.from_numpy(cols).to("cuda", index_dtype), torch.from_numpy(w).cuda())


@pytest.mark.parametrize("plane_dtype", [torch.int32, torch.int64], ids=["plane32", "plane64"])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("pattern", ["one_row", "one_cell", "alternating", "zipf", "cancelling"])
def test_stacked_ingest_kernel_bit_equal_on_duplicate_heavy_batches(cuda, pattern, index_dtype, plane_dtype):
    """The warp aggregation (one RED a group of equal addresses, none for a
    sum of 0) keeps every plane and all three outputs bit-equal to the plain
    version, on a stack holding integers."""
    n, d, wr, wc, b = 6, 5, 256, 512, 20_000
    state = _stacked_batch(cuda, n, d, wr, wc, 1, index_dtype, plane_dtype)[0]
    batch = _duplicate_heavy(pattern, n, d, wr, wc, b, index_dtype, plane_dtype)
    got = stacked_ops.stacked_ingest(*(t.clone() for t in state), *batch)
    want = stacked_ingest_ref(*(t.clone() for t in state), *batch)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    if pattern == "cancelling":  # every group sums to 0: nothing changed
        assert all(torch.equal(g, s) for g, s in zip(got, state))


@pytest.mark.parametrize("pattern", ["one_cell", "zipf"])
def test_stacked_ingest_kernel_aggregates_past_2_31_cells(cuda, pattern):
    """Duplicate-heavy batches into the last planes of a stack past 2^31
    cells (64-bit offsets and 64-bit match keys), against the plain version
    on the planes they touch."""
    n, d, w = 17, 2, 8192  # 17 * 2 * 8192^2 cells, 9.1 GB
    state = (torch.zeros((n, d, w, w), device="cuda"), torch.zeros((n, d, w), device="cuda"),
             torch.zeros((n, d, w), device="cuda"))
    plane, rows, cols, wts = _duplicate_heavy(pattern, 2, d, w, w, 8192, torch.int64, torch.int32)
    plane = torch.where((plane >= 0) & (plane < 2), plane + n - 2, plane + n)  # planes n - 2 and n - 1
    got = stacked_ops.stacked_ingest(*state, plane, rows, cols, wts)
    for p in (n - 2, n - 1):
        m = plane == p
        want = ingest_scatter_ref(torch.zeros((d, w, w), device="cuda"), rows[:, m], cols[:, m], wts[m])
        assert torch.equal(got[0][p], want)
        assert torch.equal(got[1][p], want.sum(dim=2)) and torch.equal(got[2][p], want.sum(dim=1))
    assert float(got[0][: n - 2].abs().sum()) == 0.0


def test_stacked_ingest_kernel_with_64_bit_match_keys(cuda):
    """A stack of 2^19 + 1 planes of 4,096 x 1 cells, whose register keys
    (plane * wr + row) pass 32 bits, so the warp matches take 64-bit keys:
    four rows of the last four planes, each warp's slots on one plane,
    against the plain version plane by plane."""
    n, d, wr, wc = (1 << 19) + 1, 1, 4096, 1  # 2^31 + 4,096 cells and row registers, 17.2 GB
    state = (torch.zeros((n, d, wr, wc), device="cuda"), torch.zeros((n, d, wr), device="cuda"),
             torch.zeros((n, d, wc), device="cuda"))
    assert n * wr >= 2**31
    b = 4096
    plane = (n - 1 - torch.arange(b, device="cuda") // 1024).to(torch.int32)  # the last 4 planes
    rows = torch.randint(wr - 4, wr, (d, b), generator=cuda, device="cuda")
    cols = torch.zeros((d, b), dtype=torch.int64, device="cuda")
    wts = torch.randint(-3, 9, (b,), generator=cuda, device="cuda").float()
    got = stacked_ops.stacked_ingest(*state, plane, rows, cols, wts)
    for p in range(n - 4, n):
        m = plane == p
        want = ingest_scatter_ref(torch.zeros((d, wr, wc), device="cuda"), rows[:, m], cols[:, m], wts[m])
        assert torch.equal(got[0][p], want)
        assert torch.equal(got[1][p], want.sum(dim=2)) and torch.equal(got[2][p], want.sum(dim=1))
    assert not bool((got[1][: n - 4] != 0).any())


def test_stacked_ingest_refuses_bad_operands_on_the_card(cuda):
    state, plane, rows, cols, w = _stacked_batch(cuda, 2, 2, 16, 16, 8, torch.int32, torch.int32)
    for bad_rows in (rows.float(), rows.short(), rows.to(torch.uint8)):
        with pytest.raises(ValueError, match="int32 or both int64"):
            stacked_ops.stacked_ingest(*state, plane, bad_rows, bad_rows, w)
    for bad_plane in (plane.float(), plane.double(), plane.short()):
        with pytest.raises(ValueError, match="plane"):
            stacked_ops.stacked_ingest(*state, bad_plane, rows, cols, w)
    with pytest.raises(ValueError, match="on cuda"):
        stacked_ops.stacked_ingest(*state, plane, rows.cpu(), cols, w)
    with pytest.raises(ValueError, match="plane must be on"):
        stacked_ops.stacked_ingest(*state, plane.cpu(), rows, cols, w)
    with pytest.raises(ValueError, match="row_flows"):
        stacked_ops.stacked_ingest(state[0], state[1].cpu(), state[2], plane, rows, cols, w)
    with pytest.raises(ValueError, match="weights"):
        stacked_ops.stacked_ingest(*state, plane, rows, cols, w.double())


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_fleet_update_launches_once_a_direction_and_equals_cpu(cuda, directed):
    """``FleetSketch.update_`` on the card: one stacked launch a directed
    batch, two an undirected one, and the same stack as on the CPU."""
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.fleet import FleetSketch

    cfg = SketchConfig(depth=3, width_rows=256, width_cols=256, directed=directed)
    stacks = {dev: FleetSketch.empty(cfg, 6, 0, 3, dev) for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(1)
    for _ in range(3):
        slots = rng.integers(0, 6, 4000).astype(np.int32)
        s, d = rng.integers(0, 10_000, 4000).astype(np.uint32), rng.integers(0, 10_000, 4000).astype(np.uint32)
        w = rng.integers(-2, 9, 4000).astype(np.float32)
        before = stacked_ops.stacked_ingest.launches
        for dev, st in stacks.items():
            st.update_(torch.from_numpy(slots).to(dev), keys_to_tensor(s, dev), keys_to_tensor(d, dev),
                       torch.from_numpy(w).to(dev))
        assert stacked_ops.stacked_ingest.launches == before + (1 if directed else 2)
        for dev in stacks:
            stacks[dev].advance_(int(slots[0]))
    for name in ("counters", "row_flows", "col_flows", "cursor"):
        assert torch.equal(getattr(stacks["cuda"], name).cpu(), getattr(stacks["cpu"], name))


def test_small_fleet_serve_on_card_equals_cpu(cuda):
    """``launch/serve.py --tenants 8`` on the card (kernels) and on the CPU:
    the same stack, subscription transcripts and summary counts."""
    argv = ["--depth", "3", "--width", "256", "--nodes", "2000", "--edges", "20000", "--batch", "2000",
            "--tenants", "8", "--every", "2"]
    before = stacked_ops.stacked_ingest.launches
    gpu, gpu_subs = serve.main(argv)
    assert stacked_ops.stacked_ingest.launches == before + 10
    cpu, cpu_subs = serve.main(argv + ["--device", "cpu"])
    for name in ("counters", "row_flows", "col_flows", "cursor"):
        assert torch.equal(getattr(gpu._state, name).cpu(), getattr(cpu._state, name))
    for a, b in zip(gpu_subs, cpu_subs, strict=True):
        ea, eb = a.poll(), b.poll()
        assert [(e.tick, e.epoch) for e in ea] == [(e.tick, e.epoch) for e in eb] and ea
        for x, y in zip(ea, eb):
            for ra, rb in zip(x.results, y.results, strict=True):
                assert np.array_equal(ra.value, rb.value)


@pytest.mark.parametrize("backend,mesh_shape", [("gloo", (2, 2)), ("nccl", (1, 1))])
def test_distributed_plane_on_the_card(cuda, tmp_path, backend, mesh_shape):
    """The distributed plane on CUDA tensors: four gloo ranks on one card,
    and one NCCL rank; counters, registers and answers equal the local
    sketch's, and each rank launched B1, B5 and B6."""
    import _torch_dist

    world = mesh_shape[0] * mesh_shape[1]
    for res in _torch_dist.run_ranks(_torch_dist.card_plane, world, tmp_path, timeout=240, backend=backend,
                                     mesh_shape=mesh_shape):
        assert all(res["same"].values()), res["same"]
        assert res["launches"] == [1, 1, 2], res["launches"]


@pytest.mark.parametrize("backend,mesh_shape", [("nccl", (1, 1)), ("gloo", (2, 2))])
def test_durable_mesh_recovery_on_the_card_equals_cpu(cuda, tmp_path, backend, mesh_shape):
    """A durable mesh session on the card (one NCCL rank; four gloo ranks)
    crashes after batch 4 of 8 and recovers: the transcript, report, seqs,
    summary and WAL bytes equal a local CPU session's same run, and B1
    launched once a batch a rank, the replayed batch included."""
    import _torch_dist

    world = mesh_shape[0] * mesh_shape[1]
    for res in _torch_dist.run_ranks(_torch_dist.card_durable, world, tmp_path, timeout=300, backend=backend,
                                     mesh_shape=mesh_shape, crash_at=4):
        assert all(res["same"].values()), res["same"]
        assert res["replayed"] == 1 and res["launches"] == 8 + res["replayed"], res


def test_gnn_step_on_the_card_close_to_cpu(cuda):
    """One GraphSAGE step of the example's loop (a sampled subgraph, the
    loss, ``torch.autograd`` gradients, AdamW) on the card against the CPU:
    the loss and the parameters after the step within float32 rounding of
    the card's sums (rtol 1e-4, atol 1e-6)."""
    from repro_torch.data.graphs import citation_graph
    from repro_torch.launch import gnn_sketch_sampling as gnn
    from repro_torch.models.gnn import graphsage
    from repro_torch.models.gnn.sampler import CSRGraph, sample_subgraph
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.tree import tree_leaves

    rng = np.random.default_rng(0)
    g = citation_graph(gnn.N, gnn.E, gnn.F, gnn.C, rng)
    csr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], gnn.N)
    seeds = rng.choice(gnn.N, gnn.BATCH, replace=False).astype(np.int32)
    sub = sample_subgraph(csr, seeds, gnn.FANOUTS, rng)
    cfg = graphsage.SAGEConfig(name="sage-stream", n_layers=2, d_in=gnn.F, d_hidden=32, out_dim=gnn.C)
    ocfg = opt_mod.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=120, weight_decay=0.0)
    out = {}
    for device in ("cpu", "cuda"):
        params = graphsage.init_params(cfg, torch.Generator().manual_seed(0), device)
        feats = torch.from_numpy(g["node_feat"]).to(device)
        labels = torch.from_numpy(g["labels"][seeds]).to(device)
        new, _, loss, _ = gnn.train_step(cfg, ocfg, params, opt_mod.init_adamw(ocfg, params),
                                         gnn.device_batch(sub, feats), labels)
        out[device] = (float(loss), [x.cpu() for x in tree_leaves(new)])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    for a, b in zip(out["cuda"][1], out["cpu"][1], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# The key entry of B1 (``ingest_keys``): keys at the edges of the hash's
# arithmetic, p = 2^31 - 1.
MERSENNE = (1 << 31) - 1
EDGE_KEYS = [0, 1, MERSENNE - 1, MERSENNE, MERSENNE + 1, 2 * MERSENNE, 2 * MERSENNE + 1, 2**32 - 2, 2**32 - 1]


def _key_family(seed, d, w):
    rng = np.random.default_rng(seed)
    return HashFamily.from_host(rng.integers(1, MERSENNE, d), rng.integers(0, MERSENNE, d), w, "cuda")


def _key_batch(seed, b, pad=0, float_w=False):
    """(B,) int64 keys over the whole uint32 range with the edge keys planted,
    integer weights of both signs (or Gaussian ones), ``pad`` trailing
    slots of key 0 and weight 0, on the card."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.int64)
    dst = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.int64)
    n = min(b, len(EDGE_KEYS))
    src[:n], dst[:n] = EDGE_KEYS[:n], EDGE_KEYS[::-1][:n]
    w = rng.normal(0, 1, b) if float_w else rng.integers(-4, 9, b)
    w = w.astype(np.float32)
    if pad:
        src[-pad:], dst[-pad:], w[-pad:] = 0, 0, 0.0
    return (torch.from_numpy(x).cuda() for x in (src, dst, w))


@pytest.mark.parametrize("mirror", [False, True], ids=["directed", "mirrored"])
@pytest.mark.parametrize("d,wr,wc,distinct,b", [
    (1, 64, 64, False, 33), (5, 8192, 8192, False, 32768), (3, 1000, 700, True, 5000), (9, 256, 300, True, 4096),
    (10, 512, 512, False, 20000),
])
def test_ingest_keys_kernel_bit_equals_plain_version(cuda, d, wr, wc, distinct, b, mirror):
    """The key entry against its plain version (the families' hash, then the
    plain scatter): edge keys, padding, negative weights, power-of-two and
    other widths, distinct families, depths past the 8 inline rows."""
    row = _key_family(d, d, wr)
    col = _key_family(d + 100, d, wc) if distinct else row
    src, dst, w = _key_batch(b, b, pad=b // 7)
    base = torch.randint(0, 1000, (d, wr, wc), generator=cuda, device="cuda").float()
    before = ingest_ops.ingest_keys.launches
    got = ingest_ops.ingest_keys(base.clone(), src, dst, w, row, col, mirror=mirror)
    assert ingest_ops.ingest_keys.launches == before + 1
    want = ingest_keys_ref(base.clone(), src, dst, w, row, col, mirror=mirror)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mirror", [False, True], ids=["directed", "mirrored"])
@pytest.mark.parametrize("offset", [0, 256, 700, 1024])
def test_ingest_keys_kernel_with_row_offset(cuda, offset, mirror):
    """A shard of 256 rows of a 1,024-row family at ``row_offset``: rows
    outside it add nothing."""
    row, col = _key_family(1, 3, 1024), _key_family(2, 3, 300)
    src, dst, w = _key_batch(3, 6000, pad=100)
    base = torch.randint(0, 1000, (3, 256, 300), generator=cuda, device="cuda").float()
    got = ingest_ops.ingest_keys(base.clone(), src, dst, w, row, col, row_offset=offset, mirror=mirror)
    want = ingest_keys_ref(base.clone(), src, dst, w, row, col, row_offset=offset, mirror=mirror)
    assert torch.equal(got, want)
    assert offset < 1024 or torch.equal(got, base)


def test_ingest_keys_kernel_into_a_ring_slot_view(cuda):
    """A ring slot's view (``slices[slot]``) is a valid target; the other
    slots stay as they were."""
    ring = torch.randint(0, 1000, (4, 5, 512, 512), generator=cuda, device="cuda").float()
    fam = _key_family(4, 5, 512)
    src, dst, w = _key_batch(4, 8192, pad=50)
    want = ingest_keys_ref(ring[2].clone(), src, dst, w, fam, fam, mirror=True)
    before = ring.clone()
    ingest_ops.ingest_keys(ring[2], src, dst, w, fam, fam, mirror=True)
    assert torch.equal(ring[2], want)
    for slot in (0, 1, 3):
        assert torch.equal(ring[slot], before[slot])


def test_ingest_keys_kernel_on_empty_and_all_zero_batches(cuda):
    fam = _key_family(5, 3, 256)
    base = torch.randint(0, 1000, (3, 256, 256), generator=cuda, device="cuda").float()
    src, dst, w = _key_batch(5, 3000)
    for s, t, wt in ((src[:0], dst[:0], w[:0]), (src, dst, torch.zeros_like(w))):
        for mirror in (False, True):
            got = ingest_ops.ingest_keys(base.clone(), s, t, wt, fam, fam, mirror=mirror)
            torch.cuda.synchronize()
            assert torch.equal(got, base)


def test_ingest_keys_kernel_float_weights_close(cuda):
    """Float weights: atomics add in any order (``rtol=1e-6, atol=1e-5``)."""
    row, col = _key_family(6, 2, 128), _key_family(7, 2, 96)
    src, dst, w = _key_batch(6, 7000, float_w=True)
    src, dst = src % 300, dst % 300  # repeated cells
    got = ingest_ops.ingest_keys(torch.zeros(2, 128, 96, device="cuda"), src, dst, w, row, col, mirror=True)
    want = ingest_keys_ref(torch.zeros(2, 128, 96, device="cuda"), src, dst, w, row, col, mirror=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_ingest_keys_kernel_launches_on_the_current_stream(cuda):
    """Its weights are written behind a sleep on a side stream, so a launch
    on another stream would read them before."""
    fam = _key_family(8, 3, 256)
    src, dst, w = _key_batch(8, 5000)
    base = torch.randint(0, 1000, (3, 256, 256), generator=cuda, device="cuda").float()
    got = base.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000)
        w += 1
        ingest_ops.ingest_keys(got, src, dst, w, fam, fam, mirror=True)
    side.synchronize()
    assert torch.equal(got, ingest_keys_ref(base.clone(), src, dst, w, fam, fam, mirror=True))


def test_ingest_keys_wrapper_refuses_bad_operands_on_the_card(cuda):
    fam = _key_family(9, 2, 64)
    counters = torch.zeros(2, 64, 64, device="cuda")
    src, dst, w = _key_batch(9, 100)
    bad = [
        (src.int(), dst, w, fam), (src, dst.float(), w, fam), (src, dst, w.double(), fam), (src, dst, w.half(), fam),
        (src.cpu(), dst, w, fam), (src, dst, w, fam.to("cpu")),
    ]
    for s, t, wt, f in bad:
        with pytest.raises(ValueError):
            ingest_ops.ingest_keys(counters, s, t, wt, f, f)
    assert not counters.any()


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("d", [1, 5, 8, 9, 17])
def test_ingest_bucket_entry_bit_equal_by_depth_and_index_dtype(cuda, d, index_dtype):
    """The bucket entry's body (one thread a slot, its d sketches' buckets
    loaded a chunk of 8 at a time): -1 rows, weight-0 slots, negative
    weights."""
    b, wr, wc = 9000, 300, 200
    base = torch.randint(0, 1000, (d, wr, wc), generator=cuda, device="cuda").float()
    rows = torch.randint(0, wr, (d, b), generator=cuda, device="cuda", dtype=index_dtype)
    rows[torch.rand((d, b), generator=cuda, device="cuda") < 0.1] = -1
    cols = torch.randint(0, wc, (d, b), generator=cuda, device="cuda", dtype=index_dtype)
    w = torch.randint(-3, 9, (b,), generator=cuda, device="cuda").float()
    w[torch.rand(b, generator=cuda, device="cuda") < 0.2] = 0.0
    got = ingest_ops.ingest_scatter(base.clone(), rows, cols, w)
    assert torch.equal(got, ingest_scatter_ref(base.clone(), rows, cols, w))


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_update_preaggregated_on_card_one_key_launch_equals_cpu(cuda, directed):
    """``GLavaSketch.update_preaggregated_`` on the card: one key-entry launch
    a batch (mirrored pairs included), no bucket-entry launch, and the CPU's
    counters and registers."""
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.ingest import pad_bucket, preaggregate_host
    from repro_torch.core.sketch import GLavaSketch, SketchConfig

    cfg = SketchConfig(depth=4, width_rows=512, width_cols=256, directed=directed)
    rng = np.random.default_rng(10)
    src = rng.zipf(1.3, 20000).astype(np.uint32) % 3000
    dst = rng.zipf(1.3, 20000).astype(np.uint32) % 3000
    pre = preaggregate_host(src, dst, rng.integers(-2, 7, 20000).astype(np.float32))
    fields = ("src", "dst", "weights", "src_unique", "src_totals", "dst_unique", "dst_totals")
    host = [pad_bucket(getattr(pre, f)) for f in fields]
    cpu = GLavaSketch.empty(cfg, 3)
    gpu = cpu.to("cuda")
    keys, scatters = ingest_ops.ingest_keys.launches, ingest_ops.ingest_scatter.launches
    gpu.update_preaggregated_(*(keys_to_tensor(x, "cuda") if x.dtype == np.uint32 else torch.from_numpy(x).cuda()
                                for x in host))
    assert ingest_ops.ingest_keys.launches == keys + 1 and ingest_ops.ingest_scatter.launches == scatters
    cpu.update_preaggregated_(*(keys_to_tensor(x) if x.dtype == np.uint32 else torch.from_numpy(x) for x in host))
    for name in ("counters", "row_flows", "col_flows"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name))


def _collapse_batch(rng, n, nodes, extreme=False):
    """A zipf batch of uint32 keys and integer weights, packed (3, B) int32
    as a session copies it; ``extreme`` plants the keys 0 and 2^32 - 1."""
    src = ((rng.zipf(1.2, n) - 1) % nodes).astype(np.uint32)
    dst = ((rng.zipf(1.2, n) - 1) % nodes).astype(np.uint32)
    if extreme:
        src[::5], dst[::7], dst[1::11] = 0xFFFFFFFF, 0, 0xFFFFFFFF
    w = rng.integers(1, 9, n).astype(np.float32)
    return torch.from_numpy(np.stack([src, dst, w.view(np.uint32)]).view(np.int32))


def _pairs(src, dst, w):
    """The weighted pairs of collapsed pair arrays, sorted."""
    keep = w != 0
    key = (src[keep] << 32) | dst[keep]
    order = torch.argsort(key)
    return key[order], w[keep][order]


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_preagg_collapse_kernel_equals_plain_version_over_successive_batches(cuda, directed):
    """The card's batch collapse against its plain version over three
    successive batches of one session's tables (the last one larger, so the
    tables grow): the same pairs, registers and bitmap, the pairs compacted
    first, and the tables left empty after every batch (the next batch
    needs no fill)."""
    from repro_torch.core.sketch import GLavaSketch, SketchConfig

    cfg = SketchConfig(depth=5, width_rows=8192, width_cols=8192, directed=directed)
    card = GLavaSketch.empty(cfg, 7, "cuda")
    plain = card.clone()
    tables = preagg_ops.CollapseTables()
    rng = np.random.default_rng(5)
    before = preagg_ops.preagg_collapse.launches
    for n, extreme in ((50_000, False), (20_000, True), (70_000, True)):
        batch = _collapse_batch(rng, n, 100_000, extreme).cuda()
        touched = torch.empty((5, 8192), dtype=torch.bool, device="cuda")
        want_touched = torch.empty_like(touched)
        got = preagg_ops.preagg_collapse(batch, card.row_flows, card.col_flows, touched, card.row_hash,
                                         card.col_hash, not directed, tables)
        want = preagg_collapse_ref(batch, plain.row_flows, plain.col_flows, want_touched, plain.row_hash,
                                   plain.col_hash, not directed, got[0].shape[0])
        torch.cuda.synchronize()
        n_pairs = int((want[2] != 0).sum())
        assert int((got[2][:n_pairs] != 0).sum()) == n_pairs and not bool(got[2][n_pairs:].any())
        for g, e in zip(_pairs(*got), _pairs(*want), strict=True):
            assert torch.equal(g, e)
        assert torch.equal(card.row_flows, plain.row_flows) and torch.equal(card.col_flows, plain.col_flows)
        assert torch.equal(touched, want_touched)
        assert bool((tables.pair_keys == -1).all()) and bool((tables.node_keys == -1).all())
        assert not bool(tables.sums.any()) and not bool(tables.marker_sums.any()) and not bool(tables.counts[:3].any())
    assert preagg_ops.preagg_collapse.launches == before + 3


def _standing_sessions(directed, devices, **kw):
    from repro_torch.api import GraphStream, Query
    from repro_torch.core.sketch import SketchConfig

    cfg = SketchConfig(depth=4, width_rows=2048, width_cols=2048, directed=directed)
    rng = np.random.default_rng(11)
    qs = ((rng.zipf(1.2, 256) - 1) % 400).astype(np.uint32)
    qd = ((rng.zipf(1.2, 256) - 1) % 400).astype(np.uint32)
    out = []
    for device in devices:
        gs = GraphStream.open(cfg, seed=2, device=device, **kw)
        gs.subscribe(Query.edge(qs, qd), Query.in_flow(qs), Query.heavy(qs, theta=0.01), Query.reach(qs[:64], qd[:64]),
                     every=1)
        out.append(gs)
    return out


@pytest.mark.parametrize("nodes", [400, 100_000], ids=["incremental", "full"])
@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_card_session_collapsing_on_the_card_equals_cpu_session(cuda, directed, nodes):
    """A session on the card (its batches collapsed there, touched rows as a
    bitmap) against the same session on the CPU (the host collapse, touched
    keys) over 20 zipf batches under standing edge, in-flow, heavy and reach
    queries: equal answers, equal summaries and equal closures."""
    gpu, cpu = _standing_sessions(directed, ("cuda", "cpu"))
    rng = np.random.default_rng(12)
    for _ in range(20):
        src = ((rng.zipf(1.2, 5_000) - 1) % nodes).astype(np.uint32)
        dst = ((rng.zipf(1.2, 5_000) - 1) % nodes).astype(np.uint32)
        w = rng.integers(1, 9, 5_000).astype(np.float32)
        a, b = gpu.ingest(src, dst, w), cpu.ingest(src, dst, w)
        assert a.touched_keys is None and a.touched_rows is not None and a.touched_rows.is_cuda
    assert gpu.stats.device_collapses == 20 and cpu.stats.device_collapses == 0
    for name in ("counters", "row_flows", "col_flows"):
        assert torch.equal(getattr(gpu._live(), name).cpu(), getattr(cpu._live(), name)), name
    for ea, eb in zip(gpu.events(), cpu.events(), strict=True):
        assert (ea.tick, ea.epoch) == (eb.tick, eb.epoch)
        for ra, rb in zip(ea.results, eb.results, strict=True):
            va = ra.value if isinstance(ra.value, tuple) else (ra.value,)
            vb = rb.value if isinstance(rb.value, tuple) else (rb.value,)
            assert all(np.array_equal(x, y) for x, y in zip(va, vb, strict=True))
    assert torch.equal(gpu.engine.closure_for(gpu._live(), gpu.epoch).cpu(),
                       cpu.engine.closure_for(cpu._live(), cpu.epoch))
    if nodes == 400:
        assert gpu.engine.closure_incremental_refreshes > 0


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_card_session_mixing_batch_sizes_equals_cpu_session(cuda, directed):
    """Batches of 2,000 (collapsed on the card) and 500 (below
    ``PREAGG_MIN_BATCH``, raw) in each order between closure syncs, under
    a reach query every two batches: every receipt a row bitmap, and the
    answers, incremental refreshes and closures of a CPU session."""
    from repro_torch.api import GraphStream, Query
    from repro_torch.core.sketch import SketchConfig

    cfg = SketchConfig(depth=3, width_rows=2048, width_cols=2048, directed=directed)
    gpu, cpu = (GraphStream.open(cfg, seed=5, device=d) for d in ("cuda", "cpu"))
    rng = np.random.default_rng(6)
    qs, qd = (((rng.zipf(1.2, 64) - 1) % 300).astype(np.uint32) for _ in range(2))
    for gs in (gpu, cpu):
        gs.subscribe(Query.edge(qs, qd), Query.reach(qs, qd), every=2)
    for n in (2_000, 500, 500, 2_000, 2_000, 500, 500, 500):
        src, dst = (((rng.zipf(1.2, n) - 1) % 300).astype(np.uint32) for _ in range(2))
        w = rng.integers(1, 9, n).astype(np.float32)
        receipt = gpu.ingest(src, dst, w)
        cpu.ingest(src, dst, w)
        assert receipt.touched_keys is None and receipt.touched_rows.is_cuda
    assert gpu.stats.device_collapses == 3
    assert gpu.engine.closure_incremental_refreshes == cpu.engine.closure_incremental_refreshes > 0
    for ea, eb in zip(gpu.events(), cpu.events(), strict=True):
        for ra, rb in zip(ea.results, eb.results, strict=True):
            assert np.array_equal(ra.value, rb.value)
    assert torch.equal(gpu.engine.closure_for(gpu._live(), gpu.epoch).cpu(),
                       cpu.engine.closure_for(cpu._live(), cpu.epoch))


def test_card_sessions_never_collapse_on_the_host(cuda, monkeypatch):
    """Neither a local nor a fused session on the card calls
    ``preaggregate_host``: the local one collapses on the card, the fused one
    hands the one-pass kernel its raw batch (once a batch); both equal a CPU
    session."""
    import repro_torch.api.stream as stream_mod
    from repro_torch.api import GraphStream
    from repro_torch.core.sketch import SketchConfig

    calls = []
    real = stream_mod.preaggregate_host
    monkeypatch.setattr(stream_mod, "preaggregate_host", lambda *a: calls.append(1) or real(*a))
    cfg = SketchConfig(depth=3, width_rows=1024, width_cols=1024)
    rng = np.random.default_rng(9)
    batches = [(((rng.zipf(1.2, 5_000) - 1) % 2_000).astype(np.uint32),
                ((rng.zipf(1.2, 5_000) - 1) % 2_000).astype(np.uint32),
                rng.integers(1, 9, 5_000).astype(np.float32)) for _ in range(3)]
    local, fused = (GraphStream.open(cfg, device="cuda", ingest_backend=b) for b in ("auto", "fused"))
    before = fused_ops.fused_ingest.launches
    for gs in (local, fused):
        for batch in batches:
            gs.ingest(*batch)
    assert not calls and local.stats.device_collapses == 3 and fused.stats.device_collapses == 0
    assert fused_ops.fused_ingest.launches - before == 3
    cpu = GraphStream.open(cfg, device="cpu")
    for batch in batches:
        cpu.ingest(*batch)
    assert len(calls) == 3
    for gs in (local, fused):
        for name in ("counters", "row_flows", "col_flows"):
            assert torch.equal(getattr(gs._live(), name).cpu(), getattr(cpu._live(), name)), name


def test_card_session_ingest_makes_no_host_sync(cuda):
    """``ingest`` of a card session, its batch collapsed on the card, under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync (the first
    batch builds the kernels and the tables; the flush empties the in-flight
    queue, so the two batches after it wait for nothing)."""
    from repro_torch.api import GraphStream
    from repro_torch.core.sketch import SketchConfig

    gs = GraphStream.open(SketchConfig(depth=5, width_rows=8192, width_cols=8192), device="cuda")
    rng = np.random.default_rng(3)
    batches = [(((rng.zipf(1.2, 50_000) - 1) % 100_000).astype(np.uint32),
                ((rng.zipf(1.2, 50_000) - 1) % 100_000).astype(np.uint32),
                rng.integers(1, 9, 50_000).astype(np.float32)) for _ in range(3)]
    gs.ingest(*batches[0])
    gs.flush()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in batches[1:]:
            gs.ingest(*batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert gs.stats.device_collapses == 3


def test_device_collapses_count_the_batches_collapsed_on_the_card(cuda):
    """One a batch collapsed on the card; none below ``PREAGG_MIN_BATCH``,
    with ``preagg="off"`` or on the CPU."""
    from repro_torch.api import GraphStream
    from repro_torch.core.ingest import PREAGG_MIN_BATCH
    from repro_torch.core.sketch import SketchConfig

    cfg = SketchConfig(depth=2, width_rows=512, width_cols=512)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 1000, (2, n)).astype(np.uint32)
               for n in (PREAGG_MIN_BATCH, PREAGG_MIN_BATCH - 1, 3 * PREAGG_MIN_BATCH)]
    card, off, cpu = (GraphStream.open(cfg, device=d, preagg=p) for d, p in (("cuda", "auto"), ("cuda", "off"),
                                                                               ("cpu", "auto")))
    for gs in (card, off, cpu):
        for src, dst in batches:
            gs.ingest(src, dst)
    assert (card.stats.device_collapses, off.stats.device_collapses, cpu.stats.device_collapses) == (2, 0, 0)
    assert torch.equal(card._live().counters.cpu(), cpu._live().counters)
    assert torch.equal(off._live().counters.cpu(), cpu._live().counters)


# ---------------------------------------------------------------------------
# the analysis and cost planes on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth,width,batch", [(2, 64, 8), (3, 1024, 256)], ids=["fixture", "mid"])
def test_hot_entry_points_do_not_synchronize_on_the_card(cuda, depth, width, batch):
    """Every hot entry point of ``repro_torch.analysis`` on the kernels under
    ``torch.cuda.set_sync_debug_mode("error")``; those baselined for
    ``no-host-sync`` are exempt."""
    import contextlib

    from repro_torch.analysis import contracts
    from repro_torch.analysis.baseline import BASELINE

    exempt = {s for (rule, s) in BASELINE if rule == "no-host-sync"}
    fx = contracts.Fixture(device="cuda", depth=depth, width=width, batch=batch)
    for ep in contracts.ENTRY_POINTS:
        if "no-host-sync" not in ep.contracts or ep.name in exempt:
            continue
        group = contracts.one_rank_group("cuda") if ep.name.startswith("distributed.") else contextlib.nullcontext()
        with group:
            entry = ep.build(fx)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                entry.fn(*entry.args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()


def test_cost_exponents_on_the_card_equal_the_cpus(cuda):
    """The cost pass on the kernels fits the CPU's exponents within 0.05:
    each kernel wrapper counts its declared cost on either device."""
    from repro_torch.analysis.costlint import run_cost_pass

    card_v, card = run_cost_pass(check_budgets=False, device="cuda")
    cpu_v, cpu = run_cost_pass(check_budgets=False, device="cpu")
    assert card_v == [] and cpu_v == []
    for mc, mg in zip(cpu, card, strict=True):
        assert mc["entry"] == mg["entry"]
        for fc, fg in zip(mc["axes"], mg["axes"], strict=True):
            assert fg["ok"] and abs(fc["measured"] - fg["measured"]) <= 0.05, (mg["entry"], fc, fg)


def test_analysis_cli_on_the_card(cuda, tmp_path):
    """``python -m repro_torch.analysis --device cuda`` exits 0 with the
    committed baseline (the budgets are the CPU's and are not checked)."""
    from repro_torch.analysis.runner import main as analysis_main

    out = tmp_path / "report.json"
    assert analysis_main(["--device", "cuda", "--output", str(out)]) == 0
    import json

    report = json.loads(out.read_text())
    assert report["device"] == "cuda" and report["ok"]


# -- the LM serving path (no kernel of the port: plain torch on the card) ------------

# The reference's Mixtral SMOKE widths (src/repro/configs/mixtral_8x22b.py SMOKE).
LM_SMOKE = dict(name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                vocab=256, sliding_window=8, compute_dtype=torch.float32)


def _lm_smoke(capacity_factor=1.25, **changes):
    from repro_torch.models.layers import MoEArgs
    from repro_torch.models.transformer import TransformerConfig

    moe = MoEArgs(n_experts=4, top_k=2, capacity_factor=capacity_factor, partition="ffn")
    return TransformerConfig(**{**LM_SMOKE, **changes}, moe=moe)


def _to(tree, device):
    """A tree of tensors (dicts and lists) moved to ``device``."""
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.to(device), tree)


def test_moe_block_on_card_with_dropped_tokens_matches_cpu(cuda):
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(3)
    t, d, f, e = 96, 64, 128, 4
    x = torch.randn(t, d, generator=g) + torch.randn(d, generator=g)  # a shared direction: uneven loads
    router, wg, wu = (torch.randn(s, generator=g) / d ** 0.5 for s in ((d, e), (e, d, f), (e, d, f)))
    wd = torch.randn(e, f, d, generator=g) / f ** 0.5
    args = layers.MoEArgs(n_experts=e, top_k=2, capacity_factor=1.25)
    table, _, _ = layers.route(x, router, e, 2, layers.moe_capacity(t, args), 0.01)
    assert int((table < t).sum()) < t * 2  # some (token, k) pairs drop
    want, want_aux = layers.moe_block(x, router, wg, wu, wd, args)
    got, aux = layers.moe_block(*(a.cuda() for a in (x, router, wg, wu, wd)), args)
    torch.cuda.synchronize()  # a dropped pair's index must not trip a device assert
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=0)


@pytest.mark.parametrize("prompt,max_seq,changes", [(24, 32, dict(attn_q_chunk=8, attn_window_slicing=True)),
                                                    (5, 24, {}), (10, 24, dict(sliding_window=None))],
                         ids=["wrapped", "unwrapped", "padded"])
def test_prefill_and_decode_on_card_match_cpu(cuda, prompt, max_seq, changes):
    from repro_torch.models import transformer as tfm

    cfg = _lm_smoke(**changes)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, prompt + 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, want_cache = tfm.prefill(cfg, params, tokens[:, :prompt], max_seq=max_seq)
        got, cache = tfm.prefill(cfg, _to(params, "cuda"), tokens[:, :prompt].cuda(), max_seq=max_seq)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-5)
        for j in range(prompt, prompt + 8):
            want, want_cache = tfm.decode_step(cfg, params, tokens[:, j], want_cache)
            got, cache = tfm.decode_step(cfg, _to(params, "cuda"), tokens[:, j].cuda(), cache)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-5)
            for name in ("k", "v"):
                torch.testing.assert_close(cache[name].cpu(), want_cache[name], rtol=1e-5, atol=1e-5)
            assert cache["len"].is_cuda and int(cache["len"]) == int(want_cache["len"])


def test_decode_step_is_sync_free_on_the_card(cuda):
    from repro_torch.models import transformer as tfm

    cfg = _lm_smoke()
    params = _to(tfm.init_params(cfg, torch.Generator().manual_seed(0)), "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 20), device="cuda", generator=cuda)
    with torch.no_grad():
        _, cache = tfm.prefill(cfg, params, tokens[:, :12], max_seq=20)
        tfm.decode_step(cfg, params, tokens[:, 12], dict(cache, k=cache["k"].clone(), v=cache["v"].clone()))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for j in range(12, 20):
                logits, cache = tfm.decode_step(cfg, params, tokens[:, j], cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all()) and int(cache["len"]) == 20


# -- the other models (GAT, SchNet, DimeNet, BERT4Rec) and the popularity sketch --


def _smoke_bundles(arch_id, shape):
    """The SMOKE ``build_step`` bundle of a cell on the card and on the CPU,
    one parameter state (drawn on the CPU) and one numpy batch."""
    from repro_torch.launch.steps import build_step

    card, cpu = (build_step(arch_id, shape, smoke=True, device=d) for d in ("cuda", "cpu"))
    state = cpu.init_state(torch.Generator().manual_seed(0))
    return card, cpu, state, cpu.make_batch(np.random.default_rng(5))


def _step(loss_fn, params):
    """(loss, gradients, parameters after one AdamW step) on the host."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(params)
    grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
    ocfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1)
    new, _, _ = opt_mod.apply_adamw(ocfg, opt_mod.init_adamw(ocfg, params), params, grads)
    return float(loss.detach()), [g.cpu() for g in tree_leaves(grads)], [p.cpu() for p in tree_leaves(new)]


@pytest.mark.parametrize("arch_id", ["gat-cora", "schnet", "dimenet"])
def test_gnn_model_step_on_card_matches_cpu(cuda, arch_id):
    """One training step of each GNN at its SMOKE config through its
    ``build_step`` bundle (GAT on full_graph_sm, the molecular nets on
    molecule): loss, gradients and the parameters after AdamW on the card
    against the CPU (float32, TF32 off; atomics and GEMMs in another
    order)."""
    shape = "full_graph_sm" if arch_id == "gat-cora" else "molecule"
    card, cpu, state, batch = _smoke_bundles(arch_id, shape)
    params = state["params"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = _step(lambda p: card.loss_fn(p, card.to_tensors(batch))[0], _to(params, "cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = _step(lambda p: cpu.loss_fn(p, cpu.to_tensors(batch))[0], params)
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    for g, w in zip(got[1], want[1], strict=True):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    for g, w in zip(got[2], want[2], strict=True):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


# One SMOKE bundle step of each kind, card against CPU: every SMOKE config
# computes in float32 (TF32 off), so the limits are float32 round-off of
# GEMMs and reductions taken in other orders.
BUNDLE_CELLS = [("olmo-1b", "train_4k"), ("qwen3-4b", "prefill_32k"),
                ("qwen3-4b", "decode_32k"), ("gat-cora", "full_graph_sm"), ("dimenet", "molecule"),
                ("bert4rec", "train_batch"), ("bert4rec", "serve_p99"), ("bert4rec", "retrieval_cand")]


@pytest.mark.parametrize("arch_id,shape", BUNDLE_CELLS)
def test_bundle_step_on_card_matches_cpu(cuda, arch_id, shape):
    from repro_torch.tree import tree_leaves

    card, cpu, state, batch = _smoke_bundles(arch_id, shape)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = card.step(_to(state, "cuda"), card.to_tensors(batch))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = cpu.step(state, cpu.to_tensors(batch))
    if card.is_train:
        (got_state, got_m), (want_state, want_m) = got, want
        assert set(got_m) == set(want_m)
        for k in want_m:
            torch.testing.assert_close(got_m[k].cpu().float(), want_m[k].float(), rtol=1e-5, atol=1e-6)
        got, want = got_state["params"], want_state["params"]
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert g.is_cuda and g.dtype == w.dtype
        torch.testing.assert_close(g.cpu().float(), w.float(), rtol=1e-4, atol=1e-5)


# (loss, gradients by norm) limits, card against CPU.  In bf16 compute each
# lies between the card's reading (1.04e-7, 5.24e-5 on an H100) and the
# control's below (1.46e-4, 9.63e-3), which the test checks it catches.
B4R_STEP_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (1e-5, 1e-3)}


def _rel(got, want):
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want, strict=True))
    return (num / sum(float((w ** 2).sum()) for w in want)) ** 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert4rec_step_on_card_matches_cpu(cuda, dtype, monkeypatch):
    """cloze_loss_sampled's loss and gradients at the SMOKE widths on the
    card against the CPU, within ``B4R_STEP_TOL``.  In bf16 a control, the
    float32 attention logits and sampled scores rounded to bf16 (every
    float32 ``torch.einsum`` output), run on the CPU, must fail them."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import recsys
    from repro_torch.models.recsys import bert4rec

    cfg = dataclasses.replace(get_arch("bert4rec").smoke_config, compute_dtype=getattr(torch, dtype))
    params = bert4rec.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    items = recsys.interaction_sequences(cfg.n_items, 16, cfg.seq_len, rng)
    masked, pos, tgt = recsys.cloze_mask_positions(items, cfg.mask_id, cfg.max_masked, rng)
    negs = rng.integers(1, cfg.n_items + 1, 64).astype(np.int32)

    def loss_on(device):
        args = [torch.from_numpy(a).to(device) for a in (masked, pos, tgt, negs)]
        return lambda p: bert4rec.cloze_loss_sampled(cfg, p, *args)[0]

    got = _step(loss_on("cuda"), _to(params, "cuda"))
    want = _step(loss_on("cpu"), params)
    loss_tol, grad_tol = B4R_STEP_TOL[dtype]
    readings = (abs(got[0] - want[0]) / abs(want[0]), _rel(got[1], want[1]))
    print(f"bert4rec {dtype} card vs CPU: loss rel {readings[0]:.3g}, gradients rel {readings[1]:.3g}")
    assert readings[0] <= loss_tol and readings[1] <= grad_tol, readings
    if dtype == "bfloat16":
        einsum = torch.einsum

        def rounded(eq, *ops):
            y = einsum(eq, *ops)
            return y.to(torch.bfloat16).to(torch.float32) if y.dtype == torch.float32 else y

        monkeypatch.setattr(torch, "einsum", rounded)
        ctl = _step(loss_on("cpu"), params)
        control = (abs(ctl[0] - want[0]) / abs(want[0]), _rel(ctl[1], want[1]))
        print(f"bert4rec control (logits and scores in bf16) vs CPU: loss rel {control[0]:.3g}, "
              f"gradients rel {control[1]:.3g}")
        assert control[0] > loss_tol or control[1] > grad_tol, control


def test_popularity_sketch_negatives_on_card(cuda):
    """The user x item popularity sketch on the card: one ingest_scatter
    launch a batch, estimates equal to the CPU sketch's (integer counts) and
    never under the exact counts, and the same negatives from the same
    generator."""
    from repro_torch.data import recsys
    from repro_torch.integration.popularity import InteractionPopularitySketch

    rng = np.random.default_rng(2)
    card = InteractionPopularitySketch(5_000, depth=4, width_users=256, width_items=512, device="cuda")
    host = InteractionPopularitySketch(5_000, depth=4, width_users=256, width_items=512, device="cpu")
    exact = np.zeros(5_001, np.int64)
    before = ingest_ops.ingest_scatter.launches
    for step in range(3):
        items = recsys.interaction_sequences(5_000, 64, 50, rng)
        stream = recsys.interaction_stream(items, np.arange(step * 64, (step + 1) * 64))
        card.observe(stream["src"], stream["dst"])
        host.observe(stream["src"], stream["dst"])
        exact += np.bincount(stream["dst"], minlength=5_001)
    assert ingest_ops.ingest_scatter.launches == before + 3
    seen = np.nonzero(exact)[0].astype(np.uint32)
    est = card.item_popularity(seen)
    np.testing.assert_array_equal(est, host.item_popularity(seen))
    assert np.all(est >= exact[seen])
    np.testing.assert_array_equal(card.sample_negatives(256, np.random.default_rng(3)),
                                  host.sample_negatives(256, np.random.default_rng(3)))
