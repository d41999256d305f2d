"""The frozen count functions against the bounds in PERF.md's kernel table
(serve BASE's first batch: 25,279 distinct pairs padded to 32,768, int64)."""
import torch

from bench.counts import closure, ingest, peaks


def test_closure_squaring_bound():
    assert round(closure.squaring_bound_s(5, 8192) * 1e3, 6) == 2.777948


def test_ingest_bounds():
    bucket = ingest.bucket_bound_bytes(5, 5 * 25_279, 32_768, index_bytes=8)
    assert round(bucket / peaks.HBM_BYTES_PER_S * 1e3, 5) == 0.00324
    keys = ingest.key_bound_bytes(5, 25_279, 32_768, mirror=False)
    assert round(keys / peaks.HBM_BYTES_PER_S * 1e3, 6) == 0.002610


def test_stacked_bound_counts_distinct_sectors():
    plane = torch.tensor([0, 0, 1], dtype=torch.int32)
    rows = torch.tensor([[0, 0, 0]])
    cols = torch.tensor([[0, 1, 0]])
    # Counters: cells 0 and 1 of plane 0 share a sector, plane 1's is its
    # own; row register: two sectors; column register: two.
    assert ingest.stacked_bound_bytes((2, 1, 16, 16), plane, rows, cols) == 6 * 64 + 3 * 2 * 8 + 3 * 8
    assert ingest.distinct_pairs(torch.tensor([1, 1, 2]), torch.tensor([3, 3, 3])) == 2
