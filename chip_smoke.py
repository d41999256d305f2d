#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once) and holds each kernel against its plain PyTorch
version on the card at the BASE shapes (``configs/glava.py``: d=5,
8192 x 8192 counters): the ingest scatter's bucket entry (B=50,000 int32,
and serve BASE's first batch pre-aggregated, padded, hashed into int64
buckets) and its key entry (that batch's keys as the session hands them
over, hashed in the kernel, directed and mirrored), with host us per call,
warm and cold-L2 times after a dirty and a clean fill, the random-sector
floor of the card and the earlier design's readings; the fused multi-query and the
per-sketch edge-query gather (Q=1,024 and 65,536, on int64 buckets from the
BASE family's hash and on their int32 copy, timed in turns with the library
call, with a host breakdown of one call); the closure step (8-bit, int8 wgmma: bit-equal with its
transpose at three densities, all ones among them; the IGMMA count of its
SASS; one full closure); the one-pass fused ingest (B=50,000 with inert and
weight-0 slots, and serve BASE's first batch; host us per call; the atomic
and warp instructions of both ingest kernels' SASS, which must hold RED and
no returning ATOM); the
flow reductions; the CountSketch of a gradient at the 100m preset's
length (65,020,416 elements into a 5 x 16,384 table), hashing in the kernel
and on precomputed hashes, dense and 4,096-sparse (also at width 2^17, past
the shared-memory limit), with the atomic instructions of its SASS; and the
median decode of those tables (d=5 and d=4, and with NaN, +inf and -inf
planted, on the CTA-pair variant) and of a width-2^17 table (the staged
variant), each naming its variant; and the port-only sequential kernel
(serve BASE's first 50,000 edges as they arrive, int64 and int32 buckets,
both modes, on an empty sketch and on one holding the batch: bit-equal to
the plain loop on 2,000 edges and, once, over the whole batch; sequential
mode bit-equal to the ingest scatter; conservative counters between their
cellwise floor and the vanilla counters; the chain's floor with every edge
on one cell); and the
port-only stacked ingest of the fleet (serve BASE's first batch routed to 16
tenants, grouped by slot, into the (80, 5, 8192, 8192) stack of 16 BASE
tenants, past 2^31 cells: counters and both registers bit-equal plane by
plane, with the three ``index_put_`` on precomputed offsets beside it; then
four batches that stress its warp aggregation: one row, one cell, two
tenants alternating lane by lane, weights that cancel); and the port-only
incremental closure refresh (``kernels/boolmm``) at the fleet cell's shape,
two BASE tenants and 2,048 touched rows each: bit-equal to the float32 path
and to a full rebuild, its product kernel's device ms beside the int8
bound.  Each is
timed with CUDA events and the profiler beside its plain version and one
PyTorch library call where there is one.

A small session on the card is held against the same session on the CPU:
its stream, answers and summary, and every function of the analytics path
below (bit-equal, but the global triangle estimate and PageRank within rtol
1e-5).

Then it drives the main paths, each with the launch counts set to 0 just
before and read just after:

- serve BASE: ``repro_torch.launch.serve`` at BASE with the serve entry
  point's own traffic, on the kernels and on the plain backends; the two
  runs must agree bit for bit (counters, registers, transcript), the
  closure kernel must run 13 times per full rebuild and the multi-query
  once a tick and the ingest scatter's key entry once a batch (its bucket
  entry never); one edge-family tick under the profiler must show no cast
  of the int64 buckets, and one ingest batch one kernel on its counter side;
- fused serve BASE: the same traffic through a fused session
  (``ingest_backend="fused"`` on the parsed arguments), which must equal
  both runs above and launch the fused kernel once per batch; one ingest
  batch of each run under the profiler and an aten-op log must show no
  int64-to-int32 cast and no fill (the bitmap is zeroed inside the fused
  kernel's C function);
- the ops entry points on the fused session's live sketch:
  ``kernels/flow/ops.py::node_in_flow``/``node_out_flow`` (the flow kernel)
  against the session's registers, and ``kernels/query/ops.py::
  edge_query_cells`` against the fused multi-query;
- serve incremental, plain and fused: small batches, so the closure refreshes
  incrementally (from touched keys, and from the fused kernel's bitmap, on
  the card's byte refresh); each must equal the plain-backend run, and
  launch 3 + ceil(log2 T) boolean products and the byte transposes of
  whole-tile operands a refresh of T touched rows;
- analytics BASE: one serve BASE session on the kernels, then on its
  summary (TF32 checked off) the wildcard queries (four forms, 1,024 keys),
  ``bound_wildcard_path2`` (1,024 pairs) and ``global_triangle_estimate``
  against float64 on the card, 256 triangle queries against
  ``subgraph_query_batch``, ``sketch_pagerank`` and ``GraphStream.pagerank``
  (rows summing to 1, float64), ``k_hop_reach`` at k=1, 2, 3 (k=2 equal to
  one closure step), ``heavy_hitter_buckets``, ``monitor_step`` on the
  hottest destination, ``update_sequential`` and ``update_conservative`` on
  the first batch (one ``sequential_update`` launch a call), and the four
  baselines at equal space (CountMin, node CountMin, CountSketch, gSketch
  with 8 partitions) fed the session's 500,000 edges, held to their
  over-estimate and signed-error properties against numpy counts; each
  function's time on the card;
- durable window serve BASE: ``serve.main(SERVE_BASE + --window-slices 4
  --slice-width 1.0 --max-lateness 1.0 --wal-dir DIR)`` (10 slices of event
  time through a ring of 4), then the first batch again at event time 0
  (every edge late, retracted), on the kernels and on the plain backends:
  identical ring, registers, watermark tracker, counts and transcript, and
  ``ingest_scatter`` launched exactly once per (batch, slot) group plus once
  per retraction, as counted on the host from the timestamps; a fresh
  session's genesis replay of the WAL (``seek(0)``, ``recover()``) equal to
  it; the window's sum and advance, one slot group's ingest kernel and the
  WAL's appends timed beside their bounds; a plain BASE session with a WAL
  and checkpoints (5 batches, ``checkpoint()``, 5 more, dropped,
  ``recover()``) equal to the uninterrupted run, with save, restore and
  recovery seconds; the small durable windowed session on the card against
  the CPU, its card checkpoint restored and its WAL replayed on the CPU; the
  tiny trainer on the card crashed at step 11 and resumed from step 10,
  uncompressed and compressed: the same losses bit for bit;
- fleet serve BASE: ``serve.main(SERVE_BASE + --tenants 16)``, 16 BASE
  tenants resident (21.5 GB), the serve traffic tagged with zipf tenant ids
  and tenants 0-2 subscribed, on the kernels and on the plain backends:
  identical stacks, cursors and transcripts; the stacked ingest launched
  once a batch and the closure kernel 13 times a batched build of the hot
  tenants' closures; tenants 0, 1, 2 and the tenant of slot 15 (past 2^31
  cells) equal to standalone sessions fed their sub-streams; one batched
  build at S=3 timed;
- fleet residency BASE: 6 tenants through 4 slots with checkpoint and WAL
  directories (3 evictions, 1 fault-in), then a fresh fleet's ``recover()``:
  every tenant equal to its standalone session; then a windowed fleet (4
  tenants, rings of 4 slices, 21.5 GB, the hot tenants advanced every 2
  batches) on the kernels and on the plain backends, identical;
- train 100m: ``repro_torch.launch.train_lm --preset 100m --compress`` for
  10 steps at the example's batch 8 and sequence 64 (full width, random
  weights from a seed): countsketch launched twice a step and its decode
  once, every loss finite, the mean loss over the run's batches lower at its
  final parameters than at its initial ones; the median step time, one
  profiled step, and one step's operators (no sort, no hashing over n) and
  peak memory; one round trip of the state it leaves, on the card against
  the CPU; round trips with NaN and inf in the gradient, card against CPU;
- train tiny: the tiny preset, compressed, 5 steps on the card and on the
  CPU, whose losses must agree;
- distributed serve BASE (paper §6.3): (i) the serve BASE traffic through
  a mesh session (``GraphStream.open(mesh=...)``) on one NCCL rank, a (1, 1)
  mesh, in this process: counters, registers and transcript bit-equal to a
  single-session kernels run, B1 once a batch, B5 once a tick, B3 13 times
  a rebuild, and B6 twice (both point-query directions through the
  counters, held to the registers); (ii) the same traffic on four spawned
  gloo ranks, all on the card, a (2, 2) mesh: each rank's shard bit-equal
  to its rows of (i), registers and transcript equal, the same launches a
  rank; B5 and B6 on a (5, 4096, 8192) shard against their plain versions,
  timed; (iii) the data-parallel compressed ``100m`` step on two spawned
  gloo ranks on the card, 3 steps, against a single-process emulation (one
  set of parameters, both gradients, the two tables added, one decode):
  at every step each rank's table, reduced table, parameters, sketch
  momentum, error feedback and loss bit-equal to the emulation's; wall
  times, all-reduce times and peak memory a rank.  The kernels are built before any rank is spawned.
- durable distributed serve BASE: the same traffic through a mesh session
  with a WAL and checkpoints (one log of the global stream, written by rank
  0): a checkpoint after batch 5, a crash after batch 8, then ``seek``,
  ``recover()`` and the rest; (i) one NCCL rank, whose counters, registers,
  consumed transcript and log records equal the uninterrupted single
  session's (B1 once a batch and once a replayed batch), with the seconds
  of ``recover()``, of its restore and replay and rank 0's append ms; (ii)
  four gloo ranks on the card, each shard equal to its rows of (i); (iii)
  ``merge()`` of two one-rank mesh sessions fed the halves of the stream,
  of a local half into a mesh session and of a mesh half into a local one,
  each equal to the whole-stream session;
- gnn sketch sampling (``launch/gnn_sketch_sampling.py``): the example's
  settings on the card for 120 steps (B1 once an observed block), the first
  5 losses within rtol 1e-4 of the CPU's run, the loss falling and the final
  seed accuracy above chance; then graphsage-reddit's widths at the
  minibatch_lg shape on a synthetic graph of 232,965 nodes and 114,615,892
  edges streamed through a BASE degree sketch, 8 steps: the median step ms
  and the peak GiB;
- lm serve: the LM serving path at Mixtral-8x22B's widths (the registry's
  ``get_arch("mixtral-8x22b").config`` at 2 of its 56 layers, bf16, random
  weights from a seed; no kernel of the port on it, so
  every launch count stays 0): (a) ``prefill`` of 32,768 tokens in chunks of
  512 queries at the config's capacity 1.25, window slicing on and off, the
  last logits equal within 1e-2 x max|logit| with the same argmax, wall,
  CUDA-event and profiled device ms and the peak GiB; (b) 16
  ``decode_step``s at batch 128 against a full 4,096-slot ring cache, each
  under ``torch.cuda.set_sync_debug_mode("error")``, ms a step beside the
  byte bound; (c) in float32 at a capacity no token drops from, a prefill of
  8,192 tokens (the ring wraps twice) and 16 decode steps against one
  ``forward`` over all of them, within 1e-3 x max|logit| with the same
  argmax; (d) four gloo ranks sharing the card on a (2, 2) mesh, one
  layer's ``moe_ffn_sharded`` (both partitions, full capacity) and
  ``swa_attention_halo`` on 4 x 2,048 tokens against their single-rank
  forms within 2e-2 x max|output| (tokens within 1e-5 of a routing tie
  counted and left out), the all-reduce MiB and ms a rank;
- models: the other models at the registry's FULL configs
  (``repro_torch.configs.get_arch``), random weights from a seed, each
  through its ``launch/steps.py::build_step`` bundle (its ``make_batch``,
  ``loss_fn`` and ``step``): (a) BERT4Rec's train_batch (1,000,000 items,
  embed 64, 2 blocks, 2 heads, sequence 200, 2,048 negatives, bf16), its
  batches cut from the bundle's 65,536 users to the largest power of two
  at most 16,384 whose forward and backward peak under 72 GiB; 6 steps,
  each streaming the batch's user-item interactions into one
  ``InteractionPopularitySketch`` on the card (``ingest_scatter`` once a
  batch, no other kernel), drawing the 2,048 negatives from it
  (``sample_negatives``) and handing them to the bundle's step as the
  batch's ``negatives``: finite losses, every streamed item's popularity
  at least its exact count, step ms, peak GiB, bounds, the last batch's
  ingest and step profiled; one step at batch 64 against the CPU's, in
  bf16 and in float32, with a control the float32 limits must catch; (b)
  ``score_all_items`` at serve_p99's batch 512 and serve_bulk's 262,144
  cut to 4,096, ``score_candidates`` against 1,000,000 candidates (equal
  to the full scores gathered within 1e-5 x max), timed with CUDA events
  beside their bounds; (c) GAT, SchNet and DimeNet on full_graph_sm (GAT:
  2,708 nodes and 10,556 edges padded to 3,072 and 10,752), molecule
  (SchNet, DimeNet: 128 graphs of 30 nodes and 64 edges, DimeNet's
  65,536-triplet budget) and minibatch_lg (all three: the block of 1,024
  seeds and fanouts (15, 10), 169,984 nodes and 168,960 edges), the
  bundles' batches, 5 steps (finite losses), the first step against the
  CPU's from the same parameters (loss within 1e-4, gradients within 1e-3
  by norm; DimeNet's block against the CPU's forward only); step ms and
  peak GiB; no kernel launched;
- steps: (a) ``build_step("olmo-1b", "train_4k")`` at the FULL config (16
  layers, d 2,048, vocab 50,304, bf16 parameters, fp32 AdamW moments,
  remat, chunked attention), the batch cut from 256 sequences to the
  largest power of two whose step peaks under 72 GiB (tried from the
  largest that a lower bound by shapes allows), 3 steps: finite losses,
  step ms, the last step's device busy and top kernels, the peak, the
  6·N·D bound from ``model_flops_for``; the SMOKE bundle's step on the
  card against the CPU's; (c) ``pipeline_apply`` on four gloo ranks
  sharing the card against the sequential composition; (d) the bundle dry
  run of every cell on both production meshes (``meta`` tensors): every
  live cell ``ok``; no kernel launched;
- analysis (``repro_torch.analysis`` on the kernels): (a) every hot entry
  point of the registry at the fixture size and at BASE under
  ``torch.cuda.set_sync_debug_mode("error")``, those baselined for
  ``no-host-sync`` exempt; (b) the cost pass on the card, each fitted
  exponent equal to the CPU run's within 0.05 (the kernel wrappers count
  their declared costs on both), and serve BASE's first batch through
  ``GraphStream.ingest`` raising the peak allocation by less than the 1.34
  GB of counters; (c) the sketch dry run at BASE on one NCCL rank: the
  modelled bound, the measured device time and the fraction for one ingest
  batch of 2^20 edges and 65,536 edge queries.

Output: the card's name and power limit as ``nvidia-smi`` reports them, the
build log, one line per phase, one JSON line listing every kernel (launches
on its main path, error against the plain version, times and bound), and
last the line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero; so does a machine without CUDA or a directory without the
package.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# int8 tensor-core operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1979e12

BASE_DEPTH, BASE_WIDTH = 5, 8192
INGEST_BATCH = 50_000
SERVE_BASE = [
    "--depth", "5", "--width", "8192", "--nodes", "100000",
    "--edges", "500000", "--batch", "50000", "--every", "5",
]
# Batches small enough that every tick after the first refreshes the
# closure incrementally (touched rows < 25% of 8192).
SERVE_INCREMENTAL = [
    "--depth", "5", "--width", "8192", "--nodes", "100000",
    "--edges", "2000", "--batch", "200", "--every", "1",
]
PLAIN_BACKENDS = ["--ingest-backend", "scatter", "--query-backend", "torch"]
# Sketched-gradient training of the 100m preset (examples/train_lm.py's
# batch 8 and sequence 64): its flat gradient and the compressor's sketch.
TRAIN_100M = ["--preset", "100m", "--compress", "--steps", "10", "--batch", "8", "--seq", "64"]
TRAIN_TINY = ["--preset", "tiny", "--compress", "--steps", "5", "--batch", "8", "--seq", "64"]
GRAD_100M = 65_020_416
CS_DEPTH, CS_WIDTH = 5, 16_384


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def flag(argv, name: str) -> int:
    """The integer value of ``name`` in an argument list."""
    return int(argv[argv.index(name) + 1])


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up,
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The spin kernels a profiler session starts with, left out of its readings:
# a session may come back without the records of the kernels it saw first
# (the serve BASE ingest batch's B1 record, or the edge tick's first hash
# kernel, in some processes), so the work it reads starts after them.
PREROLL_SPINS, PREROLL_CYCLES = 8, 250_000


def trace_preroll(torch) -> None:
    """Start a profiler session with ``PREROLL_SPINS`` spin kernels (about a
    millisecond in all), then wait for them."""
    for _ in range(PREROLL_SPINS):
        torch.cuda._sleep(PREROLL_CYCLES)
    torch.cuda.synchronize()


def device_ms(fn, reps: int, kernel: Optional[str] = None, exclude=()):
    """Mean device milliseconds per call of the CUDA kernels whose names hold
    ``kernel`` (of every kernel and copy when ``kernel`` is None, but those
    named in ``exclude``), from the profiler's CUPTI trace (the events above
    also count the host's launch overhead whenever it exceeds the kernel).
    A trace of one call gives the number of matching events a call makes;
    the trace of ``reps`` calls counts only if it holds exactly ``reps``
    times that many, so a trace that lost launches is never read as a faster
    kernel.  ``None`` when no complete trace came back in five tries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def trace(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_preroll(torch)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        sel = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0.0)
               and (kernel is None or kernel in e.key) and "spin_kernel" not in e.key and e.key not in exclude]
        return sum(e.count for e in sel), sum(e.device_time_total for e in sel)

    fn()
    torch.cuda.synchronize()
    for _ in range(5):  # now and then a trace comes back without some of its kernels
        per_call, _ = trace(1)
        count, total_us = trace(reps)
        if per_call and count == per_call * reps:
            return total_us / reps / 1e3
    return None


def kernel_keys(fn) -> set:
    """The names of the CUDA kernels one call of ``fn`` runs (profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if getattr(e, "device_time_total", 0.0)}


# The two ways to empty the 50 MB L2 before a timed call, each through 256 MB:
# "dirty" writes them (zero_), so the lines left are dirty and every miss of
# the call also writes one back; "clean" reads them (amax), so no write-back.
FILLS = ("dirty", "clean")


def cold_device_ms(fn, kernel: Optional[str], reps: int = 20, fill: str = "dirty"):
    """``device_ms`` of ``kernel`` (of every kernel of ``fn`` when None) with
    the 50 MB L2 emptied before each call by a 256 MB ``fill`` (``FILLS``),
    as a batch meets counters it has not touched; the fill itself is not
    counted."""
    import torch

    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    empty = {"dirty": flush.zero_, "clean": flush.amax}[fill]
    exclude = kernel_keys(empty) if kernel is None else ()
    return device_ms(lambda: (empty(), fn()), reps, kernel, exclude)


# csrc/ingest.cu's FloorRecord: the buffer; its 32-byte sectors, the adds, the
# adds a thread and a seed; the stream.
FLOOR_RECORD_FORMAT = "=Q4qQ"


def floor_ms(torch, buffer, n_adds: int, per_thread: int, fill: Optional[str]):
    """Device ms of the random-sector floor (``glava_ingest_floor``):
    ``n_adds`` REDs of 1.0, ``per_thread`` (1, 5 or 10) back to back a
    thread, each at a random 32-byte sector of ``buffer`` (its address hashed
    in registers, no index loads), the L2 emptied by ``fill`` before each
    launch (warm, the same sectors every launch, when None).  Adds into
    ``buffer``."""
    import ctypes
    import struct

    from repro_torch.kernels import build

    fn = build.function("ingest", "glava_ingest_floor", [ctypes.c_char_p])
    record = struct.pack(FLOOR_RECORD_FORMAT, buffer.data_ptr(), buffer.numel() // 8, n_adds, per_thread, 1,
                         torch._C._cuda_getCurrentRawStream(buffer.get_device()))

    def launch():
        check(fn(record) == 0, "the random-sector floor did not launch")

    if fill is None:
        return device_ms(launch, 20, "floor_kernel")
    return cold_device_ms(launch, "floor_kernel", fill=fill)


def _fmt(ms) -> str:
    return "no complete trace" if ms is None else f"{ms:.4f} ms"


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` (``time.perf_counter_ns`` around
    ``calls`` calls, after one warm-up; one synchronize after the loop,
    outside the timing, drains what the calls queued)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def query_host_breakdown(torch, counters, rows64, cols64):
    """Host µs per call of the edge-query wrappers (whole calls, on int64
    buckets and their int32 copies), of each piece of their launch path, and
    of the library calls."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.query import ops as query_ops

    d, wr, wc = counters.shape
    q = rows64.shape[1]
    rows32, cols32 = rows64.to(torch.int32), cols64.to(torch.int32)
    flat = counters.view(d, -1)
    cell = rows64 * wc + cols64
    dev = counters.get_device()
    out = counters.new_empty(q)
    fn = build.function("query", "glava_multi_query_min", [ctypes.c_char_p])
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ptrs = (counters.data_ptr(), rows64.data_ptr(), cols64.data_ptr(), out.data_ptr())
    record = query_ops._RECORD.pack(*ptrs, d, wr, wc, q, 8, stream)
    host_counters, host_rows, host_cols = torch.zeros(d, 8, 8), rows64.cpu() % 8, cols64.cpu() % 8

    pieces = {
        "edge_query_min, whole call, int32 buckets": lambda: query_ops.edge_query_min(counters, rows32, cols32),
        "edge_query_min, whole call, int64 buckets": lambda: query_ops.edge_query_min(counters, rows64, cols64),
        "edge_query_cells, whole call, int32 buckets": lambda: query_ops.edge_query_cells(counters, rows32, cols32),
        "edge_query_cells, whole call, int64 buckets": lambda: query_ops.edge_query_cells(counters, rows64, cols64),
        "piece: the checks (_gather on CPU copies returns after them)": lambda: query_ops._gather(
            "glava_multi_query_min", host_counters, host_rows, host_cols, True),
        "piece: counters.new_empty(q)": lambda: counters.new_empty(q),
        "piece: counters.new_empty(d, q)": lambda: counters.new_empty(d, q),
        "piece (more than one device only): torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "piece: torch._C._cuda_getCurrentRawStream(dev)": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "piece: four data_ptr() calls": lambda: (counters.data_ptr(), rows64.data_ptr(), cols64.data_ptr(),
                                                 out.data_ptr()),
        "piece: the launch record's pack": lambda: query_ops._RECORD.pack(*ptrs, d, wr, wc, q, 8, stream),
        "piece: the bound ctypes call on the record (launches B2)": lambda: fn(record),
        "library: flat.gather(1, cell)": lambda: flat.gather(1, cell),
        "library: flat.gather(1, cell).amin(dim=0)": lambda: flat.gather(1, cell).amin(dim=0),
    }
    times = {name: host_us(piece) for name, piece in pieces.items()}
    for name, us in times.items():
        print(f"[chip_smoke] host breakdown d={d} Q={q}: {us:8.3f} us/call  {name}")
    return times


def serve_raw_batch(torch):
    """Serve BASE's first ``--batch`` edges as they arrive (not aggregated),
    hashed by the square BASE session's family into int64 buckets.  Returns
    ``(src, dst, weights)`` as numpy, the family, ``rows``, ``cols`` and the
    weights on the card."""
    import numpy as np

    from repro_torch.core.hashing import keys_to_tensor, make_hash_family
    from repro_torch.data.graphs import edge_stream

    data = edge_stream(flag(SERVE_BASE, "--nodes"), flag(SERVE_BASE, "--edges"), np.random.default_rng(0), zipf_a=1.2)
    b = flag(SERVE_BASE, "--batch")
    src, dst, wts = data["src"][:b], data["dst"][:b], data["weight"][:b]
    family = make_hash_family(torch.Generator().manual_seed(0), BASE_DEPTH, BASE_WIDTH, "cuda")
    rows, cols = family(keys_to_tensor(src, "cuda")), family(keys_to_tensor(dst, "cuda"))
    return (src, dst, wts), family, rows, cols, torch.from_numpy(wts).cuda()


def serve_first_keys(torch):
    """Serve BASE's first batch as a session hands it to
    ``update_preaggregated_``: the first ``--batch`` edges of
    ``launch/serve.py``'s traffic (zipf a=1.2 sources and destinations, seed
    0), pre-aggregated on the host, padded by ``pad_bucket`` (key 0, weight
    0), the keys as int64 on the card.  Returns ``(src, dst, weights,
    family, pairs)`` with the square BASE session's family (drawn as
    GraphStream seed 0 draws it)."""
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.ingest import pad_bucket, preaggregate_host

    (src, dst, wts), family, *_ = serve_raw_batch(torch)
    pre = preaggregate_host(src, dst, wts)
    keys = [keys_to_tensor(pad_bucket(x), "cuda") for x in (pre.src, pre.dst)]
    return (*keys, torch.from_numpy(pad_bucket(pre.weights)).cuda(), family, pre.n_pairs)


def serve_first_batch(torch):
    """Serve BASE's first batch (``serve_first_keys``) hashed by the BASE
    family into int64 buckets, as the bucket entry takes it.  Returns
    ``(rows, cols, weights, pairs)``."""
    src, dst, wts, family, n_pairs = serve_first_keys(torch)
    rows, cols = family(src), family(dst)
    check(rows.dtype == torch.int64 and cols.dtype == torch.int64, f"the hash gave {rows.dtype} buckets")
    return rows, cols, wts, n_pairs


# Calls per CUDA-event timing of the ingest wrappers (10-20 us a call, about
# the host's time per call, so many calls average the host's noise).
INGEST_REPS = 200


def ingest_bound_bytes(rows, wts) -> int:
    """Bytes an ingest-scatter batch needs: each weighted valid slot reads and
    writes one 32-byte sector of counters; the row and column indices and
    the weights are read once."""
    d, b = rows.shape
    n_adds = int(((rows >= 0) & (wts != 0)[None, :]).sum())
    return n_adds * 64 + d * b * 2 * rows.element_size() + b * wts.element_size()


# The earlier B1 design (one thread a (slot, sketch)) on serve BASE's first
# batch's int64 buckets, device ms warm, with a cold L2 after the dirty fill
# and after the clean one: tools/ablate_ingest.py --parent on an NVIDIA H100
# 80GB HBM3, 700.00 W, in the run that chose the design.
EARLIER_INGEST_MS = (0.0033, 0.0108, 0.0053)


def key_bound_bytes(wts, depth: int, mirror: bool) -> int:
    """Bytes a key-entry batch needs: each add of a weighted slot reads and
    writes one 32-byte sector of counters (d adds a slot, 2d mirrored); the
    two int64 keys and the float32 weight of each slot are read once."""
    n_adds = depth * int((wts != 0).sum()) * (2 if mirror else 1)
    return n_adds * 64 + wts.shape[0] * (8 + 8 + 4)


def cold_pair(fn, kernel):
    """Device ms of ``kernel`` under ``fn`` with a cold L2, by each fill."""
    return {fill: cold_device_ms(fn, kernel, fill=fill) for fill in FILLS}


def _cold(times) -> str:
    return ", ".join(f"{fill} fill {_fmt(ms)}" for fill, ms in times.items())


def phase_ingest(torch, gen):
    """B1's two entries.  The bucket entry on a synthetic int32 batch
    (B=50,000, a tenth of its slots inert) and on serve BASE's first batch's
    int64 buckets; the key entry on that batch as the serve path hands it to
    ``update_preaggregated_`` (pre-aggregated keys, the BASE family; the
    kernel hashes), directed and mirrored.  Each bit-equal to its plain
    version; wrapper ms by CUDA events, host us per call, device ms warm and
    with a cold L2 after both fills beside the bound, the random-sector floor
    and the earlier design's readings; the library calls warm and cold."""
    from repro_torch.kernels.ingest.ops import ingest_keys, ingest_scatter
    from repro_torch.kernels.ingest.ref import ingest_keys_ref, ingest_scatter_ref

    d, w, b = BASE_DEPTH, BASE_WIDTH, INGEST_BATCH
    base = torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float()
    rows = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    rows[torch.rand((d, b), generator=gen, device="cuda") < 0.1] = -1  # inert slots
    cols = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    wts = torch.randint(1, 9, (b,), generator=gen, device="cuda").float()
    src, dst, swts, fam, n_pairs = serve_first_keys(torch)
    srows, scols = fam(src), fam(dst)
    err = key_err = 0.0
    for r, c, wt in ((rows, cols, wts), (srows, scols, swts)):
        got = ingest_scatter(base.clone(), r, c, wt)
        want = ingest_scatter_ref(base.clone(), r, c, wt)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"ingest kernel differs from its plain version on {r.dtype} buckets (max err {err})")
        del got, want
    for mirror in (False, True):
        got = ingest_keys(base.clone(), src, dst, swts, fam, fam, mirror=mirror)
        want = ingest_keys_ref(base.clone(), src, dst, swts, fam, fam, mirror=mirror)
        torch.cuda.synchronize()
        key_err = max(key_err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"ingest_keys (mirror={mirror}) differs from its plain version (max err {key_err})")
        del want
    ms = time_ms(lambda: ingest_scatter(got, rows, cols, wts), INGEST_REPS)
    host = host_us(lambda: ingest_scatter(got, rows, cols, wts))
    dev_ms = device_ms(lambda: ingest_scatter(got, rows, cols, wts), 20, "ingest_kernel")
    plain_ms = time_ms(lambda: ingest_scatter_ref(got, rows, cols, wts), 20)
    valid = rows >= 0
    d_idx = torch.arange(d, device="cuda")[:, None].expand(d, b)[valid]
    idx = (d_idx, rows.long()[valid], cols.long()[valid])
    vals = wts[None, :].expand(d, b)[valid]
    library_ms = time_ms(lambda: got.index_put_(idx, vals, accumulate=True), 20)
    library_dev_ms = device_ms(lambda: got.index_put_(idx, vals, accumulate=True), 20)
    bound_ms = ingest_bound_bytes(rows, wts) / PEAK_BYTES_PER_S * 1e3
    print(
        f"[chip_smoke] ingest d={d} w={w} B={b} int32 ({int(valid.sum())} valid slots): bit-equal; "
        f"wrapper {ms:.4f} ms, host {host:.3f} us/call, device {_fmt(dev_ms)}"
        + (f" ({100 * bound_ms / dev_ms:.1f}% of the bound)" if dev_ms else "")
        + f"; plain {plain_ms:.4f} ms, index_put_ {library_ms:.4f} ms (device {_fmt(library_dev_ms)}); "
        f"bound {bound_ms:.5f} ms"
    )
    scatter = lambda: ingest_scatter(got, srows, scols, swts)  # noqa: E731
    s_ms, s_host = time_ms(scatter, INGEST_REPS), host_us(scatter)
    s_dev, s_cold = device_ms(scatter, 20, "ingest_kernel"), cold_pair(scatter, "ingest_kernel")
    s_bound = ingest_bound_bytes(srows, swts) / PEAK_BYTES_PER_S * 1e3
    s_idx = (torch.arange(d, device="cuda")[:, None], srows, scols)
    s_lib = lambda: got.index_put_(s_idx, swts.expand(d, -1), accumulate=True)  # noqa: E731
    s_lib_ms, s_lib_dev, s_lib_cold = time_ms(s_lib, 20), device_ms(s_lib, 20), cold_pair(s_lib, None)
    print(
        f"[chip_smoke] ingest on serve BASE's first batch ({n_pairs} pre-aggregated pairs padded to "
        f"{srows.shape[1]}, int64 buckets): bit-equal; wrapper {s_ms:.4f} ms, host {s_host:.3f} us/call, "
        f"device {_fmt(s_dev)}" + (f" ({100 * s_bound / s_dev:.1f}% of the bound)" if s_dev else "")
        + f", with a cold L2: {_cold(s_cold)}; bound {s_bound:.5f} ms; index_put_ on the buckets {s_lib_ms:.4f} ms "
        f"(device {_fmt(s_lib_dev)}; cold: {_cold(s_lib_cold)})"
    )

    keys = lambda: ingest_keys(got, src, dst, swts, fam, fam)  # noqa: E731
    mirrored = lambda: ingest_keys(got, src, dst, swts, fam, fam, mirror=True)  # noqa: E731
    k_ms, k_host = time_ms(keys, INGEST_REPS), host_us(keys)
    k_dev, k_cold = device_ms(keys, 20, "ingest_kernel"), cold_pair(keys, "ingest_kernel")
    m_dev, m_cold = device_ms(mirrored, 20, "ingest_kernel"), cold_pair(mirrored, "ingest_kernel")
    k_plain = time_ms(lambda: ingest_keys_ref(got, src, dst, swts, fam, fam), 20)
    k_idx = lambda: (torch.arange(d, device="cuda")[:, None], fam(src), fam(dst))  # noqa: E731
    k_lib = lambda: got.index_put_(k_idx(), swts.expand(d, -1), accumulate=True)  # noqa: E731
    k_lib_ms, k_lib_dev, k_lib_cold = time_ms(k_lib, 20), device_ms(k_lib, 20), cold_pair(k_lib, None)
    k_bound = key_bound_bytes(swts, d, False) / PEAK_BYTES_PER_S * 1e3
    m_bound = key_bound_bytes(swts, d, True) / PEAK_BYTES_PER_S * 1e3
    adds = d * int((swts != 0).sum())
    floors = {(fill, per): floor_ms(torch, got, adds, per, fill) for fill in FILLS for per in (1, d)}
    floor = {fill: min((ms for (f, _), ms in floors.items() if f == fill and ms), default=None) for fill in FILLS}
    share = lambda ms, bound: f" ({100 * bound / ms:.1f}% of the bound)" if ms else ""  # noqa: E731
    print(
        f"[chip_smoke] ingest_keys on serve BASE's first batch ({n_pairs} pairs padded to {src.shape[0]}, int64 "
        f"keys hashed in the kernel, {adds} adds): bit-equal directed and mirrored; wrapper {k_ms:.4f} ms, host "
        f"{k_host:.3f} us/call; device {_fmt(k_dev)}{share(k_dev, k_bound)}, with a cold L2: {_cold(k_cold)}"
        f"{share(k_cold['clean'], k_bound)} against the clean fill; bound {k_bound:.5f} ms; mirrored device "
        f"{_fmt(m_dev)}, cold: {_cold(m_cold)}, bound {m_bound:.5f} ms; plain (hash + scatter) {k_plain:.4f} ms; "
        f"two affine_hash + index_put_ {k_lib_ms:.4f} ms (device {_fmt(k_lib_dev)}; cold: {_cold(k_lib_cold)})"
    )
    print(
        f"[chip_smoke] random-sector floor, {adds} REDs at random sectors of the 1.34 GB counters, no index loads: "
        + "; ".join(f"{fill} fill, {per} a thread, {_fmt(ms)}" for (fill, per), ms in floors.items())
        + f"; ingest_keys cold over the floor: "
        + ", ".join(f"{fill} {k_cold[fill] / floor[fill]:.2f}x" for fill in FILLS if k_cold[fill] and floor[fill])
        + f"; the earlier design read {EARLIER_INGEST_MS[0]:.4f} ms warm, {EARLIER_INGEST_MS[1]:.4f} dirty and "
        f"{EARLIER_INGEST_MS[2]:.4f} clean on these buckets"
    )
    del got, base
    return [
        dict(name="ingest_scatter", route="cuda", source="src/repro_torch/csrc/ingest.cu",
             replaces="src/repro/kernels/ingest/kernel.py:59", max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms),
        dict(name="ingest_keys", route="cuda", source="src/repro_torch/csrc/ingest.cu",
             replaces="src/repro/kernels/ingest/kernel.py:59", max_abs_err=key_err, ms=k_ms,
             plain_ms=k_plain, bound_ms=k_bound, bound_by="bytes", library_ms=k_lib_ms),
    ]


# Calls per CUDA-event timing of the edge-query wrappers and their library
# calls (host-bound at Q=1,024, so many calls average the host's noise).
QUERY_REPS = 500


def phase_queries(torch, gen):
    """B2 (fused multi-query) and B5 (per-sketch gather) at Q=1,024, the
    serve workload's edge family, and at 65,536, on int64 buckets from the
    BASE family's hash (what the serve path hands them) and on their int32
    copy: bit-equal to the plain versions; the wrapper's ms by CUDA events
    in turns with the library call (library, kernel, kernel, library), host
    µs per call and device ms beside the library call's; then the host
    breakdown of one call."""
    import numpy as np

    from repro_torch.configs.glava import QUERY_64K
    from repro_torch.core.hashing import keys_to_tensor, make_hash_family
    from repro_torch.kernels.query import ops as query_ops
    from repro_torch.kernels.query.ref import edge_query_cells_ref, edge_query_min_ref

    d, w = BASE_DEPTH, BASE_WIDTH
    counters = torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float()
    flat = counters.view(d, -1)
    # The square BASE session's one family, drawn as GraphStream seed 0 draws it.
    family = make_hash_family(torch.Generator().manual_seed(0), d, w, "cuda")
    rng = np.random.default_rng(5)
    kernels = {
        "edge_query_min": (query_ops.edge_query_min, edge_query_min_ref, "multi_query_min_kernel",
                           "gather+amin", lambda cell: flat.gather(1, cell).amin(dim=0),
                           "src/repro/kernels/query/kernel.py:99"),
        "edge_query_cells": (query_ops.edge_query_cells, edge_query_cells_ref, "query_cells_kernel",
                             "gather", lambda cell: flat.gather(1, cell),
                             "src/repro/kernels/query/kernel.py:122"),
    }
    out = {}
    for q in (1024, QUERY_64K):
        src = keys_to_tensor(rng.integers(0, 100_000, q).astype(np.uint32), "cuda")
        dst = keys_to_tensor(rng.integers(0, 100_000, q).astype(np.uint32), "cuda")
        rows64, cols64 = family(src), family(dst)
        check(rows64.dtype == torch.int64, f"the hash gave {rows64.dtype} buckets")
        cell = rows64 * w + cols64
        for rows, cols in ((rows64.to(torch.int32), cols64.to(torch.int32)), (rows64, cols64)):
            index_bytes = rows.element_size()
            for name, (fn, ref, kernel, lib_name, library, replaces) in kernels.items():
                got, want = fn(counters, rows, cols), ref(counters, rows, cols)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(torch.equal(got, want), f"{name} differs from its plain version at Q={q}, {rows.dtype}")
                call = lambda: fn(counters, rows, cols)  # noqa: E731
                lib = lambda: library(cell)  # noqa: E731
                lib_a, ms_a, ms_b, lib_b = (time_ms(f, QUERY_REPS) for f in (lib, call, call, lib))
                ms, lib_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
                host, lib_host = host_us(call), host_us(lib)
                dev_ms, lib_dev_ms = device_ms(call, 50, kernel), device_ms(lib, 50)
                plain_ms = time_ms(lambda: ref(counters, rows, cols), 50)
                # One 32-byte sector per (sketch, query), the row and column
                # indices read once, the output written once.
                out_bytes = 4 * q if name == "edge_query_min" else 4 * d * q
                bound_ms = (d * q * (32 + 2 * index_bytes) + out_bytes) / PEAK_BYTES_PER_S * 1e3
                print(
                    f"[chip_smoke] {name} d={d} w={w} Q={q} {str(rows.dtype)[6:]} buckets: bit-equal; wrapper "
                    f"{ms:.5f} ms ({ms_a:.5f}, {ms_b:.5f}) vs {lib_name} {lib_ms:.5f} ms ({lib_a:.5f}, {lib_b:.5f}): "
                    f"{ms / lib_ms:.3f}x; host {host:.3f} vs {lib_host:.3f} us/call; device {_fmt(dev_ms)} vs "
                    f"{_fmt(lib_dev_ms)}; bound {bound_ms:.5f} ms"
                    + (f" = {100 * bound_ms / dev_ms:.1f}% of the device time" if dev_ms else "")
                    + f"; plain {plain_ms:.4f} ms"
                )
                if q == 1024 and index_bytes == 8:  # the serve path's shape and buckets
                    out[name] = dict(
                        name=name, route="cuda", source="src/repro_torch/csrc/query.cu", replaces=replaces,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                        library_ms=lib_ms,
                    )
        if q == 1024:
            query_host_breakdown(torch, counters, rows64, cols64)
    return list(out.values())


def phase_closure(torch, gen):
    """The closure step against its plain version at BASE on three inputs
    (both outputs, the step and its transpose), its time beside the 8-bit
    bound and the library calls, its SASS, and one full closure at BASE."""
    from repro_torch.kernels.closure.ops import closure_step, closure_steps, transitive_closure
    from repro_torch.kernels.closure.ref import closure_step_ref

    d, w = BASE_DEPTH, BASE_WIDTH
    # Density 0.005 leaves about a fifth of A @ A nonzero; 0.02 all but ~4%;
    # all ones makes every sum equal w (an accumulator or epilogue that
    # wraps at 127 or 255 would show).
    err, ones = 0.0, []
    for density in (0.005, 0.02, 1.0):
        a = (torch.rand((d, w, w), generator=gen, device="cuda") < density).to(torch.uint8)
        a_t = a.transpose(1, 2).contiguous()
        got, got_t = closure_step(a, a_t)
        want = closure_step_ref(a)
        torch.cuda.synchronize()
        err = max(err, float((got.float() - want.float()).abs().max()))
        check(torch.equal(got, want), f"closure kernel differs from its plain version at density {density}")
        check(torch.equal(got_t, want.transpose(1, 2)), f"closure kernel's transpose is wrong at density {density}")
        ones.append(float(got.float().mean()))
        del got, got_t, want
        if density == 0.005:
            timed = a, a_t
    a, a_t = timed
    out, out_t = torch.empty_like(a), torch.empty_like(a)
    step = lambda: closure_step(a, a_t, out, out_t)  # noqa: E731
    ms = time_ms(step, 10)
    dev_ms = device_ms(step, 5, "closure_step_wgmma_kernel")
    plain_ms = time_ms(lambda: closure_step_ref(a), 3)
    # The yardsticks: int8 products per sketch on the same bytes (B as A
    # itself, row-major, and as A^T's rows, column-major: the faster), and
    # bf16 torch.matmul.
    a8, at8 = a.view(torch.int8), a_t.view(torch.int8)
    int_mm = {
        "row-major B": lambda: [torch._int_mm(a8[i], a8[i]) for i in range(d)],
        "column-major B": lambda: [torch._int_mm(a8[i], at8[i].t()) for i in range(d)],
    }
    int_ms = {k: time_ms(f, 5) for k, f in int_mm.items()}
    int_dev = {k: device_ms(f, 3) for k, f in int_mm.items()}
    best = min(int_ms, key=int_ms.get)
    library_ms = int_ms[best]
    a16 = a.to(torch.bfloat16)
    bf16_ms = time_ms(lambda: torch.matmul(a16, a16), 5)
    del a16, out, out_t
    ops = d * 2 * w**3
    bound_bytes = 4 * d * w * w  # a and a_t read, out and out_t written, a byte an entry
    bound_ms = max(ops / PEAK_INT8_OPS, bound_bytes / PEAK_BYTES_PER_S) * 1e3
    # One full closure at BASE: ceil(log2 w) launches.
    before = closure_step.launches
    transitive_closure(a)
    launches = closure_step.launches - before
    full_ms = time_ms(lambda: transitive_closure(a), 2)
    check(launches == closure_steps(w), f"full closure at BASE: {launches} launches, not {closure_steps(w)}")
    sass = closure_sass()
    del a, a_t, timed
    print(
        f"[chip_smoke] closure step d={d} w={w}, u8: bit-equal with its transpose at densities 0.005, 0.02 and 1 "
        f"(output {', '.join(f'{x:.3f}' for x in ones)} ones); kernel {ms:.4f} ms "
        f"({ops / ms / 1e9:.1f} TOPS; device {_fmt(dev_ms)}; bound {bound_ms:.4f} ms at the int8 peak), "
        f"plain {plain_ms:.3f} ms, "
        + ", ".join(f"_int_mm x{d} {k} {int_ms[k]:.4f} ms (device {_fmt(int_dev[k])})" for k in int_mm)
        + f", bf16 matmul {bf16_ms:.4f} ms"
    )
    print(f"[chip_smoke] closure full transitive_closure d={d} w={w}: {launches} launches, {full_ms:.3f} ms")
    print(f"[chip_smoke] closure SASS: {sass}")
    return dict(
        name="closure_step", route="cuda", source="src/repro_torch/csrc/closure.cu",
        replaces="src/repro/kernels/closure/kernel.py:42", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops / PEAK_INT8_OPS > bound_bytes / PEAK_BYTES_PER_S else "bytes",
        library_ms=library_ms,
    )


def closure_sass() -> str:
    """The count of warpgroup MMA instructions (IGMMA, HGMMA, QGMMA) in the
    built closure library's SASS, and ptxas's resource line for each of its
    kernels."""
    import re

    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path("closure"))], capture_output=True, text=True, check=True
    ).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("IGMMA", "HGMMA", "QGMMA")}
    check(counts["IGMMA"] > 0, f"no IGMMA instruction in the closure kernel's SASS: {counts}")
    usage = [
        line.split("ptxas info    : ", 1)[-1].strip()
        for line in build.build_log("closure").splitlines()
        if "registers" in line or "spill" in line
    ]
    return f"{counts}; ptxas: {' | '.join(usage)}"


def phase_fused_ingest(torch, gen):
    """B4 on a synthetic int32 batch (B=50,000 with inert and weight-0
    slots) and on serve BASE's first batch (int64 buckets, pairs sorted by
    source, padded by pad_bucket): all four outputs bit-equal to the plain
    version; wrapper ms by CUDA events, host us per call, device ms beside
    the bound; the serve batch's slots also with uniformly drawn rows; the
    atomic and warp instructions of the kernel's SASS."""
    from repro_torch.kernels.ingest_fused.ops import fused_ingest
    from repro_torch.kernels.ingest_fused.ref import fused_ingest_ref

    d, w, b = BASE_DEPTH, BASE_WIDTH, INGEST_BATCH
    state = (
        torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float(),
        torch.randint(0, 1000, (d, w), generator=gen, device="cuda").float(),
        torch.randint(0, 1000, (d, w), generator=gen, device="cuda").float(),
    )
    rows = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    rows[torch.rand((d, b), generator=gen, device="cuda") < 0.1] = -1  # inert slots
    cols = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    wts = torch.randint(1, 9, (b,), generator=gen, device="cuda").float()
    wts[torch.rand((b,), generator=gen, device="cuda") < 0.05] = 0.0  # valid, weight 0
    srows, scols, swts, n_pairs = serve_first_batch(torch)
    err = 0.0
    for r, c, wt in ((rows, cols, wts), (srows, scols, swts)):
        got = fused_ingest(*(t.clone() for t in state), r, c, wt)
        want = fused_ingest_ref(*(t.clone() for t in state), r, c, wt)
        torch.cuda.synchronize()
        err = max([err] + [float((g.float() - x.float()).abs().max()) for g, x in zip(got, want)])
        for name, g, x in zip(("counters", "row_flows", "col_flows", "touched"), got, want):
            check(torch.equal(g, x), f"fused ingest kernel: {name} differs from its plain version on {r.dtype} "
                                     f"buckets (max err {err})")
        del want
    counters, rf, cf, _ = got
    rows_out = {}
    for label, (r, c, wt) in {"synthetic": (rows, cols, wts), "serve": (srows, scols, swts)}.items():
        call = lambda: fused_ingest(counters, rf, cf, r, c, wt)  # noqa: E731
        rows_out[label] = dict(
            ms=time_ms(call, INGEST_REPS), host=host_us(call), dev=device_ms(call, 20, "fused_ingest_kernel"),
            with_memset=device_ms(call, 20), bound=fused_bound_bytes(torch, r, c, wt, w) / PEAK_BYTES_PER_S * 1e3,
        )
    plain_ms = time_ms(lambda: fused_ingest_ref(counters, rf, cf, rows, cols, wts), 20)
    uniform = torch.randint_like(srows, 0, w)
    uniform_ms = device_ms(lambda: fused_ingest(counters, rf, cf, uniform, scols, swts), 20, "fused_ingest_kernel")
    cold_ms = cold_device_ms(lambda: fused_ingest(counters, rf, cf, srows, scols, swts), "fused_ingest_kernel")
    valid = rows >= 0
    adds = valid & (wts != 0)[None, :]

    def line(x):
        return (f"wrapper {x['ms']:.4f} ms, host {x['host']:.3f} us/call, device {_fmt(x['dev'])}"
                + (f" ({100 * x['bound'] / x['dev']:.1f}% of the bound)" if x["dev"] else "")
                + f", with the bitmap's memset {_fmt(x['with_memset'])}; bound {x['bound']:.5f} ms")

    print(f"[chip_smoke] fused ingest on serve BASE's first batch ({n_pairs} pre-aggregated pairs padded to "
          f"{srows.shape[1]}, int64 buckets): all four outputs bit-equal; {line(rows_out['serve'])}; with a cold "
          f"L2: device {_fmt(cold_ms)}; the same slots with uniform rows: device {_fmt(uniform_ms)}")
    print(f"[chip_smoke] fused ingest d={d} w={w} B={b} int32 ({int(valid.sum())} valid slots, {int(adds.sum())} "
          f"weighted): all four outputs bit-equal; {line(rows_out['synthetic'])}; plain {plain_ms:.4f} ms; no single "
          f"library call updates counters, both registers and the bitmap (library_ms null)")
    # The adds and marks must compile to RED (no value returned), not ATOM.
    for source, kernel, ops in (("ingest_fused", "fused_ingest_kernel", "RED|ATOM|MATCH|VOTE|STG"),
                                ("ingest", "ingest_kernel", "RED|ATOM")):
        sass = sass_ops(source, kernel, ops)
        check("RED" in sass and "ATOM" not in sass, f"{kernel}: the adds are not all RED: {sass}")
        print(f"[chip_smoke] {source} SASS: {sass}")
    return dict(
        name="fused_ingest", route="cuda", source="src/repro_torch/csrc/ingest_fused.cu",
        replaces="src/repro/kernels/ingest_fused/kernel.py:98", max_abs_err=err, ms=rows_out["synthetic"]["ms"],
        plain_ms=plain_ms, bound_ms=rows_out["synthetic"]["bound"], bound_by="bytes", library_ms=None,
    )


def fused_bound_bytes(torch, rows, cols, wts, w: int) -> int:
    """Bytes a fused-ingest batch needs: a 32-byte sector read and written
    for every distinct counter and register sector its weighted valid slots
    add into, the (d, w) bitmap written once, the indices and weights read
    once."""
    d, b = rows.shape
    adds = (rows >= 0) & (wts != 0)[None, :]
    i_idx = torch.arange(d, device=rows.device)[:, None].expand(d, b)
    r, c, i = rows.long()[adds], cols.long()[adds], i_idx[adds]
    sectors = sum(
        int(torch.unique(flat // 8).numel())
        for flat in ((i * w + r) * w + c, i * w + r, i * w + c)
    )
    return sectors * 64 + d * w + d * b * 2 * rows.element_size() + b * wts.element_size()


def sass_ops(source: str, kernel: str, ops: str) -> str:
    """The count of each instruction of ``ops`` (a regex alternation of
    opcode prefixes, each matched to its whole opcode and modifiers, e.g.
    ``RED`` to ``REDG.E.ADD.F32.FTZ.RN.STRONG.GPU``) in each instantiation of
    ``kernel`` in the built library of ``csrc/<source>.cu``."""
    import re

    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path(source))], capture_output=True, text=True, check=True
    ).stdout
    out = []
    for block in sass.split("Function : ")[1:]:
        name = re.search(rf"({kernel})I(.*?)EEv", block.split("\n", 1)[0])
        counts = {}
        for op in re.findall(rf"\b((?:{ops})[A-Z]*(?:\.[A-Z0-9_]+)*)", block):
            counts[op] = counts.get(op, 0) + 1
        if name and counts:
            out.append(f"{name.group(1)}<{name.group(2)}>: {counts}")
    return "; ".join(out)


def phase_flows(torch, gen):
    from repro_torch.kernels.flow.ops import flows
    from repro_torch.kernels.flow.ref import flows_ref

    d, w = BASE_DEPTH, BASE_WIDTH
    # Cells below 2^24 / 8192 = 2048 keep every sum exact in any order.
    counters = torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float()
    rs, cs = flows(counters)
    want_rs, want_cs = flows_ref(counters)
    torch.cuda.synchronize()
    err = max(float((rs - want_rs).abs().max()), float((cs - want_cs).abs().max()))
    check(torch.equal(rs, want_rs) and torch.equal(cs, want_cs),
          f"flows kernel differs from its plain version (max err {err})")
    ms = time_ms(lambda: flows(counters), 20)
    dev_ms = device_ms(lambda: flows(counters), 20, "flows_kernel")
    plain_ms = time_ms(lambda: flows_ref(counters), 20)
    library_ms = time_ms(lambda: (counters.sum(2), counters.sum(1)), 20)
    library_dev_ms = device_ms(lambda: (counters.sum(2), counters.sum(1)), 20)
    # One read of the counters, one write of both outputs.
    bound_bytes = d * w * w * 4 + 2 * d * w * 4
    print(
        f"[chip_smoke] flows d={d} w={w}: bit-equal; kernel {ms:.4f} ms (device {_fmt(dev_ms)}, "
        f"{d * w * w * 4 / ms / 1e9:.2f} TB/s by the wrapper's time), plain {plain_ms:.4f} ms, "
        f"sum(2)+sum(1) {library_ms:.4f} ms (device {_fmt(library_dev_ms)}); bound "
        f"{bound_bytes / PEAK_BYTES_PER_S * 1e3:.5f} ms"
    )
    return dict(
        name="flows", route="cuda", source="src/repro_torch/csrc/flow.cu",
        replaces="src/repro/kernels/flow/kernel.py:39", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=library_ms,
    )


def phase_countsketch(torch, gen):
    """The CountSketch kernel, in its family form (hashing in the kernel, the
    main path's) and on precomputed hashes, against its plain version at the
    100m preset's gradient length, and at a width past the shared-memory
    limit; its SASS; then the median decode kernel against its plain version
    on the tables those sketches produce, at d=5 and d=4 and with NaN, +inf
    and -inf planted."""
    from repro_torch.core.hashing import make_hash_family
    from repro_torch.kernels.countsketch.ops import countsketch, countsketch_family, hash_indices
    from repro_torch.kernels.countsketch.ref import countsketch_ref

    d, w, n = CS_DEPTH, CS_WIDTH, GRAD_100M
    fam = make_hash_family(torch.Generator().manual_seed(1), d, w, "cuda")
    h, s = hash_indices(fam, n)
    # Integer values in [-8, 8]: every partial sum of a cell (about n/w = 4,000
    # terms) stays far below 2^24, so the plain version's float sum is exact.
    ivec = torch.randint(-8, 9, (n,), generator=gen, device="cuda").float()
    itable = countsketch_ref(ivec, h, s, w)
    for name, got in (("family form", countsketch_family(ivec, fam)), ("pre-hashed form", countsketch(ivec, h, s, w))):
        torch.cuda.synchronize()
        check(torch.equal(got, itable), f"countsketch ({name}) differs from its plain version on integer values "
              f"(max err {float((got - itable).abs().max())})")
    # A top-k update: 4,096 nonzero coordinates, the rest zero (skipped).
    sparse = torch.zeros(n, device="cuda")
    sparse[torch.randperm(n, generator=gen, device="cuda")[:4096]] = ivec[:4096]
    want = countsketch_ref(sparse, h, s, w)
    check(torch.equal(countsketch_family(sparse, fam), want) and torch.equal(countsketch(sparse, h, s, w), want),
          "countsketch differs from its plain version on a sparse vector")
    # Gaussian values: each cell sums about 4,000 terms, the kernel in fixed
    # point, the plain version in float32; both must lie within the
    # worst-case rounding bound of a float32 sum of the float64 sum
    # (rounding_bound).  The kernel's sum does not depend on the order of its
    # atomics: a second launch gives the same bits.
    gvec = torch.randn(n, generator=gen, device="cuda")
    got = countsketch_family(gvec, fam)
    again = countsketch_family(gvec, fam)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "countsketch: two launches on one Gaussian vector differ")
    check(torch.equal(countsketch(gvec, h, s, w), got), "countsketch: the pre-hashed form differs from the family form")
    del again
    plain = countsketch_ref(gvec, h, s, w)
    exact = countsketch_ref(gvec.double(), h, s, w, dtype=torch.float64)
    bound = rounding_bound(torch, countsketch_ref, gvec, h, w)
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    diff = float((got - plain).abs().max())
    check(bool(((got.double() - exact).abs() <= bound).all()), f"countsketch off the float64 sum by {err}")
    check(bool(((plain.double() - exact).abs() <= bound).all()), f"plain countsketch off by {plain_err}")
    pre = countsketch(gvec, h, s, w)
    check(bool(((pre.double() - exact).abs() <= bound).all()), "countsketch (pre-hashed) off the float64 sum")
    gtable = got
    del plain, exact, bound, pre

    # Device times are of all a call runs: the scratch's memset, the cell-max
    # pass, the sum and finalize.
    family = lambda: countsketch_family(gvec, fam)  # noqa: E731
    ms, dev_ms = time_ms(family, 20), device_ms(family, 20)
    sparse_ms = time_ms(lambda: countsketch_family(sparse, fam), 20)
    sparse_dev_ms = device_ms(lambda: countsketch_family(sparse, fam), 20)
    pre_ms = time_ms(lambda: countsketch(gvec, h, s, w), 20)
    pre_dev_ms = device_ms(lambda: countsketch(gvec, h, s, w), 20)
    plain_ms = time_ms(lambda: countsketch_ref(gvec, *hash_indices(fam, n), w), 3)
    flat = (torch.arange(d, device="cuda")[:, None] * w + h.long()).reshape(-1)
    vals = (s.float() * gvec[None, :]).reshape(-1)
    library = lambda: torch.zeros(d * w, device="cuda").index_add_(0, flat, vals)  # noqa: E731
    library_ms, library_dev_ms = time_ms(library, 10), device_ms(library, 10, "index")
    # The second launch's library call: index_add_ of its 4,096 nonzero values.
    nz = sparse.nonzero().squeeze(1)
    sp_flat = (torch.arange(d, device="cuda")[:, None] * w + h[:, nz].long()).reshape(-1)
    sp_vals = (s[:, nz].float() * sparse[None, nz]).reshape(-1)
    sparse_library = lambda: torch.zeros(d * w, device="cuda").index_add_(0, sp_flat, sp_vals)  # noqa: E731
    sparse_lib_ms, sparse_lib_dev = time_ms(sparse_library, 20), device_ms(sparse_library, 20, "index")
    del flat, vals, library, sp_flat, sp_vals, sparse_library
    bound_ms = countsketch_bound_bytes(n, d, w) / PEAK_BYTES_PER_S * 1e3
    sparse_bytes = n * 4 + d * w * 4  # the same bytes; the zeros are read and skipped
    print(
        f"[chip_smoke] countsketch family form d={d} w={w} n={n:,}: integer and sparse vectors bit-equal (family and "
        f"pre-hashed forms); Gaussian the same bits on a second launch and in the pre-hashed form, within the float32 "
        f"rounding bound (kernel off the float64 sum by {err:.3g}, "
        f"plain by {plain_err:.3g}, kernel off plain by {diff:.3g}); dense Gaussian: wrapper {ms:.4f} ms (device "
        f"{_fmt(dev_ms)}), bound {bound_ms:.5f} ms (4n + 4dw bytes); the step's second launch (a 4,096-sparse vector): "
        f"wrapper {sparse_ms:.4f} ms (device {_fmt(sparse_dev_ms)}), bound {sparse_bytes / PEAK_BYTES_PER_S * 1e3:.5f} "
        f"ms, index_add_ of its {nz.numel()} nonzero values {sparse_lib_ms:.4f} ms (device {_fmt(sparse_lib_dev)}); "
        f"pre-hashed form {pre_ms:.4f} ms (device {_fmt(pre_dev_ms)}, bound "
        f"{prehashed_bound_bytes(n, d, w) / PEAK_BYTES_PER_S * 1e3:.5f} ms); plain (hash + index_add_) "
        f"{plain_ms:.4f} ms; index_add_ on a precomputed flat index {library_ms:.4f} ms (device "
        f"{_fmt(library_dev_ms)})"
    )

    # Past the shared-memory limit the same kernel body takes global atomics.
    wide, n_wide = 1 << 17, 1 << 22
    fam_wide = make_hash_family(torch.Generator().manual_seed(2), d, wide, "cuda")
    hw, sw = hash_indices(fam_wide, n_wide)
    want = countsketch_ref(ivec[:n_wide], hw, sw, wide)
    check(torch.equal(countsketch_family(ivec[:n_wide], fam_wide), want)
          and torch.equal(countsketch(ivec[:n_wide], hw, sw, wide), want),
          f"countsketch differs from its plain version at width {wide}")
    wide_ms = device_ms(lambda: countsketch_family(gvec[:n_wide], fam_wide), 10)
    wide_bound_ms = countsketch_bound_bytes(n_wide, d, wide) / PEAK_BYTES_PER_S * 1e3
    flat = (torch.arange(d, device="cuda")[:, None] * wide + hw.long()).reshape(-1)
    vals = (sw.float() * gvec[None, :n_wide]).reshape(-1)
    wide_library = lambda: torch.zeros(d * wide, device="cuda").index_add_(0, flat, vals)  # noqa: E731
    wide_library_ms, wide_library_dev_ms = time_ms(wide_library, 10), device_ms(wide_library, 10, "index")
    del flat, vals, wide_library, hw, sw
    print(
        f"[chip_smoke] countsketch width {wide}, n={n_wide:,}: family and pre-hashed forms bit-equal; family form "
        f"device {_fmt(wide_ms)} (global atomics), bound {wide_bound_ms:.5f} ms, index_add_ {wide_library_ms:.4f} ms "
        f"(device {_fmt(wide_library_dev_ms)})"
    )
    cs_sass = sass_ops("countsketch", "countsketch_kernel|median_kernel|median_pair_kernel|median_any_depth_kernel",
                       "ATOMS|ATOMG|ATOM|RED")
    check("CAS" in cs_sass or "ATOMS" in cs_sass, f"no shared-memory atomic in the countsketch SASS: {cs_sass}")
    print(f"[chip_smoke] countsketch SASS: {cs_sass}")
    sketch_row = dict(
        name="countsketch", route="cuda", source="src/repro_torch/csrc/countsketch.cu",
        replaces="src/repro/kernels/countsketch/kernel.py:47", max_abs_err=diff, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
    )
    median_row = phase_countsketch_median(torch, gen, fam, h, s, itable, gtable)
    return [sketch_row, median_row]


def same_with_nan(torch, a, b) -> bool:
    """Equal values (``-0.0 == 0.0``, as ``torch.equal`` has it) and NaN in
    the same positions."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(torch.where(nan, 0.0, a), torch.where(b.isnan(), 0.0, b))


# The staged decode's device time at the 100m shape (d=5, w=16,384,
# n=65,020,416) on an NVIDIA H100 80GB HBM3 at 700 W, before the CTA-pair
# decode replaced it there; printed beside this run's reading.
STAGED_DECODE_MS = 0.9225


def phase_countsketch_median(torch, gen, fam, h, s, itable, gtable):
    """The decode kernel against its plain version (hash, gather, sign,
    median) on the integer and Gaussian tables of the sketch phase, at d=5
    and on their first 4 rows, and on the Gaussian table with NaN, +inf and
    -inf planted (the CTA-pair variant: the table on chip in a cluster of
    two CTAs); on an integer table of width 2^17 with NaN and inf planted,
    wider than a pair holds (the staged variant); each case names the
    variant its shape picks.  Its times beside its bound, the
    staged decode's earlier reading and the library path it replaces
    (gather, sort over d, midpoint; and torch.median for odd d)."""
    from repro_torch.core.hashing import HashFamily, make_hash_family
    from repro_torch.kernels.countsketch.ops import countsketch_median, median_variant
    from repro_torch.kernels.countsketch.ref import countsketch_median_ref

    d, w, n = CS_DEPTH, CS_WIDTH, GRAD_100M
    fam4 = HashFamily.from_host(fam.a_host[:4], fam.b_host[:4], w, "cuda")
    planted = gtable.clone()
    cells = torch.randperm(d * w, generator=gen, device="cuda")[:9]
    planted.view(-1)[cells[:3]] = float("nan")
    planted.view(-1)[cells[3:6]] = float("inf")
    planted.view(-1)[cells[6:]] = float("-inf")
    wide, n_wide = 1 << 17, 1 << 22
    fam_wide = make_hash_family(torch.Generator().manual_seed(3), d, wide, "cuda")
    wide_table = torch.randint(-50, 51, (d, wide), generator=gen, device="cuda").float()
    spots = torch.randperm(d * wide, generator=gen, device="cuda")[:3]
    wide_table.view(-1)[spots] = torch.tensor([float("nan"), float("inf"), float("-inf")], device="cuda")
    cases = (
        ("integer table d=5", itable, fam, n),
        ("integer table d=4", itable[:4].contiguous(), fam4, n),
        ("Gaussian table d=5", gtable, fam, n),
        ("Gaussian table d=4", gtable[:4].contiguous(), fam4, n),
        ("NaN/inf planted d=5", planted, fam, n),
        ("NaN/inf planted d=4", planted[:4].contiguous(), fam4, n),
        (f"NaN/inf planted d=5 w={wide}", wide_table, fam_wide, n_wide),
    )
    n_nan, variants, err = {}, {}, 0.0
    for name, table, family, length in cases:
        got, want = countsketch_median(table, family, length), countsketch_median_ref(table, family, length)
        torch.cuda.synchronize()
        check(same_with_nan(torch, got, want), f"countsketch_median differs from its plain version on the {name}")
        n_nan[name] = int(want.isnan().sum())
        variants[name] = median_variant(*table.shape)
        finite = got.isfinite() & want.isfinite()
        err = max(err, float((got[finite] - want[finite]).abs().max()))
    check(n_nan["NaN/inf planted d=5"] > 0 and n_nan[cases[-1][0]] > 0, "no NaN estimate from a planted table")
    check(variants["integer table d=5"] == "CTA pair" and variants[cases[-1][0]] == "staged",
          f"the decode variants by shape are not the CTA pair and the staged kernel: {variants}")
    del got, want
    wide_ms = device_ms(lambda: countsketch_median(wide_table, fam_wide, n_wide), 10, "median")
    del wide_table

    decode = lambda: countsketch_median(gtable, fam, n)  # noqa: E731
    ms, dev_ms = time_ms(decode, 20), device_ms(decode, 20, "median")
    ms4 = device_ms(lambda: countsketch_median(gtable[:4].contiguous(), fam4, n), 20, "median")
    plain_ms = time_ms(lambda: countsketch_median_ref(gtable, fam, n), 3)
    # The path it replaces, on precomputed hashes: gather, sign, sort over d,
    # midpoint; and torch.median over d (odd d: the same value).
    hl, sf = h.long(), s.float()
    mid = (d - 1) // 2, d // 2

    def library():
        srt = (torch.gather(gtable, 1, hl) * sf).sort(dim=0).values
        return (srt[mid[0]] + srt[mid[1]]) * 0.5

    library_ms, library_dev_ms = time_ms(library, 3), device_ms(library, 3)
    median = lambda: torch.median(torch.gather(gtable, 1, hl) * sf, dim=0).values  # noqa: E731
    median_ms = time_ms(median, 3)
    check(torch.equal(library(), countsketch_median(gtable, fam, n)), "the library path differs from the decode")
    del hl, sf
    bound_ms = (4 * n + 4 * d * w) / PEAK_BYTES_PER_S * 1e3
    share = f", {100 * bound_ms / dev_ms:.1f}% of the bound" if dev_ms else ""
    print(
        f"[chip_smoke] countsketch_median d={d} w={w} n={n:,}: equal to its plain version, NaN positions included, "
        f"on {len(cases)} tables ({', '.join(f'{k}: {v} NaN' for k, v in n_nan.items())}); wrapper {ms:.4f} ms "
        f"(device {_fmt(dev_ms)}{share}; the staged decode's earlier reading {STAGED_DECODE_MS:.4f} ms; d=4 device "
        f"{_fmt(ms4)}), bound {bound_ms:.5f} ms (4n + 4dw bytes); width {wide}, n={n_wide:,}: device "
        f"{_fmt(wide_ms)}; plain (hash, gather, sort) {plain_ms:.4f} ms; library path on precomputed hashes "
        f"(gather + sort(dim=0) + midpoint) {library_ms:.4f} ms (device {_fmt(library_dev_ms)}), gather + "
        f"torch.median(dim=0) {median_ms:.4f} ms"
    )
    print("[chip_smoke] countsketch_median variants by shape: "
          + "; ".join(f"{k}: {v}" for k, v in variants.items()))
    return dict(
        name="countsketch_median", route="cuda", source="src/repro_torch/csrc/countsketch.cu",
        replaces="src/repro/train/compression.py:64", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
    )


def countsketch_bound_bytes(n: int, d: int, w: int) -> int:
    """The family form: each element's value read once, the float32 table
    written once (the hashes are computed, not read)."""
    return 4 * n + 4 * d * w


def prehashed_bound_bytes(n: int, d: int, w: int) -> int:
    """The pre-hashed form: each element's value, its d int32 buckets and d
    int8 signs read once; the float32 table written once."""
    return n * (4 + 4 * d + 1 * d) + d * w * 4


def rounding_bound(torch, countsketch_ref, vec, h, w):
    """Per cell, gamma_(m-1) * sum|x| with gamma_k = k*u / (1 - k*u) and
    u = 2^-24: how far a float32 sum of the cell's m terms may lie from the
    exact sum, in any order of summation."""
    ones = torch.ones_like(h, dtype=torch.int8)
    mass = countsketch_ref(vec.abs().double(), h, ones, w, dtype=torch.float64)
    terms = countsketch_ref(torch.ones_like(vec, dtype=torch.float64), h, ones, w, dtype=torch.float64)
    ku = (terms - 1).clamp(min=0) * 2.0**-24
    return ku / (1 - ku) * mass


def phase_train(torch, drive):
    """The training path: the 100m preset, compressed, at full width on the
    card (countsketch launched twice a step, its decode once), one profiled
    step, one step's operators (no sort, no hashing over n) and peak memory,
    one round trip of the state it leaves on the card against the CPU, round
    trips with non-finite gradients on the card against the CPU, and the
    tiny preset on the card against the CPU."""
    import numpy as np

    from repro_torch.launch import train_lm

    t0 = time.time()
    run = drive(("countsketch", "countsketch_median"), lambda: train_lm.main(TRAIN_100M))
    train_s = time.time() - t0
    hist = run.result.history
    losses = [h["loss"] for h in hist]
    steps = len(hist)
    check(steps == flag(TRAIN_100M, "--steps"), f"100m: {steps} steps")
    check(all(np.isfinite(losses)), f"100m: non-finite loss in {losses}")
    state = run.result.state
    seen_before, seen_after = replay_losses(torch, state["params"], steps, losses[0])
    check(seen_after < seen_before,
          f"100m: mean loss over the run's {steps} batches {seen_after} at the final parameters, "
          f"not below {seen_before} at the initial ones")
    n = state["comp"].error.shape[0]
    check(n == GRAD_100M, f"100m: flat gradient of {n} elements, expected {GRAD_100M}")
    step_ms = [1e3 * h["duration_s"] for h in hist]
    print(
        f"[chip_smoke] train 100m compressed: {steps} steps in {train_s:.1f} s (set-up included); step loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; mean loss over the run's batches {seen_before:.6f} at the initial "
        f"parameters -> {seen_after:.6f} at the final ones; step median {float(np.median(step_ms)):.1f} ms "
        f"(host wall clock; steps {', '.join(f'{t:.1f}' for t in step_ms)} ms); n={n:,}"
    )
    profile_step(torch, run)
    check_step_ops(torch, run)
    check_roundtrip_cpu(torch, run)
    del run, state
    torch.cuda.empty_cache()
    check_roundtrip_nonfinite(torch)
    torch.cuda.empty_cache()

    # The tiny preset (float32) on the card and on the CPU: the same batches
    # from the same initial state.  Gradients agree to ~1e-6 relative (float32
    # products summed in other orders, TF32 off), and a top-k selection can
    # flip a coordinate within rounding of the threshold, which moves one
    # parameter by about the learning rate: the losses agree to rtol 1e-4.
    cuda_losses = [h["loss"] for h in train_lm.main(TRAIN_TINY).result.history]
    cpu_losses = [h["loss"] for h in train_lm.main(TRAIN_TINY + ["--device", "cpu"]).result.history]
    check(np.allclose(cuda_losses, cpu_losses, rtol=1e-4, atol=0),
          f"tiny: card losses {cuda_losses} vs CPU {cpu_losses}")
    print(f"[chip_smoke] train tiny compressed, 5 steps: card and CPU losses agree to rtol 1e-4 "
          f"(max rel diff {max(abs(a - b) / abs(b) for a, b in zip(cuda_losses, cpu_losses)):.3g})")


def replay_losses(torch, params, steps, first_loss):
    """Mean loss over the ``steps`` batches of the 100m run at its initial
    parameters and at ``params``.  Per-step losses are each taken on another
    batch, and over ten warm-up steps (learning rate at most 5e-4) their
    batch-to-batch spread (about 0.06) hides the progress; the same batches
    before and after show it.  The batches and the initial parameters are
    drawn again as ``launch/train_lm.py`` and ``train_loop`` draw them; the
    first batch's loss at the initial parameters must equal the run's first
    step loss, which shows the replay is faithful."""
    import numpy as np

    from repro_torch.data.lm import MarkovTokens
    from repro_torch.launch.train_lm import PRESETS
    from repro_torch.models import transformer as tfm

    cfg = PRESETS["100m"]
    batch, seq = flag(TRAIN_100M, "--batch"), flag(TRAIN_100M, "--seq")
    gen, rng = MarkovTokens(cfg.vocab, seed=0), np.random.default_rng(0)
    seen = [torch.as_tensor(gen.batch(batch, seq + 1, rng)).cuda() for _ in range(steps)]
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    with torch.no_grad():
        before = [float(tfm.loss_fn(cfg, init, t)[0]) for t in seen]
        after = [float(tfm.loss_fn(cfg, params, t)[0]) for t in seen]
    check(abs(before[0] - first_loss) <= 1e-5 * abs(first_loss),
          f"100m replay: first batch's loss {before[0]} at the initial parameters, the run's was {first_loss}")
    return float(np.mean(before)), float(np.mean(after))


def profile_step(torch, run):
    """One more compressed 100m step under the profiler (CUDA activity
    only): device time by kernel and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    batch = {k: torch.as_tensor(v).cuda() for k, v in next(run.batches).items()}
    state = run.result.state
    run.step(state, batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, metrics = run.step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_kernel = sorted(
        ((getattr(e, "device_time_total", 0.0) / 1e3, e.count, e.key) for e in prof.key_averages()),
        reverse=True,
    )
    busy_ms = sum(t for t, _, _ in by_kernel)
    print(
        f"[chip_smoke] train 100m one profiled step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%, profiler on)"
    )
    for t, k, key in by_kernel[:12]:
        print(f"[chip_smoke]   {t:10.3f} ms  x{k:<5d} {key[:100]}")


def check_step_ops(torch, run):
    """One more compressed 100m step under the profiler with CPU activity,
    the compressor's round trip marked by a ``record_function`` range: the
    round trip runs no sort of any kind (no sort operator or kernel) and no
    int64 hashing over n (``hash_indices`` not called, no
    ``aten::remainder`` or ``aten::bitwise_and``); the step's other sort
    kernels are all the model backward's (the token embedding's gradient
    sorts the batch's token ids); and the step's peak allocation above what
    was allocated before it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train import compression as comp

    batch = {k: torch.as_tensor(v).cuda() for k, v in next(run.batches).items()}
    state = run.result.state
    calls = []
    real_hash, real_roundtrip = comp.hash_indices, comp.roundtrip

    def roundtrip(*args, **kwargs):
        with record_function("compression.roundtrip"):
            return real_roundtrip(*args, **kwargs)

    comp.hash_indices = lambda *args: calls.append(args) or real_hash(*args)
    comp.roundtrip = roundtrip
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, metrics = run.step(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        comp.hash_indices, comp.roundtrip = real_hash, real_roundtrip

    def chain(evt, step):
        while evt is not None:
            yield evt
            evt = step(evt)

    def descendants(evt):
        todo = [evt]
        while todo:
            e = todo.pop()
            yield e
            todo.extend(e.cpu_children)

    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    marks = {e.device_type: e for e in events if e.name == "compression.roundtrip"}
    check(set(marks) == {cpu, cuda}, f"100m step: round-trip ranges on {sorted(map(str, marks))}")
    # Its operators: those under the CPU range; its kernels: those that ran
    # within the device range (one stream, so nothing else runs there).
    ops = {e.name for e in descendants(marks[cpu])}
    span = marks[cuda].time_range
    device = [e for e in events if e.device_type == cuda and e.name != "compression.roundtrip"]
    kernels = [e.name for e in device if span.start <= e.time_range.start and e.time_range.end <= span.end]
    check(not calls, f"100m step: hash_indices called {len(calls)} times on the card")
    sorts = sorted({k for k in kernels if "sort" in k.lower()} | {o for o in ops if "sort" in o})
    check(not sorts, f"100m step: the round trip sorted: {sorts}")
    hashing = sorted(o for o in ops if o in ("aten::remainder", "aten::bitwise_and"))
    check(not hashing, f"100m step: the round trip hashed over n: {hashing}")
    n_sketch = sum("countsketch_kernel" in k for k in kernels)
    n_decode = sum("median_" in k for k in kernels)
    check((n_sketch, n_decode) == (2, 1), f"100m step: {n_sketch} sketch and {n_decode} decode kernels in the round trip")
    # Every other sort kernel of the step is the model's backward: the token
    # embedding's gradient (index_put_ with accumulation sorts the batch's
    # 512 token ids).
    step_sorts = [(k.name, [a.name for a in chain(e, lambda x: x.cpu_parent)])
                  for e in events if e.device_type == cpu for k in e.kernels if "sort" in k.name.lower()]
    all_sorts = [e.name for e in device if "sort" in e.name.lower()]
    elsewhere = [(k, names) for k, names in step_sorts if not any("Backward" in a for a in names)]
    check(not elsewhere and len(step_sorts) == len(all_sorts),
          f"100m step: a sort outside the model's backward: {elsewhere or all_sorts}")
    launchers = sorted({next(a for a in names if "Backward" in a) + " > " + names[0] for _, names in step_sorts})
    print(
        f"[chip_smoke] train 100m step operators: the round trip ran {len(kernels)} kernels, {n_sketch} sketch and "
        f"{n_decode} decode, no sort, no hash_indices, no remainder or bitwise_and; the step's other sort kernels are "
        f"the model backward's ({len(step_sorts)}, launched by {'; '.join(launchers)}); "
        f"peak allocation during the step {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before it"
    )


def check_roundtrip_nonfinite(torch):
    """Round trips with non-finite gradients on the card (the kernels)
    against the CPU (the plain versions): the 100m compressor's shape (d=5,
    w=16,384, top-k 4,096) over 2^21 coordinates with sketch momentum off,
    so every cell is an integer sum and the two sides must agree bit for
    bit, NaN positions included.  One NaN and one inf leave fewer than k NaN
    estimates (by the reference's rule they count as the largest, and the
    rest of the k places go to the largest finite ones); 24 NaNs leave more
    than k (the threshold is NaN: nothing is selected)."""
    import numpy as np

    from repro_torch.train import compression as comp

    n = 1 << 21
    cfg = comp.CompressorConfig(depth=CS_DEPTH, width=CS_WIDTH, top_k=4096, momentum=0.0)
    cases = (("one NaN and one inf", [7], [11]), ("24 NaNs", list(range(3, 3 + 5 * 24, 5)), []))
    out = []
    for label, nans, infs in cases:
        card = comp.init_compressor(cfg, n, torch.Generator().manual_seed(3), "cuda")
        host = comp.init_compressor(cfg, n, torch.Generator().manual_seed(3), "cpu")
        rng = np.random.default_rng(4)
        selected = []
        for _ in range(3):
            g = rng.integers(-20, 21, n).astype(np.float32)
            g[nans], g[infs] = np.nan, np.inf
            up_card, card = comp.roundtrip(card, torch.from_numpy(g).cuda())
            up_host, host = comp.roundtrip(host, torch.from_numpy(g))
            for what, a, b in (("update", up_card, up_host), ("error", card.error, host.error),
                               ("momentum", card.momentum, host.momentum)):
                check(same_with_nan(torch, a.cpu(), b), f"non-finite round trip ({label}): {what} differs from the CPU")
            selected.append(int((up_host != 0).sum()))
        nan_error = int(host.error.isnan().sum())
        out.append(f"{label}: selected {selected} over 3 round trips, {nan_error} NaN in the error")
        if nans == [7]:
            # The NaN estimates take the first places of the top k.
            check(all(0 < k < cfg.top_k for k in selected), f"{label}: selected {selected}")
        else:
            check(selected == [0, 0, 0], f"{label}: selected {selected}, expected none (NaN threshold)")
    print(f"[chip_smoke] non-finite round trips, card against CPU, bit-equal with NaN positions: {'; '.join(out)}")


def check_roundtrip_cpu(torch, run):
    """One round trip of the 100m run's compressor state on the card (the
    CountSketch kernel) and on the CPU (the plain versions), on the gradient
    of the next batch."""
    import dataclasses

    from repro_torch.kernels.countsketch.ops import hash_indices
    from repro_torch.kernels.countsketch.ref import countsketch_ref
    from repro_torch.train import compression as comp
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.models import transformer as tfm
    from repro_torch.launch.train_lm import PRESETS

    state = run.result.state
    cfg = PRESETS["100m"]
    tokens = torch.as_tensor(next(run.batches)["tokens"]).cuda()
    _, grads = value_and_grad(lambda p, t: tfm.loss_fn(cfg, p, t), state["params"], tokens)
    flat, _ = comp.flatten_grads(grads)
    del grads
    card = state["comp"]
    host = dataclasses.replace(card, error=card.error.cpu(), momentum=card.momentum.cpu(), hash=card.hash.to("cpu"))
    t0 = time.time()
    up_card, new_card = comp.roundtrip(card, flat)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    t0 = time.time()
    up_host, new_host = comp.roundtrip(host, flat.cpu())
    host_s = time.time() - t0

    # The first sketch of the round trip on both sides, and the float32
    # rounding bound of its cells (the CPU sums in index order, the card in
    # any order).
    corrected = flat + card.error
    h, s = hash_indices(card.hash, flat.shape[0])
    w = card.config.width
    t_card = comp._sketch(card, corrected, (h, s))
    t_host = comp._sketch(host, corrected.cpu())
    bound = 2 * rounding_bound(torch, countsketch_ref, corrected, h, w)
    tab_err = (t_card.double() - t_host.cuda().double()).abs()
    check(bool((tab_err <= bound).all()), f"round trip: tables differ by {float(tab_err.max())}")
    # An estimate is a median of d cells, so it moves by at most the table's
    # largest difference; error and momentum move by at most twice that.
    tol = 2 * float(bound.max()) + 1e-12
    up_card = up_card.cpu()
    sel_card, sel_host = up_card != 0, up_host != 0
    flips = (sel_card != sel_host).nonzero().flatten()
    flip_mass = float(torch.maximum(up_card[flips].abs(), up_host[flips].abs()).max()) if flips.numel() else 0.0
    for upd, sel, other in ((up_card, sel_card, sel_host), (up_host, sel_host, sel_card)):
        thresh = float(upd[sel].abs().min())
        only = sel & ~other
        check(bool((upd[only].abs() <= thresh + 2 * tol).all()),
              "round trip: a coordinate selected on one side only lies away from the threshold")
    same = sel_card & sel_host
    check(torch.allclose(up_card[same], up_host[same], rtol=1e-6, atol=2 * tol), "round trip: updates differ")
    agree = sel_card == sel_host
    check(torch.allclose(new_card.error.cpu()[agree], new_host.error[agree], rtol=1e-6, atol=2 * tol),
          "round trip: error feedback differs")
    # A flipped coordinate enters d momentum cells on one side only.
    check(torch.allclose(new_card.momentum.cpu(), new_host.momentum, rtol=1e-6, atol=4 * tol + flip_mass),
          "round trip: sketch momentum differs")
    err_diff = float((new_card.error.cpu()[agree] - new_host.error[agree]).abs().max())
    mom_diff = float((new_card.momentum.cpu() - new_host.momentum).abs().max())
    print(
        f"[chip_smoke] round trip of the 100m state: card {1e3 * card_s:.1f} ms, CPU {host_s:.1f} s; tables "
        f"within the float32 bound (max diff {float(tab_err.max()):.3g}, bound up to {float(bound.max()):.3g}); "
        f"{int(sel_card.sum())} vs {int(sel_host.sum())} selected, {flips.numel()} near-threshold flips; "
        f"error max diff {err_diff:.3g}, momentum max diff {mom_diff:.3g} (tolerance {2 * tol:.3g})"
    )


def _same_results(ev_a, ev_b) -> bool:
    import numpy as np

    if (ev_a.tick, ev_a.epoch, ev_a.alarm) != (ev_b.tick, ev_b.epoch, ev_b.alarm):
        return False
    for ra, rb in zip(ev_a.results, ev_b.results, strict=True):
        va = ra.value if isinstance(ra.value, tuple) else (ra.value,)
        vb = rb.value if isinstance(rb.value, tuple) else (rb.value,)
        if not all(np.array_equal(x, y) for x, y in zip(va, vb, strict=True)):
            return False
    return True


def timed_run(torch, fn):
    """(session, events, host wall seconds) of one serve run."""
    t0 = time.time()
    stream, _, events = fn()
    torch.cuda.synchronize()
    return stream, events, time.time() - t0


def run_fused(serve, argv):
    """serve.run on the parsed ``argv`` with the session in fused mode (the
    serve CLI offers no ``fused`` choice, as in the reference)."""
    args = serve.build_parser().parse_args(argv)
    args.ingest_backend = "fused"
    return serve.run(args)


def check_same(torch, a, ev_a, b, ev_b, label):
    """Two runs must leave the same counters, registers and transcript."""
    ka, kb = a._live(), b._live()
    for name in ("counters", "row_flows", "col_flows"):
        check(torch.equal(getattr(ka, name), getattr(kb, name)), f"{label}: {name} differ")
    check(bool(torch.isfinite(ka.counters).all()), f"{label}: non-finite counters")
    same_events(ev_a, ev_b, label)


def profile_serve(torch, serve, argv, label):
    """One more serve run under the profiler (CUDA activity only): device
    time by kernel and the device's busy share of the run's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        serve.main(argv)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_kernel = sorted(
        ((getattr(e, "device_time_total", 0.0) / 1e3, e.count, e.key) for e in prof.key_averages()),
        reverse=True,
    )
    busy_ms = sum(t for t, _, _ in by_kernel)
    print(
        f"[chip_smoke] {label} profiled: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%, profiler on)"
    )
    for t, n, key in by_kernel[:8]:
        print(f"[chip_smoke]   {t:10.3f} ms  x{n:<5d} {key[:100]}")


def profile_edge_tick(torch, session, argv, counted):
    """The serve workload's edge family (1,024 queries, drawn as
    ``launch/serve.py`` draws them) through the session's engine on its live
    sketch, as a tick runs it: the answer against the plain version, one B2
    launch, the tick's CUDA kernels from the profiler, and no cast of the
    buckets (no copy kernel, no ``aten::_to_copy`` or ``aten::copy_``)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import queries
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.data.graphs import edge_stream

    n = flag(argv, "--nodes")
    rng = np.random.default_rng(0)
    edge_stream(n, flag(argv, "--edges"), rng, zipf_a=1.2)  # serve.run's draws, in order
    qs = keys_to_tensor(rng.integers(0, n, 1024).astype(np.uint32), "cuda")
    qd = keys_to_tensor(rng.integers(0, n, 1024).astype(np.uint32), "cuda")
    live = session._live()
    tick = lambda: session.engine.edge(live, qs, qd)  # noqa: E731
    before = counted["edge_query_min"].launches
    est = tick()
    check(counted["edge_query_min"].launches == before + 1, "edge tick: B2 not launched once")
    check(torch.equal(est, queries.edge_query(live, qs, qd)), "edge tick: differs from the plain edge query")
    torch.cuda.synchronize()
    for _ in range(3):  # now and then a trace comes back without its kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_preroll(torch)
            tick()
            torch.cuda.synchronize()
        kernels = [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0.0) > 0 and "spin_kernel" not in e.key]
        if any("multi_query_min_kernel" in k for k, _, _ in kernels):
            break
    check(any("multi_query_min_kernel" in k for k, _, _ in kernels), f"edge tick: no B2 kernel in the trace: {kernels}")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tick()
        torch.cuda.synchronize()
    ops = sorted({e.key for e in prof.key_averages()})
    casts = [k for k, _, _ in kernels if "copy_kernel" in k]
    casts += [o for o in ops if o in ("aten::_to_copy", "aten::copy_")]
    print(f"[chip_smoke] serve BASE edge tick (Q=1,024): {sum(c for _, c, _ in kernels)} kernels, "
          f"no bucket cast; aten ops: {', '.join(ops)}")
    for key, count, us in kernels:
        print(f"[chip_smoke]   {us / 1e3:10.4f} ms  x{count:<3d} {key[:110]}")
    check(not casts, f"edge tick: a cast of the buckets ran: {casts}")


def profile_ingest_batch(torch, session, counted, fused: bool):
    """One ingest batch of a serve BASE session on its live sketch, as the
    session folds serve BASE's first batch in (pre-aggregated pairs and
    marginals, padded, on the card): the sketch-level update of the kernels
    run (B1, ``update_preaggregated_``) or of the fused run (B4,
    ``update_fused_``), its kernel launched once, its CUDA kernels from the
    profiler, and its aten ops with their dtypes: no cast of the int64
    buckets to int32 and no fill of the bitmap (no fill kernel, no
    ``zeros``/``fill_``/``zero_``)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.ingest import pad_bucket, preaggregate_host
    from repro_torch.data.graphs import edge_stream

    class AtenLog(TorchDispatchMode):
        """Every aten op a call dispatches, with its tensors' dtypes."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            flat = [*args, *(kwargs or {}).values(), *(out if isinstance(out, (tuple, list)) else [out])]
            self.ops.append((str(func.overloadpacket), [t.dtype for t in flat if isinstance(t, torch.Tensor)]))
            return out

    data = edge_stream(flag(SERVE_BASE, "--nodes"), flag(SERVE_BASE, "--edges"), np.random.default_rng(0), zipf_a=1.2)
    b = flag(SERVE_BASE, "--batch")
    pre = preaggregate_host(data["src"][:b], data["dst"][:b], data["weight"][:b])
    live = session._live()
    keys = lambda x: keys_to_tensor(pad_bucket(x), "cuda")  # noqa: E731
    vals = lambda x: torch.from_numpy(pad_bucket(x)).cuda()  # noqa: E731
    marginals = None
    if fused:
        name, kernel, label = "fused_ingest", "fused_ingest_kernel", "fused serve BASE"
        args = (keys(pre.src), keys(pre.dst), vals(pre.weights))
        batch = lambda: live.update_fused_(*args)  # noqa: E731
    else:
        name, kernel, label = "ingest_keys", "ingest_kernel", "serve BASE"
        args = (keys(pre.src), keys(pre.dst), vals(pre.weights), keys(pre.src_unique), vals(pre.src_totals),
                keys(pre.dst_unique), vals(pre.dst_totals))
        batch = lambda: live.update_preaggregated_(*args, backend=session.ingest_backend)  # noqa: E731
        marginals = lambda: live.update_marginals_(*args[3:])  # noqa: E731
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in counted.items()}
    with AtenLog() as log:
        batch()
        torch.cuda.synchronize()
    launched = {k: f.launches - before[k] for k, f in counted.items() if f.launches != before[k]}
    check(launched == {name: 1}, f"{label} ingest batch: launches {launched}, not {name} once")

    def trace(fn):
        for _ in range(3):  # now and then a trace comes back without its kernels
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                trace_preroll(torch)
                fn()
                torch.cuda.synchronize()
            found = [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
                     if getattr(e, "device_time_total", 0.0) > 0 and "spin_kernel" not in e.key]
            if fn is marginals or any(kernel in k for k, _, _ in found):
                return found
        return found

    kernels = trace(batch)
    check(any(kernel in k for k, _, _ in kernels), f"{label} ingest batch: no {kernel} in the trace: {kernels}")
    if marginals is not None:
        # The counter side is the batch's kernels less the register side's.
        n_batch, n_registers = sum(c for _, c, _ in kernels), sum(c for _, c, _ in trace(marginals))
        check(n_batch - n_registers == 1, f"{label} ingest batch: {n_batch - n_registers} counter-side kernels "
              f"({n_batch} in the batch, {n_registers} on the register side), not 1")
        print(f"[chip_smoke] {label} ingest batch: the counter side {n_batch - n_registers} kernel (ingest_keys, "
              f"hashing in the kernel; 13 before: 12 of the hash, 1 scatter), the register side {n_registers}")
    narrow = (torch.int32, torch.int16, torch.int8, torch.uint8, torch.float32, torch.float64)
    casts = [(op, dt) for op, dt in log.ops if op in ("aten._to_copy", "aten.copy_", "aten.to")
             and torch.int64 in dt and any(t in narrow for t in dt)]
    fills = [(op, dt) for op, dt in log.ops if op in ("aten.zeros", "aten.fill_", "aten.zero_", "aten.full", "aten.new_zeros")]
    fills += [(k, c) for k, c, _ in kernels if "fill" in k.lower()]
    check(not casts, f"{label} ingest batch: a cast of the buckets ran: {casts}")
    check(not fills, f"{label} ingest batch: a fill ran: {fills}")
    print(f"[chip_smoke] {label} ingest batch ({pre.n_pairs} pairs): {sum(c for _, c, _ in kernels)} kernels, "
          f"no bucket cast, no fill; aten ops: {', '.join(sorted({op for op, _ in log.ops}))}")
    for key, count, us in kernels:
        print(f"[chip_smoke]   {us / 1e3:10.4f} ms  x{count:<3d} {key[:110]}")


# Edges of the sequential phase's bit-for-bit check against the plain loop
# (about five launches an edge; the loop runs once over the whole batch, timed).
SEQ_PLAIN_EDGES = 2_000


def conservative_floor(torch, start, family, src, dst, wts):
    """Cellwise lower bound of a conservative update of ``start`` by the batch:
    every distinct pair p raises each of its d cells to at least
    ``min_i start[i, cell_i(p)] + f(p)``, f(p) the pair's exact total weight
    (numpy); a cell no pair touches keeps its value."""
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.ingest import preaggregate_host
    from repro_torch.kernels.query.ref import edge_query_min_ref

    pre = preaggregate_host(src, dst, wts)
    r, c = family(keys_to_tensor(pre.src, "cuda")), family(keys_to_tensor(pre.dst, "cuda"))
    d, w, _ = start.shape
    vals = edge_query_min_ref(start, r, c) + torch.from_numpy(pre.weights).cuda()
    flat = (torch.arange(d, device="cuda")[:, None] * w + r) * w + c
    floor = start.clone()
    floor.view(-1).scatter_reduce_(0, flat.reshape(-1), vals.expand(d, -1).reshape(-1), reduce="amax")
    return floor


def once_ms(torch, fn) -> float:
    """Milliseconds of one call between two CUDA events (no warm-up: for the
    plain loop, whose every launch is already warm)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_sequential(torch, gen):
    """The port-only sequential kernel on serve BASE's first batch of 50,000
    edges as they arrive (not aggregated; int64 buckets from the BASE family
    and their int32 copy), both modes, on an empty sketch and on one that
    already holds the batch: bit-equal to the plain loop on the first 2,000
    edges; over all 50,000, sequential mode bit-equal to B1's scatter and
    conservative mode between the cellwise floor and the vanilla counters;
    the plain loop once over the whole batch, bit-equal.  Times by CUDA
    events and the profiler, the plain loop's per edge, and the chain's
    floor: the same batch with every edge on one cell."""
    from repro_torch.kernels.ingest.ops import ingest_scatter
    from repro_torch.kernels.sequential.ops import sequential_update
    from repro_torch.kernels.sequential.ref import sequential_update_ref

    d, w = BASE_DEPTH, BASE_WIDTH
    (src, dst, wts_np), family, rows, cols, wts = serve_raw_batch(torch)
    b = rows.shape[1]
    empty = torch.zeros((d, w, w), device="cuda")
    held = ingest_scatter(empty.clone(), rows, cols, wts)
    head = SEQ_PLAIN_EDGES
    err = 0.0
    for label, start in (("empty", empty), ("holding a batch", held)):
        floor = conservative_floor(torch, start, family, src, dst, wts_np)
        vanilla = ingest_scatter(start.clone(), rows, cols, wts)
        for idx in (torch.int64, torch.int32):
            r, c = rows.to(idx), cols.to(idx)
            rh, ch, wh = r[:, :head].contiguous(), c[:, :head].contiguous(), wts[:head].contiguous()
            for conservative in (False, True):
                mode = "conservative" if conservative else "sequential"
                got = sequential_update(start.clone(), rh, ch, wh, conservative)
                want = sequential_update_ref(start.clone(), rh, ch, wh, conservative)
                err = max(err, float((got - want).abs().max()))
                check(torch.equal(got, want), f"sequential_update {mode} {idx} {label}: differs from the plain loop")
                del got, want
            seq = sequential_update(start.clone(), r, c, wts, False)
            check(torch.equal(seq, vanilla), f"sequential_update {idx} {label}: differs from ingest_scatter")
            del seq
            cu = sequential_update(start.clone(), r, c, wts, True)
            check(bool((cu <= vanilla).all()), f"conservative {idx} {label}: above the vanilla counters")
            check(bool((cu >= floor).all()), f"conservative {idx} {label}: below the cellwise floor")
            del cu
        del floor, vanilla
        torch.cuda.empty_cache()
    # The plain loop once over the whole batch, timed, against the kernel.
    want = held.clone()
    plain_ms = once_ms(torch, lambda: sequential_update_ref(want, rows, cols, wts, True))
    got = sequential_update(held.clone(), rows, cols, wts, True)
    check(torch.equal(got, want), "conservative: differs from the plain loop over the whole batch")
    del got, want
    work = held
    rows32, cols32 = rows.int(), cols.int()
    ms = time_ms(lambda: sequential_update(work, rows, cols, wts, True), 5)
    ms32 = time_ms(lambda: sequential_update(work, rows32, cols32, wts, True), 5)
    seq_ms = time_ms(lambda: sequential_update(work, rows, cols, wts, False), 5)
    dev_ms = device_ms(lambda: sequential_update(work, rows, cols, wts, True), 3, "sequential_update_kernel")
    seq_dev = device_ms(lambda: sequential_update(work, rows, cols, wts, False), 3, "sequential_update_kernel")
    one = torch.zeros_like(rows)
    chain_ms = time_ms(lambda: sequential_update(work, one, one, wts, True), 3)
    chain_dev = device_ms(lambda: sequential_update(work, one, one, wts, True), 3, "sequential_update_kernel")
    bound_ms = (8 * d * b + 2 * d * b * rows.element_size() + 4 * b) / PEAK_BYTES_PER_S * 1e3
    print(
        f"[chip_smoke] sequential d={d} w={w} B={b} (serve BASE's first batch as it arrives, int64 and int32, "
        f"both modes, empty and holding a batch): bit-equal to the plain loop on {head} edges and over the whole "
        f"batch (conservative, int64), sequential bit-equal to ingest_scatter, conservative between its floor and "
        f"vanilla; conservative wrapper {ms:.4f} ms (int32 {ms32:.4f}), device {_fmt(dev_ms)}; sequential "
        f"wrapper {seq_ms:.4f} ms, device {_fmt(seq_dev)}; {1e6 * ms / b:.1f} ns an edge; chain floor (every "
        f"edge on one cell, conservative) {chain_ms:.4f} ms, device {_fmt(chain_dev)}, {1e6 * chain_ms / b:.1f} ns "
        f"an edge; plain loop {plain_ms:.1f} ms, {1e3 * plain_ms / b:.1f} us an edge; bound {bound_ms:.6f} ms "
        f"(bytes: each cell read and written once, the buckets and weights read once)"
    )
    return dict(
        name="sequential_update", route="cuda", source="src/repro_torch/csrc/sequential.cu",
        replaces="src/repro/core/sketch.py:420", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=None,
    )


# The baselines at equal space to BASE: a 1-D row as wide as a BASE sketch
# (8,192² counters), d=5; gSketch's partitions sampled from the first 5,000
# sources (benchmarks/bench_accuracy.py:124-145 sizes them so).
BASELINE_WIDTH = BASE_WIDTH * BASE_WIDTH
GSKETCH_PARTITIONS, GSKETCH_SAMPLE = 8, 5_000


def pagerank64(torch, counters, damping: float = 0.85, iters: int = 32):
    """``queries.sketch_pagerank``'s algorithm in float64 (the yardstick)."""
    m = counters.double()
    out = m.sum(dim=2, keepdim=True)
    p = torch.where(out > 0, m / out.clamp_min(1e-9), torch.zeros((), dtype=m.dtype, device=m.device))
    w = m.shape[-1]
    rank = torch.full((m.shape[0], 1, w), 1.0 / w, dtype=m.dtype, device=m.device)
    for _ in range(iters):
        step = torch.bmm(rank, p)
        rank = damping * step + (1.0 - damping * step.sum(-1, keepdim=True)) / w
    return rank[:, 0, :]


def analytics_base(torch, serve):
    """The analytics path at BASE: one serve BASE session on the kernels,
    then on its live sketch every ported query-plane function beyond the
    served families, the two order-dependent updates on the session's first
    batch (one ``sequential_update`` launch each), and the four baselines at
    equal space fed the session's 500,000 edges.  Checks each against an
    independent computation (float64 on the card, numpy counts, a closure
    kernel launch) and prints its time on the card.  Returns the number of
    order-dependent update calls made."""
    import numpy as np

    from repro_torch.core import queries, reach
    from repro_torch.core.hashing import keys_to_tensor, mix_keys
    from repro_torch.core.ingest import preaggregate_host
    from repro_torch.core.sketch import CountMin, CountSketch, GSketch, NodeCountMin
    from repro_torch.data.graphs import edge_stream
    from repro_torch.kernels.closure.ops import closure_step

    check(torch.backends.cuda.matmul.allow_tf32 is False and torch.get_float32_matmul_precision() == "highest",
          "analytics: TF32 is on for float32 products")
    sess, _, _ = serve.main(SERVE_BASE)
    live = sess._live()
    d, w = BASE_DEPTH, BASE_WIDTH
    nodes, b = flag(SERVE_BASE, "--nodes"), flag(SERVE_BASE, "--batch")
    data = edge_stream(nodes, flag(SERVE_BASE, "--edges"), np.random.default_rng(0), zipf_a=1.2)
    keys = lambda x: keys_to_tensor(x, "cuda")  # noqa: E731
    times = {}

    def timed(name, fn, reps=3):
        out = fn()
        times[name] = time_ms(fn, reps)
        return out

    rng = np.random.default_rng(21)
    qs, qd = keys(rng.integers(0, nodes, 1024).astype(np.uint32)), keys(rng.integers(0, nodes, 1024).astype(np.uint32))
    total = float(data["weight"].sum())
    forms = {"(x, y)": (qs, qd), "(x, *)": (qs, None), "(*, y)": (None, qd), "(*, *)": (None, None)}
    want = {"(x, y)": queries.edge_query(live, qs, qd), "(x, *)": queries.node_out_flow(live, qs),
            "(*, y)": queries.node_in_flow(live, qd), "(*, *)": torch.tensor([total], device="cuda")}
    for form, args in forms.items():
        got = timed(f"wildcard {form}", lambda: queries.wildcard_edge_query(live, *args), 20)
        check(torch.equal(got, want[form]), f"analytics: wildcard {form} differs")

    bw = timed("bound_wildcard_path2", lambda: queries.bound_wildcard_path2(live, qd, qs))
    hb, hc = live.col_hash(qd), live.row_hash(qs)
    d_idx = torch.arange(d, device="cuda")[:, None]
    m64 = live.counters.double()
    bw64 = (m64[d_idx, :, hb] * m64[d_idx, hc, :]).sum(-1).amin(dim=0)
    check(bool(torch.isfinite(bw).all()) and torch.allclose(bw.double(), bw64, rtol=1e-4, atol=0),
          "analytics: bound_wildcard_path2 differs from float64")

    hot = np.argsort(np.bincount(data["src"], minlength=nodes))[::-1][:16].astype(np.uint32)
    triples = rng.choice(hot, (256, 3)).astype(np.uint32)
    ta, tb, tc = (keys(triples[:, j]) for j in range(3))
    tri = timed("triangle_query x256", lambda: torch.stack(
        [queries.triangle_query(live, ta[i], tb[i], tc[i]) for i in range(256)]), 1)
    batch = queries.subgraph_query_batch(live, torch.stack([ta, tb, tc], 1), torch.stack([tb, tc, ta], 1),
                                         torch.ones((256, 3), dtype=torch.bool, device="cuda"))
    check(torch.equal(tri, batch), "analytics: triangle_query differs from subgraph_query_batch")

    gt = timed("global_triangle_estimate", lambda: queries.global_triangle_estimate(live))
    gt64 = (torch.bmm(m64, m64) * m64.transpose(1, 2)).sum(dim=(1, 2)).amin()
    check(bool(torch.isclose(gt.double(), gt64, rtol=1e-4, atol=0)),
          f"analytics: global_triangle_estimate {float(gt)} vs float64 {float(gt64)}")
    del m64, bw64, gt64
    torch.cuda.empty_cache()

    pr = timed("sketch_pagerank", lambda: queries.sketch_pagerank(live))
    check(float((pr.sum(dim=1) - 1).abs().max()) <= 1e-5, "analytics: PageRank rows do not sum to 1")
    check(torch.allclose(pr.double(), pagerank64(torch, live.counters), rtol=1e-4, atol=0),
          "analytics: sketch_pagerank differs from float64")
    check(np.array_equal(sess.pagerank(), pr.cpu().numpy()), "analytics: GraphStream.pagerank differs")
    times["GraphStream.pagerank"] = time_ms(sess.pagerank, 3)

    hops = [timed(f"k_hop_reach k={k}", lambda: reach.k_hop_reach(live.counters, k)) for k in (1, 2, 3)]
    eye = torch.eye(w, dtype=torch.bool, device="cuda")
    check(torch.equal(hops[0], (live.counters > 0) | eye), "analytics: k_hop_reach k=1 differs from (a > 0) | I")
    a = hops[0].view(torch.uint8)
    step, _ = closure_step(a, a.transpose(1, 2).contiguous())
    check(torch.equal(hops[1], step.view(torch.bool)), "analytics: k_hop_reach k=2 differs from one closure_step")
    check(bool((hops[1] <= hops[2]).all()), "analytics: k_hop_reach k=3 lost a pair of k=2")
    reached = [int(h.sum()) for h in hops]
    del hops, a, step, eye
    torch.cuda.empty_cache()

    theta = 0.001 * total
    rows_hh, cols_hh = timed("heavy_hitter_buckets", lambda: queries.heavy_hitter_buckets(live, theta), 20)
    check(torch.equal(cols_hh, live.col_flows > theta) and torch.equal(rows_hh, live.row_flows > theta),
          "analytics: heavy_hitter_buckets differ from the registers")
    in_deg = np.bincount(data["dst"], weights=data["weight"], minlength=nodes)
    watch = np.uint32(np.argmax(in_deg))
    check(bool(cols_hh[d_idx[:, 0], live.col_hash(keys(np.atleast_1d(watch)))[:, 0]].all()),
          "analytics: the hottest destination's buckets are not flagged")

    s1, d1, w1 = keys(data["src"][:b]), keys(data["dst"][:b]), torch.from_numpy(data["weight"][:b]).cuda()
    vanilla = live.update(s1, d1, w1)
    inflow = float(queries.node_in_flow(live, keys(np.atleast_1d(watch)))[0])
    hits = float(data["weight"][:b][data["dst"][:b] == watch].sum())
    key = torch.tensor(int(watch), device="cuda")
    for theta_m, want_alarm in ((inflow + hits - 1, True), (inflow + hits, False)):
        alarm, new = queries.monitor_step(live, s1, d1, w1, key, theta_m)
        check(bool(alarm) == want_alarm, f"analytics: monitor_step alarm {bool(alarm)} at theta {theta_m}")
        check(torch.equal(new.counters, vanilla.counters), "analytics: monitor_step's sketch differs from update")
        del new
    times["monitor_step"] = time_ms(lambda: queries.monitor_step(live, s1, d1, w1, key, inflow), 3)

    # The order-dependent updates: two calls each (checked, then timed), one
    # sequential_update launch a call.
    seq = live.update_sequential(s1, d1, w1)
    for name in ("counters", "row_flows", "col_flows"):
        check(torch.equal(getattr(seq, name), getattr(vanilla, name)), f"analytics: update_sequential {name} differs")
    del seq
    times["update_sequential"] = once_ms(torch, lambda: live.update_sequential(s1, d1, w1))
    cu = live.update_conservative(s1, d1, w1)
    check(bool((cu.counters <= vanilla.counters).all() and (cu.counters >= live.counters).all()),
          "analytics: update_conservative outside [live, vanilla]")
    check(torch.equal(cu.row_flows, cu.counters.sum(dim=2)), "analytics: update_conservative's registers")
    del cu, vanilla
    times["update_conservative"] = once_ms(torch, lambda: live.update_conservative(s1, d1, w1))
    update_calls = 4
    torch.cuda.empty_cache()

    # The baselines at equal space, fed the session's 500,000 edges.
    W = BASELINE_WIDTH
    base = {
        "CountMin": CountMin.empty(d, W, 1, "cuda"),
        "NodeCountMin": NodeCountMin.empty(d, W, 4, "cuda"),
        "CountSketch": CountSketch.empty(d, W, 3, "cuda"),
        "GSketch": GSketch.from_sample(d, W, GSKETCH_PARTITIONS, data["src"][:GSKETCH_SAMPLE], 2, "cuda"),
    }
    n = data["src"].size
    batches = [(keys(data["src"][i:i + b]), keys(data["dst"][i:i + b]), torch.from_numpy(data["weight"][i:i + b]).cuda())
               for i in range(0, n, b)]
    feed = {
        "CountMin": lambda s, t, x: base["CountMin"].update_(s, t, x),
        "NodeCountMin": lambda s, t, x: base["NodeCountMin"].update_(s, t, x),
        "CountSketch": lambda s, t, x: base["CountSketch"].update_(mix_keys(s, t), x),
        "GSketch": lambda s, t, x: base["GSketch"].update_(s, t, x),
    }
    for name, fn in feed.items():
        times[f"{name} ingest (500,000 edges)"] = once_ms(torch, lambda: [fn(*bt) for bt in batches])
    pre = preaggregate_host(data["src"], data["dst"], data["weight"])
    ps, pd, pw = keys(pre.src), keys(pre.dst), torch.from_numpy(pre.weights).cuda()
    est = {"CountMin": base["CountMin"].edge_query(ps, pd), "GSketch": base["GSketch"].edge_query(ps, pd)}
    for name, e in est.items():
        check(bool((e >= pw).all()), f"analytics: {name} under-estimates an edge")
    ncm = base["NodeCountMin"]
    check(bool((ncm.out_flow(keys(pre.src_unique)) >= torch.from_numpy(pre.src_totals).cuda()).all()
               and (ncm.in_flow(keys(pre.dst_unique)) >= torch.from_numpy(pre.dst_totals).cuda()).all()),
          "analytics: NodeCountMin under-estimates a flow")
    cs = base["CountSketch"]
    pk = mix_keys(ps, pd)
    row_err = torch.gather(cs.counters, 1, cs.hash(pk)) * cs.hash.signs(pk).float() - pw
    check(bool((row_err > 0).any() and (row_err < 0).any()), "analytics: CountSketch's row errors take one sign")
    med_err = cs.query(pk) - pw
    gb = sum(t.numel() * 4 for t in (base["CountMin"].counters, ncm.counters_out, ncm.counters_in, cs.counters,
                                     base["GSketch"].partitions.counters)) / 1e9
    print(
        f"[chip_smoke] analytics BASE: TF32 off; wildcard (4 forms, 1,024 keys) equal to the served families and "
        f"(*, *) to the stream's total {total:.0f}; bound_wildcard_path2 (1,024 pairs) and global triangle "
        f"{float(gt):.6g} within rtol 1e-4 of float64; 256 triangle queries equal subgraph_query_batch "
        f"({int((tri > 0).sum())} positive); PageRank rows sum to 1 within 1e-5, within rtol 1e-4 of float64, "
        f"GraphStream.pagerank equal; k_hop_reach k=1,2,3 reach {reached} pairs, k=2 equal to one closure_step; "
        f"heavy buckets at theta {theta:.0f}: {int(rows_hh.sum())} rows, {int(cols_hh.sum())} columns; "
        f"monitor_step alarms at theta {inflow + hits - 1:.0f}, not at {inflow + hits:.0f}; update_sequential "
        f"equal to update, update_conservative between live and vanilla"
    )
    print(
        f"[chip_smoke] analytics BASE baselines at equal space (d={d}, {W:,} a row; gSketch widths "
        f"{base['GSketch'].widths.tolist()}; {gb:.2f} GB): on {pre.n_pairs} distinct pairs CountMin, GSketch and "
        f"NodeCountMin never under-estimate; CountSketch row errors of both signs ({int((row_err > 0).sum())} "
        f"above, {int((row_err < 0).sum())} below), median errors nonzero on {int((med_err != 0).sum())} pairs"
    )
    print("[chip_smoke] analytics BASE times on the card (CUDA events, ms a call): "
          + "; ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return update_calls


def check_small_analytics(torch, gs_cuda, gs_cpu, argv):
    """Every function of the analytics path on the small session's summary,
    on the card against the CPU: bit-equal, but for the global triangle
    estimate and PageRank (float32 sums in another order, rtol 1e-5)."""
    import numpy as np

    from repro_torch.core import queries, reach
    from repro_torch.core.hashing import keys_to_tensor, mix_keys
    from repro_torch.core.ingest import preaggregate_edges
    from repro_torch.core.sketch import CountMin, CountSketch, GSketch, NodeCountMin
    from repro_torch.data.graphs import edge_stream

    nodes = flag(argv, "--nodes")
    data = edge_stream(nodes, flag(argv, "--edges"), np.random.default_rng(0), zipf_a=1.2)
    rng = np.random.default_rng(5)
    qs_np, qd_np = rng.integers(0, nodes, 256).astype(np.uint32), rng.integers(0, nodes, 256).astype(np.uint32)
    b = flag(argv, "--batch")
    width = flag(argv, "--width")
    watch = np.uint32(np.argmax(np.bincount(data["dst"], minlength=nodes)))

    def run(gs, dev):
        live = gs._live()
        k = lambda x: keys_to_tensor(x, dev)  # noqa: E731
        qs, qd = k(qs_np), k(qd_np)
        s1, d1, w1 = k(data["src"][:b]), k(data["dst"][:b]), torch.from_numpy(data["weight"][:b]).to(dev)
        out = {f"wildcard {i}": queries.wildcard_edge_query(live, *args)
               for i, args in enumerate(((qs, qd), (qs, None), (None, qd), (None, None)))}
        out["bound_wildcard_path2"] = queries.bound_wildcard_path2(live, qd, qs)
        out["triangle_query"] = torch.stack([queries.triangle_query(live, qs[i], qd[i], qs[i + 1]) for i in range(32)])
        out["global_triangle_estimate"] = queries.global_triangle_estimate(live)
        out["sketch_pagerank"] = queries.sketch_pagerank(live)
        out["GraphStream.pagerank"] = torch.from_numpy(gs.pagerank())
        for hop in (0, 1, 2, 3):
            out[f"k_hop_reach {hop}"] = reach.k_hop_reach(live.counters, hop)
        out["heavy rows"], out["heavy cols"] = queries.heavy_hitter_buckets(live, 50.0)
        alarm, new = queries.monitor_step(live, s1, d1, w1, torch.tensor(int(watch), device=dev), 100.0)
        out["monitor alarm"], out["monitor counters"] = alarm, new.counters
        out["update_sequential"] = live.update_sequential(s1, d1, w1).counters
        out["update_conservative"] = live.update_conservative(s1, d1, w1).counters
        out["preaggregate_edges"] = torch.cat([x.reshape(-1).double() for x in preaggregate_edges(s1, d1, w1, 1024)])
        cm = CountMin.empty(3, width * width, 1, dev).update_(s1, d1, w1)
        ncm = NodeCountMin.empty(3, width * width, 4, dev).update_(s1, d1, w1)
        cs = CountSketch.empty(4, width * width, 3, dev).update_(mix_keys(s1, d1), w1)
        gsk = GSketch.from_sample(3, width * width, 8, data["src"][:5000], 2, dev).update_(s1, d1, w1)
        out["CountMin"], out["GSketch"] = cm.edge_query(qs, qd), gsk.edge_query(qs, qd)
        out["NodeCountMin"] = torch.stack([ncm.out_flow(qs), ncm.in_flow(qd)])
        out["CountSketch"] = cs.query(mix_keys(qs, qd))
        return {name: t.cpu() for name, t in out.items()}

    card, host = run(gs_cuda, "cuda"), run(gs_cpu, "cpu")
    for name, want in host.items():
        got = card[name]
        if name in ("global_triangle_estimate", "sketch_pagerank", "GraphStream.pagerank"):
            same = got.shape == want.shape and torch.allclose(got, want, rtol=1e-5, atol=0)
        else:
            same = got.dtype == want.dtype and torch.equal(got, want)
        check(same, f"small session: {name} differs between the card and the CPU")
    print(f"[chip_smoke] small session: {len(host)} analytics results (queries, PageRank, k-hop, monitor, "
          f"sequential and conservative updates, preaggregate_edges, four baselines) equal on the card and the "
          f"CPU (global triangle and PageRank within rtol 1e-5)")


# The durable window serve BASE cell: serve BASE's traffic with event time
# (one slice of event time a batch, each edge lagging by up to --max-lateness)
# through a ring of 4 slices (lead 1 slice), logged to a WAL.
EVENT_TIME = ["--window-slices", "4", "--slice-width", "1.0", "--max-lateness", "1.0"]
SERVE_WINDOW = SERVE_BASE + EVENT_TIME
SMALL = ["--depth", "3", "--width", "256", "--nodes", "2000", "--edges", "20000", "--batch", "5000"]


def eventtime_launches(ts_batches, k: int, width: float, lateness: float) -> int:
    """The ingest-kernel launches an event-time session on a ring of ``k``
    slices makes for these batches of event times (directed sketch, retract
    policy, one source): one per distinct slice a batch's edges land in
    after the late ones are clamped to the oldest live slice, plus one per
    batch holding late edges (their retraction).  Counted on the host from
    the timestamps alone, by the watermark rule the session documents."""
    import math

    import numpy as np

    lead = math.ceil(lateness / width)
    seen_max = watermark = -math.inf
    head = None
    launches = 0
    for ts in ts_batches:
        promised = watermark
        seen_max = max(seen_max, float(ts.max()))
        watermark = max(watermark, seen_max - lateness)
        b = np.floor_divide(ts, width).astype(np.int64)
        late = ts < promised
        target = math.floor(watermark / width) + lead
        if not late.all():
            target = max(target, int(b[~late].max()))
        head = target if head is None else max(head, target)
        floor_slice = head - k + 1
        late |= b < floor_slice
        launches += len(np.unique(np.where(late, floor_slice, b))) + int(late.any())
    return launches


def same_window(torch, a, b, label, stats=True):
    """Two windowed event-time sessions hold the same ring, tracker and epoch
    (and, with ``stats``, the same count of auto-advances: a restored session
    starts its stats afresh)."""
    for name in ("slices", "row_flows", "col_flows"):
        check(torch.equal(getattr(a._window, name).cpu(), getattr(b._window, name).cpu()), f"{label}: {name} differ")
    check(a._window.current == b._window.current and a._head_slice == b._head_slice, f"{label}: ring positions differ")
    check(a._tracker.state() == b._tracker.state() and a.epoch == b.epoch, f"{label}: trackers or epochs differ")
    check(not stats or a.stats.auto_advances == b.stats.auto_advances, f"{label}: auto-advances differ")


def same_events(ev_a, ev_b, label):
    check(len(ev_a) == len(ev_b) and len(ev_a) > 0, f"{label}: {len(ev_a)} vs {len(ev_b)} events")
    check(all(_same_results(x, y) for x, y in zip(ev_a, ev_b)), f"{label}: subscription results differ")


def phase_durable_window(torch, serve, counted, rows):
    """The durable window serve BASE cell and its checks: (a) the windowed
    event-time serve on the kernels and on the plain backends, plus one late
    batch; (b) genesis replay of its WAL; (c) checkpoint plus WAL suffix on a
    plain BASE session; (d) the small durable windowed session, card against
    CPU; (e) the trainer's resume on the card."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-durable-"))
    try:
        kern, kev, launches = window_serve(torch, serve, counted, tmp)
        # The bucket entry's main path: one launch a (batch, slot) group.
        rows["ingest_scatter"]["launches"] = launches["ingest_scatter"]
        window_replay(torch, serve, kern, kev, tmp)
        window_times(torch, serve, kern, tmp)
        del kern, kev
        torch.cuda.empty_cache()
        checkpoint_suffix(torch, serve, tmp)
        torch.cuda.empty_cache()
        small_durable(torch, serve, tmp)
        trainer_resume(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def window_serve(torch, serve, counted, tmp):
    """(a) ``serve.main(SERVE_WINDOW + --wal-dir)`` on the kernels (counts
    from this run only) and on the plain backends, each followed by serve
    BASE's first batch sent again at event time 0 (below the watermark:
    every edge late, retracted); the two must be identical, and the ingest
    kernel must launch once per (batch, slot) group plus once per
    retraction."""
    import numpy as np

    from repro_torch.kernels.closure.ops import closure_steps

    args = serve.build_parser().parse_args(SERVE_WINDOW)
    data, ts_all, _ = serve.traffic(args)
    b, n = args.batch, args.edges
    late = (data["src"][:b], data["dst"][:b], data["weight"][:b])

    def run(argv):
        t0 = time.time()
        stream, sub, events = serve.main(argv)
        stream.ingest(*late, timestamps=np.zeros(b))
        events = events + sub.poll()
        torch.cuda.synchronize()
        return stream, events, time.time() - t0

    for f in counted.values():
        f.launches = 0
    kern, kev, kern_s = run(SERVE_WINDOW + ["--wal-dir", str(tmp / "wal-kernels")])
    launches = {name: counted[name].launches for name in ("ingest_scatter", "edge_query_min", "closure_step")}
    for name, count in launches.items():
        check(count > 0, f"durable window serve BASE: {name} was not launched")
    check(counted["ingest_keys"].launches == 0, "durable window serve BASE: a slot group took the key entry")
    plain, pev, plain_s = run(SERVE_WINDOW + PLAIN_BACKENDS + ["--wal-dir", str(tmp / "wal-plain")])
    same_window(torch, kern, plain, "durable window serve BASE vs plain")
    same_events(kev, pev, "durable window serve BASE vs plain")
    batches = [ts_all[lo:lo + b] for lo in range(0, n, b)] + [np.zeros(b)]
    want = eventtime_launches(batches, flag(EVENT_TIME, "--window-slices"), 1.0, 1.0)
    check(launches["ingest_scatter"] == want,
          f"durable window serve BASE: {launches['ingest_scatter']} ingest launches, the host counts {want} "
          f"(batch, slot) groups and retractions")
    check(kern.late_retracted == b and kern.late_dropped == 0,
          f"durable window serve BASE: {kern.late_retracted} retracted, {kern.late_dropped} dropped")
    check(launches["closure_step"] == kern.engine.closure_refreshes * closure_steps(BASE_WIDTH),
          f"durable window serve BASE: {launches['closure_step']} closure launches")
    check(launches["edge_query_min"] == len(kev), f"durable window serve BASE: {launches['edge_query_min']} edge-query "
          f"launches for {len(kev)} ticks")
    print(
        f"[chip_smoke] durable window serve BASE (K=4, slice 1.0, lateness 1.0, WAL, then the first batch again "
        f"at event time 0): kernels {kern_s:.3f} s, plain {plain_s:.3f} s (host wall clock); {len(kev)} ticks, "
        f"{kern.stats.auto_advances} auto-advances, watermark {kern.watermark}, {kern.late_retracted} retracted; "
        f"launches: ingest_scatter {launches['ingest_scatter']} (host count of groups and retractions {want}), "
        f"edge_query_min {launches['edge_query_min']}, closure_step {launches['closure_step']} "
        f"({kern.engine.closure_refreshes} full rebuilds); the window materialized {kern.window_sums} times; "
        f"ring, registers, tracker and transcript identical to the plain run"
    )
    return kern, kev, launches


def window_replay(torch, serve, kern, kev, tmp):
    """(b) A fresh session with the same flags subscribes, seeks to 0 and
    recovers from the kernels run's WAL alone: bit-identical to (a)."""
    args = serve.build_parser().parse_args(SERVE_WINDOW + ["--wal-dir", str(tmp / "wal-kernels")])
    fresh = serve.open_stream(args)
    sub = fresh.subscribe(serve.traffic(args)[2], every=args.every, name="mixed-workload")
    sub.seek(0)
    t0 = time.time()
    report = fresh.recover()
    torch.cuda.synchronize()
    replay_s = time.time() - t0
    n_batches = -(-args.edges // args.batch)
    check(report.step is None and report.mutations_replayed == n_batches + 1,
          f"genesis replay: step {report.step}, {report.mutations_replayed} mutations")
    same_window(torch, fresh, kern, "genesis replay vs the live run")
    same_events(sub.poll(), kev, "genesis replay vs the live run")
    wal_mb = sum(p.stat().st_size for p in (tmp / "wal-kernels").glob("wal-*.seg")) / 1e6
    print(
        f"[chip_smoke] genesis replay of the durable window run: {report.mutations_replayed} mutations "
        f"({wal_mb:.2f} MB of WAL) in {replay_s:.3f} s (host wall clock); ring, registers, tracker and "
        f"transcript identical"
    )


def window_times(torch, serve, kern, tmp):
    """Times of the window's own operations at BASE, K=4 (CUDA events), one
    slot group's ingest kernel (profiler) and the WAL's appends (host
    clock), each beside its bound.  Run after the comparisons: it changes
    the ring."""
    import numpy as np

    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.ingest import pad_bucket
    from repro_torch.kernels.ingest.ops import ingest_scatter
    from repro_torch.stream.wal import RECORD_SIZE, WriteAheadLog

    win = kern._window
    k, d, wr, wc = win.slices.shape
    reg = d * (wr + wc) * 4
    sum_ms = time_ms(win.window_sketch, 10)
    sum_bound = ((k + 1) * d * wr * wc * 4 + (k + 1) * reg) / PEAK_BYTES_PER_S * 1e3
    adv_ms = time_ms(win.advance_, 20)
    adv_bound = (d * wr * wc * 4 + reg) / PEAK_BYTES_PER_S * 1e3
    # One slot group as the session hands it over: batch 2's edges of its
    # lower slice, padded, hashed into int64 buckets.
    args = serve.build_parser().parse_args(SERVE_WINDOW)
    data, ts_all, _ = serve.traffic(args)
    lo, hi = args.batch, 2 * args.batch
    ts = ts_all[lo:hi]
    group = np.floor_divide(ts, 1.0) == np.floor_divide(ts, 1.0).min()
    s, dd, w = (pad_bucket(x[lo:hi][group]) for x in (data["src"], data["dst"], data["weight"]))
    rows = win.template.row_hash(keys_to_tensor(s, "cuda"))
    cols = win.template.col_hash(keys_to_tensor(dd, "cuda"))
    wt = torch.from_numpy(w).cuda()
    slot = win.slices[win.current]
    group_add = lambda: ingest_scatter(slot, rows, cols, wt)  # noqa: E731
    grp_dev, grp_cold = device_ms(group_add, 20, "ingest_kernel"), cold_pair(group_add, "ingest_kernel")
    grp_bound = ingest_bound_bytes(rows, wt) / PEAK_BYTES_PER_S * 1e3
    grp_idx = (torch.arange(d, device="cuda")[:, None], rows, cols)
    grp_lib = lambda: slot.index_put_(grp_idx, wt.expand(d, -1), accumulate=True)  # noqa: E731
    lib_ms, lib_dev, lib_cold = time_ms(grp_lib, 20), device_ms(grp_lib, 20), cold_pair(grp_lib, None)
    wal = WriteAheadLog(tmp / "wal-timing")
    append_ms = []
    for a in range(0, args.edges, args.batch):
        b = a + args.batch
        t0 = time.perf_counter()
        wal.append_edges(data["src"][a:b], data["dst"][a:b], data["weight"][a:b], ts_all[a:b])
        append_ms.append((time.perf_counter() - t0) * 1e3)
    wal.close()
    print(
        f"[chip_smoke] durable window BASE times on the card (K={k}, d={d}, {wr}x{wc}): window_sketch "
        f"{sum_ms:.3f} ms a call (bound {sum_bound:.3f} ms, {100 * sum_bound / sum_ms:.1f}%), advance "
        f"{adv_ms:.3f} ms (bound {adv_bound:.3f} ms, {100 * adv_bound / adv_ms:.1f}%) by CUDA events; "
        f"one slot group's ingest kernel ({int(group.sum())} edges padded to {rows.shape[1]}) device "
        f"{_fmt(grp_dev)}, cold: {_cold(grp_cold)} (bound {grp_bound:.5f} ms), index_put_ on its buckets "
        f"{lib_ms:.4f} ms (device {_fmt(lib_dev)}; cold: {_cold(lib_cold)}); WAL append of a {args.batch}-edge batch "
        f"({(args.batch + 1) * RECORD_SIZE / 1e6:.2f} MB, fsync each) median {float(np.median(append_ms)):.2f} ms, "
        f"max {max(append_ms):.2f} ms (host clock)"
    )


def checkpoint_suffix(torch, serve, tmp):
    """(c) A plain BASE session with a WAL and checkpoints: 5 batches,
    checkpoint(), 5 more, the session dropped, then recover() in a fresh one:
    equal to the uninterrupted run.  Save, restore and recovery seconds and
    the checkpoint's bytes."""
    from repro_torch.api import GraphStream
    from repro_torch.configs.glava import BASE

    args = serve.build_parser().parse_args(SERVE_BASE)
    data, _, workload = serve.traffic(args)
    dirs = dict(wal_dir=str(tmp / "wal-ckpt"), checkpoint_dir=str(tmp / "ckpt"))

    def durable():
        gs = GraphStream.open(BASE, device="cuda", **dirs)
        return gs, gs.subscribe(workload, every=args.every, name="mixed-workload")

    gs, sub = durable()
    for i, lo in enumerate(range(0, args.edges, args.batch)):
        hi = lo + args.batch
        gs.ingest(data["src"][lo:hi], data["dst"][lo:hi], data["weight"][lo:hi])
        if i == 4:
            gs.flush()
            t0 = time.time()
            step = gs.checkpoint()
            save_s = time.time() - t0
    want = gs.sketch
    consumed = sub.ticks
    ckpt_bytes = sum(p.stat().st_size for p in (tmp / "ckpt" / f"step_{step:010d}").iterdir())
    del gs, sub
    torch.cuda.empty_cache()
    probe = GraphStream.open(BASE, device="cuda", checkpoint_dir=dirs["checkpoint_dir"])
    t0 = time.time()
    probe.restore()
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    del probe
    torch.cuda.empty_cache()
    gs, sub = durable()
    sub.seek(consumed)
    t0 = time.time()
    report = gs.recover()
    torch.cuda.synchronize()
    recover_s = time.time() - t0
    check(report.step == step and report.mutations_replayed == 5,
          f"checkpoint + suffix: step {report.step}, {report.mutations_replayed} mutations replayed")
    got = gs.sketch
    for name in ("counters", "row_flows", "col_flows"):
        check(torch.equal(getattr(got, name), getattr(want, name)), f"checkpoint + suffix: {name} differ")
    check(sub.ticks == consumed and sub.events_deduped == 1 and not sub.poll(),
          f"checkpoint + suffix: {sub.ticks} ticks, {sub.events_deduped} deduplicated")
    print(
        f"[chip_smoke] checkpoint + WAL suffix, plain BASE session: checkpoint at epoch {step} of "
        f"{ckpt_bytes / 1e9:.3f} GB saved in {save_s:.2f} s, restored in {restore_s:.2f} s, recovered "
        f"(restore + {report.mutations_replayed} batches replayed) in {recover_s:.2f} s (host wall clock); "
        f"counters and registers equal to the uninterrupted run, the replayed tick deduplicated"
    )


def small_durable(torch, serve, tmp):
    """(d) The small windowed, event-time, durable session on the card and
    on the CPU: identical; a checkpoint written from the card restores on the
    CPU, and the card's WAL replays there, with equal state."""
    from repro_torch.api import GraphStream
    from repro_torch.core.sketch import SketchConfig

    cfg = SketchConfig(depth=flag(SMALL, "--depth"), width_rows=flag(SMALL, "--width"), width_cols=flag(SMALL, "--width"))
    opts = dict(window_slices=4, slice_width=1.0, max_lateness=1.0)
    runs = {}
    for side, dev in (("card", "cuda"), ("host", "cpu")):
        args = serve.build_parser().parse_args(SMALL + EVENT_TIME + ["--device", dev])
        gs = GraphStream.open(cfg, device=dev, wal_dir=str(tmp / f"wal-small-{side}"),
                              checkpoint_dir=str(tmp / f"ckpt-small-{side}"), **opts)
        runs[side] = serve.drive(gs, args)
    (card, _, card_ev), (host, _, host_ev) = runs["card"], runs["host"]
    same_window(torch, card, host, "small durable session, card vs CPU")
    same_events(card_ev, host_ev, "small durable session, card vs CPU")
    step = card.checkpoint()
    back = GraphStream.open(cfg, seed=7, device="cpu", checkpoint_dir=str(tmp / "ckpt-small-card"), **opts)
    check(back.restore() == step, "small: the card's checkpoint did not restore on the CPU")
    same_window(torch, back, host, "small: card checkpoint restored on the CPU", stats=False)
    replay = GraphStream.open(cfg, device="cpu", wal_dir=str(tmp / "wal-small-card"), **opts)
    replay.recover()
    same_window(torch, replay, host, "small: card WAL replayed on the CPU")
    print(f"[chip_smoke] small durable windowed session: card and CPU identical ({card.stats.auto_advances} "
          f"auto-advances); the card's checkpoint restores and its WAL replays on the CPU with equal state")


def trainer_resume(torch, tmp):
    """(e) The tiny preset on the card, uncompressed and compressed: 12
    steps straight, then the same with a failure injected at step 11 and a
    resume from the step-10 checkpoint.  The resumed losses must equal the
    straight run's bit for bit (B7 sums in fixed point, so the compressed
    run repeats itself too)."""
    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.lm import MarkovTokens
    from repro_torch.launch.train_lm import COMPRESSOR, PRESETS
    from repro_torch.models import transformer as tfm
    from repro_torch.train import compression as comp
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves

    cfg = PRESETS["tiny"]
    steps, every, fail = 12, 5, 11
    gen, rng = MarkovTokens(cfg.vocab, seed=0), np.random.default_rng(0)
    batches = [{"tokens": gen.batch(8, 65, rng)} for _ in range(steps)]
    opt_cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)

    def loss_fn(params, batch):
        return tfm.loss_fn(cfg, params, batch["tokens"])

    def plain_step(state, batch):
        (loss, _), grads = trainer.value_and_grad(loss_fn, state["params"], batch)
        p, o, om = opt_mod.apply_adamw(opt_cfg, state["opt"], state["params"], grads)
        return {"params": p, "opt": o}, {"loss": loss, **om}

    for compressed in (False, True):
        def init_state(generator):
            params = tfm.init_params(cfg, generator, "cuda")
            state = {"params": params, "opt": opt_mod.init_adamw(opt_cfg, params)}
            if compressed:
                n = sum(x.numel() for x in tree_leaves(params))
                state["comp"] = comp.init_compressor(COMPRESSOR, n, torch.Generator().manual_seed(1), "cuda")
            return state

        step = trainer.compressed_data_parallel_step(loss_fn, opt_cfg, COMPRESSOR) if compressed else plain_step
        tag = "compressed" if compressed else "uncompressed"

        def config(name, **kw):
            return trainer.TrainerConfig(total_steps=steps, checkpoint_every=every, log_every=0,
                                         checkpoint_dir=str(tmp / f"train-{tag}-{name}"), **kw)

        straight = trainer.train_loop(init_state, step, iter(batches), config("straight"))
        try:
            trainer.train_loop(init_state, step, iter(batches), config("crashed", fail_at_step=fail))
            check(False, f"trainer {tag}: the injected failure did not fire")
        except RuntimeError as e:
            check("injected failure" in str(e), f"trainer {tag}: {e}")
        start = CheckpointManager(tmp / f"train-{tag}-crashed").latest_step()
        check(start == 10, f"trainer {tag}: latest checkpoint {start}, not 10")
        resumed = trainer.train_loop(init_state, step, iter(batches[start:]), config("crashed"))
        got = [h["loss"] for h in resumed.history]
        want = [h["loss"] for h in straight.history[start:]]
        check(resumed.resumed_from == start and len(got) == steps - start, f"trainer {tag}: resumed {got}")
        check(got == want, f"trainer {tag}: resumed losses {got} differ from the straight run's {want}")
        print(f"[chip_smoke] trainer resume on the card, tiny {tag}: failure at step {fail}, resumed from step "
              f"{start}; resumed losses {got} equal to the straight run's")


# -- the multi-tenant fleet ---------------------------------------------------------

# The serve BASE traffic tagged with zipf tenant ids, 16 BASE tenants resident
# (21.5 GB of counters, 80 planes: past 2^31 cells); the residency cell (6
# tenants through 4 slots, a batch each, the first back at the end); the
# windowed fleet (4 tenants, rings of 4 slices, 21.5 GB).
FLEET_TENANTS = 16
FLEET_BASE = SERVE_BASE + ["--tenants", str(FLEET_TENANTS)]
FLEET_RESIDENCY_ORDER = (0, 1, 2, 3, 4, 5, 0)
FLEET_WINDOW = SERVE_BASE + ["--tenants", "4", "--window-slices", "4"]
STACKED_NAMES = ("counters", "row_flows", "col_flows")


def release(torch) -> float:
    """Free what is no longer referenced, cycles included (a session and its
    subscriptions, a fleet and its tenant sessions refer to each other, so
    their tensors wait for the cycle collector), and return the GiB still
    allocated on the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def fleet_first_batch(torch):
    """Serve BASE's first batch routed to 16 tenants as the fleet hands it to
    the stacked kernel: the first ``--batch`` edges of the fleet traffic and
    their tenant ids, grouped by slot (a stable sort; tenant t holds slot t,
    as the fleet admits them), hashed by the BASE fleet's family (seed 0)
    into int64 buckets, the slot lane int32.  Returns ``(plane, rows, cols,
    weights)`` on the card."""
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.sketch import GLavaSketch
    from repro_torch.fleet import group_stream
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(FLEET_BASE)
    data, ids, _ = serve.fleet_traffic(args)
    b = args.batch
    slots, src, dst, wts, *_ = group_stream(
        ids[:b].astype("int32"), data["src"][:b], data["dst"][:b], data["weight"][:b]
    )
    row_hash, col_hash = GLavaSketch.hash_families(serve._config(args), 0, "cuda")
    rows, cols = row_hash(keys_to_tensor(src, "cuda")), col_hash(keys_to_tensor(dst, "cuda"))
    return torch.from_numpy(slots).cuda(), rows, cols, torch.from_numpy(wts).cuda()


def stacked_bound_bytes(torch, plane, rows, cols, wts, shape) -> int:
    """Bytes a stacked-ingest batch needs: a 32-byte sector read and written
    for every distinct counter and register sector its weighted valid slots
    add into, the (d, B) rows and columns, the (B,) plane and weights read
    once."""
    from repro_torch.kernels.ingest_stacked.ref import stacked_offsets

    d, b = rows.shape
    valid, *flats = stacked_offsets(tuple(shape), plane, rows, cols)
    adds = valid & (wts != 0)[None, :]
    sectors = sum(int(torch.unique(flat[adds] // 8).numel()) for flat in flats)
    return sectors * 64 + d * b * 2 * rows.element_size() + b * (plane.element_size() + wts.element_size())


# The one-thread-a-slot stacked ingest's device times on serve BASE's first
# batch routed to 16 tenants (warm, cold L2) on an NVIDIA H100 80GB HBM3 at
# 700 W, before the warp-aggregating kernel replaced it; printed beside this
# run's readings.
EARLIER_STACKED_MS = (0.0160, 0.0395)


def stacked_stress_batches(torch, plane, rows, cols, wts):
    """Batches of the length of (plane, rows, cols, wts) that defeat or
    stress the stacked kernel's warp aggregation: every slot in one row of
    plane 0 (its columns as given); every slot in one cell; one cell of planes
    0 and 1 alternating lane by lane (two groups a warp); one cell with
    weights that cancel in pairs (slot 2k + 1 takes -w[2k], so every group
    sums to 0)."""
    b = wts.shape[0]
    even = torch.arange(b, device=wts.device) % 2 == 0
    one_row, one_col = torch.full_like(rows, 7), torch.full_like(cols, 11)
    zero = torch.zeros_like(plane)
    return {
        "one row": (zero, one_row, cols, wts),
        "one cell": (zero, one_row, one_col, wts),
        "two tenants alternating on one cell": ((~even).to(plane.dtype), one_row, one_col, wts),
        "one cell, cancelling weights": (zero, one_row, one_col, torch.where(even, wts, -wts.roll(1))),
    }


def phase_stacked_ingest(torch, gen):
    """The port-only stacked ingest on the fleet's BASE stack (16 tenants,
    (80, 5, 8192, 8192), 64-bit offsets) and serve BASE's first batch routed
    to them: counters and both registers bit-equal to the plain version plane
    by plane; wrapper ms by CUDA events, host us, device ms beside the bound,
    with a cold L2, and the earlier design's readings; the plain version; the
    three ``index_put_`` on precomputed flat int64 offsets by device time;
    the SASS atomics; then four batches that stress the warp aggregation
    (``stacked_stress_batches``), each bit-equal to the plain version over
    the whole stack and timed."""
    from repro_torch.kernels.ingest_stacked.ops import stacked_ingest
    from repro_torch.kernels.ingest_stacked.ref import stacked_ingest_ref, stacked_offsets

    n, d, w = FLEET_TENANTS, BASE_DEPTH, BASE_WIDTH
    plane, rows, cols, wts = fleet_first_batch(torch)

    def stack():
        return (torch.zeros((n, d, w, w), device="cuda"), torch.zeros((n, d, w), device="cuda"),
                torch.zeros((n, d, w), device="cuda"))

    got = stacked_ingest(*stack(), plane, rows, cols, wts)
    want = stacked_ingest_ref(*stack(), plane, rows, cols, wts)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, x in zip(STACKED_NAMES, got, want):
        for p in range(n):
            err = max(err, float((g[p] - x[p]).abs().max()))
            check(torch.equal(g[p], x[p]), f"stacked ingest: {name} of plane {p} differs from its plain version")
    check(float(got[0][n - 1].sum()) > 0, "stacked ingest: the last plane (past 2^31 cells) got nothing")
    del want
    release(torch)
    call = lambda: stacked_ingest(*got, plane, rows, cols, wts)  # noqa: E731
    ms, host = time_ms(call, INGEST_REPS), host_us(call)
    dev = device_ms(call, 20, "ingest_stacked_kernel")
    cold = cold_device_ms(call, "ingest_stacked_kernel")
    plain_ms = time_ms(lambda: stacked_ingest_ref(*got, plane, rows, cols, wts), 20)
    valid, *flats = stacked_offsets(tuple(got[0].shape), plane, rows, cols)
    vals = torch.where(valid, wts[None, :], torch.zeros((), device="cuda")).reshape(-1)
    idx = [(flat.reshape(-1),) for flat in flats]

    def library():
        for t, i in zip(got, idx):
            t.view(-1).index_put_(i, vals, accumulate=True)

    library_ms, library_dev = time_ms(library, 20), device_ms(library, 20)
    bound = stacked_bound_bytes(torch, plane, rows, cols, wts, got[0].shape) / PEAK_BYTES_PER_S * 1e3
    sass = sass_ops("ingest_stacked", "ingest_stacked_kernel", "RED|ATOM")
    check("RED" in sass and "ATOM" not in sass, f"ingest_stacked_kernel: the adds are not all RED: {sass}")
    print(
        f"[chip_smoke] stacked ingest, serve BASE's first batch routed to {n} tenants ({wts.shape[0]} edges, "
        f"int64 buckets, int32 slots) into the ({n}, {d}, {w}, {w}) stack ({got[0].numel():,} cells): all three "
        f"outputs bit-equal plane by plane; wrapper {ms:.4f} ms, host {host:.3f} us/call, device {_fmt(dev)}"
        + (f" ({100 * bound / dev:.1f}% of the bound)" if dev else "")
        + f", with a cold L2 {_fmt(cold)}; bound {bound:.5f} ms; plain {plain_ms:.4f} ms; three index_put_ on "
        f"precomputed int64 offsets {library_ms:.4f} ms, device {_fmt(library_dev)}"
    )
    print(f"[chip_smoke] ingest_stacked SASS: {sass}")
    stress = {}
    for label, batch in stacked_stress_batches(torch, plane, rows, cols, wts).items():
        for t in got:
            t.zero_()
        stacked_ingest(*got, *batch)
        want = stacked_ingest_ref(*stack(), *batch)
        torch.cuda.synchronize()
        for name, g, x in zip(STACKED_NAMES, got, want):
            check(torch.equal(g, x), f"stacked ingest: {name} differs from its plain version on the {label} batch")
        del want
        release(torch)
        stress[label] = device_ms(lambda: stacked_ingest(*got, *batch), 20, "ingest_stacked_kernel")
    print(
        f"[chip_smoke] stacked ingest: the earlier one-thread-a-slot kernel read {EARLIER_STACKED_MS[0]:.4f} ms warm, "
        f"{EARLIER_STACKED_MS[1]:.4f} ms with a cold L2 on this batch; stress batches of {wts.shape[0]} slots, all "
        "three outputs bit-equal over the whole stack, device: "
        + "; ".join(f"{k} {_fmt(v)}" for k, v in stress.items())
    )
    del got
    release(torch)
    return dict(
        name="ingest_stacked", route="cuda", source="src/repro_torch/csrc/ingest_stacked.cu",
        replaces="src/repro/core/sketch.py:120", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", library_ms=library_ms,
    )


def preagg_bound_bytes(n: int, n_pairs: int, depth: int, n_src: int, n_dst: int, wr: int, mirror: bool) -> int:
    """Bytes the batch collapse must move, whatever its design: the (3, B)
    batch read once; the distinct pairs written for B1 (two int64 keys, a
    float32 weight); a 32-byte sector read and written per register add (d a
    distinct source and destination, twice mirrored); the (d, w_r) bitmap
    written.  The tables' sweep is the design's and is left out."""
    adds = depth * (n_src + n_dst) * (2 if mirror else 1)
    return 12 * n + 20 * n_pairs + adds * 64 + depth * wr


def phase_preagg(torch, gen):
    """The port-only batch collapse of a card session (``kernels/preagg``)
    on serve BASE's first batch as the session copies it (50,000 raw edges,
    packed (3, B) int32), directed and mirrored: the distinct pairs, both
    registers and the bitmap against the plain version, the tables empty
    after each call; wrapper ms by CUDA events, host us, device ms of both
    launches beside the bound; the plain version; and the host collapse it
    replaces, ``preaggregate_host``, on the host clock."""
    import numpy as np

    from repro_torch.core.ingest import preaggregate_host
    from repro_torch.kernels.preagg import ops as preagg_ops
    from repro_torch.kernels.preagg.ref import preagg_collapse_ref

    (src, dst, wts), family, *_ = serve_raw_batch(torch)
    d, w, n = BASE_DEPTH, BASE_WIDTH, src.shape[0]
    batch = torch.from_numpy(np.stack([src, dst, wts.view(np.uint32)]).view(np.int32)).cuda()
    pre = preaggregate_host(src, dst, wts)
    tables = preagg_ops.CollapseTables()
    out = {}
    for mirror in (False, True):
        state = [torch.zeros((d, w), device="cuda") for _ in range(4)]
        touched = [torch.empty((d, w), dtype=torch.bool, device="cuda") for _ in range(2)]
        got = preagg_ops.preagg_collapse(batch, state[0], state[1], touched[0], family, family, mirror, tables)
        want = preagg_collapse_ref(batch, state[2], state[3], touched[1], family, family, mirror, got[0].shape[0])
        torch.cuda.synchronize()
        keys = [((s << 32) | t)[x != 0] for s, t, x in (got, want)]
        orders = [torch.argsort(k) for k in keys]
        check(int(keys[0].numel()) == pre.n_pairs and torch.equal(keys[0][orders[0]], keys[1][orders[1]]),
              f"preagg (mirror={mirror}): the pairs differ from the plain version's")
        check(torch.equal(got[2][got[2] != 0][orders[0]], want[2][want[2] != 0][orders[1]]),
              f"preagg (mirror={mirror}): the pair sums differ from the plain version's")
        for name, g, x in (("row_flows", state[0], state[2]), ("col_flows", state[1], state[3]),
                           ("touched", *touched)):
            check(torch.equal(g, x), f"preagg (mirror={mirror}): {name} differs from the plain version's")
        check(not bool(tables.sums.any()) and bool((tables.pair_keys == -1).all())
              and bool((tables.node_keys == -1).all()), f"preagg (mirror={mirror}): the tables were left dirty")
        call = lambda: preagg_ops.preagg_collapse(batch, state[0], state[1], touched[0], family, family,  # noqa: E731
                                                  mirror, tables)
        ms, host = time_ms(call, INGEST_REPS), host_us(call)
        dev = {k: device_ms(call, 20, f"preagg_{k}_kernel") for k in ("collapse", "emit")}
        both = None if None in dev.values() else sum(dev.values())
        plain_ms = time_ms(lambda: preagg_collapse_ref(batch, state[2], state[3], touched[1], family, family,
                                                       mirror, got[0].shape[0]), 5)
        bound = preagg_bound_bytes(n, pre.n_pairs, d, pre.src_unique.size, pre.dst_unique.size, w,
                                   mirror) / PEAK_BYTES_PER_S * 1e3
        out[mirror] = (ms, plain_ms, bound)
        print(
            f"[chip_smoke] preagg, serve BASE's first batch ({n} raw edges, {pre.n_pairs} pairs, "
            f"{pre.src_unique.size} sources, {pre.dst_unique.size} destinations, mirror={mirror}): pairs, registers "
            f"and bitmap equal to the plain version, the tables empty after; wrapper {ms:.4f} ms, host "
            f"{host:.3f} us/call, device collapse {_fmt(dev['collapse'])}, emit {_fmt(dev['emit'])}"
            + (f" ({100 * bound / both:.1f}% of the bound)" if both else "")
            + f"; bound {bound:.5f} ms; plain {plain_ms:.4f} ms"
        )
    # The same raw batch into a BASE summary by the two routes a session on
    # the card has: the collapse, then B1's key entry (a local session), and
    # the one-pass kernel B4 on the raw edges with their int64 keys (a fused
    # session).  Device ms of every kernel a call makes, and of B4 alone.
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.core.sketch import GLavaSketch, SketchConfig

    keys = [keys_to_tensor(x, "cuda") for x in (src, dst)]
    w_dev = torch.from_numpy(wts).cuda()
    for directed in (True, False):
        sk = GLavaSketch.empty(SketchConfig(d, w, w, directed), 0, torch.device("cuda"))
        card = lambda: sk.update_collapsed_(batch, tables, True, backend="cuda")  # noqa: E731
        one_pass = lambda: sk.update_fused_(*keys, w_dev)  # noqa: E731
        routes = {"collapse + B1": card, "B4": one_pass}
        dev = {k: device_ms(fn, 20) for k, fn in routes.items()}
        b4 = device_ms(one_pass, 20, "fused_ingest_kernel")
        wall = {k: time_ms(fn, INGEST_REPS) for k, fn in routes.items()}
        print(
            f"[chip_smoke] preagg: serve BASE's first batch into a BASE summary (directed={directed}), every kernel "
            "of a call: " + "; ".join(f"{k} device {_fmt(dev[k])}, wrapper {wall[k]:.4f} ms" for k in routes)
            + f"; B4's kernel alone {_fmt(b4)}"
        )
        del sk
    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter_ns()
        preaggregate_host(src, dst, wts)
        host_ms.append((time.perf_counter_ns() - t0) / 1e6)
    print(f"[chip_smoke] preagg: the host collapse it replaces, preaggregate_host, {median(host_ms):.3f} ms "
          f"(median of 5, host clock)")
    ms, plain_ms, bound = out[False]
    return dict(
        name="preagg_collapse", route="cuda", source="src/repro_torch/csrc/preagg.cu",
        replaces="src/repro_torch/core/ingest.py::preaggregate_host", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by="bytes", library_ms=None,
    )


REFRESH_S, REFRESH_T = 2, 2048  # the fleet cell's refresh: two tenants, a quarter of the rows touched


def refresh_bound_ops(n: int, t: int, w: int) -> int:
    """Operations of a touched-row refresh of n matrices at T touched rows:
    Δ·B and B OR G·W (2·T·w² each), S*·U (2·T²·w) and ceil(log2 T)
    squarings of S (2·T³ each)."""
    from repro_torch.kernels.closure.ops import closure_steps

    return 2 * n * (2 * t * w * w + t * t * w + closure_steps(t) * t ** 3)


def device_ops_ms(torch, fn) -> list:
    """(kernel, device ms) of one call of ``fn``, most time first (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_preroll(torch)
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) and "spin_kernel" not in e.key]
    return sorted(rows, key=lambda r: -r[1])


def phase_refresh(torch, gen):
    """The port-only incremental closure refresh on the card (``kernels/
    boolmm``) at the fleet cell's shape: S = 2 BASE tenants (d = 5, w =
    8,192) folded into 10 matrices, T = 2,048 distinct touched rows each,
    the closures built by B3 before additions in those rows.  The card
    refresh bit-equal to the parent's float32 path and to a full rebuild;
    its launches; wrapper ms; device ms of the new kernel and of the whole
    call, each kernel named, beside the int8 operation bound; the plain
    version (the same refresh, its products in float32); and the parent's
    float32 path (``fleet_closure_refresh``) as the library column."""
    from repro_torch.fleet import query as fleet_query
    from repro_torch.kernels.boolmm import ops as boolmm_ops
    from repro_torch.kernels.boolmm.ref import bool_product_ref
    from repro_torch.kernels.closure.ops import transitive_closure

    s, d, w, t = REFRESH_S, BASE_DEPTH, BASE_WIDTH, REFRESH_T
    n = s * d
    before = (torch.rand((s, 1, d, w, w), generator=gen, device="cuda") < 1.0 / w).float()
    closures = transitive_closure(before[:, 0])
    rows = torch.rand((s, d, w), generator=gen, device="cuda").argsort(dim=2)[..., :t]
    counters = before.clone()
    grown = counters[:, 0].view(n, w, w)
    cols = torch.randint(0, w, (n, t), generator=gen, device="cuda")
    grown[torch.arange(n, device="cuda")[:, None], rows.view(n, t), cols] += 2.0
    del before
    sel = list(range(s))
    card = lambda: fleet_query.cuda_fleet_closure_refresh(closures, counters, sel, rows)  # noqa: E731
    library = lambda: fleet_query.fleet_closure_refresh(closures, counters, sel, rows)  # noqa: E731
    launches, transposes = boolmm_ops.bool_product.launches, boolmm_ops.byte_transpose.launches
    got = card()
    launches = boolmm_ops.bool_product.launches - launches
    transposes = boolmm_ops.byte_transpose.launches - transposes
    want = library()
    full = transitive_closure(counters[:, 0])
    torch.cuda.synchronize()
    check(launches == 3 + boolmm_ops.closure_steps(t) and transposes == 2,
          f"refresh: {launches} products and {transposes} transposes, not 3 + ceil(log2 {t}) and 2")
    check(torch.equal(got, want), "refresh: the card refresh differs from the float32 path")
    check(torch.equal(got, full), "refresh: the card refresh differs from a full rebuild")
    ones = float(got.float().mean())
    del got, want, full

    def plain_product(a, b_t, c0=None, out=None, out_t=None):
        res = bool_product_ref(a, b_t, c0)
        if out_t is not None:
            out_t.copy_(res.transpose(1, 2))
        return res if out is None else out.copy_(res)

    ms = time_ms(card, 5)
    kernel_ms = device_ms(card, 3, "bool_product_wgmma_kernel")
    transpose_ms = device_ms(card, 3, "byte_transpose_kernel")
    all_ms = device_ms(card, 3)
    by_kernel = device_ops_ms(torch, card)
    check(not any("gemm" in k.lower() for k, _ in by_kernel), f"refresh: a library product on the card: {by_kernel}")
    library_ms = time_ms(library, 3)
    library_dev = device_ms(library, 2)
    real = boolmm_ops.bool_product
    boolmm_ops.bool_product = plain_product
    try:
        plain_ms = time_ms(card, 2)
    finally:
        boolmm_ops.bool_product = real
    ops = refresh_bound_ops(n, t, w)
    bound_ms = ops / PEAK_INT8_OPS * 1e3
    print(
        f"[chip_smoke] refresh S={s} d={d} w={w} T={t} ({n} matrices): bit-equal to the float32 path and to a "
        f"full rebuild ({ones:.3f} ones), {launches} product and {transposes} transpose launches; wrapper "
        f"{ms:.4f} ms; device: the product kernel {_fmt(kernel_ms)}"
        + (f" ({100 * bound_ms / kernel_ms:.1f}% of the bound)" if kernel_ms else "")
        + f", the transpose {_fmt(transpose_ms)}, every op {_fmt(all_ms)}; bound {bound_ms:.4f} ms ({ops:.3e} int8 operations); plain {plain_ms:.3f} "
        f"ms; the float32 path {library_ms:.3f} ms (device {_fmt(library_dev)})"
    )
    print("[chip_smoke] refresh device ms by kernel: "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in by_kernel[:12]))
    del closures, counters, grown
    return dict(
        name="bool_product", route="cuda", source="src/repro_torch/csrc/boolmm.cu",
        replaces="src/repro/core/reach.py::closure_refresh (XLA einsums, no Pallas kernel)", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="operations", library_ms=library_ms,
    )


def timed_fleet(torch, fn):
    """(fleet, each subscription's events, host wall seconds) of one fleet run."""
    t0 = time.time()
    fleet, subs = fn()
    torch.cuda.synchronize()
    return fleet, [sub.poll() for sub in subs], time.time() - t0


def same_fleet(torch, a, b, label):
    """Two fleets hold the same tenants in the same slots, every slot's
    counters, registers and cursor bit for bit, the same epochs."""
    check(a._state.counters.shape == b._state.counters.shape and set(a._sessions) == set(b._sessions),
          f"{label}: different stacks or tenants")
    for t, sess in a._sessions.items():
        other = b._sessions[t]
        check(sess._slot == other._slot and sess.epoch == other.epoch, f"{label}: tenant {t} slot or epoch differ")
        if sess._slot is None:
            continue
        for name in STACKED_NAMES + ("cursor",):
            check(torch.equal(getattr(a._state, name)[sess._slot], getattr(b._state, name)[sess._slot]),
                  f"{label}: tenant {t} {name} differ")
        check(bool(torch.isfinite(a._state.counters[sess._slot]).all()), f"{label}: tenant {t} non-finite counters")


def same_sketch(torch, got, want, label):
    for name in STACKED_NAMES:
        check(torch.equal(getattr(got, name), getattr(want, name)), f"{label}: {name} differ")


def standalone(torch, serve, args, data, ids, tenant, workload=None):
    """A port ``GraphStream`` opened as the fleet's seed opens it (seed 0) and
    fed ``tenant``'s sub-stream batch by batch (its subscription, if given,
    as the fleet's: ``every`` of its own mutations).  Returns the session
    and its events."""
    from repro_torch.api import GraphStream

    gs = GraphStream.open(serve._config(args), device="cuda")
    sub = None if workload is None else gs.subscribe(workload, every=args.every, name=f"tenant-{tenant}")
    for lo in range(0, args.edges, args.batch):
        m = ids[lo:lo + args.batch] == tenant
        if m.any():
            gs.ingest(*(data[k][lo:lo + args.batch][m] for k in ("src", "dst", "weight")))
    return gs, [] if sub is None else sub.poll()


def phase_fleet_serve(torch, serve, counted, drive):
    """Fleet serve BASE: ``serve.main(SERVE_BASE + --tenants 16)`` on the
    kernels (counts from this run only) and on the plain backends: the same
    stack and transcripts; one stacked-ingest launch a batch, 13 closure
    launches a batched build; the three hot tenants and the tenant of slot
    15 (its plane past 2^31 cells) equal to standalone sessions; a batched
    build of the hot tenants' closures timed; one more run on the kernels
    under the profiler."""
    from repro_torch.kernels.closure.ops import closure_steps

    held = release(torch)
    kern, kern_ev, kern_s = drive(("ingest_stacked",), lambda: timed_fleet(torch, lambda: serve.main(FLEET_BASE)))
    closure_launches = counted["closure_step"].launches
    kern.engine.invalidate()  # the transcripts are taken; free the closures for the plain run
    with_kern = release(torch)
    plain, plain_ev, plain_s = timed_fleet(torch, lambda: serve.main(FLEET_BASE + PLAIN_BACKENDS))
    same_fleet(torch, kern, plain, "fleet serve BASE vs plain")
    for a, b in zip(kern_ev, plain_ev, strict=True):
        same_events(a, b, "fleet serve BASE vs plain")
    args = serve.build_parser().parse_args(FLEET_BASE)
    n_batches = -(-args.edges // args.batch)
    builds = kern.engine.dispatches["closure"]
    check(counted["ingest_stacked"].launches == n_batches,
          f"fleet serve BASE: {counted['ingest_stacked'].launches} stacked launches for {n_batches} batches")
    check(builds >= 1 and closure_launches == builds * closure_steps(BASE_WIDTH),
          f"fleet serve BASE: {closure_launches} closure launches for {builds} batched builds")
    check(all(kern._sessions[t]._slot == t for t in range(FLEET_TENANTS)), "fleet serve BASE: tenant t not in slot t")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del plain, plain_ev
    release(torch)
    print(
        f"[chip_smoke] fleet serve BASE ({held:.1f} GiB held on the card before it, {with_kern:.1f} GiB with the "
        f"kernels run's fleet, peak {peak:.1f} GiB; {FLEET_TENANTS} tenants, ({FLEET_TENANTS}, 1, {BASE_DEPTH}, {BASE_WIDTH}, "
        f"{BASE_WIDTH}) counters, {kern._state.counters.numel() * 4 / 1e9:.1f} GB): kernels {kern_s:.3f} s, plain "
        f"{plain_s:.3f} s (host wall clock); {n_batches} stacked launches, {closure_launches} closure launches for "
        f"{builds} batched builds of {kern.engine.closure_builds} tenant closures; ticks "
        f"{[len(e) for e in kern_ev]}; stack, cursors and transcripts identical"
    )
    data, ids, workload = serve.fleet_traffic(args)
    for t in (0, 1, 2, 15):
        gs, events = standalone(torch, serve, args, data, ids, t, workload if t < 3 else None)
        same_sketch(torch, kern.tenant(t).sketch, gs.sketch, f"fleet tenant {t} vs its standalone session")
        check(kern.tenant(t).epoch == gs.epoch, f"fleet tenant {t}: epoch {kern.tenant(t).epoch} vs {gs.epoch}")
        if t < 3:
            same_events(kern_ev[t], events, f"fleet tenant {t} vs its standalone session")
        del gs
    print(
        f"[chip_smoke] fleet serve BASE: tenants 0, 1, 2 (counters, registers, epochs, transcripts) and 15 (slot 15, "
        f"cells from {15 * BASE_DEPTH * BASE_WIDTH ** 2:,} on, past 2^31) equal to standalone sessions"
    )
    items = [(t, kern._sessions[t].epoch) for t in range(3)]
    kern.engine.invalidate()
    build_ms = once_ms(torch, lambda: kern.engine._build(kern._state, items))
    print(f"[chip_smoke] fleet closure build, S=3 tenants (15 planes of {BASE_WIDTH}^2, "
          f"{closure_steps(BASE_WIDTH)} launches): {build_ms:.2f} ms by CUDA events")
    del kern, kern_ev
    release(torch)
    profile_serve(torch, serve, FLEET_BASE, "fleet serve BASE")
    release(torch)


def phase_fleet_residency(torch, serve):
    """Fleet residency and recovery at BASE: 6 tenants through 4 slots with
    checkpoint and WAL directories (one serve BASE batch each in
    ``FLEET_RESIDENCY_ORDER``: 3 evictions, 1 fault-in), every resident
    tenant against its standalone session; a fresh fleet's ``recover()`` from
    the shards and lanes, every tenant against its standalone session; then
    the windowed fleet on the kernels against the plain backends."""
    import shutil
    import tempfile

    from repro_torch.api import GraphStream
    from repro_torch.fleet import SketchFleet

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-fleet-"))
    try:
        args = serve.build_parser().parse_args(SERVE_BASE)
        data, _, _ = serve.traffic(args)
        cfg = serve._config(args)
        dirs = dict(capacity=4, device="cuda", checkpoint_dir=str(tmp / "ckpt"), wal_dir=str(tmp / "wal"))
        fleet = SketchFleet.open(cfg, **dirs)
        oracles = {t: GraphStream.open(cfg, device="cuda") for t in set(FLEET_RESIDENCY_ORDER)}
        admit_s, ingest_s = [], []
        for i, t in enumerate(FLEET_RESIDENCY_ORDER):
            batch = tuple(data[k][i * args.batch:(i + 1) * args.batch] for k in ("src", "dst", "weight"))
            before = (fleet.stats.evictions, fleet.stats.fault_ins)
            t0 = time.time()
            fleet.tenant(t)
            torch.cuda.synchronize()
            t1 = time.time()
            fleet.tenant(t).ingest(*batch)
            fleet.flush()
            moved = (fleet.stats.evictions - before[0], fleet.stats.fault_ins - before[1])
            admit_s.append((t, moved, t1 - t0))
            ingest_s.append(time.time() - t1)
            oracles[t].ingest(*batch)
        check((fleet.stats.evictions, fleet.stats.fault_ins) == (3, 1),
              f"fleet residency: {fleet.stats.evictions} evictions, {fleet.stats.fault_ins} fault-ins")
        for t in fleet.resident_tenants:
            same_sketch(torch, fleet.tenant(t).sketch, oracles[t].sketch, f"fleet residency: tenant {t}")
        shard_gb = sum(p.stat().st_size for p in (tmp / "ckpt").rglob("arrays.npz")) / 1e9
        del fleet  # crash
        release(torch)
        fleet = SketchFleet.open(cfg, **dirs)
        t0 = time.time()
        reports = fleet.recover()
        torch.cuda.synchronize()
        recover_s = time.time() - t0
        check(set(reports) == set(oracles), f"fleet recovery: lanes of {sorted(reports)}")
        for t in list(fleet.resident_tenants) + [t for t in oracles if t not in fleet.resident_tenants]:
            same_sketch(torch, fleet.tenant(t).sketch, oracles[t].sketch, f"fleet recovery: tenant {t}")
            check(fleet.tenant(t).epoch == oracles[t].epoch, f"fleet recovery: tenant {t} epoch")
        moves = ", ".join(f"tenant {t}: {sec:.2f} s ({ev} eviction, {fi} fault-in)" for t, (ev, fi), sec in admit_s)
        print(
            f"[chip_smoke] fleet residency BASE (capacity 4, 6 tenants, a 50,000-edge batch each in the order "
            f"{FLEET_RESIDENCY_ORDER}): 3 evictions and 1 fault-in; admissions ({moves}); ingest with its WAL append "
            f"{min(ingest_s):.3f}-{max(ingest_s):.3f} s a batch; {shard_gb:.2f} GB of shards on disk; recover() "
            f"{recover_s:.2f} s ({sum(r.mutations_replayed for r in reports.values())} mutations replayed, "
            f"{sum(r.step is not None for r in reports.values())} shards faulted in); every tenant equal to its "
            f"standalone session before the crash (residents) and after recovery (all 6) (host wall clock)"
        )
        del fleet, oracles
        release(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fleet_window(torch, serve)


def fleet_window(torch, serve):
    """The windowed fleet: 4 tenants, rings of 4 slices (21.5 GB), the fleet
    traffic with the hot tenants' windows advanced every 2 batches, on the
    kernels and on the plain backends: the same rings, cursors and
    transcripts."""
    from repro_torch.kernels.ingest_stacked.ops import stacked_ingest

    runs = {}
    for label, flags in (("kernels", []), ("plain", PLAIN_BACKENDS)):
        args = serve.build_parser().parse_args(FLEET_WINDOW + flags)
        data, ids, workload = serve.fleet_traffic(args)
        launches = stacked_ingest.launches
        t0 = time.time()
        fleet = serve.open_fleet(args)
        subs = [fleet.tenant(t).subscribe(workload, every=args.every, name=f"tenant-{t}") for t in range(3)]
        for i, lo in enumerate(range(0, args.edges, args.batch)):
            fleet.ingest_mixed(*(x[lo:lo + args.batch] for x in (ids, data["src"], data["dst"], data["weight"])))
            if i % 2 == 1:
                for t in range(3):
                    fleet.tenant(t).advance_window()
        torch.cuda.synchronize()
        fleet.engine.invalidate()
        runs[label] = (fleet, [sub.poll() for sub in subs], time.time() - t0, stacked_ingest.launches - launches)
        del fleet, subs
        release(torch)
    (kern, kern_ev, kern_s, kern_n), (plain, plain_ev, plain_s, plain_n) = runs["kernels"], runs["plain"]
    same_fleet(torch, kern, plain, "windowed fleet vs plain")
    for a, b in zip(kern_ev, plain_ev, strict=True):
        same_events(a, b, "windowed fleet vs plain")
    check(kern_n == 10 and plain_n == 0, f"windowed fleet: {kern_n} and {plain_n} stacked launches")
    cursors = kern._state.cursor.tolist()
    check(cursors[:3] == [1, 1, 1], f"windowed fleet: cursors {cursors} after 5 advances of a ring of 4")
    print(
        f"[chip_smoke] windowed fleet BASE (4 tenants, rings of 4, {kern._state.counters.numel() * 4 / 1e9:.1f} GB; "
        f"5 advances of the 3 hot tenants): kernels {kern_s:.3f} s, plain {plain_s:.3f} s (host wall clock); "
        f"{kern_n} stacked launches; {kern.engine.closure_builds} tenant closures built in "
        f"{kern.engine.dispatches['closure']} builds; ticks {[len(e) for e in kern_ev]}; rings, cursors and "
        f"transcripts identical"
    )
    del kern, plain, runs
    release(torch)


# -- the distributed plane ----------------------------------------------------------

# (ii)'s mesh: four ranks on one card, two stream blocks and two row shards.
DIST_MESH = (2, 2)
DIST_TRAIN_STEPS = 3
# Each rank's kernels, counted in its own process (the wrapper modules'
# ``launches``): B1, B5, B6, B3 on the serve path; B7 and its decode on the
# data-parallel step.
DIST_SERVE_KERNELS = ("ingest_scatter", "edge_query_cells", "flows", "closure_step")
DIST_TRAIN_KERNELS = ("countsketch", "countsketch_median")


def counted_kernels():
    """The launch-counted wrappers, by the name the ``kernels`` line uses."""
    from repro_torch.kernels.closure import ops as closure_ops
    from repro_torch.kernels.countsketch import ops as countsketch_ops
    from repro_torch.kernels.flow import ops as flow_ops
    from repro_torch.kernels.ingest import ops as ingest_ops
    from repro_torch.kernels.query import ops as query_ops

    return {
        "ingest_scatter": ingest_ops.ingest_scatter,
        "edge_query_cells": query_ops.edge_query_cells,
        "flows": flow_ops.flows,
        "closure_step": closure_ops.closure_step,
        "countsketch": countsketch_ops.countsketch,
        "countsketch_median": countsketch_ops.countsketch_median,
    }


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes (bit-equality across processes)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def transcript_digest(events) -> str:
    """SHA-256 of a subscription transcript: tick, epoch, alarm and every
    answer's dtype and bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for e in events:
        h.update(f"{e.subscription_id}:{e.tick}:{e.epoch}:{e.alarm}".encode())
        for r in e.results:
            for x in r.value if isinstance(r.value, tuple) else (r.value,):
                a = np.asarray(x)
                h.update(str(a.dtype).encode() + a.tobytes())
    return h.hexdigest()


class CollectiveClock:
    """Times every all-reduce of a mesh: the instance's ``all_reduce_`` is
    wrapped so that each call is bracketed by synchronizes (host wall
    clock) and by CUDA events on the current stream (device time; gloo
    copies a CUDA tensor to the host and back, so its host time is the
    honest one).  ``calls`` holds (axes, op, bytes, host ms, device ms)."""

    def __init__(self, torch, mesh, keep=None):
        self.calls = []
        self.kept = []
        inner = mesh.all_reduce_
        cuda = torch.cuda.is_available()

        def timed(tensor, op, axes):
            if keep is not None and keep(tensor):
                self.kept.append(tensor.detach().clone())
            if cuda:
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            inner(tensor, op, axes)
            if cuda:
                end.record()
                torch.cuda.synchronize()
            host_ms = 1e3 * (time.perf_counter() - t0)
            dev_ms = start.elapsed_time(end) if cuda else None
            self.calls.append((axes if isinstance(axes, str) else "+".join(axes), str(op).split(".")[-1],
                               tensor.numel() * tensor.element_size(), host_ms, dev_ms))
            if keep is not None and keep(tensor):
                self.kept.append(tensor.detach().clone())
            return tensor

        mesh.all_reduce_ = timed

    def first_ms(self):
        """Host ms of the first all-reduce over each axis group (where NCCL
        sets up the group's communicator)."""
        out = {}
        for axes, _, _, host_ms, _ in self.calls:
            out.setdefault(axes, round(host_ms, 3))
        return out

    def summary(self, op: str, axes: str, min_bytes: int = 0):
        """(count, bytes of one call, median host ms, median device ms) of
        the calls with ``op`` over ``axes`` moving at least ``min_bytes``."""
        import numpy as np

        sel = [c for c in self.calls if c[1] == op and c[0] == axes and c[2] >= min_bytes]
        if not sel:
            return 0, 0, None, None
        dev = [c[4] for c in sel if c[4] is not None]
        return (len(sel), sel[0][2], float(np.median([c[3] for c in sel])),
                float(np.median(dev)) if dev else None)


def distributed_serve(torch, serve, argv, mesh, device):
    """``serve``'s traffic (the flags ``argv``) through a mesh session on
    ``device``: the standing workload ticks every ``--every`` batches; then
    both point-query directions through the counters
    (``distributed_point_query(use_registers=False)``, the flow kernel on
    each shard), held to the registers.  Returns (session, events, host
    wall seconds of the serve run, with the synchronize that ends it)."""
    from repro_torch.api import GraphStream
    from repro_torch.core.distributed import distributed_point_query
    from repro_torch.core.hashing import keys_to_tensor

    args = serve.build_parser().parse_args(argv)
    stream = GraphStream.open(serve._config(args), device=device, mesh=mesh,
                              ingest_backend=args.ingest_backend, query_backend=args.query_backend)
    t0 = time.time()
    gs, _, events = serve.drive(stream, args)
    gs.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.time() - t0
    _, _, workload = serve.traffic(args)
    keys = keys_to_tensor(next(q for q in workload if q.family == "in_flow").u, device)
    for direction in ("in", "out"):
        counted = distributed_point_query(mesh, gs._sketch, keys, direction, use_registers=False)
        registers = distributed_point_query(mesh, gs._sketch, keys, direction)
        check(torch.equal(counted, registers),
              f"distributed {direction}-flow from the counters differs from the registers")
    return gs, events, wall


def rank_device(torch, device: str) -> None:
    """A spawned rank's device settings: card 0 (every rank shares it), and
    no TF32, as in this process."""
    if device != "cpu":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def spawn_ranks(target, world: int, device: str, args=(), timeout: float = 600.0):
    """``target(rank, world, workdir, device, *args)`` on ``world`` spawned
    gloo ranks (``repro_torch.distributed.spawn.run_ranks``: a nonzero exit
    code or a rank past the deadline raises); the ranks' results,
    rank-ordered."""
    import shutil
    import tempfile

    from repro_torch.distributed.spawn import run_ranks

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-ranks-"))
    try:
        return run_ranks(target, world, tmp, args=(device, *args), timeout=timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_rank(rank, world, tmp, device, argv):
    """(ii) One rank of the mesh session on ``DIST_MESH``: the serve traffic,
    then digests of its shard, the registers and the transcript, its
    launches, wall time, all-reduce times and peak memory."""
    import torch

    from repro_torch.distributed.mesh import Mesh
    from repro_torch.launch import serve

    rank_device(torch, device)
    mesh = Mesh(DIST_MESH, ("data", "model"))
    kernels = counted_kernels()
    for f in kernels.values():
        f.launches = 0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    clock = CollectiveClock(torch, mesh)
    gs, events, wall = distributed_serve(torch, serve, argv, mesh, device)
    sk = gs._sketch
    return {
        "coords": [mesh.coords["data"], mesh.coords["model"]],
        "shard": digest(sk.counters),
        "registers": digest(sk.row_flows, sk.col_flows),
        "transcript": transcript_digest(events),
        "events": len(events),
        "launches": {name: kernels[name].launches for name in DIST_SERVE_KERNELS},
        "closure": [gs.engine.closure_refreshes, gs.engine.closure_incremental_refreshes],
        "wall_s": wall,
        "ingest_allreduce": clock.summary("SUM", "data", sk.counters.numel() * 4),
        "gather_allreduce": clock.summary("SUM", "model", sk.counters.numel() * 4),
        "allreduce_total_ms": sum(c[3] for c in clock.calls),
        "first_ms": clock.first_ms(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else 0.0,
        "finite": bool(torch.isfinite(sk.counters).all()),
    }


def dist_train_state(torch, device, steps: int, preset: str = "100m"):
    """``launch/train_lm.py``'s compressed state for ``preset`` (parameters
    from seed 0, compressor from seed 1, AdamW at lr 1e-3 with 20 warm-up
    steps), its loss and AdamW config, and ``steps`` pairs of batches
    (worker 0's, worker 1's) drawn from its token stream."""
    import numpy as np

    from repro_torch.data.lm import MarkovTokens
    from repro_torch.launch.train_lm import COMPRESSOR, PRESETS
    from repro_torch.models import transformer as tfm
    from repro_torch.train import compression as comp
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.tree import tree_leaves

    cfg = PRESETS[preset]
    opt_cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), device)
    n = sum(x.numel() for x in tree_leaves(params))
    state = {"params": params, "opt": opt_mod.init_adamw(opt_cfg, params),
             "comp": comp.init_compressor(COMPRESSOR, n, torch.Generator().manual_seed(1), device)}
    gen, rng = MarkovTokens(cfg.vocab, seed=0), np.random.default_rng(0)
    batch, seq = flag(TRAIN_100M, "--batch"), flag(TRAIN_100M, "--seq")
    batches = [[{"tokens": torch.as_tensor(gen.batch(batch, seq + 1, rng)).to(device)} for _ in range(2)]
               for _ in range(steps)]

    def loss_fn(p, b):
        return tfm.loss_fn(cfg, p, b["tokens"])

    return state, loss_fn, opt_cfg, batches


def train_rank(rank, world, tmp, device, steps, preset):
    """(iii) One worker of the data-parallel compressed step
    (``axis_name="data"`` over a (2,) mesh): its own batch each step.
    Returns per step the loss, its CountSketch table before and after the
    all-reduce, digests of the parameters, of the sketch momentum and of
    its error feedback, and the step's host time; its launches and peak
    memory."""
    import torch

    from repro_torch.distributed.mesh import Mesh
    from repro_torch.launch.train_lm import COMPRESSOR
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves

    rank_device(torch, device)
    mesh = Mesh((world,), ("data",))
    kernels = counted_kernels()
    state, loss_fn, opt_cfg, batches = dist_train_state(torch, device, steps, preset)
    table_shape = (COMPRESSOR.depth, COMPRESSOR.width)
    clock = CollectiveClock(torch, mesh, keep=lambda t: tuple(t.shape) == table_shape)
    step = trainer.compressed_data_parallel_step(loss_fn, opt_cfg, COMPRESSOR, axis_name="data", mesh=mesh)
    for f in kernels.values():
        f.launches = 0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    out = []
    for pair in batches:
        t0 = time.time()
        state, m = step(state, pair[rank])
        loss = float(m["loss"])
        out.append({"loss": loss, "s": time.time() - t0, "params": digest(*tree_leaves(state["params"])),
                    "momentum": digest(state["comp"].momentum), "error": digest(state["comp"].error)})
    for i, rec in enumerate(out):
        rec["table"], rec["reduced"] = clock.kept[2 * i].cpu(), clock.kept[2 * i + 1].cpu()
    return {
        "steps": out,
        "launches": {name: kernels[name].launches for name in DIST_TRAIN_KERNELS},
        "table_allreduce": clock.summary("SUM", "data", 4 * table_shape[0] * table_shape[1]),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else 0.0,
    }


def emulate_train(torch, device, steps, preset, ranks):
    """(iii)'s single-process emulation, held to the ranks bit for bit at
    every step: one set of parameters, both workers' gradients at it, each
    worker's table of its gradient plus its error feedback, the two tables
    added, one decode (worker 0's round trip with worker 1's table added),
    one AdamW step.  Every rank's own table, reduced table, parameters,
    sketch momentum and loss must equal the emulation's, and its error
    feedback that of its worker.  Returns the emulated losses."""
    import dataclasses

    from repro_torch.train import compression as comp
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import tree_leaves

    state, loss_fn, opt_cfg, batches = dist_train_state(torch, device, steps, preset)
    params, ostate = state["params"], state["opt"]
    cstates = [state["comp"], state["comp"]]  # one family and momentum; an error feedback each
    losses = []
    for i, pair in enumerate(batches):
        flats, ls = [], []
        for k in range(2):
            (loss, _), grads = value_and_grad(loss_fn, params, pair[k])
            flat, spec = comp.flatten_grads(grads)
            del grads
            flats.append(flat)
            ls.append(loss)
        hashes = None if device != "cpu" else comp.hash_indices(cstates[0].hash, flats[0].shape[0])
        tables = [comp._sketch(c, f + c.error, hashes) for c, f in zip(cstates, flats)]
        update, first = comp.roundtrip(cstates[0], flats[0], lambda t: t + tables[1])
        second = dataclasses.replace(cstates[1], momentum=first.momentum, error=flats[1] + cstates[1].error - update)
        cstates = [first, second]
        params, ostate, _ = opt_mod.apply_adamw(opt_cfg, ostate, params, comp.unflatten_grads(update, spec))
        loss = float((ls[0] + ls[1]) / 2)
        losses.append(loss)
        want = {"params": digest(*tree_leaves(params)), "momentum": digest(first.momentum), "loss": loss}
        summed = (tables[0] + tables[1]).cpu()
        for k, r in enumerate(ranks):
            got, label = r["steps"][i], f"data-parallel step {i + 1}, rank {k}"
            check(torch.equal(got["table"], tables[k].cpu()),
                  f"{label}: its table differs from the emulation's sketch of worker {k}'s gradient")
            check(torch.equal(got["reduced"], summed), f"{label}: its reduced table is not the sum of the two tables")
            for key, value in want.items():
                check(got[key] == value, f"{label}: its {key} differs from the emulation's")
            check(got["error"] == digest(cstates[k].error),
                  f"{label}: its error feedback differs from the emulation's worker {k}")
        del flats, tables, summed, update
    return losses


def distributed_kernel_rows(torch, counters, rows, cols):
    """B5 and B6 at the shapes (ii)'s path gives them (a (d, w_r/2, w_c)
    shard; B5 on the workload's Q edge keys, rows clipped into the shard),
    each against its plain version, timed with CUDA events beside its plain
    version, its library call and its bound."""
    from repro_torch.kernels.flow.ops import flows
    from repro_torch.kernels.flow.ref import flows_ref
    from repro_torch.kernels.query.ops import edge_query_cells
    from repro_torch.kernels.query.ref import edge_query_cells_ref

    d, wr, wc = counters.shape
    q = rows.shape[1]
    out = []
    got, want = edge_query_cells(counters, rows, cols), edge_query_cells_ref(counters, rows, cols)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "distributed B5 differs from its plain version on the shard")
    flat, cell = counters.view(d, -1), rows * wc + cols
    call, lib = (lambda: edge_query_cells(counters, rows, cols)), (lambda: flat.gather(1, cell))
    lib_a, ms_a, ms_b, lib_b = (time_ms(f, QUERY_REPS) for f in (lib, call, call, lib))
    dev_ms = device_ms(call, 50, "query_cells_kernel")
    bound = (d * q * (32 + 2 * rows.element_size()) + 4 * d * q) / PEAK_BYTES_PER_S * 1e3
    out.append(dict(
        name="edge_query_cells@distributed", route="cuda", source="src/repro_torch/csrc/query.cu",
        replaces="src/repro/kernels/query/kernel.py:122", max_abs_err=float((got - want).abs().max()),
        ms=(ms_a + ms_b) / 2, plain_ms=time_ms(lambda: edge_query_cells_ref(counters, rows, cols), 50),
        bound_ms=bound, bound_by="bytes", library_ms=(lib_a + lib_b) / 2, device_ms=dev_ms,
    ))
    rs, cs = flows(counters)
    want_rs, want_cs = flows_ref(counters)
    torch.cuda.synchronize()
    check(torch.equal(rs, want_rs) and torch.equal(cs, want_cs), "distributed B6 differs from its plain version")
    bound = (d * wr * wc * 4 + (d * wr + d * wc) * 4) / PEAK_BYTES_PER_S * 1e3
    out.append(dict(
        name="flows@distributed", route="cuda", source="src/repro_torch/csrc/flow.cu",
        replaces="src/repro/kernels/flow/kernel.py:39",
        max_abs_err=max(float((rs - want_rs).abs().max()), float((cs - want_cs).abs().max())),
        ms=time_ms(lambda: flows(counters), 20), plain_ms=time_ms(lambda: flows_ref(counters), 20),
        bound_ms=bound, bound_by="bytes", library_ms=time_ms(lambda: (counters.sum(2), counters.sum(1)), 20),
        device_ms=device_ms(lambda: flows(counters), 20, "flows_kernel"),
    ))
    for r in out:
        print(f"[chip_smoke] {r['name']} on a ({d}, {wr}, {wc}) shard" + (f", Q={q}" if "query" in r["name"] else "")
              + f": bit-equal to its plain version; {r['ms']:.5f} ms (device {_fmt(r['device_ms'])}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms")
    return out


def phase_distributed(torch, serve, rows, argv=SERVE_BASE, device="cuda", backend="nccl", preset="100m"):
    """The distributed serve BASE cell: (i) one rank on ``backend`` (NCCL on
    the card), a (1, 1) mesh, in this process, bit-equal to the
    single-session kernels run; (ii) four gloo ranks on the same card, a
    (2, 2) mesh: each rank's shard bit-equal to its rows of (i), the
    registers and the transcript equal; (iii) the data-parallel compressed
    step on two gloo ranks against its single-process emulation.  Appends
    the B5 and B6 rows of this path to ``rows``."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.distributed.mesh import Mesh

    cuda = device != "cpu"
    kernels = counted_kernels()
    single, single_ev, single_s = timed_run(torch, lambda: serve.main(argv + ["--device", device]))
    if cuda:
        # B5 and B6 at the shapes the mesh path gives them, on the first
        # shard's rows of the single session (which (i) and (ii) are held to
        # below), timed before any process group exists.
        live = single._live()
        wr_local = live.counters.shape[1] // DIST_MESH[1]
        _, _, workload = serve.traffic(serve.build_parser().parse_args(argv))
        edge = next(q for q in workload if q.family == "edge")
        r, c = live.hash_edges(keys_to_tensor(edge.u, device), keys_to_tensor(edge.v, device))
        shard = live.counters[:, :wr_local].contiguous()
        dist_rows = distributed_kernel_rows(torch, shard, r.clamp(0, wr_local - 1), c)
        del live, shard
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-nccl-"))
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(str(tmp / "store"), 1), rank=0, world_size=1)
    try:
        mesh = Mesh((1, 1), ("data", "model"))
        clock = CollectiveClock(torch, mesh)
        for f in kernels.values():
            f.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        one, one_ev, one_s = distributed_serve(torch, serve, argv + ["--device", device], mesh, device)
        launches = {name: kernels[name].launches for name in DIST_SERVE_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check_same(torch, one, one_ev, single, single_ev, "distributed serve BASE (i) vs the single session")
    check(not cuda or all(v > 0 for v in launches.values()),
          f"distributed serve BASE (i): a kernel was not launched: {launches}")
    n, nbytes, host_ms, dev_ms = clock.summary("SUM", "data", one._sketch.counters.numel() * 4)
    print(
        f"[chip_smoke] distributed serve BASE (i) {backend}, 1 rank, (1, 1) mesh: {one_s:.3f} s (single session "
        f"{single_s:.3f} s; host wall clock, all-reduces bracketed by synchronizes); launches {launches}; "
        f"closure full={one.engine.closure_refreshes} incremental={one.engine.closure_incremental_refreshes}; "
        f"{n} ingest all-reduces of {nbytes / 2**30:.2f} GiB: {host_ms} ms host, {dev_ms} ms device (median); "
        f"first all-reduce of each group {clock.first_ms()} ms host; all-reduces {len(clock.calls)}, "
        f"{sum(c[3] for c in clock.calls):.1f} ms host in all; peak {peak:.2f} GiB; counters, registers and "
        f"transcript bit-equal to the single session"
    )
    # What (ii)'s ranks must hold: their rows of (i), its registers and transcript.
    sk = one._sketch
    wr_local = sk.counters.shape[1] // DIST_MESH[1]
    want_shards = [digest(sk.counters[:, m * wr_local:(m + 1) * wr_local]) for m in range(DIST_MESH[1])]
    want_registers, want_transcript = digest(sk.row_flows, sk.col_flows), transcript_digest(one_ev)
    del single, single_ev, one, one_ev, sk
    if cuda:
        release(torch)

    world = DIST_MESH[0] * DIST_MESH[1]
    t0 = time.time()
    ranks = spawn_ranks(serve_rank, world, device, (argv + ["--device", device],))
    spawn_s = time.time() - t0
    for rank, res in enumerate(ranks):
        model = res["coords"][1]
        check(res["shard"] == want_shards[model], f"distributed serve BASE (ii): rank {rank}'s shard differs from "
              f"rows {model * wr_local}..{(model + 1) * wr_local} of (i)")
        check(res["registers"] == want_registers, f"distributed serve BASE (ii): rank {rank}'s registers differ")
        check(res["transcript"] == want_transcript, f"distributed serve BASE (ii): rank {rank}'s transcript differs")
        check(res["launches"] == launches, f"distributed serve BASE (ii): rank {rank} launched {res['launches']}, "
              f"(i) {launches}")
        check(res["finite"], f"distributed serve BASE (ii): rank {rank} holds non-finite counters")
    walls = ", ".join(f"{r['wall_s']:.2f}" for r in ranks)
    peaks = ", ".join(f"{r['peak_gib']:.2f}" for r in ranks)
    n, nbytes, host_ms, dev_ms = ranks[0]["ingest_allreduce"]
    gn, gbytes, ghost_ms, gdev_ms = ranks[0]["gather_allreduce"]
    print(
        f"[chip_smoke] distributed serve BASE (ii) gloo, {world} ranks on one card, {DIST_MESH} mesh: serve "
        f"{walls} s by rank (host wall clock, all-reduces bracketed by synchronizes; {spawn_s:.1f} s with the "
        f"ranks' start); launches per rank {ranks[0]['launches']}; closure full/incremental {ranks[0]['closure']}; "
        f"{n} ingest all-reduces of {nbytes / 2**30:.2f} GiB over 'data': {host_ms} ms host, {dev_ms} ms device "
        f"(median, rank 0); {gn} gathers of {gbytes / 2**30:.2f} GiB over 'model' for reach: {ghost_ms} ms host, "
        f"{gdev_ms} ms device (median, rank 0); all-reduces {ranks[0]['allreduce_total_ms']:.1f} ms host in all, "
        f"the first of each group {ranks[0]['first_ms']} ms (rank 0); peak {peaks} GiB by rank; shards bit-equal "
        f"to (i)'s rows, registers and transcripts equal"
    )
    if cuda:
        for row in dist_rows:
            name = row["name"].split("@")[0]
            row["launches"] = ranks[0]["launches"][name]
            check(row["launches"] > 0, f"{row['name']} was not launched on its path")
            rows[row["name"]] = row

    t0 = time.time()
    train = spawn_ranks(train_rank, 2, device, (DIST_TRAIN_STEPS, preset))
    train_s = time.time() - t0
    emulated = emulate_train(torch, device, DIST_TRAIN_STEPS, preset, train)
    for r in train:
        want = {"countsketch": 2 * DIST_TRAIN_STEPS, "countsketch_median": DIST_TRAIN_STEPS} if cuda else r["launches"]
        check(r["launches"] == want, f"data-parallel step: launches {r['launches']}, expected {want}")
    n, nbytes, host_ms, dev_ms = train[0]["table_allreduce"]
    print(
        f"[chip_smoke] data-parallel compressed {preset}, 2 gloo ranks on one card, {DIST_TRAIN_STEPS} steps: "
        f"losses {[r['loss'] for r in train[0]['steps']]} (emulation {emulated}); step host s by rank "
        f"{[[round(s['s'], 4) for s in r['steps']] for r in train]}; {train_s:.1f} s with the ranks' start; "
        f"launches per rank {train[0]['launches']}; {n} table all-reduces of {nbytes} B: {host_ms} ms host, "
        f"{dev_ms} ms device (median); peak {[round(r['peak_gib'], 2) for r in train]} GiB; at every step each "
        f"rank's table, reduced table, parameters, sketch momentum, error feedback and loss bit-equal to the "
        f"single-process emulation (so the replicas are identical)"
    )
    return ranks, train


# Durable distributed serve BASE: a checkpoint after this many batches, a
# crash (the session dropped, no checkpoint) after this many.
DURABLE_CHECKPOINT_AT, DURABLE_CRASH_AT = 5, 8
DURABLE_KERNELS = ("ingest_scatter", "edge_query_cells", "closure_step")


def median(xs) -> float:
    import numpy as np

    return float(np.median(xs))


def log_records_digest(wal_dir: Path) -> str:
    """SHA-256 of a WAL's records in seq order: every segment's bytes after
    its 16-byte header (a crash opens a new segment where an uninterrupted
    run goes on writing the old one; the records are the same bytes)."""
    import hashlib

    h = hashlib.sha256()
    for seg in sorted(wal_dir.glob("wal-*.seg")):
        h.update(seg.read_bytes()[16:])
    return h.hexdigest()


def durable_serve(torch, serve, argv, device, workdir: Path, mesh=None, crash: bool = True):
    """serve's traffic (the flags ``argv``) through a durable session (a mesh
    session when ``mesh`` is given) with ``wal_dir`` and ``checkpoint_dir``
    under ``workdir``: the standing workload ticks every ``--every`` batches,
    a checkpoint after batch ``DURABLE_CHECKPOINT_AT``; with ``crash``, the
    session is dropped after batch ``DURABLE_CRASH_AT`` and a fresh one
    subscribes, seeks to the consumed tick, recovers and finishes the stream.
    Returns the final session and digests of its state, the consumed
    transcript and the log's records, the report, the seconds of
    ``recover()`` and of its restore, and the host ms of each of this rank's
    appends (rank 0 alone appends on a mesh)."""
    from repro_torch.api import GraphStream

    args = serve.build_parser().parse_args(argv)
    data, _, workload = serve.traffic(args)
    spans = [(lo, min(args.edges, lo + args.batch)) for lo in range(0, args.edges, args.batch)]
    dirs = dict(wal_dir=str(workdir / "wal"), checkpoint_dir=str(workdir / "ckpt"))
    appends = []

    def durable():
        gs = GraphStream.open(serve._config(args), device=device, mesh=mesh, **dirs)
        inner = gs._wal.append_edges

        def timed(*a, **kw):
            t0 = time.perf_counter()
            seq = inner(*a, **kw)
            appends.append(1e3 * (time.perf_counter() - t0))
            return seq

        gs._wal.append_edges = timed
        return gs, gs.subscribe(workload, every=args.every, name="mixed-workload")

    def feed(gs, sub, part, events):
        for i, (lo, hi) in part:
            gs.ingest(data["src"][lo:hi], data["dst"][lo:hi], data["weight"][lo:hi])
            events.extend(sub.poll())
            if i + 1 == DURABLE_CHECKPOINT_AT:
                gs.checkpoint()

    numbered = list(enumerate(spans))
    cut = DURABLE_CRASH_AT if crash else len(spans)
    gs, sub = durable()
    events = []
    feed(gs, sub, numbered[:cut], events)
    report = recover_s = restore_s = None
    if crash:
        consumed = sub.ticks
        del gs, sub
        if device != "cpu":
            release(torch)
        gs, sub = durable()
        sub.seek(consumed)
        inner_restore, spent = gs.restore, []

        def timed_restore(*a, **kw):
            t0 = time.perf_counter()
            out = inner_restore(*a, **kw)
            if device != "cpu":
                torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return out

        gs.restore = timed_restore
        t0 = time.perf_counter()
        report = gs.recover()
        if device != "cpu":
            torch.cuda.synchronize()
        recover_s, restore_s = time.perf_counter() - t0, spent[0]
        events.extend(sub.poll())
        feed(gs, sub, numbered[cut:], events)
    gs.flush()
    whole = gs.sketch
    return {
        "session": gs,
        "counters": digest(whole.counters),
        "registers": digest(whole.row_flows, whole.col_flows),
        "shard": digest(gs._sketch.counters),
        "transcript": transcript_digest(events),
        "events": len(events),
        "log": log_records_digest(workdir / "wal"),
        "report": None if report is None else (report.step, report.mutations_replayed, report.epoch, report.wal_seq),
        "recover_s": recover_s,
        "restore_s": restore_s,
        "append_ms": appends,
        "batches": len(spans),
    }


def durable_rank(rank, world, tmp, device, argv):
    """(ii) One rank of the durable mesh session on ``DIST_MESH``, the log
    and checkpoints in the ranks' shared directory: digests, report, times
    and this rank's launches."""
    import torch

    from repro_torch.distributed.mesh import Mesh
    from repro_torch.launch import serve

    rank_device(torch, device)
    mesh = Mesh(DIST_MESH, ("data", "model"))
    kernels = counted_kernels()
    for f in kernels.values():
        f.launches = 0
    t0 = time.time()
    out = durable_serve(torch, serve, argv, device, Path(tmp) / "durable", mesh=mesh)
    out["wall_s"] = time.time() - t0
    out["launches"] = {name: kernels[name].launches for name in DURABLE_KERNELS}
    out["coords"] = [mesh.coords["data"], mesh.coords["model"]]
    del out["session"]
    return out


def merge_checks(torch, serve, argv, mesh, device):
    """(iii) ``merge()`` with a mesh session on either side, held to the
    whole-stream session: two mesh sessions fed the halves of the stream,
    merged; a local session's half into a mesh session; a mesh session's
    half into a local session.  Returns the seconds of each merge."""
    from repro_torch.api import GraphStream

    args = serve.build_parser().parse_args(argv)
    data, _, _ = serve.traffic(args)
    spans = [(lo, min(args.edges, lo + args.batch)) for lo in range(0, args.edges, args.batch)]
    half = len(spans) // 2

    def fed(part, on_mesh):
        gs = GraphStream.open(serve._config(args), device=device, mesh=mesh if on_mesh else None)
        for lo, hi in part:
            gs.ingest(data["src"][lo:hi], data["dst"][lo:hi], data["weight"][lo:hi])
        return gs

    whole = fed(spans, False).sketch
    times = {}
    for name, (first, second) in {"mesh into mesh": (True, True), "local into mesh": (True, False),
                                  "mesh into local": (False, True)}.items():
        a, b = fed(spans[:half], first), fed(spans[half:], second)
        before = b.sketch
        t0 = time.perf_counter()
        a.merge(b)
        merged = a.sketch
        times[name] = time.perf_counter() - t0
        for f in ("counters", "row_flows", "col_flows"):
            check(torch.equal(getattr(merged, f), getattr(whole, f)), f"merge {name}: {f} differ from the whole stream's")
            check(torch.equal(getattr(b.sketch, f), getattr(before, f)), f"merge {name}: the merged-in session changed")
        check(a.stats.edges_ingested == args.edges, f"merge {name}: {a.stats.edges_ingested} edges counted")
        del a, b, before, merged
        if device != "cpu":
            release(torch)
    return times


def phase_durable_distributed(torch, serve, argv=SERVE_BASE, device="cuda", backend="nccl"):
    """Durable distributed serve BASE: (i) one ``backend`` rank (NCCL on the
    card), a (1, 1) mesh, in this process: checkpoint after batch 5, crash
    after batch 8, ``seek`` + ``recover()`` + the rest, against the
    uninterrupted single session with the same WAL and checkpoint (counters,
    registers, consumed transcript, the log's records); (ii) the same on
    four gloo ranks on one card, a (2, 2) mesh, against (i); (iii) the
    three ``merge()`` pairings on one-rank meshes against the whole-stream
    session.  Each run's launches are counted from 0."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.mesh import Mesh

    cuda = device != "cpu"
    kernels = counted_kernels()
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-durable-"))
    try:
        single = durable_serve(torch, serve, argv + ["--device", device], device, tmp / "single", crash=False)
        del single["session"]
        if cuda:
            release(torch)
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.FileStore(str(tmp / "store"), 1), rank=0, world_size=1)
        try:
            mesh = Mesh((1, 1), ("data", "model"))
            for f in kernels.values():
                f.launches = 0
            one = durable_serve(torch, serve, argv + ["--device", device], device, tmp / "one", mesh=mesh)
            launches = {name: kernels[name].launches for name in DURABLE_KERNELS}
            sk = one.pop("session")._sketch
            wr_local = sk.counters.shape[1] // DIST_MESH[1]
            want_shards = [digest(sk.counters[:, m * wr_local:(m + 1) * wr_local]) for m in range(DIST_MESH[1])]
            del sk
            if cuda:
                release(torch)
            for f in kernels.values():
                f.launches = 0
            merges = merge_checks(torch, serve, argv + ["--device", device], mesh, device)
            merge_launches = kernels["ingest_scatter"].launches
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = one["batches"]
    replayed = DURABLE_CRASH_AT - DURABLE_CHECKPOINT_AT
    for key in ("counters", "registers", "transcript", "log"):
        check(one[key] == single[key], f"durable distributed serve BASE (i): {key} differ from the single session's")
    check(one["report"] == (DURABLE_CHECKPOINT_AT, replayed, DURABLE_CRASH_AT, one["report"][3]),
          f"durable distributed serve BASE (i): report {one['report']}")
    check(not cuda or launches["ingest_scatter"] == n + replayed,
          f"durable distributed serve BASE (i): {launches['ingest_scatter']} ingest_scatter launches for {n} batches "
          f"and {replayed} replayed")
    check(not cuda or all(v > 0 for v in launches.values()), f"durable distributed serve BASE (i): launches {launches}")
    check(not cuda or merge_launches > 0, "merge: ingest_scatter was not launched")
    med = median(one["append_ms"])
    print(
        f"[chip_smoke] durable distributed serve BASE (i) {backend}, 1 rank, (1, 1) mesh: checkpoint after batch "
        f"{DURABLE_CHECKPOINT_AT}, crash after batch {DURABLE_CRASH_AT}, recover() {one['recover_s']:.3f} s (restore "
        f"{one['restore_s']:.3f} s, replay of {replayed} batches {one['recover_s'] - one['restore_s']:.3f} s; host "
        f"wall clock), rank 0's appends {med:.3f} ms median, {max(one['append_ms']):.3f} ms max over "
        f"{len(one['append_ms'])} (fsync each); launches {launches}; report {one['report']}; counters, registers, "
        f"consumed transcript ({one['events']} events) and the log's records equal to the uninterrupted single "
        f"session's"
    )
    t0 = time.time()
    ranks = spawn_ranks(durable_rank, DIST_MESH[0] * DIST_MESH[1], device, (argv + ["--device", device],))
    spawn_s = time.time() - t0
    for rank, res in enumerate(ranks):
        label = f"durable distributed serve BASE (ii): rank {rank}"
        check(res["shard"] == want_shards[res["coords"][1]], f"{label}: its shard differs from its rows of (i)")
        for key in ("counters", "registers", "transcript", "log", "report"):
            check(res[key] == one[key], f"{label}: {key} differ from (i)")
        check(res["launches"] == launches, f"{label}: launches {res['launches']}, (i) {launches}")
    walls, recovers, restores = (", ".join(f"{r[k]:.2f}" for r in ranks) for k in ("wall_s", "recover_s", "restore_s"))
    print(
        f"[chip_smoke] durable distributed serve BASE (ii) gloo, {len(ranks)} ranks on one card, {DIST_MESH} mesh, "
        f"all {n} batches (no cut): {walls} s by rank ({spawn_s:.1f} s with the ranks' start); recover() {recovers} "
        f"s by rank (restore {restores}); rank 0's appends {median(ranks[0]['append_ms']):.3f} ms median; launches "
        f"per rank {ranks[0]['launches']}; shards equal to (i)'s rows, registers, transcripts, reports and the log "
        f"equal"
    )
    print(
        f"[chip_smoke] durable distributed merge BASE (iii), (1, 1) meshes: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in merges.items())
        + f" (host wall clock, the gather of a mesh operand included); each equal to the whole-stream session, the "
        f"merged-in session unchanged; {merge_launches} ingest_scatter launches"
    )
    return one, ranks


# The GNN path: examples/gnn_sketch_sampling.py's settings, then the
# published widths of configs/graphsage_reddit.py at the minibatch_lg shape
# (src/repro/configs/base.py:87-97) on a synthetic citation graph of its
# size, its edges streamed through a BASE degree sketch.
GNN_EXAMPLE_STEPS = 120
GNN_LOSS_RTOL = 1e-4  # the card's float32 sums (atomics, other GEMM orders) against the CPU's, 5 steps
GNN_LG = dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602, n_classes=41, d_hidden=128, fanouts=(15, 10),
              batch=1024)
GNN_LG_STEPS = 8
GNN_LG_OBSERVE = 1 << 20


def phase_gnn(torch, rows, device="cuda", lg=GNN_LG, lg_steps=GNN_LG_STEPS):
    """The sketch-sampled GraphSAGE path (``launch/gnn_sketch_sampling.py``):
    the example's settings on the card, 120 steps (B1 once an observed
    block), its first 5 losses against the CPU's run of the same seed, the
    loss falling and the final seed accuracy above chance; then
    graphsage-reddit's widths at the minibatch_lg shape, a few steps, with
    the median step ms and the peak GiB."""
    import numpy as np

    from repro_torch.configs.glava import BASE
    from repro_torch.kernels.ingest import ops as ingest_ops
    from repro_torch.launch import gnn_sketch_sampling as gnn

    b1 = ingest_ops.ingest_scatter
    cuda = device != "cpu"
    lines = []
    b1.launches = 0
    run = gnn.main(device=device, steps=GNN_EXAMPLE_STEPS, log=lines.append)
    launches = b1.launches
    cpu = gnn.main(device="cpu", steps=5, log=lambda line: None)
    for line in lines:
        print(f"[chip_smoke] {line}")
    want = -(-gnn.E // gnn.OBSERVE_BATCH)
    check(not cuda or launches == want, f"gnn: {launches} ingest_scatter launches for {want} observed blocks")
    check(np.array_equal(run.estimates, cpu.estimates), "gnn: degree estimates differ from the CPU's")
    check(np.allclose(run.losses[:5], cpu.losses, rtol=GNN_LOSS_RTOL, atol=0.0),
          f"gnn: first losses {run.losses[:5]} differ from the CPU's {cpu.losses}")
    check(all(np.isfinite(run.losses)) and np.mean(run.losses[-10:]) < np.mean(run.losses[:10]),
          f"gnn: the loss does not fall: {run.losses[:3]} ... {run.losses[-3:]}")
    chance = 1.0 / gnn.C
    check(run.accs[-1] > chance, f"gnn: final seed accuracy {run.accs[-1]} not above chance {chance}")
    err = float(np.max(np.abs(np.asarray(run.losses[:5]) - np.asarray(cpu.losses))))
    print(
        f"[chip_smoke] gnn sketch sampling, the example's settings (N={gnn.N:,}, E={gnn.E:,}, F={gnn.F}, C={gnn.C}, "
        f"sketch {gnn.SKETCH.depth}x{gnn.SKETCH.width_rows}x{gnn.SKETCH.width_cols}, fanouts {gnn.FANOUTS}, batch "
        f"{gnn.BATCH}, {GNN_EXAMPLE_STEPS} steps): ingest_scatter {launches} launches; loss {run.losses[0]:.4f} -> "
        f"{run.losses[-1]:.4f}; final seed accuracy {run.accs[-1]:.2f} (chance {chance:.2f}); first 5 losses within "
        f"{err:.2e} of the CPU run (rtol {GNN_LOSS_RTOL}), degree estimates equal; step {1e3 * median(run.step_s):.2f} "
        f"ms median (host wall clock, ending in a host read of the loss)"
    )
    del run, cpu
    if cuda:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
    b1.launches = 0
    t0 = time.time()
    big = gnn.main(device=device, steps=lg_steps, sketch_config=BASE if cuda else gnn.SKETCH,
                   observe_batch=GNN_LG_OBSERVE, log=lambda line: None, **lg)
    total_s = time.time() - t0
    launches = b1.launches
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    want = -(-lg["n_edges"] // GNN_LG_OBSERVE)
    check(not cuda or launches == want, f"gnn minibatch_lg: {launches} ingest_scatter launches for {want} blocks")
    check(all(np.isfinite(big.losses)), f"gnn minibatch_lg: non-finite losses {big.losses}")
    check(bool(np.all(big.estimates >= big.exact)), "gnn minibatch_lg: a degree estimate under the exact degree")
    cut = "all of them (no cut)" if lg["n_edges"] == GNN_LG["n_edges"] else f"cut from {GNN_LG['n_edges']:,}"
    print(
        f"[chip_smoke] gnn sketch sampling, graphsage-reddit minibatch_lg widths (d_in {lg['d_feat']}, "
        f"d_hidden {lg['d_hidden']}, {lg['n_classes']} classes, batch {lg['batch']}, fanouts {lg['fanouts']}): a "
        f"synthetic citation_graph of {lg['n_nodes']:,} nodes and {lg['n_edges']:,} edges, {cut}, streamed through "
        f"a BASE degree sketch in blocks of {GNN_LG_OBSERVE:,} (ingest_scatter {launches} launches); graph "
        f"{big.timings['graph_s']:.1f} s, CSR {big.timings['csr_s']:.1f} s, sketch pass {big.timings['stream_s']:.2f} "
        f"s (host wall clock); degree estimates corr {big.corr:.3f}, none under the exact degree; {lg_steps} steps, "
        f"losses {[round(x, 4) for x in big.losses]}, step {1e3 * median(big.step_s[1:]):.1f} ms median after the "
        f"first ({1e3 * big.step_s[0]:.1f} ms), peak {peak:.2f} GiB; {total_s:.1f} s in all"
    )
    return big


# Mixtral-8x22B at 2 of its 56 layers: depth is the cut, the widths are the
# registry's config (src/repro_torch/configs/mixtral_8x22b.py).
MIXTRAL_LAYERS = 2


def lm_no_drop(cfg) -> float:
    """A capacity factor no token drops from: experts over top-k."""
    return cfg.moe.n_experts / cfg.moe.top_k


# (a) prefill_32k's length at batch 1 (the shape's batch of 32 cut to one
# card), chunks of 512 queries; (b) decode_32k's batch against a full ring;
# (c) a prompt that wraps the ring twice, then decode steps; (d) one layer's
# sharded forms on 4 x 2,048 tokens over four gloo ranks.
LM = dict(prefill=32_768, q_chunk=512, decode_batch=128, decode_len=32_768, decode_steps=16, consist_prompt=8_192,
          consist_steps=16, shard_tokens=(4, 2_048))
LM_SLICING_ATOL = 1e-2     # (a) x max|logit|: bf16 prefill, sliced against masked chunks
LM_CONSIST_ATOL = 1e-3     # (c) x max|logit|: float32, decode against forward (CPU tests: ~1e-6)
LM_SHARD_ATOL = 2e-2       # (d) x max|output|: bf16, partial sums rounded and added in another order
LM_NEAR_TIE = 1e-5         # (d) tokens whose top-2 router margin is under this are counted, not compared
LM_SHARD_MESH = (2, 2)


def lm_config(torch):
    """The served model: the registry's Mixtral-8x22B config at
    MIXTRAL_LAYERS layers in bf16, attention in chunks of LM's q_chunk."""
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("mixtral-8x22b").config, name=f"mixtral-8x22b-{MIXTRAL_LAYERS}l",
                               n_layers=MIXTRAL_LAYERS, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                               attn_q_chunk=LM["q_chunk"])


def lm_step_bytes(cfg, params, batch: int, cap: int) -> int:
    """Bytes one decode step must move: every parameter read once (the
    embedding only at the batch's rows), the whole cache read once, the new
    slot and the float32 logits written."""
    emb = params["embed"]
    n = sum(p.numel() * p.element_size() for p in params["layers"].values())
    n += sum(p.numel() * p.element_size() for k, p in params.items() if k not in ("layers", "embed"))
    n += batch * emb.shape[1] * emb.element_size()
    kv = 2 * cfg.n_layers * batch * cap * cfg.n_kv_heads * cfg.head_dim * 2
    return n + kv + 2 * cfg.n_layers * batch * cfg.n_kv_heads * cfg.head_dim * 2 + batch * cfg.vocab * 4


def lm_timed(torch, fn, device):
    """(result, host wall ms, CUDA-event ms) of one call of ``fn``."""
    if device == "cpu":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0), None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), start.elapsed_time(end)


def lm_prefill(torch, cfg, params, tokens, device):
    """(a) Prefill at both slicing modes: warm-up, a timed call, a profiled
    call; the last logits must agree within LM_SLICING_ATOL x max|logit|
    with equal argmax.  Returns the mode's readings."""
    import dataclasses

    from repro_torch.models import transformer as tfm

    out = {}
    for slicing in (True, False):
        c = dataclasses.replace(cfg, attn_window_slicing=slicing)
        run = lambda c=c: tfm.prefill(c, params, tokens)  # noqa: E731
        with torch.no_grad():
            logits, cache = run()
            if device != "cpu":
                torch.cuda.reset_peak_memory_stats()
            _, wall, ev = lm_timed(torch, run, device)
            peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else None
            busy = profile_breakdown(torch, run)[1] if device != "cpu" else None
        check(bool(torch.isfinite(logits).all()), f"lm serve (a): non-finite logits (slicing={slicing})")
        check(tuple(cache["k"].shape) == (cfg.n_layers, tokens.shape[0], min(cfg.sliding_window, tokens.shape[1]),
                                          cfg.n_kv_heads, cfg.head_dim) and int(cache["len"]) == tokens.shape[1],
              "lm serve (a): the cache's shape or length")
        out[slicing] = dict(logits=logits, wall_ms=wall, event_ms=ev, busy_ms=busy, peak_gib=peak, cache=cache)
    a, b = out[True]["logits"], out[False]["logits"]
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    check(err <= LM_SLICING_ATOL * scale, f"lm serve (a): sliced and masked prefill differ by {err} (max |logit| {scale})")
    check(torch.equal(a.argmax(-1), b.argmax(-1)), "lm serve (a): sliced and masked prefill pick other tokens")
    out["err"], out["scale"] = err, scale
    return out


def lm_decode(torch, cfg, params, gen, device, batch, length, steps):
    """(b) ``steps`` decode steps of ``batch`` tokens against a full ring
    (``len`` = ``length``), each under the sync debug mode "error" on the
    card: (step ms by CUDA events, host ms, the last logits)."""
    from repro_torch.models import transformer as tfm

    cache = tfm.init_cache(cfg, batch, length, device)
    for t in (cache["k"], cache["v"]):
        t.copy_(torch.randn(t.shape, generator=gen, device=device, dtype=torch.float32))
    cache["len"].fill_(length)
    tokens = torch.randint(0, cfg.vocab, (steps + 1, batch), generator=gen, device=device)
    with torch.no_grad():
        tfm.decode_step(cfg, params, tokens[-1], dict(cache, len=cache["len"].clone()))  # warm-up
        ev, wall = [], []
        for i in range(steps):
            if device == "cpu":
                (logits, cache), w, _ = lm_timed(torch, lambda: tfm.decode_step(cfg, params, tokens[i], cache), device)
                ev.append(None)
                wall.append(w)
                continue
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                start.record()
                logits, cache = tfm.decode_step(cfg, params, tokens[i], cache)
                end.record()
            except RuntimeError as exc:
                raise SmokeFailure(f"lm serve (b): decode step {i} synchronizes: {exc}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            end.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
            ev.append(start.elapsed_time(end))
    check(bool(torch.isfinite(logits).all()), "lm serve (b): non-finite decode logits")
    check(int(cache["len"]) == length + steps, "lm serve (b): the cache's length")
    return ev, wall, cache


def lm_consistency(torch, cfg, params, gen, device, prompt, steps):
    """(c) In float32 compute at a capacity no token drops from: prefill
    ``prompt`` tokens, then ``steps`` decode steps, against one ``forward``
    over all of them; the logits at each position within LM_CONSIST_ATOL x
    max|logit| and the same argmax.  Returns (max error, max |logit|)."""
    import dataclasses

    from repro_torch.models import transformer as tfm

    c = dataclasses.replace(cfg, compute_dtype=torch.float32, attn_window_slicing=True,
                            moe=dataclasses.replace(cfg.moe, capacity_factor=lm_no_drop(cfg)))
    tokens = torch.randint(0, c.vocab, (1, prompt + steps), generator=gen, device=device)
    with torch.no_grad():
        logits, cache = tfm.prefill(c, params, tokens[:, :prompt], max_seq=prompt + steps)
        got = [logits]
        for j in range(prompt, prompt + steps):
            logits, cache = tfm.decode_step(c, params, tokens[:, j], cache)
            got.append(logits)
        full, _ = tfm.forward(c, params, tokens)
    want = full[0, prompt - 1:].float()
    got = torch.cat(got)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    check(err <= LM_CONSIST_ATOL * scale, f"lm serve (c): decode differs from forward by {err} (max |logit| {scale})")
    check(torch.equal(got.argmax(-1), want.argmax(-1)), "lm serve (c): decode and forward pick other tokens")
    return err, scale


def lm_shard_inputs(torch, cfg, device, tokens=None):
    """(d)'s inputs, the same in every process from one seed: x (B, S, D),
    the router and one layer's experts (bf16), and q, k, v (B, S, H, Dh)."""
    b, s = tokens or LM["shard_tokens"]
    gen = torch.Generator(device=device).manual_seed(2604)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def draw(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16).mul_(scale)

    return dict(x=draw((b, s, d)), router=draw((d, e), d ** -0.5), wg=draw((e, d, f), d ** -0.5),
                wu=draw((e, d, f), d ** -0.5), wd=draw((e, f, d), f ** -0.5),
                q=draw((b, s, hq, dh)), k=draw((b, s, hkv, dh)), v=draw((b, s, hkv, dh)))


def lm_shard_rank(rank, world, tmp, device, cfg, tokens):
    """(d) One rank of the (2, 2) mesh: ``moe_ffn_sharded`` at both
    partitions at full capacity and ``swa_attention_halo`` on its block of
    the inputs; its outputs (on the host), all-reduce times and bytes."""
    import dataclasses

    import torch

    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models import layers

    rank_device(torch, device)
    mesh = Mesh(LM_SHARD_MESH, ("data", "model"))
    inp = lm_shard_inputs(torch, cfg, device, tokens)
    b, s = inp["x"].shape[0] // mesh.shape["data"], inp["x"].shape[1] // mesh.shape["model"]
    i, j = mesh.coords["data"], mesh.coords["model"]

    def block(t):
        return t[i * b:(i + 1) * b, j * s:(j + 1) * s].contiguous()

    out = {"coords": (i, j)}
    clock = CollectiveClock(torch, mesh)
    with torch.no_grad():
        for partition in ("ffn", "expert"):
            args = dataclasses.replace(cfg.moe, partition=partition, capacity_factor=lm_no_drop(cfg), mesh=mesh)
            shards = layers.moe_weight_shards(inp["wg"], inp["wu"], inp["wd"], args)
            first = len(clock.calls)
            y, aux = layers.moe_ffn_sharded(block(inp["x"]), inp["router"], *shards, args)
            out[partition] = (y.cpu(), float(aux), [c[:4] for c in clock.calls[first:]])
            del shards, y
        q, k, v = (block(inp[n]) for n in ("q", "k", "v"))
        del inp
        first = len(clock.calls)
        o = layers.swa_attention_halo(q, k, v, sliding_window=cfg.sliding_window, mesh=mesh,
                                      q_chunk=min(LM["q_chunk"], s))
        out["halo"] = (o.cpu(), None, [c[:4] for c in clock.calls[first:]])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else 0.0
    return out


def lm_sharded(torch, cfg, device, tokens):
    """(d) The sharded forms on four gloo ranks against their single-rank
    counterparts computed here first: ``moe_block`` on all the tokens at
    full capacity, dense masked ``gqa_attention``.  Returns a summary."""
    import dataclasses

    from repro_torch.models import layers

    inp = lm_shard_inputs(torch, cfg, device, tokens)
    t0 = time.perf_counter()
    with torch.no_grad():
        x = inp["x"]
        flat = x.reshape(-1, x.shape[-1])
        args = dataclasses.replace(cfg.moe, capacity_factor=lm_no_drop(cfg))
        want_moe, want_aux = layers.moe_block(flat, inp["router"], inp["wg"], inp["wu"], inp["wd"], args)
        want_moe = want_moe.reshape(x.shape).cpu()
        probs = torch.softmax(flat.float() @ inp["router"].float(), -1)
        top = torch.topk(probs, 3, dim=-1).values
        near = (top[:, 1] - top[:, 2] <= LM_NEAR_TIE).reshape(x.shape[:2]).cpu()
        want_halo = layers.gqa_attention(inp["q"], inp["k"], inp["v"], causal=True,
                                         sliding_window=cfg.sliding_window).cpu()
    single_s = time.perf_counter() - t0
    del inp, x, flat, probs
    if device != "cpu":
        release(torch)
    t0 = time.perf_counter()
    ranks = spawn_ranks(lm_shard_rank, 4, device, args=(cfg, tokens), timeout=600.0)
    ranks_s = time.perf_counter() - t0
    b, s = want_moe.shape[0] // LM_SHARD_MESH[0], want_moe.shape[1] // LM_SHARD_MESH[1]
    summary = {"near_ties": int(near.sum()), "single_s": single_s, "ranks_s": ranks_s,
               "peak_gib": max(r["peak_gib"] for r in ranks)}
    for name in ("ffn", "expert", "halo"):
        want = want_halo if name == "halo" else want_moe
        scale = float(want.float().abs().max())
        errs, calls = [], []
        for r in ranks:
            i, j = r["coords"]
            got = r[name][0].float()
            mine = want[i * b:(i + 1) * b, j * s:(j + 1) * s].float()
            tied = near[i * b:(i + 1) * b, j * s:(j + 1) * s]
            keep = torch.ones_like(tied) if name == "halo" else ~tied
            errs.append(float((got - mine).abs()[keep].max()))
            calls.extend(r[name][-1])
        if name != "halo":  # pmean'd: one value on every rank
            check(len({r[name][1] for r in ranks}) == 1, f"lm serve (d): {name} aux differs between ranks")
            summary[name + "_aux"] = (ranks[0][name][1], float(want_aux))
        err = max(errs)
        check(err <= LM_SHARD_ATOL * scale, f"lm serve (d): {name} differs from its single-rank form by {err} "
                                            f"(max |output| {scale})")
        summary[name] = dict(err=err, scale=scale, n_allreduce=len(calls) // 4,
                             allreduce_ms=sum(c[3] for c in calls) / 4,
                             allreduce_bytes=sum(c[2] for c in calls) / 4)
    return summary


def phase_lm_serve(torch, drive, counted, device="cuda", cfg=None, sizes=None):
    """The LM serving path at Mixtral-8x22B's widths (2 of 56 layers, random
    bf16 weights from a seed): (a) prefill at prefill_32k's length, window
    slicing on and off; (b) decode at decode_32k's batch against a full
    ring cache, sync-free; (c) prefill + decode against one forward in
    float32; (d) the sharded MoE and halo attention on four gloo ranks.
    None of it launches a hand-written kernel (the reference computes the
    LM in plain jnp): the counts stay 0.  Prints a line each; a failure
    raises.  ``cfg``: the served model (``lm_config``'s by default)."""
    import dataclasses
    import statistics

    from repro_torch.models import transformer as tfm

    sizes = sizes or LM
    smi = nvidia_smi() if device != "cpu" else "cpu"
    cfg = dataclasses.replace(cfg or lm_config(torch), attn_q_chunk=sizes["q_chunk"])
    gen = torch.Generator(device=device).manual_seed(26)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen, device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in [*params["layers"].values(), *(v for k, v in params.items() if k != "layers")])
    tokens = torch.randint(0, cfg.vocab, (1, sizes["prefill"]), generator=gen, device=device)

    def run():
        pre = lm_prefill(torch, cfg, params, tokens, device)
        dec = lm_decode(torch, cfg, params, gen, device, sizes["decode_batch"], sizes["decode_len"],
                        sizes["decode_steps"])
        return pre, dec

    pre, (ev, wall, cache) = drive((), run)
    launched = {name: f.launches for name, f in counted.items() if f.launches}
    check(not launched, f"lm serve: the LM path launched the port's kernels {launched}")
    s, m = pre[True], pre[False]
    print(f"[chip_smoke] lm serve ({smi}): mixtral-8x22b widths (the registry's config), {cfg.n_layers} of 56 "
          f"layers, {n_params:,} bf16 parameters "
          f"(drawn in {init_s:.1f} s), no kernel of the port on the path (launch counts 0)")
    gib = {k: "not measured" if v["peak_gib"] is None else f"{v['peak_gib']:.4f} GiB" for k, v in ((0, s), (1, m))}
    print(f"[chip_smoke] lm serve (a) prefill 1 x {sizes['prefill']:,}, q_chunk {cfg.attn_q_chunk}, capacity "
          f"{cfg.moe.capacity_factor}: "
          f"window-sliced wall {s['wall_ms']:.1f} ms, events {_fmt(s['event_ms'])}, device busy "
          f"{_fmt(s['busy_ms'])}, peak {gib[0]}; masked wall {m['wall_ms']:.1f} ms, events {_fmt(m['event_ms'])}, "
          f"device busy {_fmt(m['busy_ms'])}, peak {gib[1]}; last logits max |diff| {pre['err']:.6g} (max |logit| "
          f"{pre['scale']:.6g}, tolerance {LM_SLICING_ATOL} x), argmax equal")
    del pre, s, m
    bound_ms = lm_step_bytes(cfg, params, sizes["decode_batch"], cache["k"].shape[2]) / PEAK_BYTES_PER_S * 1e3
    ev_ok = [e for e in ev if e is not None]
    step = f"{_fmt(statistics.median(ev_ok))} a step median by CUDA events (min {_fmt(min(ev_ok))})" if ev_ok \
        else "not measured"
    print(f"[chip_smoke] lm serve (b) decode batch {sizes['decode_batch']} against a full ring of "
          f"{cache['k'].shape[2]:,} slots (len {sizes['decode_len']:,}), {len(wall)} steps, each sync-free under "
          f"sync debug mode 'error': {step}, host {statistics.median(wall):.3f} ms; bound {bound_ms:.4f} ms (bytes: "
          f"every weight and the whole cache read once at 3.35 TB/s)")
    del cache
    if device != "cpu":
        release(torch)
    err, scale = lm_consistency(torch, cfg, params, gen, device, sizes["consist_prompt"], sizes["consist_steps"])
    print(f"[chip_smoke] lm serve (c) float32, capacity {lm_no_drop(cfg)}: prefill {sizes['consist_prompt']:,} (the ring of "
          f"{cfg.sliding_window} wraps {sizes['consist_prompt'] // cfg.sliding_window} times) + "
          f"{sizes['consist_steps']} decode steps against one forward over {sizes['consist_prompt'] + sizes['consist_steps']:,} "
          f"tokens: max |diff| {err:.6g} (max |logit| {scale:.6g}, tolerance {LM_CONSIST_ATOL} x), argmax equal")
    del params
    if device != "cpu":
        release(torch)
    sh = lm_sharded(torch, cfg, device, sizes["shard_tokens"])
    parts = "; ".join(
        f"{n} max |diff| {sh[n]['err']:.6g} (max {sh[n]['scale']:.6g}), {sh[n]['n_allreduce']} all-reduces a rank, "
        f"{sh[n]['allreduce_bytes'] / 2**20:.1f} MiB and {sh[n]['allreduce_ms']:.1f} ms a rank"
        for n in ("ffn", "expert", "halo"))
    print(f"[chip_smoke] lm serve (d) 4 gloo ranks on one card, mesh (2, 2), {sizes['shard_tokens'][0]} x "
          f"{sizes['shard_tokens'][1]:,} tokens, one layer, MoE at capacity {lm_no_drop(cfg)} (near-tied tokens excluded: "
          f"{sh['near_ties']}; aux ffn {sh['ffn_aux'][0]:.6g}, expert {sh['expert_aux'][0]:.6g}, unsharded "
          f"{sh['ffn_aux'][1]:.6g}): {parts}; tolerance {LM_SHARD_ATOL} x; ranks {sh['ranks_s']:.1f} s, single-rank "
          f"forms {sh['single_s']:.1f} s, peak {sh['peak_gib']:.2f} GiB a rank")


# The other models (A12b) at their registry configs' full widths.  BERT4Rec's
# train_batch cut from 65,536 to the largest power of two at most B4R_BATCH
# whose forward and backward peak under B4R_PEAK_GIB; serve_bulk's 262,144
# cut to one card's 4,096 (its (B, vocab) float32 logits are 1.05 TB at full
# size).  The GNNs run at their shapes; minibatch_lg's block comes from a
# synthetic citation graph smaller than reddit's (the block's shape is not).
B4R = dict(batch=16_384, steps=6, check_batch=64, serve_bulk=4_096)
B4R_PEAK_GIB = 72.0
# One step at batch 64, card vs CPU: (|loss_card - loss_cpu| / |loss_cpu|,
# ||grad_card - grad_cpu|| / ||grad_cpu|| over every leaf) by compute dtype.
# bf16: GEMM outputs rounded to bf16 after float32 sums in other orders
# (readings 5.98e-6 and 1.32e-3 on an H100, the same in every run); a
# control (b4r_bf16_scores: the float32 attention logits and sampled scores
# rounded to bf16) moves it less than that (1.15e-6, 1.92e-3), so only the
# float32 step can catch it (readings 0 and 2.13e-7, the control's 4.6e-6
# and 3.73e-4): the phase checks that the control fails the float32 limits.
B4R_STEP_RTOL = {"bfloat16": (5e-5, 5e-3), "float32": (1e-6, 1e-5)}
B4R_SCORE_ATOL = 1e-5  # x max|score|: score_candidates against score_all_items gathered (f32, other orders)
GNN_STEPS = 5
GNN_LOSS_RTOL = 1e-4   # card vs CPU, float32 (TF32 off): atomics and GEMMs in other orders
GNN_GRAD_RTOL = 1e-3   # ||grad_card - grad_cpu|| / ||grad_cpu||
# DimeNet on the minibatch_lg block (1,351,680 triplets): the CPU's forward
# only; its gradients are compared on the molecule shape.
GNN_CPU_FORWARD_ONLY = {("dimenet", "gnn_minibatch")}
GNN_CELLS = (("gat-cora", "full_graph_sm"), ("schnet", "molecule"), ("dimenet", "molecule"),
             ("gat-cora", "minibatch_lg"), ("schnet", "minibatch_lg"), ("dimenet", "minibatch_lg"))
# H100 SXM published dense peaks (NVIDIA data sheet): float32 outside the
# tensor cores (TF32 is off) and bf16 on them, operations/s.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def grads_of(torch, loss_fn, params):
    """(loss, gradient leaves) of ``loss_fn`` at ``params``."""
    from repro_torch.tree import tree_leaves, tree_map

    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return float(loss.detach()), [g.float().cpu() for g in grads]


def rel_err(torch, got, want) -> float:
    """||got - want|| / ||want|| over lists of tensors."""
    num = sum(float(torch.sum((g - w) ** 2)) for g, w in zip(got, want, strict=True))
    den = sum(float(torch.sum(w ** 2)) for w in want)
    return (num / den) ** 0.5


def to_device(torch, tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.to(device), tree)


def profile_breakdown(torch, fn):
    """(device busy ms, {kernel: ms}) of one profiled call of ``fn``: the
    sum over the trace's device events, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_preroll(torch)
        out = fn()
        torch.cuda.synchronize()
    by = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
          if getattr(e, "device_time_total", 0.0) and "spin_kernel" not in e.key}
    return out, (sum(by.values()) if by else None), by


def _gib(x) -> str:
    return "not measured" if x is None else f"{x:.2f} GiB"


def top_kernels(by: dict, n: int = 5) -> str:
    return ", ".join(f"{k[:48]} {v:.3f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]) or "none"


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def b4r_batches(bundle, rng):
    """Train batches cut from the BERT4Rec bundle's ``make_batch`` (the
    reference's train_batch: 65,536 users a call): ``take(batch)`` returns
    the next ``batch`` users' numpy batch (no negatives) and their user-item
    interaction stream (the Cloze targets put back into the masked items;
    consecutive user ids)."""
    import numpy as np

    from repro_torch.data import recsys

    pool = {"left": 0, "users": 0}

    def take(batch: int):
        if pool["left"] < batch:
            full = bundle.make_batch(rng)
            full.pop("negatives")
            pool.update(full=full, at=0, left=len(full["items"]))
        at = pool["at"]
        pool["at"], pool["left"] = at + batch, pool["left"] - batch
        part = {k: v[at:at + batch] for k, v in pool["full"].items()}
        items = part["items"].copy()
        r, c = np.nonzero(part["mask_targets"])
        items[r, part["mask_positions"][r, c]] = part["mask_targets"][r, c]
        users = np.arange(pool["users"], pool["users"] + batch, dtype=np.uint32)
        pool["users"] += batch
        return part, recsys.interaction_stream(items, users)

    return take


def b4r_loss(bundle, part, negatives, device):
    """The bundle's ``cloze_loss_sampled`` on the numpy batch ``part`` and
    ``negatives``, on ``device``, as a function of the parameters."""
    batch = bundle.to_tensors(dict(part, negatives=negatives), device)
    return lambda params: bundle.loss_fn(params, batch)[0]


def b4r_bf16_scores(torch):
    """A control for the bf16 check: every float32 ``torch.einsum`` output
    (BERT4Rec's attention logits and sampled-softmax scores) rounded to
    bf16, as a port that computed them in bf16 would give.  A context
    manager."""
    import contextlib

    einsum = torch.einsum

    def rounded(eq, *ops):
        y = einsum(eq, *ops)
        return y.to(torch.bfloat16).to(torch.float32) if y.dtype == torch.float32 else y

    @contextlib.contextmanager
    def patched():
        torch.einsum = rounded
        try:
            yield
        finally:
            torch.einsum = einsum

    return patched()


def b4r_step_bounds(cfg, batch: int):
    """(operations bound ms, float32 attention-logit bytes bound ms) of one
    train_batch step, by shapes.  Operations: the GEMMs of the forward pass
    and twice them for the backward, the float32 ones (the attention logits
    from q and k, the sampled-softmax scores) at the float32 peak, the bf16
    ones at bf16's.  Bytes: the (B, h, S, S) float32 logits written and read
    once each in the forward and the backward pass of every block."""
    b, s, d, h, m, k = batch, cfg.seq_len, cfg.embed_dim, cfg.n_heads, cfg.max_masked, cfg.n_negatives
    f = d * cfg.d_ff_mult
    bf16 = cfg.n_blocks * (2 * b * s * d * d * 4 + 2 * 2 * b * s * d * f + 2 * b * s * s * d)  # proj, FFN, PV
    f32 = cfg.n_blocks * 2 * b * s * s * d + 2 * b * m * (k + 1) * d  # QK^T, sampled scores
    ops_ms = 3 * (bf16 / PEAK_BF16_FLOPS + f32 / PEAK_F32_FLOPS) * 1e3
    logit_bytes = cfg.n_blocks * 4 * (b * h * s * s * 4)
    return ops_ms, logit_bytes / PEAK_BYTES_PER_S * 1e3


def b4r_fit_batch(torch, bundle, params, device, part, negs):
    """The largest power of two at most ``part``'s users whose forward and
    backward of cloze_loss_sampled peak under B4R_PEAK_GIB (halving on a
    larger peak or an out-of-memory error).  Returns (batch, peak GiB)."""
    batch = len(part["items"])
    while batch >= 1:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        try:
            grads_of(torch, b4r_loss(bundle, {k: v[:batch] for k, v in part.items()}, negs, device), params)
            peak = torch.cuda.max_memory_allocated() / 2**30
        except torch.cuda.OutOfMemoryError:
            peak = None
        if peak is not None and peak <= B4R_PEAK_GIB:
            return batch, peak
        print(f"[chip_smoke] models (a): batch {batch:,} peaks at "
              f"{'out of memory' if peak is None else f'{peak:.2f} GiB'}, over {B4R_PEAK_GIB} GiB: halved")
        batch //= 2
    raise SmokeFailure("models (a): no batch fits")


def phase_models_b4r(torch, counted, device="cuda", sizes=None):
    """(a) BERT4Rec's train_batch at the registry's FULL config: each step streams the batch's interactions into one
    InteractionPopularitySketch (B1 once a batch), draws its negatives from
    it, then cloze_loss_sampled forward and backward and AdamW; a twin
    sketch on the CPU (the plain path) takes the same streams and must hold
    the same counters and draw the same negatives; one step at batch 64
    against the CPU, in the config's compute dtype and in float32, and a
    control that the float32 limits must catch.  Prints a line each; returns the config, the trained
    parameters and the generator."""
    import copy
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.integration.popularity import InteractionPopularitySketch
    from repro_torch.launch.steps import build_step
    from repro_torch.tree import tree_leaves

    sizes = sizes or B4R
    spec = get_arch("bert4rec")
    cfg = spec.config
    cuda = device != "cpu"
    bundle = build_step("bert4rec", "train_batch", device=device)
    state = bundle.init_state(torch.Generator(device=device).manual_seed(27))
    params = state["params"]
    n_params = sum(x.numel() for x in tree_leaves(params))
    take = b4r_batches(bundle, np.random.default_rng(2702))

    # One step at batch 64 on the card against the same step on the CPU.
    rng = np.random.default_rng(2701)
    part, _ = take(sizes["check_batch"])
    negs = rng.integers(1, cfg.n_items + 1, cfg.n_negatives).astype(np.int32)
    cpu_params = to_device(torch, params, "cpu")
    agree = []
    for dt in dict.fromkeys((cfg.compute_dtype, torch.float32)):
        c = build_step("bert4rec", "train_batch", config_override=dataclasses.replace(cfg, compute_dtype=dt),
                       device=device)
        name = str(dt)[6:]
        loss_tol, grad_tol = B4R_STEP_RTOL[name]
        card_loss, card_g = grads_of(torch, b4r_loss(c, part, negs, device), params)
        cpu_fn = b4r_loss(c, part, negs, "cpu")
        cpu_loss, cpu_g = grads_of(torch, cpu_fn, cpu_params)
        err = (abs(card_loss - cpu_loss) / abs(cpu_loss), rel_err(torch, card_g, cpu_g))
        check(np.isfinite(card_loss) and err[0] <= loss_tol and err[1] <= grad_tol,
              f"models (a): {name}, batch {sizes['check_batch']}: loss {card_loss} on the card, {cpu_loss} on the "
              f"CPU, gradients {err[1]:.3g} apart")
        agree.append(f"{name}: loss {card_loss:.6f} vs {cpu_loss:.6f} (rel {err[0]:.3g}), gradients rel "
                     f"{err[1]:.3g}; tolerances {loss_tol}, {grad_tol}")
        if dt == torch.float32:
            with b4r_bf16_scores(torch):
                ctl_loss, ctl_g = grads_of(torch, cpu_fn, cpu_params)
            ctl = (abs(ctl_loss - cpu_loss) / abs(cpu_loss), rel_err(torch, ctl_g, cpu_g))
            check(ctl[0] > loss_tol or ctl[1] > grad_tol, f"models (a): the control (logits and scores rounded "
                                                          f"to bf16) passes the float32 limits: {ctl}")
            agree.append(f"the control on the CPU, float32: loss rel {ctl[0]:.3g}, gradients rel {ctl[1]:.3g} "
                         f"(caught)")
        del card_g, cpu_g, cpu_fn
    del cpu_params

    if cuda:
        fit_part, _ = take(sizes["batch"])
        batch, fit_peak = b4r_fit_batch(torch, bundle, params, device, fit_part, negs)
        del fit_part
    else:
        batch, fit_peak = sizes["batch"], None
    pop = InteractionPopularitySketch(cfg.n_items, device=device)
    host = InteractionPopularitySketch(cfg.n_items, device="cpu")  # the plain path, fed the same streams
    exact = np.zeros(cfg.n_items + 1, np.int64)
    fed = []  # each batch's stream, sample_negatives' generator before the draw, the card's negatives
    b1 = counted["ingest_scatter"]
    for f in counted.values():
        f.launches = 0
    if cuda:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms, host_ms = [], [], []
    busy, by, feed_busy, feed_by = None, {}, None, {}
    for step in range(sizes["steps"]):
        profiled = cuda and step == sizes["steps"] - 1  # the last step under the profiler
        t0 = time.perf_counter()
        part, stream = take(batch)
        exact += np.bincount(stream["dst"], minlength=cfg.n_items + 1)
        twin = copy.deepcopy(rng)

        def feed():
            pop.observe(stream["src"], stream["dst"])
            return pop.sample_negatives(cfg.n_negatives, rng)

        negs, feed_busy, feed_by = profile_breakdown(torch, feed) if profiled else (feed(), None, {})
        batch_in = bundle.to_tensors(dict(part, negatives=negs))
        t1 = time.perf_counter()
        if profiled:
            (state, metrics), busy, by = profile_breakdown(torch, lambda: bundle.step(state, batch_in))
        else:
            state, metrics = bundle.step(state, batch_in)
        loss = metrics["loss"]
        losses.append(loss.item())
        step_ms.append(1e3 * (time.perf_counter() - t1))
        host_ms.append(1e3 * (t1 - t0))
        fed.append((stream, twin, negs))
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    reserved = torch.cuda.max_memory_reserved() / 2**30 if cuda else None
    launches = {name: f.launches for name, f in counted.items() if f.launches}
    check(not cuda or launches == {"ingest_scatter": sizes["steps"]},
          f"models (a): launches {launches} for {sizes['steps']} observed batches (want ingest_scatter once each)")
    check(all(np.isfinite(losses)), f"models (a): non-finite losses {losses}")
    seen = np.nonzero(exact)[0]
    est = pop.item_popularity(seen.astype(np.uint32))
    under = int(np.sum(est < exact[seen]))
    check(under == 0, f"models (a): {under} of {len(seen)} streamed items' popularity under their exact count")
    # The plain path replays the streams after the timed steps.  Integer
    # weights: every register is an exact float32 sum below 2^24, in any
    # order, so B1's counters equal the plain path's bit for bit.
    other_negs = 0
    for stream, twin, negs in fed:
        host.observe(stream["src"], stream["dst"])
        other_negs += not np.array_equal(host.sample_negatives(cfg.n_negatives, twin), negs)
    del fed
    regs = ("counters", "row_flows", "col_flows")
    top = max(float(getattr(host.sketch, r).max()) for r in regs)
    differ = [r for r in regs if not torch.equal(getattr(pop.sketch, r).cpu(), getattr(host.sketch, r))]
    check(top < 2**24 and not differ and other_negs == 0,
          f"models (a): the card's sketch against the plain path's: registers {differ} differ (largest {top:,.0f}), "
          f"{other_negs} of {sizes['steps']} batches drew other negatives")
    ops_ms, logit_ms = b4r_step_bounds(cfg, batch)
    timed = step_ms[1:-1] if len(step_ms) > 2 else step_ms
    smi = nvidia_smi() if cuda else "cpu"
    traced = [v for k, v in feed_by.items() if "ingest_kernel" in k]
    ingest_ms = sum(traced) if traced else None  # None: the trace lost the launch
    print(f"[chip_smoke] models (a) bert4rec train_batch through build_step ({smi}): the registry's FULL config "
          f"({cfg.n_items:,} items, vocab {cfg.vocab:,}, embed {cfg.embed_dim}, {cfg.n_blocks} blocks, {cfg.n_heads} heads, sequence "
          f"{cfg.seq_len}, {cfg.n_negatives:,} negatives, {str(cfg.compute_dtype)[6:]} compute; {n_params:,} "
          f"parameters); batch cut from {spec.shapes['train_batch'].params['batch']:,} to {batch:,} (forward and "
          f"backward peak {_gib(fit_peak)}, limit {B4R_PEAK_GIB} GiB); {sizes['steps']} steps: losses "
          f"{[round(x, 4) for x in losses]}, step {median(timed):.1f} ms median (forward, backward, AdamW; host "
          f"clock ending in a read of the loss), data and sketch {median(host_ms):.1f} ms a batch on the host; "
          f"peak {_gib(peak)} ({_gib(reserved)} reserved); bounds {ops_ms:.3f} ms (operations: f32 GEMMs at 67 TFLOP/s, bf16 at 989) and "
          f"{logit_ms:.3f} ms (bytes: the f32 attention logits, 4 passes a block)")
    print(f"[chip_smoke] models (a) popularity sketch {pop.sketch.config.depth} x {pop.sketch.config.width_rows:,} "
          f"users x {pop.sketch.config.width_cols:,} items: ingest_scatter {b1.launches} launches for "
          f"{sizes['steps']} observed batches ({int(exact.sum()):,} interactions); counters and both flow registers "
          f"equal to a CPU sketch's (the plain path) fed the same streams (largest register {top:,.0f}), the same "
          f"{cfg.n_negatives:,} negatives drawn in every batch; item popularity >= the exact "
          f"count for all {len(seen):,} streamed items; the last batch's observe and sample_negatives profiled: device "
          f"busy {_fmt(feed_busy)}, ingest_kernel {_fmt(ingest_ms)}; its training step: device busy {_fmt(busy)}, "
          f"top kernels (ms) {top_kernels(by)}")
    print(f"[chip_smoke] models (a) batch {sizes['check_batch']} on the card against the CPU, same parameters and "
          f"inputs (the control: the float32 attention logits and sampled scores rounded to bf16): "
          f"{'; '.join(agree)}")
    params = state["params"]
    del state, pop, host
    return cfg, params, rng


def phase_models_serve(torch, cfg, params, rng, device="cuda", sizes=None):
    """(b) BERT4Rec serving at the registry's recsys shapes: serve_p99 and
    serve_bulk (cut) through score_all_items, retrieval_cand through
    score_candidates, each timed with CUDA events; the candidate scores
    equal the full scores gathered at the candidates."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.data import recsys
    from repro_torch.models.recsys import bert4rec

    sizes = sizes or B4R
    cuda = device != "cpu"
    shapes = get_arch("bert4rec").shapes
    p = recsys.item_popularity(cfg.n_items)
    parts = []
    with torch.no_grad():
        for name in ("serve_p99", "serve_bulk"):
            full = shapes[name].params["batch"]
            batch = min(full, sizes["serve_bulk"])
            items = torch.from_numpy(recsys.interaction_sequences(cfg.n_items, batch, cfg.seq_len, rng, p)).to(device)
            if cuda:
                release(torch)
            fn = lambda: bert4rec.score_all_items(cfg, params, items)  # noqa: E731
            out = fn()
            check(tuple(out.shape) == (batch, cfg.vocab) and bool(torch.isfinite(out).all()),
                  f"models (b): {name} scores")
            del out
            if cuda:  # the peak of the serving calls alone, not of the check's temporaries
                torch.cuda.reset_peak_memory_stats()
            ms = time_ms(fn, 3) if cuda else None
            peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
            bound = max(2 * batch * cfg.embed_dim * cfg.vocab / PEAK_F32_FLOPS,
                        (4 * batch * cfg.vocab + 4 * cfg.vocab * (cfg.embed_dim + 1)) / PEAK_BYTES_PER_S) * 1e3
            cut = "full" if batch == full else f"cut from {full:,}"
            parts.append(f"{name} batch {batch:,} ({cut}) {_fmt(ms)}, bound {bound:.3f} ms (the last position's "
                         f"GEMM against the table at the f32 peak, or its logits written), peak {_gib(peak)}")
            del items
        n_cand = shapes["retrieval_cand"].params["n_candidates"]
        items = torch.from_numpy(recsys.interaction_sequences(cfg.n_items, 1, cfg.seq_len, rng, p)).to(device)
        cands = torch.from_numpy(rng.integers(1, cfg.n_items + 1, (1, n_cand)).astype(np.int32)).to(device)
        fn = lambda: bert4rec.score_candidates(cfg, params, items, cands)  # noqa: E731
        got = fn()
        full = bert4rec.score_all_items(cfg, params, items)
        want = torch.gather(full, 1, cands.long())
        err, scale = float((got - want).abs().max()), float(full.abs().max())
        check(err <= B4R_SCORE_ATOL * scale, f"models (b): score_candidates differs from score_all_items by {err} "
                                             f"(max |score| {scale})")
        ms = time_ms(fn, 5) if cuda else None
        bound = (n_cand * (cfg.embed_dim + 2) * 4 + n_cand * 4) / PEAK_BYTES_PER_S * 1e3
    parts.append(f"retrieval_cand 1 x {n_cand:,} candidates (full) {_fmt(ms)}, bound {bound:.4f} ms (bytes: the "
                 f"candidates' rows, ids and biases read, the scores written); equal to score_all_items gathered "
                 f"within {err:.3g} (max |score| {scale:.4g}, tolerance {B4R_SCORE_ATOL} x)")
    print(f"[chip_smoke] models (b) bert4rec serving (CUDA events, mean of 3-5 calls after one): {'; '.join(parts)}")


def dimenet_bilinear_bound_ms(cfg, n_triplets: int) -> float:
    """The bilinear mix's float32 GEMM (T, s·b) x (s·b, f), forward and
    twice for the backward, over every block, at the float32 peak."""
    s = cfg.n_spherical * cfg.n_radial
    return 3 * cfg.n_blocks * 2 * n_triplets * s * cfg.n_bilinear * cfg.d_hidden / PEAK_F32_FLOPS * 1e3


def phase_models_gnn(torch, counted, device="cuda", steps=GNN_STEPS, cells=GNN_CELLS):
    """(c) GAT, SchNet and DimeNet at their FULL configs on full_graph_sm,
    molecule and minibatch_lg, each through its ``build_step`` bundle (the
    reference's batch from ``make_batch``): the bundle's step (forward,
    backward, AdamW) for ``steps`` steps (finite losses), the first step's
    loss and gradients on the card against the CPU's from the same
    parameters.  No kernel of the port is on these paths: every launch count
    stays 0."""
    import numpy as np

    from repro_torch.launch.steps import build_step
    from repro_torch.tree import tree_leaves

    cuda = device != "cpu"
    for f in counted.values():
        f.launches = 0
    for arch_id, shape_name in cells:
        bundle = build_step(arch_id, shape_name, device=device)
        t0 = time.perf_counter()
        d = bundle.make_batch(np.random.default_rng(2703))
        data_s = time.perf_counter() - t0
        card_batch, cpu_batch = bundle.to_tensors(d), bundle.to_tensors(d, "cpu")
        trip = ""
        if "triplets" in d["graph"]:
            n_trip = len(d["graph"]["triplets"]["in"])
            trip = f", {int(d['graph']['triplets']['mask'].sum()):,} triplets in a budget of {n_trip:,}"
        state = bundle.init_state(torch.Generator().manual_seed(27))
        card_fn = lambda p: bundle.loss_fn(p, card_batch)[0]  # noqa: E731
        cpu_fn = lambda p: bundle.loss_fn(p, cpu_batch)[0]  # noqa: E731
        card_loss, card_g = grads_of(torch, card_fn, state["params"])
        cpu_params = to_device(torch, state["params"], "cpu")
        if (arch_id, bundle.kind) in GNN_CPU_FORWARD_ONLY:
            with torch.no_grad():
                cpu_loss, grad_err = float(cpu_fn(cpu_params)), None
            against = "the CPU's forward (its backward takes tens of seconds there)"
        else:
            cpu_loss, cpu_g = grads_of(torch, cpu_fn, cpu_params)
            grad_err = rel_err(torch, card_g, cpu_g)
            against = "the CPU"
            del cpu_g
        loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
        check(loss_err <= GNN_LOSS_RTOL and (grad_err is None or grad_err <= GNN_GRAD_RTOL),
              f"models (c): {arch_id} {shape_name}: loss {card_loss} on the card, {cpu_loss} on the CPU, "
              f"gradients {grad_err} apart")
        del card_g, cpu_params, cpu_batch
        if cuda:
            release(torch)
            torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(steps):
            t1 = time.perf_counter()
            state, metrics = bundle.step(state, card_batch)
            losses.append(metrics["loss"].item())
            step_ms.append(1e3 * (time.perf_counter() - t1))
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
        check(all(np.isfinite(losses)), f"models (c): {arch_id} {shape_name}: non-finite losses {losses}")
        n_params = sum(x.numel() for x in tree_leaves(state["params"]))
        bound = ""
        if arch_id == "dimenet":
            bound = (f"; bound of the bilinear GEMMs alone "
                     f"{dimenet_bilinear_bound_ms(bundle.config, len(d['graph']['triplets']['in'])):.3f} ms (f32 at "
                     f"67 TFLOP/s, padded triplets included)")
        print(f"[chip_smoke] models (c) {arch_id} {shape_name} through build_step ({bundle.notes}{trip}; make_batch "
              f"{data_s:.1f} s on the host): {n_params:,} parameters; {steps} steps, losses "
              f"{[round(x, 4) for x in losses]}, step {median(step_ms[1:]):.1f} ms median after the first "
              f"({step_ms[0]:.1f} ms; forward, backward, AdamW, host clock ending in a read of the loss), peak "
              f"{_gib(peak)}{bound}; first step against {against}: loss rel {loss_err:.3g} (tolerance "
              f"{GNN_LOSS_RTOL}), gradients rel {'not compared' if grad_err is None else f'{grad_err:.3g}'} "
              f"(tolerance {GNN_GRAD_RTOL})")
        del state, card_batch, d
        if cuda:
            release(torch)
    launched = {name: f.launches for name, f in counted.items() if f.launches}
    check(not launched, f"models (c): the GNN paths launched the port's kernels {launched}")


def phase_models(torch, counted, device="cuda"):
    """The other models (A12b) at the registry's FULL configs: (a) BERT4Rec's
    train_batch fed by the gLava popularity sketch (B1 once a batch), (b)
    its serving shapes, (c) GAT, SchNet and DimeNet at their shapes."""
    t0 = time.time()
    cuda = device != "cpu"
    if cuda:  # BERT4Rec's steps free and allocate 5-6 GiB tensors in turn: let segments grow instead
        release(torch)
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        cfg, params, rng = phase_models_b4r(torch, counted, device)
        phase_models_serve(torch, cfg, params, rng, device)
        del params
    finally:
        if cuda:
            release(torch)
            torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    phase_models_gnn(torch, counted, device)
    print(f"[chip_smoke] models: {time.time() - t0:.1f} s in all")


# The step builder's phase.  (a) olmo-1b's train_4k at its FULL config: the
# batch cut to the largest power of two whose step peaks under this.
STEPS_PEAK_GIB = 72.0
STEPS_TRAIN_STEPS = 3
# (a) The same bundle at SMOKE size, one step on the card against the CPU
# (float32 compute, TF32 off; GEMMs and reductions in other orders): limits
# on |loss_card - loss_cpu| / |loss_cpu|, and on ||x_card - x_cpu|| / ||x_cpu||
# of the gradients and of the parameters after AdamW.
# Readings on an H100: 0, 8.27e-7 and 1.07e-9.
STEPS_SMOKE_RTOL = {"loss": 1e-6, "grads": 1e-5, "params": 1e-8}
# (c) The pipeline on four gloo ranks sharing the card: stages tanh(x @ W +
# b) of width PIPE["d"] (the reference's test stage, wider), float32 with
# TF32 off; each stage's GEMM on 64 rows against the composition's on all
# 512 may take another kernel (sums in another order), so the outputs (in
# [-1, 1]) agree within PIPE_ATOL, not bit for bit.
PIPE = dict(stages=4, micro=8, mb=64, d=1024)
PIPE_ATOL = 1e-4


def steps_fit_batch(torch, bundle, state, full, batch):
    """The largest power of two at most ``batch`` whose train step on the
    first sequences of ``full`` peaks under STEPS_PEAK_GIB (halving on a
    larger peak or an out-of-memory error).  Returns (batch, peak GiB)."""
    while batch >= 1:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        try:
            out = bundle.step(state, bundle.to_tensors({"tokens": full["tokens"][:batch]}))
            out[1]["loss"].item()
            del out
            peak = torch.cuda.max_memory_allocated() / 2**30
        except torch.cuda.OutOfMemoryError:
            peak = None
        if peak is not None and peak <= STEPS_PEAK_GIB:
            return batch, peak
        print(f"[chip_smoke] steps (a): batch {batch} peaks at "
              f"{'out of memory' if peak is None else f'{peak:.2f} GiB'}, over {STEPS_PEAK_GIB} GiB: halved")
        batch //= 2
    raise SmokeFailure("steps (a): no batch fits")


def steps_train_full(torch, device="cuda", arch="olmo-1b", start=None):
    """(a) ``build_step(arch, "train_4k")`` at the FULL config on the card:
    the batch cut from the shape's 256 sequences (or ``start``) by slicing
    what ``make_batch`` returns, STEPS_TRAIN_STEPS steps (host clock ending
    in a read of the loss; the last under the profiler), the peak, the
    6·N·D bound from ``model_flops_for``."""
    import numpy as np

    from repro_torch.launch.steps import build_step
    from repro_torch.roofline.analysis import HW, model_flops_for
    from repro_torch.tree import tree_leaves

    cuda = device != "cpu"
    bundle = build_step(arch, "train_4k", device=device)
    cfg = bundle.config
    t0 = time.perf_counter()
    state = bundle.init_state(torch.Generator(device=device).manual_seed(28))
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    t0 = time.perf_counter()
    full = bundle.make_batch(np.random.default_rng(28))
    data_s = time.perf_counter() - t0
    full_batch, seq1 = full["tokens"].shape
    if start is None:
        # A lower bound by shapes rules out the batches that cannot fit: each
        # sequence's float32 logits, their softmax and their gradient (3 x S x
        # V x 4 bytes) live at once in the loss's backward.
        per_seq = 3 * (seq1 - 1) * cfg.vocab * 4
        start = full_batch
        while start > 1 and start * per_seq > STEPS_PEAK_GIB * 2**30:
            start //= 2
    batch, fit_peak = steps_fit_batch(torch, bundle, state, full, start) if cuda else (start, None)
    batch_in = bundle.to_tensors({"tokens": full["tokens"][:batch]})
    if cuda:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms, busy, by = [], [], None, {}
    for i in range(STEPS_TRAIN_STEPS):
        t1 = time.perf_counter()
        if cuda and i == STEPS_TRAIN_STEPS - 1:
            (state, metrics), busy, by = profile_breakdown(torch, lambda: bundle.step(state, batch_in))
        else:
            state, metrics = bundle.step(state, batch_in)
        losses.append(metrics["loss"].item())
        step_ms.append(1e3 * (time.perf_counter() - t1))
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    check(all(np.isfinite(losses)), f"steps (a): non-finite losses {losses}")
    flops = model_flops_for(bundle) * batch / full_batch  # 6·N·D of the cut batch
    bound_ms = flops / HW["peak_flops_bf16"] * 1e3
    timed = step_ms[1:-1] or step_ms[-1:]
    smi = nvidia_smi() if cuda else "cpu"
    print(f"[chip_smoke] steps (a) {arch} train_4k through build_step ({smi}): the registry's FULL config "
          f"({cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab:,}, {n_params:,} parameters in "
          f"{str(cfg.param_dtype)[6:]}, {str(cfg.compute_dtype)[6:]} compute, remat {cfg.remat}, attention chunks of "
          f"{cfg.attn_q_chunk} queries, AdamW moments in {str(bundle.state_specs()['opt'].m['embed'].dtype)[6:]}); "
          f"init {init_s:.1f} s on the card, make_batch {data_s:.1f} s on the host; batch cut from {full_batch} "
          f"sequences of {seq1 - 1} tokens to {batch} (tried from {start}, the largest power of two whose float32 "
          f"logits, softmax and gradient alone stay under the limit; step peak {_gib(fit_peak)}, limit "
          f"{STEPS_PEAK_GIB} GiB); "
          f"{STEPS_TRAIN_STEPS} steps: losses {[round(x, 4) for x in losses]}, step {median(timed):.1f} ms "
          f"(steps {', '.join(f'{x:.1f}' for x in step_ms)} ms; forward, backward, AdamW; host clock ending in a read "
          f"of the loss), peak {_gib(peak)}; the last step profiled: device busy {_fmt(busy)}, top kernels (ms) "
          f"{top_kernels(by)}; 6·N·D bound {bound_ms:.1f} ms ({flops:.4g} model FLOPs at the bf16 peak of "
          f"{HW['peak_flops_bf16'] / 1e12:.0f} TFLOP/s)")
    del state, batch_in, full
    return {"batch": batch, "step_ms": median(timed), "busy_ms": busy, "peak_gib": peak, "bound_ms": bound_ms}


def steps_smoke_check(torch, device="cuda", arch="olmo-1b"):
    """(a) The same bundle at SMOKE size: one step on ``device`` and on the
    CPU from the same parameters and batch, within STEPS_SMOKE_RTOL."""
    import numpy as np

    from repro_torch.launch.steps import build_step
    from repro_torch.tree import tree_leaves

    card, cpu = (build_step(arch, "train_4k", smoke=True, device=d) for d in (device, "cpu"))
    state = cpu.init_state(torch.Generator().manual_seed(5))
    batch = cpu.make_batch(np.random.default_rng(5))
    card_state = to_device(torch, state, device)
    got = grads_of(torch, lambda p: card.loss_fn(p, card.to_tensors(batch))[0], card_state["params"])
    want = grads_of(torch, lambda p: cpu.loss_fn(p, cpu.to_tensors(batch))[0], state["params"])
    new_card, _ = card.step(card_state, card.to_tensors(batch))
    new_cpu, _ = cpu.step(state, cpu.to_tensors(batch))
    errs = {"loss": abs(got[0] - want[0]) / abs(want[0]), "grads": rel_err(torch, got[1], want[1]),
            "params": rel_err(torch, [p.float().cpu() for p in tree_leaves(new_card["params"])],
                              [p.float() for p in tree_leaves(new_cpu["params"])])}
    check(np.isfinite(got[0]) and all(errs[k] <= STEPS_SMOKE_RTOL[k] for k in errs),
          f"steps (a) SMOKE {arch}: card against CPU {errs}, limits {STEPS_SMOKE_RTOL}")
    print(f"[chip_smoke] steps (a) {arch} train_4k SMOKE bundle, one step on the card against the CPU (float32, "
          f"TF32 off): loss {got[0]:.6f} vs {want[0]:.6f} (rel {errs['loss']:.3g}), gradients rel {errs['grads']:.3g}, "
          f"parameters after AdamW rel {errs['params']:.3g}; limits {STEPS_SMOKE_RTOL}")
    return errs


def pipeline_rank(rank, world, tmp, device, sizes):
    """(c) One rank of the pipeline on a (world,) ``pipe`` mesh: the stages
    and the input from one numpy seed on every rank; returns the largest
    error against the sequential composition on this rank, the pipeline's
    wall ms (after one warm-up run) and its all-reduces."""
    import numpy as np
    import torch

    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.pipeline import microbatch, pipeline_apply

    rank_device(torch, device)
    mesh = Mesh((world,), ("pipe",))
    s, m, mb, d = sizes["stages"], sizes["micro"], sizes["mb"], sizes["d"]
    rng = np.random.default_rng(28)
    ws = torch.from_numpy((rng.normal(size=(s, d, d)) / np.sqrt(d)).astype(np.float32)).to(device)
    bs = torch.from_numpy((rng.normal(size=(s, d)) * 0.1).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.normal(size=(m * mb, d)).astype(np.float32)).to(device)

    def stage(p, h):
        return torch.tanh(h @ p[0] + p[1])

    want = x
    for i in range(s):
        want = stage((ws[i], bs[i]), want)
    pipeline_apply(stage, (ws, bs), microbatch(x, m), mesh)  # warm-up
    mesh.collectives.clear()
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipeline_apply(stage, (ws, bs), microbatch(x, m), mesh)
    if device != "cpu":
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    err = float((got.reshape(m * mb, d) - want).abs().max())
    return {"err": err, "ms": ms, "reduces": len(mesh.collectives),
            "reduce_bytes": sum(r["bytes"] for r in mesh.collectives)}


def steps_pipeline(torch, device="cuda", sizes=PIPE):
    """(c) ``pipeline_apply`` on four gloo ranks sharing the card against the
    sequential composition."""
    from repro_torch.distributed.pipeline import pipeline_bubble_fraction

    t0 = time.time()
    res = spawn_ranks(pipeline_rank, sizes["stages"], device, args=(sizes,))
    err = max(r["err"] for r in res)
    ticks = sizes["micro"] + sizes["stages"] - 1
    check(err <= PIPE_ATOL and all(r["reduces"] == ticks + 1 for r in res),
          f"steps (c): pipeline error {err} (limit {PIPE_ATOL}), all-reduces {[r['reduces'] for r in res]}")
    print(f"[chip_smoke] steps (c) pipeline_apply, {sizes['stages']} gloo ranks on the card, a (4,) pipe mesh, "
          f"{sizes['micro']} microbatches of {sizes['mb']} x {sizes['d']}, stages tanh(x @ W + b): largest error "
          f"against the sequential composition {err:.3g} (limit {PIPE_ATOL}); {ticks} ticks, "
          f"{res[0]['reduces']} all-reduces a rank ({res[0]['reduce_bytes'] / 2**20:.1f} MiB); wall "
          f"{max(r['ms'] for r in res):.1f} ms (slowest rank, after a warm-up run); bubble "
          f"{pipeline_bubble_fraction(sizes['stages'], sizes['micro']):.3f}; {time.time() - t0:.1f} s with the spawn")
    return err


def steps_dryrun_start(out: Path):
    """(d) ``python -m repro_torch.launch.dryrun --all --both-meshes`` into
    ``out``, started in a process of its own: it counts on ``meta`` tensors
    on the host (no card), beside the card's work of (a) and (c)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--both-meshes", "--out",
                             str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def steps_dryrun_finish(proc, out: Path, t0: float):
    """(d) Wait for the dry run; every live cell ``ok``, no record with a
    collective term."""
    from repro_torch.configs import all_cells

    log, _ = proc.communicate(timeout=600)
    records = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    ok = [r for r in records if r["status"] == "ok"]
    skipped = [r for r in records if r["status"] == "skipped"]
    check(proc.returncode == 0 and len(ok) == 2 * len(all_cells()),
          f"steps (d): the dry run exited {proc.returncode} with {len(ok)} cells ok: {log[-2000:]}")
    check(all(r["collectives"] is None and r["roofline"]["collective_s"] is None for r in ok),
          "steps (d): a record reads a collective term")
    big = max(ok, key=lambda r: r["modeled_memory"]["modeled_total_per_device"])
    over = [f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in ok if not r["modeled_memory"]["fits_hbm"]]
    print(f"[chip_smoke] steps (d) python -m repro_torch.launch.dryrun --all --both-meshes (meta tensors, in a "
          f"process of its own beside (a) and (c)): {len(ok)} cells ok, {len(skipped)} skipped, 0 failed, done "
          f"{time.time() - t0:.1f} s after its start; largest modeled per-device memory {big['arch']}/{big['shape']}/"
          f"{big['mesh']} {big['modeled_memory']['modeled_total_per_device'] / 1e9:.2f} GB; over one H100's 80 GB: "
          f"{', '.join(over) or 'none'}")
    return len(ok)


def phase_steps(torch, counted, device="cuda"):
    """The step builder, the pipeline and the bundle dry run (A12c, A12d):
    (a) a full-width training step through ``build_step`` and its SMOKE
    check against the CPU, (c) the pipeline on four gloo ranks, (d) the dry
    run, in a process of its own from the start.  (b), the models phase on
    bundles, runs before.  No kernel of the port is on these paths: every
    launch count stays 0."""
    import shutil
    import tempfile

    t0 = time.time()
    cuda = device != "cpu"
    out = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    dry = steps_dryrun_start(out)
    try:
        for f in counted.values():
            f.launches = 0
        if cuda:  # the fit frees and allocates multi-GiB tensors in turn: let segments grow instead
            release(torch)
            torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        try:
            steps_train_full(torch, device)
        finally:
            if cuda:
                release(torch)
                torch.cuda.memory._set_allocator_settings("expandable_segments:False")
        steps_smoke_check(torch, device)
        launched = {name: f.launches for name, f in counted.items() if f.launches}
        check(not launched, f"steps (a): the step builder's path launched the port's kernels {launched}")
        steps_pipeline(torch, device)
        steps_dryrun_finish(dry, out, t0)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        shutil.rmtree(out, ignore_errors=True)
    print(f"[chip_smoke] steps: {time.time() - t0:.1f} s in all")


# Exponents of the cost pass on the card and on the CPU agree within this.
EXPONENT_AGREEMENT = 0.05


def phase_analysis(torch, device="cuda", base=None, config=None, dryrun=None):
    """The analysis and cost planes on the kernels: (a) the sync check of
    every hot entry point at the fixture size and at ``base`` (BASE), (b)
    the cost pass against the CPU's and the memory proof on ``config``
    (BASE), (c) the sketch dry run (``dryrun``: ``sketch_dryrun.run``'s
    arguments, BASE on one NCCL rank).  Prints a line each; a failure
    raises."""
    import contextlib
    import dataclasses

    from repro_torch.analysis import contracts
    from repro_torch.analysis.baseline import BASELINE
    from repro_torch.analysis.costlint import run_cost_pass
    from repro_torch.api import GraphStream
    from repro_torch.configs.glava import BASE
    from repro_torch.launch import sketch_dryrun

    base = base or contracts.BASE_FIXTURE
    config = config or BASE
    dryrun = dryrun or {"config_name": "base"}
    # (a) no synchronizing operation in a hot entry, at two sizes.
    t0 = time.time()
    exempt = sorted({s for (rule, s) in BASELINE if rule == "no-host-sync"})
    hot = [ep for ep in contracts.ENTRY_POINTS if "no-host-sync" in ep.contracts and ep.name not in exempt]
    fixtures = (dataclasses.replace(contracts.FIXTURE, device=device), base)
    for fx in fixtures:
        for ep in hot:
            if fx is base and ep.name.startswith("steps."):
                continue  # the step builder's entries build at their SMOKE size whatever the fixture
            group = contracts.one_rank_group(device) if ep.name.startswith("distributed.") else contextlib.nullcontext()
            with group:
                entry = ep.build(fx)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    entry.fn(*entry.args)
                except RuntimeError as exc:
                    raise SmokeFailure(f"analysis (a): {ep.name} at d={fx.depth} w={fx.width} synchronizes: {exc}")
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                del entry
            if fx is base:
                release(torch)
    n_steps = sum(ep.name.startswith("steps.") for ep in hot)
    print(f"[chip_smoke] analysis (a): {len(hot)} hot entry points at d=2 w=64 and at d={base.depth} w={base.width} (the "
          f"{n_steps} step-builder entries once, at their SMOKE size) under "
          f"sync debug mode 'error': no synchronizing operation; exempt (baselined no-host-sync): "
          f"{', '.join(exempt) or 'none'} ({time.time() - t0:.1f} s)")

    # (b) the cost pass on the card, against the CPU's exponents.
    t0 = time.time()
    card_v, card = run_cost_pass(check_budgets=False, device=device)
    cpu_v, cpu = run_cost_pass(check_budgets=False, device="cpu")
    check(not card_v and not cpu_v, "analysis (b): " + "; ".join(v.render() for v in card_v + cpu_v))
    check([m["entry"] for m in card] == [m["entry"] for m in cpu], "analysis (b): the two runs measured other entries")
    worst = 0.0
    rows = []
    for mc, mg in zip(cpu, card):
        for fc, fg in zip(mc["axes"], mg["axes"]):
            gap = abs(fc["measured"] - fg["measured"])
            worst = max(worst, gap)
            rows.append(f"{mg['entry'][5:]}[{fg['axis']}] {fg['measured']:.3f}")
            check(gap <= EXPONENT_AGREEMENT, f"analysis (b): {mg['entry']}[{fg['axis']}] exponent "
                                             f"{fg['measured']} on the card, {fc['measured']} on the CPU")
    print(f"[chip_smoke] analysis (b): cost pass on the kernels, {len(card)} entries, every exponent within its "
          f"ceiling and within {worst:.3f} of the CPU's ({time.time() - t0:.1f} s): {', '.join(rows)}")
    # What the cost scope (kernels/build.py::costed) costs a wrapper call
    # with no listener: the wrapper against its undecorated body, in turns.
    from repro_torch.kernels.query import ops as query_ops

    counters = torch.zeros((5, 1024, 1024), device=device)
    buckets = torch.randint(0, 1024, (5, 1024), device=device)
    scoped = lambda: query_ops.edge_query_min(counters, buckets, buckets)  # noqa: E731
    bare = lambda: query_ops.edge_query_min.__wrapped__(counters, buckets, buckets)  # noqa: E731
    turns = [host_us(f) for f in (bare, scoped, scoped, bare)]
    print(f"[chip_smoke] analysis (b): the cost scope with no listener: edge_query_min host "
          f"{(turns[1] + turns[2]) / 2:.3f} us/call scoped, {(turns[0] + turns[3]) / 2:.3f} bare "
          f"(turns {', '.join(f'{t:.3f}' for t in turns)})")
    del counters, buckets
    (src, dst, wts), *_ = serve_raw_batch(torch) if config is BASE else ((np_batch(config.width_rows)),)
    gs = GraphStream.open(config, device=device)
    state = gs._sketch.counters.numel() * 4
    gs.flush()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    gs.ingest(src, dst, wts)
    gs.flush()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    check(peak < state, f"analysis (b): serve BASE's first batch raised the peak allocation by {peak} bytes, "
                        f">= the {state} bytes of the counters")
    print(f"[chip_smoke] analysis (b): serve BASE's first batch ({len(src):,} edges) through GraphStream.ingest "
          f"raised the peak allocation by {peak / 2**20:.2f} MiB, {100 * peak / state:.3f}% of the "
          f"{state / 1e9:.2f} GB of counters (updated in place)")
    del gs
    release(torch)

    # (c) the sketch dry run at BASE, one NCCL rank.
    t0 = time.time()
    rec = sketch_dryrun.run(device=device, out=None, **dryrun)
    for call in ("ingest", "query"):
        m = rec["measured"][call]
        check(m["device_ms"] is not None and m["fraction"] is not None and m["bound_ms"] > 0,
              f"analysis (c): no device time for the dry run's {call}")
    print(f"[chip_smoke] analysis (c): {sketch_dryrun.summary(rec)}; the ingest's peak allocation "
          f"+{rec['measured']['ingest']['peak_alloc_bytes'] / 1e9:.3f} GB (distributed_ingest's per-batch "
          f"shard clone, baselined) ({time.time() - t0:.1f} s)")
    release(torch)


def np_batch(nodes: int, b: int = 5000):
    """A raw batch of ``b`` edges among ``nodes`` keys, weights 1..8 (seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return (rng.integers(0, nodes, b).astype(np.uint32), rng.integers(0, nodes, b).astype(np.uint32),
            rng.integers(1, 9, b).astype(np.float32))


def main() -> int:
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from repro_torch.core import queries
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.kernels import build
    from repro_torch.kernels.closure import ops as closure_ops
    from repro_torch.kernels.countsketch import ops as countsketch_ops
    from repro_torch.kernels.flow import ops as flow_ops
    from repro_torch.kernels.ingest import ops as ingest_ops
    from repro_torch.kernels.ingest_fused import ops as fused_ops
    from repro_torch.kernels.query import ops as query_ops
    from repro_torch.kernels.ingest_stacked import ops as stacked_ops
    from repro_torch.kernels.preagg import ops as preagg_ops
    from repro_torch.kernels.boolmm import ops as boolmm_ops
    from repro_torch.kernels.sequential import ops as seq_ops
    from repro_torch.launch import serve

    print(f"[chip_smoke] nvidia-smi: {nvidia_smi()}")
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    names = build.SOURCES
    build.build(names)
    print(f"[chip_smoke] built {', '.join(names)} in {time.time() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name in names:
        for line in build.build_log(name).splitlines():
            if "ptxas" in line:
                print(f"[chip_smoke] {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for phase in (phase_ingest, phase_queries, phase_closure, phase_fused_ingest, phase_flows, phase_countsketch,
                  phase_sequential, phase_stacked_ingest, phase_preagg, phase_refresh):
        out = phase(torch, gen)
        for row in out if isinstance(out, list) else [out]:
            rows[row["name"]] = row
        torch.cuda.empty_cache()

    # A small session on the card against the same session on the CPU (the
    # plain versions): the same stream, answers and summary.
    gs_cuda, _, ev_cuda = serve.main(SMALL)
    gs_cpu, _, ev_cpu = serve.main(SMALL + ["--device", "cpu"])
    check(torch.equal(gs_cuda._live().counters.cpu(), gs_cpu._live().counters), "small: counters differ from CPU")
    check(all(_same_results(a, b) for a, b in zip(ev_cuda, ev_cpu, strict=True)), "small: results differ from CPU")
    print("[chip_smoke] small session: CUDA and CPU runs identical")
    check_small_analytics(torch, gs_cuda, gs_cpu, SMALL)
    del gs_cuda, gs_cpu

    counted = {
        "ingest_scatter": ingest_ops.ingest_scatter,
        "ingest_keys": ingest_ops.ingest_keys,
        "edge_query_min": query_ops.edge_query_min,
        "closure_step": closure_ops.closure_step,
        "fused_ingest": fused_ops.fused_ingest,
        "edge_query_cells": query_ops.edge_query_cells,
        "flows": flow_ops.flows,
        "countsketch": countsketch_ops.countsketch,
        "countsketch_median": countsketch_ops.countsketch_median,
        "sequential_update": seq_ops.sequential_update,
        "ingest_stacked": stacked_ops.stacked_ingest,
        "preagg_collapse": preagg_ops.preagg_collapse,
        "bool_product": boolmm_ops.bool_product,
        "byte_transpose": boolmm_ops.byte_transpose,
    }

    def drive(kernel_names, fn):
        """Run ``fn`` with every count at 0; record the named kernels' counts."""
        for f in counted.values():
            f.launches = 0
        out = fn()
        for name in kernel_names:
            rows[name]["launches"] = counted[name].launches
            check(counted[name].launches > 0, f"{name} was not launched on its path")
        return out

    # The main path, at BASE, on the kernels (counts read from this run
    # only), then on the plain backends, which launch nothing.
    base, base_ev, base_s = drive(
        ("ingest_keys", "edge_query_min", "closure_step", "preagg_collapse"),
        lambda: timed_run(torch, lambda: serve.main(SERVE_BASE)),
    )
    check(counted["ingest_scatter"].launches == 0,
          f"serve BASE: the bucket entry launched {counted['ingest_scatter'].launches} times")
    plain, plain_ev, plain_s = timed_run(torch, lambda: serve.main(SERVE_BASE + PLAIN_BACKENDS))
    check_same(torch, base, base_ev, plain, plain_ev, "serve BASE vs plain")
    check(base.engine.closure_refreshes >= 1, "serve BASE: no closure build")
    want_launches = base.engine.closure_refreshes * closure_ops.closure_steps(BASE_WIDTH)
    check(rows["closure_step"]["launches"] == want_launches,
          f"serve BASE: {rows['closure_step']['launches']} closure launches, not {want_launches} "
          f"({base.engine.closure_refreshes} full rebuilds)")
    check(rows["edge_query_min"]["launches"] == len(base_ev),
          f"serve BASE: {rows['edge_query_min']['launches']} edge-query launches for {len(base_ev)} ticks")
    n_batches = -(-flag(SERVE_BASE, "--edges") // flag(SERVE_BASE, "--batch"))
    check(rows["ingest_keys"]["launches"] == n_batches,
          f"serve BASE: {rows['ingest_keys']['launches']} ingest_keys launches for {n_batches} batches")
    check(rows["preagg_collapse"]["launches"] == n_batches,
          f"serve BASE: {rows['preagg_collapse']['launches']} batches collapsed on the card for {n_batches} batches")
    print(
        f"[chip_smoke] serve BASE: kernels {base_s:.3f} s, plain {plain_s:.3f} s (host wall clock, "
        f"build excluded); {len(base_ev)} ticks; {want_launches} closure launches "
        f"({base.engine.closure_refreshes} full rebuilds), {rows['edge_query_min']['launches']} edge-query "
        f"launches, {rows['ingest_keys']['launches']} ingest_keys launches (0 of the bucket entry); counters, "
        f"registers and transcript identical"
    )
    profile_edge_tick(torch, base, SERVE_BASE, counted)

    # The fused session on the same traffic: one fused launch per batch.
    fused, fused_ev, fused_s = drive(
        ("fused_ingest",), lambda: timed_run(torch, lambda: run_fused(serve, SERVE_BASE))
    )
    check(rows["fused_ingest"]["launches"] == n_batches,
          f"fused serve BASE: {rows['fused_ingest']['launches']} fused launches for {n_batches} batches")
    check_same(torch, fused, fused_ev, plain, plain_ev, "fused serve BASE vs plain")
    check_same(torch, fused, fused_ev, base, base_ev, "fused serve BASE vs cuda-ingest run")
    print(
        f"[chip_smoke] fused serve BASE: {fused_s:.2f} s (host wall clock; {n_batches} fused launches, "
        f"closure full={fused.engine.closure_refreshes} incremental={fused.engine.closure_incremental_refreshes}); "
        f"identical to the plain and cuda-ingest runs"
    )
    # One ingest batch of each run under the profiler, after the runs are
    # compared (it folds one more batch into their sketches).
    profile_ingest_batch(torch, base, counted, fused=False)
    profile_ingest_batch(torch, fused, counted, fused=True)
    del base, plain, base_ev, plain_ev
    torch.cuda.empty_cache()

    # The ops entry points on the fused session's live sketch: flows from the
    # counters against the maintained registers, per-sketch cells against
    # the fused multi-query.
    live = fused._live()
    rng = np.random.default_rng(12)
    q_src = keys_to_tensor(rng.integers(0, 100_000, 1024).astype(np.uint32), "cuda")
    q_dst = keys_to_tensor(rng.integers(0, 100_000, 1024).astype(np.uint32), "cuda")

    def entry_checks():
        in_k, out_k = flow_ops.node_in_flow(live, q_src), flow_ops.node_out_flow(live, q_src)
        cells = query_ops.edge_query_cells(live.counters, *live.hash_edges(q_src, q_dst))
        return in_k, out_k, cells

    in_k, out_k, cells = drive(("flows", "edge_query_cells"), entry_checks)
    check(torch.equal(in_k, queries.node_in_flow(live, q_src)), "node_in_flow: kernel flows differ from registers")
    check(torch.equal(out_k, queries.node_out_flow(live, q_src)), "node_out_flow: kernel flows differ from registers")
    check(torch.equal(cells.amin(dim=0), queries.edge_query(live, q_src, q_dst)),
          "edge_query_cells: min over sketches differs from the edge query")
    print(
        f"[chip_smoke] ops entry points on the fused BASE sketch: node_in_flow/node_out_flow over 1,024 keys "
        f"equal the registers ({rows['flows']['launches']} flows launches); edge_query_cells' min equals "
        f"the edge query ({rows['edge_query_cells']['launches']} launch)"
    )
    del fused, fused_ev, live
    torch.cuda.empty_cache()
    profile_serve(torch, serve, SERVE_BASE, "serve BASE")
    torch.cuda.empty_cache()

    def refresh_launches(fn, label):
        """Run ``fn`` (a serve run, every count at 0) with the shape of each
        card refresh recorded; check the product and transpose launches
        against them: 3 + ceil(log2 T) products a refresh, and a transpose
        of the closure and of the touched-row graph where each is whole
        tiles."""
        shapes = []
        real = boolmm_ops.closure_refresh

        def recording(closure, delta, rows):
            shapes.append((closure.shape[-1], rows.shape[-1]))
            return real(closure, delta, rows)

        boolmm_ops.closure_refresh = recording
        try:
            stream, events, secs = timed_run(torch, fn)
        finally:
            boolmm_ops.closure_refresh = real
        products = sum(3 + boolmm_ops.closure_steps(t) for _, t in shapes)
        transposes = sum((w % boolmm_ops.TILE == 0) + (t % boolmm_ops.TILE == 0) for w, t in shapes)
        got = (counted["bool_product"].launches, counted["byte_transpose"].launches)
        check(len(shapes) == stream.engine.closure_incremental_refreshes,
              f"{label}: {len(shapes)} card refreshes for {stream.engine.closure_incremental_refreshes} incremental")
        check(got == (products, transposes),
              f"{label}: {got[0]} product and {got[1]} transpose launches for refreshes (w, T) {shapes}, not "
              f"{products} and {transposes}")
        return stream, events, secs, f"{got[0]} product and {got[1]} transpose launches for T {[t for _, t in shapes]}"

    inc, inc_ev, inc_s, inc_launches = drive(
        ("bool_product",), lambda: refresh_launches(lambda: serve.main(SERVE_INCREMENTAL), "serve incremental")
    )
    plain, plain_ev, plain_s = timed_run(torch, lambda: serve.main(SERVE_INCREMENTAL + PLAIN_BACKENDS))
    check_same(torch, inc, inc_ev, plain, plain_ev, "serve incremental vs plain")
    check(inc.engine.closure_incremental_refreshes > 0, "no incremental closure refresh")
    finc, finc_ev, finc_s, finc_launches = drive(
        (), lambda: refresh_launches(lambda: run_fused(serve, SERVE_INCREMENTAL), "fused serve incremental")
    )
    check_same(torch, finc, finc_ev, plain, plain_ev, "fused serve incremental vs plain")
    check(finc.engine.closure_incremental_refreshes > 0, "fused: no bitmap-driven incremental refresh")
    print(
        f"[chip_smoke] serve incremental: kernels {inc_s:.2f} s, fused {finc_s:.2f} s, plain {plain_s:.2f} s; "
        f"closure full={inc.engine.closure_refreshes} incremental={inc.engine.closure_incremental_refreshes} "
        f"({inc_launches}), fused full={finc.engine.closure_refreshes} "
        f"incremental={finc.engine.closure_incremental_refreshes} ({finc_launches}); identical to the plain run"
    )

    # The analytics path: a serve BASE session, then the query plane beyond
    # the served families, the order-dependent updates (one sequential_update
    # launch a call) and the four baselines on its summary.
    del inc, plain, finc
    torch.cuda.empty_cache()
    update_calls = drive(("sequential_update",), lambda: analytics_base(torch, serve))
    check(rows["sequential_update"]["launches"] == update_calls,
          f"analytics BASE: {rows['sequential_update']['launches']} sequential_update launches for "
          f"{update_calls} update calls")
    torch.cuda.empty_cache()

    # The durable, windowed serving plane: the windowed event-time serve at
    # BASE (ingest_scatter once per slot group and retraction), its genesis
    # replay, a checkpoint plus WAL suffix, the small session against the
    # CPU, and the trainer's resume.
    phase_durable_window(torch, serve, counted, rows)
    torch.cuda.empty_cache()

    # The multi-tenant fleet: 16 BASE tenants on one stacked ingest launch a
    # batch and batched closure builds, against the plain backends and
    # standalone sessions; then residency, recovery and the windowed fleet.
    phase_fleet_serve(torch, serve, counted, drive)
    phase_fleet_residency(torch, serve)
    torch.cuda.empty_cache()

    # The training path: countsketch twice and its decode once per
    # compressed step.
    phase_train(torch, drive)
    n_steps = flag(TRAIN_100M, "--steps")
    check(rows["countsketch"]["launches"] == 2 * n_steps,
          f"train 100m: {rows['countsketch']['launches']} countsketch launches for {n_steps} steps")
    check(rows["countsketch_median"]["launches"] == n_steps,
          f"train 100m: {rows['countsketch_median']['launches']} countsketch_median launches for {n_steps} steps")

    # The distributed plane: one NCCL rank, four gloo ranks on the card, and
    # the data-parallel compressed step on two.
    phase_distributed(torch, serve, rows)
    release(torch)
    # The durable mesh session: its WAL, recovery and merges.
    phase_durable_distributed(torch, serve)
    release(torch)

    # The sketch-sampled GraphSAGE path: B1 under the degree sketch.
    phase_gnn(torch, rows)
    release(torch)

    # The LM serving path at Mixtral-8x22B's widths: prefill, decode on the
    # ring cache, decode against forward, the sharded MoE and halo attention.
    phase_lm_serve(torch, drive, counted)
    release(torch)

    # The other models at the registry's full widths: BERT4Rec trained on
    # negatives from the gLava popularity sketch (B1 once a batch) and
    # served, then GAT, SchNet and DimeNet.
    phase_models(torch, counted)
    release(torch)

    # The step builder at olmo-1b's full widths, the pipeline on four gloo
    # ranks and the bundle dry run.
    phase_steps(torch, counted)
    release(torch)

    # The analysis and cost planes on the kernels.
    phase_analysis(torch)

    print(f"[chip_smoke] total {time.time() - t_start:.1f} s, build included")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
