#!/usr/bin/env python3
"""Where B1's time goes on the serve path's cold counters, by variant.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/ablate_ingest.py [--parent DIR]

It builds ``src/repro_torch/csrc/ingest.cu`` as it is and in edited copies
(one ``nvcc`` each, all at once, into ``build/kernels/ablate/``), and with
``--parent`` the same source of another checkout (an earlier design,
unpacked with ``git archive``).  On serve BASE's first batch
(``chip_smoke.serve_first_keys``: the pre-aggregated pairs padded to 32,768,
the BASE family) into (5, 8192, 8192) counters (1.34 GB) it times:

- the random-sector floor (``chip_smoke.floor_ms``): n REDs at random
  sectors, addresses hashed in registers, no index loads, n = the batch's
  adds, half and twice that, 1, 5 and 10 REDs a thread (warm: the same
  sectors every launch);
- the parent's kernel on the batch's int64 buckets;
- each variant's key entry, directed and mirrored, and its bucket entry on
  the int64 buckets, each checked bit-equal to the plain version first
  (ablations, which compute other values, are timed only);
- the B2 gather of serve BASE's edge family (1,024 queries, drawn as
  ``chip_smoke.profile_edge_tick`` draws them) right after the batch, under
  the variants that give the REDs an L2 eviction hint.

Each kernel warm, and cold with the L2 emptied two ways
(``chip_smoke.FILLS``): a dirty fill (a write of 256 MB) and a clean one (a
read of 256 MB).  Times are the profiler's device ms (``chip_smoke.device_ms``
and ``cold_device_ms``).  Prints the card's name and power limit, the
registers of each build's kernels, and one line per kernel.  Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# The edits (csrc/ingest.cu).
RED = "__device__ __forceinline__ void red_add(float* p, float w) { atomicAdd(p, w); }\n"
HINTED = (
    "__device__ __forceinline__ void red_add(float* p, float w) {\n"
    "  uint64_t policy;\n"
    '  asm("createpolicy.fractional.L2::POLICY.b64 %0, 1.0;" : "=l"(policy));\n'
    '  asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;" :: "l"(p), "f"(w), "l"(policy) : "memory");\n'
    "}\n"
)
NO_RED = ('__device__ __forceinline__ void red_add(float* p, float w) { asm volatile("" :: "l"(p), "f"(w)); }\n')
THREADS = "constexpr int kThreads = 256;\n"
BLOCKS = "int64_t blocks_for(int64_t batch) { return (batch + kThreads - 1) / kThreads; }\n"
CHUNK = "constexpr int kChunk = 8;"
SKETCH_LOOP = "    for (Off i0 = 0; i0 < depth; i0 += kChunk) {\n"
GRID = "dim3(static_cast<unsigned>(blocks_for(batch))), dim3(kThreads)"
TESTED = "      if (w == 0.0f) break;  // adds nothing: no hash, no RED\n"
PREFETCH = (
    "#pragma unroll\n"
    "      for (int k = 0; k < kChunk; ++k) {\n"
    "        const Off i = i0 + k;\n"
    "        if (i >= depth) break;\n"
    "        int64_t r[Src::kTargets];\n"
    "        Off c[Src::kTargets];\n"
    "        const int n = src.targets(ch, k, i, r, c);\n"
    "#pragma unroll\n"
    "        for (int t = 0; t < Src::kTargets; ++t) {\n"
    "          if (t >= n) break;\n"
    "          const int64_t local = r[t] - row_offset;\n"
    "          if (local >= 0 && local < static_cast<int64_t>(wr_local)) {\n"
    '            asm volatile("prefetch.global.L2 [%0];" :: "l"(counters + (i * wr_local + static_cast<Off>(local)) * wc + c[t]));\n'
    "          }\n"
    "        }\n"
    "      }\n"
)


def persistent(blocks: int, threads: int) -> list:
    """A grid of ``blocks`` blocks of ``threads`` that strides over the slots."""
    return [(THREADS, f"constexpr int kThreads = {threads};\n"),
            (BLOCKS, "int64_t blocks_for(int64_t batch) {\n"
                     "  const int64_t b = (batch + kThreads - 1) / kThreads;\n"
                     f"  return b < {blocks} ? b : {blocks};\n}}\n")]


# name -> (edits, bit-equal).  The floor launches through blocks_for too: it
# is timed on the build as it is only.
VARIANTS = {
    "as built (256 threads, one slot a thread)": ([], True),
    "128 threads a block": ([(THREADS, "constexpr int kThreads = 128;\n")], True),
    "64 threads a block": ([(THREADS, "constexpr int kThreads = 64;\n")], True),
    "persistent, 132 blocks of 64 threads (about 4 slots a thread)": (persistent(132, 64), True),
    "persistent, 2 x 132 blocks of 64 threads (about 2 slots a thread)": (persistent(264, 64), True),
    "one thread a (slot, sketch), the parent's grid": ([
        (CHUNK, "constexpr int kChunk = 1;"),
        (SKETCH_LOOP, "    for (Off i0 = static_cast<Off>(blockIdx.y); i0 < depth; i0 += static_cast<Off>(gridDim.y)) {\n"),
        (GRID, "dim3(static_cast<unsigned>(blocks_for(batch)), static_cast<unsigned>(depth)), dim3(kThreads)"),
    ], True),
    "prefetch.global.L2 of the slot's cells before its REDs": ([(TESTED, TESTED + PREFETCH)], True),
    "REDs with L2::evict_first": ([(RED, HINTED.replace("POLICY", "evict_first"))], True),
    "REDs with L2::evict_last": ([(RED, HINTED.replace("POLICY", "evict_last"))], True),
    "ablation: no REDs (cells computed, nothing added)": ([(RED, NO_RED)], False),
}
HINT_VARIANTS = ("as built (256 threads, one slot a thread)", "REDs with L2::evict_first", "REDs with L2::evict_last")
# Both entries' kernel (each timing launches one of them); the parent's is
# ingest_scatter_kernel.
KERNEL = "ingest_kernel"


def ptxas_lines(log: str, kernel: str) -> list:
    """What ``-Xptxas -v`` says of the entries whose mangled names hold
    ``kernel``: their spills and registers."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("spill" in line or "registers" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def build_variants(build, parent: Path | None) -> dict:
    """Variant name -> its loaded library."""
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC_DIR / "ingest.cu").read_text()
    jobs = []
    for name, (edits, _) in VARIANTS.items():
        edited = text
        for old, new in edits:
            if old not in edited:
                raise RuntimeError(f"ingest {name}: the source no longer holds {old!r}")
            edited = edited.replace(old, new)
        jobs.append((name, edited))
    if parent is not None:
        jobs.append(("parent", (parent / "src/repro_torch/csrc/ingest.cu").read_text()))
    procs = {}
    for i, (name, source) in enumerate(jobs):
        cu, so = out_dir / f"ingest_{i}.cu", out_dir / f"ingest_{i}.so"
        cu.write_text(source)
        procs[name] = (so, subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = ptxas_lines(log, "ingest")
        print(f"[ablate] built {name}" + (f": {'; '.join(regs)}" if regs else ""))
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


def timings(smoke, launch, kernel: str) -> str:
    """Warm and cold (both fills) device ms of ``kernel`` under ``launch``."""
    out = []
    for fill in (None, *smoke.FILLS):
        ms = smoke.device_ms(launch, 20, kernel) if fill is None else smoke.cold_device_ms(launch, kernel, fill=fill)
        out.append(f"{fill or 'warm'} {smoke._fmt(ms)}")
    return ", ".join(out)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.data.graphs import edge_stream
    from repro_torch.kernels import build
    from repro_torch.kernels.ingest import ops
    from repro_torch.kernels.ingest.ref import ingest_keys_ref, ingest_scatter_ref
    from repro_torch.kernels.query.ops import edge_query_min

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None, help="a checkout whose ingest.cu to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ablate] nvidia-smi: {smi}")
    build.build(["ingest", "query"])
    libs = build_variants(build, args.parent)

    d, w = smoke.BASE_DEPTH, smoke.BASE_WIDTH
    src, dst, wts, fam, n_pairs = smoke.serve_first_keys(torch)
    rows, cols = fam(src), fam(dst)
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float()
    got = base.clone()
    adds = d * int((wts != 0).sum())
    b = wts.shape[0]
    print(f"[ablate] serve BASE's first batch: {n_pairs} pairs padded to {b}, {adds} adds directed; bounds "
          f"(64 bytes an add, inputs once): keys {(adds * 64 + b * 20) / smoke.PEAK_BYTES_PER_S * 1e3:.5f} ms, "
          f"mirrored {(2 * adds * 64 + b * 20) / smoke.PEAK_BYTES_PER_S * 1e3:.5f} ms, int64 buckets "
          f"{smoke.ingest_bound_bytes(rows, wts) / smoke.PEAK_BYTES_PER_S * 1e3:.5f} ms")

    for n in (adds // 2, adds, 2 * adds):
        for per in (1, 5, 10):
            cold = ", ".join(f"{fill or 'warm'} {smoke._fmt(smoke.floor_ms(torch, got, n, per, fill))}"
                             for fill in (None, *smoke.FILLS))
            print(f"[ablate] random-sector floor, {n} REDs, {per} a thread, 1.34 GB: {cold}")
    smoke.release(torch)

    want = {mirror: ingest_keys_ref(base.clone(), src, dst, wts, fam, fam, 0, mirror) for mirror in (False, True)}
    want_buckets = ingest_scatter_ref(base.clone(), rows, cols, wts)
    check_dir = base.clone()
    for name, lib in libs.items():
        exact = name == "parent" or VARIANTS[name][1]
        scatter = entry(lib, "glava_ingest_scatter")
        lines = []
        if name != "parent":
            keys = entry(lib, "glava_ingest_keys")
            for mirror in (False, True):
                check_dir.copy_(base)
                smoke.check(keys(ops.key_record(check_dir, src, dst, wts, fam, fam, 0, mirror, 0)) == 0,
                            f"{name}: the key entry did not launch")
                torch.cuda.synchronize()
                if exact:
                    smoke.check(torch.equal(check_dir, want[mirror]), f"{name}: the key entry (mirror={mirror}) "
                                "differs from its plain version")
                record = ops.key_record(got, src, dst, wts, fam, fam, 0, mirror, 0)
                lines.append(f"keys{' mirrored' if mirror else ''}: "
                             + timings(smoke, lambda r=record: keys(r), KERNEL))
        check_dir.copy_(base)
        smoke.check(scatter(ops.scatter_record(check_dir, rows, cols, wts, 0, 0)) == 0, f"{name}: no launch")
        torch.cuda.synchronize()
        if exact:
            smoke.check(torch.equal(check_dir, want_buckets), f"{name}: the bucket entry differs from its plain version")
        record = ops.scatter_record(got, rows, cols, wts, 0, 0)
        kernel = "ingest_scatter_kernel" if name == "parent" else KERNEL
        lines.append("int64 buckets: " + timings(smoke, lambda r=record: scatter(r), kernel))
        print(f"[ablate] {name} ({'bit-equal' if exact else 'computes other values'}): " + "; ".join(lines))
    del want, want_buckets, check_dir
    smoke.release(torch)

    # The B2 gather of the edge family right after the batch, cold otherwise.
    nodes = smoke.flag(smoke.SERVE_BASE, "--nodes")
    rng = np.random.default_rng(0)
    edge_stream(nodes, smoke.flag(smoke.SERVE_BASE, "--edges"), rng, zipf_a=1.2)  # serve.run's draws, in order
    qs = fam(keys_to_tensor(rng.integers(0, nodes, 1024).astype(np.uint32), "cuda"))
    qd = fam(keys_to_tensor(rng.integers(0, nodes, 1024).astype(np.uint32), "cuda"))
    query = lambda: edge_query_min(got, qs, qd)  # noqa: E731
    for fill in smoke.FILLS:
        alone = smoke.cold_device_ms(query, "multi_query_min_kernel", fill=fill)
        after = []
        for name in HINT_VARIANTS:
            keys = entry(libs[name], "glava_ingest_keys")
            record = ops.key_record(got, src, dst, wts, fam, fam, 0, False, 0)
            ms = smoke.cold_device_ms(lambda: (keys(record), query()), "multi_query_min_kernel", fill=fill)
            after.append(f"after {name}: {smoke._fmt(ms)}")
        print(f"[ablate] B2 edge family (Q=1,024), {fill} fill: alone {smoke._fmt(alone)}; " + "; ".join(after))
    return 0


if __name__ == "__main__":
    sys.exit(main())
