#!/usr/bin/env python3
"""Where the median decode's and the stacked ingest's time goes, by variant.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/ablate_decode_stacked.py [--parent DIR]

It builds ``src/repro_torch/csrc/countsketch.cu`` and ``ingest_stacked.cu``
as they are and in edited copies (one ``nvcc`` each, all at once, into
``build/kernels/ablate/``), and with ``--parent`` the same two sources of
another checkout (an earlier design, unpacked with ``git archive``).

- The decode, at the 100m preset's shape (d=5, w=16,384, n=65,020,416, a
  Gaussian table with NaN planted): the staged kernel forced at every
  shape, checked bit-equal to the plain version, NaN positions included;
  and ablations that compute other values and are timed only (no gathers:
  the hashes and the exchange alone; no wait for the partner).
- The stacked ingest, on serve BASE's first batch routed to 16 tenants'
  (80, 5, 8192, 8192) stack (``chip_smoke.fleet_first_batch``), warm and
  with a cold L2, and on four batches that stress the warp aggregation
  (every slot in one row; in one cell; two tenants alternating lane by lane
  on one cell; one cell with weights that cancel): variants without the
  aggregation, without it on the counters, with 64-bit match keys; each
  checked bit-equal to the plain version on every batch, all three
  outputs.

Times are the profiler's device ms (``chip_smoke.device_ms``).  Prints the
card's name and power limit and one line per variant.  Imports nothing of
JAX.
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

# The decode's edits (csrc/countsketch.cu).
PLAN = "  if (d > NETWORK_DEPTH) return -1;\n"
GATHER = "      out[e] = flip(pair_smem[(i - lo) * w + bucket<kPow2>(x, p.f.lemire, p.f.width)], x2 & 1u);\n"
WAIT = (
    "    if (lane == 0) expect_bytes(full + stage, 32u * 4u * PAIR_VEC * static_cast<uint32_t>(X));\n"
    "    wait_parity(full + stage, static_cast<uint32_t>(t >> 1) & 1u);  // the partner warp's values for this tile\n"
)
DECODE = {
    "as built": ([], True),
    "staged kernel (the table's first 227 KB in shared memory)": ([(PLAN, PLAN + "  if (d > 0) return 0;\n")], True),
    "ablation: no wait for the partner (reads what the buffer holds)": ([(WAIT, "")], False),
    "ablation: no gathers": ([(GATHER, "      out[e] = flip(__uint_as_float(x), x2 & 1u);\n")], False),
}

# The stacked ingest's edits (csrc/ingest_stacked.cu).
MATCHES = (
    "      const unsigned row_group = same_key(keys32, add ? pl * wr + static_cast<Off>(r[k]) : none);\n"
    "      const unsigned col_group = same_key(keys32, add ? pl * wc + c[k] : none);\n"
)
ADDS = (
    "        add_group(row_flows, row, w, row_group, lane);\n"
    "        add_group(col_flows, sketch * wc + c[k], w, col_group, lane);\n"
    "        add_group(counters, row * wc + c[k], w, row_group & col_group, lane);\n"
)
CELL_ADD = "        add_group(counters, row * wc + c[k], w, row_group & col_group, lane);\n"
KEYS32 = "  bool keys32 = r.n_planes * (r.wr > r.wc ? r.wr : r.wc) < kFits32;\n"
STACKED = {
    "as built": [],
    "no aggregation (three REDs a slot and sketch)": [
        (MATCHES, ""),
        (ADDS, "        atomicAdd(row_flows + row, w);\n        atomicAdd(col_flows + sketch * wc + c[k], w);\n"
               "        atomicAdd(counters + row * wc + c[k], w);\n"),
    ],
    "counters not aggregated": [(CELL_ADD, "        atomicAdd(counters + row * wc + c[k], w);\n")],
    "64-bit match keys": [(KEYS32, "  bool keys32 = false;\n")],
}


def ptxas_lines(log: str, kernel: str) -> list:
    """What ``-Xptxas -v`` says of the entry whose mangled name holds
    ``kernel``: its spills and registers."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("spill" in line or "registers" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def build_variants(build, parent: Path | None) -> dict:
    """(source, variant name) -> the launch function of its library."""
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source, symbol, variants in (("countsketch", "glava_countsketch_median", DECODE),
                                     ("ingest_stacked", "glava_ingest_stacked", STACKED)):
        text = (build.CSRC_DIR / f"{source}.cu").read_text()
        for name, spec in variants.items():
            edited = text
            for old, new in spec[0] if isinstance(spec, tuple) else spec:
                if old not in edited:
                    raise RuntimeError(f"{source} {name}: the source no longer holds {old!r}")
                edited = edited.replace(old, new)
            jobs.append((source, symbol, name, edited))
        if parent is not None:
            jobs.append((source, symbol, "parent", (parent / "src/repro_torch/csrc" / f"{source}.cu").read_text()))
    procs = {}
    for i, (source, symbol, name, text) in enumerate(jobs):
        cu, so = out_dir / f"{source}_{i}.cu", out_dir / f"{source}_{i}.so"
        cu.write_text(text)
        procs[(source, name)] = (symbol, so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (symbol, so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = ptxas_lines(log, "median_pair_kernelILi5ELb1" if key[0] == "countsketch" else "ingest_stacked_kernelIlil")
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
        print(f"[ablate] built {key[0]} {key[1]}" + (f": {'; '.join(regs)}" if regs else ""))
    return fns


def decode_lines(torch, smoke, fns) -> None:
    from repro_torch.core.hashing import make_hash_family
    from repro_torch.kernels.countsketch.ops import _RECORD, _family_rows
    from repro_torch.kernels.countsketch.ref import countsketch_median_ref

    d, w, n = smoke.CS_DEPTH, smoke.CS_WIDTH, smoke.GRAD_100M
    gen = torch.Generator(device="cuda").manual_seed(0)
    fam = make_hash_family(torch.Generator().manual_seed(1), d, w, "cuda")
    table = torch.randn((d, w), generator=gen, device="cuda")
    table.view(-1)[torch.randperm(d * w, generator=gen, device="cuda")[:3]] = float("nan")
    want = countsketch_median_ref(table, fam, n)
    est = torch.empty(n, device="cuda")
    rec = _RECORD.pack(table.data_ptr(), est.data_ptr(), 0, 0, fam.a.data_ptr(), fam.b.data_ptr(), 0, n, d, w, 0,
                       torch._C._cuda_getCurrentRawStream(0)) + _family_rows(fam)
    for (source, name), fn in fns.items():
        if source != "countsketch":
            continue
        exact = name == "parent" or DECODE[name][1]
        est.fill_(7.0)
        smoke.check(fn(rec) == 0, f"decode {name}: launch failed")
        torch.cuda.synchronize()
        if exact:
            smoke.check(smoke.same_with_nan(torch, est, want), f"decode {name}: differs from the plain version")
        ms = smoke.device_ms(lambda: fn(rec), 20, "median")
        bound = (4 * n + 4 * d * w) / smoke.PEAK_BYTES_PER_S * 1e3
        share = f", {100 * bound / ms:.1f}% of the {bound:.5f} ms bound" if ms else ""
        print(f"[ablate] decode d={d} w={w} n={n:,} {name} ({'bit-equal' if exact else 'computes other values'}): "
              f"device {smoke._fmt(ms)}{share}")


def stacked_lines(torch, smoke, fns) -> None:
    from repro_torch.kernels.ingest.ops import INDEX_BYTES, RECORD
    from repro_torch.kernels.ingest_stacked.ref import stacked_ingest_ref

    n, d, w = smoke.FLEET_TENANTS, smoke.BASE_DEPTH, smoke.BASE_WIDTH
    first = smoke.fleet_first_batch(torch)
    batches = {"serve BASE's first batch, 16 tenants": first, **smoke.stacked_stress_batches(torch, *first)}
    got = (torch.zeros((n, d, w, w), device="cuda"), torch.zeros((n, d, w), device="cuda"),
           torch.zeros((n, d, w), device="cuda"))
    stream = torch._C._cuda_getCurrentRawStream(0)

    def record(plane, rows, cols, wts):
        return RECORD.pack(*(t.data_ptr() for t in got), plane.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                           wts.data_ptr(), n, d, w, w, rows.shape[1], INDEX_BYTES[rows.dtype],
                           INDEX_BYTES[plane.dtype], stream)

    wants = {}
    for label, batch in batches.items():
        want = stacked_ingest_ref(*(t.clone() for t in got), *batch)
        touched = sorted({int(p) for p in batch[0].unique().tolist()})
        wants[label] = (touched, [[x[p].clone() for p in touched] for x in want])
        del want
        smoke.release(torch)
    for (source, name), fn in fns.items():
        if source != "ingest_stacked":
            continue
        times = []
        for label, batch in batches.items():
            rec = record(*batch)
            for t in got:
                t.zero_()
            smoke.check(fn(rec) == 0, f"stacked {name}: launch failed")
            torch.cuda.synchronize()
            touched, want = wants[label]
            for g, x in zip(got, want):
                for p, xp in zip(touched, x):
                    smoke.check(torch.equal(g[p], xp), f"stacked {name}: plane {p} differs on {label}")
            ms = smoke.device_ms(lambda: fn(rec), 20, "ingest_stacked_kernel")
            times.append(f"{label} {smoke._fmt(ms)}")
            if label.startswith("serve"):
                times.append(f"cold L2 {smoke._fmt(smoke.cold_device_ms(lambda: fn(rec), 'ingest_stacked_kernel'))}")
        print(f"[ablate] stacked {name} (bit-equal on every batch): {'; '.join(times)}")


def main() -> int:
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import build

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None, help="a checkout whose two sources to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ablate] nvidia-smi: {smi}")
    fns = build_variants(build, args.parent)
    decode_lines(torch, smoke, fns)
    smoke.release(torch)
    stacked_lines(torch, smoke, fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
