#!/usr/bin/env python3
"""Where the fused-ingest kernel's time goes, by variant and by ablation.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/ablate_fused_ingest.py

It builds ``src/repro_torch/csrc/ingest_fused.cu`` as it is and in edited
copies (one ``nvcc`` each, all at once, into ``build/kernels/ablate/``):
design variants that compute the same outputs (marks as byte stores or as a
returning ``atomicOr``, 1 or 4 slots a thread, ``col_flows`` without its
warp aggregation), each checked bit-equal to the plain version, and
ablations that drop one kind of request (the marks, the ``col_flows`` adds,
the ``row_flows`` adds, all but the counter adds), which compute less and
are timed only.  Each is timed by the profiler's device time (the helper of
``chip_smoke.py``) on the two inputs of ``chip_smoke.py``'s fused-ingest
phase: serve BASE's first batch (int64 buckets, sorted by source, padded)
and the B=50,000 int32 batch of uniform rows.  Prints the card's name and
power limit and one line per variant.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MARK_BY_RED = "        red_or(reinterpret_cast<unsigned*>(word), 1u << (8 * (at & 3)));\n"
MARK_BLOCK = (
    "      if (word >= words_lo && word < words_hi) {\n" + MARK_BY_RED
    + "      } else {\n        marks[row] = 1;\n      }\n"
)
COUNTER_ADD = "    if (add) atomicAdd(&cells[static_cast<Off>(row) * wc + c[k]], w[k]);\n"
ROW_ADD = "      if (sum != 0.0f) atomicAdd(&rf[row], sum);\n"
COL_BLOCK = (
    "    const unsigned same = __match_any_sync(kFull, add ? c[k] : -1 - lane);\n"
    "    if (add) {\n"
    "      float csum = w[k];\n"
    "      if (same & (same - 1)) {  // more than one lane: each member sums the group in lane order\n"
    "        csum = 0.0f;\n"
    "        for (unsigned m = same; m; m &= m - 1) csum += __shfl_sync(same, w[k], __ffs(m) - 1);\n"
    "      }\n"
    "      if (lane == __ffs(same) - 1) atomicAdd(&cf[c[k]], csum);\n"
    "    }\n"
)
ROUNDS = "constexpr int kRounds = 2;"

# name -> (edits of the source, whether it computes the same outputs)
VARIANTS = {
    "as built": ([], True),
    "marks as byte stores": ([(MARK_BLOCK, "      marks[row] = 1;\n")], True),
    "marks by atomicOr (ATOM, returns the word)": ([(MARK_BY_RED, MARK_BY_RED.replace("red_or", "atomicOr"))], True),
    "1 slot a thread": ([(ROUNDS, "constexpr int kRounds = 1;")], True),
    "4 slots a thread": ([(ROUNDS, "constexpr int kRounds = 4;")], True),
    "col_flows one add a slot, no match": ([(COL_BLOCK, "    if (add) atomicAdd(&cf[c[k]], w[k]);\n")], True),
    "ablation: no marks": ([(MARK_BLOCK, "")], False),
    "ablation: no col_flows adds": ([(COL_BLOCK, "")], False),
    "ablation: no row_flows adds": ([(ROW_ADD, "")], False),
    "ablation: counter adds only": ([(MARK_BLOCK, ""), (COL_BLOCK, ""), (ROW_ADD, "")], False),
    "ablation: no counter adds": ([(COUNTER_ADD, "")], False),
}


def build_variants(build) -> dict:
    """name -> the launch function of its shared library."""
    source = (build.CSRC_DIR / "ingest_fused.cu").read_text()
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).glava_fused_ingest
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.ingest.ops import INDEX_BYTES, RECORD
    from repro_torch.kernels.ingest_fused.ref import fused_ingest_ref

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ablate] nvidia-smi: {smi}")
    fns = build_variants(build)
    d, w, b = smoke.BASE_DEPTH, smoke.BASE_WIDTH, smoke.INGEST_BATCH
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = tuple(torch.randint(0, 1000, shape, generator=gen, device="cuda").float()
                  for shape in ((d, w, w), (d, w), (d, w)))
    rows = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    rows[torch.rand((d, b), generator=gen, device="cuda") < 0.1] = -1
    cols = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    wts = torch.randint(1, 9, (b,), generator=gen, device="cuda").float()
    wts[torch.rand((b,), generator=gen, device="cuda") < 0.05] = 0.0
    srows, scols, swts, _ = smoke.serve_first_batch(torch)
    inputs = {"serve BASE's first batch": (srows, scols, swts), "B=50,000 int32 uniform rows": (rows, cols, wts)}
    stream = torch._C._cuda_getCurrentRawStream(0)

    def record(outs, r, c, wt):
        return RECORD.pack(*(t.data_ptr() for t in outs), r.data_ptr(), c.data_ptr(), wt.data_ptr(),
                           d, w, w, r.shape[1], 0, INDEX_BYTES[r.dtype], 0, stream)

    for name, fn in fns.items():
        times = []
        for label, (r, c, wt) in inputs.items():
            if VARIANTS[name][1]:
                outs = [t.clone() for t in state] + [torch.ones(d, w, dtype=torch.bool, device="cuda")]
                smoke.check(fn(record(outs, r, c, wt)) == 0, f"{name}: launch failed")
                want = fused_ingest_ref(*(t.clone() for t in state), r, c, wt)
                smoke.check(all(torch.equal(g, x) for g, x in zip(outs, want)), f"{name}: differs on {label}")
            outs = [t.clone() for t in state] + [torch.empty(d, w, dtype=torch.bool, device="cuda")]
            rec = record(outs, r, c, wt)
            times.append(f"{label} {smoke._fmt(smoke.device_ms(lambda: fn(rec), 50, 'fused_ingest_kernel'))}")
        same = "bit-equal" if VARIANTS[name][1] else "computes less"
        print(f"[ablate] {name} ({same}): {'; '.join(times)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
