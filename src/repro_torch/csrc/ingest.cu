// Sketch ingest scatter: counters[i, rows[i,b] - row_offset, cols[i,b]] += w[b].
//
// Replaces the TPU kernel src/repro/kernels/ingest/kernel.py::ingest_pallas
// (body _ingest_kernel).  The TPU version re-expressed the scatter as one-hot
// matmuls on the MXU, tiled over (row tile x col tile x edge chunk); none of
// that carries over.  Here one thread owns one (i, b) slot of the hashed
// batch and folds its weight in with one float atomicAdd.
//
// Semantics: rows of -1 (padding, or another shard's rows) and rows outside
// [row_offset, row_offset + wr_local) contribute nothing.  Slots of weight 0
// are skipped: adding +0.0 is the identity on counters, which never hold -0.0.
// In the counting regime (integer weights, per-cell mass < 2^24) atomics in
// any order give bit-identical counters; float weights agree to rounding.
//
// Bound on an H100 (3.35 TB/s): the scatter touches d*B random cells, each a
// 32-byte sector read and written, plus the (d, B) int32 row and column reads
// and the (B,) weight read.  At d=5, B=50,000 that is about 18 MB, some 5 us;
// the atomics' throughput in L2 is the practical limit, not the FLOPs (none).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void ingest_scatter_kernel(float* __restrict__ counters,
                                      const int* __restrict__ rows,
                                      const int* __restrict__ cols,
                                      const float* __restrict__ weights,
                                      int64_t wr_local, int64_t wc,
                                      int64_t batch, int64_t slots,
                                      int64_t row_offset) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < slots; s += stride) {
    const int raw = rows[s];
    if (raw < 0) continue;
    const int64_t r = static_cast<int64_t>(raw) - row_offset;
    if (r < 0 || r >= wr_local) continue;
    const int64_t i = s / batch;
    const float w = weights[s - i * batch];
    if (w == 0.0f) continue;
    atomicAdd(&counters[(i * wr_local + r) * wc + cols[s]], w);
  }
}

}  // namespace

extern "C" int glava_ingest_scatter(float* counters, const int* rows,
                                    const int* cols, const float* weights,
                                    int64_t depth, int64_t wr_local, int64_t wc,
                                    int64_t batch, int64_t row_offset,
                                    void* stream) {
  const int64_t slots = depth * batch;
  if (slots == 0) return 0;
  const int threads = 256;
  int64_t blocks = (slots + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  ingest_scatter_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      counters, rows, cols, weights, wr_local, wc, batch, slots, row_offset);
  return static_cast<int>(cudaGetLastError());
}
