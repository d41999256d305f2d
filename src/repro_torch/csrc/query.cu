// Edge-query gathers over the d sketches.
//
// glava_multi_query_min — fused multi-query edge estimate:
//   est[q] = min_i counters[i, rows[i,q], cols[i,q]].
//
// Replaces the TPU kernel src/repro/kernels/query/kernel.py::multi_query_pallas
// (body _multi_query_kernel).  The TPU version gathered through one-hot
// matmuls over every (row tile x col tile) of every sketch, with a running
// min in VMEM scratch across a sequential grid.  On the GPU a gather is a
// plain load: one thread owns one query, loops over the d sketches and keeps
// the min in a register, so the (d, Q) intermediate never exists.  Queries
// past Q are masked by the bounds check (the TPU wrapper padded with bucket
// (0, 0) and sliced instead).
//
// Bound on an H100 (3.35 TB/s): d*Q random 32-byte sectors of counters plus
// the (d, Q) int32 row and column reads and the (Q,) float write.  At d=5,
// Q=65,536 that is about 13 MB, some 4 us; at Q=1,024 the launch dominates.
//
// glava_query_cells — per-sketch cell values, no min:
//   out[i, q] = counters[i, rows[i,q], cols[i,q]].
// Replaces src/repro/kernels/query/kernel.py::query_pallas (body
// _query_kernel), which gathered through the same one-hot tile sweep per
// sketch.  Here one thread owns one (i, q) slot and does one load.  Bound:
// d*Q random 32-byte sectors, the indices and the (d, Q) float write; at
// d=5, Q=65,536 about 14 MB, some 4 us.
#include <cuda_runtime.h>
#include <cstdint>
#include <math_constants.h>

namespace {

__global__ void multi_query_min_kernel(const float* __restrict__ counters,
                                       const int* __restrict__ rows,
                                       const int* __restrict__ cols,
                                       float* __restrict__ out, int64_t depth,
                                       int64_t wr, int64_t wc, int64_t q) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= q) return;
  float best = CUDART_INF_F;
  for (int64_t i = 0; i < depth; ++i) {
    const int64_t cell = (i * wr + rows[i * q + j]) * wc + cols[i * q + j];
    best = fminf(best, __ldg(&counters[cell]));
  }
  out[j] = best;
}

__global__ void query_cells_kernel(const float* __restrict__ counters,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ cols,
                                   float* __restrict__ out, int64_t wr,
                                   int64_t wc, int64_t q, int64_t slots) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  const int64_t i = s / q;
  out[s] = __ldg(&counters[(i * wr + rows[s]) * wc + cols[s]]);
}

}  // namespace

extern "C" int glava_multi_query_min(const float* counters, const int* rows,
                                     const int* cols, float* out, int64_t depth,
                                     int64_t wr, int64_t wc, int64_t q,
                                     void* stream) {
  if (q == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (q + threads - 1) / threads;
  multi_query_min_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      counters, rows, cols, out, depth, wr, wc, q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glava_query_cells(const float* counters, const int* rows,
                                 const int* cols, float* out, int64_t depth,
                                 int64_t wr, int64_t wc, int64_t q,
                                 void* stream) {
  const int64_t slots = depth * q;
  if (slots == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (slots + threads - 1) / threads;
  query_cells_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      counters, rows, cols, out, wr, wc, q, slots);
  return static_cast<int>(cudaGetLastError());
}
