// Fused multi-query edge estimate: est[q] = min_i counters[i, rows[i,q], cols[i,q]].
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
