// One-pass fused ingest, in place:
//   counters[i, r, c] += w    row_flows[i, r] += w    col_flows[i, c] += w
//   touched[i, r] = 1
// for every slot (i, b) of a hashed batch with r = rows[i,b] >= 0,
// c = cols[i,b], w = weights[b].
//
// Replaces the TPU kernel
// src/repro/kernels/ingest_fused/kernel.py::fused_ingest_pallas (body
// _fused_kernel).  The TPU version kept a (TILE_R x wc) counter stripe, its
// row-flow and touched slices and the whole col-flow row in VMEM and folded
// edge chunks in through one-hot matmuls on the MXU; its width was capped by
// VMEM (MAX_FUSED_WC in its ops.py).  None of that carries over: here one
// thread owns one (i, b) slot and does three float atomicAdds and one byte
// store, so any width runs.
//
// Semantics: a slot whose row is -1 (padding) returns at once and touches
// nothing, col_flows included.  A valid slot of weight 0 skips its atomics
// (adding +0.0 is the identity on counters, which never hold -0.0) but still
// marks its row: touched means "a valid slot hashed here".  The byte store
// races between slots of one row; every racer stores 1, so the race is
// benign.  In the counting regime (integer weights, per-cell and per-register
// mass < 2^24) atomics in any order give bit-identical results; float
// weights agree to rounding.
//
// Bound on an H100 (3.35 TB/s): each valid slot reads and writes one 32-byte
// sector of counters (distinct cells in a random batch), the registers are
// small ((d, wr) and (d, wc) floats, 160 KB each at BASE) and stay in L2,
// plus the (d, B) int32 row and column reads, the (B,) weights and the
// (d, wr) byte bitmap.  Under skewed sources many slots add into one
// row_flows address; those atomics serialise in L2, the practical limit
// under zipf traffic (warp aggregation would cut them).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void fused_ingest_kernel(float* __restrict__ counters,
                                    float* __restrict__ row_flows,
                                    float* __restrict__ col_flows,
                                    uint8_t* __restrict__ touched,
                                    const int* __restrict__ rows,
                                    const int* __restrict__ cols,
                                    const float* __restrict__ weights,
                                    int64_t wr, int64_t wc, int64_t batch,
                                    int64_t slots) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < slots; s += stride) {
    const int r = rows[s];
    if (r < 0) continue;
    const int64_t i = s / batch;
    const int64_t row = i * wr + r;
    touched[row] = 1;
    const float w = weights[s - i * batch];
    if (w == 0.0f) continue;
    const int c = cols[s];
    atomicAdd(&counters[row * wc + c], w);
    atomicAdd(&row_flows[row], w);
    atomicAdd(&col_flows[i * wc + c], w);
  }
}

}  // namespace

extern "C" int glava_fused_ingest(float* counters, float* row_flows,
                                  float* col_flows, uint8_t* touched,
                                  const int* rows, const int* cols,
                                  const float* weights, int64_t depth,
                                  int64_t wr, int64_t wc, int64_t batch,
                                  void* stream) {
  const int64_t slots = depth * batch;
  if (slots == 0) return 0;
  const int threads = 256;
  int64_t blocks = (slots + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  fused_ingest_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      counters, row_flows, col_flows, touched, rows, cols, weights, wr, wc,
      batch, slots);
  return static_cast<int>(cudaGetLastError());
}
