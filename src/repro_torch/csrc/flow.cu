// Row and column sums of the counters in one pass:
//   row_sums[i, r] = sum_c counters[i, r, c]    (out-flow table)
//   col_sums[i, c] = sum_r counters[i, r, c]    (in-flow table)
//
// Replaces the TPU kernel src/repro/kernels/flow/kernel.py::flows_pallas
// (body _flow_kernel).  The TPU version swept (TILE_R x TILE_C) tiles over a
// sequential grid and accumulated both outputs in place across grid steps.
// Hopper blocks run in any order, so nothing can be carried between them:
// here one block owns ROWS whole rows of one sketch and walks the full width
// in steps of its 256 threads (thread t owns column c0 + t of each step, so
// a warp reads 128 contiguous bytes of each row).
//   * Row sums stay inside the block: each thread keeps ROWS partial sums in
//     registers, each warp folds its lanes with shuffles, and the block adds
//     its 8 warps in a fixed order before one plain store per row.
//   * Column sums cross blocks: each thread adds its column's ROWS values in
//     a register and folds that partial into col_sums with one atomicAdd per
//     (block, column).  col_sums must be zeroed by the caller.
// Sums are taken in another order than torch.sum's; in the counting regime
// (integer counters, every sum < 2^24) any order is exact.
//
// Bound on an H100 (3.35 TB/s): one read of the counters, d*wr*wc*4 bytes
// (1.34 GB at BASE, d=5, 8192 x 8192: 0.40 ms), plus the two small outputs.
// The atomics number d * ceil(wr/ROWS) * wc (10.5 M at BASE) to d*wc
// distinct addresses; they resolve in L2 and overlap the stream of reads.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;

__global__ void __launch_bounds__(THREADS)
flows_kernel(const float* __restrict__ counters, float* __restrict__ row_sums,
             float* __restrict__ col_sums, int64_t wr, int64_t wc) {
  const int64_t i = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int nrows = static_cast<int>(wr - r0 < ROWS ? wr - r0 : ROWS);
  const float* base = counters + (i * wr + r0) * wc;
  float row_part[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) row_part[k] = 0.0f;

  for (int64_t c0 = 0; c0 < wc; c0 += THREADS) {
    const int64_t c = c0 + threadIdx.x;
    const bool in = c < wc;
    float col_part = 0.0f;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const float v = (in && k < nrows) ? __ldg(&base[k * wc + c]) : 0.0f;
      col_part += v;
      row_part[k] += v;
    }
    if (in) atomicAdd(&col_sums[i * wc + c], col_part);
  }

  __shared__ float warp_rows[WARPS][ROWS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    float v = row_part[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_rows[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_rows[w][threadIdx.x];
    row_sums[i * wr + r0 + threadIdx.x] = total;
  }
}

}  // namespace

extern "C" int glava_flows(const float* counters, float* row_sums,
                           float* col_sums, int64_t depth, int64_t wr,
                           int64_t wc, void* stream) {
  if (depth == 0 || wr == 0 || wc == 0) return 0;
  const dim3 grid(static_cast<unsigned>((wr + ROWS - 1) / ROWS),
                  static_cast<unsigned>(depth));
  flows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      counters, row_sums, col_sums, wr, wc);
  return static_cast<int>(cudaGetLastError());
}
