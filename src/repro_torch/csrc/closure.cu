// One boolean squaring step of transitive closure: out = A OR (A @ A > 0),
// for n stacked (w, w) float 0/1 matrices (the d sketches), w % 128 == 0.
//
// Replaces the TPU kernel src/repro/kernels/closure/kernel.py::closure_step_pallas
// (body _closure_kernel).  The TPU version accumulated into its output block
// across a sequential contraction grid axis and read A three times through
// BlockSpecs.  Here each block owns one 128 x 128 output tile of one matrix
// (grid z = the sketch index) and loops over the contraction itself; blocks
// run in parallel in any order, so the step reads `a` and writes a SEPARATE
// buffer `out` (the caller ping-pongs two buffers across steps).
//
// The product runs on the tensor cores (WMMA, bf16 inputs, fp32 sums).  It is
// exact: 0 and 1 are exact in bf16, and every sum is at most w <= 2^24.  Each
// warp of 8 computes a 32 x 64 sub-tile as 2 x 4 fragments of 16 x 16; tiles
// of A are converted from float to bf16 on their way into shared memory.  The
// epilogue saturates (> 0 -> 1) and ORs in A's own entry.
//
// Bound on an H100: 2*w^3 operations per matrix at 989 TFLOP/s (bf16 dense);
// at d=5, w=8,192 that is 5.5 TFLOP, 5.6 ms a step, far above the 2.7 GB of
// reads and writes (0.8 ms at 3.35 TB/s).  This simple kernel has no
// asynchronous copies or software pipeline (cp.async/TMA, wgmma), so it sits
// well below that bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 4, WARPS_N = 2, THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 32 x 64 per warp
constexpr int FM = WM / 16, FN = WN / 16;            // 2 x 4 fragments
constexpr int A_LD = BK + 8, B_LD = BN + 8;          // padded rows, in bf16

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(v.z, v.w);
}

__global__ void __launch_bounds__(THREADS)
closure_step_kernel(const float* __restrict__ a, float* __restrict__ out, int64_t w) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float stage[WARPS_M * WARPS_N][16 * 16];

  const int64_t plane = w * w;
  const float* A = a + static_cast<int64_t>(blockIdx.z) * plane;
  float* O = out + static_cast<int64_t>(blockIdx.z) * plane;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int m = 0; m < FM; ++m)
#pragma unroll
    for (int n = 0; n < FN; ++n) wmma::fill_fragment(acc[m][n], 0.0f);

  for (int64_t k0 = 0; k0 < w; k0 += BK) {
    for (int t = tid; t < BM * BK / 4; t += THREADS) {  // A[i0:+BM, k0:+BK]
      const int r = t / (BK / 4), c = (t % (BK / 4)) * 4;
      store4(&As[r * A_LD + c],
             *reinterpret_cast<const float4*>(&A[(i0 + r) * w + k0 + c]));
    }
    for (int t = tid; t < BK * BN / 4; t += THREADS) {  // A[k0:+BK, j0:+BN]
      const int r = t / (BN / 4), c = (t % (BN / 4)) * 4;
      store4(&Bs[r * B_LD + c],
             *reinterpret_cast<const float4*>(&A[(k0 + r) * w + j0 + c]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int m = 0; m < FM; ++m)
        wmma::load_matrix_sync(fa[m], &As[(wm * WM + m * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int n = 0; n < FN; ++n)
        wmma::load_matrix_sync(fb[n], &Bs[kk * B_LD + wn * WN + n * 16], B_LD);
#pragma unroll
      for (int m = 0; m < FM; ++m)
#pragma unroll
        for (int n = 0; n < FN; ++n) wmma::mma_sync(acc[m][n], fa[m], fb[n], acc[m][n]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int m = 0; m < FM; ++m) {
#pragma unroll
    for (int n = 0; n < FN; ++n) {
      wmma::store_matrix_sync(st, acc[m][n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        const int64_t idx =
            (i0 + wm * WM + m * 16 + e / 16) * w + j0 + wn * WN + n * 16 + e % 16;
        O[idx] = (st[e] > 0.0f || A[idx] > 0.0f) ? 1.0f : 0.0f;
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int glava_closure_step(const float* a, float* out, int64_t n, int64_t w,
                                  void* stream) {
  if (n == 0 || w == 0) return 0;
  if (w % BM != 0 || w % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(w / BN), static_cast<unsigned>(w / BM),
                  static_cast<unsigned>(n));
  closure_step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, out, w);
  return static_cast<int>(cudaGetLastError());
}
