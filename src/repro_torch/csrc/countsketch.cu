// CountSketch of a flat vector: table[i, h[i,j]] += s[i,j] * vec[j].
//
// Replaces the TPU kernel src/repro/kernels/countsketch/kernel.py::
// countsketch_pallas (body _cs_kernel).  The TPU version tiled the table into
// 256-wide stripes over a (d, width/256, n/1024) grid and built each stripe
// as a one-hot MXU product, so every stripe re-read all of vec: O(n * width)
// work.  None of that carries over.  Here the work is O(d * n):
//   * Shared-memory path (width * 4 bytes within the opt-in limit, about
//     56 K floats on an H100): one block owns one sketch row i and a
//     contiguous range of j.  It zeroes a private copy of the row's width
//     floats in shared memory, folds s * vec into it with shared-memory
//     atomics (a zero product is skipped: adding +0.0 changes no cell, and
//     the second sketch of a training step is almost all zeros), then adds
//     each nonzero cell into the global table with one atomicAdd.
//   * Global path (wider rows): a grid-stride loop over the d * n slots with
//     one global atomicAdd per nonzero product.
// The table must be zeroed by the caller.  Buckets outside [0, width) are
// skipped (a HashFamily of width `width` never yields one).
// fp32 atomics add in any order: integer-valued vec whose partial sums stay
// below 2^24 gives the plain version's table bit for bit, float vec agrees to
// rounding.
//
// Bound on an H100 (3.35 TB/s): each element's value (4 bytes), its d int32
// buckets and its d signs (int8: 1 byte each, or int32) are read once, the
// (d, width) float32 table written once: 4 + 5d bytes an element with int8
// signs, 29 at d=5, so 0.56 ms for a 65 M-element gradient.  No arithmetic
// worth counting; the shared-memory atomics' throughput is the practical
// limit once the reads are coalesced.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 512;

template <typename Sign>
__global__ void __launch_bounds__(THREADS)
countsketch_smem_kernel(const float* __restrict__ vec, const int* __restrict__ h,
                        const Sign* __restrict__ s, float* __restrict__ table,
                        int64_t n, int width, int64_t chunk) {
  extern __shared__ float row[];
  const int64_t i = blockIdx.y;
  for (int c = threadIdx.x; c < width; c += THREADS) row[c] = 0.0f;
  __syncthreads();
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const int* hrow = h + i * n;
  const Sign* srow = s + i * n;
  for (int64_t j = lo + threadIdx.x; j < hi; j += THREADS) {
    const float v = vec[j];
    if (v == 0.0f) continue;
    const int b = hrow[j];
    if (static_cast<unsigned>(b) >= static_cast<unsigned>(width)) continue;
    atomicAdd(&row[b], static_cast<float>(srow[j]) * v);
  }
  __syncthreads();
  float* out = table + i * width;
  for (int c = threadIdx.x; c < width; c += THREADS) {
    const float v = row[c];
    if (v != 0.0f) atomicAdd(&out[c], v);
  }
}

template <typename Sign>
__global__ void __launch_bounds__(THREADS)
countsketch_global_kernel(const float* __restrict__ vec, const int* __restrict__ h,
                          const Sign* __restrict__ s, float* __restrict__ table,
                          int64_t n, int64_t width, int64_t slots) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       k < slots; k += stride) {
    const int64_t i = k / n;
    const float v = vec[k - i * n];
    if (v == 0.0f) continue;
    const int b = h[k];
    if (b < 0 || b >= width) continue;
    atomicAdd(&table[i * width + b], static_cast<float>(s[k]) * v);
  }
}

template <typename Sign>
int launch(const float* vec, const int* h, const Sign* s, float* table,
           int64_t depth, int64_t n, int64_t width, cudaStream_t stream) {
  if (depth == 0 || n == 0) return 0;
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int64_t smem = width * static_cast<int64_t>(sizeof(float));
  if (smem <= optin) {
    auto kernel = countsketch_smem_kernel<Sign>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
    // Two waves of resident blocks, split evenly over the d rows; no block
    // gets fewer than 4 elements a thread, so the flush stays a small share.
    int64_t per_row = (2LL * sms * per_sm + depth - 1) / depth;
    const int64_t most = (n + 4LL * THREADS - 1) / (4LL * THREADS);
    if (per_row > most) per_row = most;
    if (per_row < 1) per_row = 1;
    const int64_t chunk = (n + per_row - 1) / per_row;
    per_row = (n + chunk - 1) / chunk;
    kernel<<<dim3(static_cast<unsigned>(per_row), static_cast<unsigned>(depth)), THREADS,
             static_cast<size_t>(smem), stream>>>(vec, h, s, table, n,
                                                   static_cast<int>(width), chunk);
  } else {
    const int64_t slots = depth * n;
    int64_t blocks = (slots + THREADS - 1) / THREADS;
    if (blocks > 32LL * sms) blocks = 32LL * sms;  // grid-stride beyond this
    countsketch_global_kernel<Sign><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        vec, h, s, table, n, width, slots);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sign_bytes selects the sign type: 1 for int8, 4 for int32.
extern "C" int glava_countsketch(const float* vec, const int* h, const void* s,
                                 int64_t sign_bytes, float* table, int64_t depth,
                                 int64_t n, int64_t width, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sign_bytes == 1)
    return launch(vec, h, static_cast<const int8_t*>(s), table, depth, n, width, st);
  if (sign_bytes == 4)
    return launch(vec, h, static_cast<const int32_t*>(s), table, depth, n, width, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
