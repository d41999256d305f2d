// Edge-query gathers over the d sketches.
//
// glava_multi_query_min — fused multi-query edge estimate:
//   est[q] = min_i counters[i, rows[i,q], cols[i,q]].
// Replaces the TPU kernel src/repro/kernels/query/kernel.py::multi_query_pallas
// (body _multi_query_kernel), which gathered through one-hot matmuls over
// every (row tile x col tile) of every sketch, with a running min in VMEM
// scratch across a sequential grid.
//
// glava_query_cells — per-sketch cell values, no min:
//   out[i, q] = counters[i, rows[i,q], cols[i,q]].
// Replaces src/repro/kernels/query/kernel.py::query_pallas (body
// _query_kernel), the same one-hot tile sweep per sketch without the min.
//
// What bounds them on an H100: d*Q data-dependent 4-byte loads from a
// counter table (1.34 GB at BASE, d=5, 8192 x 8192) far larger than the
// 50 MB L2, so each load costs one DRAM sector (32 bytes) and a full memory
// latency.  Bound: d*Q sectors, the (d, Q) row and column indices read once
// (4 or 8 bytes each) and the output written once, over 3.35 TB/s; at d=5,
// Q=65,536 with int32 indices that is 13.4 MB, 4.0 us (B2) and 14.4 MB,
// 4.3 us (B5).  Nothing is reused, so shared memory has nothing to hold,
// TMA moves tiles (not scattered words) and wgmma has no product to take:
// what the card offers here is many independent loads in flight per SM.
//
// Design: one thread owns one query and all d sketches of it.  It first
// loads its d (row, col) pairs, coalesced along q, computes the d cell
// offsets, then issues all d gathers (__ldg) before it uses the first, so d
// sectors are in flight per query instead of one.  B2 then reduces with
// fminf in sketch order 0..d-1 (bit-equal to amin over finite counters) and
// writes one float; B5 writes out[i, q] for each i, coalesced along q.
// Queries past Q are masked (the TPU wrapper padded with bucket (0, 0) and
// sliced instead).  Blocks of 64 threads up to one block per SM (Q <= 64 *
// 132; Q=1,024 then spreads over 16 SMs, not 4), else 256: the faster of
// 64, 128 and 256 at Q=1,024 and 65,536 on the H100 (PERF.md).
//
// Template axes: the depth D = 1..8, each fully unrolled, and D = 0, which
// walks a runtime depth in chunks of 8 (loads first within each chunk); the
// index type, int32 or int64, as the caller's buckets come (no cast); and
// the offset type, int32 when every cell offset and index position fits
// (d*wr*wc and d*Q below 2^31 - 1024; BASE has 335,544,320 cells), else
// int64.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>
#include <math_constants.h>

namespace {

constexpr int kChunk = 8;  // sketches in flight per query at runtime depth
constexpr int64_t kFits32 = (int64_t{1} << 31) - 1024;

// Query j: depth sketches in chunks of CHUNK, each chunk's index loads,
// then its gathers, then its reduction or stores.  With D > 0 the caller
// passes depth == CHUNK == D and the loop runs once, unrolled.
template <int CHUNK, bool MIN, typename Idx, typename Off>
__device__ __forceinline__ void gather_query(const float* __restrict__ counters,
                                             const Idx* __restrict__ rows,
                                             const Idx* __restrict__ cols,
                                             float* __restrict__ out, int depth,
                                             Off wr, Off wc, Off q) {
  const Off j = static_cast<Off>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= q) return;
  float best = CUDART_INF_F;
  for (int i0 = 0; i0 < depth; i0 += CHUNK) {
    Off cell[CHUNK];
    float v[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const Off i = i0 + t;
      if (i < depth) {
        const Off r = static_cast<Off>(__ldg(&rows[i * q + j]));
        const Off c = static_cast<Off>(__ldg(&cols[i * q + j]));
        cell[t] = (i * wr + r) * wc + c;
      }
    }
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      if (i0 + t < depth) v[t] = __ldg(&counters[cell[t]]);
    }
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const Off i = i0 + t;
      if (i < depth) {
        if constexpr (MIN) {
          best = fminf(best, v[t]);
        } else {
          out[i * q + j] = v[t];
        }
      }
    }
  }
  if constexpr (MIN) out[j] = best;
}

template <int D, typename Idx, typename Off>
__global__ void __launch_bounds__(256) multi_query_min_kernel(
    const float* __restrict__ counters, const Idx* __restrict__ rows,
    const Idx* __restrict__ cols, float* __restrict__ out, int depth, Off wr,
    Off wc, Off q) {
  gather_query<D == 0 ? kChunk : D, true>(counters, rows, cols, out,
                                          D == 0 ? depth : D, wr, wc, q);
}

template <int D, typename Idx, typename Off>
__global__ void __launch_bounds__(256) query_cells_kernel(
    const float* __restrict__ counters, const Idx* __restrict__ rows,
    const Idx* __restrict__ cols, float* __restrict__ out, int depth, Off wr,
    Off wc, Off q) {
  gather_query<D == 0 ? kChunk : D, false>(counters, rows, cols, out,
                                           D == 0 ? depth : D, wr, wc, q);
}

// One launch, as the wrapper packs it (struct.Struct("=4Q5qQ")): four
// pointers, five int64 and the stream.  One bytes argument costs ctypes one
// conversion instead of ten.
struct Record {
  const float* counters;
  const void* rows;  // (depth, q) contiguous, int32 or int64
  const void* cols;
  float* out;
  int64_t depth, wr, wc, q, index_bytes;
  cudaStream_t stream;
};
static_assert(sizeof(Record) == 80, "the record is ten 8-byte fields");

// The launch's own error comes back from cudaLaunchKernel (a refused
// configuration never runs); on one, the sticky last error is cleared so that
// no later caller's check reports it again.
template <bool MIN, int D, typename Idx, typename Off>
cudaError_t launch(const Record& r) {
  const int threads = r.q <= 64 * 132 ? 64 : 256;
  const dim3 blocks(static_cast<unsigned>((r.q + threads - 1) / threads));
  const float* counters = r.counters;
  const Idx* rows = static_cast<const Idx*>(r.rows);
  const Idx* cols = static_cast<const Idx*>(r.cols);
  float* out = r.out;
  int depth = static_cast<int>(r.depth);
  Off wr = static_cast<Off>(r.wr), wc = static_cast<Off>(r.wc), q = static_cast<Off>(r.q);
  void* args[] = {&counters, &rows, &cols, &out, &depth, &wr, &wc, &q};
  const void* kernel = reinterpret_cast<const void*>(
      MIN ? multi_query_min_kernel<D, Idx, Off> : query_cells_kernel<D, Idx, Off>);
  return cudaLaunchKernel(kernel, blocks, dim3(threads), args, 0, r.stream);
}

template <bool MIN, int D, typename Idx>
cudaError_t by_offset(const Record& r) {
  if (r.depth * r.wr * r.wc < kFits32 && r.depth * r.q < kFits32) {
    return launch<MIN, D, Idx, int32_t>(r);
  }
  return launch<MIN, D, Idx, int64_t>(r);
}

template <bool MIN, int D>
cudaError_t by_index(const Record& r) {
  return r.index_bytes == 8 ? by_offset<MIN, D, int64_t>(r) : by_offset<MIN, D, int32_t>(r);
}

template <bool MIN>
int dispatch(const char* record) {
  Record r;
  memcpy(&r, record, sizeof(Record));
  if (r.q == 0 || r.depth == 0) return 0;
  if (r.index_bytes != 4 && r.index_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (r.depth) {
    case 1: err = by_index<MIN, 1>(r); break;
    case 2: err = by_index<MIN, 2>(r); break;
    case 3: err = by_index<MIN, 3>(r); break;
    case 4: err = by_index<MIN, 4>(r); break;
    case 5: err = by_index<MIN, 5>(r); break;
    case 6: err = by_index<MIN, 6>(r); break;
    case 7: err = by_index<MIN, 7>(r); break;
    case 8: err = by_index<MIN, 8>(r); break;
    default: err = by_index<MIN, 0>(r); break;
  }
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// record: a packed Record (see above).
extern "C" int glava_multi_query_min(const char* record) { return dispatch<true>(record); }

extern "C" int glava_query_cells(const char* record) { return dispatch<false>(record); }
