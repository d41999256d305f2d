// Order-dependent sketch updates, edge by edge in stream order, in place:
//   sequential:    counters[i, r_i(e), c_i(e)] += w(e)
//   conservative:  with cur_i = counters[i, r_i(e), c_i(e)] and m = min_i cur_i,
//                  counters[i, r_i(e), c_i(e)] = max(cur_i, m + w(e))
// for e = 0, 1, ..., B-1, where r_i(e) = rows[i,e], c_i(e) = cols[i,e],
// w(e) = weights[e].
//
// A port-only kernel: the reference runs GLavaSketch.update_sequential and
// update_conservative (src/repro/core/sketch.py:399 and :420) as a lax.scan
// over the edges and leaves the scan to XLA; there is no Pallas kernel.  In
// plain PyTorch the scan is a Python loop of about five launches an edge.
//
// Design: one block of one warp.  Lane i owns sketch i (d <= 32), so every
// cell a lane reads or writes is one only it touches, and program order alone
// makes edge e+1 see edge e's store: no atomics, no fences.  Per edge a lane
// loads its cell; conservative mode takes the min across the d lanes by a
// butterfly of shuffles, stores max(cur, min + w) and moves on; sequential
// mode stores cur + w.  Every add and every max happens in the same order as
// the plain edge-by-edge loop (kernels/sequential/ref.py), so the result is
// bit-equal to it for any float weights.  Min and max propagate NaN as
// torch.amin and torch.maximum do.
//
// The edges' rows, columns and weights are staged into shared memory 32 at a
// time by cp.async, the next round's copies in flight while this round's
// edges run, and the next edge's bucket is read from shared memory while the
// current cell's load is in flight; so only the cell read, the shuffles and
// the store sit on the chain from one edge to the next.
//
// Bound on an H100: the bytes are few (each of the d*B cells read and written
// once, 8*d*B bytes, and the buckets and weights read once: 6.2 MB at d=5,
// B=50,000 with int64 buckets, 1.9 us at 3.35 TB/s); the pace is set by
// latency: B dependent round trips to the memory holding the cells, one
// after another.  Hiding that chain (forwarding a cell that the next edge
// reads again, several edges in flight on disjoint cells) is later work.
//
// An edge with a bucket outside [0, wr) x [0, wc) in any sketch is left out
// (the hash's buckets never are; the plain version raises on one).
//
// Template axes: the index type, int32 or int64, as the caller's buckets
// come (no cast); the mode.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kLanes = 32;     // one warp: lane i owns sketch i
constexpr int kMaxDepth = 32;
constexpr int kChunk = 32;     // edges staged a round, one a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kConservativeFlag = 1;

// NaN-propagating min and max (torch.amin, torch.maximum): b wins when it is
// NaN, a NaN a is kept.
__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || b != b) ? b : a; }
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

template <typename Idx>
struct Stage {
  Idx rows[2][kMaxDepth][kChunk + 1];  // +1: lanes reading one edge's d buckets spread over banks
  Idx cols[2][kMaxDepth][kChunk + 1];
  float weights[2][kChunk];
};

// Start the copies of round `round`'s edges into buffer `buf`: lane j copies
// edge round * kChunk + j (its weight and its d rows and columns).
template <typename Idx>
__device__ __forceinline__ void stage(Stage<Idx>& s, int buf, int64_t round, const Idx* rows,
                                      const Idx* cols, const float* weights, int depth,
                                      int64_t batch) {
  const int j = threadIdx.x;
  const int64_t e = round * kChunk + j;
  if (e >= batch) return;
  __pipeline_memcpy_async(&s.weights[buf][j], weights + e, sizeof(float));
  for (int i = 0; i < depth; ++i) {
    __pipeline_memcpy_async(&s.rows[buf][i][j], rows + i * batch + e, sizeof(Idx));
    __pipeline_memcpy_async(&s.cols[buf][i][j], cols + i * batch + e, sizeof(Idx));
  }
}

template <typename Idx, bool kConservative>
__global__ void __launch_bounds__(kLanes, 1) sequential_update_kernel(
    float* __restrict__ counters, const Idx* __restrict__ rows, const Idx* __restrict__ cols,
    const float* __restrict__ weights, int depth, int64_t wr, int64_t wc, int64_t batch) {
  __shared__ Stage<Idx> s;
  const int lane = threadIdx.x;
  const bool owner = lane < depth;
  float* const sketch = counters + (owner ? static_cast<int64_t>(lane) * wr * wc : 0);
  int span = 1;  // the butterfly covers lanes [0, span), span a power of two >= depth
  while (span < depth) span <<= 1;
  const int64_t rounds = (batch + kChunk - 1) / kChunk;

  // The cell of edge k of buffer buf for this lane, and whether the whole
  // edge is in range (warp-uniform).
  auto slot = [&](int buf, int k, float*& cell, bool& skip) {
    bool bad = false;
    cell = sketch;
    if (owner) {
      const int64_t r = static_cast<int64_t>(s.rows[buf][lane][k]);
      const int64_t c = static_cast<int64_t>(s.cols[buf][lane][k]);
      bad = r < 0 || r >= wr || c < 0 || c >= wc;
      if (!bad) cell = sketch + r * wc + c;
    }
    skip = __any_sync(kFull, bad);
  };

  stage(s, 0, 0, rows, cols, weights, depth, batch);
  __pipeline_commit();
  for (int64_t round = 0; round < rounds; ++round) {
    const int buf = static_cast<int>(round & 1);
    if (round + 1 < rounds) stage(s, buf ^ 1, round + 1, rows, cols, weights, depth, batch);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this round's copies have landed
    __syncwarp();
    const int n = static_cast<int>(batch - round * kChunk < kChunk ? batch - round * kChunk : kChunk);
    float* cell;
    bool skip;
    slot(buf, 0, cell, skip);
    for (int k = 0; k < n; ++k) {
      float* const here = cell;
      const bool skip_here = skip;
      const float w = s.weights[buf][k];
      const float cur = (owner && !skip_here) ? *here : CUDART_INF_F;
      if (k + 1 < n) slot(buf, k + 1, cell, skip);  // overlaps the load above
      if (skip_here) continue;
      if (kConservative) {
        float m = cur;
        for (int off = span >> 1; off > 0; off >>= 1) m = nan_min(m, __shfl_xor_sync(kFull, m, off));
        if (owner) *here = nan_max(cur, m + w);
      } else if (owner) {
        *here = cur + w;
      }
    }
    __syncwarp();  // every lane is done with buf before round + 2 stages into it
  }
}

// One launch, as the wrapper packs it (kernels/ingest/ops.py RECORD,
// struct.Struct("=7Q7qQ"), the ingest kernels' layout).  This kernel reads
// the counters, rows, cols and weights pointers, d, wr, wc, B, the index size
// and the flags (bit 0: conservative); no register, bitmap or row offset.
struct Record {
  float* counters;
  float* row_flows;
  float* col_flows;
  uint8_t* touched;
  const void* rows;  // (depth, batch) contiguous, int32 or int64
  const void* cols;
  const float* weights;  // (batch,)
  int64_t depth, wr, wc, batch, row_offset, index_bytes, flags;
  cudaStream_t stream;
};
static_assert(sizeof(Record) == 120, "the record is fifteen 8-byte fields");

template <typename Idx, bool kConservative>
cudaError_t launch(const Record& r) {
  float* counters = r.counters;
  const Idx* rows = static_cast<const Idx*>(r.rows);
  const Idx* cols = static_cast<const Idx*>(r.cols);
  const float* weights = r.weights;
  int depth = static_cast<int>(r.depth);
  int64_t wr = r.wr, wc = r.wc, batch = r.batch;
  void* args[] = {&counters, &rows, &cols, &weights, &depth, &wr, &wc, &batch};
  return cudaLaunchKernel(reinterpret_cast<const void*>(sequential_update_kernel<Idx, kConservative>),
                          dim3(1), dim3(kLanes), args, 0, r.stream);
}

template <typename Idx>
cudaError_t by_mode(const Record& r) {
  return (r.flags & kConservativeFlag) ? launch<Idx, true>(r) : launch<Idx, false>(r);
}

}  // namespace

// record: a packed Record (see above).  Returns the launch's cudaError_t; on
// an error the sticky last error is cleared, so no later check reports it.
extern "C" int glava_sequential_update(const char* record) {
  Record r;
  memcpy(&r, record, sizeof(Record));
  if (r.batch == 0 || r.depth == 0) return 0;
  if ((r.index_bytes != 4 && r.index_bytes != 8) || r.depth > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = r.index_bytes == 8 ? by_mode<int64_t>(r) : by_mode<int32_t>(r);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
