// Stacked ingest: fold one hashed batch into N stacked sketch planes, in place:
//   counters[p, i, r, c] += w    row_flows[p, i, r] += w    col_flows[p, i, c] += w
// for every slot (i, b) of the batch with p = plane[b], r = rows[i,b],
// c = cols[i,b], w = weights[b].
//
// A port-only kernel: the reference has no Pallas kernel here.  It replaces
// the flat XLA scatter of src/repro/core/sketch.py::scatter_stacked, which the
// fleet's FleetSketch.update (src/repro/fleet/stack.py) runs once per batch
// and direction, with the tenant and window slice riding in the plane index.
// In plain PyTorch that is three index_put_(accumulate=True) calls plus the
// index arithmetic; here it is one launch.
//
// Semantics: a slot whose row lies outside [0, wr) (-1 is padding) or whose
// plane lies outside [0, N) adds nothing.  Slots of weight 0 are skipped:
// adding +0.0 is the identity on counters and registers, which never hold
// -0.0.  Negative weights are added as they come (turnstile deletes).  In the
// counting regime (integer weights, per-cell and per-register mass < 2^24)
// atomics in any order give bit-identical results; float weights agree to
// rounding.
//
// Design (simple and right): grid (chunk of B, sketch i), one thread a slot,
// three REDs (atomicAdd with the result unused) a weighted valid slot.  The
// fused ingest's run aggregation of row_flows and its column match are left
// for later: a fleet batch is sorted by tenant slot, not by (src, dst).
//
// Offsets: the reference computes its flat index in int32, which wraps once
// N*d*wr*wc reaches 2^31 (7 planes at d=5, w=8,192).  Here the offset type is
// int32 only when every cell offset and slot position fits (N*d*wr*wc and
// d*B below 2^31 - 1024), else int64.
//
// Bound on an H100 (3.35 TB/s): each distinct counter and register sector the
// weighted valid slots add into is read and written once (32 bytes each way),
// the (d, B) rows and columns, the (B,) plane and the (B,) weights read once.
//
// Template axes: the bucket type and the plane type, each int32 or int64 as
// the caller's tensors come (no cast); the offset type as above.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kFits32 = (int64_t{1} << 31) - 1024;

template <typename Idx, typename Pl, typename Off>
__global__ void __launch_bounds__(kThreads) ingest_stacked_kernel(
    float* __restrict__ counters, float* __restrict__ row_flows, float* __restrict__ col_flows,
    const Pl* __restrict__ plane, const Idx* __restrict__ rows, const Idx* __restrict__ cols,
    const float* __restrict__ weights, Off n_planes, Off depth, Off wr, Off wc, Off batch) {
  const Off b = static_cast<Off>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= batch) return;
  const Off i = blockIdx.y;
  const Off s = i * batch + b;
  const int64_t r = static_cast<int64_t>(rows[s]);
  if (r < 0 || r >= static_cast<int64_t>(wr)) return;
  const int64_t p = static_cast<int64_t>(plane[b]);
  if (p < 0 || p >= static_cast<int64_t>(n_planes)) return;
  const float w = weights[b];
  if (w == 0.0f) return;
  const Off c = static_cast<Off>(cols[s]);
  const Off sketch = static_cast<Off>(p) * depth + i;  // (plane, sketch) index
  const Off row = sketch * wr + static_cast<Off>(r);
  atomicAdd(&counters[row * wc + c], w);
  atomicAdd(&row_flows[row], w);
  atomicAdd(&col_flows[sketch * wc + c], w);
}

// One launch, as the wrapper packs it (kernels/ingest_stacked/ops.py, the
// record layout of kernels/ingest/ops.py RECORD, struct.Struct("=7Q7qQ")):
// seven pointers, seven 64-bit integers, the stream.
struct Record {
  float* counters;   // (N, depth, wr, wc) contiguous
  float* row_flows;  // (N, depth, wr)
  float* col_flows;  // (N, depth, wc)
  const void* plane;  // (batch,) int32 or int64
  const void* rows;   // (depth, batch) contiguous, int32 or int64
  const void* cols;
  const float* weights;  // (batch,)
  int64_t n_planes, depth, wr, wc, batch, index_bytes, plane_bytes;
  cudaStream_t stream;
};
static_assert(sizeof(Record) == 120, "the record is fifteen 8-byte fields");

template <typename Idx, typename Pl, typename Off>
cudaError_t launch(const Record& r) {
  const dim3 blocks(static_cast<unsigned>((r.batch + kThreads - 1) / kThreads),
                    static_cast<unsigned>(r.depth));
  float* counters = r.counters;
  float* row_flows = r.row_flows;
  float* col_flows = r.col_flows;
  const Pl* plane = static_cast<const Pl*>(r.plane);
  const Idx* rows = static_cast<const Idx*>(r.rows);
  const Idx* cols = static_cast<const Idx*>(r.cols);
  const float* weights = r.weights;
  Off n = static_cast<Off>(r.n_planes), d = static_cast<Off>(r.depth);
  Off wr = static_cast<Off>(r.wr), wc = static_cast<Off>(r.wc), batch = static_cast<Off>(r.batch);
  void* args[] = {&counters, &row_flows, &col_flows, &plane, &rows, &cols, &weights, &n, &d, &wr, &wc, &batch};
  return cudaLaunchKernel(reinterpret_cast<const void*>(ingest_stacked_kernel<Idx, Pl, Off>),
                          blocks, dim3(kThreads), args, 0, r.stream);
}

template <typename Idx, typename Pl>
cudaError_t by_offset(const Record& r) {
  if (r.n_planes * r.depth * r.wr * r.wc < kFits32 && r.depth * r.batch < kFits32) {
    return launch<Idx, Pl, int32_t>(r);
  }
  return launch<Idx, Pl, int64_t>(r);
}

template <typename Idx>
cudaError_t by_plane(const Record& r) {
  return r.plane_bytes == 8 ? by_offset<Idx, int64_t>(r) : by_offset<Idx, int32_t>(r);
}

}  // namespace

// record: a packed Record (see above).  Returns the launch's cudaError_t; on
// an error the sticky last error is cleared, so no later check reports it.
extern "C" int glava_ingest_stacked(const char* record) {
  Record r;
  memcpy(&r, record, sizeof(Record));
  if (r.batch == 0 || r.depth == 0 || r.n_planes == 0) return 0;
  if ((r.index_bytes != 4 && r.index_bytes != 8) || (r.plane_bytes != 4 && r.plane_bytes != 8) ||
      r.depth > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = r.index_bytes == 8 ? by_plane<int64_t>(r) : by_plane<int32_t>(r);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
