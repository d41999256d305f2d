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
// Design: one thread a slot b for all d sketches, so plane[b] and
// weights[b] are read once and rows[i, b], cols[i, b] coalesced along b, up
// to 8 sketches' buckets loaded before the first add.  A fleet batch is
// grouped by tenant slot but within a tenant comes in arrival order, with
// zipf sources and destinations: the slots of a warp share their plane, hot
// rows and columns recur among them, and same-address REDs from one warp
// serialise at the L2 slice that owns the address.  So each add is
// aggregated within the warp first: two __match_any_sync a sketch, on the
// row register's key (plane, row) and on the column register's (plane,
// column), 32-bit where they fit; two slots add into the same counter cell
// exactly when they share both, so the cell's group is the two groups'
// intersection and takes no third match.  Each group's lowest lane sums
// its weights in lane order and issues one RED (none when the sum is 0).
// The adds are RED (atomicAdd with the result unused), never ATOM.
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

constexpr int kThreads = 128;
constexpr int kSketches = 8;  // sketches whose buckets a thread loads before its first add
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kFits32 = (int64_t{1} << 31) - 1024;

// Adds the w of every lane of `group` (the lanes adding into base[at], this
// lane among them) into base[at]: the group's lowest lane sums the group's
// weights in lane order and issues one RED, none when the sum is 0.  Every
// lane of the group calls it.
template <typename Off>
__device__ __forceinline__ void add_group(float* __restrict__ base, Off at, float w, unsigned group, int lane) {
  float sum = w;
  if (group & (group - 1)) {  // more than one lane: each member sums the group in lane order
    sum = 0.0f;
    for (unsigned m = group; m; m &= m - 1) sum += __shfl_sync(group, w, __ffs(m) - 1);
  }
  if (lane == __ffs(group) - 1 && sum != 0.0f) atomicAdd(base + at, sum);
}

// The lanes of the warp whose key equals this lane's: 32-bit keys when the
// launch's keys fit (keys32), else the offset type's.
template <typename Off>
__device__ __forceinline__ unsigned same_key(bool keys32, Off key) {
  return keys32 ? __match_any_sync(kFull, static_cast<int>(key)) : __match_any_sync(kFull, key);
}

template <typename Idx, typename Pl, typename Off>
__global__ void __launch_bounds__(kThreads) ingest_stacked_kernel(
    float* __restrict__ counters, float* __restrict__ row_flows, float* __restrict__ col_flows,
    const Pl* __restrict__ plane, const Idx* __restrict__ rows, const Idx* __restrict__ cols,
    const float* __restrict__ weights, Off n_planes, Off depth, Off wr, Off wc, Off batch, bool keys32) {
  const int lane = threadIdx.x & 31;
  const Off b = static_cast<Off>(blockIdx.x) * kThreads + threadIdx.x;
  // Slots past B take part in the warp's matches and add nothing.
  const bool in = b < batch;
  int64_t p = -1;
  float w = 0.0f;
  if (in) {
    p = static_cast<int64_t>(plane[b]);
    w = weights[b];
  }
  const bool live = p >= 0 && p < static_cast<int64_t>(n_planes) && w != 0.0f;
  const Off pl = live ? static_cast<Off>(p) : 0;
  const Off none = -1 - lane;  // a key no other lane holds
  for (Off i0 = 0; i0 < depth; i0 += kSketches) {
    int64_t r[kSketches];
    Off c[kSketches];
#pragma unroll
    for (int k = 0; k < kSketches; ++k) {
      r[k] = -1;
      c[k] = 0;
      if (in && i0 + k < depth) {
        r[k] = static_cast<int64_t>(rows[(i0 + k) * batch + b]);
        c[k] = static_cast<Off>(cols[(i0 + k) * batch + b]);
      }
    }
#pragma unroll
    for (int k = 0; k < kSketches; ++k) {
      if (i0 + k >= depth) break;  // warp-uniform
      const bool add = live && r[k] >= 0 && r[k] < static_cast<int64_t>(wr);
      // The sketch is the same for every lane, so (plane, row) and (plane,
      // column) key the registers; equal cells are equal in both.
      const unsigned row_group = same_key(keys32, add ? pl * wr + static_cast<Off>(r[k]) : none);
      const unsigned col_group = same_key(keys32, add ? pl * wc + c[k] : none);
      if (add) {
        const Off sketch = pl * depth + i0 + k;
        const Off row = sketch * wr + static_cast<Off>(r[k]);
        add_group(row_flows, row, w, row_group, lane);
        add_group(col_flows, sketch * wc + c[k], w, col_group, lane);
        add_group(counters, row * wc + c[k], w, row_group & col_group, lane);
      }
    }
  }
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
  const dim3 blocks(static_cast<unsigned>((r.batch + kThreads - 1) / kThreads));
  float* counters = r.counters;
  float* row_flows = r.row_flows;
  float* col_flows = r.col_flows;
  const Pl* plane = static_cast<const Pl*>(r.plane);
  const Idx* rows = static_cast<const Idx*>(r.rows);
  const Idx* cols = static_cast<const Idx*>(r.cols);
  const float* weights = r.weights;
  Off n = static_cast<Off>(r.n_planes), d = static_cast<Off>(r.depth);
  Off wr = static_cast<Off>(r.wr), wc = static_cast<Off>(r.wc), batch = static_cast<Off>(r.batch);
  // The register keys (plane * wr + row, plane * wc + column) fit 32 bits.
  bool keys32 = r.n_planes * (r.wr > r.wc ? r.wr : r.wc) < kFits32;
  void* args[] = {&counters, &row_flows, &col_flows, &plane, &rows, &cols, &weights, &n, &d, &wr, &wc, &batch,
                  &keys32};
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
  if ((r.index_bytes != 4 && r.index_bytes != 8) || (r.plane_bytes != 4 && r.plane_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = r.index_bytes == 8 ? by_plane<int64_t>(r) : by_plane<int32_t>(r);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
