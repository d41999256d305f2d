// Sketch ingest scatter: counters[i, rows[i,b] - row_offset, cols[i,b]] += w[b].
//
// Replaces the TPU kernel src/repro/kernels/ingest/kernel.py::ingest_pallas
// (body _ingest_kernel).  The TPU version re-expressed the scatter as one-hot
// matmuls on the MXU, tiled over (row tile x col tile x edge chunk); none of
// that carries over.  Here one thread owns one (i, b) slot of the hashed
// batch and folds its weight in with one float atomicAdd (a RED: its result
// is unused).  The grid is (chunk of B, sketch i), so no slot divides by B.
//
// Semantics: rows of -1 (padding, or another shard's rows) and rows outside
// [row_offset, row_offset + wr_local) contribute nothing.  Slots of weight 0
// are skipped: adding +0.0 is the identity on counters, which never hold -0.0.
// In the counting regime (integer weights, per-cell mass < 2^24) atomics in
// any order give bit-identical counters; float weights agree to rounding.
//
// Bound on an H100 (3.35 TB/s): the scatter touches d*B random cells, each a
// 32-byte sector read and written, plus the (d, B) row and column reads and
// the (B,) weight read.  At d=5, B=50,000 with int32 buckets that is about
// 18 MB, some 5 us; the atomics' throughput in L2 is the practical limit,
// not the FLOPs (none).
//
// Template axes: the index type, int32 or int64, as the caller's buckets
// come (no cast); the offset type, int32 when every cell offset and slot
// position fits (d*wr*wc and d*B below 2^31 - 1024), else int64.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kFits32 = (int64_t{1} << 31) - 1024;

template <typename Idx, typename Off>
__global__ void __launch_bounds__(kThreads) ingest_scatter_kernel(
    float* __restrict__ counters, const Idx* __restrict__ rows,
    const Idx* __restrict__ cols, const float* __restrict__ weights,
    Off wr_local, Off wc, Off batch, int64_t row_offset) {
  const Off b = static_cast<Off>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= batch) return;
  const Off i = blockIdx.y;
  const Off s = i * batch + b;
  const int64_t raw = static_cast<int64_t>(rows[s]);
  // -1 and another shard's rows fall outside [row_offset, row_offset + wr_local).
  if (raw < row_offset || raw >= row_offset + static_cast<int64_t>(wr_local)) return;
  const Off r = static_cast<Off>(raw - row_offset);
  const float w = weights[b];
  if (w == 0.0f) return;
  atomicAdd(&counters[(i * wr_local + r) * wc + static_cast<Off>(cols[s])], w);
}

// One launch, as the wrapper packs it (kernels/ingest/ops.py RECORD,
// struct.Struct("=7Q7qQ")); csrc/ingest_fused.cu reads the same layout.  The
// scatter reads neither register nor the bitmap, nor the flags.
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

template <typename Idx, typename Off>
cudaError_t launch(const Record& r) {
  const dim3 blocks(static_cast<unsigned>((r.batch + kThreads - 1) / kThreads),
                    static_cast<unsigned>(r.depth));
  float* counters = r.counters;
  const Idx* rows = static_cast<const Idx*>(r.rows);
  const Idx* cols = static_cast<const Idx*>(r.cols);
  const float* weights = r.weights;
  Off wr = static_cast<Off>(r.wr), wc = static_cast<Off>(r.wc), batch = static_cast<Off>(r.batch);
  int64_t row_offset = r.row_offset;
  void* args[] = {&counters, &rows, &cols, &weights, &wr, &wc, &batch, &row_offset};
  return cudaLaunchKernel(reinterpret_cast<const void*>(ingest_scatter_kernel<Idx, Off>),
                          blocks, dim3(kThreads), args, 0, r.stream);
}

template <typename Idx>
cudaError_t by_offset(const Record& r) {
  if (r.depth * r.wr * r.wc < kFits32 && r.depth * r.batch < kFits32) {
    return launch<Idx, int32_t>(r);
  }
  return launch<Idx, int64_t>(r);
}

}  // namespace

// record: a packed Record (see above).  Returns the launch's cudaError_t; on
// an error the sticky last error is cleared, so no later check reports it.
extern "C" int glava_ingest_scatter(const char* record) {
  Record r;
  memcpy(&r, record, sizeof(Record));
  if (r.batch == 0 || r.depth == 0) return 0;
  if ((r.index_bytes != 4 && r.index_bytes != 8) || r.depth > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = r.index_bytes == 8 ? by_offset<int64_t>(r) : by_offset<int32_t>(r);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
