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
// VMEM (MAX_FUSED_WC in its ops.py).  None of that carries over: this is a
// scatter with no product to take, so wgmma and TMA have nothing to do, and
// any width runs.
//
// Semantics: a slot whose row is -1 (padding) touches nothing, col_flows
// included.  A valid slot of weight 0 adds nothing (adding +0.0 is the
// identity on counters and registers, which never hold -0.0) but still
// marks its row: touched means "a valid slot hashed here".  In the counting
// regime (integer weights, per-cell and per-register mass < 2^24) sums in
// any order give bit-identical results; float weights agree to rounding.
//
// Bound on an H100 (3.35 TB/s): each distinct counter and register sector the
// weighted valid slots add into is read and written once (32 bytes each way;
// the registers are (d, wr) and (d, wc) floats, 160 KB each at BASE), the
// (d, wr) bitmap written once, the (d, B) rows and columns and the (B,)
// weights read once.  What holds the kernel is the count of L2 operations,
// not the bytes: every add and every mark is one request to the L2 slice
// owning its sector, and the registers and the bitmap are small, so their
// sectors take many requests each (PERF.md: dropping the byte-store marks
// alone took a third off a batch of uniform rows).  The design cuts requests per slot and
// keeps many independent ones in flight:
//   * grid (chunk of B, sketch i = blockIdx.y), so no slot divides by B; a
//     block covers kThreads * kRounds consecutive slots, each warp 32 *
//     kRounds of them, round k of a warp the 32 consecutive slots from
//     32 * k, one a lane (every load coalesced, at any alignment of B);
//   * a thread issues all kRounds of its row, column and weight loads before
//     its first atomic;
//   * each counter add is one RED (an atomicAdd whose result is unused) per
//     weighted valid slot: its cell is hashed, so no two slots share it but
//     by chance;
//   * row_flows and touched are aggregated over runs of equal rows among a
//     round's 32 slots: the fused session hands the kernel pairs sorted by
//     (src, dst), so the slots of one source are consecutive and share their
//     row in every sketch.  A segmented shuffle scan sums a run's weights into
//     its last lane, which issues one row_flows RED (none when the sum is 0)
//     and one mark for the whole run.  The pad_bucket padding (key 0, weight
//     0, thousands of slots at serve BASE) so becomes one mark a round
//     instead of one a slot.  A warp whose 32 rows all differ (an unsorted
//     batch) skips the scan;
//   * col_flows is aggregated over the lanes of a round that add into one
//     column (__match_any_sync): a hot destination recurs across the short
//     runs of the zipf tail, and one column address takes its adds one after
//     another in its L2 slice;
//   * a mark is a RED.OR of one bit into the bitmap's 32-bit word, not a
//     byte store (the ends of a bitmap that is not 4-byte aligned or sized
//     take byte stores).
//
// Flags (the record's last int): KEEP_TOUCHED ORs into the caller's bitmap
// (the second launch of an undirected sketch); without it the bitmap is
// zeroed first with cudaMemsetAsync on the same stream.
//
// Template axes: the index type, int32 or int64, as the caller's buckets
// come (no cast); the offset type, int32 when every cell offset and slot
// position fits (d*wr*wc and d*B below 2^31 - 1024), else int64.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 2;  // slots a thread
constexpr int kSlotsPerBlock = kThreads * kRounds;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kFits32 = (int64_t{1} << 31) - 1024;
constexpr int64_t kKeepTouched = 1;

// atomicOr with its result unused compiles to ATOM.E.OR, which returns the
// old word to the SM; red.global.or returns nothing.
__device__ __forceinline__ void red_or(unsigned* word, unsigned bits) {
  asm volatile("red.global.or.b32 [%0], %1;" ::"l"(word), "r"(bits) : "memory");
}

template <typename Idx, typename Off>
__global__ void __launch_bounds__(kThreads) fused_ingest_kernel(
    float* __restrict__ counters, float* __restrict__ row_flows,
    float* __restrict__ col_flows, uint8_t* __restrict__ touched,
    const Idx* __restrict__ rows, const Idx* __restrict__ cols,
    const float* __restrict__ weights, Off wr, Off wc, Off batch, Off marks_bytes) {
  const int lane = threadIdx.x & 31;
  const Off i = blockIdx.y;
  const Off first = static_cast<Off>(blockIdx.x) * kSlotsPerBlock +
                    (threadIdx.x >> 5) * (32 * kRounds) + lane;
  const Idx* row_in = rows + i * batch;
  const Idx* col_in = cols + i * batch;
  // Rows and columns are below 2^31 at any width, so a round's keys are ints;
  // slots past B are inert (-1) and take part in the warp's shuffles.
  int r[kRounds], c[kRounds];
  float w[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const Off b = first + 32 * k;
    r[k] = -1;
    c[k] = 0;
    w[k] = 0.0f;
    if (b < batch) {
      r[k] = static_cast<int>(__ldg(&row_in[b]));
      c[k] = static_cast<int>(__ldg(&col_in[b]));
      w[k] = __ldg(&weights[b]);
    }
  }
  float* cells = counters + i * wr * wc;
  float* rf = row_flows + i * wr;
  float* cf = col_flows + i * wc;
  uint8_t* marks = touched + i * wr;
  // The bitmap's whole 32-bit words: a mark inside them is a RED.OR of its
  // byte's bit 0, a mark outside them (the ends of a bitmap that is not
  // 4-byte aligned or sized) a byte store.
  const uintptr_t words_lo = (reinterpret_cast<uintptr_t>(touched) + 3) & ~uintptr_t{3};
  const uintptr_t words_hi = (reinterpret_cast<uintptr_t>(touched) + marks_bytes) & ~uintptr_t{3};
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane (all 32 at lane 31)
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int row = r[k] < 0 ? -1 : r[k];
    const bool valid = row >= 0;
    const bool add = valid && w[k] != 0.0f;
    if (add) atomicAdd(&cells[static_cast<Off>(row) * wc + c[k]], w[k]);
    // col_flows: the lanes adding into one column (a hot destination recurs
    // across the short runs of a round) sum into the lowest of them.
    const unsigned same = __match_any_sync(kFull, add ? c[k] : -1 - lane);
    if (add) {
      float csum = w[k];
      if (same & (same - 1)) {  // more than one lane: each member sums the group in lane order
        csum = 0.0f;
        for (unsigned m = same; m; m &= m - 1) csum += __shfl_sync(same, w[k], __ffs(m) - 1);
      }
      if (lane == __ffs(same) - 1) atomicAdd(&cf[c[k]], csum);
    }
    // Runs of equal rows among the round's 32 consecutive slots: heads
    // holds each run's first lane, so a run ends where the next begins.
    const int prev = __shfl_up_sync(kFull, row, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || row != prev);
    float sum = add ? w[k] : 0.0f;
    if (heads != kFull) {  // some run is longer than one slot (warp-uniform)
      const int start = 31 - __clz(heads & upto);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(kFull, sum, o);
        if (lane - o >= start) sum += t;
      }
    }
    const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (valid && last) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(marks + row);
      const uintptr_t word = at & ~uintptr_t{3};
      if (word >= words_lo && word < words_hi) {
        red_or(reinterpret_cast<unsigned*>(word), 1u << (8 * (at & 3)));
      } else {
        marks[row] = 1;
      }
      if (sum != 0.0f) atomicAdd(&rf[row], sum);
    }
  }
}

// One launch, as the wrapper packs it (kernels/ingest/ops.py RECORD,
// struct.Struct("=7Q7qQ")); csrc/ingest.cu reads the same layout.  The fused
// ingest reads no row_offset.
struct Record {
  float* counters;
  float* row_flows;
  float* col_flows;
  uint8_t* touched;  // (depth, wr) bytes, 0 or 1
  const void* rows;  // (depth, batch) contiguous, int32 or int64
  const void* cols;
  const float* weights;  // (batch,)
  int64_t depth, wr, wc, batch, row_offset, index_bytes, flags;
  cudaStream_t stream;
};
static_assert(sizeof(Record) == 120, "the record is fifteen 8-byte fields");

template <typename Idx, typename Off>
cudaError_t launch(const Record& r) {
  const dim3 blocks(static_cast<unsigned>((r.batch + kSlotsPerBlock - 1) / kSlotsPerBlock),
                    static_cast<unsigned>(r.depth));
  float* counters = r.counters;
  float* row_flows = r.row_flows;
  float* col_flows = r.col_flows;
  uint8_t* touched = r.touched;
  const Idx* rows = static_cast<const Idx*>(r.rows);
  const Idx* cols = static_cast<const Idx*>(r.cols);
  const float* weights = r.weights;
  Off wr = static_cast<Off>(r.wr), wc = static_cast<Off>(r.wc), batch = static_cast<Off>(r.batch);
  Off marks_bytes = static_cast<Off>(r.depth * r.wr);
  void* args[] = {&counters, &row_flows, &col_flows, &touched, &rows, &cols, &weights, &wr, &wc, &batch, &marks_bytes};
  return cudaLaunchKernel(reinterpret_cast<const void*>(fused_ingest_kernel<Idx, Off>),
                          blocks, dim3(kThreads), args, 0, r.stream);
}

template <typename Idx>
cudaError_t by_offset(const Record& r) {
  if (r.depth * r.wr * r.wc < kFits32 && r.depth * r.batch < kFits32) {
    return launch<Idx, int32_t>(r);
  }
  return launch<Idx, int64_t>(r);
}

cudaError_t run(const Record& r) {
  if ((r.index_bytes != 4 && r.index_bytes != 8) || r.depth > 65535) return cudaErrorInvalidValue;
  if (!(r.flags & kKeepTouched) && r.depth * r.wr > 0) {
    const cudaError_t err = cudaMemsetAsync(r.touched, 0, static_cast<size_t>(r.depth * r.wr), r.stream);
    if (err != cudaSuccess) return err;
  }
  if (r.batch == 0 || r.depth == 0) return cudaSuccess;
  return r.index_bytes == 8 ? by_offset<int64_t>(r) : by_offset<int32_t>(r);
}

}  // namespace

// record: a packed Record (see above).  Returns the first cudaError_t of the
// bitmap's zeroing and the launch; on an error the sticky last error is
// cleared, so no later check reports it.
extern "C" int glava_fused_ingest(const char* record) {
  Record r;
  memcpy(&r, record, sizeof(Record));
  const cudaError_t err = run(r);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
