// Sketch ingest scatter, one kernel body with two entries:
//   counters[i, r_i(b) - row_offset, c_i(b)] += w[b]
// for every sketch i and slot b of a batch of B slots.
//
// Replaces the TPU kernel src/repro/kernels/ingest/kernel.py::ingest_pallas
// (body _ingest_kernel).  The TPU version re-expressed the scatter as one-hot
// matmuls on the MXU, tiled over (row tile x col tile x edge chunk); none of
// that carries over.  The entries:
// - glava_ingest_scatter, the Pallas kernel's interface: r_i(b) = rows[i, b]
//   and c_i(b) = cols[i, b], hashed before, (d, B) int32 or int64.
// - glava_ingest_keys: the slot's uint32 keys src[b] and dst[b] (int64
//   tensors), hashed here by the row and the column family,
//   h(x) = ((a (x mod p) mod p) + b) mod p mod w with p = 2^31 - 1, exactly
//   core/hashing.py::affine_hash: r_i = row_i(src), c_i = col_i(dst).  With
//   `mirror` (an undirected sketch) the same launch also adds the mirrored
//   edge, (row_i(dst), col_i(src)).  It replaces the hash of the serve path's
//   pre-aggregated batch: two family calls of six elementwise int64 kernels
//   each a direction, and the (d, B) buckets they wrote for this kernel
//   alone to read back.
// - glava_ingest_floor measures; no path calls it: n REDs at random 32-byte
//   sectors, addresses hashed in registers, no index loads.  It is the floor
//   chip_smoke.py and tools/ablate_ingest.py hold B1 against.
//
// Semantics: rows outside [row_offset, row_offset + wr_local) (-1 is
// padding, or another shard's rows) contribute nothing.  Slots of weight 0
// are skipped: adding +0.0 is the identity on counters, which never hold
// -0.0.  In the counting regime (integer weights, per-cell mass < 2^24)
// atomics in any order give bit-identical counters; float weights agree to
// rounding.
//
// Design: one thread takes one slot for all d sketches.  It loads the weight
// and the keys (or its buckets, 8 sketches' at a time) together, coalesced
// along b, and only then tests the weight: a slot of weight 0 hashes nothing
// and adds nothing.  Then, sketch by sketch, it hashes in registers (32-bit
// Mersenne folds) and issues that sketch's RED (atomicAdd with the result
// unused; two when mirrored) at once, so the adds stream while the later
// sketches hash; the bucket entry holds its chunk's buckets before its first
// add.  No load lies between the REDs.  The earlier design gave a thread one
// (slot, sketch) pair on a (chunk of B, d) grid, each behind a chain of
// dependent loads (row, test, weight, column).
//
// Bound on an H100 (3.35 TB/s): each add reads and writes one 32-byte sector
// of counters, 64 bytes an add; the inputs are read once (keys: B x 20 bytes;
// buckets: d x B x 2 x 4 or 8 bytes, and 4 B of weights).  The serve path's
// batch meets counters of 1.34 GB that the L2 (50 MB) does not hold, so its
// adds miss L2 on random sectors, which HBM serves at about half its
// streaming rate: on serve BASE's first batch (126,395 adds) the random-
// sector floor (glava_ingest_floor, the same REDs with no index loads)
// reads about twice the DRAM bound after a clean L2 fill and four times it
// after a dirty one, whose lines each miss also writes back
// (tools/ablate_ingest.py).  Both entries run at that floor cold.  Tried and
// left out: 64 or 128 threads a block, one thread a (slot, sketch) (no
// faster), persistent grids and prefetch.global.L2 of the cells before the
// REDs (slower), and L2 eviction hints on the REDs: evict_last was faster
// only after the dirty fill, slower mirrored after the clean one, and would
// keep counter lines in L2 against the serve path's other kernels.
//
// Template axes: the index type of the bucket entry, int32 or int64, as the
// caller's buckets come (no cast); the offset type, int32 when every cell
// offset and slot position fits (d*wr*wc and d*B below 2^31 - 1024), else
// int64.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;   // sketches a thread takes at a time (d <= 8: all of them)
constexpr int kInline = 8;  // rows of a family whose coefficients come by value
constexpr uint32_t kP = 0x7fffffffu;  // p = 2^31 - 1
constexpr int64_t kFits32 = (int64_t{1} << 31) - 1024;

// x mod p for any 32-bit x: 2^31 = 1 (mod p).
__host__ __device__ __forceinline__ uint32_t mod_p(uint32_t x) {
  x = (x & kP) + (x >> 31);  // <= p + 1
  return x >= kP ? x - kP : x;
}

// ((a k mod p) + b) mod p for a, k, b < p, in 32-bit steps: the product
// a k < 2^62 folds to (x & p) + (x >> 31) <= 2^32 - 2, that to at most p.
__device__ __forceinline__ uint32_t affine_mod_p(uint32_t a, uint32_t k, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * k;
  const uint32_t lo = static_cast<uint32_t>(x);
  uint32_t t = (lo & kP) + __funnelshift_l(lo, static_cast<uint32_t>(x >> 32), 1);
  t = (t & kP) + (t >> 31);  // <= p, and p stands for 0
  t += b;                    // < 2p
  return t >= kP ? t - kP : t;
}

// One add whose result is unused: a RED.
__device__ __forceinline__ void red_add(float* p, float w) { atomicAdd(p, w); }

// An affine hash family onto [0, width): the coefficients of its first
// kInline rows by value, reduced mod p (the bucket is the same), every row's
// on the device (read past kInline), and the width with its Lemire constant
// floor((2^64 - 1) / width) + 1, so that u mod width is two multiplies (a
// mask for a power of two).
struct Family {
  uint32_t a[kInline];
  uint32_t b[kInline];
  const int64_t* a_dev;
  const int64_t* b_dev;
  uint64_t lemire;
  uint32_t width;
  bool pow2;

  // Row i's bucket of a key already reduced mod p.
  __device__ __forceinline__ uint32_t operator()(int64_t i, uint32_t k) const {
    uint32_t ai, bi;
    if (i < kInline) {
      ai = a[i];
      bi = b[i];
    } else {
      ai = mod_p(static_cast<uint32_t>(a_dev[i]));
      bi = mod_p(static_cast<uint32_t>(b_dev[i]));
    }
    const uint32_t u = affine_mod_p(ai, k, bi);
    return pow2 ? u & (width - 1) : static_cast<uint32_t>(__umul64hi(lemire * u, width));
  }
};

// The bucket entry's slots: (d, B) buckets hashed before, a chunk of
// sketches' loaded at a time, all before the chunk's first add.
template <typename Idx>
struct Buckets {
  static constexpr int kTargets = 1;
  const Idx* rows;
  const Idx* cols;

  struct Slot {};
  struct Chunk {
    Idx r[kChunk], c[kChunk];
  };
  template <typename Off>
  __device__ __forceinline__ Slot slot(Off) const { return {}; }

  template <typename Off>
  __device__ __forceinline__ Chunk chunk(Slot, Off i0, Off depth, Off b, Off batch) const {
    Chunk ch;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (i0 + k < depth) {
        ch.r[k] = rows[(i0 + k) * batch + b];
        ch.c[k] = cols[(i0 + k) * batch + b];
      }
    }
    return ch;
  }

  // The k-th sketch of the chunk, sketch i: its (row, column); returns the
  // number of targets.
  template <typename Off>
  __device__ __forceinline__ int targets(const Chunk& ch, int k, Off, int64_t* r, Off* c) const {
    r[0] = static_cast<int64_t>(ch.r[k]);
    c[0] = static_cast<Off>(ch.c[k]);
    return 1;
  }
};

// The key entry's slots: the (src, dst) keys, hashed here sketch by sketch;
// two targets a sketch when mirrored.
struct Keys {
  static constexpr int kTargets = 2;
  const int64_t* src;
  const int64_t* dst;
  Family row, col;
  bool mirror;

  struct Slot {
    uint32_t s, d;
  };
  using Chunk = Slot;  // the keys mod p

  // Keys are uint32 values: the low 32 bits are the key.
  template <typename Off>
  __device__ __forceinline__ Slot slot(Off b) const {
    return {static_cast<uint32_t>(src[b]), static_cast<uint32_t>(dst[b])};
  }

  template <typename Off>
  __device__ __forceinline__ Chunk chunk(Slot keys, Off, Off, Off, Off) const {
    return {mod_p(keys.s), mod_p(keys.d)};
  }

  template <typename Off>
  __device__ __forceinline__ int targets(const Chunk& k, int, Off i, int64_t* r, Off* c) const {
    r[0] = row(i, k.s);
    c[0] = static_cast<Off>(col(i, k.d));
    if (!mirror) return 1;
    r[1] = row(i, k.d);
    c[1] = static_cast<Off>(col(i, k.s));
    return 2;
  }
};

template <typename Src, typename Off>
__global__ void __launch_bounds__(kThreads) ingest_kernel(
    float* __restrict__ counters, const __grid_constant__ Src src, const float* __restrict__ weights,
    Off depth, Off wr_local, Off wc, Off batch, int64_t row_offset) {
  const Off stride = static_cast<Off>(gridDim.x) * kThreads;
  for (Off b = static_cast<Off>(blockIdx.x) * kThreads + threadIdx.x; b < batch; b += stride) {
    const float w = weights[b];
    const auto slot = src.slot(b);  // the keys, loaded beside the weight
    for (Off i0 = 0; i0 < depth; i0 += kChunk) {
      // The buckets, loaded before the weight is tested (the first chunk's
      // beside it).
      const auto ch = src.chunk(slot, i0, depth, b, batch);
      if (w == 0.0f) break;  // adds nothing: no hash, no RED
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const Off i = i0 + k;
        if (i >= depth) break;
        int64_t r[Src::kTargets];
        Off c[Src::kTargets];
        const int n = src.targets(ch, k, i, r, c);
#pragma unroll
        for (int t = 0; t < Src::kTargets; ++t) {
          if (t >= n) break;
          // -1 and another shard's rows fall outside [row_offset, row_offset + wr_local).
          const int64_t local = r[t] - row_offset;
          if (local >= 0 && local < static_cast<int64_t>(wr_local)) {
            red_add(counters + (i * wr_local + static_cast<Off>(local)) * wc + c[t], w);
          }
        }
      }
    }
  }
}

// The launch's geometry: one slot a thread.
int64_t blocks_for(int64_t batch) { return (batch + kThreads - 1) / kThreads; }

template <typename Src, typename Off>
cudaError_t launch(float* counters, const Src& src, const float* weights, int64_t depth, int64_t wr, int64_t wc,
                   int64_t batch, int64_t row_offset, cudaStream_t stream) {
  Src s = src;
  Off d = static_cast<Off>(depth), w_r = static_cast<Off>(wr), w_c = static_cast<Off>(wc);
  Off b = static_cast<Off>(batch);
  void* args[] = {&counters, &s, &weights, &d, &w_r, &w_c, &b, &row_offset};
  return cudaLaunchKernel(reinterpret_cast<const void*>(ingest_kernel<Src, Off>),
                          dim3(static_cast<unsigned>(blocks_for(batch))), dim3(kThreads), args, 0, stream);
}

template <typename Src>
cudaError_t by_offset(float* counters, const Src& src, const float* weights, int64_t depth, int64_t wr,
                      int64_t wc, int64_t batch, int64_t row_offset, cudaStream_t stream) {
  if (depth * wr * wc < kFits32 && depth * batch < kFits32) {
    return launch<Src, int32_t>(counters, src, weights, depth, wr, wc, batch, row_offset, stream);
  }
  return launch<Src, int64_t>(counters, src, weights, depth, wr, wc, batch, row_offset, stream);
}

// The bucket entry's launch, as the wrapper packs it (kernels/ingest/ops.py
// RECORD, struct.Struct("=7Q7qQ")); csrc/ingest_fused.cu reads the same
// layout.  The scatter reads neither register nor the bitmap, nor the flags.
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

// The key entry's launch (kernels/ingest/ops.py KEY_RECORD,
// struct.Struct("=8Q7qQ")), followed by depth x (row a, row b, column a,
// column b) as int64.
struct KeyRecord {
  float* counters;      // (depth, wr, wc) contiguous
  const int64_t* src;   // (batch,) uint32 values
  const int64_t* dst;
  const float* weights;  // (batch,)
  const int64_t* row_a;  // (depth,) coefficients on the device
  const int64_t* row_b;
  const int64_t* col_a;
  const int64_t* col_b;
  int64_t depth, wr, wc, batch, row_offset, row_width, mirror;
  cudaStream_t stream;
};
static_assert(sizeof(KeyRecord) == 128, "the key record is sixteen 8-byte fields");

Family make_family(const int64_t* coef, int64_t depth, int64_t width, const int64_t* a_dev,
                   const int64_t* b_dev) {
  Family f{};
  for (int i = 0; i < kInline && i < depth; ++i) {
    f.a[i] = mod_p(static_cast<uint32_t>(coef[4 * i]));
    f.b[i] = mod_p(static_cast<uint32_t>(coef[4 * i + 1]));
  }
  f.a_dev = a_dev;
  f.b_dev = b_dev;
  f.width = static_cast<uint32_t>(width);
  f.lemire = ~uint64_t{0} / static_cast<uint64_t>(width) + 1;
  f.pow2 = (width & (width - 1)) == 0;
  return f;
}

// The floor's launch (chip_smoke.py FLOOR_RECORD, struct.Struct("=Q4qQ")).
struct FloorRecord {
  float* buffer;
  int64_t n_sectors, n_adds, per_thread, seed;
  cudaStream_t stream;
};

template <int kPer>
__global__ void __launch_bounds__(kThreads) floor_kernel(float* __restrict__ buffer, uint64_t n_sectors,
                                                         int64_t n_adds, uint64_t seed) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t j = t * kPer + k;
    if (j >= n_adds) return;
    uint64_t x = (static_cast<uint64_t>(j) + seed) * 0x9E3779B97F4A7C15ull;
    x ^= x >> 32;
    x *= 0xD6E8FEB86659FD93ull;
    x ^= x >> 32;
    red_add(buffer + __umul64hi(x, n_sectors) * 8, 1.0f);
  }
}

template <int kPer>
cudaError_t launch_floor(const FloorRecord& r) {
  const int64_t threads = (r.n_adds + kPer - 1) / kPer;
  floor_kernel<kPer><<<static_cast<unsigned>(blocks_for(threads)), kThreads, 0, r.stream>>>(
      r.buffer, static_cast<uint64_t>(r.n_sectors), r.n_adds, static_cast<uint64_t>(r.seed));
  return cudaGetLastError();
}

}  // namespace

// record: a packed Record (see above).  Returns the launch's cudaError_t; on
// an error the sticky last error is cleared, so no later check reports it.
extern "C" int glava_ingest_scatter(const char* record) {
  Record r;
  memcpy(&r, record, sizeof(Record));
  if (r.batch == 0 || r.depth == 0) return 0;
  if (r.index_bytes != 4 && r.index_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      r.index_bytes == 8
          ? by_offset(r.counters, Buckets<int64_t>{static_cast<const int64_t*>(r.rows),
                                                   static_cast<const int64_t*>(r.cols)},
                      r.weights, r.depth, r.wr, r.wc, r.batch, r.row_offset, r.stream)
          : by_offset(r.counters, Buckets<int32_t>{static_cast<const int32_t*>(r.rows),
                                                   static_cast<const int32_t*>(r.cols)},
                      r.weights, r.depth, r.wr, r.wc, r.batch, r.row_offset, r.stream);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// record: a packed KeyRecord and its coefficients (see above).  Returns as
// glava_ingest_scatter.
extern "C" int glava_ingest_keys(const char* record) {
  KeyRecord r;
  memcpy(&r, record, sizeof(KeyRecord));
  if (r.batch == 0 || r.depth == 0) return 0;
  if (r.row_width < 1 || r.wc < 1 || r.row_width > 0xffffffffll || r.wc > 0xffffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* coef = reinterpret_cast<const int64_t*>(record + sizeof(KeyRecord));
  Keys keys;
  keys.src = r.src;
  keys.dst = r.dst;
  keys.row = make_family(coef, r.depth, r.row_width, r.row_a, r.row_b);
  keys.col = make_family(coef + 2, r.depth, r.wc, r.col_a, r.col_b);
  keys.mirror = r.mirror != 0;
  const cudaError_t err = by_offset(r.counters, keys, r.weights, r.depth, r.wr, r.wc, r.batch, r.row_offset, r.stream);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// record: a packed FloorRecord.  per_thread is 1, 5 or 10 REDs a thread.
extern "C" int glava_ingest_floor(const char* record) {
  FloorRecord r;
  memcpy(&r, record, sizeof(FloorRecord));
  if (r.n_adds <= 0) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (r.per_thread == 1) err = launch_floor<1>(r);
  if (r.per_thread == 5) err = launch_floor<5>(r);
  if (r.per_thread == 10) err = launch_floor<10>(r);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
