// Batch collapse on the card: one session batch of B raw edges (src, dst; w)
// folded into its distinct (src, dst) pairs, the per-source and
// per-destination totals added straight into the flow registers, and the
// row buckets the batch writes marked in a (d, w_r) bitmap:
//   pairs:      one slot per distinct (src, dst), its summed weight
//   row_flows[i, row_i(s)] += total(s)     for every distinct source s
//   col_flows[i, col_i(t)] += total(t)     for every distinct destination t
//   touched[i, row_i(s)] = 1
// and for an undirected sketch the mirrored roles too (row_i(t) and col_i(s)
// take the destination's and the source's totals; the destinations' rows are
// marked).  B1's key entry (csrc/ingest.cu) then folds the pairs into the
// counters.
//
// A port-only kernel: the reference has no Pallas kernel here.  It replaces
// the session's host collapse, core/ingest.py::preaggregate_host (two stable
// argsorts and np.add.reduceat on the host, then seven padded arrays copied
// to the card and 22 small register ops, GLavaSketch.update_marginals_), for
// a local session whose summary is on the card.  The host's 8.5 ms a
// 50,000-edge batch left the card idle; here the host copies the raw batch
// once and launches twice.
//
// Semantics: the pair sums and the totals are exact for integer weights
// (sums below 2^24), in whatever order the atomics land; float weights agree
// to rounding.  Every distinct source is marked, whatever its total (the
// host path's touched set is the batch's distinct sources).  A total of 0
// adds nothing to a register (registers never hold -0.0).  Pairs whose sum
// is 0 go out with weight 0, which B1 skips.
//
// Design: three open-addressing tables (pairs by their 64-bit key, sources
// and destinations by their 32-bit key), each of cap = 2 * bucket_size(B)
// slots with linear probing, so the load factor stays at most 0.5 and no
// insert can overflow: no check, no host sync.  Every key value is a valid
// label, so the empty marker (all ones) is also a key: that one key value
// has a slot of its own beside each table, with a seen flag.
// - glava_preagg_collapse, launch 1, one thread an edge: within the warp,
//   lanes of equal key (__match_any_sync) are summed in lane order, and the
//   group's lowest lane inserts (an atomicCAS claims an empty slot, probes
//   read through L2) and adds by RED.  The zipf stream's hot sources and
//   pairs recur within a warp.  The same launch zeroes the pair weights,
//   the bitmap and the emit's counter.
// - launch 2, one thread a table slot (grid (slots, 3 tables)): an occupied
//   pair slot is compacted into the pair arrays by a warp-aggregated
//   counter (order does not matter to B1); an occupied node slot hashes its
//   key by the d rows of both families in registers (the key entry's
//   arithmetic) and REDs its total into the registers, and sets the
//   bitmap's bytes.  Each slot resets itself to empty as it is read, so the
//   next batch needs no fill.
//
// Bound on an H100 (3.35 TB/s): the batch read once (12 bytes an edge); the
// pair arrays written (20 bytes a slot of bucket_size(B)); the tables read
// and reset once (28 bytes a slot of cap: an 8-byte pair key, two 4-byte
// node keys, three 4-byte sums); a 32-byte sector read and written per
// register add (d a distinct source or destination, twice mirrored); the
// bitmap written once.  The tables (3.7 MB at B = 50,000) stay in L2.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kInline = 8;  // rows of a family whose coefficients come by value
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kP = 0x7fffffffu;  // p = 2^31 - 1

// The affine hash of csrc/ingest.cu (core/hashing.py::affine_hash):
// h(x) = ((a (x mod p) mod p) + b) mod p mod width.

// x mod p for any 32-bit x: 2^31 = 1 (mod p).
__host__ __device__ __forceinline__ uint32_t mod_p(uint32_t x) {
  x = (x & kP) + (x >> 31);
  return x >= kP ? x - kP : x;
}

// ((a k mod p) + b) mod p for a, k, b < p, in 32-bit steps.
__device__ __forceinline__ uint32_t affine_mod_p(uint32_t a, uint32_t k, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * k;
  const uint32_t lo = static_cast<uint32_t>(x);
  uint32_t t = (lo & kP) + __funnelshift_l(lo, static_cast<uint32_t>(x >> 32), 1);
  t = (t & kP) + (t >> 31);
  t += b;
  return t >= kP ? t - kP : t;
}

// An affine family onto [0, width): the first kInline rows' coefficients by
// value, every row's on the device, the width's Lemire constant.
struct Family {
  uint32_t a[kInline];
  uint32_t b[kInline];
  const int64_t* a_dev;
  const int64_t* b_dev;
  uint64_t lemire;
  uint32_t width;
  bool pow2;

  // Row i's bucket of a key already reduced mod p.
  __device__ __forceinline__ uint32_t operator()(int i, uint32_t k) const {
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

// The tables of one batch: the first cap slots of each (cap a power of two).
struct Tables {
  u64* pair_keys;       // (cap,)
  uint32_t* src_keys;   // (cap,)
  uint32_t* dst_keys;   // (cap,)
  float* pair_sums;     // (cap,)
  float* src_sums;
  float* dst_sums;
  float* marker_sums;   // (3,): the all-ones key's sums (pairs, sources, destinations)
  int32_t* counts;      // (4,): the all-ones key's seen flags, then the emit's pair count
  uint32_t mask;        // cap - 1
};

// splitmix64's finalizer: a table slot for any key.
__device__ __forceinline__ uint32_t home(u64 x, uint32_t mask) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return static_cast<uint32_t>(x) & mask;
}

// Adds w into key's slot, claiming an empty slot on first sight.  The all-ones
// key, which is also the empty marker, takes the marker slot.  A probe read
// may be stale only as "empty" (a slot goes from empty to its key once in a
// launch), and the atomicCAS then gives the slot's key.
template <typename K>
__device__ __forceinline__ void insert(K* keys, float* sums, uint32_t mask, K key, float w, float* marker_sum,
                                       int32_t* marker_seen) {
  constexpr K kEmpty = ~K{0};
  if (key == kEmpty) {
    *marker_seen = 1;
    atomicAdd(marker_sum, w);
    return;
  }
  uint32_t j = home(static_cast<u64>(key), mask);
  while (true) {
    K cur = __ldcg(keys + j);
    if (cur == kEmpty) {
      cur = atomicCAS(keys + j, kEmpty, key);
      if (cur == kEmpty) break;
    }
    if (cur == key) break;
    j = (j + 1) & mask;
  }
  atomicAdd(sums + j, w);
}

// The lanes of `live` holding this lane's key sum their weights in lane
// order; the group's lowest lane inserts the sum.  Every lane of the warp
// calls it (the match takes the whole warp).
template <typename K>
__device__ __forceinline__ void insert_grouped(K* keys, float* sums, uint32_t mask, K key, float w, bool live,
                                               unsigned lives, int lane, float* marker_sum, int32_t* marker_seen) {
  const unsigned group = __match_any_sync(kFull, key) & lives;
  if (!live) return;
  float sum = w;
  if (group & (group - 1)) {
    sum = 0.0f;
    for (unsigned m = group; m; m &= m - 1) sum += __shfl_sync(group, w, __ffs(m) - 1);
  }
  if (lane == __ffs(group) - 1) insert(keys, sums, mask, key, sum, marker_sum, marker_seen);
}

__global__ void __launch_bounds__(kThreads) preagg_collapse_kernel(
    const uint32_t* __restrict__ batch, int64_t n, Tables t, float* __restrict__ out_w, int64_t n_out,
    uint8_t* __restrict__ touched, int64_t n_touched) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // The previous batch's B1 has read the pair arrays (same stream).
  if (tid == 0) t.counts[3] = 0;
  for (int64_t k = tid; k < n_out; k += stride) out_w[k] = 0.0f;
  if (touched != nullptr) {
    for (int64_t k = tid; k < n_touched; k += stride) touched[k] = 0;
  }
  const int lane = threadIdx.x & 31;
  const bool live = tid < n;
  uint32_t s = 0, d = 0;
  float w = 0.0f;
  if (live) {
    s = batch[tid];
    d = batch[n + tid];
    w = __uint_as_float(batch[2 * n + tid]);
  }
  const unsigned lives = __ballot_sync(kFull, live);
  if (lives == 0) return;  // warp-uniform
  insert_grouped<u64>(t.pair_keys, t.pair_sums, t.mask, (static_cast<u64>(s) << 32) | d, w, live, lives, lane,
                      t.marker_sums, t.counts);
  insert_grouped<uint32_t>(t.src_keys, t.src_sums, t.mask, s, w, live, lives, lane, t.marker_sums + 1,
                           t.counts + 1);
  insert_grouped<uint32_t>(t.dst_keys, t.dst_sums, t.mask, d, w, live, lives, lane, t.marker_sums + 2,
                           t.counts + 2);
}

// Reads slot j of a table (j == cap: the marker slot) and resets it; returns
// whether it held a key.
template <typename K>
__device__ __forceinline__ bool take(K* keys, float* sums, uint32_t cap, int64_t j, float* marker_sum,
                                     int32_t* marker_seen, K* key, float* sum) {
  if (j < cap) {
    *key = keys[j];
    if (*key == ~K{0}) return false;
    *sum = sums[j];
    keys[j] = ~K{0};
    sums[j] = 0.0f;
    return true;
  }
  if (j > cap || *marker_seen == 0) return false;
  *key = ~K{0};
  *sum = *marker_sum;
  *marker_seen = 0;
  *marker_sum = 0.0f;
  return true;
}

__global__ void __launch_bounds__(kThreads) preagg_emit_kernel(
    Tables t, int64_t* __restrict__ out_src, int64_t* __restrict__ out_dst, float* __restrict__ out_w,
    float* __restrict__ row_flows, float* __restrict__ col_flows, uint8_t* __restrict__ touched,
    const __grid_constant__ Family row, const __grid_constant__ Family col, int depth, int64_t wr, int64_t wc,
    bool mirror) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const uint32_t cap = t.mask + 1;
  if (blockIdx.y == 0) {  // the pairs: compacted by a warp-aggregated counter
    u64 key = 0;
    float sum = 0.0f;
    const bool has = take(t.pair_keys, t.pair_sums, cap, j, t.marker_sums, t.counts, &key, &sum);
    const unsigned hits = __ballot_sync(kFull, has);
    if (hits == 0) return;  // warp-uniform
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(hits) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(t.counts + 3, __popc(hits));
    base = __shfl_sync(kFull, base, leader);
    if (has) {
      const int at = base + __popc(hits & ((1u << lane) - 1));
      out_src[at] = static_cast<int64_t>(key >> 32);
      out_dst[at] = static_cast<int64_t>(key & 0xffffffffull);
      out_w[at] = sum;
    }
    return;
  }
  // A source (y = 1) adds into the rows and marks them; a destination (y =
  // 2) into the columns; mirrored, each takes the other role too.
  const bool source = blockIdx.y == 1;
  uint32_t key = 0;
  float sum = 0.0f;
  const bool has = source ? take(t.src_keys, t.src_sums, cap, j, t.marker_sums + 1, t.counts + 1, &key, &sum)
                          : take(t.dst_keys, t.dst_sums, cap, j, t.marker_sums + 2, t.counts + 2, &key, &sum);
  if (!has) return;
  const uint32_t k = mod_p(key);
  const bool as_row = source || mirror, as_col = !source || mirror;
  for (int i = 0; i < depth; ++i) {
    if (as_row) {
      const int64_t r = i * wr + row(i, k);
      if (sum != 0.0f) atomicAdd(row_flows + r, sum);
      if (touched != nullptr) touched[r] = 1;
    }
    if (as_col) {
      const int64_t c = i * wc + col(i, k);
      if (sum != 0.0f) atomicAdd(col_flows + c, sum);
    }
  }
}

// One batch, as kernels/preagg/ops.py packs it (RECORD,
// struct.Struct("=16Q8qQ")), followed by depth x (row a, row b, column a,
// column b) as int64, the key entry's coefficient tail.
struct Record {
  const uint32_t* batch;  // (3, n): src, dst, the weights' float32 bits
  u64* pair_keys;         // (stride,)
  uint32_t* node_keys;    // (2, stride): sources, then destinations
  float* sums;            // (3, stride): pairs, sources, destinations
  float* marker_sums;     // (3,)
  int32_t* counts;        // (4,)
  int64_t* out_src;       // (n_out,)
  int64_t* out_dst;
  float* out_w;
  float* row_flows;       // (depth, wr)
  float* col_flows;       // (depth, wc)
  uint8_t* touched;       // (depth, wr) or null
  const int64_t* row_a;   // (depth,) coefficients on the device
  const int64_t* row_b;
  const int64_t* col_a;
  const int64_t* col_b;
  int64_t depth, wr, wc, n, cap, stride, n_out, mirror;
  cudaStream_t stream;
};
static_assert(sizeof(Record) == 200, "the record is twenty-five 8-byte fields");

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

}  // namespace

// record: a packed Record and its coefficients (see above).  Launches the
// collapse and the emit on the record's stream.  Returns the first launch
// error's cudaError_t; on an error the sticky last error is cleared, so no
// later check reports it.
extern "C" int glava_preagg(const char* record) {
  Record r;
  memcpy(&r, record, sizeof(Record));
  const bool pow2 = r.cap > 0 && (r.cap & (r.cap - 1)) == 0;
  if (!pow2 || r.cap > r.stride || r.cap > 0x80000000ll || r.n < 0 || 2 * r.n > r.cap || r.n_out < r.n ||
      r.depth < 1 || r.wr < 1 || r.wc < 1 || r.wr > 0xffffffffll || r.wc > 0xffffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* coef = reinterpret_cast<const int64_t*>(record + sizeof(Record));
  Tables t;
  t.pair_keys = r.pair_keys;
  t.src_keys = r.node_keys;
  t.dst_keys = r.node_keys + r.stride;
  t.pair_sums = r.sums;
  t.src_sums = r.sums + r.stride;
  t.dst_sums = r.sums + 2 * r.stride;
  t.marker_sums = r.marker_sums;
  t.counts = r.counts;
  t.mask = static_cast<uint32_t>(r.cap - 1);
  const int64_t n_touched = r.touched != nullptr ? r.depth * r.wr : 0;
  const unsigned collapse_blocks = static_cast<unsigned>((r.n > 0 ? r.n + kThreads - 1 : kThreads) / kThreads);
  preagg_collapse_kernel<<<collapse_blocks, kThreads, 0, r.stream>>>(r.batch, r.n, t, r.out_w, r.n_out,
                                                                      r.touched, n_touched);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    const Family row = make_family(coef, r.depth, r.wr, r.row_a, r.row_b);
    const Family col = make_family(coef + 2, r.depth, r.wc, r.col_a, r.col_b);
    const dim3 emit_blocks(static_cast<unsigned>((r.cap + kThreads) / kThreads), 3);  // cap + 1 slots
    preagg_emit_kernel<<<emit_blocks, kThreads, 0, r.stream>>>(
        t, r.out_src, r.out_dst, r.out_w, r.row_flows, r.col_flows, r.touched, row, col,
        static_cast<int>(r.depth), r.wr, r.wc, r.mirror != 0);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
