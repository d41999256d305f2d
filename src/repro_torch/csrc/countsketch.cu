// The CountSketch of a flat vector and its median decode, the gradient
// compressor's round trip (src/repro_torch/train/compression.py).
//
// 1. The sketch: table[i, h_i(j)] += s_i(j) * vec[j].  Replaces the TPU kernel
//    src/repro/kernels/countsketch/kernel.py::countsketch_pallas (body
//    _cs_kernel) together with the hashing its wrapper did before it
//    (src/repro/kernels/countsketch/ops.py::countsketch).  The TPU version
//    tiled the table into 256-wide stripes and built each as a one-hot MXU
//    product, re-reading vec for every stripe: O(n * width) work.  Here the
//    work is O(d * n), and one kernel body serves two sources of buckets:
//    hashed in registers from the family's coefficients (the main path, no
//    (d, n) operand), or read from precomputed (d, n) buckets and signs (the
//    Pallas kernel's own interface).
//    The sum is deterministic: every term is added as a 64-bit fixed-point
//    integer, so the order of the atomics cannot change the table, and two
//    data-parallel workers that sketch the same vector hold the same bits
//    (as the TPU's one-hot product does).  Each cell has its own scale, so a
//    cell of small terms keeps float32's precision beside cells of large
//    ones.  Three launches after a memset of the scratch:
//    * cellmax: each cell's largest finite |term|, M_c, by an integer
//      atomicMax on its bits (a max does not depend on order), and its NaN
//      and infinite terms as flag bits (atomicOr).  M_c fixes the cell's
//      scale 2^e_c with n * M_c * 2^e_c < 2^62, so no sum of rounded terms
//      reaches 2^63.
//    * the sum: round(s * vec * 2^e_c) of every finite term into the cell,
//      as an int64.
//    * finalize: table = float(sum) * 2^-e_c, or NaN / +inf / -inf as float
//      addition gives for the flags (NaN beside anything, or +inf beside
//      -inf, is NaN).
//    The two passes share one loop (for_each_term): one block of 1,024
//    threads owns one sketch row i and a contiguous chunk of j; each thread
//    takes 4 consecutive coordinates at a time (one 16-byte load of vec); a
//    group of 4 zeros is skipped whole and a zero product never reaches a
//    cell (the second sketch of a training step is almost all zeros).  The
//    row is the fastest grid index, so the d blocks of a chunk run side by
//    side and rows 2..d read the chunk from L2.  Shared-memory paths (the
//    sum's row, 10 bytes a cell, within the opt-in limit: about 23 K cells
//    on an H100): a private copy of the row's maxima, or of its sums (32-bit
//    low and high words, add_split) and exponents, flushed into the scratch
//    once a block.  Wider rows take global atomics.
// 2. The decode: est[j] = median_i(s_i(j) * table[i, h_i(j)]), NaN wherever a
//    value is NaN, else (lo + hi) * 0.5 of the two middle values
//    (jnp.median's midpoint rule).  Replaces the gather and jnp.median of
//    src/repro/train/compression.py:64-70 (no Pallas kernel there).  Each
//    thread hashes its 4 coordinates under every row, gathers d cells, and
//    takes the median with a sorting network in registers (d = 1..8; a
//    counting selection with a runtime d beyond).  What bounds it is where
//    the d*n random 4-byte gathers land: a 5 x 16,384 table (320 KB) does not
//    fit one SM's 227 KB of shared memory, and a gather that misses it costs a
//    32-byte L2 sector.  Three variants, chosen by shape (median_plan):
//    * one CTA (the table fits a CTA's shared memory): the staged kernel
//      below with every cell staged, 512 threads a block;
//    * a pair (a cluster of 2 CTAs on two SMs, each holding L >= d/2 whole
//      rows, CTA 0 the first L and CTA 1 the last L; 3 of 5 rows, 192 KB,
//      at 5 x 16,384): every gather is local.  Each CTA gathers the d - L
//      rows its partner lacks for the partner's coordinates and sends the
//      signed values into the partner's shared memory by st.async
//      (distributed shared memory, coalesced 16-byte stores, d - L floats a
//      coordinate), then gathers its own L rows for its own coordinates;
//      warp w of one CTA waits on an mbarrier for warp w of the other only,
//      which the stores themselves complete (complete_tx), so no sender
//      waits and no CTA-wide barrier runs a tile.  Designs measured first
//      (PERF.md): random gathers into the partner's shared memory
//      (ld.shared::cluster) cost more than L2 sectors, twice the staged
//      kernel's time; a cluster barrier a tile, or mbarrier arrivals with
//      cluster-scope release, kept the warps in step.  512 threads a CTA, 4
//      coordinates a thread; the hash's multipliers and the grid stride's
//      increments come as launch constants, not registers.  What bounds it
//      now is its instructions (hashes and networks, ~95 a coordinate):
//      with the gathers taken out it runs as long;
//    * staged (wider tables): the longest prefix of the table that fits is
//      staged in shared memory, the rest read through L1/L2.
//
// The hash is repro_torch/core/hashing.py's, in 32-bit registers: with
// k = j mod p and p = 2^31 - 1, bucket = ((a k + b) mod p) mod w and sign
// = 1 - 2 ((((b | 1) k + a) mod p) & 1).  From one coordinate to the next
// each residue grows by its multiplier mod p, so after a group's first
// coordinate a hash costs an add and a conditional subtract; the first is
// one 64-bit product reduced by Mersenne folds (mod_p).
//
// The sketch equals its plain version (a float32 index_add_) bit for bit
// where every term is an integer and every partial sum stays below 2^24
// (each term is then exact), and otherwise lies within float32's rounding
// of the exact sum: each term is rounded to a multiple of 2^-e_c, by at most
// n * M_c * 2^-61 (M_c * 2^-35 at n = 2^26), and the sum once to float32.
// The decode is exact (a selection) and equals its plain version bit for
// bit, NaN positions included.
//
// Bounds, both bytes, on an NVIDIA H100 80GB HBM3 at its 700.00 W limit
// (3.35 TB/s, the data sheet's peak): the sketch reads vec once and writes
// the table once, 4n + 4dw bytes (0.0777 ms at n = 65,020,416, d = 5,
// w = 16,384); the decode reads the table once and writes est once, the same
// 4n + 4dw.  What limits the sketch in practice is its two passes of d*n
// shared-memory atomics and hashes over vec; the decode's d*n hashes, gathers
// and compare-exchanges once the pair variant holds its table on chip.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr uint32_t P = 0x7FFFFFFFu;  // 2^31 - 1
constexpr int THREADS = 512;
constexpr int SKETCH_THREADS = 1024;  // the sum: one block an SM (a 128 KB row)
constexpr int VEC = 4;               // coordinates a thread takes at a time
constexpr int INLINE_ROWS = 8;       // rows whose coefficients come by value
constexpr int NETWORK_DEPTH = 8;     // deepest decode by sorting network
constexpr int PAIR_THREADS = 512;     // the pair decode: one CTA an SM
constexpr int PAIR_VEC = 4;            // coordinates a thread owns a tile
constexpr int PAIR_HALF = PAIR_VEC * PAIR_THREADS;  // coordinates a CTA owns a tile
constexpr int PAIR_WARPS = PAIR_THREADS / 32;
static_assert(PAIR_VEC == 4, "the pair decode moves a thread's coordinates as one float4");

// x mod p for any 64-bit x.
__host__ __device__ __forceinline__ uint32_t mod_p(uint64_t x) {
  x = (x & P) + (x >> 31);  // < 2^33 + 2^31
  x = (x & P) + (x >> 31);  // < p + 6
  return static_cast<uint32_t>(x >= P ? x - P : x);
}

// (u + s) mod p for u, s < p.
__device__ __forceinline__ uint32_t add_mod(uint32_t u, uint32_t s) {
  const uint32_t t = u + s;
  return t >= P ? t - P : t;
}

// x with its sign bit flipped when `odd` is 1: (-1) * x, exactly.
__device__ __forceinline__ float flip(float x, uint32_t odd) {
  return __int_as_float(__float_as_int(x) ^ static_cast<int>(odd << 31));
}

// A hash family: the coefficients of its first rows by value, every row's on
// the device (read only past INLINE_ROWS), and the width with its Lemire
// constant floor((2^64 - 1) / w) + 1, so that u mod w is two multiplies.
struct Family {
  uint32_t a[INLINE_ROWS];
  uint32_t b[INLINE_ROWS];
  const int64_t* a_dev;
  const int64_t* b_dev;
  uint64_t lemire;
  uint32_t width;

  __device__ __forceinline__ void coef(int i, uint32_t& ai, uint32_t& bi) const {
    if (i < INLINE_ROWS) {
      ai = a[i];
      bi = b[i];
    } else {
      ai = static_cast<uint32_t>(a_dev[i]);
      bi = static_cast<uint32_t>(b_dev[i]);
    }
  }
};

// u mod w: a mask for a power of two, else Lemire's two multiplies.
template <bool kPow2>
__device__ __forceinline__ int bucket(uint32_t u, uint64_t lemire, uint32_t width) {
  if (kPow2) return static_cast<int>(u & (width - 1));
  return static_cast<int>(__umul64hi(lemire * u, width));
}

// One row's hashes along a thread's coordinates: the bucket residue
// u = (a k + b) mod p and the sign residue u2 = (sa k + sb) mod p at the
// thread's current group, stepped by `step` coordinates at a time.
template <bool kPow2>
struct HashedRow {
  uint32_t a, sa, step_a, step_sa, u, u2;
  uint32_t cu[VEC], cu2[VEC];

  __device__ __forceinline__ void start(const Family& f, int i, int64_t j, int64_t step) {
    uint32_t ai, bi;
    f.coef(i, ai, bi);
    const uint32_t sai = bi | 1u;
    a = mod_p(ai);
    sa = mod_p(sai);
    step_a = mod_p(static_cast<uint64_t>(a) * static_cast<uint64_t>(step));
    step_sa = mod_p(static_cast<uint64_t>(sa) * static_cast<uint64_t>(step));
    const uint64_t k = mod_p(static_cast<uint64_t>(j));
    u = mod_p(static_cast<uint64_t>(ai) * k + bi);
    u2 = mod_p(static_cast<uint64_t>(sai) * k + ai);
  }
  // The residues of the group's VEC coordinates.
  __device__ __forceinline__ void group() {
    cu[0] = u;
    cu2[0] = u2;
#pragma unroll
    for (int e = 1; e < VEC; ++e) {
      cu[e] = add_mod(cu[e - 1], a);
      cu2[e] = add_mod(cu2[e - 1], sa);
    }
  }
  __device__ __forceinline__ void advance() {
    u = add_mod(u, step_a);
    u2 = add_mod(u2, step_sa);
  }
};

// Bucket sources of the sketch.  row(i, j, step) gives a thread's state for
// sketch row i from coordinate j on; group(j) readies the VEC coordinates
// from j; term(e, v, b) sets b to the bucket of the group's e-th coordinate
// and returns its signed value; advance() moves on by `step` coordinates.
template <bool kPow2>
struct Hashed {
  Family f;
  struct Row {
    HashedRow<kPow2> r;
    uint64_t lemire;
    uint32_t width;
    __device__ __forceinline__ void group(int64_t) { r.group(); }
    __device__ __forceinline__ float term(int e, float v, int& b) const {
      b = bucket<kPow2>(r.cu[e], lemire, width);
      return flip(v, r.cu2[e] & 1u);
    }
    __device__ __forceinline__ void advance() { r.advance(); }
  };
  __device__ __forceinline__ Row row(int i, int64_t j, int64_t step) const {
    Row out;
    out.r.start(f, i, j, step);
    out.lemire = f.lemire;
    out.width = f.width;
    return out;
  }
};

template <typename Sign>
struct Prehashed {
  const int* h;
  const Sign* s;
  int64_t n;
  struct Row {
    const int* h;
    const Sign* s;
    int64_t j;
    __device__ __forceinline__ void group(int64_t jj) { j = jj; }
    __device__ __forceinline__ float term(int e, float v, int& b) const {
      b = h[j + e];
      return static_cast<float>(s[j + e]) * v;
    }
    __device__ __forceinline__ void advance() {}
  };
  __device__ __forceinline__ Row row(int i, int64_t, int64_t) const {
    return Row{h + static_cast<int64_t>(i) * n, s + static_cast<int64_t>(i) * n, 0};
  }
};

// vec[j..j+VEC) with zeros at and past hi; one 16-byte load when aligned.
__device__ __forceinline__ void load_group(const float* __restrict__ vec, int64_t j, int64_t hi,
                                           bool aligned, float (&v)[VEC]) {
  if (aligned && j + VEC <= hi) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(vec + j));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = j + e < hi ? vec[j + e] : 0.0f;
}

// Flag bits of a cell that received a non-finite term.
constexpr unsigned FLAG_NAN = 1u, FLAG_POS_INF = 2u, FLAG_NEG_INF = 4u;

// Calls body(b, t) for every nonzero term t = s_i(j) * vec[j] of sketch row i
// over the coordinates [lo, hi), b its bucket in [0, width).  Each thread
// takes VEC consecutive coordinates at a time (one 16-byte load of vec); a
// group of VEC zeros is skipped whole.
template <class Src, class Body>
__device__ __forceinline__ void for_each_term(const float* __restrict__ vec, int64_t lo, int64_t hi,
                                              int width, bool aligned, int i, const Src& src, Body body) {
  constexpr int64_t step = static_cast<int64_t>(VEC) * SKETCH_THREADS;
  int64_t j = lo + static_cast<int64_t>(VEC) * threadIdx.x;
  auto r = src.row(i, j, step);
  float v[VEC];
  load_group(vec, j, hi, aligned, v);
  for (; j < hi; j += step, r.advance()) {
    float next[VEC];  // the next group's load is in flight while this one adds
    load_group(vec, j + step, hi, aligned, next);
    if (v[0] != 0.0f || v[1] != 0.0f || v[2] != 0.0f || v[3] != 0.0f) {
      r.group(j);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (v[e] == 0.0f) continue;
        int b;
        const float t = r.term(e, v[e], b);
        if (static_cast<unsigned>(b) < static_cast<unsigned>(width)) body(b, t);
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = next[e];
  }
}

// Pass 1: each cell's largest finite |term| as float bits (for non-negative
// floats the order of the bits is the order of the values) by atomicMax,
// and its non-finite terms as flag bits by atomicOr; neither depends on
// the order of the atomics.  Shared path: a private row in shared memory,
// flushed once a block.
template <class Src, bool kShared>
__global__ void __launch_bounds__(SKETCH_THREADS)
countsketch_cellmax_kernel(const __grid_constant__ Src src, const float* __restrict__ vec,
                           unsigned* __restrict__ maxbits, unsigned* __restrict__ flags, int64_t n, int width,
                           int64_t chunk, bool aligned) {
  extern __shared__ __align__(16) unsigned char sketch_smem[];
  unsigned* row = reinterpret_cast<unsigned*>(sketch_smem);
  const int i = blockIdx.x;  // the sketch row, fastest: a chunk's d blocks run together
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  unsigned* out = maxbits + static_cast<int64_t>(i) * width;
  unsigned* out_flags = flags + static_cast<int64_t>(i) * width;
  if (kShared) {
    for (int c = threadIdx.x; c < width; c += SKETCH_THREADS) row[c] = 0u;
    __syncthreads();
  }
  for_each_term(vec, lo, hi, width, aligned, i, src, [&](int b, float t) {
    const unsigned bits = __float_as_uint(t) & 0x7FFFFFFFu;
    if (bits < 0x7F800000u) {
      atomicMax(kShared ? &row[b] : &out[b], bits);
    } else {
      atomicOr(&out_flags[b], bits > 0x7F800000u ? FLAG_NAN : (t > 0.0f ? FLAG_POS_INF : FLAG_NEG_INF));
    }
  });
  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < width; c += SKETCH_THREADS)
      if (row[c] != 0u) atomicMax(&out[c], row[c]);
  }
}

// The exponent e of a cell's fixed-point scale: with M < 2^k its largest
// finite |term| (bits `maxbits`) and n <= 2^log2n, n * M * 2^e < 2^62, so
// its sum of at most n rounded terms stays below 2^63.
__device__ __forceinline__ int cell_exponent(unsigned maxbits, int log2n) {
  if (maxbits == 0) return 0;
  int k;
  frexpf(__uint_as_float(maxbits), &k);
  return 62 - log2n - k;
}

// 2^e as a double, for -1022 <= e <= 1023 (cell exponents lie in -131..211).
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double(static_cast<long long>(e + 1023) << 52);
}

// x added to a 64-bit cell held as two 32-bit words in shared memory, with
// native 32-bit atomics (Hopper's shared 64-bit add is a CAS loop): the low
// word takes x's low half and, when that add wraps (seen in the old value
// the atomic returns), the high word takes one more.  Every wrap is counted
// once, so high * 2^32 + low is the exact sum mod 2^64, whatever the order.
__device__ __forceinline__ void add_split(unsigned* low, int* high, long long x) {
  const unsigned x_low = static_cast<unsigned>(x);
  const unsigned old = atomicAdd(low, x_low);
  const int up = static_cast<int>(x >> 32) + (old + x_low < old ? 1 : 0);
  if (up != 0) atomicAdd(high, up);
}

// Pass 2: each finite term rounded to a multiple of its cell's 2^-e and
// added as an int64 (integer sums do not depend on the order of the
// atomics).  Shared path: the row as low and high words and the row's
// exponents in shared memory, flushed once a block with one int64 atomicAdd
// a nonzero cell.
template <class Src, bool kShared>
__global__ void __launch_bounds__(SKETCH_THREADS)
countsketch_kernel(const __grid_constant__ Src src, const float* __restrict__ vec,
                   unsigned long long* __restrict__ acc, const unsigned* __restrict__ maxbits, int log2n,
                   int64_t n, int width, int64_t chunk, bool aligned) {
  // The shared row: width low words, width high words, width exponents.
  extern __shared__ __align__(16) unsigned char sketch_smem[];
  unsigned* row_low = reinterpret_cast<unsigned*>(sketch_smem);
  int* row_high = reinterpret_cast<int*>(row_low + width);
  short* row_exp = reinterpret_cast<short*>(row_high + width);
  const int i = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  unsigned long long* out = acc + static_cast<int64_t>(i) * width;
  const unsigned* row_max = maxbits + static_cast<int64_t>(i) * width;
  if (kShared) {
    for (int c = threadIdx.x; c < width; c += SKETCH_THREADS) {
      row_low[c] = 0u;
      row_high[c] = 0;
      row_exp[c] = static_cast<short>(cell_exponent(row_max[c], log2n));
    }
    __syncthreads();
  }
  for_each_term(vec, lo, hi, width, aligned, i, src, [&](int b, float t) {
    if (!isfinite(t)) return;  // flagged by pass 1
    const int e = kShared ? row_exp[b] : cell_exponent(row_max[b], log2n);
    const long long x = __double2ll_rn(static_cast<double>(t) * pow2(e));
    if (kShared) {
      add_split(&row_low[b], &row_high[b], x);
    } else {
      // Two's complement: adding the unsigned image adds the signed value.
      atomicAdd(&out[b], static_cast<unsigned long long>(x));
    }
  });
  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < width; c += SKETCH_THREADS) {
      const unsigned long long x =
          (static_cast<unsigned long long>(static_cast<unsigned>(row_high[c])) << 32) | row_low[c];
      if (x != 0ull) atomicAdd(&out[c], x);
    }
  }
}

// table[c] = the fixed-point sum of cell c back in float32 (one rounding to
// float32, then an exact scaling by 2^-e), or the non-finite value float
// addition gives for its flags.
__global__ void __launch_bounds__(THREADS)
countsketch_finalize_kernel(const long long* __restrict__ acc, const unsigned* __restrict__ maxbits,
                            const unsigned* __restrict__ flags, int log2n, float* __restrict__ table,
                            int64_t cells) {
  const int64_t step = static_cast<int64_t>(THREADS) * gridDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; c < cells; c += step) {
    const unsigned f = flags[c];
    float x;
    if ((f & FLAG_NAN) || (f & (FLAG_POS_INF | FLAG_NEG_INF)) == (FLAG_POS_INF | FLAG_NEG_INF)) {
      x = __int_as_float(0x7fc00000);
    } else if (f & FLAG_POS_INF) {
      x = __int_as_float(0x7f800000);
    } else if (f & FLAG_NEG_INF) {
      x = __int_as_float(static_cast<int>(0xff800000u));
    } else {
      const int e = cell_exponent(maxbits[c], log2n);
      x = static_cast<float>(static_cast<double>(__ll2float_rn(acc[c])) * pow2(-e));
    }
    table[c] = x;
  }
}

// Median of D values by jnp.median's rule, in registers: an odd-even
// transposition network (fminf/fmaxf), then NaN if any value was NaN.
template <int D>
__device__ __forceinline__ float median_network(float (&v)[D]) {
  bool nan = false;
#pragma unroll
  for (int i = 0; i < D; ++i) nan |= v[i] != v[i];
#pragma unroll
  for (int p = 0; p < D; ++p) {
#pragma unroll
    for (int q = p & 1; q + 1 < D; q += 2) {
      const float lo = fminf(v[q], v[q + 1]);
      const float hi = fmaxf(v[q], v[q + 1]);
      v[q] = lo;
      v[q + 1] = hi;
    }
  }
  return nan ? __int_as_float(0x7fc00000) : (v[(D - 1) / 2] + v[D / 2]) * 0.5f;
}

template <int D, bool kPow2>
__global__ void __launch_bounds__(THREADS)
median_kernel(const float* __restrict__ table, float* __restrict__ est, int64_t n,
              int64_t staged, bool aligned, const __grid_constant__ Family f) {
  extern __shared__ float cells[];  // the table's first `staged` cells
  const int w = static_cast<int>(f.width);
  for (int64_t c = threadIdx.x; c < staged; c += THREADS) cells[c] = table[c];
  __syncthreads();
  const int64_t step = static_cast<int64_t>(VEC) * THREADS * gridDim.x;
  int64_t j = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  HashedRow<kPow2> r[D];
#pragma unroll
  for (int i = 0; i < D; ++i) r[i].start(f, i, j, step);
  for (; j < n; j += step) {
    float v[VEC][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      r[i].group();
      const int64_t row = static_cast<int64_t>(i) * w;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int64_t c = row + bucket<kPow2>(r[i].cu[e], f.lemire, f.width);
        const float x = c < staged ? cells[c] : __ldg(table + c);
        v[e][i] = flip(x, r[i].cu2[e] & 1u);
      }
      r[i].advance();
    }
    float m[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) m[e] = median_network<D>(v[e]);
    if (aligned && j + VEC <= n) {
      *reinterpret_cast<float4*>(est + j) = make_float4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (j + e < n) est[j + e] = m[e];
    }
  }
}

// The pair decode's launch constants: the family; for each row the residues
// mod p of its two multipliers and of their increments over the grid's
// stride; the rows each CTA holds and where its exchange buffers and
// barriers lie in shared memory.
struct PairDecode {
  Family f;
  uint32_t a[NETWORK_DEPTH], sa[NETWORK_DEPTH], step_a[NETWORK_DEPTH], step_sa[NETWORK_DEPTH];
  int64_t n, tiles;  // tiles of 2 * PAIR_HALF coordinates
  int rows;          // L: CTA 0 holds rows [0, L), CTA 1 rows [d - L, d); 2 L >= d
  int exchange;      // the float offset of the exchange buffers [2][d - L][PAIR_HALF] past the rows
  int barriers;      // the float offset of the barriers [2 stages][PAIR_WARPS] past them
  bool aligned;      // est is aligned to a thread's PAIR_VEC floats
};

// Distributed shared memory: the shared::cluster address of the partner's
// copy of an own shared address; an asynchronous store of a thread's 4
// floats into the partner's shared memory that, once written, counts its 16
// bytes off a barrier there (complete_tx, a release at cluster scope: the
// sender never waits for it); arming an own barrier for a phase of `bytes`;
// and waiting, acquiring at cluster scope, for the phase of the given
// parity.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_async(uint32_t addr, const float (&x)[PAIR_VEC], uint32_t remote_barrier) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
               ::"r"(addr), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(remote_barrier) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t barrier, uint32_t bytes) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
               ::"r"(barrier), "r"(bytes) : "memory");
}

// A wait of more than 2^34 clocks (about 10 s) means a broken handshake: it
// traps rather than hang the card.
__device__ __forceinline__ void wait_parity(uint32_t barrier, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(barrier), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// A pair of CTAs (a cluster of 2 on two SMs) holds a table wider than one
// CTA's shared memory: CTA 0 rows [0, L), CTA 1 rows [d - L, d).  Tile by
// tile, each CTA owns PAIR_HALF coordinates, PAIR_VEC a thread, and warp w
// of one CTA trades values with warp w of the other only.  For tile t
// (stage s = t mod 2) a warp hashes the partner warp's coordinates under the
// X = d - L rows the partner lacks (all among its own rows), gathers them
// from its own shared memory and stores the signed values into the
// partner's exchange buffer s by st.async (coalesced, X floats a
// coordinate), each counted off the partner's barrier full[s][w].  It
// gathers its own coordinates under its L rows, arms its own full[s][w] for
// the bytes the partner warp sends, waits for them, reads them and
// takes the median of the d values in row order (the same network on the
// same order as the one-CTA kernel: the same bits).  Every gather is local;
// warps never wait for the rest of their CTA, and no fence stalls a sender.
// Two buffers suffice: the partner writes tile t + 2 into buffer s only
// after its wait for tile t + 1, which this warp sends after reading tile t
// (its store's release orders the read before the partner's acquire).
template <int D, bool kPow2>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
median_pair_kernel(const float* __restrict__ table, float* __restrict__ est,
                   const __grid_constant__ PairDecode p) {
  extern __shared__ __align__(16) float pair_smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int w = static_cast<int>(p.f.width);
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L = p.rows, X = D - L;
  const int lo = rank == 0 ? 0 : D - L;       // the first row held here
  const int sent_lo = rank == 0 ? 0 : L;      // the first row the partner lacks
  const int recv_lo = rank == 0 ? L : 0;      // the first row this CTA lacks
  for (int c = threadIdx.x; c < L * w; c += PAIR_THREADS) pair_smem[c] = __ldg(table + lo * w + c);
  float* exchange = pair_smem + p.exchange;  // [2][X][PAIR_HALF]
  const uint32_t remote =
      map_rank(static_cast<uint32_t>(__cvta_generic_to_shared(exchange)), rank ^ 1) + 4u * PAIR_VEC * threadIdx.x;
  // full[s][w], the barrier of stage s and warp w, at s * PAIR_WARPS + w.
  const uint32_t full = static_cast<uint32_t>(__cvta_generic_to_shared(pair_smem + p.barriers)) + 8u * warp;
  if (lane == 0) {
    for (int stage = 0; stage < 2; ++stage) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(full + 8u * PAIR_WARPS * stage) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const uint32_t partner_full = map_rank(full, rank ^ 1);
  cluster.sync();  // both CTAs staged, barriers set, before any store crosses

  const int64_t pair = blockIdx.x / 2, pairs = gridDim.x / 2;
  const int64_t own0 = (pair * 2 + rank) * PAIR_HALF + PAIR_VEC * threadIdx.x;
  const int64_t other0 = (pair * 2 + (rank ^ 1)) * PAIR_HALF + PAIR_VEC * threadIdx.x;
  uint32_t u[D], u2[D], ou[D], ou2[D];  // residues at this thread's own and partner coordinates
  {
    const uint64_t k = mod_p(static_cast<uint64_t>(own0)), ok = mod_p(static_cast<uint64_t>(other0));
#pragma unroll
    for (int i = 0; i < D; ++i) {
      uint32_t ai, bi;
      p.f.coef(i, ai, bi);
      u[i] = mod_p(static_cast<uint64_t>(ai) * k + bi);
      u2[i] = mod_p(static_cast<uint64_t>(bi | 1u) * k + ai);
      ou[i] = mod_p(static_cast<uint64_t>(ai) * ok + bi);
      ou2[i] = mod_p(static_cast<uint64_t>(bi | 1u) * ok + ai);
    }
  }
  // The signed cells of local row i for a thread's PAIR_VEC coordinates,
  // the first at residues (x, x2).
  auto cells = [&](int i, uint32_t x, uint32_t x2, float (&out)[PAIR_VEC]) {
#pragma unroll
    for (int e = 0; e < PAIR_VEC; ++e) {
      if (e > 0) {
        x = add_mod(x, p.a[i]);
        x2 = add_mod(x2, p.sa[i]);
      }
      out[e] = flip(pair_smem[(i - lo) * w + bucket<kPow2>(x, p.f.lemire, p.f.width)], x2 & 1u);
    }
  };
  int64_t j = own0;
  const int64_t stride = 2 * PAIR_HALF * pairs;
  for (int64_t tile = pair, t = 0; tile < p.tiles; tile += pairs, ++t, j += stride) {
    const uint32_t s = static_cast<uint32_t>(t & 1), stage = 8u * PAIR_WARPS * s;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i < sent_lo || i >= sent_lo + X) continue;  // CTA-uniform
      float x[PAIR_VEC];
      cells(i, ou[i], ou2[i], x);
      store_async(remote + 4u * static_cast<uint32_t>((s * X + i - sent_lo) * PAIR_HALF), x, partner_full + stage);
      ou[i] = add_mod(ou[i], p.step_a[i]);
      ou2[i] = add_mod(ou2[i], p.step_sa[i]);
    }
    float v[PAIR_VEC][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i < lo || i >= lo + L) continue;
      float x[PAIR_VEC];
      cells(i, u[i], u2[i], x);
#pragma unroll
      for (int e = 0; e < PAIR_VEC; ++e) v[e][i] = x[e];
      u[i] = add_mod(u[i], p.step_a[i]);
      u2[i] = add_mod(u2[i], p.step_sa[i]);
    }
    if (lane == 0) expect_bytes(full + stage, 32u * 4u * PAIR_VEC * static_cast<uint32_t>(X));
    wait_parity(full + stage, static_cast<uint32_t>(t >> 1) & 1u);  // the partner warp's values for this tile
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i < recv_lo || i >= recv_lo + X) continue;
      const float4 got =
          *reinterpret_cast<const float4*>(exchange + (s * X + i - recv_lo) * PAIR_HALF + PAIR_VEC * threadIdx.x);
      v[0][i] = got.x;
      v[1][i] = got.y;
      v[2][i] = got.z;
      v[3][i] = got.w;
    }
    float m[PAIR_VEC];
#pragma unroll
    for (int e = 0; e < PAIR_VEC; ++e) m[e] = median_network<D>(v[e]);
    if (p.aligned && j + PAIR_VEC <= p.n) {
      *reinterpret_cast<float4*>(est + j) = make_float4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int e = 0; e < PAIR_VEC; ++e)
        if (j + e < p.n) est[j + e] = m[e];
    }
  }
  cluster.sync();  // no CTA leaves while its partner may still store into it
}

// Past NETWORK_DEPTH rows: the r-th smallest value is the v_i with
// #{v < v_i} <= r < #{v <= v_i}; each value is hashed and gathered again
// for each comparison (d^2 of them), so no array of d values is kept.
template <bool kPow2>
__device__ __forceinline__ float cell_value(const float* __restrict__ table, const Family& f,
                                            int i, uint64_t k) {
  uint32_t ai, bi;
  f.coef(i, ai, bi);
  const uint32_t u = mod_p(static_cast<uint64_t>(ai) * k + bi);
  const uint32_t u2 = mod_p(static_cast<uint64_t>(bi | 1u) * k + ai);
  const float x = __ldg(table + static_cast<int64_t>(i) * f.width + bucket<kPow2>(u, f.lemire, f.width));
  return flip(x, u2 & 1u);
}

template <bool kPow2>
__global__ void __launch_bounds__(THREADS)
median_any_depth_kernel(const float* __restrict__ table, float* __restrict__ est, int64_t n,
                        int depth, const __grid_constant__ Family f) {
  const int r_lo = (depth - 1) / 2, r_hi = depth / 2;
  const int64_t step = static_cast<int64_t>(THREADS) * gridDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; j < n; j += step) {
    const uint64_t k = mod_p(static_cast<uint64_t>(j));
    bool nan = false;
    for (int i = 0; i < depth; ++i) {
      const float x = cell_value<kPow2>(table, f, i, k);
      nan |= x != x;
    }
    float lo = 0.0f, hi = 0.0f;
    for (int i = 0; !nan && i < depth; ++i) {
      const float x = cell_value<kPow2>(table, f, i, k);
      int less = 0, leq = 0;
      for (int q = 0; q < depth; ++q) {
        const float y = cell_value<kPow2>(table, f, q, k);
        less += y < x;
        leq += y <= x;
      }
      if (less <= r_lo && r_lo < leq) lo = x;
      if (less <= r_hi && r_hi < leq) hi = x;
    }
    est[j] = nan ? __int_as_float(0x7fc00000) : (lo + hi) * 0.5f;
  }
}

// The launch record both entry points take (kernels/countsketch/ops.py
// packs it): pointers, sizes and the stream, then depth x (a, b) as int64
// when the buckets are hashed.
struct Record {
  uint64_t in;      // vec (sketch) or table (decode)
  uint64_t out;     // table (sketch, every cell written) or est (decode)
  uint64_t h, s;    // precomputed (d, n) buckets and signs, or 0: hash them
  uint64_t a_dev, b_dev;  // the family's (d,) int64 coefficients on the device
  uint64_t scratch; // the sketch's scratch_bytes(d, width) bytes (the decode: 0)
  int64_t n, depth, width, sign_bytes;
  uint64_t stream;
};

Family make_family(const Record& r) {
  const int64_t* ab = reinterpret_cast<const int64_t*>(
      reinterpret_cast<const char*>(&r) + sizeof(Record));
  Family f{};
  for (int i = 0; i < INLINE_ROWS && i < r.depth; ++i) {
    f.a[i] = static_cast<uint32_t>(ab[2 * i]);
    f.b[i] = static_cast<uint32_t>(ab[2 * i + 1]);
  }
  f.a_dev = reinterpret_cast<const int64_t*>(r.a_dev);
  f.b_dev = reinterpret_cast<const int64_t*>(r.b_dev);
  f.width = static_cast<uint32_t>(r.width);
  f.lemire = ~0ull / static_cast<uint64_t>(r.width) + 1;
  return f;
}

bool is_pow2(int64_t w) { return (w & (w - 1)) == 0; }

struct Device {
  int sms = 0, optin = 0;
  Device() {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
};

// The sketch's scratch: the int64 sums, the uint32 maxima and the uint32
// flags of the d x width cells (kernels/countsketch/ops.py allocates it).
int64_t scratch_bytes(int64_t d, int64_t width) { return 16 * d * width; }

// Launches one pass over the (d, chunk) grid with the kernel's arguments,
// then its chunk and whether vec is 16-byte aligned: one wave of resident blocks,
// split evenly over the d rows (each block's flush touches up to a row of
// cells, and a second wave of a few blocks would double the time); no block
// gets fewer than 4 groups a thread; chunks are whole groups, so every
// 16-byte load stays aligned.
template <typename Kernel, typename... Args>
cudaError_t launch_pass(Kernel kernel, bool shared, int64_t smem, const Record& r, const Device& dev,
                        Args... args) {
  const int64_t d = r.depth, n = r.n;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(r.stream);
  if (shared) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SKETCH_THREADS,
                                                                  shared ? static_cast<size_t>(smem) : 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  int64_t per_row = static_cast<int64_t>(dev.sms) * per_sm / d;
  const int64_t most = (n + 4LL * VEC * SKETCH_THREADS - 1) / (4LL * VEC * SKETCH_THREADS);
  if (per_row > most) per_row = most;
  if (per_row < 1) per_row = 1;
  int64_t chunk = (n + per_row - 1) / per_row;
  chunk = (chunk + VEC - 1) / VEC * VEC;
  per_row = (n + chunk - 1) / chunk;
  kernel<<<dim3(static_cast<unsigned>(d), static_cast<unsigned>(per_row)), SKETCH_THREADS,
           shared ? static_cast<size_t>(smem) : 0, stream>>>(args..., chunk, (r.in & 15) == 0);
  return cudaGetLastError();
}

template <class Src>
int launch_sketch(const Record& r, Src src) {
  const float* vec = reinterpret_cast<const float*>(r.in);
  float* table = reinterpret_cast<float*>(r.out);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(r.stream);
  const int64_t d = r.depth, n = r.n, width = r.width;
  char* scratch = reinterpret_cast<char*>(r.scratch);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(scratch);
  unsigned* maxbits = reinterpret_cast<unsigned*>(scratch + 8 * d * width);
  unsigned* flags = maxbits + d * width;
  int log2n = 0;
  while ((int64_t{1} << log2n) < n) ++log2n;
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(scratch_bytes(d, width)), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Device dev;
  const int w = static_cast<int>(width);

  const int64_t max_smem = 4 * width;  // the row's maxima
  const bool max_shared = max_smem <= dev.optin;
  err = launch_pass(max_shared ? countsketch_cellmax_kernel<Src, true> : countsketch_cellmax_kernel<Src, false>,
                    max_shared, max_smem, r, dev, src, vec, maxbits, flags, n, w);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t sum_smem = 10 * width;  // low and high words, exponents
  const bool sum_shared = sum_smem <= dev.optin;
  err = launch_pass(sum_shared ? countsketch_kernel<Src, true> : countsketch_kernel<Src, false>,
                    sum_shared, sum_smem, r, dev, src, vec, acc, static_cast<const unsigned*>(maxbits), log2n, n,
                    w);
  if (err != cudaSuccess) return static_cast<int>(err);

  int64_t fin = (d * width + THREADS - 1) / THREADS;
  if (fin > static_cast<int64_t>(dev.sms) * 8) fin = static_cast<int64_t>(dev.sms) * 8;
  countsketch_finalize_kernel<<<static_cast<unsigned>(fin), THREADS, 0, stream>>>(
      reinterpret_cast<const long long*>(acc), maxbits, flags, log2n, table, d * width);
  return static_cast<int>(cudaGetLastError());
}

// The pair decode's shared memory for L rows of width w: the rows, then
// (16-byte aligned) two exchange buffers of d - L floats a coordinate, then
// two 8-byte barriers a warp.
int64_t pair_exchange_offset(int64_t rows, int64_t w) { return (rows * w + 3) / 4 * 4; }
int64_t pair_barrier_offset(int64_t d, int64_t rows, int64_t w) {
  return pair_exchange_offset(rows, w) + 2 * (d - rows) * PAIR_HALF;
}
int64_t pair_smem_bytes(int64_t d, int64_t rows, int64_t w) {
  return 4 * pair_barrier_offset(d, rows, w) + 8 * 2 * PAIR_WARPS;
}

// The rows L each CTA of a pair holds: the most that fit with the exchange
// buffers (fewer values cross per coordinate), with 2 L >= d so that the two
// CTAs hold every row; 0 where no L fits.
int64_t pair_rows(int64_t d, int64_t w, const Device& dev) {
  for (int64_t rows = d - 1; rows >= 1 && 2 * rows >= d; --rows) {
    if (pair_smem_bytes(d, rows, w) <= dev.optin) return rows;
  }
  return 0;
}

// The decode's variant for a (d, w) table: 1 where one CTA's shared memory
// holds the whole table (the staged kernel, every cell staged), 2 where a
// pair of CTAs does (the pair kernel), 0 otherwise (the staged kernel, a
// prefix staged), -1 past NETWORK_DEPTH rows (the runtime-depth kernel).
int median_plan(int64_t d, int64_t w, const Device& dev) {
  if (d > NETWORK_DEPTH) return -1;
  if (4 * d * w <= dev.optin) return 1;
  return pair_rows(d, w, dev) > 0 ? 2 : 0;
}

template <int D>
int launch_median_pair(const Record& r, const Family& f, const Device& dev) {
  const int64_t rows = pair_rows(D, r.width, dev);
  const size_t smem = static_cast<size_t>(pair_smem_bytes(D, rows, r.width));
  auto kernel = is_pow2(r.width) ? median_pair_kernel<D, true> : median_pair_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(PAIR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(r.stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int pairs = 0;
  err = cudaOccupancyMaxActiveClusters(&pairs, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // A persistent grid of every pair that fits at once, cut short for a
  // vector of fewer tiles.
  PairDecode p{};
  p.tiles = (r.n + 2 * PAIR_HALF - 1) / (2 * PAIR_HALF);
  if (pairs > p.tiles) pairs = static_cast<int>(p.tiles);
  cfg.gridDim = dim3(static_cast<unsigned>(2 * pairs));
  p.f = f;
  const uint64_t stride = static_cast<uint64_t>(2 * PAIR_HALF) * pairs;
  static_assert(D <= INLINE_ROWS, "every row's coefficients come by value");
  for (int i = 0; i < D; ++i) {
    p.a[i] = mod_p(f.a[i]);
    p.sa[i] = mod_p(f.b[i] | 1u);
    p.step_a[i] = mod_p(static_cast<uint64_t>(p.a[i]) * stride);
    p.step_sa[i] = mod_p(static_cast<uint64_t>(p.sa[i]) * stride);
  }
  p.n = r.n;
  p.rows = static_cast<int>(rows);
  p.exchange = static_cast<int>(pair_exchange_offset(rows, r.width));
  p.barriers = static_cast<int>(pair_barrier_offset(D, rows, r.width));
  p.aligned = (r.out & (4 * PAIR_VEC - 1)) == 0;
  err = cudaLaunchKernelEx(&cfg, kernel, reinterpret_cast<const float*>(r.in), reinterpret_cast<float*>(r.out), p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int D>
int launch_median_network(const Record& r, const Family& f, const Device& dev) {
  if (median_plan(D, r.width, dev) == 2) return launch_median_pair<D>(r, f, dev);
  const float* table = reinterpret_cast<const float*>(r.in);
  float* est = reinterpret_cast<float*>(r.out);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(r.stream);
  int64_t staged = dev.optin / static_cast<int64_t>(sizeof(float));
  if (staged > D * r.width) staged = D * r.width;
  const size_t smem = static_cast<size_t>(staged) * sizeof(float);
  auto kernel = is_pow2(r.width) ? median_kernel<D, true> : median_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  // A persistent grid (each block stages the table once), cut short for a
  // vector too small to give every block a group a thread.
  int64_t blocks = static_cast<int64_t>(dev.sms) * per_sm;
  const int64_t most = (r.n + static_cast<int64_t>(VEC) * THREADS - 1) / (static_cast<int64_t>(VEC) * THREADS);
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  const bool aligned = (r.out & 15) == 0;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      table, est, r.n, staged, aligned, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table = the CountSketch of vec: from the precomputed buckets h and signs
// s (sign_bytes 1 for int8, 4 for int32) when h is set, else hashed in the
// kernel from the record's coefficients.
extern "C" int glava_countsketch(const char* record) {
  const Record& r = *reinterpret_cast<const Record*>(record);
  if (r.width < 1 || r.width > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (r.depth == 0) return 0;
  if (r.n == 0)
    return static_cast<int>(cudaMemsetAsync(reinterpret_cast<void*>(r.out), 0,
                                            static_cast<size_t>(4 * r.depth * r.width),
                                            reinterpret_cast<cudaStream_t>(r.stream)));
  if (r.h != 0) {
    const int* h = reinterpret_cast<const int*>(r.h);
    if (r.sign_bytes == 1)
      return launch_sketch(r, Prehashed<int8_t>{h, reinterpret_cast<const int8_t*>(r.s), r.n});
    if (r.sign_bytes == 4)
      return launch_sketch(r, Prehashed<int32_t>{h, reinterpret_cast<const int32_t*>(r.s), r.n});
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Family f = make_family(r);
  if (is_pow2(r.width)) return launch_sketch(r, Hashed<true>{f});
  return launch_sketch(r, Hashed<false>{f});
}

// The decode's variant for a (depth, width) table on the current device
// (median_plan): 1 one CTA, 2 a pair of CTAs, 0 a staged prefix, -1 the
// runtime-depth kernel.
extern "C" int glava_countsketch_median_plan(int64_t depth, int64_t width) {
  return median_plan(depth, width, Device());
}

// est (n,) = the median decode of the (depth, width) table under the
// record's family, for the coordinates 0..n-1.
extern "C" int glava_countsketch_median(const char* record) {
  const Record& r = *reinterpret_cast<const Record*>(record);
  if (r.depth == 0 || r.n == 0) return 0;
  if (r.width < 1 || r.width > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const Family f = make_family(r);
  const Device dev;
  switch (r.depth) {
    case 1: return launch_median_network<1>(r, f, dev);
    case 2: return launch_median_network<2>(r, f, dev);
    case 3: return launch_median_network<3>(r, f, dev);
    case 4: return launch_median_network<4>(r, f, dev);
    case 5: return launch_median_network<5>(r, f, dev);
    case 6: return launch_median_network<6>(r, f, dev);
    case 7: return launch_median_network<7>(r, f, dev);
    case 8: return launch_median_network<8>(r, f, dev);
    default: break;
  }
  static_assert(NETWORK_DEPTH == 8, "the switch above covers depths 1..NETWORK_DEPTH");
  const float* table = reinterpret_cast<const float*>(r.in);
  float* est = reinterpret_cast<float*>(r.out);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(r.stream);
  int64_t blocks = static_cast<int64_t>(dev.sms) * 4;
  const int64_t most = (r.n + THREADS - 1) / THREADS;
  if (blocks > most) blocks = most;
  if (is_pow2(r.width))
    median_any_depth_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        table, est, r.n, static_cast<int>(r.depth), f);
  else
    median_any_depth_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        table, est, r.n, static_cast<int>(r.depth), f);
  return static_cast<int>(cudaGetLastError());
}
