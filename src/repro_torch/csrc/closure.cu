// The port's boolean product on the 8-bit tensor cores, out = C0 OR (A @ B > 0),
// over n stacked 0/1 byte matrices: A (n, M, K), B (n, K, N) given as B^T
// (n, N, K), C0 (n, M, N) optional, and out^T (n, N, M) written beside out when
// asked for; M, N and K multiples of 128.  One device body behind two kernel
// names, each the name the profiler and the benchmark read:
// - closure_step_wgmma_kernel (glava_closure_step): one boolean squaring step
//   of transitive closure, out = A OR (A @ A > 0), for n stacked (w, w)
//   matrices (the d sketches), with out's transpose, which the next step
//   needs: the product with B^T = A^T, C0 = A and M = N = K = w.  Replaces
//   the TPU kernel src/repro/kernels/closure/kernel.py::closure_step_pallas
//   (body _closure_kernel), which accumulated float32 blocks across a
//   sequential contraction grid axis.
// - bool_product_wgmma_kernel (glava_bool_product), port-only: the products
//   of the incremental closure refresh (src/repro/core/reach.py::
//   closure_refresh, float32 einsums in the reference, no Pallas kernel).
//   The refresh on the card (kernels/boolmm/ops.py::closure_refresh) runs
//   every product here: U = Delta . B, the touched-row closure's squarings,
//   W = S* . U and the new closure B OR G . W.
// Beside them, a byte transpose (byte_transpose_kernel, glava_byte_transpose)
// for the refresh's closure, which a generic strided copy moves at a tenth of
// the bandwidth.
//
// Each block owns one 128 x BN output tile of one matrix (BN = 256 when
// N % 256 == 0, else 128) and runs the whole contraction itself; blocks run
// in any order, so out is a buffer apart from the operands (B3's loop
// ping-pongs two pairs across steps).
//
// Bound on an H100: 2*M*N*K operations a matrix on the tensor cores at the
// 8-bit rate (1,979 TOPS dense).  B3 at d=5, w=8,192 is 5.5e12 operations,
// 2.78 ms a step, against 1.34 GB of reads and writes (A, A^T, out, out^T at
// one byte an entry: 0.40 ms at 3.35 TB/s); the refresh at d = 5, w = 8,192
// and T = 2,048 touched rows, two tenants, is 8.0e12 operations (4.05 ms)
// against 2.0 GB (0.6 ms).  So both are bound by operations, and the design
// feeds the tensor cores at that rate:
// - 8-bit operands.  0/1 is exact in u8 and the int32 sums are at most
//   K < 2^31, so `wgmma ... .s32.u8.u8` computes A @ B exactly.  8-bit wgmma
//   takes both operands K-major only: A's rows are, and the B operand comes
//   from B^T's rows.  Hence B3's transposed copy.
// - A TMA pipeline.  One producer thread keeps STAGES stages of (128 rows of
//   A, BN rows of B^T) x 128 bytes of the contraction in flight, each loaded
//   by TMA with the 128-byte swizzle wgmma reads, and signalled on an
//   mbarrier; two consumer warpgroups each issue m64nBNk32 wgmma on their 64
//   rows, keep one stage's wgmma in flight while they issue the next, and
//   release a stage on a second mbarrier once the wgmma reading it is done.
//   setmaxnreg moves the producer's registers to the consumers' BN/2 int32
//   accumulators.
// - A grouped raster: blocks walk 16 row tiles per column tile, so the tiles
//   in flight share A and B^T panels in the 50 MB L2.
// - The epilogue saturates (> 0 -> 1) into a byte tile in shared memory (the
//   pipeline's, free by then), ORs in C0's entries with 16-byte loads and
//   stores the tile row-major into out and, when asked, transposed through
//   shared memory with byte permutes into out^T: 32 contiguous bytes a store.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <mutex>

namespace {

constexpr int BM = 128;        // output rows a block: two consumer warpgroups of 64
constexpr int BK = 128;        // contraction bytes a stage: one 128-byte swizzle row
constexpr int WK = 32;         // contraction of one 8-bit wgmma
constexpr int STAGES = 4;
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, warpgroup 2 loads
constexpr int CONSUMERS = 256;
constexpr int GROUP_I = 16;    // row tiles per raster group

template <int BN>
struct Cfg {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int PIPE_BYTES = STAGES * STAGE_BYTES;
  static constexpr int C_LD = BN + 16;  // row stride of the epilogue's byte tile
  // Stages, their 2 x STAGES mbarriers, and slack to align the stages to 1024 bytes.
  static constexpr int SMEM_BYTES = PIPE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(BM * C_LD <= PIPE_BYTES, "the epilogue tile reuses the stages");
  static_assert(SMEM_BYTES <= 232448, "over the H100's shared memory per block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// of more than 10 s means a broken pipeline: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 0xFFF) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma operand descriptor of a K-major tile in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart.  A step of 32 bytes along K
// inside the swizzle row adds 2 to the start address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n128(uint32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(uint32_t (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(uint32_t (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_n256(d, da, db);
  else wgmma_n128(d, da, db);
}

// The product of one block: its 128 x BN tile of out = C0 OR (A @ B > 0)
// and, when out_t is not null, of out^T; c0 may be null.
template <int BN>
__device__ __forceinline__ void bool_product_block(const CUtensorMap* map_a, const CUtensorMap* map_bt,
                                                   const uint8_t* __restrict__ c0, uint8_t* __restrict__ out,
                                                   uint8_t* __restrict__ out_t, int m, int n, int k) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::PIPE_BYTES);
  uint64_t* empty = full + STAGES;

  // Grouped raster over (matrix, row tile, column tile).
  const int tiles_i = m / BM, tiles_j = n / BN;
  const int per_matrix = tiles_i * tiles_j;
  const int z = blockIdx.x / per_matrix;
  const int r = blockIdx.x % per_matrix;
  const int group = GROUP_I * tiles_j;
  const int first_i = (r / group) * GROUP_I;
  const int group_rows = min(tiles_i - first_i, GROUP_I);
  const int i0 = (first_i + (r % group) % group_rows) * BM;
  const int j0 = ((r % group) / group_rows) * BN;
  const int nk = k / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        uint8_t* stage = smem + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_3d(stage, map_a, &full[s], kt * BK, i0, z);
        tma_load_3d(stage + C::A_BYTES, map_bt, &full[s], kt * BK, j0, z);
      }
    }
  } else {
    // Consumers: warpgroup wg multiplies rows wg*64 .. +64 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    uint32_t acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_operands(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint8_t* stage = smem + s * C::STAGE_BYTES;
      const uint64_t da = sw128_desc(stage + wg * 64 * BK);
      const uint64_t db = sw128_desc(stage + C::A_BYTES);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / WK; ++kk) wgmma<BN>(acc, da + 2 * kk, db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // The previous stage's wgmma is done once at most this one is in flight.
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_operands(acc);
      if (kt > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(acc);

    // Epilogue.  Every consumer is past its last wgmma before the stages
    // are reused as the (BM, C_LD) byte tile.
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    uint8_t* tile = smem;
    const int t = threadIdx.x, warp = (t % 128) / 32, lane = t % 32;
    // The accumulator layout of m64nNk32: register 4j+e of a thread holds
    // row warp*16 + lane/4 (+8 for e >= 2), column 8j + 2*(lane%4) (+1 for odd e).
    const int row = wg * 64 + warp * 16 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uint16_t lo = (acc[4 * j] != 0) | ((acc[4 * j + 1] != 0) << 8);
      const uint16_t hi = (acc[4 * j + 2] != 0) | ((acc[4 * j + 3] != 0) << 8);
      *reinterpret_cast<uint16_t*>(tile + row * C::C_LD + 8 * j + col) = lo;
      *reinterpret_cast<uint16_t*>(tile + (row + 8) * C::C_LD + 8 * j + col) = hi;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

    const size_t plane = static_cast<size_t>(m) * n;
    uint8_t* O = out + z * plane;
    // Row-major: out = tile | C0, 16 bytes a thread, kept in the tile too.
    for (int q = t; q < BM * BN / 16; q += CONSUMERS) {
      const int rr = q / (BN / 16), cc = (q % (BN / 16)) * 16;
      const size_t g = static_cast<size_t>(i0 + rr) * n + j0 + cc;
      uint4 v = *reinterpret_cast<const uint4*>(tile + rr * C::C_LD + cc);
      if (c0 != nullptr) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(c0 + z * plane + g));
        v.x |= x.x;
        v.y |= x.y;
        v.z |= x.z;
        v.w |= x.w;
        *reinterpret_cast<uint4*>(tile + rr * C::C_LD + cc) = v;
      }
      *reinterpret_cast<uint4*>(O + g) = v;
    }
    if (out_t == nullptr) return;
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    uint8_t* OT = out_t + z * plane;
    // Transposed: an item is 4 columns x 32 rows of the tile, read as 32
    // words and written as 4 rows of 32 bytes of out^T.
    for (int q = t; q < (BN / 4) * (BM / 32); q += CONSUMERS) {
      const int p = q % (BN / 4), band = q / (BN / 4);
      uint32_t v[32];
#pragma unroll
      for (int kk = 0; kk < 32; ++kk)
        v[kk] = *reinterpret_cast<const uint32_t*>(tile + (32 * band + kk) * C::C_LD + 4 * p);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t sel = c | ((c + 4) << 4);  // byte c of each of two words
        uint32_t o[8];
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const uint32_t lo = __byte_perm(v[4 * g], v[4 * g + 1], sel);
          const uint32_t hi = __byte_perm(v[4 * g + 2], v[4 * g + 3], sel);
          o[g] = __byte_perm(lo, hi, 0x5410);
        }
        uint4* dst = reinterpret_cast<uint4*>(OT + static_cast<size_t>(j0 + 4 * p + c) * m + i0 + 32 * band);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
closure_step_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_at,
                          const uint8_t* __restrict__ a, uint8_t* __restrict__ out,
                          uint8_t* __restrict__ out_t, int w) {
  bool_product_block<BN>(&map_a, &map_at, a, out, out_t, w, w, w);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
bool_product_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_bt,
                          const uint8_t* __restrict__ c0, uint8_t* __restrict__ out,
                          uint8_t* __restrict__ out_t, int m, int n, int k) {
  bool_product_block<BN>(&map_a, &map_bt, c0, out, out_t, m, n, k);
}

// out[z] = a[z]^T for (n, rows, cols) bytes, rows and cols multiples of 128:
// the refresh transposes the closure once (its B operand).  A block moves a
// 128 x 128 tile through shared memory: 16-byte loads along the rows, then
// the epilogue's transposed store above (32 words of 32 source rows read
// across the banks, byte permutes, 32 contiguous bytes a store).
constexpr int TT = 128;
constexpr int TT_THREADS = 128;

__global__ void __launch_bounds__(TT_THREADS)
byte_transpose_kernel(const uint8_t* __restrict__ a, uint8_t* __restrict__ out, int rows, int cols) {
  __shared__ uint32_t tile[TT][TT / 4 + 1];  // a word column of padding: the reads below cross the banks
  const int i0 = blockIdx.y * TT, j0 = blockIdx.x * TT, t = threadIdx.x;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const uint8_t* A = a + blockIdx.z * plane;
  for (int q = t; q < TT * TT / 16; q += TT_THREADS) {
    const int r = q / (TT / 16), c = q % (TT / 16);
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(A + static_cast<size_t>(i0 + r) * cols + j0 + 16 * c));
    uint32_t* dst = &tile[r][4 * c];
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();
  uint8_t* O = out + blockIdx.z * plane;
  for (int q = t; q < (TT / 4) * (TT / 32); q += TT_THREADS) {
    const int p = q % (TT / 4), band = q / (TT / 4);
    uint32_t v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = tile[32 * band + k][p];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t sel = c | ((c + 4) << 4);
      uint32_t o[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const uint32_t lo = __byte_perm(v[4 * g], v[4 * g + 1], sel);
        const uint32_t hi = __byte_perm(v[4 * g + 2], v[4 * g + 3], sel);
        o[g] = __byte_perm(lo, hi, 0x5410);
      }
      uint4* dst = reinterpret_cast<uint4*>(O + static_cast<size_t>(j0 + 4 * p + c) * rows + i0 + 32 * band);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the
// runtime's entry-point query so the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor maps cached per (pointer, n, rows, k, box rows): a closure's steps
// cycle through four buffers and a refresh's products reuse the caching
// allocator's blocks call after call, so their host paths mostly encode
// nothing.  The slots hold a fleet tick's B3 build and refresh together.
constexpr int MAP_SLOTS = 48;
struct MapEntry {
  const void* ptr;
  int64_t n, rows, k;
  uint32_t box_rows;
  CUtensorMap map;
};
std::mutex map_mutex;
MapEntry map_cache[MAP_SLOTS];
int map_count = 0, map_next = 0;

// The map of an (n, rows, k) byte tensor read as boxes of `box_rows` rows x
// BK bytes, 128-byte swizzled.  False if the encoding is refused.
bool tensor_map(const void* ptr, int64_t n, int64_t rows, int64_t k, uint32_t box_rows, CUtensorMap* map) {
  std::lock_guard<std::mutex> lock(map_mutex);
  for (int i = 0; i < map_count; ++i) {
    const MapEntry& e = map_cache[i];
    if (e.ptr == ptr && e.n == n && e.rows == rows && e.k == k && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows * k)};
  const cuuint32_t box[3] = {BK, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides,
                              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return false;
  MapEntry& slot = map_cache[map_next];
  slot = MapEntry{ptr, n, rows, k, box_rows, *map};
  map_next = (map_next + 1) % MAP_SLOTS;
  if (map_count < MAP_SLOTS) ++map_count;
  return true;
}

// Launch `kernel` at BN over n matrices of (m / BM) x (nc / BN) tiles, A read
// as (n, m, k) and B^T as (n, nc, k); `args` follow the two maps.
template <int BN, typename Kernel, typename... Args>
int launch(Kernel kernel, const uint8_t* a, const uint8_t* b_t, int64_t n, int64_t m, int64_t nc, int64_t k,
           cudaStream_t stream, Args... args) {
  using C = Cfg<BN>;
  CUtensorMap map_a, map_bt;
  if (!tensor_map(a, n, m, k, BM, &map_a) || !tensor_map(b_t, n, nc, k, BN, &map_bt))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = n * (m / BM) * (nc / BN);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, C::SMEM_BYTES, stream>>>(map_a, map_bt, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a and a_t: (n, w, w) bytes in {0, 1}, a_t the transpose of each matrix of
// a; out and out_t receive the step and its transpose.  All four 16-byte
// aligned and distinct; w % 128 == 0.
extern "C" int glava_closure_step(const uint8_t* a, const uint8_t* a_t, uint8_t* out, uint8_t* out_t,
                                  int64_t n, int64_t w, void* stream) {
  if (n == 0 || w == 0) return 0;
  if (w % BM != 0 || w > (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wi = static_cast<int>(w);
  return w % 256 == 0 ? launch<256>(closure_step_wgmma_kernel<256>, a, a_t, n, w, w, w, s, a, out, out_t, wi)
                      : launch<128>(closure_step_wgmma_kernel<128>, a, a_t, n, w, w, w, s, a, out, out_t, wi);
}

// a: (n, m, k) bytes in {0, 1}; b_t: (n, nc, k), each matrix of B
// transposed; c0: (n, m, nc) or null; out receives (n, m, nc) and out_t, if
// not null, its transpose (n, nc, m).  All 16-byte aligned; out and out_t
// distinct from the inputs and each other; m, nc, k multiples of 128.
extern "C" int glava_bool_product(const uint8_t* a, const uint8_t* b_t, const uint8_t* c0, uint8_t* out,
                                  uint8_t* out_t, int64_t n, int64_t m, int64_t nc, int64_t k, void* stream) {
  if (n == 0 || m == 0 || nc == 0) return 0;
  if (m % BM != 0 || nc % 128 != 0 || k % BK != 0 || k == 0 || m > (1 << 24) || nc > (1 << 24) ||
      k > (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m), ni = static_cast<int>(nc), ki = static_cast<int>(k);
  return nc % 256 == 0
             ? launch<256>(bool_product_wgmma_kernel<256>, a, b_t, n, m, nc, k, s, c0, out, out_t, mi, ni, ki)
             : launch<128>(bool_product_wgmma_kernel<128>, a, b_t, n, m, nc, k, s, c0, out, out_t, mi, ni, ki);
}

// a: (n, rows, cols) bytes; out receives (n, cols, rows), each matrix
// transposed.  Both 16-byte aligned and distinct; rows, cols multiples of 128.
extern "C" int glava_byte_transpose(const uint8_t* a, uint8_t* out, int64_t n, int64_t rows, int64_t cols,
                                    void* stream) {
  if (n == 0 || rows == 0 || cols == 0) return 0;
  if (rows % TT != 0 || cols % TT != 0 || n > 65535 || rows / TT > 65535 || rows > (1 << 24) || cols > (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(cols / TT), static_cast<unsigned>(rows / TT), static_cast<unsigned>(n));
  byte_transpose_kernel<<<grid, TT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, out, static_cast<int>(rows), static_cast<int>(cols));
  return static_cast<int>(cudaGetLastError());
}
