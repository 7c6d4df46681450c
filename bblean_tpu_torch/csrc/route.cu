// Group route for NVIDIA Hopper (sm_90a): an int8 tensor-core product of
// rows against the live group centroids with the Tanimoto and the first
// argmax (the route) or the max (its twin) fused into the epilogue.
//
// == What it replaces ==
//
// bblean_tpu/engine/batch.py::_route_groups (:203-244) and
// bblean_tpu/parallel/sharded.py::_best_group_sim (:117-148).  Neither is a
// Pallas kernel: each is an XLA program, a lax.fori_loop over blocks of
// `block` groups of an int8 dot_general on the MXU, then the Tanimoto, the
// mask and a max (and argmax) per block.  ops/route.py keeps that chain
// (torch._int_mm per block plus elementwise ops) as the plain version.
//
// Contract, equal to the plain version bit for bit.  Logical column
// c = b * block + j reads centroid row s0 + j, s0 = min(b * block,
// G_cap - block): only the last block can be clamped, so the wrapper passes
// its first column `last_start` and the shift of its rows
// (row = c + shift for c >= last_start, else c).  inter is the int32 dot
// product of the 0/1 planes; sim = f32(inter) / max(f32(pop_r + pop_g) -
// f32(inter), 1) with IEEE round-to-nearest division (__fdiv_rn; the build
// uses no fast-math); columns c >= g_num score nothing.  Route: the
// smallest c among the columns of largest sim, from (-2, 0), 0 where the
// row is not pending.  Twin: the largest sim, from -2.
//
// == The bound ==
//
// At the engine's shapes the work is the product: 2 * M * G * F int8
// operations (M = 8192 rows, F = 2048 bits, G live groups) over 1,979 TOP/s
// (H100 SXM, dense int8) is 0.729 ms at G = 43,008, while the bytes (rows
// and live centroids once, ~105 MB) take 0.031 ms at 3.35 TB/s.  So the
// tensor cores bound it.  A 128 x 256 tile does 2 * 128 * 256 int8
// operations for each (128 + 256) bytes of K it reads from L2: about 171
// operations a byte, or 11.6 TB/s of L2 reads at the int8 peak.
//
// == Design: the TMA path (route_wgmma_kernel) ==
//
// Persistent and warp-specialised: one block of three warpgroups on each
// SM.  Warpgroup 0 gives its registers away (setmaxnreg 40) and one of its
// threads keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle) in
// flight through a ring of kStages stages, each the 128 x 128 B row tile
// and the 256 x 128 B centroid tile (48 KiB), guarded by a full and an
// empty mbarrier.  Warpgroups 1 and 2 (setmaxnreg 232) each multiply 64 of
// the 128 rows by the 256 columns with wgmma.mma_async m64n256k32
// s32.s8.s8, A and B both read from shared memory through descriptors:
// rows (M, F) and centroids (G_cap, F) are both K-major already, the only
// layout wgmma takes for 8-bit types, so nothing is transposed.  Each
// thread holds 128 int32 sums: 2 rows x 64 columns of the tile.
//
// Work units are (row tile, column range): the wrapper (ops/route.py::
// _plan) cuts the live columns into ranges of `span` columns, with a range
// boundary at `last_start`, so no tile mixes shifted and unshifted rows:
// the last range's tiles start at `last_start` and the TMA coordinate of
// their rows is shifted.  TMA zero-fills past G_cap, past M and past F;
// columns at or past the range's end are masked in the epilogue.  The
// grid is min(units, SMs); block b walks units b, b + grid, ... in
// row-tile-fastest order, so the blocks running at once share a few
// column ranges and the centroids they read stay in L2.
//
// The epilogue runs in registers after each column tile, keeping a running
// best per row across the unit's tiles; after the unit the four threads of
// a quad (the same rows, other columns) reduce by shuffles and one of them
// writes the unit's partial into the (S, M) scratch.  route_combine_kernel
// combines the ranges' partials in column order with strict >, which keeps
// the smallest c of the largest sim: exactly the plain version's per-block
// first argmax with its strict cross-block merge.
//
// A division-free running argmax.  inter and union are integers below
// 2^24, exact in f32, so sim is the correctly rounded quotient fl(i/u) of
// the exact fraction, and round-to-nearest is monotone: i/u <= i'/u'
// implies fl(i/u) <= fl(i'/u').  So the first column of the largest sim is
// found without dividing: each thread visits its columns in rising c and
// keeps the exact record (i, u) (a column beats it when i * u_best >
// i_best * u: int32 products below 2 F^2, exact up to the path's F <=
// 16,384), with two products, a compare and three selects a pair and no
// branch.  The record's column is the answer unless a new record rounds to
// the same f32 as the one it replaced (a near tie), when the earlier column
// must stay: that needs i * u_best >= 2^22 (route_tile), which true
// popcounts at F <= 2048 all but rule out.  A warp whose lanes passed such
// a record takes the tile again from its starting state, dividing at each
// record.  After the unit each row divides once (its record's f32 sim);
// between threads and ranges the f32 values are compared (better()).  The
// twin keeps the exact record alone: fl(max) = max(fl).  Why branch-free:
// any branch per pair unrolls into 128 branch sites a tile; on an H100 a
// short-circuit `ok && a * b > c * d` alone made the twin 1.8x slower, so
// both products are computed before the compare.
//
// == The generic path (route_kernel) ==
//
// TMA needs 16-byte row strides and 16-byte-aligned tables, and the skip
// rule exact products (F <= 16,384): where F % 16 != 0, F > 16,384 or a
// table is not aligned, a non-persistent kernel (128 x 128
// blocks of 8 warps, mma.sync.m16n8k32 int8, predicated byte loads into a
// 4-stage ring, __fdiv_rn per pair) runs over the same column ranges, one
// block per (row tile, range).  The wrapper counts its launches apart
// (ops/route.py generic_launches).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -2.0f;
constexpr int kNoColumn = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kCombineThreads = 256;

// The column ranges of one call: range s < s1 is [s * span, min((s + 1) *
// span, seg1_end)) with unshifted rows; range s >= s1 starts at seg1_end
// (the clamped last block's first column when shift != 0) and reads row
// c + shift
struct Ranges {
  int span, s1, seg1_end, shift, g_num;
};

__device__ __forceinline__ void range_of(const Ranges& r, int s, int& c0, int& c1, int& sh) {
  if (s < r.s1) {
    c0 = s * r.span;
    c1 = min(c0 + r.span, r.seg1_end);
    sh = 0;
  } else {
    c0 = r.seg1_end + (s - r.s1) * r.span;
    c1 = min(c0 + r.span, r.g_num);
    sh = r.shift;
  }
}

// (sim, c) beats (best_sim, best_c): a larger sim, or an equal one at a
// smaller column
__device__ __forceinline__ bool better(float sim, int c, float best_sim, int best_c) {
  return sim > best_sim || (sim == best_sim && c < best_c);
}

// ---------------------------------------------------------------------------
// The TMA path: persistent, warp-specialised wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 128;  // rows of a tile (two consumer warpgroups x 64)
constexpr int kBN = 256;  // group columns of a tile
constexpr int kBK = 128;  // bytes of F a stage holds per row (one swizzle row)
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kABytes = kBM * kBK;               // 16 KiB
constexpr int kBBytes = kBN * kBK;               // 32 KiB
constexpr int kStageBytes = kABytes + kBBytes;   // 48 KiB
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + 1 KiB to align
constexpr int kAcc = kBN / 2;                    // int32 sums a thread
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// Widest rows the TMA path takes: the skip rule's products i * u stay below
// 2 F^2 <= 2^29, exact in int32
constexpr int kMaxF = 16384;

struct Params {
  const int32_t* pops;    // (M,)
  const int32_t* g_pops;  // (G_cap,)
  float* part_sim;        // (S, M)
  int32_t* part_idx;      // (S, M), route only
  Ranges ranges;
  int m, f, row_tiles, n_ranges;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One box of a 2-D tensor map into shared memory; x is the K byte, y the row
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// Descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle that
// TMA wrote: 8-row atoms of 1,024 bytes (stride 64 x 16 B), the leading
// offset unused, the tile 1,024-byte aligned (base offset 0)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// The sums are read only after this: it orders them after wgmma_wait
__device__ __forceinline__ void fence_acc(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256 int32) (+)= A (64 x 32 B) . B (256 x 32 B)^T; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[kAcc], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// A new record's product i * u_best below this rules out an f32 near tie
// with the record it replaces (see route_tile)
constexpr int kNearTie = 1 << 22;

// The twin's epilogue over one tile: the exact largest i / u of the thread's
// columns below c1 (branch-free: two products and a compare a pair)
__device__ __forceinline__ void twin_tile(const int (&acc)[kAcc], const int32_t* g_pops, int col,
                                          int c1, int sh, int q, const int (&row_pop)[2],
                                          int (&best_i)[2], int (&best_u)[2]) {
#pragma unroll
  for (int b = 0; b < kBN / 8; ++b) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col + 8 * b + 2 * q + e;
      const bool ok = c < c1;
      const int g_pop = ok ? __ldg(g_pops + c + sh) : 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int inter = acc[4 * b + 2 * h + e];
        const int uni = max(row_pop[h] + g_pop - inter, 1);
        // Both products first: `ok && a * b > c * d` would branch
        const int prod = inter * best_u[h], other = best_i[h] * uni;
        const bool win = ok && prod > other;
        best_i[h] = win ? inter : best_i[h];
        best_u[h] = win ? uni : best_u[h];
      }
    }
  }
}

// The route's tile again from the state it started with (state: i, u, c of
// row 0, then of row 1), dividing at each record to tell near ties apart.
// Out of line, over a copy of the sums in local memory: only warps that
// passed a record with i * u_best >= 2^22 come here, and the fast pass
// keeps its registers.
__device__ __noinline__ void route_tile_exact(const int* acc, const int32_t* g_pops, int col,
                                              int c1, int sh, int q, int pop0, int pop1,
                                              int* state) {
  const int row_pop[2] = {pop0, pop1};
  float best_sim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best_sim[h] = __fdiv_rn(static_cast<float>(state[3 * h]), static_cast<float>(state[3 * h + 1]));
  }
#pragma unroll 1
  for (int b = 0; b < kBN / 8; ++b) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col + 8 * b + 2 * q + e;
      const bool ok = c < c1;
      const int g_pop = ok ? __ldg(g_pops + c + sh) : 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int inter = acc[4 * b + 2 * h + e];
        const int uni = max(row_pop[h] + g_pop - inter, 1);
        const int prod = inter * state[3 * h + 1], other = state[3 * h] * uni;
        if (ok && prod > other) {
          const float sim = __fdiv_rn(static_cast<float>(inter), static_cast<float>(uni));
          if (sim > best_sim[h]) {  // else a near tie: the earlier column stays
            best_sim[h] = sim;
            state[3 * h + 2] = c;
          }
          state[3 * h] = inter;
          state[3 * h + 1] = uni;
        }
      }
    }
  }
}

// The route's epilogue over one tile.  State per row: the exact record
// (best_i, best_u), the first of the columns of largest i / u, and best_c,
// the first column whose f32 quotient equals the record's.  Each new record
// has a larger f32 quotient than the one it replaces, so best_c moves to
// it, unless the two round to the same f32 (a near tie): then best_c stays.
// Two distinct fractions i/u > i'/u' share an f32 only if their difference
// D / (u u') is below 2^-22 i / u, i.e. D = i u' - i' u <= i u' / 2^22, which
// needs i u' >= 2^22 (never at F <= 2048 with true popcounts, where i u' <=
// 2^22 and D >= 1 rule it out but for i = u' = 2048).  So a branch-free pass
// moves best_c with every record and notes any record with i u' >= 2^22;
// where a lane of the warp noted one, route_tile_exact takes the tile again.
__device__ __forceinline__ void route_tile(const int (&acc)[kAcc], const int32_t* g_pops, int col,
                                           int c1, int sh, int q, const int (&row_pop)[2],
                                           int (&best_i)[2], int (&best_u)[2], int (&best_c)[2]) {
  int state[6] = {best_i[0], best_u[0], best_c[0], best_i[1], best_u[1], best_c[1]};
  int wide = 0;  // bits at or above 2^22: a near tie may have been passed over
#pragma unroll
  for (int b = 0; b < kBN / 8; ++b) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col + 8 * b + 2 * q + e;
      const bool ok = c < c1;
      const int g_pop = ok ? __ldg(g_pops + c + sh) : 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int inter = acc[4 * b + 2 * h + e];
        const int uni = max(row_pop[h] + g_pop - inter, 1);
        const int prod = inter * best_u[h], other = best_i[h] * uni;
        const bool win = ok && prod > other;
        wide |= win ? prod : 0;
        best_i[h] = win ? inter : best_i[h];
        best_u[h] = win ? uni : best_u[h];
        best_c[h] = win ? c : best_c[h];
      }
    }
  }
  if (__any_sync(kAll, wide >= kNearTie)) {
    int copy[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) copy[i] = acc[i];
    route_tile_exact(copy, g_pops, col, c1, sh, q, row_pop[0], row_pop[1], state);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_i[h] = state[3 * h];
      best_u[h] = state[3 * h + 1];
      best_c[h] = state[3 * h + 2];
    }
  }
}

template <bool kArgmax>
__global__ void __launch_bounds__(kThreads, 1)
    route_wgmma_kernel(const __grid_constant__ CUtensorMap tm_rows,
                       const __grid_constant__ CUtensorMap tm_cent, Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n_units = p.row_tiles * p.n_ranges;
  const int ksteps = (p.f + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_rows)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_cent)) : "memory");
      int it = 0;
      for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
        const int s = unit / p.row_tiles;
        const int row0 = (unit - s * p.row_tiles) * kBM;
        int c0, c1, sh;
        range_of(p.ranges, s, c0, c1, sh);
        for (int col = c0; col < c1; col += kBN) {
          for (int k = 0; k < ksteps; ++k, ++it) {
            const int stage = it % kStages;
            const uint32_t phase = (it / kStages) & 1;
            mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
            const uint32_t full = smem_u32(&full_bar[stage]);
            mbar_expect_tx(full, kStageBytes);
            const uint32_t a = base + stage * kStageBytes;
            tma_load(a, &tm_rows, full, k * kBK, row0);
            tma_load(a + kABytes, &tm_cent, full, k * kBK, col + sh);
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: rows 64 * cw .. 64 * cw + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int q = lane & 3;
    int acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    int it = 0;
    for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
      const int s = unit / p.row_tiles;
      const int row0 = (unit - s * p.row_tiles) * kBM;
      int c0, c1, sh;
      range_of(p.ranges, s, c0, c1, sh);
      // The thread's rows: h = 0, 1 is row r0 + 8 h; sums acc[4 b + 2 h + e]
      // hold column 8 b + 2 q + e of the tile
      const int r0 = row0 + cw * 64 + warp * 16 + (lane >> 2);
      int row_pop[2], best_i[2], best_u[2], best_c[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row_pop[h] = r0 + 8 * h < p.m ? p.pops[r0 + 8 * h] : 0;
        best_i[h] = -2;
        best_u[h] = 1;
        best_c[h] = kNoColumn;
      }
      for (int col = c0; col < c1; col += kBN) {
        for (int k = 0; k < ksteps; ++k, ++it) {
          const int stage = it % kStages;
          mbar_wait(smem_u32(&full_bar[stage]), (it / kStages) & 1);
          const uint32_t a = base + stage * kStageBytes + cw * 64 * kBK;
          const uint64_t desc_a = sw128_desc(a);
          const uint64_t desc_b = sw128_desc(base + stage * kStageBytes + kABytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 32; ++kk) {
            // 32 bytes of K further along the swizzled rows: + 2 x 16 B
            wgmma_m64n256k32(acc, desc_a + 2 * kk, desc_b + 2 * kk, (k | kk) != 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done with it
          if (k > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[(it - 1) % kStages]));
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(smem_u32(&empty_bar[(it - 1) % kStages]));
        fence_acc(acc);
        if (kArgmax) {
          route_tile(acc, p.g_pops, col, c1, sh, q, row_pop, best_i, best_u, best_c);
        } else {
          twin_tile(acc, p.g_pops, col, c1, sh, q, row_pop, best_i, best_u);
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // The record's f32 quotient: that of best_c's column too
        float best_sim = __fdiv_rn(static_cast<float>(best_i[h]), static_cast<float>(best_u[h]));
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float o_sim = __shfl_xor_sync(kAll, best_sim, off);
          if (kArgmax) {
            const int o_c = __shfl_xor_sync(kAll, best_c[h], off);
            if (better(o_sim, o_c, best_sim, best_c[h])) {
              best_sim = o_sim;
              best_c[h] = o_c;
            }
          } else {
            best_sim = fmaxf(best_sim, o_sim);
          }
        }
        const int r = r0 + 8 * h;
        if (q == 0 && r < p.m) {
          p.part_sim[static_cast<int64_t>(s) * p.m + r] = best_sim;
          if (kArgmax) p.part_idx[static_cast<int64_t>(s) * p.m + r] = best_c[h];
        }
      }
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The generic path: mma.sync with byte loads, one block per (row tile, range)
// ---------------------------------------------------------------------------

namespace generic {

constexpr int kTileM = 128;  // rows of a block
constexpr int kTileN = 128;  // group columns of a block
constexpr int kTileK = 64;   // bytes of F a stage holds per row
constexpr int kStages = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStageBytes = (kTileM + kTileN) * kTileK;  // 16 KiB
constexpr int kSmemBytes = kStages * kStageBytes;         // 64 KiB
// load_stage gives each thread the same number of 16-byte pieces, and one
// index r runs over the rows of the row tile and the columns of the
// centroid tile
static_assert(kTileM == kTileN && kTileM * 4 % kThreads == 0, "stage layout");

struct Params {
  const int8_t* rows;     // (M, F) 0/1
  const int32_t* pops;    // (M,)
  const int8_t* g_cent;   // (G_cap, F) 0/1
  const int32_t* g_pops;  // (G_cap,)
  float* part_sim;        // (S, M)
  int32_t* part_idx;      // (S, M), route only
  Ranges ranges;
  int m, f;
};

// 16 bytes from `src` (the first `left` of them, when fewer) into shared
// memory by byte loads, the rest zero
__device__ __forceinline__ void load16(uint8_t* dst, const int8_t* src, bool ok, int left) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (ok) {
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (b < left) w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b & 3));
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fill stage `it % kStages` with K step `it % ksteps` of the column tile at
// `col0 + (it / ksteps) * kTileN` (columns below c1, rows shifted by sh):
// 512 16-byte pieces of rows and 512 of centroids, two of each per thread
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* smem, int it, int ksteps,
                                           int row0, int col0, int c1, int sh) {
  uint8_t* sa = smem + (it % kStages) * kStageBytes;
  uint8_t* sb = sa + kTileM * kTileK;
  const int col = col0 + (it / ksteps) * kTileN;
  const int k0 = (it % ksteps) * kTileK;
#pragma unroll
  for (int j = 0; j < kTileM * 4 / kThreads; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int r = q >> 2;
    const int k = k0 + (q & 3) * 16;
    const int row = row0 + r;
    const int c = col + r;
    const bool ok_a = row < p.m && k < p.f;
    const bool ok_b = c < c1 && k < p.f;
    const int8_t* src_a = ok_a ? p.rows + static_cast<int64_t>(row) * p.f + k : p.rows;
    const int8_t* src_b = ok_b ? p.g_cent + static_cast<int64_t>(c + sh) * p.f + k : p.g_cent;
    load16(sa + r * kTileK + (q & 3) * 16, src_a, ok_a, p.f - k);
    load16(sb + r * kTileK + (q & 3) * 16, src_b, ok_b, p.f - k);
  }
}

template <bool kArgmax>
__global__ void __launch_bounds__(kThreads, 2) route_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red_sim[2][kTileM];
  __shared__ int red_idx[2][kTileM];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;  // mma groupID, thread in group
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int row0 = blockIdx.x * kTileM;
  int c0, c1, sh;
  range_of(p.ranges, blockIdx.y, c0, c1, sh);
  const int ksteps = (p.f + kTileK - 1) / kTileK;
  const int n_iter = (c1 - c0 + kTileN - 1) / kTileN * ksteps;

  // The thread's four epilogue rows: i = 2 * mi + h is row
  // warp_m * 32 + mi * 16 + h * 8 + grp of the block
  int row_pop[4];
  float best_sim[4];
  int best_c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + warp_m * 32 + (i >> 1) * 16 + (i & 1) * 8 + grp;
    row_pop[i] = r < p.m ? p.pops[r] : 0;
    best_sim[i] = kNeg;
    best_c[i] = kNoColumn;
  }

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_stage(p, smem, s, ksteps, row0, c0, c1, sh);
  }

  for (int it = 0; it < n_iter; ++it) {
    // Stage it is in for every thread, and every thread is done with stage
    // it - 1, which the next load overwrites
    __syncthreads();
    if (it + kStages - 1 < n_iter) load_stage(p, smem, it + kStages - 1, ksteps, row0, c0, c1, sh);

    const uint8_t* sa = smem + (it % kStages) * kStageBytes;
    const uint8_t* sb = sa + kTileM * kTileK;
    uint4 a[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = warp_m * 32 + mi * 16 + grp;
      a[mi][0] = *reinterpret_cast<const uint4*>(sa + r * kTileK + tq * 16);
      a[mi][1] = *reinterpret_cast<const uint4*>(sa + (r + 8) * kTileK + tq * 16);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = warp_n * 64 + ni * 8 + grp;
      const uint4 b = *reinterpret_cast<const uint4*>(sb + n * kTileK + tq * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_s8(acc[mi][ni], a[mi][0].x, a[mi][1].x, a[mi][0].y, a[mi][1].y, b.x, b.y);
        mma_s8(acc[mi][ni], a[mi][0].z, a[mi][1].z, a[mi][0].w, a[mi][1].w, b.z, b.w);
      }
    }

    if (it % ksteps == ksteps - 1) {  // the column tile's last K step
      const int col = c0 + it / ksteps * kTileN;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + warp_n * 64 + ni * 8 + tq * 2 + e;
          if (c < c1) {
            const int g_pop = __ldg(p.g_pops + c + sh);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float inter = static_cast<float>(acc[i >> 1][ni][(i & 1) * 2 + e]);
              const float uni = fmaxf(static_cast<float>(row_pop[i] + g_pop) - inter, 1.0f);
              const float sim = __fdiv_rn(inter, uni);
              if (kArgmax) {
                if (sim > best_sim[i]) {
                  best_sim[i] = sim;
                  best_c[i] = c;
                }
              } else {
                best_sim[i] = fmaxf(best_sim[i], sim);
              }
            }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    }
  }

  // The quad's four threads hold the same rows over other columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float o_sim = __shfl_xor_sync(kAll, best_sim[i], off);
      if (kArgmax) {
        const int o_c = __shfl_xor_sync(kAll, best_c[i], off);
        if (better(o_sim, o_c, best_sim[i], best_c[i])) {
          best_sim[i] = o_sim;
          best_c[i] = o_c;
        }
      } else {
        best_sim[i] = fmaxf(best_sim[i], o_sim);
      }
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp_m * 32 + (i >> 1) * 16 + (i & 1) * 8 + grp;
      red_sim[warp_n][r] = best_sim[i];
      red_idx[warp_n][r] = best_c[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < kTileM && row0 + threadIdx.x < p.m) {
    const int r = threadIdx.x;
    float s = red_sim[0][r];
    int c = red_idx[0][r];
    if (kArgmax) {
      if (better(red_sim[1][r], red_idx[1][r], s, c)) {
        s = red_sim[1][r];
        c = red_idx[1][r];
      }
      p.part_idx[static_cast<int64_t>(blockIdx.y) * p.m + row0 + r] = c;
    } else {
      s = fmaxf(s, red_sim[1][r]);
    }
    p.part_sim[static_cast<int64_t>(blockIdx.y) * p.m + row0 + r] = s;
  }
}

}  // namespace generic

// One thread per row: the ranges' partials in column order.  A later range
// wins only when strictly better, so the smallest column of the largest
// sim stays.
template <bool kArgmax>
__global__ void __launch_bounds__(kCombineThreads) route_combine_kernel(
    const float* __restrict__ part_sim, const int32_t* __restrict__ part_idx,
    const uint8_t* __restrict__ pending, void* out, int m, int n_ranges) {
  const int r = blockIdx.x * kCombineThreads + threadIdx.x;
  if (r >= m) return;
  float best = kNeg;
  int idx = 0;
  for (int s = 0; s < n_ranges; ++s) {
    const float v = part_sim[static_cast<int64_t>(s) * m + r];
    if (kArgmax) {
      if (v > best) {
        best = v;
        idx = part_idx[static_cast<int64_t>(s) * m + r];
      }
    } else {
      best = fmaxf(best, v);
    }
  }
  if (kArgmax) {
    static_cast<int32_t*>(out)[r] = pending[r] ? idx : 0;
  } else {
    static_cast<float*>(out)[r] = best;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a (rows, f) uint8 table: boxes of 128 bytes x box_rows rows
// in the 128-byte swizzle, zero-filled out of bounds
CUresult encode_table(CUtensorMap* map, const void* ptr, int rows, int f, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(f), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(f)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(wg::kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Offset of a failed tensor-map encoding in bb_route's return value
constexpr int kEncodeError = 100000;

template <bool kArgmax>
int launch_wgmma(const void* rows, const void* g_cent, int g_cap, const wg::Params& p, int grid,
                 cudaStream_t stream) {
  CUtensorMap tm_rows, tm_cent;
  CUresult res = encode_table(&tm_rows, rows, p.m, p.f, wg::kBM);
  if (res == CUDA_SUCCESS) res = encode_table(&tm_cent, g_cent, g_cap, p.f, wg::kBN);
  if (res != CUDA_SUCCESS) return kEncodeError + (int)res;
  auto kernel = wg::route_wgmma_kernel<kArgmax>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, wg::kThreads, wg::kSmemBytes, stream>>>(tm_rows, tm_cent, p);
  return (int)cudaGetLastError();
}

template <bool kArgmax>
int launch_generic(const generic::Params& p, int n_ranges, cudaStream_t stream) {
  auto kernel = generic::route_kernel<kArgmax>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         generic::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.m + generic::kTileM - 1) / generic::kTileM, n_ranges);
  kernel<<<grid, generic::kThreads, generic::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kArgmax>
int launch_combine(const float* part_sim, const int32_t* part_idx, const void* pending, void* out,
                   int m, int n_ranges, cudaStream_t stream) {
  route_combine_kernel<kArgmax><<<(m + kCombineThreads - 1) / kCombineThreads, kCombineThreads,
                                  0, stream>>>(
      part_sim, part_idx, static_cast<const uint8_t*>(pending), out, m, n_ranges);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows (which = 0) or group columns (which = 1) of one tile of the TMA path
int bb_route_tile(int which) { return which == 0 ? wg::kBM : wg::kBN; }

// The route (argmax = 1: `pending` the (M,) bool mask, `part_idx` an
// (S, M) int32 scratch, `out` (M,) int32) or its twin (argmax = 0: both
// null, `out` (M,) f32) over live columns [0, g_num) of a (g_cap, f)
// table, in `n_ranges` column ranges of `span` columns (range_of: `s1`
// ranges below `seg1_end`, the rest from it with rows shifted by
// `shift`); `part_sim` is an (S, M) f32 scratch.  tma = 1 takes the TMA
// path on `grid` persistent blocks (f % 16 == 0, f <= 16,384 and
// 16-byte-aligned tables, else the launch is refused); 0 the generic path.  Two launches
// on `stream` (the product, then the ranges' combination); returns 0, a
// CUDA error after them, or kEncodeError + the CUresult of a tensor map
// that could not be encoded.
int bb_route(const void* rows, const void* pops, const void* g_cent, const void* g_pops,
             const void* pending, void* part_sim, void* part_idx, void* out, int m, int f,
             int g_cap, int g_num, int span, int s1, int seg1_end, int shift, int n_ranges,
             int grid, int argmax, int tma, void* stream) {
  if (m < 1 || f < 1 || g_num < 1 || g_cap < g_num || span < 1 || n_ranges < 1 ||
      n_ranges > 65535 || s1 < 0 || s1 > n_ranges || seg1_end > g_num || grid < 1 ||
      (argmax && (pending == nullptr || part_idx == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (tma && (f % 16 != 0 || f > wg::kMaxF || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(g_cent) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Ranges ranges{span, s1, seg1_end, shift, g_num};
  const cudaStream_t s = (cudaStream_t)stream;
  float* psim = static_cast<float*>(part_sim);
  int32_t* pidx = static_cast<int32_t*>(part_idx);
  int err;
  if (tma) {
    const wg::Params p{static_cast<const int32_t*>(pops), static_cast<const int32_t*>(g_pops),
                       psim, pidx, ranges, m, f, (m + wg::kBM - 1) / wg::kBM, n_ranges};
    err = argmax ? launch_wgmma<true>(rows, g_cent, g_cap, p, grid, s)
                 : launch_wgmma<false>(rows, g_cent, g_cap, p, grid, s);
  } else {
    const generic::Params p{static_cast<const int8_t*>(rows),   static_cast<const int32_t*>(pops),
                            static_cast<const int8_t*>(g_cent), static_cast<const int32_t*>(g_pops),
                            psim, pidx, ranges, m, f};
    err = argmax ? launch_generic<true>(p, n_ranges, s) : launch_generic<false>(p, n_ranges, s);
  }
  if (err != 0) return err;
  return argmax ? launch_combine<true>(psim, pidx, pending, out, m, n_ranges, s)
                : launch_combine<false>(psim, pidx, pending, out, m, n_ranges, s);
}

}  // extern "C"
