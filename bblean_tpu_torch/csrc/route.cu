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
// mask and a max (and argmax) per block.  The port ran each block as
// torch._int_mm plus about eight elementwise ops over an (M, block) f32
// block in device memory (ops/route.py keeps that as the plain version).
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
// tensor cores bound it, and the plain version's time (about 20x the
// bound) was spent writing and re-reading the (M, block) f32 blocks.
//
// == Design (right and simple first; wgmma and TMA are later work) ==
//
// Blocks of 128 rows x 128 group columns, 8 warps (4 along the rows x 2
// along the columns, each warp 32 x 64).  The K axis (F bytes) goes in
// steps of 64 bytes through a ring of kStages stages in shared memory, each
// stage the 128 x 64 B row tile and the 128 x 64 B centroid tile, filled
// with 16-byte cp.async copies (zero-filled past M, past g_num and past F)
// while earlier stages are multiplied.  The (G, F) centroid table is
// already K-contiguous, the "col" operand of
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, so it needs no
// transpose.  Each thread reads its fragments as 16-byte words: its four
// 32-bit words of a row's 64-byte step are the k slots (t, t + 4) of two
// consecutive k32 products, one permutation of k shared by A and B, which
// an exact integer dot product does not see; at a 64-byte row stride the
// 16-byte reads are free of bank conflicts.
//
// Epilogue in registers.  After a column tile's last K step each thread
// turns its 64 accumulators (4 rows x 16 columns) into sims and keeps a
// running (sim, c) per row (visited in rising c, strict >, so the first of
// equal sims stays); the (M, G) block never leaves the SM.  After the
// block's last tile the 4 threads of a quad reduce by shuffles and the two
// column warps through shared memory, by (larger sim, then smaller c).
//
// Filling the card.  At M = 8192 there are 64 row tiles; the live column
// tiles split into chunks on blockIdx.y, as many as keep all blocks
// resident at once (ops/route.py::_chunks; 2 blocks an SM).  Each block
// writes its chunk's partial (sim, c) per row into an (S, M) scratch; a
// second small kernel combines the chunks in column order with strict >,
// which keeps the smallest c of the largest sim: deterministic, and
// exactly the plain version's per-block first argmax with its strict-
// merge.  The twin keeps the max alone.
//
// Generic path.  cp.async needs 16-byte-aligned sources: when F % 16 != 0
// or a table is not 16-byte aligned, the kBulk = false instance fills the
// same stages with predicated byte loads (zero-filled tails) and ordinary
// shared-memory stores; the rest is the same kernel.  The wrapper counts
// its launches apart (ops/route.py generic_launches).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;  // rows of a block
constexpr int kTileN = 128;  // group columns of a block
constexpr int kTileK = 64;   // bytes of F a stage holds per row
constexpr int kStages = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStageBytes = (kTileM + kTileN) * kTileK;  // 16 KiB
constexpr int kSmemBytes = kStages * kStageBytes;         // 64 KiB
constexpr int kMinBlocks = 2;                             // resident per SM
constexpr int kCombineThreads = 256;
constexpr float kNeg = -2.0f;
constexpr int kNoColumn = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;
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
  int m, f, g_num, last_start, shift, tiles_per_chunk;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;  // 0: nothing is read, the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

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

// (sim, c) beats (best_sim, best_c): a larger sim, or an equal one at a
// smaller column
__device__ __forceinline__ bool better(float sim, int c, float best_sim, int best_c) {
  return sim > best_sim || (sim == best_sim && c < best_c);
}

// Fill stage `it % kStages` with K step `it % ksteps` of column tile
// `tile0 + it / ksteps`: 512 16-byte pieces of rows and 512 of centroids,
// two of each per thread
template <bool kBulk>
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* smem, int it, int ksteps,
                                           int row0, int tile0) {
  uint8_t* sa = smem + (it % kStages) * kStageBytes;
  uint8_t* sb = sa + kTileM * kTileK;
  const int tile = tile0 + it / ksteps;
  const int k0 = (it % ksteps) * kTileK;
#pragma unroll
  for (int j = 0; j < kTileM * 4 / kThreads; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int r = q >> 2;
    const int k = k0 + (q & 3) * 16;
    const int row = row0 + r;
    const int c = tile * kTileN + r;
    const bool ok_a = row < p.m && k < p.f;
    const bool ok_b = c < p.g_num && k < p.f;
    const int g_row = c + (c >= p.last_start ? p.shift : 0);
    const int8_t* src_a = ok_a ? p.rows + static_cast<int64_t>(row) * p.f + k : p.rows;
    const int8_t* src_b = ok_b ? p.g_cent + static_cast<int64_t>(g_row) * p.f + k : p.g_cent;
    uint8_t* dst_a = sa + r * kTileK + (q & 3) * 16;
    uint8_t* dst_b = sb + r * kTileK + (q & 3) * 16;
    if (kBulk) {
      cp_async16(dst_a, src_a, ok_a);
      cp_async16(dst_b, src_b, ok_b);
    } else {
      load16(dst_a, src_a, ok_a, p.f - k);
      load16(dst_b, src_b, ok_b, p.f - k);
    }
  }
}

template <bool kArgmax, bool kBulk>
__global__ void __launch_bounds__(kThreads, kMinBlocks) route_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red_sim[2][kTileM];
  __shared__ int red_idx[2][kTileM];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;  // mma groupID, thread in group
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int row0 = blockIdx.x * kTileM;
  const int col_tiles = (p.g_num + kTileN - 1) / kTileN;
  const int tile0 = blockIdx.y * p.tiles_per_chunk;
  const int tile1 = min(tile0 + p.tiles_per_chunk, col_tiles);
  const int ksteps = (p.f + kTileK - 1) / kTileK;
  const int n_iter = tile1 > tile0 ? (tile1 - tile0) * ksteps : 0;

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
    if (s < n_iter) load_stage<kBulk>(p, smem, s, ksteps, row0, tile0);
    cp_async_commit();
  }

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    // Stage it is in for every thread, and every thread is done with stage
    // it - 1, which the next load overwrites
    __syncthreads();
    if (it + kStages - 1 < n_iter) {
      load_stage<kBulk>(p, smem, it + kStages - 1, ksteps, row0, tile0);
    }
    cp_async_commit();

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
      const int tile = tile0 + it / ksteps;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = tile * kTileN + warp_n * 64 + ni * 8 + tq * 2 + e;
          if (c < p.g_num) {
            const int g_pop = __ldg(p.g_pops + c + (c >= p.last_start ? p.shift : 0));
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
  cp_async_wait<0>();

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

// One thread per row: the chunks' partials in column order.  A later chunk
// wins only when strictly better, so the smallest column of the largest
// sim stays; a chunk without a live column holds -2 and never wins.
template <bool kArgmax>
__global__ void __launch_bounds__(kCombineThreads) route_combine_kernel(
    const float* __restrict__ part_sim, const int32_t* __restrict__ part_idx,
    const uint8_t* __restrict__ pending, void* out, int m, int n_chunks) {
  const int r = blockIdx.x * kCombineThreads + threadIdx.x;
  if (r >= m) return;
  float best = kNeg;
  int idx = 0;
  for (int s = 0; s < n_chunks; ++s) {
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

template <bool kArgmax, bool kBulk>
int launch(const Params& p, const void* pending, void* out, int n_chunks, cudaStream_t stream) {
  auto kernel = route_kernel<kArgmax, kBulk>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.m + kTileM - 1) / kTileM, n_chunks);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  route_combine_kernel<kArgmax><<<(p.m + kCombineThreads - 1) / kCombineThreads,
                                  kCombineThreads, 0, stream>>>(
      p.part_sim, p.part_idx, static_cast<const uint8_t*>(pending), out, p.m, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows (which = 0) or group columns (which = 1) of one block
int bb_route_tile(int which) { return which == 0 ? kTileM : kTileN; }

// Blocks of the route kernel the card holds at once (SMs x blocks an SM),
// or a negative CUDA error
int bb_route_resident_blocks() {
  auto kernel = route_kernel<true, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           kSmemBytes)) != cudaSuccess)
    return -(int)err;
  return per_sm * n_sm;
}

// The route (argmax = 1: `pending` the (M,) bool mask, `part_idx` an
// (S, M) int32 scratch, `out` (M,) int32) or its twin (argmax = 0: both
// null, `out` (M,) f32), over live columns [0, g_num) in `n_chunks` chunks
// of `tiles_per_chunk` column tiles; `part_sim` is an (S, M) f32 scratch.
// `bulk` = 1 takes the cp.async path (F % 16 == 0 and 16-byte-aligned
// tables, else the launch is refused); 0 the generic path.  Two launches
// on `stream` (the product, then the chunks' combination); returns
// cudaGetLastError() after them (0 = ok).
int bb_route(const void* rows, const void* pops, const void* g_cent, const void* g_pops,
             const void* pending, void* part_sim, void* part_idx, void* out, int m, int f,
             int g_num, int last_start, int shift, int n_chunks, int tiles_per_chunk,
             int argmax, int bulk, void* stream) {
  if (m < 1 || f < 1 || g_num < 1 || n_chunks < 1 || n_chunks > 65535 || tiles_per_chunk < 1 ||
      (argmax && (pending == nullptr || part_idx == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (bulk && (f % 16 != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(g_cent) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{static_cast<const int8_t*>(rows),   static_cast<const int32_t*>(pops),
                 static_cast<const int8_t*>(g_cent), static_cast<const int32_t*>(g_pops),
                 static_cast<float*>(part_sim),      static_cast<int32_t*>(part_idx),
                 m, f, g_num, last_start, shift, tiles_per_chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  if (argmax) {
    return bulk ? launch<true, true>(p, pending, out, n_chunks, s)
                : launch<true, false>(p, pending, out, n_chunks, s);
  }
  return bulk ? launch<false, true>(p, pending, out, n_chunks, s)
              : launch<false, false>(p, pending, out, n_chunks, s);
}

}  // extern "C"
