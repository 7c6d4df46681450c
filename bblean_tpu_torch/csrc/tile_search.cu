// Sorted in-group packed-Tanimoto tile search for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bblean_tpu/ops/pallas_search2.py::_kernel
// (called through _run_planned, tile_search_planned and tile_search_sorted).
// Contract, equal to bblean_tpu/engine/batch.py::_search_tiles: for every
// row, score each cell of its routed group's packed-centroid tile with
//   inter = popc(row & cell),
//   sim   = f32(inter) / f32(max(pop_cell + pop_row - inter, 1)),
// set cells with slot < 0 to -2, take the argmax (lowest cell index on
// ties) and return (best_sim, max(best_slot, 0)).  Rows that are not
// pending get (-2, 0).  Rows arrive sorted by routed group; the outputs are
// written back in the caller's row order (the unsort is folded into the
// stores, and so is the pending mask).
//
// What bounds it on the card: at M = 8192 rows, Fc = 256 cells and
// F8 = 256 bytes a round does 8192 * 256 * 32 popc64 (67M) and reads 2 MiB
// of rows plus D tiles of 64 KiB, D being the number of distinct routed
// groups (from a handful at t = 0.3 up to thousands at t = 0.65).  A gather
// of one tile per row, as the plain version does, would move
// 8192 * 64 KiB = 512 MiB instead.
//
// Design (simple first): one thread block takes a chunk of kRowsPerBlock
// consecutive sorted rows.  For each run of equal group keys in the chunk
// it stages that group's tile once in dynamic shared memory (64-bit words,
// the row stride padded to an odd number of words so that the 16 lanes of
// a half-warp reading one word of 16 different cells hit 16 different bank
// pairs), together with the cells' popcounts and slots.  Each warp then
// takes one row of the run: each lane scores cells lane, lane + 32, ...,
// keeps its first best, and the warp reduces with shuffles, preferring the
// lower cell index on equal sims.  Runs with no pending row skip the
// staging.  Division is IEEE round-to-nearest (__fdiv_rn, and the build
// uses no fast-math), so the sims equal the plain version's bit for bit.
// A byte tail (F8 % 8 != 0) is zero-padded into the last word.  No TMA,
// wgmma or double buffering yet: a row-per-warp block walks its runs in
// order, and tuning is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 32;

__device__ __forceinline__ unsigned long long load_word(
    const uint8_t* __restrict__ p, int w, int f8, bool aligned) {
  if (aligned) {
    return reinterpret_cast<const unsigned long long*>(p)[w];
  }
  unsigned long long v = 0;
  const int b0 = w * 8;
  for (int b = 0; b < 8; ++b) {
    const int idx = b0 + b;
    if (idx < f8) v |= static_cast<unsigned long long>(p[idx]) << (8 * b);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) tile_search_kernel(
    const uint8_t* __restrict__ srows,   // (M, F8) rows, sorted by key
    const int32_t* __restrict__ spops,   // (M,) row popcounts, sorted
    const int32_t* __restrict__ skey,    // (M,) routed group per sorted row
    const int64_t* __restrict__ order,   // (M,) sorted position -> row
    const uint8_t* __restrict__ t_pk,    // (G, Fc, F8)
    const int32_t* __restrict__ t_pops,  // (G, Fc)
    const int32_t* __restrict__ t_slot,  // (G, Fc)
    const uint8_t* __restrict__ pending, // (M,) bool, row order
    float* __restrict__ out_sim,         // (M,) row order
    int32_t* __restrict__ out_slot,      // (M,) row order
    int m, int fc, int f8, int words, int stride, int aligned_i) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* tile = smem;                      // fc * stride
  unsigned long long* rowbuf = tile + (size_t)fc * stride;  // kWarps * words
  int32_t* cell_pop = reinterpret_cast<int32_t*>(rowbuf + kWarps * words);
  int32_t* cell_slot = cell_pop + fc;

  const bool aligned = aligned_i != 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int begin = blockIdx.x * kRowsPerBlock;
  const int end = min(begin + kRowsPerBlock, m);
  unsigned long long* my_row = rowbuf + warp * words;

  int s = begin;
  while (s < end) {
    const int g = skey[s];
    int e = s + 1;
    while (e < end && skey[e] == g) ++e;

    int any_local = 0;
    for (int r = s + threadIdx.x; r < e; r += kThreads) {
      any_local |= pending[order[r]] != 0;
    }
    const int any = __syncthreads_or(any_local);

    if (any) {
      const uint8_t* src = t_pk + (size_t)g * fc * f8;
      const int n_words = fc * words;
      for (int i = threadIdx.x; i < n_words; i += kThreads) {
        const int c = i / words;
        const int w = i - c * words;
        tile[(size_t)c * stride + w] = load_word(src + (size_t)c * f8, w, f8, aligned);
      }
      for (int c = threadIdx.x; c < fc; c += kThreads) {
        cell_pop[c] = t_pops[(size_t)g * fc + c];
        cell_slot[c] = t_slot[(size_t)g * fc + c];
      }
      __syncthreads();

      for (int r = s + warp; r < e; r += kWarps) {
        const int64_t row = order[r];
        if (!pending[row]) {
          if (lane == 0) {
            out_sim[row] = -2.0f;
            out_slot[row] = 0;
          }
          continue;
        }
        const uint8_t* rp = srows + (size_t)r * f8;
        for (int w = lane; w < words; w += 32) my_row[w] = load_word(rp, w, f8, aligned);
        __syncwarp();
        const int row_pop = spops[r];

        float best = -3.0f;  // below every sim, so each lane's first cell wins
        int best_c = 0x7fffffff;
        for (int c = lane; c < fc; c += 32) {
          const unsigned long long* cell = tile + (size_t)c * stride;
          int inter = 0;
          for (int w = 0; w < words; ++w) inter += __popcll(cell[w] & my_row[w]);
          const int uni = max(cell_pop[c] + row_pop - inter, 1);
          const float sim = cell_slot[c] >= 0
                                ? __fdiv_rn(static_cast<float>(inter), static_cast<float>(uni))
                                : -2.0f;
          if (sim > best) {
            best = sim;
            best_c = c;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float o_best = __shfl_xor_sync(0xffffffffu, best, off);
          const int o_c = __shfl_xor_sync(0xffffffffu, best_c, off);
          if (o_best > best || (o_best == best && o_c < best_c)) {
            best = o_best;
            best_c = o_c;
          }
        }
        if (lane == 0) {
          out_sim[row] = best;
          out_slot[row] = max(cell_slot[best_c], 0);
        }
        __syncwarp();  // my_row is rewritten for the warp's next row
      }
    } else {
      for (int r = s + threadIdx.x; r < e; r += kThreads) {
        const int64_t row = order[r];
        out_sim[row] = -2.0f;
        out_slot[row] = 0;
      }
    }
    __syncthreads();  // the tile is restaged for the next run
    s = e;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for one launch, in bytes.
long long bb_tile_search_smem_bytes(int fc, int f8) {
  const int words = (f8 + 7) / 8;
  const int stride = words | 1;
  return (long long)fc * stride * 8 + (long long)kWarps * words * 8 + 2LL * fc * 4;
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
int bb_tile_search(const void* srows, const void* spops, const void* skey,
                   const void* order, const void* t_pk, const void* t_pops,
                   const void* t_slot, const void* pending, void* out_sim,
                   void* out_slot, int m, int fc, int f8, void* stream) {
  const int words = (f8 + 7) / 8;
  const int stride = words | 1;
  const long long smem = bb_tile_search_smem_bytes(fc, f8);
  cudaError_t err = cudaFuncSetAttribute(
      tile_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = (f8 % 8 == 0) &&
                       (reinterpret_cast<uintptr_t>(srows) % 8 == 0) &&
                       (reinterpret_cast<uintptr_t>(t_pk) % 8 == 0);
  const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  tile_search_kernel<<<blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(srows), static_cast<const int32_t*>(spops),
      static_cast<const int32_t*>(skey), static_cast<const int64_t*>(order),
      static_cast<const uint8_t*>(t_pk), static_cast<const int32_t*>(t_pops),
      static_cast<const int32_t*>(t_slot), static_cast<const uint8_t*>(pending),
      static_cast<float*>(out_sim), static_cast<int32_t*>(out_slot), m, fc, f8,
      words, stride, aligned ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
