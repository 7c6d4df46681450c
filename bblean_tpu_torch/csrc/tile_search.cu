// Packed-Tanimoto tile search for NVIDIA Hopper (sm_90a): two launch modes
// of one search, sorted and per-row.
//
// Contract of both, equal to bblean_tpu/engine/batch.py::_search_tiles: for
// every row, score each cell of its routed group's packed-centroid tile with
//   inter = popc(row & cell),
//   sim   = f32(inter) / f32(max(pop_cell + pop_row - inter, 1)),
// set cells with slot < 0 to -2, take the argmax (lowest cell index on
// ties) and return (best_sim, max(best_slot, 0)).  Rows that are not
// pending get (-2, 0) and read no tile.  A pending row's group outside
// [0, G) is taken as JAX's gather takes it: a negative group is wrapped once
// (+ G), then the group is clamped to [0, G - 1] (clamp_group).  Division
// is IEEE round-to-nearest (__fdiv_rn, and the build uses no fast-math),
// so the sims equal the plain PyTorch
// version's bit for bit.  A byte tail (F8 % 8 != 0) is zero-padded into the
// last word (load_word's byte-wise path, also taken for unaligned pointers).
//
// == Sorted mode: tile_search_kernel ==
//
// Replaces the Pallas TPU kernel bblean_tpu/ops/pallas_search2.py::_kernel
// (called through _run_planned, tile_search_planned and tile_search_sorted).
// Rows arrive sorted by routed group; the outputs are written back in the
// caller's row order (the unsort is folded into the stores, and so is the
// pending mask).
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
// staging.  No TMA, wgmma or double buffering yet: a row-per-warp block
// walks its runs in order, and tuning is later work.
//
// == Per-row mode: tile_search_rows_kernel ==
//
// Replaces the Pallas TPU kernel bblean_tpu/ops/pallas_search.py::
// _search_kernel (line 42, called through tile_search_pallas, line 79): one
// row per grid step, the row's group scalar-prefetched to pick the tile
// block.  Rows come in any order, with no sort and no plan.  The batch
// engine runs it in the narrow retry rounds (M = m/4 = 2048 rows at the
// bench's batch of 8192), and predict runs it at batch sizes the sorted
// mode's alignment rule does not take.
//
// Design: one warp per row, no shared tile.  The row's words sit in shared
// memory (one slice per warp); the routed group's tile is read from global
// memory through L2.  The warp walks the tile 32 cells at a time: for each
// cell it reads one word per lane (256 B of one cell per warp load at
// F8 = 256), ANDs it with the row's word, popcounts, and sums the lanes with
// one __reduce_add_sync; lane j keeps cell c0 + j's count.  Each lane then
// scores its own cell, keeps its first best across the chunks, and the warp
// takes the first argmax as the sorted mode does.
//
// Traps, and what the design does about them:
// - Coalescing.  If each lane took one cell and walked its words, the 32
//   lanes would touch 32 lines 256 B apart on every load.  Reading one cell
//   at a time, one word per lane, makes each warp load one contiguous
//   256 B span at F8 = 256.
// - Unaligned widths.  F8 = 33 (264-bit rows) is not a whole number of
//   words: load_word's byte-wise path reads the tail, as in sorted mode.
// - Out-of-range groups.  A row that is not pending reads no tile, whatever
//   its group, and gets (-2, 0).  A pending row's group goes through
//   clamp_group, as the plain version's and JAX's gathers do, so nothing
//   reads out of bounds and such a row still gets its clamped group's best
//   cell (never a silent "no candidate").
//
// What bounds it on the card: every pending row reads its whole tile,
// M * Fc * F8 bytes, which is 2048 * 256 * 256 B = 128 MiB per narrow round
// at the bench's shapes.  Where routed groups repeat, most of that is served
// from the 50 MB L2; where they do not (t = 0.65 spreads rows over
// thousands of groups) it comes from HBM.  The sorted mode reads each
// distinct tile once instead, but needs a sort and two gathers per call,
// which the narrow rounds would pay every round.

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

// Warp-wide first argmax: every lane ends with the largest (best, best_c),
// the lower cell index winning on equal sims.  Each lane must hold its own
// first best over cells it scanned in rising order.
__device__ __forceinline__ void warp_first_argmax(float& best, int& best_c) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o_best = __shfl_xor_sync(0xffffffffu, best, off);
    const int o_c = __shfl_xor_sync(0xffffffffu, best_c, off);
    if (o_best > best || (o_best == best && o_c < best_c)) {
      best = o_best;
      best_c = o_c;
    }
  }
}

// A routed group as JAX's gather reads it: negative groups wrap once, then
// the index is clamped to the table
__device__ __forceinline__ int clamp_group(int g, int n_groups) {
  if (g < 0) g += n_groups;
  return min(max(g, 0), n_groups - 1);
}

// Tanimoto of one cell in f32, -2 for an empty cell (slot < 0)
__device__ __forceinline__ float cell_sim(int inter, int cell_pop, int row_pop,
                                          int slot) {
  const int uni = max(cell_pop + row_pop - inter, 1);
  return slot >= 0 ? __fdiv_rn(static_cast<float>(inter), static_cast<float>(uni))
                   : -2.0f;
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
    int m, int n_groups, int fc, int f8, int words, int stride, int aligned_i) {
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
    const int key = skey[s];
    int e = s + 1;
    while (e < end && skey[e] == key) ++e;
    const int g = clamp_group(key, n_groups);

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
          const float sim = cell_sim(inter, cell_pop[c], row_pop, cell_slot[c]);
          if (sim > best) {
            best = sim;
            best_c = c;
          }
        }
        warp_first_argmax(best, best_c);
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

__global__ void __launch_bounds__(kThreads) tile_search_rows_kernel(
    const uint8_t* __restrict__ row_pk,   // (M, F8) rows, any order
    const int32_t* __restrict__ row_pop,  // (M,)
    const int32_t* __restrict__ row_group,// (M,) routed group per row
    const uint8_t* __restrict__ t_pk,     // (G, Fc, F8)
    const int32_t* __restrict__ t_pops,   // (G, Fc)
    const int32_t* __restrict__ t_slot,   // (G, Fc)
    const uint8_t* __restrict__ pending,  // (M,) bool
    float* __restrict__ out_sim,          // (M,)
    int32_t* __restrict__ out_slot,       // (M,)
    int m, int n_groups, int fc, int f8, int words, int aligned_i) {
  extern __shared__ unsigned long long rows_smem[];  // kWarps * words
  const bool aligned = aligned_i != 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= m) return;  // warp-uniform: no barrier below spans warps
  if (!pending[row]) {
    if (lane == 0) {
      out_sim[row] = -2.0f;
      out_slot[row] = 0;
    }
    return;
  }
  const int g = clamp_group(row_group[row], n_groups);
  unsigned long long* my_row = rows_smem + (size_t)warp * words;
  const uint8_t* rp = row_pk + (size_t)row * f8;
  for (int w = lane; w < words; w += 32) my_row[w] = load_word(rp, w, f8, aligned);
  __syncwarp();
  const int pop = row_pop[row];
  const uint8_t* tile = t_pk + (size_t)g * fc * f8;
  const int32_t* cpops = t_pops + (size_t)g * fc;
  const int32_t* cslots = t_slot + (size_t)g * fc;

  float best = -3.0f;  // below every sim, so each lane's first cell wins
  int best_c = 0x7fffffff;
  for (int c0 = 0; c0 < fc; c0 += 32) {
    const int n_cells = min(32, fc - c0);
    int my_inter = 0;
    for (int j = 0; j < n_cells; ++j) {
      const uint8_t* cell = tile + (size_t)(c0 + j) * f8;
      int part = 0;
      for (int w = lane; w < words; w += 32) {
        part += __popcll(load_word(cell, w, f8, aligned) & my_row[w]);
      }
      const int inter = (int)__reduce_add_sync(0xffffffffu, (unsigned)part);
      if (lane == j) my_inter = inter;
    }
    const int c = c0 + lane;
    if (c < fc) {
      const float sim = cell_sim(my_inter, cpops[c], pop, cslots[c]);
      if (sim > best) {
        best = sim;
        best_c = c;
      }
    }
  }
  warp_first_argmax(best, best_c);
  if (lane == 0) {
    out_sim[row] = best;
    out_slot[row] = max(cslots[best_c], 0);
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
                   void* out_slot, int m, int n_groups, int fc, int f8,
                   void* stream) {
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
      static_cast<float*>(out_sim), static_cast<int32_t*>(out_slot), m, n_groups,
      fc, f8, words, stride, aligned ? 1 : 0);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the per-row kernel needs for one launch, in bytes.
long long bb_tile_search_rows_smem_bytes(int f8) {
  return (long long)kWarps * ((f8 + 7) / 8) * 8;
}

// Per-row mode.  Launches on `stream`; returns cudaGetLastError() after the
// launch (0 = ok).
int bb_tile_search_rows(const void* row_pk, const void* row_pop,
                        const void* row_group, const void* t_pk,
                        const void* t_pops, const void* t_slot,
                        const void* pending, void* out_sim, void* out_slot,
                        int m, int n_groups, int fc, int f8, void* stream) {
  const int words = (f8 + 7) / 8;
  const long long smem = bb_tile_search_rows_smem_bytes(f8);
  cudaError_t err = cudaFuncSetAttribute(
      tile_search_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = (f8 % 8 == 0) &&
                       (reinterpret_cast<uintptr_t>(row_pk) % 8 == 0) &&
                       (reinterpret_cast<uintptr_t>(t_pk) % 8 == 0);
  const int blocks = (m + kWarps - 1) / kWarps;
  tile_search_rows_kernel<<<blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(row_pk), static_cast<const int32_t*>(row_pop),
      static_cast<const int32_t*>(row_group), static_cast<const uint8_t*>(t_pk),
      static_cast<const int32_t*>(t_pops), static_cast<const int32_t*>(t_slot),
      static_cast<const uint8_t*>(pending), static_cast<float*>(out_sim),
      static_cast<int32_t*>(out_slot), m, n_groups, fc, f8, words, aligned ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
