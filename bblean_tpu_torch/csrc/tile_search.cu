// Packed-Tanimoto tile search for NVIDIA Hopper (sm_90a): one streaming
// core, two front ends (sorted and per-row).
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
// so the sims equal the plain PyTorch version's bit for bit.
//
// == What each front end replaces ==
//
// Sorted: the Pallas TPU kernel bblean_tpu/ops/pallas_search2.py::_kernel
// (through _run_planned, tile_search_planned, tile_search_sorted).  Rows
// arrive sorted by routed group with a device-side item table from
// ops/tile_search.py::sorted_search_plan: each item is a run of at most
// kItemRows sorted rows of one group.  Outputs go back to row order through
// the plan's `order`.  The batch engine runs it in the wide insert rounds
// (M = 8192) and predict at aligned batches.
//
// The item table is built by plan_items_kernel below (one block, one
// launch per plan; the TPU plan's next-distinct-group table, which fed its
// DMA prefetcher, has no counterpart here).
//
// Per-row: bblean_tpu/ops/pallas_search.py::_search_kernel (through
// tile_search_pallas): rows in any order, no sort and no plan; each row is
// an item of its own.  The engine runs it in the narrow retry rounds
// (M = 2048) and predict at unaligned batches.
//
// == The bound at the engine's shapes ==
//
// Fc = 256 cells of F8 = 256 bytes: a tile is 64 KiB plus 2 KiB of cell
// popcounts and slots.  Counting each distinct routed tile and each pending
// row once over 3.35 TB/s (H100 SXM HBM), and each bit of AND + popcount as
// one int8 multiply-add over 1,979 TOP/s.  The int8 rate is a stand-in: no
// peak of the binary mma that the dense items use is published for the
// H100.  The fit's rows are the average launch of a profiled 1M fit at
// t = 0.3 (chip_profile.py); the others have 80% of rows pending:
//
//   case                          pending, tiles   bound
//   sorted M = 8192, the fit's    ~7,408, ~64      3.9 us (operations)
//   sorted M = 8192, 3 groups     ~6,554, 3        3.5 us (operations)
//   sorted M = 8192, 4,095 grp    ~6,554, ~3,270   66 us (bytes, ~221 MB)
//   per-row M = 2048, the fit's   ~515, ~2         0.27 us (operations)
//   per-row M = 2048, 3 groups    ~1,638, 3        0.9 us (operations)
//   per-row M = 2048, 4,095 grp   ~1,638, ~1,350   27 us (bytes, ~91 MB)
//
// The fit's launches are bound by operations at a few microseconds or
// less, where launch and per-item latency set the time: the sorted front
// end's dense items (16 or more pending rows of one group) go to the
// tensor cores, and a whole launch reads its few tiles from L2.  Rows
// spread over many groups (predict on a large tree, the 4,095-group case)
// make both front ends byte-bound: the tile tables (~200 MB at 1M rows,
// t = 0.3) are far larger than the 50 MB L2, and what matters there is
// streaming each routed tile once at HBM rate, which the ring below does.
//
// == Design ==
//
// Streaming core.  Persistent blocks (as many as fit on the SMs) walk the
// items.  One producer warp streams each item's tile in chunks of
// kChunkCells cells (8 KiB at F8 = 256) through a ring of stages in shared
// memory, with one 1-D bulk async copy per chunk (cp.async.bulk ...
// mbarrier::complete_tx) and a full/empty mbarrier pair per stage.  The
// sorted front end runs blocks of eight consumer warps with a 64 KiB ring,
// two an SM; the per-row one, whose items are single rows, blocks of four
// with a 32 KiB ring, three an SM, to keep more items in flight: 96-128 KiB
// in flight per SM either way.  The consumer warps score chunk k while
// chunk k + 1 lands, and release each stage to the producer as soon as
// they are done with it, so the next item's chunks land while this item
// is still being scored.
// Every consumer warp waits on every chunk's full barrier in turn, even one
// it does not score, and arrives on its empty barrier: no warp can run a
// whole ring ahead of another.  Shared memory no longer grows with Fc;
// it grows with F8 (the ring's stages and the kItemRows staged rows).
//
// Items.  The consumers stage the item's rows in shared memory while warp
// 0 lists the pending ones and writes (-2, 0) for the rest; an item with
// no pending row copies nothing (producer and consumers skip it alike).
// The cells' popcounts and slots are read from global memory before the
// wait on their chunk.  Then:
// - sparse items (fewer than kDenseRows pending rows, "spread": mostly one):
//   lane l scores cell 32k + l of chunk k, warp w of W takes the chunks
//   k = w mod W, so every warp works on a one-row item.  Each lane reads
//   its cell's 64-bit words rotated by its lane (word (w + l) mod W): the
//   bulk copies land cells densely at a 256 B stride, and without the
//   rotation 32 lanes reading word w of their own cells would all hit one
//   bank.  Intersections are integers, so the order cannot change a bit.
// - dense items (kDenseRows or more pending rows, F8 % 64 == 0): the
//   tensor cores' binary product mma.m16n8k256 .and.popc computes
//   popc(row & cell) exactly on packed words.  Rows go in tiles of 16
//   (A fragments from the padded row buffer, conflict-free), cells in
//   tiles of 8 (B fragments from the ring, 128-bit loads, two-way bank
//   conflicts at the dense stride); the k slots of A and B are one
//   permutation of the row's 32-bit words, which popc over AND does not
//   see.  Row tiles split the warps and the rest of the warps split the
//   chunks.  On 8,192 rows of one group this path took 0.0214 ms against
//   0.1151 ms with every item on the CUDA cores (chip_smoke.py phase 2,
//   H100 SXM at 700 W), so kDenseRows is 16.
// Each warp keeps a running first-argmax per row over its chunks in rising
// cell order (strict >), and the warps' results merge by (sim, lowest
// cell), so ties keep the first cell.
//
// Generic path.  Bulk copies need 16-byte-aligned addresses and sizes.
// When F8 % 16 != 0 (F8 = 33, 13) or a row or tile pointer is not 16-byte
// aligned, the wrapper launches the kTileBulk = false instance: the
// producer warp fills the ring with ordinary loads (load_word, byte-wise for
// a tail) and arrives on the full barrier; the rest is the same kernel.
// The shape decides the path, never a failure.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkCells = 32;
constexpr int kItemRows = 64;  // rows of one item at most (the plan's R)
constexpr int kMaxStages = 8;
constexpr int kRowBatch = 16;  // rows a lane scores at once (sparse)
// Items with at least this many pending rows go to the tensor cores
constexpr int kDenseRows = 16;

// Block shapes: consumer warps (plus one producer warp), ring bytes, and the
// resident blocks per SM the registers must allow.  A sorted item holds up
// to kItemRows rows that eight warps share; a per-row item holds one row,
// and smaller blocks keep more items in flight per SM.
template <int kWarps>
struct Shape;
template <>
struct Shape<8> {
  static constexpr int kRing = 64 * 1024, kMinBlocks = 2;
};
template <>
struct Shape<4> {
  static constexpr int kRing = 32 * 1024, kMinBlocks = 3;
};
constexpr unsigned kAll = 0xffffffffu;

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

// A running first argmax: best sim, its cell and the cell's slot
struct Best {
  float sim;
  int cell, slot;
};

__device__ __forceinline__ Best no_best() { return {-3.0f, 0x7fffffff, 0}; }

// Order of the first argmax: larger sim, then lower cell
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.sim > b.sim || (a.sim == b.sim && a.cell < b.cell);
}

// First argmax over groups of `width` lanes (xor distances below it): every
// lane ends with the best of its group.
__device__ __forceinline__ void shfl_first_argmax(Best& best, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    Best o;
    o.sim = __shfl_xor_sync(kAll, best.sim, off);
    o.cell = __shfl_xor_sync(kAll, best.cell, off);
    o.slot = __shfl_xor_sync(kAll, best.slot, off);
    if (better(o, best)) best = o;
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

// ---- mbarriers and bulk copies (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// 1-D bulk copy global -> shared; completion counted on `bar` in bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// The consumer warps only (named barrier 1; the producer runs free)
template <int kConsumers>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// d += popc(A & B) over one 256-bit k step: A 16 rows, B 8 cells
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- layout of one launch ----

struct Layout {
  int cs;      // bytes per cell in the ring
  int rs;      // bytes per staged row (rs % 128 == 64: conflict-free A loads)
  int stages;  // ring stages
  size_t ring, rows, best, meta, bars, total;  // byte offsets, total size
};

__host__ __device__ inline Layout make_layout(int f8, bool bulk, int warps, int ring_bytes) {
  Layout L;
  const int words = (f8 + 7) / 8;
  L.cs = bulk ? f8 : words * 8;
  L.rs = L.cs + ((64 - L.cs % 128) + 128) % 128;
  const int stage = kChunkCells * L.cs;
  const int fit = ring_bytes / stage;
  L.stages = fit < 2 ? 2 : fit > kMaxStages ? kMaxStages : fit;
  L.ring = 0;
  L.rows = L.ring + (size_t)L.stages * stage;
  L.best = L.rows + (size_t)kItemRows * L.rs;                    // Best [warps][rows]
  L.meta = L.best + sizeof(Best) * warps * kItemRows;            // idx, out, pop [rows], np, g
  L.bars = (L.meta + 3 * kItemRows * 4 + 8 + 7) / 8 * 8;          // full, empty [stages]
  L.total = L.bars + 2 * (size_t)kMaxStages * 8;
  return L;
}

struct Item {
  int s0, s1;  // rows [s0, s1) in the item order of `rows`
};

__device__ __forceinline__ Item item_at(const int32_t* items, int i, int n_items, int m) {
  Item it;
  if (items != nullptr) {
    it.s0 = items[i];
    it.s1 = i + 1 < n_items ? items[i + 1] : m;
    it.s1 = min(it.s1, it.s0 + kItemRows);  // the plan never makes longer items
  } else {
    it.s0 = i;
    it.s1 = i + 1;
  }
  return it;
}

__device__ __forceinline__ int out_row(const int64_t* order, int r) {
  return order != nullptr ? static_cast<int>(order[r]) : r;
}

// CUDA-core scoring of B pending rows (item rows idx[0 .. B - 1]) against
// one chunk: lane l takes cell c; the warp's running best per item row lives
// in wbest.  B is a compile-time count, so no row is predicated.
template <int B>
__device__ __forceinline__ void score_rows(
    const unsigned long long* cell, const uint8_t* rowbuf, const int32_t* s_pop,
    const int* idx, int c, bool live, int cp, int sl, int W, int rot, int rs,
    Best* wbest, int lane) {
  int acc[B];
  const unsigned long long* row[B];
#pragma unroll
  for (int jj = 0; jj < B; ++jj) {
    acc[jj] = 0;
    row[jj] = reinterpret_cast<const unsigned long long*>(rowbuf + idx[jj] * rs);
  }
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    int x = w + rot;
    if (x >= W) x -= W;
    const unsigned long long cw = cell[x];
#pragma unroll
    for (int jj = 0; jj < B; ++jj) acc[jj] += __popcll(cw & row[jj][x]);
  }
#pragma unroll
  for (int jj = 0; jj < B; ++jj) {
    const int j = idx[jj];
    Best b = no_best();
    if (live) b = {cell_sim(acc[jj], cp, s_pop[j], sl), c, sl};
    shfl_first_argmax(b, 32);
    if (lane == 0 && better(b, wbest[j])) wbest[j] = b;
  }
}

// CUDA-core scoring of one chunk for every pending row of the item, in
// batches of kRowBatch, then 4, then 1 rows.  Lane l's cell is c = chunk0
// + l, live when c < Fc, with popcount cp and slot sl.
__device__ __forceinline__ void score_sparse(
    const uint8_t* stage, const uint8_t* rowbuf, const int32_t* s_pop,
    const int* s_idx, int np, int c, bool live, int cp, int sl, int cs, int rs,
    Best* wbest, int lane) {
  const int W = cs / 8;
  const unsigned long long* cell =
      reinterpret_cast<const unsigned long long*>(stage + lane * cs);
  const int rot = lane % W;
  int p = 0;
  for (; p + kRowBatch <= np; p += kRowBatch) {
    score_rows<kRowBatch>(cell, rowbuf, s_pop, s_idx + p, c, live, cp, sl, W, rot,
                          rs, wbest, lane);
  }
  for (; p + 4 <= np; p += 4) {
    score_rows<4>(cell, rowbuf, s_pop, s_idx + p, c, live, cp, sl, W, rot, rs,
                  wbest, lane);
  }
  for (; p < np; ++p) {
    score_rows<1>(cell, rowbuf, s_pop, s_idx + p, c, live, cp, sl, W, rot, rs,
                  wbest, lane);
  }
}

// Tensor-core scoring of one chunk for row tile rt (item rows 16 rt ..
// 16 rt + 15, pending or not): thread (gq = lane / 4, t = lane % 4) keeps
// the running best of rows 16 rt + gq (best[0]) and 16 rt + gq + 8
// (best[1]).  k step s takes the row's 32-bit words
// (s / 2) * 16 + t * 4 + (s % 2) * 2 + h for slot (t, h), the same for A
// and B.
__device__ __forceinline__ void score_dense(
    const uint8_t* stage, const uint8_t* rowbuf, const int32_t* s_pop, int rt,
    int chunk0, int fc, int f8, int cs, int rs, const int (&cpv)[8],
    const int (&slv)[8], Best (&best)[2], int lane) {
  const int gq = lane >> 2, t = lane & 3;
  const uint8_t* ra = rowbuf + (rt * 16 + gq) * rs + t * 16;
  const uint8_t* rb = ra + 8 * rs;
  const uint8_t* cb = stage + gq * cs + t * 16;
  const int n_nt = min(4, (fc - chunk0 + 7) / 8);
  int acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
  for (int j = 0; j < f8 / 64; ++j) {
    const uint4 alo = *reinterpret_cast<const uint4*>(ra + j * 64);
    const uint4 ahi = *reinterpret_cast<const uint4*>(rb + j * 64);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < n_nt) {  // warp-uniform
        const uint4 b = *reinterpret_cast<const uint4*>(cb + nt * 8 * cs + j * 64);
        mma_and_popc(acc[nt], alo.x, ahi.x, alo.y, ahi.y, b.x, b.y);
        mma_and_popc(acc[nt], alo.z, ahi.z, alo.w, ahi.w, b.z, b.w);
      }
    }
  }
  const int pop0 = s_pop[rt * 16 + gq], pop1 = s_pop[rt * 16 + gq + 8];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = chunk0 + nt * 8 + 2 * t + e;
      if (nt < n_nt && c < fc) {
        const int cp = cpv[nt * 2 + e], sl = slv[nt * 2 + e];
        const float s0 = cell_sim(acc[nt][e], cp, pop0, sl);
        const float s1 = cell_sim(acc[nt][2 + e], cp, pop1, sl);
        if (s0 > best[0].sim) best[0] = {s0, c, sl};
        if (s1 > best[1].sim) best[1] = {s1, c, sl};
      }
    }
  }
}

template <bool kTileBulk, int kWarps>
__global__ void __launch_bounds__((kWarps + 1) * 32, Shape<kWarps>::kMinBlocks)
tile_search_kernel(
    const uint8_t* __restrict__ rows,    // (M, F8) rows in item order
    const int32_t* __restrict__ pops,    // (M,) their popcounts
    const int32_t* __restrict__ key,     // (M,) routed group per row
    const int64_t* __restrict__ order,   // (M,) item position -> row; null: same
    const int32_t* __restrict__ items,   // (M + 1,) item starts, count at [M]; null: a row each
    const uint8_t* __restrict__ t_pk,    // (G, Fc, F8)
    const int32_t* __restrict__ t_pops,  // (G, Fc)
    const int32_t* __restrict__ t_slot,  // (G, Fc)
    const uint8_t* __restrict__ pending, // (M,) bool, row order
    float* __restrict__ out_sim,         // (M,) row order
    int32_t* __restrict__ out_slot,      // (M,) row order
    int m, int n_groups, int fc, int f8, int aligned8) {
  constexpr int kConsumers = kWarps * 32;
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L = make_layout(f8, kTileBulk, kWarps, Shape<kWarps>::kRing);
  uint8_t* ring = smem + L.ring;
  uint8_t* rowbuf = smem + L.rows;  // the item's rows, pending or not
  Best* wbest = reinterpret_cast<Best*>(smem + L.best);
  int* s_idx = reinterpret_cast<int*>(smem + L.meta);  // pending item rows
  int* s_out = s_idx + kItemRows;                       // output row per item row
  int32_t* s_pop = s_out + kItemRows;                   // popcount per item row
  int* s_np = s_pop + kItemRows;
  int* s_g = s_np + 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = (f8 + 7) / 8;
  const int nch = (fc + kChunkCells - 1) / kChunkCells;
  const int n_items = items != nullptr ? items[m] : m;
  const int stages = L.stages;
  const int cs = L.cs, rs = L.rs;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kTileBulk ? 1 : 32);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // ---- producer ----
    uint32_t q = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item it = item_at(items, i, n_items, m);
      bool any = false;
      for (int r = it.s0 + lane; r < it.s1; r += 32) any |= pending[out_row(order, r)] != 0;
      if (!__any_sync(kAll, any)) continue;
      const int g = clamp_group(key[it.s0], n_groups);
      const uint8_t* tile = t_pk + (size_t)g * fc * f8;
      for (int k = 0; k < nch; ++k, ++q) {
        const int s = q % stages;
        const uint32_t use = q / stages;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        const int n_cells = min(kChunkCells, fc - k * kChunkCells);
        uint8_t* dst = ring + (size_t)s * kChunkCells * cs;
        const uint8_t* src = tile + (size_t)k * kChunkCells * f8;
        if (kTileBulk) {
          if (lane == 0) {
            const uint32_t bytes = (uint32_t)n_cells * f8;
            mbar_arrive_expect_tx(&full[s], bytes);
            bulk_copy(dst, src, bytes, &full[s]);
          }
        } else {
          unsigned long long* d = reinterpret_cast<unsigned long long*>(dst);
          for (int x = lane; x < n_cells * words; x += 32) {
            const int c = x / words;
            d[x] = load_word(src + (size_t)c * f8, x - c * words, f8, aligned8 != 0);
          }
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  uint32_t q = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = item_at(items, i, n_items, m);
    const int n_rows = it.s1 - it.s0;
    consumer_sync<kConsumers>();  // the previous item's merge is done with shared memory
    // Stage the item's rows (all threads) while warp 0 lists the pending
    // ones and writes (-2, 0) for the rest
    if (kTileBulk) {
      const int v16 = f8 / 16;
      const uint4* src = reinterpret_cast<const uint4*>(rows + (size_t)it.s0 * f8);
      for (int x = threadIdx.x; x < n_rows * v16; x += kConsumers) {
        const int j = x / v16;
        reinterpret_cast<uint4*>(rowbuf + j * rs)[x - j * v16] = src[x];
      }
    } else {
      for (int x = threadIdx.x; x < n_rows * words; x += kConsumers) {
        const int j = x / words;
        reinterpret_cast<unsigned long long*>(rowbuf + j * rs)[x - j * words] =
            load_word(rows + (size_t)(it.s0 + j) * f8, x - j * words, f8, aligned8 != 0);
      }
    }
    if (warp == 0) {
      int base = 0;
      for (int j0 = 0; j0 < n_rows; j0 += 32) {
        const int j = j0 + lane;
        const bool in = j < n_rows;
        const int orow = in ? out_row(order, it.s0 + j) : 0;
        const bool p = in && pending[orow] != 0;
        const unsigned bal = __ballot_sync(kAll, p);
        if (in) {
          s_out[j] = orow;
          s_pop[j] = pops[it.s0 + j];
        }
        if (p) {
          s_idx[base + __popc(bal & ((1u << lane) - 1u))] = j;
        } else if (in) {
          out_sim[orow] = -2.0f;
          out_slot[orow] = 0;
        }
        base += __popc(bal);
      }
      if (lane == 0) {
        *s_np = base;
        *s_g = clamp_group(key[it.s0], n_groups);
      }
    }
    Best* my_best = wbest + warp * kItemRows;
    for (int j = lane; j < kItemRows; j += 32) my_best[j] = no_best();
    consumer_sync<kConsumers>();
    const int np = *s_np;
    if (np == 0) continue;  // the producer copies nothing for it either

    const int g = *s_g;
    const int32_t* cpop = t_pops + (size_t)g * fc;
    const int32_t* cslot = t_slot + (size_t)g * fc;
    const bool dense = np >= kDenseRows && f8 % 64 == 0;
    // dense: row tile rt of n_rt, chunk group cg of n_cg
    const int n_rt = (n_rows + 15) / 16;
    const int n_cg = max(1, kWarps / (n_rt == 3 ? 4 : n_rt));
    const int rt = warp / n_cg, cg = warp % n_cg;
    Best best[2] = {no_best(), no_best()};

    for (int k = 0; k < nch; ++k, ++q) {
      const int s = q % stages;
      const int chunk0 = k * kChunkCells;
      const bool mine = dense ? rt < n_rt && k % n_cg == cg : k % kWarps == warp;
      // The cells' popcounts and slots do not come through the ring: load
      // them before waiting on it
      int cpv[8], slv[8];
      const int c = chunk0 + lane;
      if (mine && dense) {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int cd = chunk0 + (x >> 1) * 8 + 2 * (lane & 3) + (x & 1);
          cpv[x] = cd < fc ? cpop[cd] : 0;
          slv[x] = cd < fc ? cslot[cd] : -1;
        }
      } else if (mine) {
        cpv[0] = c < fc ? cpop[c] : 0;
        slv[0] = c < fc ? cslot[c] : -1;
      }
      mbar_wait(&full[s], (q / stages) & 1);
      const uint8_t* stage = ring + (size_t)s * kChunkCells * cs;
      if (mine && dense) {
        score_dense(stage, rowbuf, s_pop, rt, chunk0, fc, f8, cs, rs, cpv, slv,
                    best, lane);
      } else if (mine) {
        score_sparse(stage, rowbuf, s_pop, s_idx, np, c, c < fc, cpv[0], slv[0], cs,
                     rs, my_best, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (dense && rt < n_rt) {
      shfl_first_argmax(best[0], 4);
      shfl_first_argmax(best[1], 4);
      if ((lane & 3) == 0) {
        const int j = rt * 16 + (lane >> 2);
        my_best[j] = best[0];
        my_best[j + 8] = best[1];
      }
    }
    consumer_sync<kConsumers>();
    for (int p = threadIdx.x; p < np; p += kConsumers) {
      const int j = s_idx[p];
      Best b = no_best();
      for (int w = 0; w < kWarps; ++w) {
        if (better(wbest[w * kItemRows + j], b)) b = wbest[w * kItemRows + j];
      }
      out_sim[s_out[j]] = b.sim;
      out_slot[s_out[j]] = max(b.slot, 0);
    }
  }
}

template <bool kTileBulk, int kWarps>
int launch(const void* rows, const void* pops, const void* key, const void* order,
           const void* items, const void* t_pk, const void* t_pops,
           const void* t_slot, const void* pending, void* out_sim, void* out_slot,
           int m, int n_groups, int fc, int f8, int aligned8,
           cudaStream_t stream) {
  constexpr int kThreads = (kWarps + 1) * 32;
  const Layout L = make_layout(f8, kTileBulk, kWarps, Shape<kWarps>::kRing);
  auto kernel = tile_search_kernel<kTileBulk, kWarps>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           L.total)) != cudaSuccess)
    return (int)err;
  const int resident = (per_sm > 0 ? per_sm : 1) * n_sm;
  const int blocks = m < resident ? m : resident;
  kernel<<<blocks, kThreads, L.total, stream>>>(
      static_cast<const uint8_t*>(rows), static_cast<const int32_t*>(pops),
      static_cast<const int32_t*>(key), static_cast<const int64_t*>(order),
      static_cast<const int32_t*>(items), static_cast<const uint8_t*>(t_pk),
      static_cast<const int32_t*>(t_pops), static_cast<const int32_t*>(t_slot),
      static_cast<const uint8_t*>(pending), static_cast<float*>(out_sim),
      static_cast<int32_t*>(out_slot), m, n_groups, fc, f8, aligned8);
  return (int)cudaGetLastError();
}

template <int kWarps>
int launch_shape(const void* rows, const void* pops, const void* key,
                 const void* order, const void* items, const void* t_pk,
                 const void* t_pops, const void* t_slot, const void* pending,
                 void* out_sim, void* out_slot, int m, int n_groups, int fc, int f8,
                 int bulk, cudaStream_t stream) {
  const uintptr_t pr = reinterpret_cast<uintptr_t>(rows);
  const uintptr_t pt = reinterpret_cast<uintptr_t>(t_pk);
  if (bulk) {
    if (f8 % 16 != 0 || pr % 16 != 0 || pt % 16 != 0) return (int)cudaErrorInvalidValue;
    return launch<true, kWarps>(rows, pops, key, order, items, t_pk, t_pops, t_slot,
                                pending, out_sim, out_slot, m, n_groups, fc, f8, 1,
                                stream);
  }
  const int aligned8 = f8 % 8 == 0 && pr % 8 == 0 && pt % 8 == 0;
  return launch<false, kWarps>(rows, pops, key, order, items, t_pk, t_pops, t_slot,
                               pending, out_sim, out_slot, m, n_groups, fc, f8,
                               aligned8, stream);
}

// ---- the sort plan's item table ----

constexpr int kPlanThreads = 1024;
constexpr int kPlanRows = 8;  // consecutive sorted rows per thread and pass

// First sorted row of the run of equal keys that holds row s (keys sorted)
__device__ __forceinline__ int run_start(const int32_t* __restrict__ skey, int s) {
  const int k = skey[s];
  int lo = 0, hi = s;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (skey[mid] < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One block builds the whole table (M is a batch: 8,192 rows in the fit):
// an item starts where the key changes and every kItemRows rows within a
// run; items[0 .. n) are the starts in order, items[n .. M) = M and
// items[M] = n.  Each pass gives a thread kPlanRows rows, scans the
// threads' start counts across the block and writes the starts after
// those of the earlier passes.
__global__ void __launch_bounds__(kPlanThreads) plan_items_kernel(
    const int32_t* __restrict__ skey, int32_t* __restrict__ items, int m) {
  __shared__ int warp_off[kPlanThreads / 32];
  __shared__ int pass_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;  // starts written by the earlier passes
  for (int base = 0; base < m; base += kPlanThreads * kPlanRows) {
    const int p0 = base + threadIdx.x * kPlanRows;
    unsigned flags = 0;
    if (p0 < m) {
      int rs = p0 > 0 && skey[p0] == skey[p0 - 1] ? run_start(skey, p0) : p0;
      for (int j = 0; j < kPlanRows && p0 + j < m; ++j) {
        const int p = p0 + j;
        if (j > 0 && skey[p] != skey[p - 1]) rs = p;
        if ((p - rs) % kItemRows == 0) flags |= 1u << j;
      }
    }
    const int count = __popc(flags);
    int incl = count;  // inclusive scan of the counts within the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int total = warp_off[lane];
      int w_incl = total;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kAll, w_incl, off);
        if (lane >= off) w_incl += v;
      }
      warp_off[lane] = w_incl - total;
      if (lane == 31) pass_total = w_incl;
    }
    __syncthreads();
    int idx = carry + warp_off[warp] + incl - count;
    for (int j = 0; j < kPlanRows; ++j) {
      if (flags >> j & 1u) items[idx++] = p0 + j;
    }
    carry += pass_total;
    __syncthreads();  // the next pass rewrites warp_off and pass_total
  }
  for (int i = carry + threadIdx.x; i < m; i += kPlanThreads) items[i] = m;
  if (threadIdx.x == 0) items[m] = carry;
}

}  // namespace

extern "C" {

// Rows of one item at most: the sort plan's item table must use the same.
int bb_tile_search_item_rows() { return kItemRows; }

// Dynamic shared memory one block of the sorted (sorted = 1) or per-row
// front end needs, in bytes: it grows with F8, not with Fc.
long long bb_tile_search_smem_bytes(int f8, int bulk, int sorted) {
  return (long long)(sorted ? make_layout(f8, bulk != 0, 8, Shape<8>::kRing)
                            : make_layout(f8, bulk != 0, 4, Shape<4>::kRing))
      .total;
}

// Both front ends.  Sorted: `rows`, `pops` and `key` in sorted order,
// `order` the sort and `items` the plan's item table (blocks of 8 consumer
// warps).  Per-row: rows in row order and `order` = `items` = null (blocks
// of 4).  `bulk` = 1 takes the bulk-copy path (F8 % 16 == 0 and
// 16-byte-aligned rows and tiles, else the launch is refused); 0 the
// generic path.  Launches on `stream`; returns cudaGetLastError() after the
// launch (0 = ok).
int bb_tile_search(const void* rows, const void* pops, const void* key,
                   const void* order, const void* items, const void* t_pk,
                   const void* t_pops, const void* t_slot, const void* pending,
                   void* out_sim, void* out_slot, int m, int n_groups, int fc,
                   int f8, int bulk, void* stream) {
  if (order != nullptr) {
    return launch_shape<8>(rows, pops, key, order, items, t_pk, t_pops, t_slot,
                           pending, out_sim, out_slot, m, n_groups, fc, f8, bulk,
                           (cudaStream_t)stream);
  }
  return launch_shape<4>(rows, pops, key, order, items, t_pk, t_pops, t_slot, pending,
                         out_sim, out_slot, m, n_groups, fc, f8, bulk,
                         (cudaStream_t)stream);
}

// The item table of `m` sorted keys (int32) into `items` ((m + 1,) int32),
// one block on `stream`; returns cudaGetLastError() after the launch.
int bb_plan_items(const void* skey, void* items, int m, void* stream) {
  plan_items_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(skey), static_cast<int32_t*>(items), m);
  return (int)cudaGetLastError();
}

}  // extern "C"
