// The insert round's merge tests for NVIDIA Hopper (sm_90a): a segmented
// exclusive scan of the accepted rows' linear sums along the sorted rows,
// fused with the per-row iSIM moments of the merged and pre-merge clusters,
// in one launch with a decoupled look-back across chunks.
//
// == What it replaces ==
//
// bblean_tpu/engine/batch.py:390 (the individual screen) and :406-470 (the
// two passes of the prefix commits): jnp.cumsum(s_ls, axis=0) at :415 and
// :448, the gathers and masks around it and the sums inside
// ops/merges.py::merge_accept_batch, all of which XLA fuses inside the
// jitted step.  ops/prefix_commit.py keeps that chain (torch.cumsum over
// (M, F) int32 planes, then int64 sums) as the plain version.
//
// Contract, equal to the plain version bit for bit.  For sorted row i,
// r = order[i] (i without an order), s = mask[i] ? row_ls[r] : 0 (row_ls[r]
// without a mask), pre = the sum of s over the earlier rows of i's segment
// (a segment starts where seg_start[i] == i; seg_start is non-decreasing
// with seg_start[i] <= i; without it every row starts one), y = cand_ls[r]
// + pre and x = y + s per column, in wrapping int32.  Out, (moments, M)
// int64 in sorted order: sum(x), sum(x^2); for the radius criteria also
// sum(x + c), sum((x + c)^2) with c the majority vote f32(x) >=
// f32(new_n) * 0.5 (clamp(x, 0, 1) where new_n <= 1); for the tolerance
// criteria the same again of y (vote at max(old_n, 2)).  Rows outside
// `need` (every row without it) get zeros.  The sums wrap modulo 2^64 like
// torch's int64 sums, so any order gives the same bits.
//
// == The bound ==
//
// A call must read cand_ls for the rows in `need`, row_ls for the rows the
// result depends on (with segments: the rows in the mask; without: the
// rows in the mask and in `need`), and O(M) flags, counts and moments.
// At M = 8192, F = 2048 with every row in both, 128 MiB: 0.040 ms at
// 3.35 TB/s.  The arithmetic is a few integer operations a column, so the
// bytes bound it.
//
// == Design: one launch, each row slice read once ==
//
// Sorted rows are cut into chunks of `rows` <= 32 rows (the wrapper takes
// 16) and columns into tiles of kTileCols = 256; a work item is one
// (chunk, tile), numbered chunk * tiles + tile.  Blocks are persistent (as
// many as fit on the card, at most one an item) and warp-specialised: one
// producer warp and eight consumer warps, with a ring of kRing item slots
// in shared memory (each the item's rows of both tables, 32 KiB at 16
// rows: three blocks an SM) guarded by full / empty mbarriers.
//   1. The producer claims the next item with an atomic ticket once a slot
//      is free, so items start in order and an item only ever waits on
//      items that a running block already holds.  Not earlier: a ticket
//      claimed while the block's slots are full holds back that item's
//      tail, which later items' look-backs wait for (claiming one item
//      ahead, with or without its flags, made the segmented passes slower
//      on the card).  It reads the chunk's
//      flags (mask, need, segment starts, order, counts: one lane a row,
//      one round trip) and issues each row's bulk copies (cp.async.bulk,
//      1 KiB a row slice, gathered by order[i]) of row_ls (where the
//      result needs the row) and cand_ls (rows in `need`) into the slot,
//      completing on one mbarrier a table a stage of kStageRows rows.  A
//      chunk with no row in mask | need reads no table.
//   2. The producer sums the tail (s since the chunk's last segment
//      start) as soon as row_ls lands and publishes it at once, a word a
//      column: as the chunk's inclusive prefix if it holds a start, else
//      as its aggregate (zeros where nothing is read).  So a tail is
//      published when its rows land, not when the consumers reach it.
//   3. Look-back (unless the chunk's first row starts a segment): each
//      consumer thread reads its column's words of the kWindow chunks
//      before it at once and adds them up to the nearest inclusive
//      prefix, re-reading from the first word not yet published, and goes
//      kWindow further back if none was inclusive.  A chunk without a
//      start then publishes carry + tail as its inclusive prefix.
//   4. Rescan in shared memory: per column, y = cand + prefix is written
//      over the cand_ls rows in place.
//   5. Moments: one warp a needed row, lanes over its columns (16-byte
//      shared loads, conflict-free), reduced by shuffles and stored
//      (added with int64 atomics where several tiles share a row).
// A word holds its flag (aggregate or inclusive) in its high half and its
// value in its low half, written and read as one 64-bit access at gpu
// scope: a look-back step is one round trip, with no fence, barrier or
// second read.  The wrapper zeroes the words and the ticket before each
// call (chunks * F * 8 bytes: 8 MiB at M = 8192, 2 MiB at 2048).  While
// the consumers finish one item, the next one's rows load into the other
// slot.  The screen (no segments) skips steps 2-4 and takes items
// blockIdx.x, + gridDim.x, ... without tickets.  Nothing allocates or
// synchronises; one launch goes on the caller's stream, so the call can be
// captured in a CUDA graph (the zeroing a node before it).  Without
// 16-byte rows (F % 4 != 0 or unaligned tables) the producer copies the
// rows with plain loads instead of bulk copies, still once.
//
// What bounds it on the fit's long segments: a chunk's inclusive prefix
// comes one look-back after its rows land, so with hundreds of items in
// flight the nearest inclusive prefix lies tens of chunks back, and a
// look-back takes several windows; a pass over long segments takes longer
// than the screen, which reads the same bytes (chip_smoke.py phase 2e and
// chip_profile.py time both).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;            // one column a thread in the scans
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kWarps = kConsumers / 32;    // consumer warps
constexpr int kTileCols = kConsumers;      // columns of an item
constexpr int kHalves = kTileCols / 128;   // the producer's tail: 4 columns a lane a half
constexpr int kMaxRows = 32;               // one producer lane a row
constexpr int kStageRows = 8;              // rows a stage (one mbarrier a table)
constexpr int kStages = kMaxRows / kStageRows;
constexpr int kRing = 2;                   // items a block holds in shared memory at once
constexpr int kWindow = 8;                 // predecessors a look-back step reads at once

// The flag in the high half of a (chunk, column) word; the low half is the
// value.  0: not yet published
constexpr unsigned long long kAgg = 1ull << 32, kInc = 2ull << 32;
// Row flags
constexpr uint8_t kInMask = 1, kStart = 2, kNeed = 4, kSingle = 8;

struct Args {
  const int* row_ls;         // (M, F) row order
  const int* cand_ls;        // (M, F) row order
  const int64_t* order;      // (M,) sorted -> row, or null (identity)
  const bool* mask;          // (M,) sorted, or null (all rows)
  const int64_t* seg_start;  // (M,) sorted, or null (every row a segment)
  const bool* need;          // (M,) sorted, or null (all rows)
  const int* new_n;          // (M,) sorted
  const int* old_n;          // (M,) sorted
  unsigned* ticket;          // zeroed
  unsigned long long* words; // (chunks, F): flag | value of each chunk's tail or prefix; zeroed
  unsigned long long* out;   // (moments, M), zeroed
  int m, f, rows, tiles, items, bulk;
};

// ---- mbarriers, bulk copies, flagged words (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// A word and its flag in one 64-bit access (single-copy atomic), at gpu
// scope: no fence, no second read
__device__ __forceinline__ void put_word(unsigned long long* p, unsigned long long flag, int v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(flag | (unsigned)v)
               : "memory");
}

__device__ __forceinline__ unsigned long long get_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// One side's moments of column value x: sum(x), sum(x^2) and, for the
// radius criteria, sum(x + c), sum((x + c)^2) with c its majority vote
template <bool kRadius>
__device__ __forceinline__ void add_moments(int x, float half, bool single,
                                            unsigned long long* mom) {
  mom[0] += (unsigned long long)(long long)x;
  mom[1] += (unsigned long long)((long long)x * x);
  if (kRadius) {
    const int c = single ? min(max(x, 0), 1) : (__int2float_rn(x) >= half ? 1 : 0);
    const int x1 = wrap_add(x, c);
    mom[2] += (unsigned long long)(long long)x1;
    mom[3] += (unsigned long long)((long long)x1 * x1);
  }
}

// The consumers only (named barrier 1; the producer warp runs free)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// One work item's flags and rows, written by the producer warp
struct Meta {
  int src[kMaxRows];        // the table row of each sorted row
  float half[2][kMaxRows];  // the votes' halves: new_n, max(old_n, 2)
  uint8_t flag[kMaxRows];
  int item;                 // chunk * tiles + tile, or -1: no more items
  unsigned live, starts;    // rows in mask | need (need alone without segments); starts
};

template <bool kSeg, bool kRadius, bool kOld>
__global__ void __launch_bounds__(kThreads) prefix_commit_kernel(Args a) {
  constexpr int kSide = kRadius ? 4 : 2;
  constexpr int kMom = kSide * (kOld ? 2 : 1);
  extern __shared__ __align__(128) int s_tab[];  // [kRing][row_ls, cand_ls][rows][kTileCols]
  __shared__ Meta s_meta[kRing];
  __shared__ __align__(8) uint64_t s_full[kRing];   // the item's flags and tail are in
  __shared__ __align__(8) uint64_t s_empty[kRing];  // the consumers are done with the slot
  __shared__ __align__(8) uint64_t s_bar[kRing][2][kStages];  // row_ls, cand_ls a stage of rows
  __shared__ __align__(16) int s_tail[kRing][kTileCols];      // the item's tail

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_stages = (a.rows + kStageRows - 1) / kStageRows;
  if (tid == 0) {
    for (int r = 0; r < kRing; ++r) {
      mbar_init(&s_full[r], 1);
      mbar_init(&s_empty[r], 1);
      for (int s = 0; s < n_stages; ++s) {
        mbar_init(&s_bar[r][0][s], min(kStageRows, a.rows - s * kStageRows));
        mbar_init(&s_bar[r][1][s], min(kStageRows, a.rows - s * kStageRows));
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int slot_ints = 2 * a.rows * kTileCols;

  if (warp == kWarps) {
    // ---- the producer: claims items in order and reads their flags (one
    // lane a row, every load at once) ahead of a free slot, then issues
    // the rows' bulk copies into the slot, sums and publishes the tail as
    // soon as row_ls lands, and hands the item to the consumers ----
    for (int k = 0;; ++k) {
      const int r = k % kRing;
      const uint32_t parity = (k / kRing) & 1;
      if (k >= kRing) mbar_wait(&s_empty[r], parity ^ 1);
      Meta& me = s_meta[r];
      int item;
      if (kSeg) {
        unsigned t = 0;
        if (lane == 0) t = atomicAdd(a.ticket, 1u);
        item = (int)__shfl_sync(0xffffffffu, t, 0);
      } else {
        item = blockIdx.x + k * gridDim.x;
      }
      if (item >= a.items) {
        if (lane == 0) {
          me.item = -1;
          mbar_arrive(&s_full[r]);
        }
        break;
      }
      const int chunk = item / a.tiles, tile = item - chunk * a.tiles;
      const int i0 = chunk * a.rows, nrows = min(a.rows, a.m - i0);
      const int col0 = tile * kTileCols, ncols = min(kTileCols, a.f - col0);
      const int i = i0 + lane;
      bool in = false, nd = false, st = false;
      int src = 0, nn = 0, on = 0;
      if (lane < nrows) {  // every load at once: one round trip
        in = a.mask == nullptr || a.mask[i];
        nd = a.need == nullptr || a.need[i];
        st = kSeg && a.seg_start[i] == i;
        src = a.order != nullptr ? (int)a.order[i] : i;
        if (kRadius) nn = a.new_n[i];
        if (kRadius && kOld) on = a.old_n[i];
      }
      // Rows whose row_ls slice the result needs: with segments every row
      // in the mask (it feeds later rows' prefix), else the needed ones
      const bool load_row = kSeg ? in : (in && nd);
      const unsigned live = __ballot_sync(0xffffffffu, kSeg ? (in || nd) : nd);
      const unsigned starts = __ballot_sync(0xffffffffu, st);
      const unsigned in_mask = __ballot_sync(0xffffffffu, in);
      if (lane < nrows) {
        uint8_t fl = (in ? kInMask : 0) | (st ? kStart : 0) | (nd ? kNeed : 0);
        if (kRadius) {
          me.half[0][lane] = __int2float_rn(nn) * 0.5f;
          if (nn <= 1) fl |= kSingle;
          if (kOld) me.half[1][lane] = __int2float_rn(max(on, 2)) * 0.5f;
        }
        me.src[lane] = src;
        me.flag[lane] = fl;
      }
      if (lane == 0) {
        me.item = item;
        me.live = live;
        me.starts = starts;
      }
      int* slot = s_tab + r * slot_ints;
      if (a.bulk && lane < a.rows) {
        // Every lane of a stage arrives on its barriers at every item (no
        // bytes where nothing is read), so the phases stay in step
        const int s = lane / kStageRows;
        const bool go = live != 0 && lane < nrows;
        const uint32_t bytes = (uint32_t)ncols * 4;
        const size_t off = (size_t)src * a.f + col0;
        mbar_arrive_expect_tx(&s_bar[r][0][s], go && load_row ? bytes : 0);
        if (go && load_row) bulk_copy(slot + lane * kTileCols, a.row_ls + off, bytes, &s_bar[r][0][s]);
        mbar_arrive_expect_tx(&s_bar[r][1][s], go && nd ? bytes : 0);
        if (go && nd) {
          bulk_copy(slot + (a.rows + lane) * kTileCols, a.cand_ls + off, bytes, &s_bar[r][1][s]);
        }
      }
      __syncwarp();
      if (!a.bulk && live != 0) {  // plain loads, each row slice once; zeros up to 4 columns
        const int ncols4 = (ncols + 3) & ~3;
        for (int t = 0; t < nrows; ++t) {
          const uint8_t fl = me.flag[t];
          const size_t row = (size_t)me.src[t] * a.f + col0;
          for (int c = lane; c < ncols4; c += 32) {
            if (kSeg ? (fl & kInMask) : (fl & kInMask) && (fl & kNeed)) {
              slot[t * kTileCols + c] = c < ncols ? __ldg(a.row_ls + row + c) : 0;
            }
            if (fl & kNeed) slot[(a.rows + t) * kTileCols + c] = c < ncols ? __ldg(a.cand_ls + row + c) : 0;
          }
        }
        __syncwarp();
      }
      if (kSeg) {
        // ---- the tail: s since the chunk's last segment start.  A chunk
        // that holds a start publishes it as its inclusive prefix, one
        // that holds none as an aggregate (zeros where nothing is read) ----
        const int last = starts != 0 ? 31 - __clz(starts) : 0;
        if (a.bulk && live != 0) {
          for (int s = last / kStageRows; s * kStageRows < nrows; ++s) {
            mbar_wait(&s_bar[r][0][s], parity);
          }
        }
        int acc[kHalves][4] = {};  // columns h * 128 + 4 lane + j
        if (live != 0 && (in_mask >> last) != 0) {
          for (int t = last; t < nrows; ++t) {
            if (!(me.flag[t] & kInMask)) continue;
#pragma unroll
            for (int h = 0; h < kHalves; ++h) {
              const int4 v = *reinterpret_cast<const int4*>(slot + t * kTileCols + h * 128 + 4 * lane);
              acc[h][0] = wrap_add(acc[h][0], v.x);
              acc[h][1] = wrap_add(acc[h][1], v.y);
              acc[h][2] = wrap_add(acc[h][2], v.z);
              acc[h][3] = wrap_add(acc[h][3], v.w);
            }
          }
        }
        unsigned long long* w = a.words + (size_t)chunk * a.f + col0;
        const unsigned long long flag = starts != 0 ? kInc : kAgg;
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = h * 128 + 4 * lane + j;
            s_tail[r][c] = acc[h][j];
            if (c < ncols) put_word(w + c, flag, acc[h][j]);
          }
        }
        __syncwarp();
      }
      if (lane == 0) mbar_arrive(&s_full[r]);
    }
    return;
  }

  // ---- the consumers: one column each in the look-back and the rescan,
  // a warp a row in the moments ----
  for (int k = 0;; ++k) {
    const int r = k % kRing;
    const uint32_t parity = (k / kRing) & 1;
    mbar_wait(&s_full[r], parity);
    const Meta& me = s_meta[r];
    const int item = me.item;
    if (item < 0) break;
    const int chunk = item / a.tiles, tile = item - chunk * a.tiles;
    const int i0 = chunk * a.rows, nrows = min(a.rows, a.m - i0);
    const int col0 = tile * kTileCols, ncols = min(kTileCols, a.f - col0);
    const unsigned live = me.live, starts = me.starts;
    int* s_row = s_tab + r * slot_ints;
    int* s_cand = s_row + a.rows * kTileCols;
    const bool col_ok = tid < ncols;

    if (live != 0) {  // else nothing to read and nothing to write
      if (kSeg) {
        // ---- look-back: the carry into the chunk's first row, each
        // thread its column, kWindow predecessors' words at once; a chunk
        // without a start publishes carry + tail as its inclusive prefix ----
        int carry = 0;
        if (!(starts & 1u) && col_ok) {
          const unsigned long long* w = a.words + col0 + tid;
          for (int kb = chunk - 1;;) {
            unsigned long long v[kWindow];
#pragma unroll
            for (int q = 0; q < kWindow; ++q) {
              // Before chunk 0 (only where seg_start[0] != 0, outside the
              // contract) an empty prefix
              v[q] = kb - q >= 0 ? get_word(w + (size_t)(kb - q) * a.f) : kInc;
            }
            int q = 0;
            bool done = false;
            for (; q < kWindow; ++q) {
              const unsigned long long flag = v[q] & ~0xffffffffull;
              if (flag == 0) break;  // not yet published: read again from here
              carry = wrap_add(carry, (int)(unsigned)v[q]);
              if (flag == kInc) {
                done = true;
                break;
              }
            }
            if (done) break;
            kb -= q;
          }
          if (starts == 0) {
            put_word(a.words + (size_t)chunk * a.f + col0 + tid, kInc,
                     wrap_add(carry, s_tail[r][tid]));
          }
        }

        // ---- rescan: y = cand + prefix over the cand_ls rows ----
        int run = carry;
        for (int t = 0; t < nrows; ++t) {
          if (a.bulk && t % kStageRows == 0) {
            mbar_wait(&s_bar[r][0][t / kStageRows], parity);
            mbar_wait(&s_bar[r][1][t / kStageRows], parity);
          }
          const uint8_t fl = me.flag[t];
          if (fl & kStart) run = 0;
          if (col_ok) {
            if (fl & kNeed) s_cand[t * kTileCols + tid] = wrap_add(s_cand[t * kTileCols + tid], run);
            if (fl & kInMask) run = wrap_add(run, s_row[t * kTileCols + tid]);
          }
        }
        consumer_sync();
      }

      // ---- moments: a warp a needed row ----
      for (int t = warp; t < nrows; t += kWarps) {
        const uint8_t fl = me.flag[t];
        if (!(fl & kNeed)) continue;
        if (!kSeg && a.bulk) {
          mbar_wait(&s_bar[r][0][t / kStageRows], parity);
          mbar_wait(&s_bar[r][1][t / kStageRows], parity);
        }
        const float half_new = kRadius ? me.half[0][t] : 0.f;
        const float half_old = kRadius && kOld ? me.half[1][t] : 0.f;
        const bool single = fl & kSingle;
        const bool in = fl & kInMask;
        unsigned long long mom[kMom];
#pragma unroll
        for (int q = 0; q < kMom; ++q) mom[q] = 0;
        const int4* yrow = reinterpret_cast<const int4*>(s_cand + t * kTileCols);
        const int4* srow = reinterpret_cast<const int4*>(s_row + t * kTileCols);
        for (int c4 = lane; c4 * 4 < ncols; c4 += 32) {
          const int4 y4 = yrow[c4];
          const int4 s4 = in ? srow[c4] : make_int4(0, 0, 0, 0);
          const int ys[4] = {y4.x, y4.y, y4.z, y4.w};
          const int ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            add_moments<kRadius>(wrap_add(ys[j], ss[j]), half_new, single, mom);
            if (kOld) add_moments<kRadius>(ys[j], half_old, false, mom + kSide);
          }
        }
#pragma unroll
        for (int q = 0; q < kMom; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) mom[q] += __shfl_xor_sync(0xffffffffu, mom[q], off);
        }
        if (lane < kMom) {
          unsigned long long v = mom[0];
#pragma unroll
          for (int q = 1; q < kMom; ++q) v = lane == q ? mom[q] : v;
          unsigned long long* dst = a.out + (size_t)lane * a.m + i0 + t;
          if (a.tiles > 1) {
            atomicAdd(dst, v);
          } else {
            *dst = v;
          }
        }
      }
    }
    // ---- release the slot: the producer's next bulk copies (the async
    // proxy) come after these threads' reads and writes of it ----
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();
    if (tid == 0) mbar_arrive(&s_empty[r]);
  }
}

template <bool kSeg>
int launch(const Args& a, bool radius, bool old, cudaStream_t stream) {
  auto kernel = radius ? (old ? prefix_commit_kernel<kSeg, true, true>
                              : prefix_commit_kernel<kSeg, true, false>)
                       : (old ? prefix_commit_kernel<kSeg, false, true>
                              : prefix_commit_kernel<kSeg, false, false>);
  const size_t smem = (size_t)kRing * 2 * a.rows * kTileCols * 4;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  const int resident = (per_sm > 0 ? per_sm : 1) * n_sm;
  kernel<<<a.items < resident ? a.items : resident, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The moments of the contract above for m sorted rows of f columns, in
// chunks of `rows` (1-32) rows and tiles of 256 columns; radius / old
// choose the moments (2, 4 or 8 rows of `out`).  With seg_start, `status`
// is (1 + chunks * f) int64 of zeros (chunks = ceil(m / rows)): the ticket
// in the first, then each chunk's flagged words; without it, it may be
// null.  bulk = 1 needs f % 4 == 0 and both tables 16-byte aligned.
// `out` must hold zeros (rows outside `need` stay so; where f spans
// several tiles they add into it).  One launch on `stream`; returns 0 or
// the CUDA error after it.
int bb_prefix_commit(const void* row_ls, const void* cand_ls, const void* order,
                     const void* mask, const void* seg_start, const void* need,
                     const void* new_n, const void* old_n, void* status, void* out, int m,
                     int f, int rows, int radius, int old, int bulk, void* stream) {
  if (m < 1 || f < 1 || rows < 1 || rows > kMaxRows || (seg_start != nullptr && status == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bulk && (f % 4 != 0 || reinterpret_cast<uintptr_t>(row_ls) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(cand_ls) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = (m + rows - 1) / rows;
  const int tiles = (f + kTileCols - 1) / kTileCols;
  unsigned long long* st = static_cast<unsigned long long*>(status);
  const Args a{
      static_cast<const int*>(row_ls), static_cast<const int*>(cand_ls),
      static_cast<const int64_t*>(order), static_cast<const bool*>(mask),
      static_cast<const int64_t*>(seg_start), static_cast<const bool*>(need),
      static_cast<const int*>(new_n), static_cast<const int*>(old_n),
      reinterpret_cast<unsigned*>(st), st == nullptr ? nullptr : st + 1,
      static_cast<unsigned long long*>(out), m, f, rows, tiles, chunks * tiles, bulk,
  };
  const cudaStream_t s = (cudaStream_t)stream;
  return seg_start != nullptr ? launch<true>(a, radius != 0, old != 0, s)
                              : launch<false>(a, radius != 0, old != 0, s);
}

}  // extern "C"
