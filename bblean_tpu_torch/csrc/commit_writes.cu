// The insert round's step 7 and step 8 for NVIDIA Hopper (sm_90a): each
// surviving merge segment's committed rows summed into its pool row and its
// count added to its cluster, each promotion's and pooled creation's pool
// row and pool ref set, each committed creation's count added and its
// majority-vote centroid packed into its tile cell, without an (M, F) plane
// in between.
//
// == What it replaces ==
//
// bblean_tpu/engine/batch.py:572-579 (the joint creations' sums spread to
// their rows), :660-684 (step 7: the created clusters' tile entries) and
// :686-736 (step 8: the linear-sum pool's promotions, adds and pooled
// creations, the pool refs and the cluster counts), which XLA fuses inside
// the jitted step.  ops/commit_writes.py keeps the torch chain the port ran
// before (the gathers, selects, segment sums, the vote and the drop-mode
// scatters over (M, F) planes) as the plain version.
//
// Contract, equal to the plain version bit for bit (int32 sums wrap).
// Sorted positions p (the round's candidate sort, `aorder`, segments
// `agrp`): a segment's writer is its one position with seg_any[p];
// promo[p] and adder[p] hold only at writers.  seg_add = the sum of
// row_ls[aorder[p]] and seg_n the sum of row_n[aorder[p]] over the
// segment's positions with committed[p].  At a writer w:
//   promo:   ls[ref_promo[w]] = bits of t_pk[group[best_s[w]]][pos[best_s[w]]]
//            + seg_add;  ls_ref[best_s[w]] = ref_promo[w]
//   adder:   ls[cand_ref[w]] += seg_add
//   seg_any: n[best_s[w]] += seg_n
// Rows r:
//   create_pool[r]:   ls[ref_create[r]] = join_ok[r] ? gj_ls[jseg[r]] : row_ls[r];
//                     ls_ref[new_slot[r]] = ref_create[r]
//   create_commit[r]: n[new_slot[r]] += pool_created_n[r]; with
//                     s = join_ok[r] & fits[r] ? gj_ls[jseg[r]] : row_ls[r] and
//                     c = max(created_n[r], 1), the vote v = c <= 1 ?
//                     clamp(s, 0, 1) : f32(s) >= f32(c) * 0.5 written at
//                     cell[r] of the flattened (G * Fc) tiles: t_pk its
//                     packed bits (big-endian in each byte), t_pops its
//                     popcount, t_slot new_slot[r].
// row_single[r] promises that row_ls[r] is the bits of row_pk[r] (a row of
// one fingerprint: the producers set it once a step); the kernel then
// reads the row's 256 packed bytes in place of its 8 KiB of sums.
// Writes outside the masks, and at indices outside a table, do not happen
// (JAX's mode="drop"); kept indices are unique.  The promotions' cells are
// read before any tile is written.
//
// == The bound ==
//
// Each committed row once (F / 8 bytes where row_single, else 4F), the
// gj_ls rows of the pooled or created joint creations and the own sums
// that the pooled creations copy and the unflagged creations vote, each
// written pool row once (and read for the adders), the promoted
// candidates' cells, 256 B + 8 B a written tile cell, the refs and counts,
// over 3.35 TB/s: a wide round mid-fit moves about 2 MB, under a
// microsecond.  What is left is launches and latency, so the design sizes
// its grids to the round's work and keeps every load of a block in flight
// at once.
//
// == Design ==
//
// Two launches in stream order, no memset, no allocation:
//   1. writes_sets_kernel, ceil(M / 32) blocks: the first warp takes 32
//      indices (one ballot): each writer records its position in a
//      per-segment word, the refs and the creations' counts are set or
//      added, and the promotions (the candidate's cell unpacked) and the
//      pooled creations (16-byte copies) are listed; the block's eight
//      warps then write those rows, one warp a row, each lane with eight
//      loads in flight.
//   2. writes_adds_cells_kernel, a persistent grid of at most four blocks
//      an SM over the items (chunk of 32 sorted positions, 2048 columns)
//      and (32 creation rows).  A chunk item lists its committed
//      positions by ballot (a chunk without one costs that ballot), finds
//      each one's writer through the segment's word (checked against the
//      writer's own segment and flag, so the word needs no reset), copies
//      the flagged rows' packed bytes to shared memory with cp.async, and
//      sums: a thread owns columns t, t + 256, ..., t + 1792, so that its
//      int32 loads and its atomics are coalesced across the warp; a run
//      of positions of one segment adds in registers and flushes one
//      atomic a column at each change of segment (a segment of thousands
//      of rows spreads over many blocks: integer adds are exact in any
//      order), with the run's count added to n by one atomic.  Unflagged
//      rows read their int32 sums eight rows at a time.  A creation item
//      lists its committed creations by ballot and the block's warps write
//      a cell each: a flagged own creation (c <= 1) copies its packed row
//      (the vote of 0/1 sums at c = 1 is the sums), the others vote over
//      int32 sums.
// Both run inside the round's CUDA graph, with no host synchronisation.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;       // threads a block, both launches
constexpr int kChunk = 32;          // sorted positions an add item
constexpr int kCols = 8;            // columns a thread of an add item
constexpr int kTileCols = kThreads * kCols;  // columns an add item
constexpr int kTileBytes = kTileCols / 8;    // their packed bytes
constexpr int kBatch = 8;           // unflagged rows whose loads are in flight at once
constexpr int kUnroll = 8;          // loads a lane in flight in a row copy
constexpr int kVote = 4;            // bytes a lane votes from one batch of loads
constexpr int kBlocksPerSm = 4;     // the adds' persistent grid
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int* ls;
  unsigned char* t_pk;
  int* t_pops;
  int* t_slot;
  int* ls_ref;
  int* n;
  const int* group;
  const int* pos;
  const int* row_ls;
  const unsigned char* row_pk;
  const int* gj_ls;
  const bool* row_single;
  const int* row_n;
  const int64_t* aorder;
  const int* agrp;
  const bool* committed;
  const bool* seg_any;
  const bool* promo;
  const bool* adder;
  const int* ref_promo;
  const int* cand_ref;
  const int* best_s;
  const int* jseg;
  const bool* join_ok;
  const bool* fits;
  const bool* create_pool;
  const int* ref_create;
  const bool* create_commit;
  const int* created_n;
  const int* pool_created_n;
  const int* cell;
  const int* new_slot;
  int* seg_writer;  // (m,) each segment's writer position, read only where it checks out
  int m;
  int f;
  int f8;
  int fc;           // cells a tile
  int p_cap;        // pool rows
  int n_cells;      // G * Fc
  int c_cap;        // cluster slots
  int g_cap;        // groups
  int vec;          // f % 8 == 0 and ls, row_ls, gj_ls 16-byte aligned
  int pk_bulk;      // f8 % 16 == 0 and row_pk 16-byte aligned: cp.async of 16 B
  int pk_words;     // f % 64 == 0 and row_pk, t_pk 8-byte aligned: cells copied 8 B a lane
  int col_tiles;    // column tiles of kTileCols
  int add_items;    // chunks * col_tiles
  int items;        // add items, then creation items of 32 rows
};

__device__ __forceinline__ bool in(int i, int cap) { return i >= 0 && i < cap; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[0:f] = src[0:f], by one warp, kUnroll 16-byte loads a lane in
// flight before their stores (a store may alias the source, so the
// compiler would not move a later load above it)
__device__ __forceinline__ void copy_row(int* dst, const int* src, int f, bool vec, int lane) {
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int n4 = f / 4;
    for (int k0 = lane; k0 < n4; k0 += 32 * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + 32 * u;
        if (k < n4) v[u] = __ldg(s4 + k);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + 32 * u;
        if (k < n4) d4[k] = v[u];
      }
    }
  } else {
    for (int c0 = lane; c0 < f; c0 += 32 * kUnroll) {
      int v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < f) v[u] = __ldg(src + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < f) dst[c] = v[u];
      }
    }
  }
}

// dst[0:f] = the bits of the packed row `bits`, by one warp
__device__ __forceinline__ void unpack_row(int* dst, const unsigned char* bits, int f, int f8,
                                           bool vec, int lane) {
  for (int b0 = lane; b0 < f8; b0 += 32 * kUnroll) {
    unsigned v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + 32 * u;
      v[u] = b < f8 ? bits[b] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + 32 * u;
      if (b >= f8) break;
      const unsigned x = v[u];
      const int c0 = 8 * b;
      if (vec) {
        int4* d4 = reinterpret_cast<int4*>(dst + c0);
        d4[0] = make_int4((x >> 7) & 1, (x >> 6) & 1, (x >> 5) & 1, (x >> 4) & 1);
        d4[1] = make_int4((x >> 3) & 1, (x >> 2) & 1, (x >> 1) & 1, x & 1);
      } else {
        for (int k = 0; k < 8 && c0 + k < f; ++k) dst[c0 + k] = (x >> (7 - k)) & 1;
      }
    }
  }
}

// One block's jobs, listed by its first warp (a ballot over 32 indices)
// and taken by its warps in turn, so that each row is written by a warp
// of its own and not after the other rows of its ballot
struct Jobs {
  int index[2 * 32];  // the index of each job (a second kind after the first)
  int count[2];
};

__global__ void __launch_bounds__(kThreads) writes_sets_kernel(Args a) {
  __shared__ Jobs jobs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (warp == 0) {
    const int i = blockIdx.x * 32 + lane;
    bool promo_row = false, pool_row = false;
    if (i < a.m) {
      // Every load is issued before any is tested (one round trip)
      const bool any = a.seg_any[i], promo = a.promo[i], pool = a.create_pool[i];
      const bool commit = a.create_commit[i], join_ok = a.join_ok[i];
      const int seg = a.agrp[i], ref_promo = a.ref_promo[i], best = a.best_s[i];
      const int ref_create = a.ref_create[i], slot = a.new_slot[i], js = a.jseg[i];
      const int pool_n = a.pool_created_n[i];
      if (any && in(seg, a.m)) a.seg_writer[seg] = i;
      if (promo && in(best, a.c_cap)) {
        a.ls_ref[best] = ref_promo;
        promo_row = in(ref_promo, a.p_cap) && in(a.group[best], a.g_cap) && in(a.pos[best], a.fc);
      }
      if (pool) {
        if (in(slot, a.c_cap)) a.ls_ref[slot] = ref_create;
        pool_row = in(ref_create, a.p_cap) && (!join_ok || in(js, a.m));
      }
      if (commit && in(slot, a.c_cap)) atomicAdd(a.n + slot, pool_n);
    }
    const unsigned lt = (1u << lane) - 1u;
    const unsigned bp = __ballot_sync(kFull, promo_row);
    const unsigned bc = __ballot_sync(kFull, pool_row);
    if (promo_row) jobs.index[__popc(bp & lt)] = i;
    if (pool_row) jobs.index[32 + __popc(bc & lt)] = i;
    if (lane == 0) {
      jobs.count[0] = __popc(bp);
      jobs.count[1] = __popc(bc);
    }
  }
  __syncthreads();
  const int n_promo = jobs.count[0];
  for (int j = warp; j < n_promo + jobs.count[1]; j += kThreads / 32) {
    if (j < n_promo) {
      const int i = jobs.index[j];
      const int slot = a.best_s[i];
      const unsigned char* cand = a.t_pk + ((size_t)a.group[slot] * a.fc + a.pos[slot]) * a.f8;
      unpack_row(a.ls + (size_t)a.ref_promo[i] * a.f, cand, a.f, a.f8, a.vec != 0, lane);
    } else {
      const int i = jobs.index[32 + j - n_promo];
      const int* src = a.join_ok[i] ? a.gj_ls + (size_t)a.jseg[i] * a.f : a.row_ls + (size_t)i * a.f;
      copy_row(a.ls + (size_t)a.ref_create[i] * a.f, src, a.f, a.vec != 0, lane);
    }
  }
}

struct AddSmem {
  unsigned char bits[kChunk][kTileBytes];  // the flagged rows' packed bytes
  int row[kChunk];   // the chunk's committed positions, in order: their row,
  int seg[kChunk];   // segment,
  int t_ls[kChunk];  // pool row (-1: none),
  int t_n[kChunk];   // cluster slot (-1: none),
  int rn[kChunk];    // row_n
  int single[kChunk];
  int count[kChunk / 32];
};

// One (chunk, column tile) item of the adds
__device__ __forceinline__ void add_item(const Args& a, AddSmem& s, int item) {
  const int chunk = item / a.col_tiles;
  const int tile = item - chunk * a.col_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = chunk * kChunk + tid;
  __syncthreads();  // the previous item is done with the shared memory
  // Every load a level needs is issued before any is tested: a test
  // between two loads would make them two round trips
  bool mine = false;
  int row = 0, seg = 0;
  if (tid < kChunk && p < a.m) {
    mine = a.committed[p];
    row = (int)a.aorder[p];
    seg = a.agrp[p];
  }
  unsigned bal = 0u;
  if (warp < kChunk / 32) {
    bal = __ballot_sync(kFull, mine);
    if (lane == 0) s.count[warp] = __popc(bal);
  }
  __syncthreads();
  int total = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kChunk / 32; ++w) {
    const int c = s.count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (total == 0) return;
  if (mine) {
    const int k = before + __popc(bal & ((1u << lane) - 1u));
    const int w = in(seg, a.m) ? a.seg_writer[seg] : -1;
    int t_ls = -1, t_n = -1, rn = 0;
    bool single = false;
    if (in(row, a.m) && in(w, a.m)) {
      const int w_seg = a.agrp[w];
      const bool w_any = a.seg_any[w], w_promo = a.promo[w], w_adder = a.adder[w];
      const int ref_promo = a.ref_promo[w], cand_ref = a.cand_ref[w], best = a.best_s[w];
      rn = a.row_n[row];
      single = a.row_single[row];
      if (w_seg == seg && w_any) {
        t_ls = w_promo ? ref_promo : (w_adder ? cand_ref : -1);
        if (!in(t_ls, a.p_cap)) t_ls = -1;
        t_n = in(best, a.c_cap) && tile == 0 ? best : -1;
      }
    }
    s.row[k] = row;
    s.seg[k] = seg;
    s.t_ls[k] = t_ls;
    s.t_n[k] = t_n;
    s.rn[k] = t_n >= 0 ? rn : 0;
    s.single[k] = t_ls >= 0 && single;
  }
  __syncthreads();
  // The flagged rows' bytes of this column tile into shared memory
  const int b0 = tile * kTileBytes;
  const int nb = min(kTileBytes, a.f8 - b0);
  if (a.pk_bulk) {
    constexpr int kPieces = kTileBytes / 16;
    for (int q = tid; q < total * kPieces; q += kThreads) {
      const int k = q / kPieces;
      const int off = (q - k * kPieces) * 16;
      if (s.single[k] && off < nb) {
        cp_async16(&s.bits[k][off], a.row_pk + (size_t)s.row[k] * a.f8 + b0 + off);
      }
    }
    cp_async_wait_all();
  } else {
    for (int q = tid; q < total * kTileBytes; q += kThreads) {
      const int k = q / kTileBytes;
      const int off = q - k * kTileBytes;
      if (s.single[k] && off < nb) s.bits[k][off] = a.row_pk[(size_t)s.row[k] * a.f8 + b0 + off];
    }
  }
  __syncthreads();
  // Column c0 + 256 j of the tile is bit 7 - (tid & 7) of byte (tid >> 3) + 32 j
  const int c0 = tile * kTileCols + tid;
  const int byte0 = tid >> 3;
  const int shift = 7 - (tid & 7);
  unsigned acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0u;
  int n_sum = 0;
  for (int k0 = 0; k0 < total; k0 += kBatch) {
    unsigned v[kBatch][kCols];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u;
      const bool add = k < total && s.t_ls[k] >= 0;
      if (add && s.single[k]) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[u][j] = (s.bits[k][byte0 + 32 * j] >> shift) & 1u;
      } else if (add) {
        const int* src = a.row_ls + (size_t)s.row[k] * a.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + kThreads * j;
          v[u][j] = c < a.f ? (unsigned)__ldg(src + c) : 0u;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[u][j] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u;
      if (k >= total) break;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] += v[u][j];
      n_sum += s.rn[k];
      if (k + 1 == total || s.seg[k + 1] != s.seg[k]) {  // the run ends: flush
        const int t = s.t_ls[k];
        if (t >= 0) {
          int* dst = a.ls + (size_t)t * a.f;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int c = c0 + kThreads * j;
            if (c < a.f) atomicAdd(reinterpret_cast<unsigned*>(dst + c), acc[j]);
          }
        }
        if (tid == 0 && s.t_n[k] >= 0 && n_sum != 0) atomicAdd(a.n + s.t_n[k], n_sum);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = 0u;
        n_sum = 0;
      }
    }
  }
}

// One committed creation's tile cell, by one warp
__device__ __forceinline__ void tile_cell(const Args& a, int r, int lane) {
  const int cell = a.cell[r];
  const bool join_ok = a.join_ok[r], fits = a.fits[r], single = a.row_single[r];
  const int c = max(a.created_n[r], 1), js = a.jseg[r], slot = a.new_slot[r];
  const bool joint = join_ok && fits;
  unsigned char* out = a.t_pk + (size_t)cell * a.f8;
  int count = 0;
  if (!joint && c <= 1 && single) {
    // Its vote is its own 0/1 sums: the packed row (pad bits cleared)
    const unsigned char* src = a.row_pk + (size_t)r * a.f8;
    if (a.pk_words) {
      for (int q = lane; q < a.f8 / 8; q += 32) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(src) + q);
        reinterpret_cast<uint2*>(out)[q] = w;
        count += __popc(w.x) + __popc(w.y);
      }
    } else {
      const unsigned tail = (a.f & 7) ? (0xffu << (8 - (a.f & 7))) & 0xffu : 0xffu;
      for (int b = lane; b < a.f8; b += 32) {
        const unsigned v = src[b] & (b == a.f8 - 1 ? tail : 0xffu);
        out[b] = (unsigned char)v;
        count += __popc(v);
      }
    }
  } else {
    const int* s = joint ? a.gj_ls + (size_t)js * a.f : a.row_ls + (size_t)r * a.f;
    const float half = (float)c * 0.5f;
    for (int b0 = lane; b0 < a.f8; b0 += 32 * kVote) {
      int x[kVote][8];
#pragma unroll
      for (int u = 0; u < kVote; ++u) {
        const int c0 = (b0 + 32 * u) * 8;
        if (a.vec && c0 < a.f) {
          const int4 lo = __ldg(reinterpret_cast<const int4*>(s + c0));
          const int4 hi = __ldg(reinterpret_cast<const int4*>(s + c0 + 4));
          x[u][0] = lo.x; x[u][1] = lo.y; x[u][2] = lo.z; x[u][3] = lo.w;
          x[u][4] = hi.x; x[u][5] = hi.y; x[u][6] = hi.z; x[u][7] = hi.w;
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) x[u][k] = c0 + k < a.f ? __ldg(s + c0 + k) : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kVote; ++u) {
        const int b = b0 + 32 * u;
        if (b >= a.f8) break;
        unsigned v = 0u;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const bool bit = 8 * b + k < a.f && (c <= 1 ? x[u][k] >= 1 : (float)x[u][k] >= half);
          v |= (unsigned)bit << (7 - k);
        }
        out[b] = (unsigned char)v;
        count += __popc(v);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(kFull, count, o);
  if (lane == 0) {
    a.t_pops[cell] = count;
    a.t_slot[cell] = slot;
  }
}

// One item of 32 creation rows: the first warp lists the committed
// creations, the block's warps write a cell each in turn
__device__ __forceinline__ void cell_item(const Args& a, Jobs& jobs, int item) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();  // the previous item is done with the list
  if (warp == 0) {
    const int r = item * 32 + lane;
    bool mine = false;
    if (r < a.m) {
      const bool commit = a.create_commit[r], joint = a.join_ok[r] && a.fits[r];
      const int cell = a.cell[r], js = a.jseg[r];
      mine = commit && in(cell, a.n_cells) && !(joint && !in(js, a.m));
    }
    const unsigned bal = __ballot_sync(kFull, mine);
    if (mine) jobs.index[__popc(bal & ((1u << lane) - 1u))] = r;
    if (lane == 0) jobs.count[0] = __popc(bal);
  }
  __syncthreads();
  for (int j = warp; j < jobs.count[0]; j += kThreads / 32) tile_cell(a, jobs.index[j], lane);
}

__global__ void __launch_bounds__(kThreads) writes_adds_cells_kernel(Args a) {
  __shared__ __align__(16) AddSmem s;
  __shared__ Jobs jobs;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    if (item < a.add_items) {
      add_item(a, s, item);
    } else {
      cell_item(a, jobs, item - a.add_items);
    }
  }
}

}  // namespace

extern "C" {

// The contract above for m rows of f columns: ls (p_cap, f) int32, t_pk
// (g_cap * fc, f8) uint8, t_pops and t_slot (g_cap * fc) int32, ls_ref
// and n (c_cap) int32, updated in place; group and pos (c_cap) int32;
// row_ls and gj_ls (m, f) int32; row_pk (m, f8) uint8; aorder (m) int64;
// the other inputs (m) int32 or bool as named.  seg_writer is (m) int32
// scratch of any content.  Two launches on `stream` (the current
// device's); returns 0 or the CUDA error after them.
int bb_commit_writes(void* ls, void* t_pk, void* t_pops, void* t_slot, void* ls_ref, void* n,
                     const void* group, const void* pos, const void* row_ls, const void* row_pk,
                     const void* gj_ls, const void* row_single, const void* row_n,
                     const void* aorder, const void* agrp, const void* committed,
                     const void* seg_any, const void* promo, const void* adder,
                     const void* ref_promo, const void* cand_ref, const void* best_s,
                     const void* jseg, const void* join_ok, const void* fits,
                     const void* create_pool, const void* ref_create, const void* create_commit,
                     const void* created_n, const void* pool_created_n, const void* cell,
                     const void* new_slot, void* seg_writer, int m, int f, int p_cap, int g_cap,
                     int fc, int c_cap, void* stream) {
  if (m < 1 || f < 1 || p_cap < 1 || g_cap < 1 || fc < 1 || c_cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return (int)err;
  }
  auto aligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; };
  const int f8 = (f + 7) / 8;
  const int col_tiles = (f + kTileCols - 1) / kTileCols;
  const int chunks = (m + kChunk - 1) / kChunk;
  const int rows_items = (m + 31) / 32;
  const Args a{
      static_cast<int*>(ls), static_cast<unsigned char*>(t_pk), static_cast<int*>(t_pops),
      static_cast<int*>(t_slot), static_cast<int*>(ls_ref), static_cast<int*>(n),
      static_cast<const int*>(group), static_cast<const int*>(pos),
      static_cast<const int*>(row_ls), static_cast<const unsigned char*>(row_pk),
      static_cast<const int*>(gj_ls), static_cast<const bool*>(row_single),
      static_cast<const int*>(row_n), static_cast<const int64_t*>(aorder),
      static_cast<const int*>(agrp), static_cast<const bool*>(committed),
      static_cast<const bool*>(seg_any), static_cast<const bool*>(promo),
      static_cast<const bool*>(adder), static_cast<const int*>(ref_promo),
      static_cast<const int*>(cand_ref), static_cast<const int*>(best_s),
      static_cast<const int*>(jseg), static_cast<const bool*>(join_ok),
      static_cast<const bool*>(fits), static_cast<const bool*>(create_pool),
      static_cast<const int*>(ref_create), static_cast<const bool*>(create_commit),
      static_cast<const int*>(created_n), static_cast<const int*>(pool_created_n),
      static_cast<const int*>(cell), static_cast<const int*>(new_slot),
      static_cast<int*>(seg_writer),
      m, f, f8, fc, p_cap, g_cap * fc, c_cap, g_cap,
      f % 8 == 0 && aligned(ls, 16) && aligned(row_ls, 16) && aligned(gj_ls, 16),
      f8 % 16 == 0 && aligned(row_pk, 16),
      f % 64 == 0 && aligned(row_pk, 8) && aligned(t_pk, 8),
      col_tiles, chunks * col_tiles, chunks * col_tiles + rows_items,
  };
  const cudaStream_t s = (cudaStream_t)stream;
  writes_sets_kernel<<<rows_items, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid = a.items < kBlocksPerSm * n_sm ? a.items : kBlocksPerSm * n_sm;
  writes_adds_cells_kernel<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
