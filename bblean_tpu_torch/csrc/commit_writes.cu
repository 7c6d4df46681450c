// The insert round's pool and tile writes for NVIDIA Hopper (sm_90a): each
// surviving merge segment's committed rows summed into its pool row, each
// pooled creation's sums copied to its new pool row, and each committed
// creation's majority-vote centroid packed into its tile cell, without an
// (M, F) plane in between.
//
// == What it replaces ==
//
// bblean_tpu/engine/batch.py:572-579 (the joint creations' sums spread to
// their rows), :660-684 (step 7: the created clusters' tile entries) and
// :686-723 (step 8: the linear-sum pool's promotions, adds and pooled
// creations), which XLA fuses inside the jitted step.
// ops/commit_writes.py keeps the torch chain the port ran before (the
// gathers, selects, segment sums, the vote and the drop-mode scatters over
// (M, F) planes) as the plain version.
//
// Contract, equal to the plain version bit for bit (int32 sums wrap).
// Sorted positions p (the round's candidate sort, `aorder`, segments
// `agrp`): the writer of a segment is its one position with promo[p] or
// adder[p]; seg_add = the sum of row_ls[aorder[p]] over the segment's
// positions with committed[p].
//   promo:  ls[ref_promo[p]] = bits of t_pk[group[best_s[p]]][pos[best_s[p]]]
//           + seg_add
//   adder:  ls[cand_ref[p]] += seg_add
// Rows r:
//   create_pool[r]:   ls[ref_create[r]] = join_ok[r] ? gj_ls[jseg[r]] : row_ls[r]
//   create_commit[r]: with s = join_ok[r] & fits[r] ? gj_ls[jseg[r]] : row_ls[r]
//                     and n = max(created_n[r], 1), the vote v = n <= 1 ?
//                     clamp(s, 0, 1) : f32(s) >= f32(n) * 0.5 written at
//                     cell[r] of the flattened (G * Fc) tiles: t_pk its
//                     packed bits (big-endian in each byte), t_pops its
//                     popcount, t_slot new_slot[r].
// Writes outside the masks, and at indices outside a table, do not happen
// (JAX's mode="drop"); kept indices are unique.  The promotions' cells are
// read before any tile is written.
//
// == The bound ==
//
// The committed rows' row_ls once, the gj_ls rows of the pooled or
// created joint creations once, each written pool row once (and read for
// the adders), the promoted candidates' cells, and 256 B + 8 B a written
// tile cell, over 3.35 TB/s: a few MiB a wide round mid-fit, a few
// microseconds.  The plain version moves about 3 GiB of (M, F) planes.
//
// == Design ==
//
// Two launches in stream order:
//   1. writes_sets_kernel, a warp per index r (16-byte accesses where the
//      tables allow): the segment writer at sorted position r records its pool
//      row in a per-segment word (-1 where the write drops) and, for a
//      promotion, writes the candidate's unpacked bits there; a pooled
//      creation at row r copies its sums to its new pool row.
//   2. writes_adds_tiles_kernel: blocks of one kind take (chunk of kChunk
//      sorted positions, column tile of 256) items: the chunk's committed rows,
//      their segments' pool rows staged in shared memory, all their loads
//      in flight at once, summed in registers while consecutive rows share
//      a pool row and added with one atomic a column at each change (a
//      segment of thousands of rows is split over many blocks; integer
//      adds are exact in any order).  Blocks of the other kind take a row
//      a warp: the committed creations' votes, packed a byte a lane, the
//      popcount reduced by shuffles.
// Both run inside the round's CUDA graph: no allocation (the wrapper makes
// the per-segment words), no host synchronisation.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // rows a block of the row-wise kinds
constexpr int kChunk = 32;  // sorted positions an add item
constexpr int kCols = 256;  // columns an add item (a thread a column)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int* ls;
  unsigned char* t_pk;
  int* t_pops;
  int* t_slot;
  const int* group;
  const int* pos;
  const int* row_ls;
  const int* gj_ls;
  const int64_t* aorder;
  const int* agrp;
  const bool* committed;
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
  const int* cell;
  const int* new_slot;
  int* seg_target;  // (m,) pool row of each segment's adds, -1 = none
  int m;
  int f;
  int f8;
  int fc;           // cells a tile
  int p_cap;        // pool rows
  int n_cells;      // G * Fc
  int c_cap;        // cluster slots
  int g_cap;        // groups
  int vec;          // f % 8 == 0 and the (., F) tables 16-byte aligned
  int add_blocks;   // blocks of the add kind (chunks * column tiles)
  int col_tiles;
};

// dst[0:f] = src[0:f], by one warp
__device__ __forceinline__ void copy_row(int* dst, const int* src, int f, bool vec, int lane) {
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int k = lane; k < f / 4; k += 32) d4[k] = __ldg(s4 + k);
  } else {
    for (int c = lane; c < f; c += 32) dst[c] = __ldg(src + c);
  }
}

__global__ void __launch_bounds__(32 * kWarps) writes_sets_kernel(Args a) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= a.m) return;
  const bool pr = a.promo[r];
  if (pr || a.adder[r]) {
    const int t = pr ? a.ref_promo[r] : a.cand_ref[r];
    const bool ok = t >= 0 && t < a.p_cap;
    const int seg = a.agrp[r];
    if (lane == 0 && seg >= 0 && seg < a.m) a.seg_target[seg] = ok ? t : -1;
    if (pr && ok) {
      const int slot = a.best_s[r];
      const int g = slot >= 0 && slot < a.c_cap ? a.group[slot] : -1;
      const int p = slot >= 0 && slot < a.c_cap ? a.pos[slot] : -1;
      if (g >= 0 && g < a.g_cap && p >= 0 && p < a.fc) {
        const unsigned char* bits = a.t_pk + ((size_t)g * a.fc + p) * a.f8;
        int* dst = a.ls + (size_t)t * a.f;
        for (int c = lane; c < a.f; c += 32) dst[c] = (bits[c >> 3] >> (7 - (c & 7))) & 1;
      }
    }
  }
  if (a.create_pool[r]) {
    const int t = a.ref_create[r];
    const int js = a.jseg[r];
    const bool joint = a.join_ok[r];
    if (t >= 0 && t < a.p_cap && (!joint || (js >= 0 && js < a.m))) {
      const int* src = joint ? a.gj_ls + (size_t)js * a.f : a.row_ls + (size_t)r * a.f;
      copy_row(a.ls + (size_t)t * a.f, src, a.f, a.vec != 0, lane);
    }
  }
}

// One (chunk, column tile) item of the adds: committed rows' sums into
// their segments' pool rows
__device__ __forceinline__ void add_item(const Args& a, int item) {
  __shared__ int s_target[kChunk];
  __shared__ int s_row[kChunk];
  const int chunk = item / a.col_tiles;
  const int tile = item - chunk * a.col_tiles;
  const int p0 = chunk * kChunk;
  const int tid = threadIdx.x;
  if (tid < kChunk) {
    const int p = p0 + tid;
    int t = -1, row = 0;
    if (p < a.m && a.committed[p]) {
      const int seg = a.agrp[p];
      t = seg >= 0 && seg < a.m ? a.seg_target[seg] : -1;
      row = (int)a.aorder[p];
      if (row < 0 || row >= a.m) t = -1;
    }
    s_target[tid] = t;
    s_row[tid] = row;
  }
  __syncthreads();
  const int c = tile * kCols + tid;
  if (c >= a.f) return;
  unsigned v[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    v[k] = s_target[k] >= 0 ? (unsigned)__ldg(a.row_ls + (size_t)s_row[k] * a.f + c) : 0u;
  }
  int cur = -1;
  unsigned acc = 0u;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int t = s_target[k];
    if (t < 0) continue;
    if (t != cur) {
      if (cur >= 0) atomicAdd(reinterpret_cast<unsigned*>(a.ls + (size_t)cur * a.f + c), acc);
      cur = t;
      acc = 0u;
    }
    acc += v[k];
  }
  if (cur >= 0) atomicAdd(reinterpret_cast<unsigned*>(a.ls + (size_t)cur * a.f + c), acc);
}

// One committed creation's tile cell, by one warp
__device__ __forceinline__ void tile_row(const Args& a, int r, int lane) {
  if (!a.create_commit[r]) return;
  const int cell = a.cell[r];
  if (cell < 0 || cell >= a.n_cells) return;
  const int js = a.jseg[r];
  const bool joint = a.join_ok[r] && a.fits[r];
  if (joint && (js < 0 || js >= a.m)) return;
  const int* src = joint ? a.gj_ls + (size_t)js * a.f : a.row_ls + (size_t)r * a.f;
  const int n = max(a.created_n[r], 1);
  const float half = (float)n * 0.5f;
  unsigned char* out = a.t_pk + (size_t)cell * a.f8;
  int count = 0;
  for (int b = lane; b < a.f8; b += 32) {
    int s[8];
    const int c0 = b * 8;
    if (a.vec) {
      const int4 lo = __ldg(reinterpret_cast<const int4*>(src + c0));
      const int4 hi = __ldg(reinterpret_cast<const int4*>(src + c0 + 4));
      s[0] = lo.x; s[1] = lo.y; s[2] = lo.z; s[3] = lo.w;
      s[4] = hi.x; s[5] = hi.y; s[6] = hi.z; s[7] = hi.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = c0 + k < a.f ? __ldg(src + c0 + k) : 0;
    }
    unsigned byte = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool bit = c0 + k < a.f && (n <= 1 ? s[k] >= 1 : (float)s[k] >= half);
      byte |= (unsigned)bit << (7 - k);
    }
    out[b] = (unsigned char)byte;
    count += __popc(byte);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(kFull, count, o);
  if (lane == 0) {
    a.t_pops[cell] = count;
    a.t_slot[cell] = a.new_slot[r];
  }
}

__global__ void __launch_bounds__(kCols) writes_adds_tiles_kernel(Args a) {
  if ((int)blockIdx.x < a.add_blocks) {
    add_item(a, blockIdx.x);
    return;
  }
  const int r = ((int)blockIdx.x - a.add_blocks) * kWarps + (threadIdx.x >> 5);
  if (r < a.m) tile_row(a, r, threadIdx.x & 31);
}

}  // namespace

extern "C" {

// The contract above for m rows of f columns: ls (p_cap, f) int32, t_pk
// (g_cap * fc, f8) uint8, t_pops and t_slot (g_cap * fc) int32, group and
// pos (c_cap) int32 tables, updated in place; row_ls and gj_ls (m, f)
// int32; aorder (m) int64; the other inputs (m) int32 or bool as named.
// seg_target is (m) int32 scratch.  Two launches and a memset on
// `stream`; returns 0 or the CUDA error after them.
int bb_commit_writes(void* ls, void* t_pk, void* t_pops, void* t_slot, const void* group,
                     const void* pos, const void* row_ls, const void* gj_ls, const void* aorder,
                     const void* agrp, const void* committed, const void* promo,
                     const void* adder, const void* ref_promo, const void* cand_ref,
                     const void* best_s, const void* jseg, const void* join_ok,
                     const void* fits, const void* create_pool, const void* ref_create,
                     const void* create_commit, const void* created_n, const void* cell,
                     const void* new_slot, void* seg_target, int m, int f, int p_cap,
                     int g_cap, int fc, int c_cap, void* stream) {
  if (m < 1 || f < 1 || p_cap < 1 || g_cap < 1 || fc < 1 || c_cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int col_tiles = (f + kCols - 1) / kCols;
  const int chunks = (m + kChunk - 1) / kChunk;
  const Args a{
      static_cast<int*>(ls), static_cast<unsigned char*>(t_pk), static_cast<int*>(t_pops),
      static_cast<int*>(t_slot), static_cast<const int*>(group), static_cast<const int*>(pos),
      static_cast<const int*>(row_ls), static_cast<const int*>(gj_ls),
      static_cast<const int64_t*>(aorder), static_cast<const int*>(agrp),
      static_cast<const bool*>(committed), static_cast<const bool*>(promo),
      static_cast<const bool*>(adder), static_cast<const int*>(ref_promo),
      static_cast<const int*>(cand_ref), static_cast<const int*>(best_s),
      static_cast<const int*>(jseg), static_cast<const bool*>(join_ok),
      static_cast<const bool*>(fits), static_cast<const bool*>(create_pool),
      static_cast<const int*>(ref_create), static_cast<const bool*>(create_commit),
      static_cast<const int*>(created_n), static_cast<const int*>(cell),
      static_cast<const int*>(new_slot), static_cast<int*>(seg_target),
      m, f, (f + 7) / 8, fc, p_cap, g_cap * fc, c_cap, g_cap,
      f % 8 == 0 && aligned(ls) && aligned(row_ls) && aligned(gj_ls),
      chunks * col_tiles, col_tiles,
  };
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(seg_target, 0xff, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (m + kWarps - 1) / kWarps;
  writes_sets_kernel<<<row_blocks, 32 * kWarps, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  writes_adds_tiles_kernel<<<a.add_blocks + row_blocks, kCols, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
