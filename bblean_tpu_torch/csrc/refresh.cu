// The batch step's refresh for NVIDIA Hopper (sm_90a): the step's committed
// rows folded into their groups' sums and counts, then the tile centroids of
// the clusters and the routing centroids of the groups the step touched
// revoted, in two launches, without an (M, F) plane and without a host read.
//
// == What it replaces ==
//
// bblean_tpu/engine/batch.py:891 _refresh_touched (XLA fuses it into the
// jitted step).  ops/refresh.py keeps the torch chain the port ran before
// (the sort by group, the segment sums and their gather back to rows, the
// clusters' sums gathered from the pool or unpacked from their cells, the
// votes and the drop-mode scatters over (M, F) planes) as the plain version.
//
// Contract, equal to the plain version bit for bit (int32 sums wrap).  A row
// r commits where 0 <= assigned[r] < c_cap, to cluster s = assigned[r] of
// group g = group[s] (0 <= g < g_cap):
//   g_ls[g] += row_ls[r];  g_n[g] += row_n[r]
// then, after every row's adds, each distinct committed cluster s whose
// cell (group[s], pos[s]) lies in the tiles, at c = max(n[s], 1):
//   sums = ls[ls_ref[s]] where ls_ref[s] >= 0, else the bits of its cell;
//   t_pk at the cell = the packed vote (big-endian in each byte, pad bits
//   0), t_pops at the cell = its popcount
// and each distinct committed group g, at c = max(g_n[g], 1):
//   g_cent[g] = the vote of g_ls[g] (int8 0/1), g_pops[g] = its popcount
// where the vote of a sum x is c <= 1 ? x >= 1 : f32(x) >= f32(c) * 0.5
// (ops/isim.py::majority_centroid_from_sums).  row_single[r] promises that
// row_ls[r] is the bits of row_pk[r] (a row of one fingerprint); the kernel
// then reads the row's packed bytes in place of its 4F bytes of sums.
// order is any permutation of the rows; it sets only the runs that are
// added in registers, not the result.
//
// Scratch (int32, 2h + 2m + 3 words, h a power of two >= 2m): two hash sets
// of h words (0 = empty, else key + 1), the touched groups' and clusters'
// lists of m words, and three counters (groups, clusters, blocks done).
// It is all 0 at a call and the second launch leaves it so.
//
// == The bound ==
//
// Each committed row once (F / 8 bytes where row_single, else 4F), each
// touched group's g_ls row read and written by the adds and read again by
// its vote, each touched cluster's pool row or cell read, and the cells
// and centroids written, over 3.35 TB/s: a mid-fit step of the 1M fit at
// t = 0.3 (8,192 rows, all flagged, into 89 groups and 1,885 clusters)
// moves about 5.6 MB, 1.7 us.  The adds are int32 atomics, one a non-zero
// column a run of one group; their traffic and the latency of the two
// launches are what is left.
//
// == Design ==
//
// Two launches in stream order, no memset, no allocation:
//   1. refresh_fold_kernel, ceil(M / 32) x ceil(F / 2048) blocks of 256
//      threads: a block takes 32 positions of `order` and one tile of
//      2048 columns.  Its first warp finds each position's row, cluster and
//      group (in column tile 0 it also puts the cluster in its hash set;
//      the first to put it there appends it to the cluster list) and lists
//      the committed ones by ballot; the flagged rows' packed bytes go to
//      shared memory with cp.async; a thread owns columns t, t + 256, ...,
//      t + 1792 of the tile, so that its int32 loads and atomics are
//      coalesced across the warp, and adds a run of rows of one group in
//      registers, flushing one atomic a non-zero column at each change of
//      group (in column tile 0 with the run's count into g_n and the group
//      into its hash set and list).  The step's sort plan orders the rows
//      by routed group, which is the committed group of all but the
//      creations sent to an overflow group, so the runs are the groups.
//   2. refresh_vote_kernel, a persistent grid of at most four blocks an SM:
//      each warp takes a listed cluster or group in turn, reads its sums
//      (a singleton: its cell's packed bytes) and writes the packed vote
//      and popcount (a group: the int8 vote, eight columns a lane store);
//      the blocks then clear the hash sets, and the last block to finish
//      zeroes the counters.
// Neither reads anything on the host; the step's refresh is these two
// launches and nothing else.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;       // threads a block, both launches
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;          // positions a fold block
constexpr int kCols = 8;            // columns a thread of a fold block
constexpr int kTileCols = kThreads * kCols;  // columns a fold block
constexpr int kTileBytes = kTileCols / 8;    // their packed bytes
constexpr int kBatch = 8;           // unflagged rows whose loads are in flight at once
constexpr int kVote = 4;            // bytes a lane votes from one batch of loads
constexpr int kBlocksPerSm = 4;     // the vote's persistent grid
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int* g_ls;
  int* g_n;
  unsigned char* t_pk;
  int* t_pops;
  signed char* g_cent;
  int* g_pops;
  const int* ls;
  const int* ls_ref;
  const int* n;
  const int* group;
  const int* pos;
  const int* assigned;
  const int* row_ls;
  const unsigned char* row_pk;
  const bool* row_single;
  const int* row_n;
  const int64_t* order;
  int* ghash;            // (h) the touched groups' set; chash follows it
  int* chash;            // (h) the touched clusters' set
  int* glist;            // (m) the touched groups
  int* clist;            // (m) the touched clusters
  int* counts;           // groups listed, clusters listed, vote blocks done
  int m;
  int f;
  int f8;
  int fc;           // cells a tile
  int p_cap;        // pool rows
  int c_cap;        // cluster slots
  int g_cap;        // groups
  int hmask;        // h - 1
  int col_tiles;    // column tiles of kTileCols
  int vec_ls;       // f % 8 == 0 and ls, g_ls 16-byte aligned: int4 loads in the votes
  int vec_cent;     // f % 8 == 0 and g_cent 8-byte aligned: 8-byte stores of the int8 vote
  int pk_bulk;      // f8 % 16 == 0 and row_pk 16-byte aligned: cp.async of 16 B
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

// Put key (>= 0) in the hash set `set` of hmask + 1 words (a power of two;
// Fibonacci hashing, linear probes); true for the one caller that put it
// there first.  The set holds at most m keys in 2m or more words, so a
// probe ends.
__device__ __forceinline__ bool first_in(int* set, int hmask, int key) {
  unsigned h = ((unsigned)key * 2654435761u) >> (32 - __popc(hmask));
  while (true) {
    const int prev = atomicCAS(set + h, 0, key + 1);
    if (prev == 0) return true;
    if (prev == key + 1) return false;
    h = (h + 1) & (unsigned)hmask;
  }
}

struct FoldSmem {
  unsigned char bits[kChunk][kTileBytes];  // the flagged rows' packed bytes
  int row[kChunk];   // the block's committed positions, in order: their row,
  int grp[kChunk];   // group,
  int rn[kChunk];    // row_n,
  int single[kChunk];
  int count;
};

__global__ void __launch_bounds__(kThreads) refresh_fold_kernel(Args a) {
  __shared__ __align__(16) FoldSmem s;
  const int chunk = blockIdx.x / a.col_tiles;
  const int tile = blockIdx.x - chunk * a.col_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (warp == 0) {
    const int p = chunk * kChunk + lane;
    bool mine = false;
    int row = 0, g = 0, slot = 0;
    if (p < a.m) {
      row = (int)a.order[p];
      if (in(row, a.m)) {
        slot = a.assigned[row];
        if (in(slot, a.c_cap)) {
          g = a.group[slot];
          mine = in(g, a.g_cap);
        }
      }
    }
    if (mine && tile == 0 && first_in(a.chash, a.hmask, slot)) {
      a.clist[atomicAdd(a.counts + 1, 1)] = slot;
    }
    const unsigned bal = __ballot_sync(kFull, mine);
    if (mine) {
      const int k = __popc(bal & ((1u << lane) - 1u));
      s.row[k] = row;
      s.grp[k] = g;
      s.rn[k] = a.row_n[row];
      s.single[k] = a.row_single[row];
    }
    if (lane == 0) s.count = __popc(bal);
  }
  __syncthreads();
  const int total = s.count;
  if (total == 0) return;
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
      if (k < total && s.single[k]) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[u][j] = (s.bits[k][byte0 + 32 * j] >> shift) & 1u;
      } else if (k < total) {
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
      const int g = s.grp[k];
      if (k + 1 == total || s.grp[k + 1] != g) {  // the run ends: flush
        int* dst = a.g_ls + (size_t)g * a.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + kThreads * j;
          if (c < a.f && acc[j] != 0u) atomicAdd(reinterpret_cast<unsigned*>(dst + c), acc[j]);
          acc[j] = 0u;
        }
        if (tid == 0 && tile == 0) {
          if (n_sum != 0) atomicAdd(a.g_n + g, n_sum);
          if (first_in(a.ghash, a.hmask, g)) a.glist[atomicAdd(a.counts, 1)] = g;
        }
        n_sum = 0;
      }
    }
  }
}

// The vote of a sum x at count c (c >= 1, half = f32(c) * 0.5)
__device__ __forceinline__ unsigned vote(int x, int c, float half) {
  return c <= 1 ? (unsigned)(x >= 1) : (unsigned)((float)x >= half);
}

// The vote of the int32 sums src[0:f] at count c, by one warp: the packed
// bytes into out_pk (pad bits 0) or the int8 0/1 values into out_cent;
// returns the warp's popcount (on every lane)
template <bool kCent>
__device__ __forceinline__ int vote_row(const Args& a, const int* src, int c,
                                        unsigned char* out_pk, signed char* out_cent, bool vec,
                                        int lane) {
  const float half = (float)c * 0.5f;
  int count = 0;
  for (int b0 = lane; b0 < a.f8; b0 += 32 * kVote) {
    int x[kVote][8];
#pragma unroll
    for (int u = 0; u < kVote; ++u) {
      const int col = (b0 + 32 * u) * 8;
      if (vec && col < a.f) {
        const int4 lo = __ldg(reinterpret_cast<const int4*>(src + col));
        const int4 hi = __ldg(reinterpret_cast<const int4*>(src + col + 4));
        x[u][0] = lo.x; x[u][1] = lo.y; x[u][2] = lo.z; x[u][3] = lo.w;
        x[u][4] = hi.x; x[u][5] = hi.y; x[u][6] = hi.z; x[u][7] = hi.w;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) x[u][k] = col + k < a.f ? __ldg(src + col + k) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kVote; ++u) {
      const int b = b0 + 32 * u;
      if (b >= a.f8) break;
      unsigned v = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) v |= (8 * b + k < a.f ? vote(x[u][k], c, half) : 0u) << (7 - k);
      count += __popc(v);
      if (!kCent) {
        out_pk[b] = (unsigned char)v;
      } else if (a.vec_cent) {
        // Column 8b + k is byte k of the eight (little-endian words)
        uint2 w;
        w.x = ((v >> 7) & 1u) | ((v >> 6) & 1u) << 8 | ((v >> 5) & 1u) << 16 | ((v >> 4) & 1u) << 24;
        w.y = ((v >> 3) & 1u) | ((v >> 2) & 1u) << 8 | ((v >> 1) & 1u) << 16 | (v & 1u) << 24;
        reinterpret_cast<uint2*>(out_cent)[b] = w;
      } else {
        for (int k = 0; k < 8 && 8 * b + k < a.f; ++k) out_cent[8 * b + k] = (signed char)((v >> (7 - k)) & 1u);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(kFull, count, o);
  return count;
}

// One touched cluster's tile cell, by one warp
__device__ __forceinline__ void vote_cluster(const Args& a, int slot, int lane) {
  const int g = a.group[slot], ps = a.pos[slot], ref = a.ls_ref[slot];
  const int c = max(a.n[slot], 1);
  if (!in(g, a.g_cap) || !in(ps, a.fc) || ref >= a.p_cap) return;
  const size_t cell = (size_t)g * a.fc + ps;
  unsigned char* out = a.t_pk + cell * a.f8;
  int count = 0;
  if (ref >= 0) {
    count = vote_row<false>(a, a.ls + (size_t)ref * a.f, c, out, nullptr, a.vec_ls != 0, lane);
  } else {
    // A singleton's sums are its cell's bits: each lane votes the bytes it
    // reads and writes them back (pad bits cleared)
    const float half = (float)c * 0.5f;
    for (int b = lane; b < a.f8; b += 32) {
      const unsigned x = out[b];
      unsigned v = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v |= (8 * b + k < a.f ? vote((int)((x >> (7 - k)) & 1u), c, half) : 0u) << (7 - k);
      }
      out[b] = (unsigned char)v;
      count += __popc(v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(kFull, count, o);
  }
  if (lane == 0) a.t_pops[cell] = count;
}

// One touched group's routing centroid, by one warp
__device__ __forceinline__ void vote_group(const Args& a, int g, int lane) {
  const int c = max(a.g_n[g], 1);
  const int count = vote_row<true>(a, a.g_ls + (size_t)g * a.f, c, nullptr,
                                   a.g_cent + (size_t)g * a.f, a.vec_ls != 0, lane);
  if (lane == 0) a.g_pops[g] = count;
}

__global__ void __launch_bounds__(kThreads) refresh_vote_kernel(Args a) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_groups = a.counts[0];
  const int n_clusters = a.counts[1];
  for (int i = blockIdx.x * kWarps + (tid >> 5); i < n_clusters + n_groups; i += gridDim.x * kWarps) {
    if (i < n_clusters) {
      vote_cluster(a, a.clist[i], lane);
    } else {
      vote_group(a, a.glist[i - n_clusters], lane);
    }
  }
  // No one reads the sets in this launch: clear them for the next call
  const int words = 2 * (a.hmask + 1);
  for (int i = blockIdx.x * kThreads + tid; i < words; i += gridDim.x * kThreads) a.ghash[i] = 0;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    // Every block has read the counters before it counts itself done
    if (atomicAdd(a.counts + 2, 1) == (int)gridDim.x - 1) {
      a.counts[0] = 0;
      a.counts[1] = 0;
      a.counts[2] = 0;
    }
  }
}

}  // namespace

extern "C" {

// The contract above for m rows of f columns: g_ls (g_cap, f) int32, g_n,
// g_pops (g_cap) int32, g_cent (g_cap, f) int8, t_pk (g_cap * fc, f8)
// uint8 and t_pops (g_cap * fc) int32, updated in place; ls (p_cap, f),
// ls_ref, n, group, pos (c_cap) int32; assigned, row_n (m) int32; row_ls
// (m, f) int32; row_pk (m, f8) uint8; row_single (m) bool; order (m) int64;
// scratch as above with h = hmask + 1.  Two launches on `stream`
// (the current device's); returns 0 or the CUDA error after them.
int bb_refresh(void* g_ls, void* g_n, void* t_pk, void* t_pops, void* g_cent, void* g_pops,
               const void* ls, const void* ls_ref, const void* n, const void* group,
               const void* pos, const void* assigned, const void* row_ls, const void* row_pk,
               const void* row_single, const void* row_n, const void* order, void* scratch,
               int m, int f, int p_cap, int c_cap, int g_cap, int fc, int hmask, void* stream) {
  if (m < 1 || f < 1 || p_cap < 1 || c_cap < 1 || g_cap < 1 || fc < 1 || hmask < 2 * m - 1 ||
      (hmask & (hmask + 1)) != 0) {
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
  int* ws = static_cast<int*>(scratch);
  const int h = hmask + 1;
  const Args a{
      static_cast<int*>(g_ls), static_cast<int*>(g_n), static_cast<unsigned char*>(t_pk),
      static_cast<int*>(t_pops), static_cast<signed char*>(g_cent), static_cast<int*>(g_pops),
      static_cast<const int*>(ls), static_cast<const int*>(ls_ref), static_cast<const int*>(n),
      static_cast<const int*>(group), static_cast<const int*>(pos),
      static_cast<const int*>(assigned), static_cast<const int*>(row_ls),
      static_cast<const unsigned char*>(row_pk), static_cast<const bool*>(row_single),
      static_cast<const int*>(row_n), static_cast<const int64_t*>(order),
      ws, ws + h, ws + 2 * h, ws + 2 * h + m, ws + 2 * h + 2 * m,
      m, f, f8, fc, p_cap, c_cap, g_cap, hmask, col_tiles,
      f % 8 == 0 && aligned(ls, 16) && aligned(g_ls, 16),
      f % 8 == 0 && aligned(g_cent, 8),
      f8 % 16 == 0 && aligned(row_pk, 16),
  };
  const cudaStream_t s = (cudaStream_t)stream;
  refresh_fold_kernel<<<chunks * col_tiles, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // At most 2m items of a warp each
  const int wanted = (2 * m + kWarps - 1) / kWarps;
  const int grid = wanted < kBlocksPerSm * n_sm ? wanted : kBlocksPerSm * n_sm;
  refresh_vote_kernel<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
