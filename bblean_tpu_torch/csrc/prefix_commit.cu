// The insert round's merge tests for NVIDIA Hopper (sm_90a): a segmented
// exclusive scan of the accepted rows' linear sums along the sorted rows,
// fused with the per-row iSIM moments of the merged and pre-merge clusters.
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
// criteria the same again of y (vote at max(old_n, 2)).  The sums wrap
// modulo 2^64 like torch's int64 sums, so any order gives the same bits.
//
// == The bound ==
//
// One pass must read row_ls and cand_ls once: 2 * M * F * 4 bytes, 128 MiB
// at M = 8192, F = 2048, or 0.040 ms at 3.35 TB/s (0.010 ms at M = 2048).
// The outputs are O(M) and the arithmetic is a few integer operations a
// column, so the bytes bound it.  The plain version writes and reads about
// ten (M, F) int32 planes around torch.cumsum(dim=0), whose outer-dimension
// scan runs one thread per column down all M rows.
//
// == Design: reduce, carry, rescan ==
//
// Sorted rows are cut into chunks of `rows` rows (the wrapper picks about
// two chunks an SM, so M = 2048 fills the card as well as M = 8192; the
// chunk's rows and their partial moments live in dynamic shared memory)
// and columns into tiles of kBlockCols (256 threads x 8
// contiguous columns, two 16-byte loads a row).  A segment may run from
// one row to all M, so no chunk can assume its segment starts inside it:
//   1. tails_kernel: per (chunk, column tile), the sum of s since the
//      chunk's last segment start (the whole chunk if it holds none) and
//      whether it holds a start.  Rows outside the mask are not read.
//   2. carry_kernel: per column, the segmented exclusive scan of the
//      tails across chunks: carry[k + 1] = starts[k] ? tail[k] : carry[k] +
//      tail[k].  Eight warps split the chunks, combine their aggregates in
//      shared memory and rescan their ranges (coalesced across columns).
//   3. moments_kernel: per (chunk, column tile), the rows again with the
//      carry as the running prefix, kept in registers; each row's x and y
//      columns are reduced to the thread's partial moments, then across the
//      warp by shuffles, then across the block's warps through shared
//      memory once the chunk is done; the moments are stored (added with
//      int64 atomics where several column tiles share a row).
// Rows are taken kUnroll at a time with their loads issued first, so each
// warp keeps several 1 KiB rows in flight.  The (M, F) prefix and the
// merged sums are never stored: the traffic is row_ls twice (masked rows
// only), cand_ls once and 2 * chunks * F * 4 bytes of tails and carries.
// Nothing allocates or synchronises; three launches go on the caller's
// stream, so the call can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                      // contiguous columns a thread
constexpr int kBlockCols = kThreads * kCols;  // columns a block
constexpr int kUnroll = 4;                    // rows whose loads go out together
constexpr int kCarryWarps = 8;

struct Args {
  const int* row_ls;         // (M, F) row order
  const int* cand_ls;        // (M, F) row order
  const int64_t* order;      // (M,) sorted -> row, or null (identity)
  const bool* mask;          // (M,) sorted, or null (all rows)
  const int64_t* seg_start;  // (M,) sorted, or null (every row a segment)
  const int* new_n;          // (M,) sorted
  const int* old_n;          // (M,) sorted
  int* tails;                // (chunks, F) scratch
  int* carry;                // (chunks, F) scratch
  uint8_t* starts;           // (chunks,) scratch
  unsigned long long* out;   // (moments, M)
  int m, f, rows, vec;
};

// The chunk's sorted rows: the row each reads and its flags (1: in the
// mask, 2: starts a segment)
__device__ __forceinline__ void load_meta(const Args& a, int i0, int nrows, int* s_row,
                                          uint8_t* s_flag) {
  for (int t = threadIdx.x; t < nrows; t += blockDim.x) {
    const int i = i0 + t;
    s_row[t] = a.order ? (int)a.order[i] : i;
    uint8_t fl = (a.mask == nullptr || a.mask[i]) ? 1 : 0;
    if (a.seg_start == nullptr || a.seg_start[i] == i) fl |= 2;
    s_flag[t] = fl;
  }
}

// The thread's kCols columns of one row (`nv` of them inside F; the rest 0).
// With vec, F % 4 == 0 and the table 16-byte aligned, so nv is 0, 4 or 8.
__device__ __forceinline__ void load_cols(const int* __restrict__ p, int nv, bool vec,
                                          int v[kCols]) {
  if (vec) {
    const int4* q = reinterpret_cast<const int4*>(p);
    const int4 lo = nv >= 4 ? __ldg(q) : make_int4(0, 0, 0, 0);
    const int4 hi = nv >= 8 ? __ldg(q + 1) : make_int4(0, 0, 0, 0);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = j < nv ? __ldg(p + j) : 0;
  }
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// Dynamic shared memory of a chunk of `rows` rows whose partial moments
// are kMom a warp: the partials, then the halves of the votes, the rows
// they read, their single flags and their flags
constexpr size_t chunk_smem(int rows, int mom) {
  return (size_t)rows * (kWarps * mom * 8 + 2 * 4 + 4 + 1 + 1);
}

__global__ void __launch_bounds__(kThreads) tails_kernel(Args a) {
  extern __shared__ __align__(8) unsigned char smem[];
  int* s_row = reinterpret_cast<int*>(smem);
  uint8_t* s_flag = smem + (size_t)a.rows * 4;
  const int chunk = blockIdx.x;
  const int i0 = chunk * a.rows;
  const int nrows = min(a.rows, a.m - i0);
  load_meta(a, i0, nrows, s_row, s_flag);
  __syncthreads();
  const int col0 = blockIdx.y * kBlockCols + threadIdx.x * kCols;
  const int nv = max(0, min(kCols, a.f - col0));
  int acc[kCols] = {0, 0, 0, 0, 0, 0, 0, 0};
  bool any = false;
  for (int t0 = 0; t0 < nrows; t0 += kUnroll) {
    int v[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const bool live = t < nrows && (s_flag[t] & 1) && nv > 0;
      load_cols(a.row_ls + (size_t)(live ? s_row[t] : 0) * a.f + (live ? col0 : 0),
                live ? nv : 0, a.vec && live, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t >= nrows) break;
      if (s_flag[t] & 2) {
        any = true;
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = 0;
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = wrap_add(acc[j], v[u][j]);
    }
  }
  int* tail = a.tails + (size_t)chunk * a.f + col0;
  for (int j = 0; j < nv; ++j) tail[j] = acc[j];
  if (threadIdx.x == 0 && blockIdx.y == 0) a.starts[chunk] = any;
}

__global__ void __launch_bounds__(32 * kCarryWarps) carry_kernel(Args a, int chunks) {
  __shared__ unsigned s_agg[kCarryWarps][32];
  __shared__ bool s_any[kCarryWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const bool ok = col < a.f;
  const int per = (chunks + kCarryWarps - 1) / kCarryWarps;
  const int k0 = min(chunks, warp * per), k1 = min(chunks, k0 + per);
  unsigned agg = 0;
  bool any = false;
#pragma unroll 8
  for (int k = k0; k < k1; ++k) {
    const unsigned v = ok ? (unsigned)a.tails[(size_t)k * a.f + col] : 0u;
    const bool st = a.starts[k];
    agg = st ? v : agg + v;
    any |= st;
  }
  s_agg[warp][lane] = agg;
  if (lane == 0) s_any[warp] = any;
  __syncthreads();
  unsigned c = 0;
  for (int w = 0; w < warp; ++w) c = s_any[w] ? s_agg[w][lane] : c + s_agg[w][lane];
#pragma unroll 8
  for (int k = k0; k < k1; ++k) {
    const size_t at = (size_t)k * a.f + col;
    const unsigned v = ok ? (unsigned)a.tails[at] : 0u;
    if (ok) a.carry[at] = (int)c;
    c = a.starts[k] ? v : c + v;
  }
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

template <bool kSeg, bool kRadius, bool kOld>
__global__ void __launch_bounds__(kThreads) moments_kernel(Args a) {
  constexpr int kSide = kRadius ? 4 : 2;
  constexpr int kMom = kSide * (kOld ? 2 : 1);
  extern __shared__ __align__(8) unsigned char smem[];
  unsigned long long* s_part = reinterpret_cast<unsigned long long*>(smem);  // [rows][kWarps][kMom]
  float* s_half = reinterpret_cast<float*>(s_part + (size_t)a.rows * kWarps * kMom);  // [2][rows]
  int* s_row = reinterpret_cast<int*>(s_half + 2 * a.rows);
  bool* s_single = reinterpret_cast<bool*>(s_row + a.rows);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_single + a.rows);
  const int chunk = blockIdx.x;
  const int i0 = chunk * a.rows;
  const int nrows = min(a.rows, a.m - i0);
  load_meta(a, i0, nrows, s_row, s_flag);
  if (kRadius) {
    for (int t = threadIdx.x; t < nrows; t += blockDim.x) {
      const int nn = a.new_n[i0 + t];
      s_half[t] = __int2float_rn(nn) * 0.5f;
      s_single[t] = nn <= 1;
      if (kOld) s_half[a.rows + t] = __int2float_rn(max(a.old_n[i0 + t], 2)) * 0.5f;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * kBlockCols + threadIdx.x * kCols;
  const int nv = max(0, min(kCols, a.f - col0));
  // Columns past F load as 0, never change the prefix, and add nothing to
  // any moment (a zero x votes 0 at every count)
  int run[kCols] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (kSeg && nv > 0) {
    const int* c = a.carry + (size_t)chunk * a.f + col0;
    for (int j = 0; j < nv; ++j) run[j] = c[j];
  }
  for (int t0 = 0; t0 < nrows; t0 += kUnroll) {
    int cv[kUnroll][kCols], sv[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const bool in = t < nrows && nv > 0;
      const bool live = in && (s_flag[t] & 1);
      const size_t base = in ? (size_t)s_row[t] * a.f + col0 : 0;
      load_cols(a.cand_ls + base, in ? nv : 0, a.vec && in, cv[u]);
      load_cols(a.row_ls + base, live ? nv : 0, a.vec && live, sv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t >= nrows) break;
      if (kSeg && (s_flag[t] & 2)) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) run[j] = 0;
      }
      const float half_new = kRadius ? s_half[t] : 0.f;
      const float half_old = kRadius && kOld ? s_half[a.rows + t] : 0.f;
      const bool single = kRadius ? s_single[t] : false;
      unsigned long long mom[kMom];
#pragma unroll
      for (int k = 0; k < kMom; ++k) mom[k] = 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int y = kSeg ? wrap_add(cv[u][j], run[j]) : cv[u][j];
        add_moments<kRadius>(wrap_add(y, sv[u][j]), half_new, single, mom);
        if (kOld) add_moments<kRadius>(y, half_old, false, mom + kSide);
        if (kSeg) run[j] = wrap_add(run[j], sv[u][j]);
      }
#pragma unroll
      for (int k = 0; k < kMom; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mom[k] += __shfl_xor_sync(0xffffffffu, mom[k], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kMom; ++k) s_part[((size_t)t * kWarps + warp) * kMom + k] = mom[k];
      }
    }
  }
  __syncthreads();
  const bool shared_rows = gridDim.y > 1;
  for (int idx = threadIdx.x; idx < nrows * kMom; idx += kThreads) {
    const int t = idx / kMom, k = idx % kMom;
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_part[((size_t)t * kWarps + w) * kMom + k];
    unsigned long long* dst = a.out + (size_t)k * a.m + i0 + t;
    if (shared_rows) {
      atomicAdd(dst, sum);
    } else {
      *dst = sum;
    }
  }
}

template <bool kSeg>
void launch_moments(const Args& a, dim3 grid, bool radius, bool old, cudaStream_t s) {
  const size_t smem = chunk_smem(a.rows, (radius ? 4 : 2) * (old ? 2 : 1));
  if (radius) {
    if (old) {
      moments_kernel<kSeg, true, true><<<grid, kThreads, smem, s>>>(a);
    } else {
      moments_kernel<kSeg, true, false><<<grid, kThreads, smem, s>>>(a);
    }
  } else if (old) {
    moments_kernel<kSeg, false, true><<<grid, kThreads, smem, s>>>(a);
  } else {
    moments_kernel<kSeg, false, false><<<grid, kThreads, smem, s>>>(a);
  }
}

}  // namespace

extern "C" {

// The moments of the contract above for m sorted rows of f columns, in
// chunks of `rows` rows (chunks = ceil(m / rows); a chunk's shared memory
// must fit in the default 48 KiB: up to 93 rows); radius / old choose the
// moments (2, 4 or 8 rows of `out`).  With seg_start, `tails` and `carry`
// are (chunks, f) int32 scratch and `starts` (chunks,) uint8; without it
// they may be null and only the moments kernel runs.  vec = 1 needs
// f % 4 == 0 and both tables 16-byte aligned.  `out` must hold zeros
// (where f spans several column tiles, they add into it).  Launches on
// `stream`; returns 0 or the CUDA error after the launches.
int bb_prefix_commit(const void* row_ls, const void* cand_ls, const void* order,
                     const void* mask, const void* seg_start, const void* new_n,
                     const void* old_n, void* tails, void* carry, void* starts, void* out,
                     int m, int f, int rows, int radius, int old, int vec, void* stream) {
  if (m < 1 || f < 1 || rows < 1 || chunk_smem(rows, 8) > 48 * 1024 ||
      (seg_start != nullptr && (tails == nullptr || carry == nullptr || starts == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec && (f % 4 != 0 || reinterpret_cast<uintptr_t>(row_ls) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(cand_ls) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{
      static_cast<const int*>(row_ls), static_cast<const int*>(cand_ls),
      static_cast<const int64_t*>(order), static_cast<const bool*>(mask),
      static_cast<const int64_t*>(seg_start), static_cast<const int*>(new_n),
      static_cast<const int*>(old_n), static_cast<int*>(tails), static_cast<int*>(carry),
      static_cast<uint8_t*>(starts), static_cast<unsigned long long*>(out), m, f, rows, vec,
  };
  const cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (m + rows - 1) / rows;
  const dim3 grid(chunks, (f + kBlockCols - 1) / kBlockCols);
  if (seg_start != nullptr) {
    tails_kernel<<<grid, kThreads, chunk_smem(rows, 0), s>>>(a);
    carry_kernel<<<(f + 31) / 32, 32 * kCarryWarps, 0, s>>>(a, chunks);
    launch_moments<true>(a, grid, radius != 0, old != 0, s);
  } else {
    launch_moments<false>(a, grid, radius != 0, old != 0, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
