// The insert round's leader election for NVIDIA Hopper (sm_90a): among the
// round's rejected rows, each routed group elects the rows that no lower
// rejected row of the group is similar to, and every rejected row that
// does not lead finds its most similar leader below it.  The work scales
// with the rejected rows and the pairs among them.
//
// == What it replaces ==
//
// bblean_tpu/engine/batch.py:504-540 (step 4 of _insert_round), which XLA
// fuses inside the jitted step.  ops/leader_election.py keeps the torch
// chain the port ran before (the (M, M) planes same_group, lower,
// sim_to_lower and sim_to_leader, their any / argmax / amax, over the int8
// Gram of the rejected rows) as the plain version.
//
// Contract.  A pair (j, i) counts where i < j, rejected[i] and both rows
// are on one group; its sim s(j, i) is the f32 Tanimoto of their packed
// rows: inter = popcount(pk_j & pk_i), s = inter / max(pop_i + pop_j -
// inter, 1) with an IEEE division.  The groups come from the plan: the
// step's rows sorted stably by group (`order`, `skey`), and, where the
// call's rows are a selection of the step's (a narrow round), `sel`, the
// step row of each call row, rising over the rows that may be rejected.
//   leads[j]   = rejected[j] & (force_lead[j] | !(-2 >= thr | any counted
//                pair of j has s >= thr)), on every row
// and on the rows with rejected[j] & !leads[j] only:
//   best[j]    = the largest s over the counted pairs of j whose i leads,
//                -2 (_NEG) where there is none
//   lead_of[j] = the smallest such i with s == best[j], 0 where none.
// Every other row gets lead_of = 0 and best = -2.  These equal the plain
// version bit for bit on those rows; its values elsewhere are never read:
// engine/batch.py::_insert_round reads best_lead_sim only in `join =
// rejected & ~leads & ...` (:568), overwrites lead_of for the leaders
// (:570), and masks every later read of lead_of by `leader | join` (the
// cohesion key, :575) or `join_commit` (the create guard :606, the fit
// check :631, the joining rows' slots :643).  Sims are Tanimoto values
// (finite, >= 0), so their f32 bit patterns order like their values and no
// counted pair ties _NEG.
//
// == The bound ==
//
// The leads need the pairs of rejected rows of one group (j against the
// lower ones); the best leaders the pairs of a rejected non-leader against
// the lower leaders, a subset: the packed rows of the rejected rows once
// and an AND + popcount of F bits a pair.  Add the O(M) flags, plan and
// outputs.  Mid-fit the 1M t = 0.3 fit's wide round rejects ~1,000 of
// 8,192 rows, most in one group: a few hundred thousand pairs, a bound of
// about a microsecond.
//
// == Design: three launches, no binary search, no (M, M) temporary ==
//
//   1. election_compact_kernel, one block of 1,024 threads: writes the
//      defaults of every row, then lists the rejected rows by (group, row)
//      ("entries") by a block scan of their flags in the order of the
//      step's sort plan (every pending row, so every rejected one, sits in
//      its group's segment in row order).  In a narrow round the plan
//      lists the step's rows: the block first maps each step row to its
//      call row (-1 where the call has none) from `sel`, and the step rows
//      the call leaves out drop with the rows that are not rejected (the
//      call's pending rows are the step's lowest pending rows, in order,
//      so the plan's order is theirs).  One more pass of scans cuts
//      each group's entries into chunks of kT and numbers the tiles: chunk
//      k of a group whose first chunk is k0 has the tiles (k, k0) ...
//      (k, k), j-rows from k and i-rows from the other, every i of a tile
//      below every j (on the diagonal only the lower ones count).  A tile's
//      table entry holds both chunks' first entries and sizes, its j-chunk
//      and that chunk's tile count.  The kernel also zeroes the hit flags,
//      the best-leader words, the chunk counters and the tickets, so
//      nothing is set from the host and the call replays in a CUDA graph.
//   2. election_leads_kernel: persistent blocks take tiles by an atomic
//      ticket.  Warp 0 picks the j-rows still without a hit (and not
//      forced) and the i-rows; their packed rows land in shared memory by
//      cp.async (16 B a copy), and each warp computes a 16 x 8 block of
//      the tile's intersections on the tensor cores (mma.m16n8k256
//      .and.popc, the tile search's binary product), then the Tanimoto and
//      the test; a j with a pair at or above the threshold gets its hit
//      flag, and later tiles skip it.
//   3. election_best_kernel: the same tiles, with j the rows that do not
//      lead and i the leaders (leads is known from the hit flags now);
//      each pair's (bits(s) << 32) | ~i is max-combined in shared memory,
//      then with one 64-bit atomicMax an entry across tiles (largest s,
//      then smallest i: exact in any order).  The block that finishes a
//      chunk's last tile (a counter a chunk, after a fence) writes that
//      chunk's rows' leads, lead_of and best.
// A large group spreads over many blocks: the first batch's group of
// 8,192 rejected rows is 32,896 tiles.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -2.0f;
constexpr int kT = 32;               // rejected rows a tile side
constexpr int kScanThreads = 1024;   // the compaction's one block (32 warps)
constexpr int kItems = 8;            // entries a thread of the compaction takes a pass
constexpr int kTileThreads = 256;    // 8 warps: 2 x 4 blocks of 16 x 8 pairs
constexpr unsigned kFull = 0xffffffffu;

// Words of the scratch header
enum { kTiles = 0, kTicketLeads = 1, kTicketBest = 2, kHeader = 4 };

struct Args {
  const bool* rejected;
  const bool* force_lead;
  const float* threshold;
  const unsigned char* pk;    // (m, f8) packed rows
  const int* pop;             // (m,) popcounts
  const int64_t* order;       // (lp,) sorted position -> step row
  const int* skey;            // (lp,) groups, non-decreasing
  const int64_t* sel;         // (m,) each row's step row, or null (the step's rows: lp == m)
  bool* leads;
  int* lead_of;
  float* best;
  int* hdr;                   // kHeader words
  int* list;                  // (m) the entries: the rejected rows by (group, row)
  int* gkey;                  // (m) each entry's group
  int* cstart;                // (m + 1) each chunk's first entry
  int* cu;                    // (m) each chunk's place in its group
  int* tstart;                // (m) each chunk's first tile
  int* done;                  // (m) each chunk's best-leader tiles finished
  int* hit;                   // (m) each entry: a counted pair at or above the threshold
  unsigned long long* key;    // (m) each entry's best leader, (bits(s) << 32) | ~i
  int4* items;                // (max_tiles(m)) {j first, i first, j chunk << 6 | j rows,
                              //  tiles of the j chunk << 6 | i rows}
  int* pos;                   // (lp) each step row's row, -1 where none (with sel)
  int m;
  int lp;                     // the plan's rows
  int f8;
  int kp;                     // bytes of a staged row the products read: f8 rounded up to 64
  int rs;                     // bytes between staged rows: kp, plus 64 where kp % 128 == 0
  int bulk;                   // rows copied 16 B at a time (f8 % 16 == 0, pk 16-byte aligned)
};

// A group of r entries has n = q + e chunks (q = r / kT, e = r % kT != 0)
// and n (n + 1) / 2 = q (q + 1) / 2 + e (q + 1) tiles: the first terms sum
// to at most N (N + 1) / 2 (N = ceil(m / kT)), the second to at most m
long long max_tiles(int m) {
  const long long n = (m + kT - 1) / kT;
  return n * (n + 1) / 2 + m;
}

size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the scratch's arrays, in Args order, and its size (`lp`
// the plan's rows where the call's are a selection of them, else 0)
constexpr int kArrays = 11;
struct Layout {
  size_t off[kArrays];
  size_t bytes;
};

Layout layout(int m, int lp) {
  const size_t n = (size_t)m;
  const size_t sizes[kArrays] = {
      kHeader * 4, n * 4, n * 4, (n + 1) * 4, n * 4, n * 4, n * 4, n * 4, n * 8,
      (size_t)max_tiles(m) * 16, (size_t)lp * 4,
  };
  Layout l{};
  size_t at = 0;
  for (int k = 0; k < kArrays; ++k) {
    l.off[k] = at;
    at = align16(at + sizes[k]);
  }
  l.bytes = at;
  return l;
}

struct Add {
  __device__ __forceinline__ unsigned long long operator()(unsigned long long x,
                                                           unsigned long long y) const {
    return x + y;
  }
};
struct Max {
  __device__ __forceinline__ unsigned long long operator()(unsigned long long x,
                                                           unsigned long long y) const {
    return x > y ? x : y;
  }
};

// Exclusive scan over the block (kScanThreads threads) of one value a
// thread under `op` (`id` its identity); `total` gets the whole block's.
// Every thread calls it; it ends with the block in step.
template <class Op>
__device__ __forceinline__ unsigned long long block_exclusive_scan(
    unsigned long long v, unsigned long long id, unsigned long long& total,
    unsigned long long* s_warp, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(y, x);
  }
  const unsigned long long excl_lane = __shfl_up_sync(kFull, x, 1);
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = op(y, w);
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[31];
  unsigned long long excl = lane > 0 ? excl_lane : id;
  if (warp > 0) excl = op(s_warp[warp - 1], excl);
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(kScanThreads) election_compact_kernel(Args a) {
  __shared__ unsigned long long s_warp[32];
  const int tid = threadIdx.x;
  const int m = a.m, lp = a.lp;
  for (int r = tid; r < m; r += kScanThreads) {
    a.leads[r] = false;
    a.lead_of[r] = 0;
    a.best[r] = kNeg;
  }
  if (a.sel != nullptr) {
    // Each step row's row of the call (the block's own writes, visible to
    // it after each barrier)
    for (int r = tid; r < lp; r += kScanThreads) a.pos[r] = -1;
    __syncthreads();
    for (int r = tid; r < m; r += kScanThreads) a.pos[a.sel[r]] = r;
    __syncthreads();
  }

  // ---- the entries: the rejected rows, by (group, row) ----
  int n = 0;
  for (int base = 0; base < lp; base += kScanThreads * kItems) {
    int row[kItems];
    bool f[kItems];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int q = base + tid * kItems + k;
      row[k] = q < lp ? (int)a.order[q] : -1;
    }
    if (a.sel != nullptr) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) row[k] = row[k] >= 0 ? a.pos[row[k]] : -1;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      f[k] = row[k] >= 0 && a.rejected[row[k]];
      cnt += f[k];
    }
    unsigned long long total;
    int c = n + (int)block_exclusive_scan(cnt, 0ull, total, s_warp, Add());
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!f[k]) continue;
      a.list[c] = row[k];
      a.gkey[c] = a.skey[base + tid * kItems + k];
      ++c;
    }
    n += (int)total;
  }
  __syncthreads();

  // ---- chunks and tiles, in one pass: each entry's group start (a max
  // scan), then the chunk starts (every kT entries from it) and each
  // chunk's first tile (a scan of the chunk count and the tile count
  // together: chunks << 32 | tiles) ----
  unsigned long long g_carry = 0, ct_carry = 0;
  for (int base = 0; base < n; base += kScanThreads * kItems) {
    int g[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int c = base + tid * kItems + k;
      g[k] = a.gkey[c < n ? c : n - 1];
    }
    const int c0 = base + tid * kItems;
    const int gprev = c0 > 0 && c0 < n ? a.gkey[c0 - 1] : 0;
    unsigned long long start[kItems];  // 1 + the entry's group start, 0 where unknown yet
    unsigned long long run = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int c = c0 + k;
      const bool first = c < n && (c == 0 || g[k] != (k > 0 ? g[k - 1] : gprev));
      if (first) run = (unsigned long long)c + 1;
      start[k] = run;
    }
    unsigned long long gmax;
    const unsigned long long before = Max()(
        g_carry, block_exclusive_scan(run, 0ull, gmax, s_warp, Max()));
    int u[kItems];
    bool cs[kItems];
    unsigned long long cnt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int c = c0 + k;
      const int gs = (int)(start[k] > 0 ? start[k] : before) - 1;
      const int off = c - gs;
      cs[k] = c < n && off % kT == 0;
      u[k] = off / kT;
      if (cs[k]) cnt += (1ull << 32) | (unsigned)(u[k] + 1);
    }
    unsigned long long total;
    unsigned long long at = ct_carry + block_exclusive_scan(cnt, 0ull, total, s_warp, Add());
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!cs[k]) continue;
      const int ch = (int)(at >> 32);
      a.cstart[ch] = c0 + k;
      a.cu[ch] = u[k];
      a.tstart[ch] = (int)(unsigned)at;
      at += (1ull << 32) | (unsigned)(u[k] + 1);
    }
    g_carry = Max()(g_carry, gmax);
    ct_carry += total;
  }
  const int chunks = (int)(ct_carry >> 32), tiles = (int)(unsigned)ct_carry;
  if (tid == 0) a.cstart[chunks] = n;
  __syncthreads();

  // ---- the tile table, a warp a chunk; the counters ----
  const int warp = tid >> 5, lane = tid & 31;
  for (int ch = warp; ch < chunks; ch += kScanThreads / 32) {
    const int u0 = a.cu[ch], t0 = a.tstart[ch];
    const int js = a.cstart[ch], jn = a.cstart[ch + 1] - js;
    for (int v = lane; v <= u0; v += 32) {
      const int is = a.cstart[ch - u0 + v], in = a.cstart[ch - u0 + v + 1] - is;
      a.items[t0 + v] = make_int4(js, is, (ch << 6) | jn, ((u0 + 1) << 6) | in);
    }
    if (lane == 0) a.done[ch] = 0;
  }
  for (int c = tid; c < n; c += kScanThreads) {
    a.hit[c] = 0;
    a.key[c] = 0ull;
  }
  if (tid == 0) {
    a.hdr[kTiles] = tiles;
    a.hdr[kTicketLeads] = 0;
    a.hdr[kTicketBest] = 0;
  }
}

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

// d += popc(A & B) over one 256-bit k step: A 16 rows, B 8 columns
__device__ __forceinline__ void mma_and_popc(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Whether entry c (row `row`) leads, once the hit flags are final
__device__ __forceinline__ bool entry_leads(const Args& a, int c, int row, bool walk) {
  return a.force_lead[row] || (walk && a.hit[c] == 0);
}

// The tiles of one launch: kBest false, the leads; true, the best leaders
template <bool kBest>
__device__ __forceinline__ void election_tiles(const Args& a) {
  extern __shared__ __align__(16) unsigned char s_rows[];  // 32 j rows, then 32 i rows
  __shared__ int s_j[kT], s_i[kT];          // the tile's selected rows
  __shared__ int s_joff[kT], s_ioff[kT];    // their places in their chunks
  __shared__ int s_jpop[kT], s_ipop[kT];
  __shared__ volatile int s_hit[kT];
  __shared__ unsigned long long s_key[kT];
  __shared__ int4 s_item;
  __shared__ int s_nj, s_ni, s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float thr = *a.threshold;
  const bool walk = !(kNeg >= thr);  // else every row's _NEG entries reach thr
  if (!kBest && !walk) return;       // leads = force_lead: nothing to test
  const int tiles = a.hdr[kTiles];

  // One pair's sim, then the test (leads) or the candidate (best leader)
  auto take = [&](int jj, int ii, float s) {
    if constexpr (kBest) {
      atomicMax(&s_key[jj], ((unsigned long long)__float_as_uint(s) << 32) | (unsigned)~s_i[ii]);
    } else if (s >= thr) {
      s_hit[jj] = 1;
    }
  };

  for (;;) {
    if (tid == 0) {
      const int t = atomicAdd(a.hdr + (kBest ? kTicketBest : kTicketLeads), 1);
      s_item = t < tiles ? a.items[t] : make_int4(-1, 0, 0, 0);
    }
    __syncthreads();
    const int4 it = s_item;
    if (it.x < 0) return;
    const int js = it.x, is = it.y, jn = it.z & 63, in = it.w & 63;
    const bool diag = js == is;
    if (warp == 0) {
      // j: leads, the rows still without a hit and not forced; best, the
      // rows that do not lead.  i: leads, every row; best, the leaders.
      int jr = 0, ir = 0;
      bool jok = false, iok = false;
      if (lane < jn) {
        jr = a.list[js + lane];
        if constexpr (kBest) {
          jok = !entry_leads(a, js + lane, jr, walk);
        } else {
          jok = !a.force_lead[jr] && *(volatile const int*)(a.hit + js + lane) == 0;
        }
      }
      if (lane < in) {
        ir = a.list[is + lane];
        iok = kBest ? entry_leads(a, is + lane, ir, walk) : true;
      }
      const unsigned jb = __ballot_sync(kFull, jok), ib = __ballot_sync(kFull, iok);
      const unsigned below = (1u << lane) - 1u;
      if (jok) {
        const int p = __popc(jb & below);
        s_j[p] = jr;
        s_joff[p] = lane;
        s_jpop[p] = a.pop[jr];
        s_hit[p] = 0;
        s_key[p] = 0ull;
      }
      if (iok) {
        const int p = __popc(ib & below);
        s_i[p] = ir;
        s_ioff[p] = lane;
        s_ipop[p] = a.pop[ir];
      }
      if (lane == 0) {
        s_nj = __popc(jb);
        s_ni = __popc(ib);
      }
    }
    __syncthreads();
    const int nj = s_nj, ni = s_ni;
    if (nj > 0 && ni > 0) {
      // ---- the rows into shared memory: smem row r < 32 is j row r,
      // 32 + r is i row r; bytes past f8 up to kp read as zeros ----
      const int rows = nj + ni;
      if (a.bulk) {
        const int per = a.f8 >> 4;
        for (int x = tid; x < rows * per; x += kTileThreads) {
          const int r = x / per, w = x - r * per;
          const int row = r < nj ? s_j[r] : s_i[r - nj];
          const int sr = r < nj ? r : kT + r - nj;
          cp_async16(s_rows + (size_t)sr * a.rs + 16 * w, a.pk + (size_t)row * a.f8 + 16 * w);
        }
        const int tail = (a.kp - a.f8) >> 2;  // words of zeros a row
        for (int x = tid; x < rows * tail; x += kTileThreads) {
          const int r = x / tail, w = x - r * tail;
          const int sr = r < nj ? r : kT + r - nj;
          reinterpret_cast<unsigned*>(s_rows + (size_t)sr * a.rs + a.f8)[w] = 0u;
        }
        cp_async_wait_all();
      } else {
        for (int x = tid; x < rows * a.kp; x += kTileThreads) {
          const int r = x / a.kp, b = x - r * a.kp;
          const int row = r < nj ? s_j[r] : s_i[r - nj];
          const int sr = r < nj ? r : kT + r - nj;
          s_rows[(size_t)sr * a.rs + b] = b < a.f8 ? __ldg(a.pk + (size_t)row * a.f8 + b) : 0;
        }
      }
      __syncthreads();
      // ---- warp w: j rows 16 (w / 4) .. + 15 against i rows 8 (w % 4)
      // .. + 7; thread (gq, t) loads words 16 s + 4 t .. + 3 of its rows
      // at k step pair s, the same words for A and B ----
      const int jb0 = 16 * (warp >> 2), ib0 = 8 * (warp & 3);
      if (jb0 < nj && ib0 < ni) {
        const int gq = lane >> 2, t = lane & 3;
        const unsigned char* ra = s_rows + (size_t)(jb0 + gq) * a.rs + 16 * t;
        const unsigned char* rb = ra + (size_t)8 * a.rs;
        const unsigned char* rc = s_rows + (size_t)(kT + ib0 + gq) * a.rs + 16 * t;
        int acc[4] = {0, 0, 0, 0};
        for (int o = 0; o < a.kp; o += 64) {
          const uint4 lo = *reinterpret_cast<const uint4*>(ra + o);
          const uint4 hi = *reinterpret_cast<const uint4*>(rb + o);
          const uint4 b = *reinterpret_cast<const uint4*>(rc + o);
          mma_and_popc(acc, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
          mma_and_popc(acc, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = jb0 + gq + 8 * (e >> 1), ii = ib0 + 2 * t + (e & 1);
          if (jj < nj && ii < ni && !(diag && s_ioff[ii] >= s_joff[jj]) && (kBest || !s_hit[jj])) {
            float u = (float)(s_ipop[ii] + s_jpop[jj]) - (float)acc[e];
            u = u < 1.0f ? 1.0f : u;
            take(jj, ii, __fdiv_rn((float)acc[e], u));
          }
        }
      }
      __syncthreads();
      if (tid < nj) {
        const int c = js + s_joff[tid];
        if constexpr (kBest) {
          if (s_key[tid] != 0ull) atomicMax(a.key + c, s_key[tid]);
        } else if (s_hit[tid]) {
          a.hit[c] = 1;
        }
      }
    }
    if constexpr (kBest) {
      // The block that finishes the chunk's last tile writes its rows
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(a.done + (it.z >> 6), 1) == (it.w >> 6) - 1;
      __syncthreads();
      if (s_last) {
        __threadfence();
        for (int x = tid; x < jn; x += kTileThreads) {
          const int c = js + x, row = a.list[c];
          const bool lead = entry_leads(a, c, row, walk);
          a.leads[row] = lead;
          if (!lead) {
            const unsigned long long k = atomicAdd(a.key + c, 0ull);
            if (k != 0ull) {
              a.lead_of[row] = (int)~(unsigned)k;
              a.best[row] = __uint_as_float((unsigned)(k >> 32));
            }
          }
        }
      }
    }
    __syncthreads();  // the tile's shared arrays are free for the next
  }
}

__global__ void __launch_bounds__(kTileThreads) election_leads_kernel(Args a) {
  election_tiles<false>(a);
}

__global__ void __launch_bounds__(kTileThreads) election_best_kernel(Args a) {
  election_tiles<true>(a);
}

int launch_tiles(const Args& a, size_t smem, int dev, cudaStream_t stream) {
  int n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  auto leads_k = election_leads_kernel;
  auto best_k = election_best_kernel;
  for (auto k : {leads_k, best_k}) {
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return (int)err;
  }
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, best_k, kTileThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * n_sm;
  const long long tiles = max_tiles(a.m);
  const int grid = (int)(tiles < resident ? tiles : resident);
  leads_k<<<grid, kTileThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  best_k<<<grid, kTileThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch a call on m rows takes, lp the plan's rows where the
// call passes sel, else 0 (any contents: the first launch sets what the
// others read).
size_t bb_leader_election_scratch(int m, int lp) {
  return layout(m < 1 ? 1 : m, lp < 0 ? 0 : lp).bytes;
}

// The contract above for m rows: pk (m, f8) packed rows, pop (m,) int32;
// order (lp,) int64 and skey (lp,) int32 the step's rows sorted stably by
// group (every row of the call that may be rejected in its group's
// segment), and sel (m,) int64 each row's step row (distinct, below lp),
// or null where the call's rows are the step's (lp == m).  Writes leads (m,) bool, lead_of
// (m,) int32, best (m,) f32.  Three launches on `stream`; returns 0 or the
// CUDA error after them.
int bb_leader_election(const void* rejected, const void* force_lead, const void* threshold,
                       const void* pk, const void* pop, const void* order, const void* skey,
                       const void* sel, void* leads, void* lead_of, void* best, void* scratch,
                       int m, int f8, int lp, void* stream) {
  if (m < 1 || pk == nullptr || pop == nullptr || f8 < 1 || order == nullptr ||
      skey == nullptr || scratch == nullptr || (sel == nullptr ? lp != m : lp < m)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout l = layout(m, sel == nullptr ? 0 : lp);
  char* s = static_cast<char*>(scratch);
  const int kp = (f8 + 63) / 64 * 64;
  const Args a{
      static_cast<const bool*>(rejected), static_cast<const bool*>(force_lead),
      static_cast<const float*>(threshold), static_cast<const unsigned char*>(pk),
      static_cast<const int*>(pop), static_cast<const int64_t*>(order),
      static_cast<const int*>(skey), static_cast<const int64_t*>(sel),
      static_cast<bool*>(leads), static_cast<int*>(lead_of), static_cast<float*>(best),
      reinterpret_cast<int*>(s + l.off[0]), reinterpret_cast<int*>(s + l.off[1]),
      reinterpret_cast<int*>(s + l.off[2]), reinterpret_cast<int*>(s + l.off[3]),
      reinterpret_cast<int*>(s + l.off[4]), reinterpret_cast<int*>(s + l.off[5]),
      reinterpret_cast<int*>(s + l.off[6]), reinterpret_cast<int*>(s + l.off[7]),
      reinterpret_cast<unsigned long long*>(s + l.off[8]),
      reinterpret_cast<int4*>(s + l.off[9]), reinterpret_cast<int*>(s + l.off[10]),
      m, lp, f8, kp, kp % 128 == 0 ? kp + 64 : kp,
      f8 % 16 == 0 && reinterpret_cast<uintptr_t>(pk) % 16 == 0,
  };
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  // Two tiles' rows; the static shared arrays take a few hundred bytes beside them
  const size_t rows = (size_t)2 * kT * a.rs;
  if (rows + 2048 > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  election_compact_kernel<<<1, kScanThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_tiles(a, rows, dev, st);
}

}  // extern "C"
