// The insert round's leader election for NVIDIA Hopper (sm_90a): among the
// round's rejected rows, each routed group elects the rows that no lower
// rejected row of the group is similar to, and every row finds its most
// similar leader below it, visiting only the pairs of one group.
//
// == What it replaces ==
//
// bblean_tpu/engine/batch.py:504-540 (step 4 of _insert_round), which XLA
// fuses inside the jitted step.  ops/leader_election.py keeps the torch
// chain the port ran before (the (M, M) planes same_group, lower,
// sim_to_lower and sim_to_leader, their any / argmax / amax, and in narrow
// rounds the in-round int8 Gram of the rejected rows) as the plain version.
//
// Contract, equal to the plain version bit for bit.  A pair (j, i) counts
// where i < j, rejected[i] and row_group[i] == row_group[j]; its sim s(j,
// i) is sims[j * m + i] or, without sims, the f32 Tanimoto of the packed
// rows of j and i: inter = popcount(pk_j & pk_i), s = inter / max(pop_i +
// pop_j - inter, 1) with an IEEE division, where row j's bits and pop
// count as zero when j is not rejected (the plain version's masked Gram).
//   leads[j] = rejected[j] & (force_lead[j] | !(-2 >= thr | any counted
//              pair of j has s >= thr))
//   best[j]  = the largest s over the counted pairs of j whose i leads,
//              -2 (_NEG) where there is none
//   lead_of[j] = the smallest such i with s == best[j], 0 where none (the
//              first argmax of the plain version's row of _NEG and sims).
// Sims are Tanimoto values (finite, >= 0), so no counted pair ties _NEG.
//
// == The bound ==
//
// The result needs the sims of the counted pairs (4 B each) or, without
// sims, the packed rows of the rejected rows once, and the O(M) flags,
// groups and outputs.  Mid-fit the 1M t = 0.3 fit routes 8,192 rows over
// ~1,646 groups, a few thousand pairs: the O(M) bytes dominate, and the
// bound is a fraction of a microsecond; the plain version reads and
// writes about 2.5 GiB of (M, M) planes a wide round.
//
// == Design: the pairs of one group, a warp a row, no (M, M) temporary ==
//
// The rows sorted stably by group (`order`, `skey`: the step's sort plan in
// wide rounds, where every rejected row sits in its group's segment in row
// order; a torch.sort of row_group in narrow rounds) list each group's
// rows in row order.  A warp takes one row j, finds its group's segment
// [lo, hi) in skey by binary search and the rows below j in it by a second
// binary search on order, and walks them 256 at a time (each lane issues
// the loads of eight positions before it uses any: a long group is a
// chain of dependent loads, order -> flags -> sims).  Two launches, as
// leads[i] must be known for every i before any argmax:
//   1. election_leads_kernel: rejected rows only; with sims each lane
//      reads the sims of its candidates (one row of sims, columns rising with the sorted
//      position); without, the warp takes the candidates one by one (a
//      ballot of the rejected ones), each lane AND-popcounting a slice of
//      the two packed rows, reduced by shuffles.  A hit ends the walk.
//   2. election_argmax_kernel: every row; each lane keeps its first
//      strict maximum over the leaders among its candidates, the warp reduces (larger s,
//      then smaller i).
// Each row costs at most M / 256 steps of its warp (the first batch routes
// all 8,192 rows to group 0: 33.5M pairs over 8,192 warps), and the sims
// of one row are read once.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kNeg = -2.0f;
constexpr int kWarps = 8;  // rows a block of 256 threads
constexpr int kUnroll = 8;  // candidate positions a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const bool* rejected;
  const bool* force_lead;
  const int* row_group;
  const float* threshold;
  const float* sims;          // (m, m) or null
  const unsigned char* pk;    // (m, f8) packed rows where sims is null
  const int* pop;             // (m,) popcounts where sims is null
  const int64_t* order;       // (m,) sorted position -> row
  const int* skey;            // (m,) groups, non-decreasing
  bool* leads;
  int* lead_of;
  float* best;
  int m;
  int f8;
  int words;                  // f8 / 4 where the packed rows are read as words, else 0
};

// Sorted positions [lo, end) of the rows of j's group below j
__device__ __forceinline__ void lower_range(const Args& a, int j, int& lo, int& end) {
  const int g = a.row_group[j];
  int l = 0, h = a.m;
  while (l < h) {  // first key >= g
    const int mid = (l + h) >> 1;
    if (a.skey[mid] < g) l = mid + 1; else h = mid;
  }
  lo = l;
  h = a.m;
  while (l < h) {  // first position past g's segment or at a row >= j
    const int mid = (l + h) >> 1;
    if (a.skey[mid] == g && a.order[mid] < j) l = mid + 1; else h = mid;
  }
  end = l;
}

// The f32 Tanimoto of rows j and i from their packed bits, summed over the
// warp (every lane returns it); j's bits count as zero unless `live_j`
__device__ __forceinline__ float pair_sim(const Args& a, int j, int i, bool live_j, int lane) {
  int inter = 0;
  if (live_j) {
    if (a.words) {
      const unsigned* pj = reinterpret_cast<const unsigned*>(a.pk + (size_t)j * a.f8);
      const unsigned* pi = reinterpret_cast<const unsigned*>(a.pk + (size_t)i * a.f8);
      for (int w = lane; w < a.words; w += 32) inter += __popc(__ldg(pj + w) & __ldg(pi + w));
    } else {
      const unsigned char* pj = a.pk + (size_t)j * a.f8;
      const unsigned char* pi = a.pk + (size_t)i * a.f8;
      for (int b = lane; b < a.f8; b += 32) inter += __popc((unsigned)(__ldg(pj + b) & __ldg(pi + b)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) inter += __shfl_xor_sync(kFull, inter, o);
  const int pop_j = live_j ? a.pop[j] : 0;
  float u = (float)(a.pop[i] + pop_j) - (float)inter;
  u = u < 1.0f ? 1.0f : u;
  return __fdiv_rn((float)inter, u);
}

// The candidates at sorted positions q0 + 32 k + lane (k < kUnroll) below
// `end`: their rows, and whether they count (rejected, and leading where
// `leaders`).  Every load of a step is issued before any is used.
__device__ __forceinline__ void load_candidates(const Args& a, int q0, int end, int lane,
                                                bool leaders, int (&i)[kUnroll],
                                                bool (&ok)[kUnroll]) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int q = q0 + 32 * k + lane;
    i[k] = q < end ? (int)__ldg(reinterpret_cast<const long long*>(a.order) + q) : 0;
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const bool in = q0 + 32 * k + lane < end;
    ok[k] = in & a.rejected[i[k]] & (!leaders || a.leads[i[k]]);
  }
}

__global__ void __launch_bounds__(32 * kWarps) election_leads_kernel(Args a) {
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= a.m) return;
  bool lead = false;
  if (a.rejected[j]) {
    const float thr = *a.threshold;
    if (a.force_lead[j]) {
      lead = true;
    } else if (!(kNeg >= thr)) {  // else the row's _NEG entries already reach thr
      int lo, end;
      lower_range(a, j, lo, end);
      bool hit = false;
      for (int q0 = lo; q0 < end && !hit; q0 += 32 * kUnroll) {
        int i[kUnroll];
        bool ok[kUnroll];
        load_candidates(a, q0, end, lane, false, i, ok);
        if (a.sims != nullptr) {
          float s[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) s[k] = ok[k] ? a.sims[(size_t)j * a.m + i[k]] : kNeg;
          bool h = false;
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) h |= ok[k] && s[k] >= thr;
          hit = __any_sync(kFull, h);
        } else {
          for (int k = 0; k < kUnroll && !hit; ++k) {
            unsigned cand = __ballot_sync(kFull, ok[k]);
            while (cand != 0u && !hit) {
              const int src = __ffs(cand) - 1;
              cand &= cand - 1u;
              const int ii = __shfl_sync(kFull, i[k], src);
              hit = pair_sim(a, j, ii, true, lane) >= thr;
            }
          }
        }
      }
      lead = !hit;
    }
  }
  if (lane == 0) a.leads[j] = lead;
}

__global__ void __launch_bounds__(32 * kWarps) election_argmax_kernel(Args a) {
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= a.m) return;
  int lo, end;
  lower_range(a, j, lo, end);
  float best = kNeg;
  int idx = INT_MAX;  // none yet
  const bool live_j = a.rejected[j];
  for (int q0 = lo; q0 < end; q0 += 32 * kUnroll) {
    int i[kUnroll];
    bool ok[kUnroll];
    load_candidates(a, q0, end, lane, true, i, ok);
    if (a.sims != nullptr) {
      float s[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) s[k] = ok[k] ? a.sims[(size_t)j * a.m + i[k]] : kNeg;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        // A lane's positions rise with k: it keeps its first maximum
        if (ok[k] && (s[k] > best || idx == INT_MAX)) {
          best = s[k];
          idx = i[k];
        }
      }
    } else {
      for (int k = 0; k < kUnroll; ++k) {
        unsigned cand = __ballot_sync(kFull, ok[k]);
        while (cand != 0u) {
          const int src = __ffs(cand) - 1;
          cand &= cand - 1u;
          const int ii = __shfl_sync(kFull, i[k], src);
          const float s = pair_sim(a, j, ii, live_j, lane);
          if (s > best || idx == INT_MAX) {  // every lane alike: rising positions
            best = s;
            idx = ii;
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (oi != INT_MAX && (idx == INT_MAX || ob > best || (ob == best && oi < idx))) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0) {
    a.lead_of[j] = idx == INT_MAX ? 0 : idx;
    a.best[j] = idx == INT_MAX ? kNeg : best;
  }
}

}  // namespace

extern "C" {

// The contract above for m rows: sims (m, m) f32, or null with pk (m, f8)
// packed rows and pop (m,) int32; order (m,) int64 and skey (m,) int32 the
// rows sorted stably by group (every rejected row in its group's
// segment).  Writes leads (m,) bool, lead_of (m,) int32, best (m,) f32.
// Two launches on `stream`; returns 0 or the CUDA error after them.
int bb_leader_election(const void* rejected, const void* force_lead, const void* row_group,
                       const void* threshold, const void* sims, const void* pk, const void* pop,
                       const void* order, const void* skey, void* leads, void* lead_of,
                       void* best, int m, int f8, void* stream) {
  if (m < 1 || (sims == nullptr && (pk == nullptr || pop == nullptr || f8 < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool words = sims == nullptr && f8 % 4 == 0 && reinterpret_cast<uintptr_t>(pk) % 4 == 0;
  const Args a{
      static_cast<const bool*>(rejected), static_cast<const bool*>(force_lead),
      static_cast<const int*>(row_group), static_cast<const float*>(threshold),
      static_cast<const float*>(sims), static_cast<const unsigned char*>(pk),
      static_cast<const int*>(pop), static_cast<const int64_t*>(order),
      static_cast<const int*>(skey), static_cast<bool*>(leads), static_cast<int*>(lead_of),
      static_cast<float*>(best), m, f8, words ? f8 / 4 : 0,
  };
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (m + kWarps - 1) / kWarps;
  election_leads_kernel<<<blocks, 32 * kWarps, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  election_argmax_kernel<<<blocks, 32 * kWarps, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
