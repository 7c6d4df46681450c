// bblean-tpu native host library.
//
// Two layers, exposed through a plain C ABI (driven from Python via ctypes):
//
//  1. Similarity kernels: packed-fingerprint popcount, array-vs-vector
//     Tanimoto, iSIM-from-sum and the O(N) most-dissimilar-pair heuristic.
//     These match the NumPy reference kernels (bblean_tpu/_np_similarity.py)
//     bit-for-bit: identical double expression order, identical clamps.
//
//  2. A complete native BitBirch exact-tree engine (bb_tree_*): the full
//     iterative insert loop of bblean_tpu/engine/exact.py in C++, with the
//     same decision order (first-occurrence argmax/argmin ties, leaf
//     linked-list split order, merge-criterion arithmetic).  The reference
//     implementation keeps this loop in Python and only the kernels native;
//     moving the whole loop native removes the per-row interpreter and
//     NumPy-dispatch overhead entirely.
//
// Numerical contracts for bit-exactness with the Python engines:
//  - Tanimoto: intersection / max(unionc, 1) in double.
//  - iSIM: a = (ksq - k) / 2 with uint64 k/ksq (wrapping semantics match
//    NumPy's uint64); isim = a / (a + n*k - ksq) with the same evaluation
//    order; all-zero sums give 1.0.
//  - Majority centroid: bit set iff 2*ls >= n (integer-exact equivalent of
//    ls >= n*0.5) for n > 1, ls itself for n <= 1.
//  - Adaptive tolerance uses a host-provided LUT of np.exp values so the
//    exp() implementation cannot diverge; beyond the LUT the tolerance is
//    exactly 0 (max-clamp with the offset).
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -march=native (see Makefile).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <limits>

#if defined(__x86_64__) && defined(__GNUC__)
#define BB_X86_DISPATCH 1
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Popcount helpers
//
// Built for a portable baseline (-march=x86-64-v2, see Makefile); the
// AVX-512 VPOPCNTDQ fast paths are compiled via per-function target
// attributes and selected at RUN TIME with __builtin_cpu_supports, so the
// same .so runs on hosts without the extension (pre-Zen4 AMD, pre-Ice-Lake
// Intel client) instead of hitting SIGILL at call time.
// ---------------------------------------------------------------------------

inline uint64_t load_u64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

inline int64_t popcount_bytes_scalar(const uint8_t* p, int64_t n_bytes) {
    int64_t total = 0;
    int64_t i = 0;
    for (; i + 8 <= n_bytes; i += 8) {
        total += __builtin_popcountll(load_u64(p + i));
    }
    for (; i < n_bytes; ++i) {
        total += __builtin_popcount(p[i]);
    }
    return total;
}

inline int64_t and_popcount_bytes_scalar(const uint8_t* a, const uint8_t* b,
                                         int64_t n_bytes) {
    int64_t total = 0;
    int64_t i = 0;
    for (; i + 8 <= n_bytes; i += 8) {
        total += __builtin_popcountll(load_u64(a + i) & load_u64(b + i));
    }
    for (; i < n_bytes; ++i) {
        total += __builtin_popcount(a[i] & b[i]);
    }
    return total;
}

#ifdef BB_X86_DISPATCH
// 64 bytes per iteration through the AVX-512 VPOPCNTQ unit.  Unaligned
// loads are fine (loadu); the 8-byte scalar tail handles any remainder.
__attribute__((target("avx512f,avx512vpopcntdq")))
int64_t popcount_bytes_avx512(const uint8_t* p, int64_t n_bytes) {
    __m512i acc = _mm512_setzero_si512();
    int64_t i = 0;
    for (; i + 64 <= n_bytes; i += 64) {
        __m512i v = _mm512_loadu_si512(p + i);
        acc = _mm512_add_epi64(acc, _mm512_popcnt_epi64(v));
    }
    int64_t total = _mm512_reduce_add_epi64(acc);
    for (; i + 8 <= n_bytes; i += 8) {
        total += __builtin_popcountll(load_u64(p + i));
    }
    for (; i < n_bytes; ++i) {
        total += __builtin_popcount(p[i]);
    }
    return total;
}

__attribute__((target("avx512f,avx512vpopcntdq")))
int64_t and_popcount_bytes_avx512(const uint8_t* a, const uint8_t* b,
                                  int64_t n_bytes) {
    __m512i acc = _mm512_setzero_si512();
    int64_t i = 0;
    for (; i + 64 <= n_bytes; i += 64) {
        __m512i v = _mm512_and_si512(_mm512_loadu_si512(a + i),
                                     _mm512_loadu_si512(b + i));
        acc = _mm512_add_epi64(acc, _mm512_popcnt_epi64(v));
    }
    int64_t total = _mm512_reduce_add_epi64(acc);
    for (; i + 8 <= n_bytes; i += 8) {
        total += __builtin_popcountll(load_u64(a + i) & load_u64(b + i));
    }
    for (; i < n_bytes; ++i) {
        total += __builtin_popcount(a[i] & b[i]);
    }
    return total;
}

inline bool has_vpopcntdq() {
    static const bool ok = __builtin_cpu_supports("avx512f") &&
                           __builtin_cpu_supports("avx512vpopcntdq");
    return ok;
}

inline int64_t popcount_bytes(const uint8_t* p, int64_t n_bytes) {
    if (has_vpopcntdq()) return popcount_bytes_avx512(p, n_bytes);
    return popcount_bytes_scalar(p, n_bytes);
}

inline int64_t and_popcount_bytes(const uint8_t* a, const uint8_t* b,
                                  int64_t n_bytes) {
    if (has_vpopcntdq()) return and_popcount_bytes_avx512(a, b, n_bytes);
    return and_popcount_bytes_scalar(a, b, n_bytes);
}
#else
inline int64_t popcount_bytes(const uint8_t* p, int64_t n_bytes) {
    return popcount_bytes_scalar(p, n_bytes);
}

inline int64_t and_popcount_bytes(const uint8_t* a, const uint8_t* b,
                                  int64_t n_bytes) {
    return and_popcount_bytes_scalar(a, b, n_bytes);
}
#endif

inline double tanimoto_from_counts(int64_t inter, int64_t card_a,
                                   int64_t card_b) {
    int64_t unionc = card_a + card_b - inter;
    if (unionc < 1) unionc = 1;
    return double(inter) / double(unionc);
}

// iSIM from a uint64 linear sum; matches _np_similarity.jt_isim_from_sum
inline double isim_from_sum_u64(const uint64_t* ls, int64_t len, int64_t n) {
    uint64_t k = 0;
    uint64_t ksq = 0;
    for (int64_t i = 0; i < len; ++i) {
        k += ls[i];
        ksq += ls[i] * ls[i];  // uint64 wrap matches numpy dot
    }
    if (k == 0) return 1.0;
    double a = double(ksq - k) / 2.0;
    double denom = a + double(uint64_t(n) * k) - double(ksq);
    return a / denom;
}

// ---------------------------------------------------------------------------
// The exact BitBirch tree
// ---------------------------------------------------------------------------

enum Criterion {
    RADIUS = 0,
    DIAMETER = 1,
    TOLERANCE_DIAMETER = 2,
    TOLERANCE_RADIUS = 3,
    TOLERANCE_LEGACY = 4,
    NEVER_MERGE = 5,
};

struct Sub {
    std::vector<uint32_t> ls;   // linear sum, one entry per feature
    int64_t n = 0;
    int64_t card = 0;           // popcount of the packed centroid
    std::vector<uint8_t> cent;  // packed majority centroid
    int32_t child = -1;         // node id, -1 for leaf subclusters
    uint8_t creation_code = 1;  // bytes of the creating buffer's dtype
    bool mutated = false;       // true after any merge commit
    std::vector<int64_t> mols;  // molecule indices (leaf subclusters only)
};

struct Node {
    std::vector<int32_t> subs;
    std::vector<uint8_t> cent_buf;  // (B + 1) * n_bytes packed centroids
    std::vector<int64_t> cards;     // cached centroid popcounts (per entry)
    int32_t prev = -1;              // leaf linked list; -1 = not a leaf
    int32_t next = -1;
};

struct Tree {
    int64_t n_features;
    int64_t n_bytes;
    int64_t branching;
    int criterion;
    double threshold;
    double tolerance;
    std::vector<double> tol_lut;  // tolerance * (exp(-d*n) - offset), >= 0
    std::vector<Node> nodes;
    std::vector<Sub> subs;
    int32_t root = -1;
    int32_t dummy = -1;
    // Scratch
    std::vector<double> sims;
    std::vector<uint32_t> scratch_ls;
    std::vector<uint8_t> scratch_bits;

    int32_t new_node() {
        nodes.emplace_back();
        Node& nd = nodes.back();
        nd.cent_buf.resize(size_t(branching + 1) * n_bytes);
        return int32_t(nodes.size() - 1);
    }

    void init() {
        dummy = new_node();
        root = new_node();
        nodes[dummy].next = root;
        nodes[root].prev = dummy;
    }

    // Majority-vote centroid (packed) from a subcluster's CF; returns its
    // popcount so callers can maintain cardinality caches for free
    int64_t pack_centroid(const std::vector<uint32_t>& ls, int64_t n,
                          std::vector<uint8_t>& out) const {
        out.assign(n_bytes, 0);
        int64_t card = 0;
        if (n <= 1) {
            for (int64_t f = 0; f < n_features; ++f) {
                if (ls[f]) {
                    out[f >> 3] |= uint8_t(0x80u >> (f & 7));
                    ++card;
                }
            }
        } else {
            for (int64_t f = 0; f < n_features; ++f) {
                if (int64_t(ls[f]) * 2 >= n) {
                    out[f >> 3] |= uint8_t(0x80u >> (f & 7));
                    ++card;
                }
            }
        }
        return card;
    }

    double isim(const std::vector<uint32_t>& ls, int64_t n) const {
        uint64_t k = 0, ksq = 0;
        for (int64_t f = 0; f < n_features; ++f) {
            uint64_t v = ls[f];
            k += v;
            ksq += v * v;
        }
        if (n < 2) return std::numeric_limits<double>::quiet_NaN();
        if (k == 0) return 1.0;
        double a = double(ksq - k) / 2.0;
        return a / (a + double(uint64_t(n) * k) - double(ksq));
    }

    // Complement of the Tanimoto radius; matches
    // similarity.jt_isim_radius_compl_from_sum expression order
    double radius_compl(const std::vector<uint32_t>& ls, int64_t n) const {
        uint64_t k = 0, ksq = 0, k1 = 0, ksq1 = 0;
        for (int64_t f = 0; f < n_features; ++f) {
            uint64_t v = ls[f];
            uint64_t bit;
            if (n <= 1) {
                bit = v ? 1 : 0;  // centroid == the (0/1) sample itself
                if (v > 1) bit = v;  // degenerate; unreachable for valid CFs
            } else {
                bit = (int64_t(v) * 2 >= n) ? 1 : 0;
            }
            uint64_t v1 = v + bit;
            k += v;
            ksq += v * v;
            k1 += v1;
            ksq1 += v1 * v1;
        }
        double isim_n;
        if (n < 2) {
            isim_n = std::numeric_limits<double>::quiet_NaN();
        } else if (k == 0) {
            isim_n = 1.0;
        } else {
            double a = double(ksq - k) / 2.0;
            isim_n = a / (a + double(uint64_t(n) * k) - double(ksq));
        }
        double isim_n1;
        if (k1 == 0) {
            isim_n1 = 1.0;
        } else {
            double a1 = double(ksq1 - k1) / 2.0;
            isim_n1 = a1 / (a1 + double(uint64_t(n + 1) * k1) - double(ksq1));
        }
        return (isim_n1 * double(n + 1) - isim_n * double(n - 1)) / 2.0;
    }

    double adaptive_tol(int64_t old_n) const {
        // LUT holds max(exp(-decay*n) - offset, 0); scale by the current
        // tolerance so set_params can change it without rebuilding the LUT
        if (old_n >= 0 && old_n < int64_t(tol_lut.size()))
            return tolerance * tol_lut[old_n];
        return 0.0;  // beyond n_max the clamped tolerance is exactly 0
    }

    bool merge_accept(const std::vector<uint32_t>& new_ls, int64_t new_n,
                      const std::vector<uint32_t>& old_ls, int64_t old_n,
                      int64_t nom_n) const {
        switch (criterion) {
            case NEVER_MERGE:
                return false;
            case DIAMETER:
                return isim(new_ls, new_n) >= threshold;
            case RADIUS:
                return radius_compl(new_ls, new_n) >= threshold;
            case TOLERANCE_DIAMETER: {
                double new_c = isim(new_ls, new_n);
                if (!(new_c >= threshold)) return false;
                if (old_n == 1) return true;
                double old_c = isim(old_ls, old_n);
                return new_c >= old_c - adaptive_tol(old_n);
            }
            case TOLERANCE_RADIUS: {
                double new_c = radius_compl(new_ls, new_n);
                if (!(new_c >= threshold)) return false;
                if (old_n == 1) return true;
                double old_c = radius_compl(old_ls, old_n);
                return new_c >= old_c - adaptive_tol(old_n);
            }
            case TOLERANCE_LEGACY: {
                double new_dc = isim(new_ls, new_n);
                if (!(new_dc >= threshold)) return false;
                if (old_n == 1 || nom_n != 1) return true;
                double old_dc = isim(old_ls, old_n);
                return (new_dc * double(new_n) - old_dc * double(old_n - 1)) /
                           2.0 >=
                       old_dc - tolerance;
            }
        }
        return false;
    }

    // First-occurrence argmax of Tanimoto(node centroids, probe); uses the
    // per-node cardinality cache (recomputing popcounts per entry per insert
    // doubled the kernel cost)
    int64_t closest_in_node(const Node& nd, const uint8_t* probe,
                            int64_t probe_card) {
        int64_t best = 0;
        double best_sim = -1.0;
        for (size_t i = 0; i < nd.subs.size(); ++i) {
            const uint8_t* cent = nd.cent_buf.data() + i * n_bytes;
            int64_t inter = and_popcount_bytes(cent, probe, n_bytes);
            double sim = tanimoto_from_counts(inter, nd.cards[i], probe_card);
            if (sim > best_sim) {
                best_sim = sim;
                best = int64_t(i);
            }
        }
        return best;
    }

    void append_sub(int32_t node_id, int32_t sid) {
        Node& nd = nodes[node_id];
        std::memcpy(nd.cent_buf.data() + nd.subs.size() * n_bytes,
                    subs[sid].cent.data(), n_bytes);
        nd.cards.push_back(subs[sid].card);
        nd.subs.push_back(sid);
    }

    // Fold sid's CF into a tracking entry (no mol indices for internal CFs)
    void cf_add(int32_t entry, int32_t sid) {
        Sub& e = subs[entry];
        const Sub& s = subs[sid];
        for (int64_t f = 0; f < n_features; ++f) e.ls[f] += s.ls[f];
        e.n += s.n;
        e.mutated = true;
        e.card = pack_centroid(e.ls, e.n, e.cent);
    }

    // Most-dissimilar pair over a node's centroids, and the balanced-vs-
    // reference-faithful partition mask (reference semantics: strictly
    // closer to seed1 joins node1; seed1 forced)
    void split_node(int32_t node2_id, int32_t* out_sc1, int32_t* out_sc2) {
        // New tracking subclusters + the new node
        int32_t node1_id = new_node();
        if (nodes[node2_id].prev != -1) {
            int32_t prev = nodes[node2_id].prev;
            nodes[node1_id].prev = prev;
            nodes[prev].next = node1_id;
            nodes[node1_id].next = node2_id;
            nodes[node2_id].prev = node1_id;
        }

        Node& node2 = nodes[node2_id];
        size_t count = node2.subs.size();
        // Linear sum of member centroids -> majority seed centroid
        std::vector<uint32_t>& sum = scratch_ls;
        sum.assign(n_features, 0);
        for (size_t i = 0; i < count; ++i) {
            const uint8_t* cent = node2.cent_buf.data() + i * n_bytes;
            for (int64_t f = 0; f < n_features; ++f) {
                sum[f] += (cent[f >> 3] >> (7 - (f & 7))) & 1u;
            }
        }
        std::vector<uint8_t> seed;
        pack_centroid(sum, int64_t(count), seed);

        const std::vector<int64_t>& cards = node2.cards;
        int64_t seed_card = popcount_bytes(seed.data(), n_bytes);

        // fp1: least similar to the centroid (first-occurrence argmin)
        int64_t i1 = 0;
        double worst = 2.0;
        for (size_t i = 0; i < count; ++i) {
            int64_t inter = and_popcount_bytes(
                node2.cent_buf.data() + i * n_bytes, seed.data(), n_bytes);
            double sim = tanimoto_from_counts(inter, cards[i], seed_card);
            if (sim < worst) {
                worst = sim;
                i1 = int64_t(i);
            }
        }
        // fp2: least similar to fp1; record both similarity rows
        std::vector<double> sims1(count), sims2(count);
        const uint8_t* fp1 = node2.cent_buf.data() + i1 * n_bytes;
        int64_t i2 = 0;
        worst = 2.0;
        for (size_t i = 0; i < count; ++i) {
            int64_t inter = and_popcount_bytes(
                node2.cent_buf.data() + i * n_bytes, fp1, n_bytes);
            sims1[i] = tanimoto_from_counts(inter, cards[i], cards[i1]);
            if (sims1[i] < worst) {
                worst = sims1[i];
                i2 = int64_t(i);
            }
        }
        const uint8_t* fp2 = node2.cent_buf.data() + i2 * n_bytes;
        for (size_t i = 0; i < count; ++i) {
            int64_t inter = and_popcount_bytes(
                node2.cent_buf.data() + i * n_bytes, fp2, n_bytes);
            sims2[i] = tanimoto_from_counts(inter, cards[i], cards[i2]);
        }

        // Redistribute; node1 gets strictly-closer members plus seed 1
        std::vector<int32_t> old_subs;
        old_subs.swap(nodes[node2_id].subs);
        nodes[node2_id].cards.clear();

        int32_t sc1 = int32_t(subs.size());
        subs.emplace_back();
        int32_t sc2 = int32_t(subs.size());
        subs.emplace_back();
        for (int32_t sc : {sc1, sc2}) {
            subs[sc].ls.assign(n_features, 0);
            subs[sc].n = 0;
        }
        subs[sc1].child = node1_id;
        subs[sc2].child = node2_id;

        for (size_t i = 0; i < old_subs.size(); ++i) {
            bool to1 = (sims1[i] > sims2[i]) || int64_t(i) == i1;
            int32_t target_node = to1 ? node1_id : node2_id;
            int32_t target_sc = to1 ? sc1 : sc2;
            append_sub(target_node, old_subs[i]);
            Sub& t = subs[target_sc];
            const Sub& m = subs[old_subs[i]];
            for (int64_t f = 0; f < n_features; ++f) t.ls[f] += m.ls[f];
            t.n += m.n;
        }
        subs[sc1].card = pack_centroid(subs[sc1].ls, subs[sc1].n, subs[sc1].cent);
        subs[sc2].card = pack_centroid(subs[sc2].ls, subs[sc2].n, subs[sc2].cent);
        *out_sc1 = sc1;
        *out_sc2 = sc2;
    }

    bool try_merge(int32_t closest, int32_t nominee) {
        Sub& c = subs[closest];
        Sub& s = subs[nominee];
        int64_t new_n = c.n + s.n;
        std::vector<uint32_t>& new_ls = scratch_ls;
        new_ls.resize(n_features);
        for (int64_t f = 0; f < n_features; ++f) new_ls[f] = c.ls[f] + s.ls[f];
        if (!merge_accept(new_ls, new_n, c.ls, c.n, s.n)) return false;
        c.ls.swap(new_ls);
        c.n = new_n;
        c.mutated = true;
        c.card = pack_centroid(c.ls, c.n, c.cent);
        c.mols.insert(c.mols.end(), s.mols.begin(), s.mols.end());
        return true;
    }

    void insert(int32_t sid) {
        int32_t node_id = root;
        // (node, entry position) descent path
        std::vector<std::pair<int32_t, int64_t>> path;
        int64_t probe_card = popcount_bytes(subs[sid].cent.data(), n_bytes);
        int64_t closest = 0;

        for (;;) {
            Node& nd = nodes[node_id];
            if (nd.subs.empty()) {
                append_sub(node_id, sid);
                return;
            }
            closest = closest_in_node(nd, subs[sid].cent.data(), probe_card);
            int32_t child = subs[nd.subs[closest]].child;
            if (child == -1) break;
            path.emplace_back(node_id, closest);
            node_id = child;
        }

        bool must_split;
        {
            Node& leaf = nodes[node_id];
            int32_t closest_id = leaf.subs[closest];
            if (try_merge(closest_id, sid)) {
                std::memcpy(leaf.cent_buf.data() + closest * n_bytes,
                            subs[closest_id].cent.data(), n_bytes);
                leaf.cards[closest] = subs[closest_id].card;
                must_split = false;
            } else {
                append_sub(node_id, sid);
                must_split = int64_t(leaf.subs.size()) > branching;
            }
        }

        while (!path.empty()) {
            auto [pnode, pidx] = path.back();
            path.pop_back();
            if (must_split) {
                int32_t child_node = subs[nodes[pnode].subs[pidx]].child;
                int32_t sc1, sc2;
                split_node(child_node, &sc1, &sc2);
                nodes[pnode].subs[pidx] = sc1;
                std::memcpy(nodes[pnode].cent_buf.data() + pidx * n_bytes,
                            subs[sc1].cent.data(), n_bytes);
                nodes[pnode].cards[pidx] = subs[sc1].card;
                append_sub(pnode, sc2);
                must_split = int64_t(nodes[pnode].subs.size()) > branching;
            } else {
                int32_t entry = nodes[pnode].subs[pidx];
                cf_add(entry, sid);
                std::memcpy(nodes[pnode].cent_buf.data() + pidx * n_bytes,
                            subs[entry].cent.data(), n_bytes);
                nodes[pnode].cards[pidx] = subs[entry].card;
            }
        }
        if (must_split) {
            int32_t sc1, sc2;
            split_node(root, &sc1, &sc2);
            root = new_node();
            append_sub(root, sc1);
            append_sub(root, sc2);
        }
    }

    // Collect leaf subcluster ids in leaf-linked-list order
    void leaf_sub_ids(std::vector<int32_t>& out) const {
        out.clear();
        int32_t leaf = nodes[dummy].next;
        while (leaf != -1) {
            for (int32_t sid : nodes[leaf].subs) out.push_back(sid);
            leaf = nodes[leaf].next;
        }
    }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI: similarity kernels
// ---------------------------------------------------------------------------

extern "C" {

double bb_jt_isim_from_sum_u64(const uint64_t* ls, int64_t len, int64_t n) {
    return isim_from_sum_u64(ls, len, n);
}

void bb_jt_sim_arr_vec_packed(const uint8_t* arr, const uint8_t* vec,
                              int64_t n_rows, int64_t n_bytes, double* out) {
    int64_t vec_card = popcount_bytes(vec, n_bytes);
    for (int64_t i = 0; i < n_rows; ++i) {
        const uint8_t* row = arr + i * n_bytes;
        int64_t inter = and_popcount_bytes(row, vec, n_bytes);
        int64_t card = popcount_bytes(row, n_bytes);
        out[i] = tanimoto_from_counts(inter, card, vec_card);
    }
}

void bb_most_dissimilar_packed(const uint8_t* arr, int64_t n_rows,
                               int64_t n_bytes, int64_t n_features,
                               int64_t* out_i1, int64_t* out_i2,
                               double* out_sims1, double* out_sims2) {
    // Majority centroid of the (unpacked) rows
    std::vector<uint32_t> sum(n_features, 0);
    for (int64_t i = 0; i < n_rows; ++i) {
        const uint8_t* row = arr + i * n_bytes;
        for (int64_t f = 0; f < n_features; ++f) {
            sum[f] += (row[f >> 3] >> (7 - (f & 7))) & 1u;
        }
    }
    std::vector<uint8_t> seed(n_bytes, 0);
    if (n_rows <= 1) {
        for (int64_t f = 0; f < n_features; ++f)
            if (sum[f]) seed[f >> 3] |= uint8_t(0x80u >> (f & 7));
    } else {
        for (int64_t f = 0; f < n_features; ++f)
            if (int64_t(sum[f]) * 2 >= n_rows)
                seed[f >> 3] |= uint8_t(0x80u >> (f & 7));
    }
    std::vector<int64_t> cards(n_rows);
    for (int64_t i = 0; i < n_rows; ++i)
        cards[i] = popcount_bytes(arr + i * n_bytes, n_bytes);
    int64_t seed_card = popcount_bytes(seed.data(), n_bytes);

    int64_t i1 = 0;
    double worst = 2.0;
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t inter =
            and_popcount_bytes(arr + i * n_bytes, seed.data(), n_bytes);
        double sim = tanimoto_from_counts(inter, cards[i], seed_card);
        if (sim < worst) {
            worst = sim;
            i1 = i;
        }
    }
    const uint8_t* fp1 = arr + i1 * n_bytes;
    int64_t i2 = 0;
    worst = 2.0;
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t inter = and_popcount_bytes(arr + i * n_bytes, fp1, n_bytes);
        out_sims1[i] = tanimoto_from_counts(inter, cards[i], cards[i1]);
        if (out_sims1[i] < worst) {
            worst = out_sims1[i];
            i2 = i;
        }
    }
    const uint8_t* fp2 = arr + i2 * n_bytes;
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t inter = and_popcount_bytes(arr + i * n_bytes, fp2, n_bytes);
        out_sims2[i] = tanimoto_from_counts(inter, cards[i], cards[i2]);
    }
    *out_i1 = i1;
    *out_i2 = i2;
}

// ---------------------------------------------------------------------------
// C ABI: exact tree engine
// ---------------------------------------------------------------------------

void* bb_tree_new(int64_t n_features, int64_t branching, int criterion,
                  double threshold, double tolerance, const double* tol_lut,
                  int64_t lut_len) {
    Tree* t = new Tree();
    t->n_features = n_features;
    t->n_bytes = (n_features + 7) / 8;
    t->branching = branching;
    t->criterion = criterion;
    t->threshold = threshold;
    t->tolerance = tolerance;
    if (tol_lut && lut_len > 0) t->tol_lut.assign(tol_lut, tol_lut + lut_len);
    t->init();
    return t;
}

void bb_tree_free(void* handle) { delete static_cast<Tree*>(handle); }

void bb_tree_set_params(void* handle, int criterion, double threshold,
                        double tolerance) {
    Tree* t = static_cast<Tree*>(handle);
    t->criterion = criterion;
    t->threshold = threshold;
    t->tolerance = tolerance;
}

// Insert packed fingerprint rows (each a singleton CF)
void bb_tree_insert_packed(void* handle, const uint8_t* fps, int64_t n_rows,
                           int64_t row_bytes, const int64_t* mol_idxs) {
    Tree* t = static_cast<Tree*>(handle);
    for (int64_t i = 0; i < n_rows; ++i) {
        const uint8_t* row = fps + i * row_bytes;
        int32_t sid = int32_t(t->subs.size());
        t->subs.emplace_back();
        Sub& s = t->subs.back();
        s.ls.assign(t->n_features, 0);
        for (int64_t f = 0; f < t->n_features; ++f)
            s.ls[f] = (row[f >> 3] >> (7 - (f & 7))) & 1u;
        s.n = 1;
        s.cent.assign(row, row + t->n_bytes);
        s.card = popcount_bytes(row, t->n_bytes);
        // Zero any padding bits beyond n_features (defensive; packbits pads 0)
        s.creation_code = 1;
        s.mols.push_back(mol_idxs[i]);
        t->insert(sid);
    }
}

// Insert pre-aggregated CF buffers (uint64 linear sums + counts)
void bb_tree_insert_buffers(void* handle, const uint64_t* ls_rows,
                            const int64_t* ns, int64_t n_rows,
                            const int64_t* mols_flat,
                            const int64_t* mols_offsets, int dtype_code) {
    Tree* t = static_cast<Tree*>(handle);
    for (int64_t i = 0; i < n_rows; ++i) {
        int32_t sid = int32_t(t->subs.size());
        t->subs.emplace_back();
        Sub& s = t->subs.back();
        s.ls.resize(t->n_features);
        const uint64_t* row = ls_rows + i * t->n_features;
        for (int64_t f = 0; f < t->n_features; ++f)
            s.ls[f] = uint32_t(row[f]);
        s.n = ns[i];
        s.creation_code = uint8_t(dtype_code);
        s.card = t->pack_centroid(s.ls, s.n, s.cent);
        s.mols.assign(mols_flat + mols_offsets[i],
                      mols_flat + mols_offsets[i + 1]);
        t->insert(sid);
    }
}

int64_t bb_tree_num_leaf_subs(void* handle) {
    Tree* t = static_cast<Tree*>(handle);
    std::vector<int32_t> ids;
    t->leaf_sub_ids(ids);
    return int64_t(ids.size());
}

// Per-leaf-subcluster metadata, in leaf-linked-list order
void bb_tree_leaf_meta(void* handle, int64_t* ns, int64_t* mol_counts,
                       uint8_t* mutated, uint8_t* creation_codes) {
    Tree* t = static_cast<Tree*>(handle);
    std::vector<int32_t> ids;
    t->leaf_sub_ids(ids);
    for (size_t i = 0; i < ids.size(); ++i) {
        const Sub& s = t->subs[ids[i]];
        ns[i] = s.n;
        mol_counts[i] = int64_t(s.mols.size());
        mutated[i] = s.mutated ? 1 : 0;
        creation_codes[i] = s.creation_code;
    }
}

void bb_tree_leaf_mols(void* handle, int64_t* out_flat) {
    Tree* t = static_cast<Tree*>(handle);
    std::vector<int32_t> ids;
    t->leaf_sub_ids(ids);
    int64_t pos = 0;
    for (int32_t sid : ids) {
        const Sub& s = t->subs[sid];
        std::memcpy(out_flat + pos, s.mols.data(),
                    s.mols.size() * sizeof(int64_t));
        pos += int64_t(s.mols.size());
    }
}

void bb_tree_leaf_centroids(void* handle, uint8_t* out_packed) {
    Tree* t = static_cast<Tree*>(handle);
    std::vector<int32_t> ids;
    t->leaf_sub_ids(ids);
    for (size_t i = 0; i < ids.size(); ++i) {
        std::memcpy(out_packed + i * t->n_bytes, t->subs[ids[i]].cent.data(),
                    t->n_bytes);
    }
}

void bb_tree_leaf_ls(void* handle, uint64_t* out) {
    Tree* t = static_cast<Tree*>(handle);
    std::vector<int32_t> ids;
    t->leaf_sub_ids(ids);
    for (size_t i = 0; i < ids.size(); ++i) {
        const Sub& s = t->subs[ids[i]];
        uint64_t* row = out + i * t->n_features;
        for (int64_t f = 0; f < t->n_features; ++f) row[f] = s.ls[f];
    }
}

int bb_tree_root_is_leaf(void* handle) {
    Tree* t = static_cast<Tree*>(handle);
    return (t->root != -1 && t->nodes[t->root].prev != -1) ? 1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-tree binary serialization (pickle support)
// ---------------------------------------------------------------------------

namespace {

struct Writer {
    uint8_t* p;
    template <typename T>
    void put(const T& v) {
        std::memcpy(p, &v, sizeof(T));
        p += sizeof(T);
    }
    template <typename T>
    void put_vec(const std::vector<T>& v) {
        put(int64_t(v.size()));
        std::memcpy(p, v.data(), v.size() * sizeof(T));
        p += v.size() * sizeof(T);
    }
};

struct Reader {
    const uint8_t* p;
    template <typename T>
    void get(T& v) {
        std::memcpy(&v, p, sizeof(T));
        p += sizeof(T);
    }
    template <typename T>
    void get_vec(std::vector<T>& v) {
        int64_t len;
        get(len);
        v.resize(size_t(len));
        std::memcpy(v.data(), p, v.size() * sizeof(T));
        p += v.size() * sizeof(T);
    }
};

template <typename T>
int64_t vec_size(const std::vector<T>& v) {
    return int64_t(sizeof(int64_t) + v.size() * sizeof(T));
}

}  // namespace

extern "C" {

int64_t bb_tree_serialized_size(void* handle) {
    Tree* t = static_cast<Tree*>(handle);
    int64_t total = 8 * sizeof(int64_t) + 2 * sizeof(double);
    total += vec_size(t->tol_lut);
    total += sizeof(int64_t);  // n_nodes
    for (const Node& nd : t->nodes) {
        total += 2 * sizeof(int32_t);
        total += vec_size(nd.subs) + vec_size(nd.cent_buf) + vec_size(nd.cards);
    }
    total += sizeof(int64_t);  // n_subs
    for (const Sub& s : t->subs) {
        total += 2 * sizeof(int64_t) + sizeof(int32_t) + 2 * sizeof(uint8_t);
        total += vec_size(s.ls) + vec_size(s.cent) + vec_size(s.mols);
    }
    return total;
}

void bb_tree_serialize(void* handle, uint8_t* out) {
    Tree* t = static_cast<Tree*>(handle);
    Writer w{out};
    w.put(t->n_features);
    w.put(t->n_bytes);
    w.put(t->branching);
    w.put(int64_t(t->criterion));
    w.put(int64_t(t->root));
    w.put(int64_t(t->dummy));
    w.put(t->threshold);
    w.put(t->tolerance);
    w.put(int64_t(0));  // reserved
    w.put(int64_t(0));  // reserved
    w.put_vec(t->tol_lut);
    w.put(int64_t(t->nodes.size()));
    for (const Node& nd : t->nodes) {
        w.put(nd.prev);
        w.put(nd.next);
        w.put_vec(nd.subs);
        w.put_vec(nd.cent_buf);
        w.put_vec(nd.cards);
    }
    w.put(int64_t(t->subs.size()));
    for (const Sub& s : t->subs) {
        w.put(s.n);
        w.put(s.card);
        w.put(s.child);
        w.put(s.creation_code);
        w.put(uint8_t(s.mutated ? 1 : 0));
        w.put_vec(s.ls);
        w.put_vec(s.cent);
        w.put_vec(s.mols);
    }
}

void* bb_tree_deserialize(const uint8_t* data) {
    Tree* t = new Tree();
    Reader r{data};
    int64_t criterion, root, dummy, reserved;
    r.get(t->n_features);
    r.get(t->n_bytes);
    r.get(t->branching);
    r.get(criterion);
    r.get(root);
    r.get(dummy);
    r.get(t->threshold);
    r.get(t->tolerance);
    r.get(reserved);
    r.get(reserved);
    t->criterion = int(criterion);
    t->root = int32_t(root);
    t->dummy = int32_t(dummy);
    r.get_vec(t->tol_lut);
    int64_t n_nodes;
    r.get(n_nodes);
    t->nodes.resize(size_t(n_nodes));
    for (Node& nd : t->nodes) {
        r.get(nd.prev);
        r.get(nd.next);
        r.get_vec(nd.subs);
        r.get_vec(nd.cent_buf);
        r.get_vec(nd.cards);
    }
    int64_t n_subs;
    r.get(n_subs);
    t->subs.resize(size_t(n_subs));
    for (Sub& s : t->subs) {
        uint8_t mutated;
        r.get(s.n);
        r.get(s.card);
        r.get(s.child);
        r.get(s.creation_code);
        r.get(mutated);
        s.mutated = mutated != 0;
        r.get_vec(s.ls);
        r.get_vec(s.cent);
        r.get_vec(s.mols);
    }
    return t;
}

}  // extern "C"
