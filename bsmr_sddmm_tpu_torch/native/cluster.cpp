// Native greedy row-clustering for BSMR reordering.
//
// C++/OpenMP replacement for the hot preprocessing loop (the reference
// runs this on-GPU with dynamic parallelism and per-row spinlocks,
// src/rowReordering.cu:325-432; the TPU-native framework keeps clustering
// host-side, and this module is its production implementation — the
// NumPy/SciPy version in reorder.py is the readable fallback/spec).
//
// Inputs are the row encodings in CSR form, rows already sorted ascending
// by dispersion. Similarity is the normalized weighted Jaccard
// (rowReordering.cu:235-293):
//
//     sim(a, b) = sum_k min(a_hat_k, b_hat_k) / sum_k max(a_hat_k, b_hat_k)
//     sum(max) = ||a_hat||_1 + ||b_hat||_1 - sum(min)
//
// Two prunings make this subquadratic in practice without changing a
// single decision:
//   * inverted index over encoding blocks — rows sharing no block with
//     the representative have sim == 0 and are never touched (the killer
//     optimization for power-law matrices where most rows end up
//     singleton clusters);
//   * l1-ratio upper bound — sim <= min(l1a,l1b)/max(l1a,l1b), so rows
//     outside the alpha band skip the dot product.
//
// Exposed with a plain C ABI; loaded from Python via ctypes (no pybind11
// in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct InvertedIndex {
    // rows listed per encoding block, over ALL rows. Lists COMPACT
    // LAZILY: assigned rows met during a walk are swapped behind the
    // per-block live end, so a hub block's list shrinks as its rows get
    // clustered instead of being re-skipped by every later
    // representative (the round-1 power-law tail: ~R reps x O(hub list)
    // touches; with compaction each entry is removed at most once,
    // amortized O(total entries) over the whole run). Decisions are
    // unchanged — assigned rows were never candidates.
    std::vector<int64_t> ptr;   // (nblocks+1)
    std::vector<int64_t> rows;  // (total entries, mutable order)
    std::vector<double> vals;   // row's normalized value in that block
    std::vector<int64_t> live;  // (nblocks) current live end per block

    InvertedIndex(int64_t R, const int64_t* indptr, const int32_t* indices,
                  const double* data_hat, int64_t nblocks) {
        ptr.assign(nblocks + 1, 0);
        const int64_t total = indptr[R];
        for (int64_t i = 0; i < total; ++i) ptr[indices[i] + 1]++;
        for (int64_t b = 0; b < nblocks; ++b) ptr[b + 1] += ptr[b];
        rows.assign(total, 0);
        vals.assign(total, 0.0);
        std::vector<int64_t> cursor(ptr.begin(), ptr.end() - 1);
        for (int64_t r = 0; r < R; ++r)
            for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
                const int64_t c = cursor[indices[i]]++;
                rows[c] = r;
                vals[c] = data_hat ? data_hat[i] : 0.0;
            }
        live.assign(ptr.begin() + 1, ptr.end());
    }
};

// candidates: unassigned rows sharing >= 1 block with `blocks`, appended
// UNSORTED (deduped via the stamp marker) — the fast strategy's hit test
// is order-independent, and sorting hub-block candidate lists costs more
// than testing them. Assigned rows are compacted out of the walked lists
// (rows processed before the current rep are always assigned, so the
// old `r <= rep` skip is subsumed by the assigned check).
// `shared` (when non-null, length R) accumulates per candidate the EXACT
// smin contribution of the walked blocks: sum_b min(acc[b], row_val[b]).
// With the unscanned-suffix mass S this yields a sound upper bound
// smin <= shared[r] + S that rejects most candidates without a dot.
void collect_candidates(InvertedIndex& idx, const int32_t* blocks,
                        int64_t n_blocks,
                        const std::vector<uint8_t>& assigned,
                        std::vector<int64_t>& stamp, int64_t marker,
                        int64_t rep, std::vector<int64_t>& out,
                        const std::vector<double>* acc = nullptr,
                        std::vector<double>* shared = nullptr) {
    (void)rep;
    for (int64_t i = 0; i < n_blocks; ++i) {
        const int64_t b = blocks[i];
        const double a = acc ? (*acc)[b] : 0.0;
        int64_t p = idx.ptr[b];
        int64_t end = idx.live[b];
        while (p < end) {
            const int64_t r = idx.rows[p];
            if (assigned[r]) {
                idx.rows[p] = idx.rows[end - 1];
                idx.rows[end - 1] = r;
                std::swap(idx.vals[p], idx.vals[end - 1]);
                --end;
                continue;
            }
            if (stamp[r] != marker) {
                stamp[r] = marker;
                out.push_back(r);
                if (shared) (*shared)[r] = 0.0;
            }
            if (shared) {
                const double v = idx.vals[p];
                (*shared)[r] += a < v ? a : v;
            }
            ++p;
        }
        idx.live[b] = end;
    }
}

}  // namespace

extern "C" {

// Greedy clustering with a static representative ("fast" strategy):
// the first unassigned row seeds a cluster; every later unassigned row
// whose similarity with the *seed* encoding exceeds alpha joins.
//
//   R          number of rows (in ascending-dispersion order)
//   indptr     (R+1) CSR offsets into indices/data_hat
//   indices    column-block ids per row entry
//   data_hat   L2-normalized encoding values per entry (float64)
//   l1_hat     (R) L1 norm of each normalized row
//   nblocks    encoding width (number of column blocks)
//   alpha      similarity threshold
//   cluster_out (R) cluster id per row position, 0-based
// Returns the number of clusters.
int64_t bsmr_cluster_fast(int64_t R, const int64_t* indptr,
                          const int32_t* indices, const double* data_hat,
                          const double* l1_hat, int64_t nblocks,
                          double alpha, int64_t* cluster_out) {
    InvertedIndex idx(R, indptr, indices, data_hat, nblocks);
    std::vector<uint8_t> assigned(R, 0);
    std::vector<int64_t> stamp(R, -1);
    std::vector<double> acc(nblocks, 0.0);
    std::vector<double> shared(R, 0.0);
    std::vector<int64_t> cand;
    std::vector<int64_t> blk_order;
    std::vector<int32_t> scan_blocks;
    std::vector<uint8_t> hit;
    // per-call stats; the parallel loop accumulates via an OpenMP
    // reduction (naked global += inside the loop was a data race)
    int64_t g_collected = 0, g_tested = 0, g_dotwork = 0;
    int64_t cid = 0;
    int64_t next = 0;
    while (next < R) {
        while (next < R && assigned[next]) ++next;
        if (next >= R) break;
        const int64_t rep = next;
        assigned[rep] = 1;
        cluster_out[rep] = cid;
        const int64_t rb = indptr[rep], re = indptr[rep + 1];
        for (int64_t i = rb; i < re; ++i) acc[indices[i]] = data_hat[i];
        const double acc_l1 = l1_hat[rep];
        // hub pruning: scan the rep's blocks heaviest-first and stop once
        // the remaining mass S cannot reach alpha for ANY row whose whole
        // shared support lies in the skipped suffix:
        //   smin <= S,  smax = l1a + l1r - smin >= l1a + 1 - S
        //   (l1_hat = l1/l2 >= 1 for every nonzero row)
        // so sim <= S / (l1a + 1 - S) <= alpha => skipping is exact.
        // This kills the H^2 candidate blowup of hub blocks in power-law
        // matrices: a hub carrying little of the rep's mass is never
        // walked.
        blk_order.clear();
        for (int64_t i = rb; i < re; ++i) blk_order.push_back(i);
        std::sort(blk_order.begin(), blk_order.end(),
                  [&](int64_t x, int64_t y) {
                      return data_hat[x] > data_hat[y];
                  });
        scan_blocks.clear();
        double suffix = acc_l1;
        for (const int64_t i : blk_order) {
            if (suffix <= alpha * (acc_l1 + 1.0 - suffix)) break;
            scan_blocks.push_back(indices[i]);
            suffix -= data_hat[i];
        }
        cand.clear();
        collect_candidates(idx, scan_blocks.data(),
                           static_cast<int64_t>(scan_blocks.size()),
                           assigned, stamp, rep, rep, cand,
                           &acc, &shared);
        const int64_t n_c = static_cast<int64_t>(cand.size());
        g_collected += n_c;
        hit.assign(n_c, 0);
#pragma omp parallel for schedule(dynamic, 256) if (n_c > 512) \
    reduction(+ : g_tested, g_dotwork)
        for (int64_t j = 0; j < n_c; ++j) {
            const int64_t r = cand[j];
            // sound upper bound from the walk: smin <= shared[r] + suffix
            // (shared = exact smin over scanned blocks; the candidate's
            // overlap with the rep's unscanned blocks is <= their mass)
            const double bound = shared[r] + suffix;
            const double den_lb = acc_l1 + l1_hat[r] - bound;
            if (den_lb <= 0.0 || bound / den_lb <= alpha) continue;
            if (suffix <= 0.0) {
                // every rep block was scanned: shared IS the exact smin
                const double smin = shared[r];
                const double smax = acc_l1 + l1_hat[r] - smin;
                hit[j] = (smax > 0.0 && smin / smax > alpha) ? 1 : 0;
                continue;
            }
            const int64_t b = indptr[r], e = indptr[r + 1];
            g_tested += 1;
            g_dotwork += e - b;
            double smin = 0.0;
            for (int64_t i = b; i < e; ++i) {
                const double a = acc[indices[i]];
                const double v = data_hat[i];
                smin += a < v ? a : v;
            }
            const double smax = acc_l1 + l1_hat[r] - smin;
            hit[j] = (smax > 0.0 && smin / smax > alpha) ? 1 : 0;
        }
        for (int64_t j = 0; j < n_c; ++j) {
            if (hit[j]) {
                assigned[cand[j]] = 1;
                cluster_out[cand[j]] = cid;
            }
        }
        for (int64_t i = rb; i < re; ++i) acc[indices[i]] = 0.0;
        ++cid;
    }
    if (std::getenv("BSMR_CLUSTER_STATS")) {
        std::fprintf(stderr,
                     "[cluster_fast] reps=%lld collected=%lld "
                     "band_tested=%lld dot_flops~=%lld\n",
                     (long long)cid, (long long)g_collected,
                     (long long)g_tested, (long long)g_dotwork);
    }
    return cid;
}

// Faithful accumulate-greedy clustering ("exact" strategy, the reference
// bsa_clustering semantics, rowReordering.cu:361-431): scan remaining rows
// in ascending order; a row joining the cluster adds its *raw* encoding
// into the representative accumulator (data_raw, rowReordering.cu:393-397),
// which is L2-renormalized per sweep; scanning continues after the join
// against the updated accumulator. Candidates come from the inverted
// index over the accumulator's (growing) support — rows outside it have
// sim == 0, so skipping them never changes a decision.
int64_t bsmr_cluster_exact(int64_t R, const int64_t* indptr,
                           const int32_t* indices, const double* data_raw,
                           const double* data_hat, const double* l1_hat,
                           int64_t nblocks, double alpha,
                           int64_t* cluster_out) {
    InvertedIndex idx(R, indptr, indices, nullptr, nblocks);
    std::vector<uint8_t> assigned(R, 0);
    std::vector<int64_t> stamp(R, -1);
    std::vector<double> acc(nblocks, 0.0);
    std::vector<int32_t> acc_support;     // nonzero blocks of acc
    std::vector<int64_t> cand;
    int64_t cid = 0;
    int64_t next = 0;
    while (next < R) {
        while (next < R && assigned[next]) ++next;
        if (next >= R) break;
        const int64_t rep = next;
        assigned[rep] = 1;
        cluster_out[rep] = cid;
        acc_support.clear();
        {
            const int64_t b = indptr[rep], e = indptr[rep + 1];
            for (int64_t i = b; i < e; ++i) {
                acc[indices[i]] = data_raw[i];
                acc_support.push_back(indices[i]);
            }
        }
        cand.clear();
        collect_candidates(idx, acc_support.data(),
                           static_cast<int64_t>(acc_support.size()),
                           assigned, stamp, rep, rep, cand);
        std::sort(cand.begin(), cand.end());
        int64_t scan_pos = 0;  // index into cand
        while (true) {
            // normalize acc over its support
            double l2sq = 0.0, l1 = 0.0;
            for (const int32_t b : acc_support) {
                l2sq += acc[b] * acc[b];
                l1 += acc[b];
            }
            const double inv_l2 =
                l2sq > 0.0 ? 1.0 / std::sqrt(l2sq) : 0.0;
            const double acc_l1 = l1 * inv_l2;
            const int64_t n_c = static_cast<int64_t>(cand.size());
            int64_t first_hit = -1;
#pragma omp parallel if (n_c - scan_pos > 512)
            {
                int64_t local_hit = -1;
#pragma omp for schedule(dynamic, 256)
                for (int64_t j = scan_pos; j < n_c; ++j) {
                    if (local_hit >= 0 && j > local_hit) continue;
                    const int64_t r = cand[j];
                    if (assigned[r]) continue;
                    const double lo =
                        acc_l1 < l1_hat[r] ? acc_l1 : l1_hat[r];
                    const double hi =
                        acc_l1 < l1_hat[r] ? l1_hat[r] : acc_l1;
                    if (hi <= 0.0 || lo / hi <= alpha) continue;
                    const int64_t b = indptr[r], e = indptr[r + 1];
                    double smin = 0.0;
                    for (int64_t i = b; i < e; ++i) {
                        const double a = acc[indices[i]] * inv_l2;
                        const double v = data_hat[i];
                        smin += a < v ? a : v;
                    }
                    const double smax = acc_l1 + l1_hat[r] - smin;
                    if (smax > 0.0 && smin / smax > alpha) local_hit = j;
                }
#pragma omp critical
                {
                    if (local_hit >= 0 &&
                        (first_hit < 0 || local_hit < first_hit))
                        first_hit = local_hit;
                }
            }
            if (first_hit < 0) break;
            const int64_t r = cand[first_hit];
            assigned[r] = 1;
            cluster_out[r] = cid;
            bool grew = false;
            const int64_t n_support_before =
                static_cast<int64_t>(acc_support.size());
            for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
                const int32_t b = indices[i];
                if (acc[b] == 0.0) {
                    acc_support.push_back(b);
                    grew = true;
                }
                acc[b] += data_raw[i];
            }
            scan_pos = first_hit + 1;
            if (grew) {
                // new support blocks can surface candidate rows that were
                // unreachable before: collect candidates of ONLY the new
                // blocks (stamp dedups against everything already in
                // cand), sort the appended tail, merge, and resume past
                // the joined row id (the spec never revisits rows at or
                // before the join position within a cluster)
                const size_t old_n = cand.size();
                collect_candidates(
                    idx, acc_support.data() + n_support_before,
                    static_cast<int64_t>(acc_support.size())
                        - n_support_before,
                    assigned, stamp, rep, rep, cand);
                if (cand.size() > old_n) {
                    std::sort(cand.begin() + old_n, cand.end());
                    std::inplace_merge(cand.begin(),
                                       cand.begin() + old_n, cand.end());
                    scan_pos = static_cast<int64_t>(
                        std::upper_bound(cand.begin(), cand.end(), r)
                        - cand.begin());
                }
            }
        }
        for (const int32_t b : acc_support) acc[b] = 0.0;
        ++cid;
    }
    return cid;
}

}  // extern "C"
