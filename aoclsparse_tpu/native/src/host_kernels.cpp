// Native host kernels for the planner's inherently sequential passes.
//
// The reference implements these in C++ inside the library proper
// (ILU0: solvers/aoclsparse_ilu0.hpp:37-112; the clean-CSR/level analysis
// lives in analysis/aoclsparse_csr_util.*). In this library the
// device executes wavefront-blocked solves, but the one-time factorization
// and dependency-level analysis are host planner work — implemented here in
// C++ with a numpy fallback in Python (aoclsparse_tpu/native/__init__.py).
//
// ABI: plain C, int64 indices, dtype-suffixed entry points (s/d/c/z), the
// same suffix convention as the reference's public API.

#include <algorithm>
#include <complex>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// ILU(0): in-place IKJ factorization over a sorted CSR pattern.
// Returns 0 on success; 1 = missing diagonal (err = row); 2 = zero pivot
// (err = row). lu[] holds A's values on entry, combined L\U on exit (unit L
// implied below the diagonal).
// ---------------------------------------------------------------------------

template <typename T>
static int ilu0_impl(int64_t m,
                     const int64_t *ptr,
                     const int64_t *ind,
                     T *lu,
                     int64_t *diag,
                     int64_t *err)
{
    // locate diagonals
    for (int64_t i = 0; i < m; ++i) {
        diag[i] = -1;
        for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) {
            if (ind[k] == i) { diag[i] = k; break; }
            if (ind[k] > i) break;
        }
        if (diag[i] < 0) { *err = i; return 1; }
    }
    // column -> offset scatter map for the active row
    std::vector<int64_t> pos((size_t)m, -1);
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) pos[(size_t)ind[k]] = k;
        for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) {
            const int64_t j = ind[k];
            if (j >= i) break;
            const T piv = lu[diag[j]];
            if (piv == T(0)) { *err = j; return 2; }
            const T lik = lu[k] / piv;
            lu[k] = lik;
            for (int64_t t = diag[j] + 1; t < ptr[j + 1]; ++t) {
                const int64_t p = pos[(size_t)ind[t]];
                if (p >= 0) lu[p] -= lik * lu[t];
            }
        }
        for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) pos[(size_t)ind[k]] = -1;
    }
    return 0;
}

extern "C" {

int ilu0_s(int64_t m, const int64_t *ptr, const int64_t *ind, float *lu,
           int64_t *diag, int64_t *err)
{ return ilu0_impl<float>(m, ptr, ind, lu, diag, err); }

int ilu0_d(int64_t m, const int64_t *ptr, const int64_t *ind, double *lu,
           int64_t *diag, int64_t *err)
{ return ilu0_impl<double>(m, ptr, ind, lu, diag, err); }

int ilu0_c(int64_t m, const int64_t *ptr, const int64_t *ind, void *lu,
           int64_t *diag, int64_t *err)
{ return ilu0_impl<std::complex<float>>(m, ptr, ind,
      reinterpret_cast<std::complex<float> *>(lu), diag, err); }

int ilu0_z(int64_t m, const int64_t *ptr, const int64_t *ind, void *lu,
           int64_t *diag, int64_t *err)
{ return ilu0_impl<std::complex<double>>(m, ptr, ind,
      reinterpret_cast<std::complex<double> *>(lu), diag, err); }

// ---------------------------------------------------------------------------
// Level scheduling: levels[i] = 1 + max(levels[j]) over strictly-lower
// dependencies of row i (the wavefront analysis the planner uses to size
// blocked sweeps; the reference has no analog — its TRSV is sequential,
// SURVEY.md §3.3). Returns the number of levels.
// ---------------------------------------------------------------------------

int64_t level_schedule(int64_t m,
                       const int64_t *ptr,
                       const int64_t *ind,
                       int64_t *levels)
{
    int64_t nlev = 0;
    for (int64_t i = 0; i < m; ++i) {
        int64_t lv = 0;
        for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) {
            const int64_t j = ind[k];
            if (j >= i) break;
            const int64_t cand = levels[j] + 1;
            if (cand > lv) lv = cand;
        }
        levels[i] = lv;
        if (lv + 1 > nlev) nlev = lv + 1;
    }
    return nlev;
}

// ---------------------------------------------------------------------------
// Gustavson symbolic row-counts (upper bound pass used to presize product
// expansion; the analog of the reference's nnz_count stage dense-marker scan,
// level3/aoclsparse_csr2m.cpp:89-200).
// ---------------------------------------------------------------------------

int64_t spgemm_nnz(int64_t mA,
                   int64_t nB,
                   const int64_t *Aptr,
                   const int64_t *Aind,
                   const int64_t *Bptr,
                   const int64_t *Bind,
                   int64_t *Cptr /* mA+1, out */)
{
    std::vector<int64_t> marker((size_t)nB, -1);
    int64_t total = 0;
    Cptr[0] = 0;
    for (int64_t i = 0; i < mA; ++i) {
        int64_t cnt = 0;
        for (int64_t k = Aptr[i]; k < Aptr[i + 1]; ++k) {
            const int64_t kk = Aind[k];
            for (int64_t t = Bptr[kk]; t < Bptr[kk + 1]; ++t) {
                const int64_t j = Bind[t];
                if (marker[(size_t)j] != i) { marker[(size_t)j] = i; ++cnt; }
            }
        }
        total += cnt;
        Cptr[i + 1] = total;
    }
    return total;
}

// ---------------------------------------------------------------------------
// Full Gustavson product expansion with per-row sorted merge: emits the
// product triples (pa, pb, pc) ordered by (row, col) plus C's structure in
// one pass — the symbolic stage of the product-expansion SpGEMM
// (ops/level3/spgemm.py). ~100x the numpy sort path.
// Buffers: pa/pb/pc sized P (total products, precomputed by caller);
// Cind capacity P. Returns nnzC.
// ---------------------------------------------------------------------------

// Expand a contiguous row range [i0, i1) writing at precomputed offsets:
// Cptr/Pptr already hold the global prefix sums, so ranges are disjoint
// and the fill parallelizes (the reference's static OpenMP row split,
// level3/aoclsparse_csr2m.cpp:89-101, as std::thread ranges).
static void expand_rows(int64_t i0,
                        int64_t i1,
                        const int64_t *Aptr,
                        const int64_t *Aind,
                        const int64_t *Bptr,
                        const int64_t *Bind,
                        int32_t *pa,
                        int32_t *pb,
                        int32_t *pc,
                        const int64_t *Cptr,
                        const int64_t *Pptr,
                        int32_t *Cind,
                        uint8_t upper_only)
{
    std::vector<int64_t> marker;  // col -> absolute slot; grown on demand
    marker.assign((size_t)1, -1);
    std::vector<std::pair<int64_t, int64_t>> row_cols;  // (col, local slot)
    std::vector<int64_t> rank;                           // local slot -> rank
    std::vector<int64_t> cnt;                            // products per local slot
    std::vector<int64_t> off;                            // write offset per local slot
    struct Prod { int32_t a, b, slot; };
    std::vector<Prod> scratch;                           // row's products
    for (int64_t i = i0; i < i1; ++i) {
        const int64_t row_c0 = Cptr[i];
        const int64_t row_p0 = Pptr[i];
        int64_t c_out = row_c0;
        row_cols.clear();
        scratch.clear();
        for (int64_t k = Aptr[i]; k < Aptr[i + 1]; ++k) {
            const int64_t kk = Aind[k];
            for (int64_t t = Bptr[kk]; t < Bptr[kk + 1]; ++t) {
                const int64_t j = Bind[t];
                if (upper_only && j < i) continue;
                if (j >= (int64_t)marker.size())
                    marker.resize(std::max((size_t)j + 1, marker.size() * 2), -1);
                int64_t slot = marker[(size_t)j];
                if (slot < row_c0) {  // not seen this row (stale markers are
                    slot = c_out++;   //  below row_c0: freshness by offset)
                    marker[(size_t)j] = slot;
                    row_cols.push_back({j, slot - row_c0});
                    cnt.push_back(0);
                }
                const int64_t ls = slot - row_c0;
                ++cnt[(size_t)ls];
                scratch.push_back({(int32_t)k, (int32_t)t, (int32_t)ls});
            }
        }
        // order the row's columns; local slot -> sorted rank
        std::sort(row_cols.begin(), row_cols.end());
        const int64_t ncols = c_out - row_c0;
        rank.assign((size_t)ncols, 0);
        for (int64_t r = 0; r < ncols; ++r) {
            Cind[row_c0 + r] = (int32_t)row_cols[(size_t)r].first;
            rank[(size_t)row_cols[(size_t)r].second] = r;
        }
        // counting-sort placement: offsets in rank order
        off.assign((size_t)ncols, 0);
        int64_t acc = 0;
        for (int64_t r = 0; r < ncols; ++r) {
            const int64_t ls = row_cols[(size_t)r].second;
            off[(size_t)ls] = acc;
            acc += cnt[(size_t)ls];
        }
        for (const Prod &pr : scratch) {
            const int64_t pos = row_p0 + off[(size_t)pr.slot]++;
            pa[pos] = pr.a;
            pb[pos] = pr.b;
            pc[pos] = (int32_t)(row_c0 + rank[(size_t)pr.slot]);
        }
        cnt.clear();
    }
}

// Count pass for a row range: per-row distinct columns (-> Cptr[i+1]) and
// per-row kept products (-> Pcnt[i]).
static void count_rows(int64_t i0,
                       int64_t i1,
                       const int64_t *Aptr,
                       const int64_t *Aind,
                       const int64_t *Bptr,
                       const int64_t *Bind,
                       int64_t *Crow,
                       int64_t *Pcnt,
                       uint8_t upper_only)
{
    std::vector<int64_t> marker;
    marker.assign((size_t)1, -1);
    for (int64_t i = i0; i < i1; ++i) {
        int64_t nc = 0, np = 0;
        for (int64_t k = Aptr[i]; k < Aptr[i + 1]; ++k) {
            const int64_t kk = Aind[k];
            for (int64_t t = Bptr[kk]; t < Bptr[kk + 1]; ++t) {
                const int64_t j = Bind[t];
                if (upper_only && j < i) continue;
                if (j >= (int64_t)marker.size())
                    marker.resize(std::max((size_t)j + 1, marker.size() * 2), -1);
                if (marker[(size_t)j] != i) { marker[(size_t)j] = i; ++nc; }
                ++np;
            }
        }
        Crow[i] = nc;
        Pcnt[i] = np;
    }
}

static int expand_threads()
{
    if (const char *env = std::getenv("AOCLSPARSE_NUM_THREADS")) {
        const long v = std::atol(env);
        if (v >= 1) return (int)std::min<long>(v, 64);
    }
    const unsigned hw = std::thread::hardware_concurrency();
    return hw ? (int)std::min(hw, 8u) : 1;
}

int64_t spgemm_expand(int64_t mA,
                                 const int64_t *Aptr,
                                 const int64_t *Aind,
                                 const int64_t *Bptr,
                                 const int64_t *Bind,
                                 int32_t *pa,
                                 int32_t *pb,
                                 int32_t *pc,
                                 int64_t *Cptr,
                                 int32_t *Cind,
                                 uint8_t upper_only,
                                 int64_t *p_count_out)
{
    // Marker-based, no comparison sort over the P products (only the nnzC
    // output columns sort per row; typically P >> nnzC):
    //   count pass (parallel row ranges): per-row distinct-column and
    //           product counts -> serial prefix sums give every row its
    //           global write offsets,
    //   fill pass (parallel, ranges balanced by product count): per row,
    //           dense marker assigns slots in first-seen order, the row's
    //           (col, slot) pairs sort -> rank permutation, counting-sort
    //           placement writes products at (row, col)-ordered positions,
    //           so pc comes out non-decreasing (the device numeric stage's
    //           sorted segment-sum requires it).
    // This is the Gustavson marker scan of the reference's symbolic stage
    // (level3/aoclsparse_csr2m.cpp:89-200) extended to also emit the
    // product triples the device numeric stage consumes, with the
    // reference's OpenMP row split rebuilt on std::thread.
    std::vector<int64_t> Pptr((size_t)mA + 1, 0);
    int64_t *Crow = Cptr + 1;  // stash per-row counts where prefixes land
    const int nt_req = expand_threads();
    const int64_t rows_per_min = 2048;
    int nt = (int)std::min<int64_t>(nt_req, std::max<int64_t>(mA / rows_per_min, 1));
    if (nt <= 1) {
        count_rows(0, mA, Aptr, Aind, Bptr, Bind, Crow, Pptr.data() + 1, upper_only);
    } else {
        std::vector<std::thread> ths;
        for (int tix = 0; tix < nt; ++tix) {
            const int64_t i0 = mA * tix / nt, i1 = mA * (tix + 1) / nt;
            ths.emplace_back(count_rows, i0, i1, Aptr, Aind, Bptr, Bind,
                             Crow, Pptr.data() + 1, upper_only);
        }
        for (auto &t : ths) t.join();
    }
    Cptr[0] = 0;
    for (int64_t i = 0; i < mA; ++i) {
        Cptr[i + 1] += Cptr[i];
        Pptr[(size_t)i + 1] += Pptr[(size_t)i];
    }
    const int64_t p_out = Pptr[(size_t)mA];
    const int64_t c_out = Cptr[mA];
    if (nt <= 1) {
        expand_rows(0, mA, Aptr, Aind, Bptr, Bind, pa, pb, pc,
                    Cptr, Pptr.data(), Cind, upper_only);
    } else {
        // balance fill ranges by product count (power-law rows skew badly
        // under an even row split)
        std::vector<std::thread> ths;
        int64_t i0 = 0;
        for (int tix = 0; tix < nt; ++tix) {
            const int64_t target = p_out * (tix + 1) / nt;
            int64_t i1 = (tix == nt - 1)
                ? mA
                : (std::lower_bound(Pptr.begin() + i0, Pptr.end(), target)
                   - Pptr.begin());
            if (i1 < i0) i1 = i0;
            ths.emplace_back(expand_rows, i0, i1, Aptr, Aind, Bptr, Bind,
                             pa, pb, pc, Cptr, Pptr.data(), Cind, upper_only);
            i0 = i1;
        }
        for (auto &t : ths) t.join();
    }
    *p_count_out = p_out;
    return c_out;
}

static void pattern_rows(int64_t i0,
                         int64_t i1,
                         const int64_t *Aptr,
                         const int64_t *Aind,
                         const int64_t *Bptr,
                         const int64_t *Bind,
                         const int64_t *Cptr,
                         int32_t *Cind)
{
    std::vector<int64_t> marker;
    marker.assign((size_t)1, -1);
    for (int64_t i = i0; i < i1; ++i) {
        int64_t w = Cptr[i];
        for (int64_t k = Aptr[i]; k < Aptr[i + 1]; ++k) {
            const int64_t kk = Aind[k];
            for (int64_t t = Bptr[kk]; t < Bptr[kk + 1]; ++t) {
                const int64_t j = Bind[t];
                if (j >= (int64_t)marker.size())
                    marker.resize(std::max((size_t)j + 1, marker.size() * 2), -1);
                if (marker[(size_t)j] != i) {
                    marker[(size_t)j] = i;
                    Cind[w++] = (int32_t)j;
                }
            }
        }
        std::sort(Cind + Cptr[i], Cind + w);
    }
}

extern "C" {

// Pattern-only symbolic stage: C's (Cptr, Cind) WITHOUT materializing the
// O(P) product-expansion triples. The band numeric engine only needs C's
// pattern for its extraction map — at FEM-scale products (cant A@A: 285M)
// the expansion triples are ~7 GB of host memory plus a device upload the
// band engine never reads (measured 72 s end-to-end, round-4 real-matrix
// sweep). Same marker scan as the reference's symbolic Gustavson
// (level3/aoclsparse_csr2m.cpp:89-200), pattern emission only. Two calls:
// count (fills the Cptr/Pptr prefixes, returns nnzC so the caller can
// allocate Cind) then fill (threads balanced by product count via Pptr).
int64_t spgemm_pattern_count(int64_t mA,
                             const int64_t *Aptr,
                             const int64_t *Aind,
                             const int64_t *Bptr,
                             const int64_t *Bind,
                             int64_t *Cptr,
                             int64_t *Pptr)
{
    int64_t *Crow = Cptr + 1;
    const int nt_req = expand_threads();
    const int64_t rows_per_min = 2048;
    int nt = (int)std::min<int64_t>(nt_req, std::max<int64_t>(mA / rows_per_min, 1));
    if (nt <= 1) {
        count_rows(0, mA, Aptr, Aind, Bptr, Bind, Crow, Pptr + 1, 0);
    } else {
        std::vector<std::thread> ths;
        for (int tix = 0; tix < nt; ++tix) {
            const int64_t i0 = mA * tix / nt, i1 = mA * (tix + 1) / nt;
            ths.emplace_back(count_rows, i0, i1, Aptr, Aind, Bptr, Bind,
                             Crow, Pptr + 1, (uint8_t)0);
        }
        for (auto &t : ths) t.join();
    }
    Cptr[0] = 0;
    Pptr[0] = 0;
    for (int64_t i = 0; i < mA; ++i) {
        Cptr[i + 1] += Cptr[i];
        Pptr[i + 1] += Pptr[i];
    }
    return Cptr[mA];
}

void spgemm_pattern_fill(int64_t mA,
                         const int64_t *Aptr,
                         const int64_t *Aind,
                         const int64_t *Bptr,
                         const int64_t *Bind,
                         const int64_t *Cptr,
                         const int64_t *Pptr,
                         int32_t *Cind)
{
    const int64_t p_out = Pptr[mA];
    const int nt_req = expand_threads();
    const int64_t rows_per_min = 2048;
    int nt = (int)std::min<int64_t>(nt_req, std::max<int64_t>(mA / rows_per_min, 1));
    if (nt <= 1) {
        pattern_rows(0, mA, Aptr, Aind, Bptr, Bind, Cptr, Cind);
        return;
    }
    std::vector<std::thread> ths;
    int64_t i0 = 0;
    for (int tix = 0; tix < nt; ++tix) {
        const int64_t target = p_out * (tix + 1) / nt;
        int64_t i1 = (tix == nt - 1)
            ? mA
            : (std::lower_bound(Pptr + i0, Pptr + mA + 1, target) - Pptr);
        if (i1 < i0) i1 = i0;
        if (i1 > mA) i1 = mA;
        ths.emplace_back(pattern_rows, i0, i1, Aptr, Aind, Bptr, Bind,
                         Cptr, Cind);
        i0 = i1;
    }
    for (auto &t : ths) t.join();
}

} // extern "C"

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering on the symmetrized pattern of A.
// Bandwidth reduction is the planner's lever for making general matrices
// band-compressible (the banded-window execution forms): the reference
// never needs this (its gather-based kernels are structure-agnostic on
// x86), so this is a new analysis.
// perm[k] = original index of the row placed at position k.
// Returns the post-permutation half bandwidth (max |perm^-1[i]-perm^-1[j]|).
// ---------------------------------------------------------------------------

int64_t rcm(int64_t m,
            const int64_t *ptr,
            const int64_t *ind,
            int64_t *perm)
{
    // build symmetrized adjacency (A + A^T, self-loops dropped, dedup)
    std::vector<int64_t> deg((size_t)m, 0);
    const int64_t nnz = ptr[m];
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) {
            const int64_t j = ind[k];
            if (j == i || j >= m) continue;
            ++deg[(size_t)i];
            ++deg[(size_t)j];
        }
    }
    std::vector<int64_t> aptr((size_t)m + 1, 0);
    for (int64_t i = 0; i < m; ++i) aptr[(size_t)i + 1] = aptr[(size_t)i] + deg[(size_t)i];
    std::vector<int64_t> adj((size_t)aptr[(size_t)m]);
    std::vector<int64_t> fill((size_t)m, 0);
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) {
            const int64_t j = ind[k];
            if (j == i || j >= m) continue;
            adj[(size_t)(aptr[(size_t)i] + fill[(size_t)i]++)] = j;
            adj[(size_t)(aptr[(size_t)j] + fill[(size_t)j]++)] = i;
        }
    }
    // dedup + degree-sort each adjacency row (CM wants ascending degree)
    for (int64_t i = 0; i < m; ++i) {
        auto b = adj.begin() + aptr[(size_t)i];
        auto e = adj.begin() + aptr[(size_t)i] + fill[(size_t)i];
        std::sort(b, e);
        auto ne = std::unique(b, e);
        fill[(size_t)i] = ne - b;
    }
    for (int64_t i = 0; i < m; ++i) deg[(size_t)i] = fill[(size_t)i];
    for (int64_t i = 0; i < m; ++i) {
        auto b = adj.begin() + aptr[(size_t)i];
        auto e = b + fill[(size_t)i];
        std::sort(b, e, [&](int64_t x, int64_t y) {
            return deg[(size_t)x] != deg[(size_t)y] ? deg[(size_t)x] < deg[(size_t)y]
                                                    : x < y;
        });
    }

    std::vector<uint8_t> visited((size_t)m, 0);
    std::vector<int64_t> order;
    order.reserve((size_t)m);
    std::vector<int64_t> queue;
    queue.reserve((size_t)m);
    std::vector<int64_t> level((size_t)m, 0);

    // one BFS pass from s; returns index (into q) of start of last level
    auto bfs = [&](int64_t s, std::vector<int64_t> &q) -> size_t {
        q.clear();
        q.push_back(s);
        std::vector<uint8_t> seen((size_t)m, 0);
        seen[(size_t)s] = 1;
        level[(size_t)s] = 0;
        size_t head = 0, last_lvl_start = 0;
        int64_t cur_lvl = 0;
        while (head < q.size()) {
            const int64_t u = q[head++];
            if (level[(size_t)u] != cur_lvl) {
                cur_lvl = level[(size_t)u];
                last_lvl_start = head - 1;
            }
            for (int64_t k = aptr[(size_t)u]; k < aptr[(size_t)u] + fill[(size_t)u]; ++k) {
                const int64_t v = adj[(size_t)k];
                if (!seen[(size_t)v] && !visited[(size_t)v]) {
                    seen[(size_t)v] = 1;
                    level[(size_t)v] = level[(size_t)u] + 1;
                    q.push_back(v);
                }
            }
        }
        return last_lvl_start;
    };

    for (int64_t seed = 0; seed < m; ++seed) {
        if (visited[(size_t)seed]) continue;
        // component start: min-degree node reachable check via BFS growth
        int64_t s = seed;
        // George-Liu pseudo-peripheral: iterate "farthest min-degree" twice
        size_t last_start = bfs(s, queue);
        for (int rep = 0; rep < 2; ++rep) {
            int64_t best = queue[last_start];
            for (size_t t = last_start; t < queue.size(); ++t)
                if (deg[(size_t)queue[t]] < deg[(size_t)best]) best = queue[t];
            if (best == s) break;
            s = best;
            last_start = bfs(s, queue);
        }
        // Cuthill-McKee order = the BFS order (neighbors pre-sorted by degree)
        for (const int64_t u : queue) {
            visited[(size_t)u] = 1;
            order.push_back(u);
        }
    }
    // reverse
    for (int64_t i = 0; i < m; ++i) perm[i] = order[(size_t)(m - 1 - i)];
    // post-permutation half bandwidth
    std::vector<int64_t> ip((size_t)m);
    for (int64_t i = 0; i < m; ++i) ip[(size_t)perm[i]] = i;
    int64_t bw = 0;
    for (int64_t i = 0; i < m; ++i)
        for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) {
            if (ind[k] >= m) continue;
            const int64_t d = ip[(size_t)i] - ip[(size_t)ind[k]];
            const int64_t ad = d < 0 ? -d : d;
            if (ad > bw) bw = ad;
        }
    (void)nnz;
    return bw;
}

// ---------------------------------------------------------------------------
// BLKCSR greedy block scan (reference conversion/aoclsparse_convert.cpp:36-290):
// rows are grouped nrowsblk at a time; each block covers 8 columns starting at
// the minimum unconsumed column across the group's subrows; at the right edge
// the block start clamps to n-8 (masks shift accordingly). blkcsr_count is the
// counting pass opt_blksize runs per candidate size; blkcsr_build additionally
// emits blk_row_ptr / blk_col_ind / per-subrow masks and a value permutation
// (output slot -> CSR source index) so Python can place values of any dtype.
// ---------------------------------------------------------------------------

int64_t blkcsr_count(int64_t m, int64_t n,
                     const int64_t *ptr, const int64_t *ind,
                     int64_t nrowsblk)
{
    const int64_t W = 8;
    int64_t total = 0;
    std::vector<int64_t> cur((size_t)nrowsblk, 0);
    for (int64_t r0 = 0; r0 < m; r0 += nrowsblk) {
        const int64_t nr = std::min(nrowsblk, m - r0);
        for (int64_t s = 0; s < nr; ++s) cur[(size_t)s] = ptr[r0 + s];
        while (true) {
            int64_t c0 = INT64_MAX;
            for (int64_t s = 0; s < nr; ++s)
                if (cur[(size_t)s] < ptr[r0 + s + 1])
                    c0 = std::min(c0, ind[cur[(size_t)s]]);
            if (c0 == INT64_MAX) break;
            for (int64_t s = 0; s < nr; ++s)
                while (cur[(size_t)s] < ptr[r0 + s + 1] &&
                       ind[cur[(size_t)s]] < c0 + W)
                    ++cur[(size_t)s];
            ++total;
        }
    }
    return total;
}

int64_t blkcsr_build(int64_t m, int64_t n,
                     const int64_t *ptr, const int64_t *ind,
                     int64_t nrowsblk,
                     int64_t *brow_ptr /* m+1 */,
                     int64_t *bcol /* nblks */,
                     uint8_t *masks /* nblks*nrowsblk */,
                     int64_t *perm /* nnz */)
{
    const int64_t W = 8;
    int64_t nblk = 0, nval = 0;
    std::vector<int64_t> cur((size_t)nrowsblk, 0);
    for (int64_t r0 = 0; r0 < m; r0 += nrowsblk) {
        const int64_t nr = std::min(nrowsblk, m - r0);
        const int64_t blk0 = nblk;
        for (int64_t s = 0; s < nr; ++s) cur[(size_t)s] = ptr[r0 + s];
        while (true) {
            int64_t c0 = INT64_MAX;
            for (int64_t s = 0; s < nr; ++s)
                if (cur[(size_t)s] < ptr[r0 + s + 1])
                    c0 = std::min(c0, ind[cur[(size_t)s]]);
            if (c0 == INT64_MAX) break;
            const bool edge = (c0 + W > n);
            const int64_t cstart = edge ? n - W : c0;
            bcol[nblk] = cstart;
            for (int64_t s = 0; s < nrowsblk; ++s) {
                uint8_t msk = 0;
                if (s < nr) {
                    while (cur[(size_t)s] < ptr[r0 + s + 1] &&
                           ind[cur[(size_t)s]] < c0 + W) {
                        msk |= (uint8_t)(1u << (ind[cur[(size_t)s]] - cstart));
                        perm[nval++] = cur[(size_t)s];
                        ++cur[(size_t)s];
                    }
                }
                masks[nblk * nrowsblk + s] = msk;
            }
            ++nblk;
        }
        // reference row-pointer layout: first subrow of the group stores the
        // group's start offset, the remaining subrows store the end
        brow_ptr[r0] = blk0;
        for (int64_t s = 1; s < nr; ++s) brow_ptr[r0 + s] = nblk;
    }
    brow_ptr[m] = nblk;
    return nval;
}

} // extern "C"

// ---------------------------------------------------------------------------
// SpGEMM host numeric: Cval[pc[p]] += Aval[pa[p]] * Bval[pb[p]] over the
// symbolic stage's sorted product triples — the reference's numeric
// Gustavson pass (level3/aoclsparse_csr2m.cpp:405-545) on the expansion
// plan. pc is NON-DECREASING (spgemm_expand guarantees it), so threads own
// disjoint OUTPUT ranges found by binary search: race-free, no atomics.
// Complex dtypes pass through as interleaved (re, im) pairs.
// ---------------------------------------------------------------------------

template <typename T>
static void spgemm_numeric_body(int64_t P,
                                const int32_t *pa,
                                const int32_t *pb,
                                const int32_t *pc,
                                const T *av,
                                const T *bv,
                                T *cv,
                                int64_t nnzC)
{
    for (int64_t i = 0; i < nnzC; ++i) cv[i] = T(0);
    const int nt_req = expand_threads();
    const int nt = (int)std::min<int64_t>(nt_req, std::max<int64_t>(nnzC, 1));
    if (nt <= 1 || P < (1 << 16)) {
        for (int64_t p = 0; p < P; ++p)
            cv[pc[p]] += av[pa[p]] * bv[pb[p]];
        return;
    }
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) {
        const int64_t c_lo = nnzC * t / nt;
        const int64_t c_hi = nnzC * (t + 1) / nt;
        ths.emplace_back([=]() {
            // products for outputs [c_lo, c_hi): binary search on sorted pc
            const int32_t *beg = std::lower_bound(pc, pc + P, (int32_t)c_lo);
            const int32_t *end = std::lower_bound(pc, pc + P, (int32_t)c_hi);
            for (const int32_t *q = beg; q != end; ++q) {
                const int64_t p = q - pc;
                cv[*q] += av[pa[p]] * bv[pb[p]];
            }
        });
    }
    for (auto &th : ths) th.join();
}

extern "C" {

void spgemm_numeric_s(int64_t P, const int32_t *pa, const int32_t *pb,
                      const int32_t *pc, const float *av, const float *bv,
                      float *cv, int64_t nnzC)
{
    spgemm_numeric_body<float>(P, pa, pb, pc, av, bv, cv, nnzC);
}

void spgemm_numeric_d(int64_t P, const int32_t *pa, const int32_t *pb,
                      const int32_t *pc, const double *av, const double *bv,
                      double *cv, int64_t nnzC)
{
    spgemm_numeric_body<double>(P, pa, pb, pc, av, bv, cv, nnzC);
}

void spgemm_numeric_c(int64_t P, const int32_t *pa, const int32_t *pb,
                      const int32_t *pc, const void *av, const void *bv,
                      void *cv, int64_t nnzC)
{
    spgemm_numeric_body<std::complex<float>>(
        P, pa, pb, pc, (const std::complex<float> *)av,
        (const std::complex<float> *)bv, (std::complex<float> *)cv, nnzC);
}

void spgemm_numeric_z(int64_t P, const int32_t *pa, const int32_t *pb,
                      const int32_t *pc, const void *av, const void *bv,
                      void *cv, int64_t nnzC)
{
    spgemm_numeric_body<std::complex<double>>(
        P, pa, pb, pc, (const std::complex<double> *)av,
        (const std::complex<double> *)bv, (std::complex<double> *)cv, nnzC);
}

} // extern "C"

// ---------------------------------------------------------------------------
// Sequential triangular solve over a host CSR triangle (the host engine for
// latency-bound small solves; see ops/level2/trsv.py KID 2). Serves the
// same role as the reference's scalar substitution (its TRSV is host
// sequential by construction, level2/aoclsparse_trsv_kr.hpp); independently
// written: operates on the planner's EFFECTIVE triangle (diagonal entries
// always materialized, unit diag folded as constant 1s upstream), direction
// chosen by the caller, IEEE division on zero pivots (no error protocol —
// parity with the device forms' behavior).
// ---------------------------------------------------------------------------

template <typename T>
static void trsv_seq_impl(int64_t m,
                          const int64_t *ptr,
                          const int64_t *ind,
                          const T *val,
                          const T *b,
                          T *x,
                          int lower)
{
    if (lower) {
        for (int64_t i = 0; i < m; ++i) {
            T s = T(0);
            T d = T(0);
            for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k) {
                const int64_t j = ind[k];
                if (j < i)
                    s += val[k] * x[j];
                else if (j == i)
                    d = val[k];
            }
            x[i] = (b[i] - s) / d;
        }
    } else {
        for (int64_t i = m - 1; i >= 0; --i) {
            T s = T(0);
            T d = T(0);
            for (int64_t k = ptr[i + 1] - 1; k >= ptr[i]; --k) {
                const int64_t j = ind[k];
                if (j > i)
                    s += val[k] * x[j];
                else if (j == i)
                    d = val[k];
            }
            x[i] = (b[i] - s) / d;
        }
    }
}

extern "C" {

void trsv_seq_s(int64_t m, const int64_t *ptr, const int64_t *ind,
                const float *val, const float *b, float *x, int lower)
{ trsv_seq_impl<float>(m, ptr, ind, val, b, x, lower); }

void trsv_seq_d(int64_t m, const int64_t *ptr, const int64_t *ind,
                const double *val, const double *b, double *x, int lower)
{ trsv_seq_impl<double>(m, ptr, ind, val, b, x, lower); }

void trsv_seq_c(int64_t m, const int64_t *ptr, const int64_t *ind,
                const void *val, const void *b, void *x, int lower)
{
    trsv_seq_impl<std::complex<float>>(m, ptr, ind,
                                       (const std::complex<float> *)val,
                                       (const std::complex<float> *)b,
                                       (std::complex<float> *)x, lower);
}

void trsv_seq_z(int64_t m, const int64_t *ptr, const int64_t *ind,
                const void *val, const void *b, void *x, int lower)
{
    trsv_seq_impl<std::complex<double>>(m, ptr, ind,
                                        (const std::complex<double> *)val,
                                        (const std::complex<double> *)b,
                                        (std::complex<double> *)x, lower);
}

} // extern "C"

// ---------------------------------------------------------------------------
// Multi-RHS sequential solve (the host TRSM engine, ops/level3/trsm.py
// KID 2): k independent substitutions over the same triangle, threaded
// across RHS columns exactly like the reference's OpenMP column split
// (level3/aoclsparse_trsm.hpp:149 — parallel for over k). Layout is
// (k, m) RHS-major so each solve sweeps a contiguous vector.
// ---------------------------------------------------------------------------

template <typename T>
static void trsm_seq_impl(int64_t m, int64_t k,
                          const int64_t *ptr,
                          const int64_t *ind,
                          const T *val,
                          const T *b,
                          T *x,
                          int lower)
{
    const unsigned hw = std::thread::hardware_concurrency();
    const int64_t nthr =
        (k >= 4 && hw > 1) ? std::min<int64_t>(k, (int64_t)hw) : 1;
    if (nthr <= 1) {
        for (int64_t r = 0; r < k; ++r)
            trsv_seq_impl<T>(m, ptr, ind, val, b + r * m, x + r * m, lower);
        return;
    }
    std::vector<std::thread> ts;
    ts.reserve((size_t)nthr);
    for (int64_t t = 0; t < nthr; ++t) {
        const int64_t lo = k * t / nthr, hi = k * (t + 1) / nthr;
        ts.emplace_back([=]() {
            for (int64_t r = lo; r < hi; ++r)
                trsv_seq_impl<T>(m, ptr, ind, val, b + r * m, x + r * m, lower);
        });
    }
    for (auto &t : ts)
        t.join();
}

extern "C" {

void trsm_seq_s(int64_t m, int64_t k, const int64_t *ptr, const int64_t *ind,
                const float *val, const float *b, float *x, int lower)
{ trsm_seq_impl<float>(m, k, ptr, ind, val, b, x, lower); }

void trsm_seq_d(int64_t m, int64_t k, const int64_t *ptr, const int64_t *ind,
                const double *val, const double *b, double *x, int lower)
{ trsm_seq_impl<double>(m, k, ptr, ind, val, b, x, lower); }

void trsm_seq_c(int64_t m, int64_t k, const int64_t *ptr, const int64_t *ind,
                const void *val, const void *b, void *x, int lower)
{
    trsm_seq_impl<std::complex<float>>(m, k, ptr, ind,
                                       (const std::complex<float> *)val,
                                       (const std::complex<float> *)b,
                                       (std::complex<float> *)x, lower);
}

void trsm_seq_z(int64_t m, int64_t k, const int64_t *ptr, const int64_t *ind,
                const void *val, const void *b, void *x, int lower)
{
    trsm_seq_impl<std::complex<double>>(m, k, ptr, ind,
                                        (const std::complex<double> *)val,
                                        (const std::complex<double> *)b,
                                        (std::complex<double> *)x, lower);
}

} // extern "C"

// ---------------------------------------------------------------------------
// Blocked-window TRSV form builder (planner/triangular.py build_trsv_form's
// hot path in C++). The Python/numpy build costs seconds at 16.7M nnz on
// this throttled host — per-row slice iteration over the CLEAN structure
// (triangle = per-row [lo, hi) given by the caller from idiag/iurow, so no
// extracted triangle arrays are ever materialized), optional index
// reversal (upper -> lower), one analyze pass for the window width and
// entry counts, one fill pass writing the dense diagonal blocks, the left
// window, and the refresh scatter maps. Reference role: the analysis-time
// working copies of aoclsparse_analysis.cpp / csr_util.hpp, rearchitected
// for the blocked device solve.
// ---------------------------------------------------------------------------

static int64_t win_nthreads(int64_t m)
{
    const unsigned hw = std::thread::hardware_concurrency();
    if (m < 65536 || hw <= 1) return 1;
    return (int64_t)hw;
}

extern "C" {

// Pass 1: WL_need (max reach of left-of-block entries) plus PER-ROW prefix
// sums of the left/diag entry counts (prefL/prefD, length m+1) so the fill
// pass can run threaded with deterministic map order. Threaded over row
// chunks (the Python/numpy twin of this pass cost seconds at 16.7M nnz).
void trsv_win_analyze(int64_t m, const int64_t *lo, const int64_t *hi,
                      const int32_t *ind, int64_t nb, int reversed,
                      int64_t *prefL, int64_t *prefD, int64_t *wl_out)
{
    const int64_t nthr = win_nthreads(m);
    std::vector<int64_t> wls((size_t)nthr, 0);
    std::vector<std::thread> ts;
    ts.reserve((size_t)nthr);
    for (int64_t t = 0; t < nthr; ++t) {
        const int64_t r0 = m * t / nthr, r1 = m * (t + 1) / nthr;
        ts.emplace_back([=, &wls]() {
            int64_t wl = 0;
            for (int64_t r = r0; r < r1; ++r) {
                const int64_t rp = reversed ? (m - 1 - r) : r;
                const int64_t blk0 = (rp / nb) * nb;
                int64_t nl = 0, nd = 0;
                for (int64_t k = lo[r]; k < hi[r]; ++k) {
                    const int64_t cp =
                        reversed ? (m - 1 - (int64_t)ind[k]) : (int64_t)ind[k];
                    if (cp < blk0) {
                        ++nl;
                        const int64_t need = blk0 - cp;
                        if (need > wl) wl = need;
                    } else {
                        ++nd;
                    }
                }
                prefL[r + 1] = nl;
                prefD[r + 1] = nd;
            }
            wls[(size_t)t] = wl;
        });
    }
    for (auto &th : ts) th.join();
    int64_t wl = 0;
    for (auto w : wls) wl = std::max(wl, w);
    prefL[0] = 0;
    prefD[0] = 0;
    for (int64_t r = 0; r < m; ++r) {
        prefL[r + 1] += prefL[r];
        prefD[r + 1] += prefD[r];
    }
    *wl_out = wl;
}

} // extern "C"

template <typename T>
static void trsv_win_fill_impl(int64_t m, const int64_t *lo, const int64_t *hi,
                               const int32_t *ind, const T *vals, int64_t nb,
                               int reversed, int64_t WL,
                               const int64_t *prefL, const int64_t *prefD,
                               T *D, T *Lw,
                               int64_t *D_dest, int64_t *D_srcpos,
                               int64_t *L_dest, int64_t *L_srcpos)
{
    const int64_t nthr = win_nthreads(m);
    std::vector<std::thread> ts;
    ts.reserve((size_t)nthr);
    for (int64_t t = 0; t < nthr; ++t) {
        const int64_t r0 = m * t / nthr, r1 = m * (t + 1) / nthr;
        ts.emplace_back([=]() {
            int64_t il = prefL[r0], id = prefD[r0];
            for (int64_t r = r0; r < r1; ++r) {
                const int64_t rp = reversed ? (m - 1 - r) : r;
                const int64_t blk = rp / nb, blk0 = blk * nb, rin = rp - blk0;
                for (int64_t k = lo[r]; k < hi[r]; ++k) {
                    const int64_t cp =
                        reversed ? (m - 1 - (int64_t)ind[k]) : (int64_t)ind[k];
                    if (cp < blk0) {
                        const int64_t dest = (blk * nb + rin) * WL + (cp - blk0 + WL);
                        Lw[dest] = vals[k];
                        L_dest[il] = dest;
                        L_srcpos[il] = k;
                        ++il;
                    } else {
                        const int64_t dest = (blk * nb + rin) * nb + (cp - blk0);
                        D[dest] = vals[k];
                        D_dest[id] = dest;
                        D_srcpos[id] = k;
                        ++id;
                    }
                }
            }
        });
    }
    for (auto &th : ts) th.join();
}

extern "C" {

void trsv_win_fill_s(int64_t m, const int64_t *lo, const int64_t *hi,
                     const int32_t *ind, const float *vals, int64_t nb,
                     int reversed, int64_t WL,
                     const int64_t *prefL, const int64_t *prefD,
                     float *D, float *Lw,
                     int64_t *D_dest, int64_t *D_srcpos,
                     int64_t *L_dest, int64_t *L_srcpos)
{
    trsv_win_fill_impl<float>(m, lo, hi, ind, vals, nb, reversed, WL,
                              prefL, prefD, D, Lw,
                              D_dest, D_srcpos, L_dest, L_srcpos);
}

void trsv_win_fill_d(int64_t m, const int64_t *lo, const int64_t *hi,
                     const int32_t *ind, const double *vals, int64_t nb,
                     int reversed, int64_t WL,
                     const int64_t *prefL, const int64_t *prefD,
                     double *D, double *Lw,
                     int64_t *D_dest, int64_t *D_srcpos,
                     int64_t *L_dest, int64_t *L_srcpos)
{
    trsv_win_fill_impl<double>(m, lo, hi, ind, vals, nb, reversed, WL,
                               prefL, prefD, D, Lw,
                               D_dest, D_srcpos, L_dest, L_srcpos);
}

} // extern "C"
