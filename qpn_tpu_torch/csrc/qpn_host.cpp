// Copied verbatim, below this note, from qpn_tpu/native/qpn_host.cpp (the
// JAX package's native host kernels).  The port builds this copy with g++
// (qpn_tpu_torch/utils/native.py) and, unlike the JAX package, has no
// silent pure-Python fallback: a failed build raises.
//
// Native host-side kernels for the enumeration bookkeeping.
//
// The TPU executes all numeric math (ops/, geometry/setops); what remains on
// host is combinatorial: expanding complementarity-label products into
// recipe tensors (avi_solutions.jl:200-215's all_Ks) and quantized row
// hashing for piece/vertex dedup (the reference's 5-digit rounding,
// sets.jl:104-112).  Those inner loops are pure integer/byte work — exactly
// the part CPython is slowest at — so they live here, loaded via ctypes
// (no pybind11 in this image), with pure-Python fallbacks in
// qpn_tpu/utils/native.py.
//
// Build: g++ -O3 -shared -fPIC qpn_host.cpp -o libqpn_host.so

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Cartesian product of per-row label choices.
//   labels:  flattened choice lists (int32), row r occupies
//            [offsets[r], offsets[r+1])
//   n_rows:  number of complementarity rows
//   cap:     maximum number of recipes to emit
//   out:     (cap * n_rows) int32 buffer, recipes row-major
// returns the number of recipes written (product truncated at cap).
int64_t qpn_recipe_product(const int32_t* labels, const int64_t* offsets,
                           int64_t n_rows, int64_t cap, int32_t* out) {
    // odometer over the choice lists
    // a row with an EMPTY choice list means zero recipes (the Python
    // fallback's itertools.product semantics); indexing past offsets
    // would read the next row's labels
    for (int64_t r = 0; r < n_rows; ++r) {
        if (offsets[r + 1] <= offsets[r]) return 0;
    }
    int64_t* idx = new int64_t[n_rows];
    std::memset(idx, 0, sizeof(int64_t) * n_rows);
    int64_t count = 0;
    bool done = (n_rows == 0);
    while (!done && count < cap) {
        int32_t* row = out + count * n_rows;
        for (int64_t r = 0; r < n_rows; ++r) {
            row[r] = labels[offsets[r] + idx[r]];
        }
        ++count;
        // increment odometer (last row fastest, matching itertools.product)
        int64_t r = n_rows - 1;
        while (r >= 0) {
            idx[r] += 1;
            if (idx[r] < offsets[r + 1] - offsets[r]) break;
            idx[r] = 0;
            --r;
        }
        if (r < 0) done = true;
    }
    delete[] idx;
    return count;
}

// Quantize one value to `scale` decimal digits: half-to-even rounding
// (nearbyint under the default FP env, matching np.round in the Python
// fallback exactly), -0.0 folded to 0.0, NaN/overflow clamped to sentinel
// int64 codes.  The ONE copy of the subtle clamp constants.
static inline int64_t qpn_quantize_value(double x, double scale) {
    double v = std::nearbyint(x * scale);
    if (v == 0.0) v = 0.0;  // fold -0.0
    if (std::isnan(v)) return INT64_MIN;
    if (v > 9.2e18) return INT64_MAX;
    if (v < -9.2e18) return INT64_MIN + 1;
    return (int64_t)v;
}

static inline uint64_t qpn_fnv1a_row(const int64_t* q, int64_t cols) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t c = 0; c < cols; ++c) {
        const unsigned char* bytes = (const unsigned char*)(q + c);
        for (int b = 0; b < 8; ++b) {
            h ^= bytes[b];
            h *= 1099511628211ULL;
        }
    }
    return h;
}

// FNV-1a hash of rows rounded to `digits` decimal digits; -0.0 folds to 0.0.
// data: (rows * cols) doubles; out: rows uint64 hashes.
void qpn_quantize_hash(const double* data, int64_t rows, int64_t cols,
                       int32_t digits, uint64_t* out) {
    const double scale = std::pow(10.0, digits);
    int64_t* q = new int64_t[cols];
    for (int64_t r = 0; r < rows; ++r) {
        const double* row = data + r * cols;
        for (int64_t c = 0; c < cols; ++c) q[c] = qpn_quantize_value(row[c], scale);
        out[r] = qpn_fnv1a_row(q, cols);
    }
    delete[] q;
}

// Deduplicate rows by quantized equality: out_keep[r] = 1 iff row r is the
// first occurrence of its quantized content.  Exact comparison on the
// quantized integers (no hash collisions), O(rows^2 * cols) worst case with
// a hash prefilter.
void qpn_dedupe_rows(const double* data, int64_t rows, int64_t cols,
                     int32_t digits, uint8_t* out_keep) {
    const double scale = std::pow(10.0, digits);
    int64_t* q = new int64_t[rows * cols];
    uint64_t* hashes = new uint64_t[rows];
    for (int64_t r = 0; r < rows; ++r) {
        for (int64_t c = 0; c < cols; ++c) {
            q[r * cols + c] = qpn_quantize_value(data[r * cols + c], scale);
        }
        // hash the already-quantized buffer: one quantization pass total
        hashes[r] = qpn_fnv1a_row(q + r * cols, cols);
    }
    for (int64_t r = 0; r < rows; ++r) {
        out_keep[r] = 1;
        for (int64_t p = 0; p < r; ++p) {
            if (hashes[p] != hashes[r] || !out_keep[p]) continue;
            if (std::memcmp(q + p * cols, q + r * cols,
                            sizeof(int64_t) * cols) == 0) {
                out_keep[r] = 0;
                break;
            }
        }
    }
    delete[] q;
    delete[] hashes;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Box-AVI complementary pivoting (Lemke) — native port of the host oracle
// ops/lemke.py::solve_lemke_np (same algorithm: synthetic big-M boxes,
// slack-only start basis, "viol" covering vector, bound flips,
// lexicographic ratio tie-break, terminal refactorization).  Used for the
// small exact-shape LP-KKT systems behind geometry support/exemplar
// queries, where per-pivot work is a few µs and JAX dispatch overhead
// dominates any device kernel (sets.jl:377-407 / 591-642 roles).
// ---------------------------------------------------------------------------

static const int LK_SUCCESS = 1, LK_RAY = 2, LK_MAX = 3, LK_SINGULAR = 4;
static const double LK_INF = INFINITY;

// Gaussian elimination with partial pivoting; returns 0 on success.
static int lk_solve_dense(int64_t n, double* A /*n*n, destroyed*/,
                          double* b /*n, in/out*/) {
    for (int64_t k = 0; k < n; ++k) {
        int64_t p = k;
        double mx = std::fabs(A[k * n + k]);
        for (int64_t r = k + 1; r < n; ++r) {
            double v = std::fabs(A[r * n + k]);
            if (v > mx) { mx = v; p = r; }
        }
        if (!(mx > 1e-300)) return 1;
        if (p != k) {
            for (int64_t c = k; c < n; ++c) {
                double t = A[k * n + c]; A[k * n + c] = A[p * n + c];
                A[p * n + c] = t;
            }
            double t = b[k]; b[k] = b[p]; b[p] = t;
        }
        for (int64_t r = k + 1; r < n; ++r) {
            double f = A[r * n + k] / A[k * n + k];
            if (f == 0.0) continue;
            for (int64_t c = k; c < n; ++c) A[r * n + c] -= f * A[k * n + c];
            b[r] -= f * b[k];
        }
    }
    for (int64_t k = n - 1; k >= 0; --k) {
        double s = b[k];
        for (int64_t c = k + 1; c < n; ++c) s -= A[k * n + c] * b[c];
        b[k] = s / A[k * n + k];
        if (!std::isfinite(b[k])) return 1;
    }
    return 0;
}

static void lk_pivot(double* T, int64_t n_rows, int64_t n_cols,
                     int64_t row, int64_t col) {
    double piv = T[row * n_cols + col];
    double* tr = T + row * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) tr[c] /= piv;
    for (int64_t r = 0; r < n_rows; ++r) {
        if (r == row) continue;
        double f = T[r * n_cols + col];
        if (f == 0.0) continue;
        double* rr = T + r * n_cols;
        for (int64_t c = 0; c < n_cols; ++c) rr[c] -= f * tr[c];
    }
}

// basic values xB = T[:, rhs] - T[:, 0:3n+1] @ nb  (nb = nonbasic values)
static void lk_basic_values(const double* T, int64_t n, int64_t n_cols,
                            const int64_t* basis, const double* val,
                            double* nb /*3n+1 scratch*/, double* xB) {
    int64_t nv = 3 * n + 1;
    for (int64_t j = 0; j < nv; ++j) nb[j] = val[j];
    for (int64_t j = 0; j < n; ++j) nb[basis[j]] = 0.0;
    for (int64_t r = 0; r < n; ++r) {
        const double* tr = T + r * n_cols;
        double s = tr[n_cols - 1];
        for (int64_t j = 0; j < nv; ++j)
            if (nb[j] != 0.0) s -= tr[j] * nb[j];
        xB[r] = s;
    }
}

static void lk_extract(int64_t n, const int64_t* basis, const double* val,
                       const double* xB, double* z) {
    for (int64_t i = 0; i < n; ++i) z[i] = val[i];
    for (int64_t j = 0; j < n; ++j)
        if (basis[j] < n) z[basis[j]] = xB[j];
}

// complement rule: (entering, ent_dir, ent_val) from the exiting variable
static void lk_complement(int64_t exiting, const double* val,
                          const double* l, const double* u, int64_t n,
                          int64_t* entering, double* ent_dir,
                          double* ent_val) {
    int64_t i = exiting % n;
    if (exiting < n) {
        bool at_l = std::fabs(val[exiting] - l[i])
                    <= std::fabs(val[exiting] - u[i]);
        *entering = at_l ? n + i : 2 * n + i; *ent_dir = 1.0; *ent_val = 0.0;
    } else if (exiting < 2 * n) {
        *entering = i; *ent_dir = 1.0; *ent_val = l[i];
    } else {
        *entering = i; *ent_dir = -1.0; *ent_val = u[i];
    }
}

// One box AVI  M z + q ⟂ l ≤ z ≤ u.  Returns status, writes z and pivots.
static int lemke_one(int64_t n, const double* M, const double* q,
                     const double* l_in, const double* u_in,
                     const double* z0, double tol, double piv_tol,
                     int64_t max_pivots, double synth_scale,
                     double* z_out, int64_t* pivots_out) {
    int64_t n_cols = 3 * n + 2, T_ID = 3 * n;
    double* T = new double[n * n_cols];
    double* l = new double[n];
    double* u = new double[n];
    double* var_lb = new double[3 * n + 1];
    double* var_ub = new double[3 * n + 1];
    double* val = new double[3 * n + 1];
    double* nb = new double[3 * n + 1];
    double* xB = new double[n];
    double* d = new double[n];
    double* theta = new double[n];
    int64_t* basis = new int64_t[n];
    int64_t* ties = new int64_t[n];
    double* zc = new double[n];
    int status = LK_MAX;
    int64_t pivots = 0;

    // synthetic big-M boxes around the clipped start point
    double ref_mx = 0.0, fin_mx = 0.0, q_mx = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double v = z0[i];
        if (std::isnan(v)) v = 0.0;
        if (v < l_in[i]) v = l_in[i];
        if (v > u_in[i]) v = u_in[i];
        if (std::isnan(v)) v = 0.0;
        if (v < -1e12) v = -1e12;
        if (v > 1e12) v = 1e12;
        zc[i] = v;
        if (std::fabs(v) > ref_mx) ref_mx = std::fabs(v);
        if (std::isfinite(l_in[i]) && std::fabs(l_in[i]) > fin_mx)
            fin_mx = std::fabs(l_in[i]);
        if (std::isfinite(u_in[i]) && std::fabs(u_in[i]) > fin_mx)
            fin_mx = std::fabs(u_in[i]);
        if (std::fabs(q[i]) > q_mx) q_mx = std::fabs(q[i]);
    }
    double L = synth_scale * (1.0 + ref_mx + fin_mx);
    for (int64_t i = 0; i < n; ++i) {
        l[i] = std::isinf(l_in[i]) ? zc[i] - L : l_in[i];
        u[i] = std::isinf(u_in[i]) ? zc[i] + L : u_in[i];
    }
    for (int64_t i = 0; i < n; ++i) {
        bool pinned = (u[i] - l[i]) <= 0.0;
        var_lb[i] = l[i]; var_ub[i] = u[i];
        var_lb[n + i] = pinned ? -LK_INF : 0.0; var_ub[n + i] = LK_INF;
        var_lb[2 * n + i] = 0.0; var_ub[2 * n + i] = LK_INF;
    }
    var_lb[T_ID] = 0.0; var_ub[T_ID] = LK_INF;

    // start: nonbasic z at nearest bound, slack basic; tableau = ∓[M -I I 0 -q]
    for (int64_t j = 0; j <= 3 * n; ++j) val[j] = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        bool at_lower = (zc[i] - l[i]) <= (u[i] - zc[i]);
        val[i] = at_lower ? l[i] : u[i];
        basis[i] = at_lower ? n + i : 2 * n + i;
        double sgn = at_lower ? -1.0 : 1.0;
        double* tr = T + i * n_cols;
        for (int64_t c = 0; c < n; ++c) tr[c] = sgn * M[i * n + c];
        for (int64_t c = n; c < 3 * n; ++c) tr[c] = 0.0;
        tr[n + i] = sgn * -1.0;
        tr[2 * n + i] = sgn * 1.0;
        tr[T_ID] = 0.0;
        tr[n_cols - 1] = sgn * -q[i];
    }

    lk_basic_values(T, n, n_cols, basis, val, nb, xB);
    double xB_mx = 0.0, viol_mx = 0.0;
    for (int64_t j = 0; j < n; ++j)
        if (std::fabs(xB[j]) > xB_mx) xB_mx = std::fabs(xB[j]);
    double scale = 1.0 + q_mx + xB_mx;
    int64_t jstar = 0;
    for (int64_t j = 0; j < n; ++j) {
        double v = var_lb[basis[j]] - xB[j];
        if (v < 0.0) v = 0.0;
        if (v > viol_mx) { viol_mx = v; jstar = j; }
    }
    if (viol_mx <= tol * scale) {
        lk_extract(n, basis, val, xB, z_out);
        status = LK_SUCCESS; pivots = 0; goto done;
    }

    // first pivot: t enters along the covering direction (violated rows)
    {
        for (int64_t j = 0; j < n; ++j) {
            double v = var_lb[basis[j]] - xB[j];
            T[j * n_cols + T_ID] = (v > tol * scale) ? -1.0 : 0.0;
        }
        if (std::fabs(T[jstar * n_cols + T_ID]) < piv_tol) {
            for (int64_t i = 0; i < n; ++i) z_out[i] = zc[i];
            status = LK_SINGULAR; pivots = 0; goto done;
        }
        int64_t exiting = basis[jstar];
        val[exiting] = var_lb[exiting];
        lk_pivot(T, n, n_cols, jstar, T_ID);
        basis[jstar] = T_ID;
        val[T_ID] = 0.0;

        int64_t entering; double ent_dir, ent_val;
        lk_complement(exiting, val, l, u, n, &entering, &ent_dir, &ent_val);
        pivots = 1;

        while (pivots < max_pivots) {
            val[entering] = ent_val;
            lk_basic_values(T, n, n_cols, basis, val, nb, xB);
            double tstar = LK_INF;
            for (int64_t j = 0; j < n; ++j) {
                d[j] = ent_dir * T[j * n_cols + entering];
                double th;
                if (d[j] > piv_tol) th = (xB[j] - var_lb[basis[j]]) / d[j];
                else if (d[j] < -piv_tol)
                    th = (xB[j] - var_ub[basis[j]]) / d[j];
                else th = LK_INF;
                if (std::isnan(th)) th = LK_INF;
                if (th < 0.0) th = 0.0;
                theta[j] = th;
                if (th < tstar) tstar = th;
            }
            double theta_e = (ent_dir > 0) ? var_ub[entering] - ent_val
                                           : ent_val - var_lb[entering];
            if (!std::isfinite(tstar) && !std::isfinite(theta_e)) {
                lk_extract(n, basis, val, xB, z_out);
                status = LK_RAY; goto done;
            }
            if (theta_e <= tstar) {                     // bound flip
                val[entering] = (ent_dir > 0) ? var_ub[entering]
                                              : var_lb[entering];
                int64_t i = entering % n;
                if (ent_dir > 0) { entering = 2 * n + i; }
                else             { entering = n + i; }
                ent_dir = 1.0; ent_val = 0.0;
                ++pivots;
                continue;
            }
            // collect ties; lexicographic tie-break on -B^{-1} (u-columns)
            int64_t n_ties = 0;
            double thr = tstar + tol * (1.0 + std::fabs(tstar));
            for (int64_t j = 0; j < n; ++j)
                if (theta[j] <= thr) ties[n_ties++] = j;
            if (n_ties > 1) {
                int64_t trow = -1;
                for (int64_t j = 0; j < n; ++j)
                    if (basis[j] == T_ID) { trow = j; break; }
                bool t_in = false;
                if (trow >= 0)
                    for (int64_t k = 0; k < n_ties; ++k)
                        if (ties[k] == trow) { t_in = true; break; }
                if (t_in) {
                    jstar = trow;
                } else {
                    int64_t n_cand = n_ties;
                    for (int64_t k = 0; k < n && n_cand > 1; ++k) {
                        double kmin = LK_INF;
                        for (int64_t c = 0; c < n_cand; ++c) {
                            double key = -T[ties[c] * n_cols + n + k]
                                         / d[ties[c]];
                            if (key < kmin) kmin = key;
                        }
                        double kthr = kmin + 1e-12 * (1.0 + std::fabs(kmin));
                        int64_t w = 0;
                        for (int64_t c = 0; c < n_cand; ++c) {
                            double key = -T[ties[c] * n_cols + n + k]
                                         / d[ties[c]];
                            if (key <= kthr) ties[w++] = ties[c];
                        }
                        n_cand = w;
                    }
                    jstar = ties[0];
                }
            } else {
                jstar = ties[0];
            }
            if (std::fabs(T[jstar * n_cols + entering]) < piv_tol) {
                lk_extract(n, basis, val, xB, z_out);
                status = LK_SINGULAR; goto done;
            }
            exiting = basis[jstar];
            bool hit_lower = d[jstar] > 0;
            val[exiting] = hit_lower ? var_lb[exiting] : var_ub[exiting];
            lk_pivot(T, n, n_cols, jstar, entering);
            basis[jstar] = entering;
            val[entering] = 0.0;
            ++pivots;

            if (exiting == T_ID) {
                // terminal refactorization from the ORIGINAL data
                double* Bm = new double[n * n];
                double* rhs = new double[n];
                for (int64_t i = 0; i < n * n; ++i) Bm[i] = 0.0;
                bool ok = true;
                for (int64_t j = 0; j < n && ok; ++j) {
                    int64_t var = basis[j];
                    if (var < n)
                        for (int64_t r = 0; r < n; ++r)
                            Bm[r * n + j] = M[r * n + var];
                    else if (var < 2 * n) Bm[(var - n) * n + j] = -1.0;
                    else if (var < 3 * n) Bm[(var - 2 * n) * n + j] = 1.0;
                    else ok = false;     // t basic: cannot happen here
                }
                if (ok) {
                    for (int64_t j = 0; j <= 3 * n; ++j) nb[j] = val[j];
                    for (int64_t j = 0; j < n; ++j) nb[basis[j]] = 0.0;
                    for (int64_t r = 0; r < n; ++r) {
                        double s = -q[r] + nb[n + r] - nb[2 * n + r];
                        for (int64_t c = 0; c < n; ++c)
                            s -= M[r * n + c] * nb[c];
                        rhs[r] = s;
                    }
                    ok = (lk_solve_dense(n, Bm, rhs) == 0);
                }
                if (ok) {
                    lk_extract(n, basis, val, rhs, z_out);
                } else {
                    lk_basic_values(T, n, n_cols, basis, val, nb, xB);
                    lk_extract(n, basis, val, xB, z_out);
                }
                delete[] Bm; delete[] rhs;
                status = LK_SUCCESS; goto done;
            }
            lk_complement(exiting, val, l, u, n, &entering, &ent_dir,
                          &ent_val);
        }
        lk_basic_values(T, n, n_cols, basis, val, nb, xB);
        lk_extract(n, basis, val, xB, z_out);
        status = LK_MAX;
    }

done:
    *pivots_out = pivots;
    delete[] T; delete[] l; delete[] u; delete[] var_lb; delete[] var_ub;
    delete[] val; delete[] nb; delete[] xB; delete[] d; delete[] theta;
    delete[] basis; delete[] ties; delete[] zc;
    return status;
}

extern "C" {

// Batched box-AVI Lemke: B instances of size n (row-major).
// z0 may be null (zeros).  Outputs: z (B*n), status (B), pivots (B).
void qpn_lemke_batch(const double* M, const double* q, const double* l,
                     const double* u, const double* z0,
                     int64_t B, int64_t n, double tol, double piv_tol,
                     int64_t max_pivots, double synth_scale,
                     double* z_out, int32_t* status_out,
                     int64_t* pivots_out) {
    // lanes are independent (lemke_one is pure; all scratch is per-call) —
    // dynamic schedule because pivot counts vary wildly across lanes
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t b = 0; b < B; ++b) {
        const double* z0b;
        double* zb = nullptr;
        if (z0) {
            z0b = z0 + b * n;
        } else {
            zb = new double[n]();
            z0b = zb;
        }
        int64_t piv = 0;
        int st = lemke_one(n, M + b * n * n, q + b * n, l + b * n,
                           u + b * n, z0b, tol, piv_tol, max_pivots,
                           synth_scale, z_out + b * n, &piv);
        status_out[b] = st;
        pivots_out[b] = piv;
        if (zb) delete[] zb;
    }
}

}  // extern "C"
