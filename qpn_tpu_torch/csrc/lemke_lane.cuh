// Per-lane logic of the batched Lemke pivot loop for box AVIs
//     M z + q  ⟂  l ≤ z ≤ u,
// shared by the Hopper kernel (lemke_pivot.cu: one thread block per lane)
// and a host instance built with g++ for the CPU tests
// (lemke_lane_host.cpp: one "thread", tid 0 of 1).
//
// The functions take the thread index and count as arguments; QPN_SYNC() is
// __syncthreads() in device code and a no-op on the host.  Data-parallel
// steps (basic values, ratio test, rank-1 tableau update) are split over the
// threads; the scalar decisions (min ratio, ties, lexicographic refinement,
// bound flip, complement rule) are thread-0 steps between barriers.
//
// Semantics follow the JAX package's pivot loop lane for lane
// (qpn_tpu/ops/lemke.py::_lemke_single, qpn_tpu/ops/lemke_pallas.py):
//   * the iteration counter starts at 1; the loop runs while it is below
//     max_pivots and the lane's status is 0;
//   * a terminating ray or singular step counts no pivot;
//   * a NaN ratio is +inf, then every ratio is clamped at 0 or above;
//   * ties: theta <= tstar + tol*(1+|tstar|); the t row wins a tie, else
//     lexicographic refinement over the u-columns n+kk, eps 1e-12;
//   * every argmin takes the first index;
//   * a bound flip changes no basis; a singular pivot leaves the tableau;
//   * IEEE infinities in the variable bounds stay infinities.
// Compile without fast math: approximate division would move ratio ties.

#pragma once

#include <cmath>
#include <cstddef>

#if defined(__CUDACC__)
#define QPN_HD __host__ __device__ __forceinline__
#else
#define QPN_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define QPN_SYNC() __syncthreads()
#else
#define QPN_SYNC() ((void)0)
#endif

namespace qpn {

enum { LEMKE_SUCCESS = 1, LEMKE_RAY = 2, LEMKE_MAX = 3, LEMKE_SINGULAR = 4 };
enum { ACT_NONE = 0, ACT_PIVOT = 1 };

template <typename T> QPN_HD T lk_inf() { return T(INFINITY); }
template <typename T> QPN_HD bool lk_isnan(T x) { return x != x; }
template <typename T> QPN_HD bool lk_isfinite(T x) {
    return x == x && x != lk_inf<T>() && x != -lk_inf<T>();
}
template <typename T> QPN_HD T lk_abs(T x) { return x < T(0) ? -x : x; }

// Batched inputs and outputs in device (or host) memory, row-major:
// tableau (B, n, 3n+2) with columns z|u|v|t then rhs; per-lane vectors
// (B, n) or (B, 3n+1); per-lane scalars (B,).
template <typename T>
struct LemkeBatch {
    const T* tab_in;
    const int* basis_in;
    const T* val_in;
    const T* vlb;
    const T* vub;
    const T* leff;
    const T* ueff;
    const int* ent_in;
    const T* edir_in;
    const T* ev_in;
    const int* status_in;
    T* xB_out;
    int* basis_out;
    T* val_out;
    int* piv_out;
    int* status_out;
    int B, n;
    T tol, piv_tol;
    int max_pivots;
};

// Scalars of one lane, shared by its threads.
template <typename T>
struct LaneCtl {
    T edir, ev, piv_elt;
    int ent, status, piv, k, jstar, act;
};

// One lane's working set (shared memory on the card).
template <typename T>
struct Lane {
    int n;
    T* tab;      // (n, 3n+2)
    T* val;      // (3n+1) nonbasic values
    T* vlb;      // (3n+1) variable bounds
    T* vub;
    T* leff;     // (n) synthetically boxed bounds
    T* ueff;
    T* xB;       // (n) basic values
    T* d;        // (n) entering column times direction
    T* theta;    // (n) ratios
    T* other;    // (n) entering column, pivot row zeroed
    T* pr;       // (3n+2) scaled pivot row
    int* basis;  // (n)
    unsigned char* cand;  // (n) tie candidates
    LaneCtl<T>* ctl;
};

QPN_HD size_t lk_align16(size_t x) { return (x + 15) & ~size_t(15); }

template <typename T>
QPN_HD size_t lane_floats(int n) {
    const size_t W = 3 * (size_t)n + 2, NV = W - 1;
    return (size_t)n * W + 3 * NV + 6 * (size_t)n + W;
}

// Bytes of one lane's working set: f32 at n=38 is about 20 KB.
template <typename T>
QPN_HD size_t lane_bytes(int n) {
    return lk_align16(sizeof(LaneCtl<T>)) + lk_align16(lane_floats<T>(n) * sizeof(T))
         + lk_align16((size_t)n * sizeof(int)) + lk_align16((size_t)n);
}

// Carve a lane's working set out of a 16-byte aligned buffer.
template <typename T>
QPN_HD Lane<T> lane_carve(unsigned char* base, int n) {
    const size_t W = 3 * (size_t)n + 2, NV = W - 1;
    Lane<T> L;
    L.n = n;
    L.ctl = reinterpret_cast<LaneCtl<T>*>(base);
    T* f = reinterpret_cast<T*>(base + lk_align16(sizeof(LaneCtl<T>)));
    L.tab = f;       f += (size_t)n * W;
    L.val = f;       f += NV;
    L.vlb = f;       f += NV;
    L.vub = f;       f += NV;
    L.leff = f;      f += n;
    L.ueff = f;      f += n;
    L.xB = f;        f += n;
    L.d = f;         f += n;
    L.theta = f;     f += n;
    L.other = f;     f += n;
    L.pr = f;
    unsigned char* rest = base + lk_align16(sizeof(LaneCtl<T>))
                        + lk_align16(lane_floats<T>(n) * sizeof(T));
    L.basis = reinterpret_cast<int*>(rest);
    L.cand = rest + lk_align16((size_t)n * sizeof(int));
    return L;
}

template <typename T>
QPN_HD void lane_load(const Lane<T>& L, const LemkeBatch<T>& bt, size_t b,
                      int tid, int nthr) {
    const int n = L.n, W = 3 * n + 2, NV = W - 1;
    const T* tb = bt.tab_in + b * (size_t)n * W;
    for (int i = tid; i < n * W; i += nthr) L.tab[i] = tb[i];
    for (int j = tid; j < NV; j += nthr) {
        L.val[j] = bt.val_in[b * NV + j];
        L.vlb[j] = bt.vlb[b * NV + j];
        L.vub[j] = bt.vub[b * NV + j];
    }
    for (int r = tid; r < n; r += nthr) {
        L.basis[r] = bt.basis_in[b * n + r];
        L.leff[r] = bt.leff[b * n + r];
        L.ueff[r] = bt.ueff[b * n + r];
    }
    if (tid == 0) {
        LaneCtl<T>* c = L.ctl;
        c->ent = bt.ent_in[b];
        c->edir = bt.edir_in[b];
        c->ev = bt.ev_in[b];
        c->status = bt.status_in[b];
        c->piv = 0;
        c->k = 1;
        c->jstar = 0;
        c->piv_elt = T(0);
        c->act = ACT_NONE;
    }
    QPN_SYNC();
}

template <typename T>
QPN_HD void lane_store(const Lane<T>& L, const LemkeBatch<T>& bt, size_t b,
                       int tid, int nthr) {
    const int n = L.n, NV = 3 * n + 1;
    for (int r = tid; r < n; r += nthr) {
        bt.xB_out[b * n + r] = L.xB[r];
        bt.basis_out[b * n + r] = L.basis[r];
    }
    for (int j = tid; j < NV; j += nthr) bt.val_out[b * NV + j] = L.val[j];
    if (tid == 0) {
        bt.piv_out[b] = L.ctl->piv;
        bt.status_out[b] = L.ctl->status;
    }
}

// xB[r] = rhs[r] - tab[r, 0:3n+1] . val  for rows r = tid, tid+nthr, ...
template <typename T>
QPN_HD void lane_basic_values(const Lane<T>& L, int tid, int nthr) {
    const int n = L.n, W = 3 * n + 2, NV = W - 1;
    for (int r = tid; r < n; r += nthr) {
        const T* row = L.tab + (size_t)r * W;
        T s = row[NV];
        for (int j = 0; j < NV; ++j) s -= row[j] * L.val[j];
        L.xB[r] = s;
    }
}

// Thread 0: ray / bound flip / pivot-row choice after the ratio test.
template <typename T>
QPN_HD void lane_decide(const Lane<T>& L, T tol, T piv_tol) {
    const int n = L.n, W = 3 * n + 2, T_ID = 3 * n;
    LaneCtl<T>* c = L.ctl;
    const T INF = lk_inf<T>();
    const int ent = c->ent;
    const T edir = c->edir, ev = c->ev;
    c->act = ACT_NONE;

    T tstar = INF;
    for (int r = 0; r < n; ++r)
        if (L.theta[r] < tstar) tstar = L.theta[r];
    const T theta_e = edir > T(0) ? L.vub[ent] - ev : ev - L.vlb[ent];

    if (!lk_isfinite(tstar) && !lk_isfinite(theta_e)) {
        c->status = LEMKE_RAY;               // no pivot counted
        return;
    }
    if (theta_e <= tstar) {                  // bound flip: no basis change
        const int i = ent % n;
        L.val[ent] = edir > T(0) ? L.vub[ent] : L.vlb[ent];
        c->ent = edir > T(0) ? 2 * n + i : n + i;
        c->edir = T(1);
        c->ev = T(0);
        c->piv += 1;
        return;
    }

    const T thr = tstar + tol * (T(1) + lk_abs(tstar));
    int js = -1;
    for (int r = 0; r < n; ++r)              // t exits on a tie: terminate
        if (L.theta[r] <= thr && L.basis[r] == T_ID) { js = r; break; }
    if (js < 0) {
        int ncand = 0;
        for (int r = 0; r < n; ++r) {
            L.cand[r] = L.theta[r] <= thr;
            ncand += L.cand[r];
        }
        // lexicographic refinement over the -B^{-1} block (u-columns)
        for (int kk = 0; kk < n && ncand > 1; ++kk) {
            T kmin = INF;
            for (int r = 0; r < n; ++r) {
                if (!L.cand[r]) continue;
                const T dr = lk_abs(L.d[r]) > piv_tol ? L.d[r] : T(1);
                const T key = -L.tab[(size_t)r * W + n + kk] / dr;
                if (key < kmin) kmin = key;
            }
            const T kthr = kmin + T(1e-12) * (T(1) + lk_abs(kmin));
            ncand = 0;
            for (int r = 0; r < n; ++r) {
                if (!L.cand[r]) continue;
                const T dr = lk_abs(L.d[r]) > piv_tol ? L.d[r] : T(1);
                const T key = -L.tab[(size_t)r * W + n + kk] / dr;
                L.cand[r] = key <= kthr;
                ncand += L.cand[r];
            }
        }
        js = 0;                              // argmax convention: 0 if none
        for (int r = 0; r < n; ++r)
            if (L.cand[r]) { js = r; break; }
    }
    const T pe = L.tab[(size_t)js * W + ent];
    if (lk_abs(pe) < piv_tol) {
        c->status = LEMKE_SINGULAR;          // tableau untouched, no pivot
        return;
    }
    c->jstar = js;
    c->piv_elt = pe;
    c->act = ACT_PIVOT;
}

// Thread 0, after a pivot: basis bookkeeping and the Lemke complement rule.
template <typename T>
QPN_HD void lane_commit(const Lane<T>& L) {
    const int n = L.n, T_ID = 3 * n;
    LaneCtl<T>* c = L.ctl;
    const int js = c->jstar, ent = c->ent;
    const int ex = L.basis[js];
    const T exv = L.d[js] > T(0) ? L.vlb[ex] : L.vub[ex];
    L.basis[js] = ent;
    L.val[ex] = exv;
    L.val[ent] = T(0);
    c->piv += 1;
    if (ex == T_ID) {
        c->status = LEMKE_SUCCESS;
        return;
    }
    const int i = ex % n;
    if (ex < n) {                            // z_i left at a bound
        const bool at_l = lk_abs(exv - L.leff[i]) <= lk_abs(exv - L.ueff[i]);
        c->ent = at_l ? n + i : 2 * n + i;
        c->edir = T(1);
        c->ev = T(0);
    } else if (ex < 2 * n) {                 // u_i left: z_i rises from l_i
        c->ent = i;
        c->edir = T(1);
        c->ev = L.leff[i];
    } else {                                 // v_i left: z_i falls from u_i
        c->ent = i;
        c->edir = T(-1);
        c->ev = L.ueff[i];
    }
}

// The pivot loop of one lane; every thread of the lane calls it.
template <typename T>
QPN_HD void lane_run(const Lane<T>& L, int tid, int nthr, T tol, T piv_tol,
                     int max_pivots) {
    const int n = L.n, W = 3 * n + 2;
    LaneCtl<T>* c = L.ctl;
    const T INF = lk_inf<T>();
    while (c->status == 0 && c->k < max_pivots) {
        // the entering variable temporarily carries its start value
        if (tid == 0) L.val[c->ent] = c->ev;
        QPN_SYNC();
        const int ent = c->ent;
        const T edir = c->edir;
        lane_basic_values(L, tid, nthr);
        for (int r = tid; r < n; r += nthr) {          // ratio test
            const T dr = edir * L.tab[(size_t)r * W + ent];
            const int bv = L.basis[r];
            T th;
            if (dr > piv_tol) th = (L.xB[r] - L.vlb[bv]) / dr;
            else if (dr < -piv_tol) th = (L.xB[r] - L.vub[bv]) / dr;
            else th = INF;
            if (lk_isnan(th)) th = INF;
            if (th < T(0)) th = T(0);
            L.d[r] = dr;
            L.theta[r] = th;
        }
        QPN_SYNC();
        if (tid == 0) lane_decide(L, tol, piv_tol);
        QPN_SYNC();
        if (c->act == ACT_PIVOT) {
            const int js = c->jstar;
            const T pe = c->piv_elt;
            for (int j = tid; j < W; j += nthr)
                L.pr[j] = L.tab[(size_t)js * W + j] / pe;
            for (int r = tid; r < n; r += nthr)
                L.other[r] = r == js ? T(0) : L.tab[(size_t)r * W + ent];
            QPN_SYNC();
            for (int i = tid; i < n * W; i += nthr) {  // rank-1 update
                const int r = i / W, j = i - r * W;
                L.tab[i] = r == js ? L.pr[j] : L.tab[i] - L.other[r] * L.pr[j];
            }
            if (tid == 0) lane_commit(L);   // touches basis/val/ctl only
        }
        if (tid == 0) c->k += 1;
        QPN_SYNC();
    }
    lane_basic_values(L, tid, nthr);
    if (tid == 0 && c->status == 0) c->status = LEMKE_MAX;
    QPN_SYNC();
}

}  // namespace qpn

// Parameter list and batch descriptor of the C entry points (CUDA and host).
#define QPN_LEMKE_PARAMS(T)                                                   \
    const T *tab_in, const int *basis_in, const T *val_in, const T *vlb,      \
        const T *vub, const T *leff, const T *ueff, const int *ent_in,        \
        const T *edir_in, const T *ev_in, const int *status_in, T *xB_out,    \
        int *basis_out, T *val_out, int *piv_out, int *status_out, int B,     \
        int n, double tol, double piv_tol, int max_pivots

#define QPN_LEMKE_BATCH(T)                                                    \
    qpn::LemkeBatch<T> {                                                      \
        tab_in, basis_in, val_in, vlb, vub, leff, ueff, ent_in, edir_in,      \
            ev_in, status_in, xB_out, basis_out, val_out, piv_out,            \
            status_out, B, n, (T)tol, (T)piv_tol, max_pivots                  \
    }
