// Per-polyhedron logic of the f32 feasibility screen for batches of
// polyhedra  l ≤ A x ≤ u  (A row-normalised by the caller), shared by the
// Hopper kernel (screen.cu: one thread block per polyhedron) and a host
// instance built with g++ for the CPU tests (screen_lane_host.cpp: one
// "thread", tid 0 of 1).
//
// Each of `steps` projected-subgradient steps is
//     v = max(l − Ax, 0) + min(u − Ax, 0),   x ← x + lr · Aᵀv,
// v being the signed violation of each row (positive below l, negative
// above u).  A step is two phases separated by barriers (QPN_SCREEN_SYNC:
// __syncthreads() on the card, a no-op on the host): phase 1 gives each
// thread rows r = tid, tid+nthr, ... and computes (Ax)_r and v_r, summing
// over the columns in order; phase 2 gives each thread columns j and
// computes g_j = Σ_r A_rj v_r over the rows in order, then updates x_j.
// After the last step one more phase 1 gives the final v, and a block
// reduction its max |v|.
//
// max and min propagate NaN, as jnp.maximum / jnp.minimum and torch do
// (fmaxf/fminf would drop it and could turn a diverged polyhedron into a
// witness).  IEEE infinities in l and u stand for missing bounds.

#pragma once

#include <cstddef>

#if defined(__CUDACC__)
#define QPN_SCREEN_HD __host__ __device__ __forceinline__
#else
#define QPN_SCREEN_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define QPN_SCREEN_SYNC() __syncthreads()
#else
#define QPN_SCREEN_SYNC() ((void)0)
#endif

namespace qpn {

// Batched f32 inputs and outputs in device (or host) memory, row-major:
// A (B, m, n); l, u (B, m); x0, x_out (B, n); v_out (B,).
struct ScreenBatch {
    const float* A;
    const float* l;
    const float* u;
    const float* x0;
    float* x_out;
    float* v_out;
    int B, m, n, steps;
    float lr;
};

// One polyhedron's working set (shared memory on the card).  Rows of A are
// ld = n | 1 floats apart: the odd stride puts the rows that neighbouring
// threads read in phase 1 on different banks, while phase 2's threads read
// neighbouring columns of one row.
struct ScreenLane {
    int m, n, ld;
    float* A;     // (m, ld)
    float* l;     // (m)
    float* u;
    float* v;     // signed violation
    float* x;     // (n)
    float* red;   // (nthr) partial maxima of |v|
};

QPN_SCREEN_HD int screen_ld(int n) { return n | 1; }

// Bytes of one polyhedron's working set with `nthr` threads: about 1.9 KB
// at robust_avoid's piece shape (18 rows, dimension 18, 32 threads).
QPN_SCREEN_HD size_t screen_lane_bytes(int m, int n, int nthr) {
    return ((size_t)m * screen_ld(n) + 3 * (size_t)m + (size_t)n
            + (size_t)nthr) * sizeof(float);
}

QPN_SCREEN_HD ScreenLane screen_lane_carve(float* base, int m, int n) {
    ScreenLane L;
    L.m = m;
    L.n = n;
    L.ld = screen_ld(n);
    L.A = base;
    L.l = L.A + (size_t)m * L.ld;
    L.u = L.l + m;
    L.v = L.u + m;
    L.x = L.v + m;
    L.red = L.x + n;
    return L;
}

QPN_SCREEN_HD float screen_nanmax(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

QPN_SCREEN_HD float screen_nanmin(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

QPN_SCREEN_HD void screen_lane_load(const ScreenLane& L, const ScreenBatch& bt,
                                    size_t b, int tid, int nthr) {
    const int m = L.m, n = L.n;
    const float* Ab = bt.A + b * (size_t)m * n;
    for (int k = tid; k < m * n; k += nthr) L.A[(k / n) * L.ld + k % n] = Ab[k];
    for (int r = tid; r < m; r += nthr) {
        L.l[r] = bt.l[b * m + r];
        L.u[r] = bt.u[b * m + r];
    }
    for (int j = tid; j < n; j += nthr) L.x[j] = bt.x0[b * n + j];
    QPN_SCREEN_SYNC();
}

// Phase 1: v_r for the thread's rows.
QPN_SCREEN_HD void screen_violation(const ScreenLane& L, int tid, int nthr) {
    for (int r = tid; r < L.m; r += nthr) {
        const float* Ar = L.A + (size_t)r * L.ld;
        float ax = 0.0f;
        for (int j = 0; j < L.n; ++j) ax += Ar[j] * L.x[j];
        L.v[r] = screen_nanmax(L.l[r] - ax, 0.0f)
                 + screen_nanmin(L.u[r] - ax, 0.0f);
    }
    QPN_SCREEN_SYNC();
}

// Phase 2: x_j += lr · Σ_r A_rj v_r for the thread's columns.
QPN_SCREEN_HD void screen_update(const ScreenLane& L, float lr, int tid,
                                 int nthr) {
    for (int j = tid; j < L.n; j += nthr) {
        float g = 0.0f;
        for (int r = 0; r < L.m; ++r) g += L.A[(size_t)r * L.ld + j] * L.v[r];
        L.x[j] = L.x[j] + lr * g;
    }
    QPN_SCREEN_SYNC();
}

QPN_SCREEN_HD void screen_lane_run(const ScreenLane& L, int steps, float lr,
                                   int tid, int nthr) {
    for (int s = 0; s < steps; ++s) {
        screen_violation(L, tid, nthr);
        screen_update(L, lr, tid, nthr);
    }
    screen_violation(L, tid, nthr);
}

// max |v| over the rows: per-thread partial maxima, then thread 0 folds
// them (max is exact, so the order does not change the value).
QPN_SCREEN_HD void screen_lane_store(const ScreenLane& L, const ScreenBatch& bt,
                                     size_t b, int tid, int nthr) {
    float acc = 0.0f;
    for (int r = tid; r < L.m; r += nthr) {
        const float a = L.v[r] < 0.0f ? -L.v[r] : L.v[r];
        acc = screen_nanmax(acc, a);
    }
    L.red[tid] = acc;
    for (int j = tid; j < L.n; j += nthr) bt.x_out[b * L.n + j] = L.x[j];
    QPN_SCREEN_SYNC();
    if (tid == 0) {
        float vmax = L.red[0];
        for (int t = 1; t < nthr; ++t) vmax = screen_nanmax(vmax, L.red[t]);
        bt.v_out[b] = vmax;
    }
}

}  // namespace qpn

// The C interface's parameter list and the batch built from it.
#define QPN_SCREEN_PARAMS                                                  \
    const float *A, const float *l, const float *u, const float *x0,      \
        float *x_out, float *v_out, int B, int m, int n, int steps, float lr
#define QPN_SCREEN_BATCH \
    qpn::ScreenBatch{A, l, u, x0, x_out, v_out, B, m, n, steps, lr}
