// Per-polyhedron logic of the f32 feasibility screen for batches of
// polyhedra  l ≤ A x ≤ u  (A row-normalised by the caller), shared by the
// Hopper kernels (screen.cu) and a host instance built with g++ for the CPU
// tests (screen_lane_host.cpp).
//
// Each of `steps` projected-subgradient steps is
//     v = max(l − Ax, 0) + min(u − Ax, 0),   x ← x + lr · Aᵀv,
// v being the signed violation of each row (positive below l, negative
// above u).  A step is two phases: phase 1 computes (Ax)_r and v_r for each
// row, summing over the columns in order; phase 2 computes
// g_j = Σ_r A_rj v_r over the rows in order and updates x_j.  After the last
// step one more phase 1 gives the final v, and a reduction its max |v|.
// The order of both sums is the same in the two instances below, so they
// give the same bits.
//
// Two instances, picked from the shape alone (screen_instance):
//
// * the warp instance, for max(m, n) ≤ 32: one polyhedron in one warp, A in
//   registers for all steps.  Thread t keeps row t of A (phase 1) and column
//   t of A (phase 2), loaded once, in arrays whose lengths are compile-time
//   ceilings NC ≥ n and MC ≥ m (multiples of 4), so every loop unrolls.  x
//   and v are exchanged through one shared-memory line each, read back as
//   16-byte vectors that every thread loads from the same address (a
//   broadcast).  Entries beyond n and m are zero in A and stay exactly zero
//   in x and v (their threads never write), so each adds +0 at the end of a
//   sum and leaves its bits as they are.  On the host the 32 threads are a
//   loop (ScreenWarpHost).
// * the generic instance, for larger polyhedra: one thread block per
//   polyhedron, A, l, u, v and x in shared memory, a thread per row in phase
//   1 and per column in phase 2, barriers between (QPN_SCREEN_SYNC:
//   __syncthreads() on the card, a no-op for the host's one "thread").
//   Where A does not fit the block's shared memory, the same code reads A in
//   place from device memory (the global instance; l, u, v and x stay in
//   shared memory).  screen_instance picks from the shape alone.
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

// The generic instance.  One polyhedron's working set.  In shared memory
// the rows of A are ld = n | 1 floats apart: the odd stride puts the rows
// that neighbouring threads read in phase 1 on different banks, while phase
// 2's threads read neighbouring columns of one row.  In the global instance
// A stays where the batch holds it (ld = n).  The sums read A through `A`
// either way.
struct ScreenLane {
    int m, n, ld;
    const float* A;  // (m, ld)
    float* As;       // the shared copy of A that screen_lane_load fills, or null
    float* l;        // (m)
    float* u;
    float* v;        // signed violation
    float* x;        // (n)
    float* red;      // (nthr) partial maxima of |v|
};

QPN_SCREEN_HD int screen_ld(int n) { return n | 1; }

// Threads of the generic instance's block: a row (then a column) each, up
// to 256.
QPN_SCREEN_HD int screen_block_threads(int m, int n) {
    const int work = m > n ? m : n;
    const int threads = (work + 31) / 32 * 32;
    return threads > 256 ? 256 : threads;
}

// Bytes of one polyhedron's working set with `nthr` threads: about 1.9 KB
// at robust_avoid's piece shape (18 rows, dimension 18, 32 threads).
QPN_SCREEN_HD size_t screen_lane_bytes(int m, int n, int nthr) {
    return ((size_t)m * screen_ld(n) + 3 * (size_t)m + (size_t)n
            + (size_t)nthr) * sizeof(float);
}

// The same in the global instance: all but A.
QPN_SCREEN_HD size_t screen_global_lane_bytes(int m, int n, int nthr) {
    return (3 * (size_t)m + (size_t)n + (size_t)nthr) * sizeof(float);
}

QPN_SCREEN_HD void screen_carve_vectors(ScreenLane& L, float* base) {
    L.l = base;
    L.u = L.l + L.m;
    L.v = L.u + L.m;
    L.x = L.v + L.m;
    L.red = L.x + L.n;
}

QPN_SCREEN_HD ScreenLane screen_lane_carve(float* base, int m, int n) {
    ScreenLane L;
    L.m = m;
    L.n = n;
    L.ld = screen_ld(n);
    L.As = base;
    L.A = base;
    screen_carve_vectors(L, base + (size_t)m * L.ld);
    return L;
}

// Polyhedron b of the batch in the global instance: A read in place.
QPN_SCREEN_HD ScreenLane screen_lane_carve_global(const ScreenBatch& bt,
                                                  size_t b, float* base) {
    ScreenLane L;
    L.m = bt.m;
    L.n = bt.n;
    L.ld = bt.n;
    L.As = nullptr;
    L.A = bt.A + b * (size_t)bt.m * bt.n;
    screen_carve_vectors(L, base);
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
    if (L.As != nullptr)
        for (int k = tid; k < m * n; k += nthr)
            L.As[(k / n) * L.ld + k % n] = Ab[k];
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


// --------------------------------------------------------------------------
//  The warp instance: one polyhedron in one warp, A in registers.
// --------------------------------------------------------------------------

constexpr int kScreenWarp = 32;     // threads, and the largest m and n

QPN_SCREEN_HD bool screen_fits_warp(int m, int n) {
    return m <= kScreenWarp && n <= kScreenWarp;
}

// The instance the card's launcher runs for polyhedra of m rows in dimension
// n: the warp instance where it fits, else the generic instance with A in
// shared memory while screen_lane_bytes fits the block's opt-in limit
// `smem_optin` (232448 bytes on an H100: m = n up to 238), else the generic
// instance with A in device memory.  A choice by shape alone.
enum { SCREEN_WARP = 0, SCREEN_SHARED = 1, SCREEN_GLOBAL = 2 };

QPN_SCREEN_HD int screen_instance(int m, int n, long long smem_optin) {
    if (screen_fits_warp(m, n)) return SCREEN_WARP;
    const size_t bytes = screen_lane_bytes(m, n, screen_block_threads(m, n));
    return smem_optin >= 0 && bytes <= (size_t)smem_optin ? SCREEN_SHARED
                                                          : SCREEN_GLOBAL;
}

// Index of the compile-time ceiling of k rows or columns: ceilings are 4, 8,
// ..., 32, one 16-byte vector load apart.
QPN_SCREEN_HD int screen_ceiling_index(int k) { return (k + 3) / 4 - 1; }

struct alignas(16) ScreenVec4 {
    float a, b, c, d;
};

// What thread t keeps for all steps.
template <int MC, int NC>
struct ScreenRegs {
    float row[NC];   // A[t][0..n), zeros beyond (all zeros for t >= m)
    float col[MC];   // A[0..m)[t], zeros beyond (all zeros for t >= n)
    float l, u;      // bounds of row t
    float x;         // x_t
};

template <int MC, int NC>
QPN_SCREEN_HD void screen_regs_load(ScreenRegs<MC, NC>& R,
                                    const ScreenBatch& bt, size_t b, int t) {
    const int m = bt.m, n = bt.n;
    const float* Ab = bt.A + b * (size_t)m * n;
#pragma unroll
    for (int j = 0; j < NC; ++j)
        R.row[j] = (t < m && j < n) ? Ab[(size_t)t * n + j] : 0.0f;
#pragma unroll
    for (int r = 0; r < MC; ++r)
        R.col[r] = (r < m && t < n) ? Ab[(size_t)r * n + t] : 0.0f;
    R.l = t < m ? bt.l[b * m + t] : 0.0f;
    R.u = t < m ? bt.u[b * m + t] : 0.0f;
    R.x = t < n ? bt.x0[b * n + t] : 0.0f;
}

// Σ_k a[k] · line[k] over k in order, the line read four entries at a time.
template <int C>
QPN_SCREEN_HD float screen_line_dot(const float (&a)[C],
                                    const ScreenVec4* line) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
        const ScreenVec4 q = line[k];
        acc += a[4 * k] * q.a;
        acc += a[4 * k + 1] * q.b;
        acc += a[4 * k + 2] * q.c;
        acc += a[4 * k + 3] * q.d;
    }
    return acc;
}

// Phase 1 of thread t: v_t from the x line (only threads t < m have a row).
template <int MC, int NC>
QPN_SCREEN_HD float screen_regs_violation(const ScreenRegs<MC, NC>& R,
                                          const ScreenVec4* xline) {
    const float ax = screen_line_dot<NC>(R.row, xline);
    return screen_nanmax(R.l - ax, 0.0f) + screen_nanmin(R.u - ax, 0.0f);
}

// Phase 2 of thread t: x_t += lr · g_t from the v line (threads t < n).
template <int MC, int NC>
QPN_SCREEN_HD void screen_regs_update(ScreenRegs<MC, NC>& R,
                                      const ScreenVec4* vline, float lr) {
    const float g = screen_line_dot<MC>(R.col, vline);
    R.x = R.x + lr * g;
}

QPN_SCREEN_HD float screen_abs(float v) { return v < 0.0f ? -v : v; }

#if !defined(__CUDACC__)
// The warp instance on the host: the 32 threads of one polyhedron as a
// loop, each phase over all threads before the next (what __syncwarp()
// orders on the card).
template <int MC, int NC>
void screen_warp_host(const ScreenBatch& bt) {
    const int m = bt.m, n = bt.n;
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        ScreenRegs<MC, NC> R[kScreenWarp];
        ScreenVec4 vline[MC / 4] = {}, xline[NC / 4] = {};
        float* vf = &vline[0].a;
        float* xf = &xline[0].a;
        for (int t = 0; t < kScreenWarp; ++t) {
            screen_regs_load(R[t], bt, b, t);
            if (t < n) xf[t] = R[t].x;
        }
        for (int s = 0; s <= bt.steps; ++s) {
            for (int t = 0; t < m; ++t)
                vf[t] = screen_regs_violation(R[t], xline);
            if (s == bt.steps) break;
            for (int t = 0; t < n; ++t) {
                screen_regs_update(R[t], vline, bt.lr);
                xf[t] = R[t].x;
            }
        }
        float vmax = 0.0f;
        for (int t = 0; t < m; ++t)
            vmax = screen_nanmax(vmax, screen_abs(vf[t]));
        for (int t = 0; t < n; ++t) bt.x_out[b * n + t] = R[t].x;
        bt.v_out[b] = vmax;
    }
}
#endif

}  // namespace qpn

// The C interface's parameter list and the batch built from it.
#define QPN_SCREEN_PARAMS                                                  \
    const float *A, const float *l, const float *u, const float *x0,      \
        float *x_out, float *v_out, int B, int m, int n, int steps, float lr
#define QPN_SCREEN_BATCH \
    qpn::ScreenBatch{A, l, u, x0, x_out, v_out, B, m, n, steps, lr}

// One entry for each pair of ceilings (MC, NC) of the warp instance, indexed
// [screen_ceiling_index(m)][screen_ceiling_index(n)].
#define QPN_SCREEN_ROW(F, MC)                                              \
    {F<MC, 4>, F<MC, 8>, F<MC, 12>, F<MC, 16>, F<MC, 20>, F<MC, 24>,      \
     F<MC, 28>, F<MC, 32>}
#define QPN_SCREEN_TABLE(F)                                                \
    {QPN_SCREEN_ROW(F, 4), QPN_SCREEN_ROW(F, 8), QPN_SCREEN_ROW(F, 12),   \
     QPN_SCREEN_ROW(F, 16), QPN_SCREEN_ROW(F, 20), QPN_SCREEN_ROW(F, 24), \
     QPN_SCREEN_ROW(F, 28), QPN_SCREEN_ROW(F, 32)}
