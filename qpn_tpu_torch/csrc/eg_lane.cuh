// Per-lane logic of the fused extragradient warm start for box AVIs
//     M z + q  ⟂  l ≤ z ≤ u,
// shared by the Hopper kernel (eg_warmstart.cu: one thread block per lane)
// and a host instance built with g++ for the CPU tests (eg_lane_host.cpp:
// one "thread", tid 0 of 1).
//
// Each step is Korpelevich's extragradient pair, in f32:
//     z½ = Π[l,u](z − τ(Mz + q)),   z⁺ = Π[l,u](z − τ(Mz½ + q)).
// Thread i owns rows i, i+nthr, ...; a step is two phases separated by
// barriers (QPN_SYNC: __syncthreads() on the card, a no-op on the host):
// phase 1 reads all of z and writes z½ of its rows, phase 2 reads all of z½
// and writes z of its rows.  Every row's dot product runs j = 0..n-1 in
// order, then adds q, as the plain version's (M z) + q does.
//
// The projection is min(max(x, l), u) with NaN passing through, like
// torch.clamp and jnp.clip: a lane that diverges to NaN stays NaN, and the
// caller's residual audit rejects it.  IEEE infinities in l and u are kept.

#pragma once

#include <cstddef>

#if defined(__CUDACC__)
#define QPN_EG_HD __host__ __device__ __forceinline__
#else
#define QPN_EG_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define QPN_EG_SYNC() __syncthreads()
#else
#define QPN_EG_SYNC() ((void)0)
#endif

namespace qpn {

// Batched f32 inputs and output in device (or host) memory, row-major:
// M (B, n, n); q, l, u, z0, z_out (B, n); tau (B,).
struct EGBatch {
    const float* M;
    const float* q;
    const float* l;
    const float* u;
    const float* z0;
    const float* tau;
    float* z_out;
    int B, n, steps;
};

// One lane's working set (shared memory on the card).  The matrix rows are
// ld = n | 1 floats apart: an odd stride puts the rows that neighbouring
// threads read on different banks.
struct EGLane {
    int n, ld;
    float* M;    // (n, ld)
    float* q;    // (n)
    float* l;
    float* u;
    float* z;
    float* zh;   // z½
};

QPN_EG_HD int eg_ld(int n) { return n | 1; }

// Bytes of one lane's working set: about 6.7 KB at n=38.
QPN_EG_HD size_t eg_lane_bytes(int n) {
    return ((size_t)n * eg_ld(n) + 5 * (size_t)n) * sizeof(float);
}

QPN_EG_HD EGLane eg_lane_carve(float* base, int n) {
    EGLane L;
    L.n = n;
    L.ld = eg_ld(n);
    L.M = base;
    L.q = L.M + (size_t)n * L.ld;
    L.l = L.q + n;
    L.u = L.l + n;
    L.z = L.u + n;
    L.zh = L.z + n;
    return L;
}

QPN_EG_HD float eg_clip(float x, float lo, float hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

QPN_EG_HD void eg_lane_load(const EGLane& L, const EGBatch& bt, size_t b,
                            int tid, int nthr) {
    const int n = L.n;
    const float* Mb = bt.M + b * (size_t)n * n;
    for (int k = tid; k < n * n; k += nthr) L.M[(k / n) * L.ld + k % n] = Mb[k];
    for (int i = tid; i < n; i += nthr) {
        L.q[i] = bt.q[b * n + i];
        L.l[i] = bt.l[b * n + i];
        L.u[i] = bt.u[b * n + i];
        L.z[i] = bt.z0[b * n + i];
    }
    QPN_EG_SYNC();
}

// (M x)_i + q_i for row i, summed in column order.
QPN_EG_HD float eg_row(const EGLane& L, const float* x, int i) {
    const float* Mi = L.M + (size_t)i * L.ld;
    float acc = 0.0f;
    for (int j = 0; j < L.n; ++j) acc += Mi[j] * x[j];
    return acc + L.q[i];
}

QPN_EG_HD void eg_lane_run(const EGLane& L, float tau, int steps, int tid,
                           int nthr) {
    const int n = L.n;
    for (int s = 0; s < steps; ++s) {
        for (int i = tid; i < n; i += nthr)
            L.zh[i] = eg_clip(L.z[i] - tau * eg_row(L, L.z, i), L.l[i], L.u[i]);
        QPN_EG_SYNC();
        for (int i = tid; i < n; i += nthr)
            L.z[i] = eg_clip(L.z[i] - tau * eg_row(L, L.zh, i), L.l[i], L.u[i]);
        QPN_EG_SYNC();
    }
}

QPN_EG_HD void eg_lane_store(const EGLane& L, const EGBatch& bt, size_t b,
                             int tid, int nthr) {
    for (int i = tid; i < L.n; i += nthr) bt.z_out[b * L.n + i] = L.z[i];
}

}  // namespace qpn

// The C interface's parameter list and the batch built from it.
#define QPN_EG_PARAMS                                                      \
    const float *M, const float *q, const float *l, const float *u,       \
        const float *z0, const float *tau, float *z_out, int B, int n,    \
        int steps
#define QPN_EG_BATCH qpn::EGBatch{M, q, l, u, z0, tau, z_out, B, n, steps}
