// Per-lane logic of the fused extragradient warm start for box AVIs
//     M z + q  ⟂  l ≤ z ≤ u,
// shared by the Hopper kernels (eg_warmstart.cu) and a host instance built
// with g++ for the CPU tests (eg_lane_host.cpp).
//
// Each step is Korpelevich's extragradient pair, in f32:
//     z½ = Π[l,u](z − τ(Mz + q)),   z⁺ = Π[l,u](z − τ(Mz½ + q)).
//
// The order of every row's sum (M x)_i is defined here, once, by a
// partition (G, C): the row's columns are cut into G chunks of C
// neighbouring columns (G·C ≥ n, the tail padded with zeros); chunk g is
// summed in column order from 0, and the G partial sums are joined by a
// butterfly, p_g ← p_g + p_{g xor o} for o = G/2, ..., 1.  Then q_i is
// added.  Two bodies walk that order:
//   * eg_chunk<C> + eg_tree<G>: the register kernel.  A group of G
//     neighbouring threads of one warp owns the row; each holds its chunk
//     of the row in registers for all steps, reads z from shared memory
//     and joins with xor shuffles;
//   * eg_row_sum: a loop over the same partition and the same butterfly,
//     for the host instance.  The generic kernels' partition is (1, n): one
//     chunk, plain column order (eg_row), whether the lane's M sits in
//     shared memory or stays in device memory (eg_instance picks).
// Floating-point addition commutes, so every thread of a group ends the
// butterfly with the same bits, and the loop reproduces them.
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

// Threads that share a row in the register kernel.
constexpr int kEgGroup = 4;

// The chunk length C of the register kernel's instance for rows of n
// columns: the smallest instantiated C with kEgGroup·C ≥ n, or 0 where there
// is none (n beyond the instances: the generic kernel, whose partition is
// (1, n)).
QPN_EG_HD int eg_pick_chunk(int n) {
    return n <= 16 ? 4 : n <= 40 ? 10 : n <= 64 ? 16 : n <= 128 ? 32 : 0;
}

QPN_EG_HD float eg_clip(float x, float lo, float hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// One chunk's partial sum from registers: m and x hold the chunk's C
// entries of the row and of the vector.
template <int C>
QPN_EG_HD float eg_chunk(const float (&m)[C], const float (&x)[C]) {
    float acc = 0.0f;
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int k = 0; k < C; ++k) acc = acc + m[k] * x[k];
    return acc;
}

#if defined(__CUDACC__)
// The butterfly over a group of G neighbouring threads of a warp.
template <int G>
__device__ __forceinline__ float eg_tree(float acc) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
        acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
    return acc;
}
#endif

// (M x)_i for one row under the partition (G, C), as a loop: the chunks in
// column order, then the same butterfly on the array of partial sums.
template <int G>
QPN_EG_HD float eg_row_sum(const float* Mi, const float* x, int n, int C) {
    float part[G], next[G];
    for (int g = 0; g < G; ++g) {
        float acc = 0.0f;
        for (int k = 0; k < C; ++k) {
            const int j = g * C + k;
            acc = acc + (j < n ? Mi[j] : 0.0f) * (j < n ? x[j] : 0.0f);
        }
        part[g] = acc;
    }
    for (int o = G / 2; o > 0; o >>= 1) {
        for (int g = 0; g < G; ++g) next[g] = part[g] + part[g ^ o];
        for (int g = 0; g < G; ++g) part[g] = next[g];
    }
    return part[0];
}

// ---- the lane in memory: the generic kernels and the host instance ------

// One lane's working set.  In the shared instance all of it sits in shared
// memory, the rows of M ld = n | 1 floats apart (an odd stride puts the rows
// that neighbouring threads read on different banks).  In the global
// instance, for lanes whose M does not fit, M stays where the batch holds it
// in device memory (ld = n) and is read every half-step; q, l, u, z and z½
// sit in shared memory.  The sums read M through `M` either way.
struct EGLane {
    int n, ld;
    const float* M;  // (n, ld)
    float* Ms;       // the shared copy of M that eg_lane_load fills, or null
    float* q;        // (n)
    float* l;
    float* u;
    float* z;
    float* zh;       // z½
};

QPN_EG_HD int eg_ld(int n) { return n | 1; }

// Shared memory of the shared instance's lane, and of the global one's.
QPN_EG_HD size_t eg_lane_bytes(int n) {
    return ((size_t)n * eg_ld(n) + 5 * (size_t)n) * sizeof(float);
}

QPN_EG_HD size_t eg_global_lane_bytes(int n) {
    return 5 * (size_t)n * sizeof(float);
}

QPN_EG_HD void eg_carve_vectors(EGLane& L, float* base) {
    L.q = base;
    L.l = L.q + L.n;
    L.u = L.l + L.n;
    L.z = L.u + L.n;
    L.zh = L.z + L.n;
}

QPN_EG_HD EGLane eg_lane_carve(float* base, int n) {
    EGLane L;
    L.n = n;
    L.ld = eg_ld(n);
    L.Ms = base;
    L.M = base;
    eg_carve_vectors(L, base + (size_t)n * L.ld);
    return L;
}

// Lane b of the batch in the global instance: M read in place.
QPN_EG_HD EGLane eg_lane_carve_global(const EGBatch& bt, size_t b,
                                      float* base) {
    EGLane L;
    L.n = bt.n;
    L.ld = bt.n;
    L.Ms = nullptr;
    L.M = bt.M + b * (size_t)bt.n * bt.n;
    eg_carve_vectors(L, base);
    return L;
}

// The kernel that takes rows of n columns: the register kernel where an
// instance of it does (eg_pick_chunk), else the generic kernel with the
// lane in shared memory while eg_lane_bytes(n) fits the block's opt-in
// limit `smem_optin` (232448 bytes on an H100: n up to 238), else the
// generic kernel with M in device memory.  A choice by shape alone.
enum { EG_REGISTER = 0, EG_SHARED = 1, EG_GLOBAL = 2 };

QPN_EG_HD int eg_instance(int n, long long smem_optin) {
    if (eg_pick_chunk(n) != 0) return EG_REGISTER;
    return smem_optin >= 0 && eg_lane_bytes(n) <= (size_t)smem_optin
               ? EG_SHARED
               : EG_GLOBAL;
}

QPN_EG_HD void eg_lane_load(const EGLane& L, const EGBatch& bt, size_t b,
                            int tid, int nthr) {
    const int n = L.n;
    const float* Mb = bt.M + b * (size_t)n * n;
    if (L.Ms != nullptr)
        for (int k = tid; k < n * n; k += nthr)
            L.Ms[(k / n) * L.ld + k % n] = Mb[k];
    for (int i = tid; i < n; i += nthr) {
        L.q[i] = bt.q[b * n + i];
        L.l[i] = bt.l[b * n + i];
        L.u[i] = bt.u[b * n + i];
        L.z[i] = bt.z0[b * n + i];
    }
    QPN_EG_SYNC();
}

// Thread tid of nthr owns rows tid, tid+nthr, ...; a step is two phases
// separated by barriers: z½ from z, then z from z½.
// (M x)_i + q_i for row i of the lane in memory.  G = 1 is one chunk: the
// plain column order.
template <int G>
QPN_EG_HD float eg_row(const EGLane& L, const float* x, int i, int C) {
    const float* Mi = L.M + (size_t)i * L.ld;
    if (G == 1) {
        float acc = 0.0f;
        for (int j = 0; j < L.n; ++j) acc += Mi[j] * x[j];
        return acc + L.q[i];
    }
    return eg_row_sum<G>(Mi, x, L.n, C) + L.q[i];
}

template <int G>
QPN_EG_HD void eg_lane_run(const EGLane& L, float tau, int steps, int C,
                           int tid, int nthr) {
    const int n = L.n;
    for (int s = 0; s < steps; ++s) {
        for (int i = tid; i < n; i += nthr)
            L.zh[i] = eg_clip(L.z[i] - tau * eg_row<G>(L, L.z, i, C), L.l[i],
                              L.u[i]);
        QPN_EG_SYNC();
        for (int i = tid; i < n; i += nthr)
            L.z[i] = eg_clip(L.z[i] - tau * eg_row<G>(L, L.zh, i, C), L.l[i],
                             L.u[i]);
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
