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
//     chunk, plain column order (eg_row), whether the lane's M sits in one
//     block's shared memory, is spread over a cluster's, or stays in device
//     memory (eg_instance picks).
// Floating-point addition commutes, so every thread of a group ends the
// butterfly with the same bits, and the loop reproduces them.
//
// Ranks (the cluster instance; R = 1 elsewhere).  Rank k of R holds a band
// of nb = ceil(n / R) rows of M, k·nb onwards, with their q, l and u, and
// a copy of the whole z and z½.  A half-step computes the band's rows of
// the new vector from this rank's copy of the old one and writes each new
// entry into every rank's copy (eg_put: distributed shared memory on the
// card); one barrier of the ranks follows.  Between two barriers no rank
// reads what another writes: the first half-step reads z and writes z½,
// the second reads z½ and the band's own rows of z, writes z, and each row
// of z is written by its band's rank only.  So the host's emulation, each
// half-step run for rank 0, 1, ..., R-1 in turn, gives the card's bits.
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

#if defined(__CUDACC__)
#include <cooperative_groups.h>
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

// One lane's working set, or one rank's part of it.  In the shared instance
// all of it sits in shared memory, the rows of M ld = n | 1 floats apart (an
// odd stride puts the rows that neighbouring threads read on different
// banks); in the cluster instance each rank's part does.  In the global
// instance, for lanes whose M fits no cluster, M stays where the batch
// holds it in device memory (ld = n) and is read every half-step; q, l, u,
// z and z½ sit in shared memory.  The sums read M through `M` either way.
struct EGLane {
    int n, ld;
    int R, rank;     // ranks of the lane, and this one
    int nb, r0;      // rows a band, ceil(n / R); this rank's first row
    int rows;        // this rank's rows: nb, fewer in the last band
    const float* M;  // (nb, ld): rows r0 + [0, rows)
    float* Ms;       // the shared copy of M that eg_lane_load fills, or null
    float* q;        // (nb) the band's rows
    float* l;
    float* u;
    float* z;        // (n) the whole vector
    float* zh;       // (n) z½
    float* const* bases;  // host: each rank's buffer (R > 1)
};

QPN_EG_HD int eg_ld(int n) { return n | 1; }

QPN_EG_HD int eg_band_height(int n, int R) { return (n + R - 1) / R; }

// Floats rounded up to a multiple of 4 (16 bytes).
QPN_EG_HD size_t eg_align4(size_t k) { return (k + 3) & ~size_t(3); }

// Floats of the vectors: z and z½ first, each 16-byte aligned (eg_row reads
// them four at a time), then the band's q, l and u.
QPN_EG_HD size_t eg_vector_floats(int n, int nb) {
    return 2 * eg_align4((size_t)n) + 3 * (size_t)nb;
}

// Shared memory of one rank of a lane whose bands are nb rows high, of the
// shared instance's lane (one band), and of the global one's.
QPN_EG_HD size_t eg_band_bytes(int n, int nb) {
    return (eg_align4((size_t)nb * eg_ld(n)) + eg_vector_floats(n, nb))
           * sizeof(float);
}

QPN_EG_HD size_t eg_lane_bytes(int n) { return eg_band_bytes(n, n); }

QPN_EG_HD size_t eg_global_lane_bytes(int n) {
    return eg_vector_floats(n, n) * sizeof(float);
}

// The vectors from a 16-byte aligned base.
QPN_EG_HD void eg_carve_vectors(EGLane& L, float* base) {
    L.z = base;
    L.zh = L.z + eg_align4((size_t)L.n);
    L.q = L.zh + eg_align4((size_t)L.n);
    L.l = L.q + L.nb;
    L.u = L.l + L.nb;
}

QPN_EG_HD void eg_set_ranks(EGLane& L, int n, int R, int rank,
                            float* const* bases) {
    L.n = n;
    L.R = R;
    L.rank = rank;
    L.nb = eg_band_height(n, R);
    L.r0 = rank * L.nb;
    const int left = n - L.r0;
    L.rows = left < 0 ? 0 : (left < L.nb ? left : L.nb);
    L.bases = bases;
}

// Rank `rank` of R of a lane, carved from a buffer of eg_band_bytes (R = 1:
// the whole lane).  `bases` is the host's table of every rank's buffer,
// read by eg_put where R > 1; null on the card.
QPN_EG_HD EGLane eg_lane_carve(float* base, int n, int R = 1, int rank = 0,
                               float* const* bases = nullptr) {
    EGLane L;
    eg_set_ranks(L, n, R, rank, bases);
    L.ld = eg_ld(n);
    L.Ms = base;
    L.M = base;
    eg_carve_vectors(L, base + eg_align4((size_t)L.nb * L.ld));
    return L;
}

// Lane b of the batch in the global instance: M read in place.
QPN_EG_HD EGLane eg_lane_carve_global(const EGBatch& bt, size_t b,
                                      float* base) {
    EGLane L;
    eg_set_ranks(L, bt.n, 1, 0, nullptr);
    L.ld = bt.n;
    L.Ms = nullptr;
    L.M = bt.M + b * (size_t)bt.n * bt.n;
    eg_carve_vectors(L, base);
    return L;
}

// The kernel that takes rows of n columns: the register kernel where an
// instance of it does (eg_pick_chunk), else the generic kernel with the
// lane in one block's shared memory while eg_lane_bytes(n) fits the
// block's opt-in limit `smem_optin` (232448 bytes on an H100: n up to 238),
// else spread over the shared memory of a cluster of eg_cluster_ranks(n)
// blocks while a band fits the limit at 8 ranks or fewer (8: the portable
// cluster size), else with M in device memory.  A choice by shape alone.
enum { EG_REGISTER = 0, EG_SHARED = 1, EG_GLOBAL = 2, EG_CLUSTER = 3 };
constexpr int kEgMaxRanks = 8;

// The fewest ranks, 2 to kEgMaxRanks, whose bands fit `smem_optin`; 0
// where none does (or the limit is unknown: negative).
QPN_EG_HD int eg_cluster_ranks(int n, long long smem_optin) {
    if (smem_optin < 0) return 0;
    for (int R = 2; R <= kEgMaxRanks; ++R)
        if (eg_band_bytes(n, eg_band_height(n, R)) <= (size_t)smem_optin)
            return R;
    return 0;
}

QPN_EG_HD int eg_instance(int n, long long smem_optin) {
    if (eg_pick_chunk(n) != 0) return EG_REGISTER;
    if (smem_optin < 0) return EG_GLOBAL;
    if (eg_lane_bytes(n) <= (size_t)smem_optin) return EG_SHARED;
    return eg_cluster_ranks(n, smem_optin) != 0 ? EG_CLUSTER : EG_GLOBAL;
}

// The barrier of the lane's ranks: the cluster's where the lane is spread,
// else the block's.
QPN_EG_HD void eg_sync_ranks(const EGLane& L) {
#if defined(__CUDA_ARCH__)
    if (L.R > 1) cooperative_groups::this_cluster().sync();
    else __syncthreads();
#endif
    (void)L;
}

// v into entry r of the vector `x` (a field of this rank's part) of every
// rank.
QPN_EG_HD void eg_put(const EGLane& L, float* x, int r, float v) {
    if (L.R == 1) {
        x[r] = v;
        return;
    }
    for (int k = 0; k < L.R; ++k) {
#if defined(__CUDA_ARCH__)
        cooperative_groups::this_cluster().map_shared_rank(x, k)[r] = v;
#else
        L.bases[k][(x - L.bases[L.rank]) + r] = v;
#endif
    }
}

// Lane b of the batch into this rank's part: its band of M (unless read in
// place), q, l and u, and the whole z.  Ends at a barrier of the ranks, so
// that every rank has started before any writes into another.
QPN_EG_HD void eg_lane_load(const EGLane& L, const EGBatch& bt, size_t b,
                            int tid, int nthr) {
    const int n = L.n;
    const size_t row0 = b * (size_t)n + L.r0;
    const float* Mb = bt.M + row0 * n;
    if (L.Ms != nullptr)
        for (int k = tid; k < L.rows * n; k += nthr)
            L.Ms[(k / n) * L.ld + k % n] = Mb[k];
    for (int i = tid; i < L.rows; i += nthr) {
        L.q[i] = bt.q[row0 + i];
        L.l[i] = bt.l[row0 + i];
        L.u[i] = bt.u[row0 + i];
    }
    for (int i = tid; i < n; i += nthr) L.z[i] = bt.z0[b * n + i];
    eg_sync_ranks(L);
}

// (M x)_i + q_i for row i of the band.  G = 1 is one chunk: the plain
// column order.  On the card x (z or z½, 16-byte aligned) is read four
// entries a load, a quarter of the loads that every warp makes of it; the
// products and sums are the same, in the same order.
template <int G>
QPN_EG_HD float eg_row(const EGLane& L, const float* x, int i, int C) {
    const float* Mi = L.M + (size_t)i * L.ld;
    if (G == 1) {
        float acc = 0.0f;
        int j = 0;
#ifdef __CUDA_ARCH__
        for (; j + 4 <= L.n; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(x + j);
            acc += Mi[j] * v.x;
            acc += Mi[j + 1] * v.y;
            acc += Mi[j + 2] * v.z;
            acc += Mi[j + 3] * v.w;
        }
#endif
        for (; j < L.n; ++j) acc += Mi[j] * x[j];
        return acc + L.q[i];
    }
    return eg_row_sum<G>(Mi, x, L.n, C) + L.q[i];
}

// One half-step of the band, y = Π(z − τ(M x + q)) on its rows, into every
// rank's y.  Thread tid of nthr owns the band's rows tid, tid+nthr, ...
template <int G>
QPN_EG_HD void eg_half_step(const EGLane& L, const float* x, float* y,
                            float tau, int C, int tid, int nthr) {
    for (int i = tid; i < L.rows; i += nthr) {
        const int r = L.r0 + i;
        eg_put(L, y, r, eg_clip(L.z[r] - tau * eg_row<G>(L, x, i, C), L.l[i],
                                L.u[i]));
    }
}

// The steps of one rank of a lane on the card: z½ from z, then z from z½,
// a barrier of the ranks after each.  The host runs the same half-steps
// for each rank in turn (eg_lane_host.cpp).
template <int G>
QPN_EG_HD void eg_lane_run(const EGLane& L, float tau, int steps, int C,
                           int tid, int nthr) {
    for (int s = 0; s < steps; ++s) {
        eg_half_step<G>(L, L.z, L.zh, tau, C, tid, nthr);
        eg_sync_ranks(L);
        eg_half_step<G>(L, L.zh, L.z, tau, C, tid, nthr);
        eg_sync_ranks(L);
    }
}

QPN_EG_HD void eg_lane_store(const EGLane& L, const EGBatch& bt, size_t b,
                             int tid, int nthr) {
    const size_t row0 = b * (size_t)L.n + L.r0;
    for (int i = tid; i < L.rows; i += nthr)
        bt.z_out[row0 + i] = L.z[L.r0 + i];
}

}  // namespace qpn

// The C interface's parameter list and the batch built from it.
#define QPN_EG_PARAMS                                                      \
    const float *M, const float *q, const float *l, const float *u,       \
        const float *z0, const float *tau, float *z_out, int B, int n,    \
        int steps
#define QPN_EG_BATCH qpn::EGBatch{M, q, l, u, z0, tau, z_out, B, n, steps}
