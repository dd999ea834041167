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
// The order of both sums is the same in every instance below, so they all
// give the same bits.
//
// Four instances, picked from the shape alone (screen_instance):
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
// * the shared instance: one thread block per polyhedron, A, l, u, v and x
//   in shared memory, a thread per row in phase 1 and per column in phase
//   2, a block barrier after each phase.
// * the cluster instance, where A does not fit one block's shared memory
//   but fits R = 2-8 blocks' (screen_cluster_ranks): one polyhedron on a
//   thread-block cluster.  Rank k holds a band of rows, k·ceil(m/R)
//   onwards (phase 1), and a band of columns, k·ceil(n/R) onwards, for all
//   m rows (phase 2), stored by columns, so A is on chip twice; and a copy
//   of the whole v and x.  Each phase writes every new entry into every rank's copy
//   (distributed shared memory) and ends at one cluster barrier.  Between
//   two barriers no rank reads what another writes: phase 1 reads x and
//   writes v, phase 2 reads v and its own columns of x and writes those
//   columns.  So the host's emulation, each phase run for rank 0, 1, ...,
//   R-1 in turn on R buffers, gives the card's bits.
// * the global instance, past the cluster's reach: one block per
//   polyhedron with l, u, v and x in shared memory and A in device memory.
//   Phase 2 reads A in place (a warp reads neighbouring columns of one
//   row); phase 1 reads a column-major copy of A that the block writes at
//   its start (a warp reads neighbouring rows of one column).
// The phase functions run on the card with one thread per row (column), or
// on the host as thread 0 of 1 with the barriers as no-ops.
//
// max and min propagate NaN, as jnp.maximum / jnp.minimum and torch do
// (fmaxf/fminf would drop it and could turn a diverged polyhedron into a
// witness).  IEEE infinities in l and u stand for missing bounds.

#pragma once

#include <cstddef>

#if defined(__CUDACC__)
#define QPN_SCREEN_HD __host__ __device__ __forceinline__
#include <cooperative_groups.h>
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

// One polyhedron's working set, or one rank's part of it (the cluster
// instance; R = 1, rank 0 elsewhere).  Phase 1 reads entry (r0 + i, j) of
// A at Ar[i · ld + j · cs] and phase 2 entry (r, c0 + k) at
// Ac[r · lc + k · cc]: in the shared instance both point at one copy whose
// rows are ld = n | 1 floats apart (the odd stride puts the rows that
// neighbouring threads read in phase 1 on different banks, while phase 2's
// threads read neighbouring columns of one row); in the cluster instance
// at the rank's row band (rows n | 1 floats apart) and column band, stored
// by columns m | 1 floats apart (phase 2's threads read one row's
// neighbouring columns on different banks, each walking its own column
// with unit stride); in the global instance at the column-major copy (ld =
// 1, cs = m) and at A in place (lc = n, cc = 1).
struct ScreenLane {
    int m, n;
    int R, rank;       // ranks of the polyhedron, and this one
    int r0, rows;      // this rank's rows: phase 1 gives their v
    int c0, cols;      // this rank's columns: phase 2 updates their x
    const float* Ar;   // phase 1's A
    int ld, cs;
    const float* Ac;   // phase 2's A
    int lc, cc;
    float* As;         // the row band that screen_lane_load fills, or null
    float* Acs;        // the column band that screen_lane_load fills, or null
    float* At;         // the column-major copy that screen_lane_load fills
    bool vec;          // x and v 16-byte aligned (read 4 a load on the card)
    bool dev;          // A in device memory (the global instance)
    float* l;          // (rows) bounds of this rank's rows
    float* u;
    float* v;          // (m) signed violation
    float* x;          // (n)
    float* red;        // (nthr) partial maxima of |v|
    float* const* bases;  // host: each rank's buffer (cluster instance)
};

QPN_SCREEN_HD int screen_ld(int n) { return n | 1; }

// Floats rounded up to a multiple of 4 (16 bytes).
QPN_SCREEN_HD size_t screen_align4(size_t k) { return (k + 3) & ~size_t(3); }

QPN_SCREEN_HD int screen_band(int k, int R) { return (k + R - 1) / R; }

QPN_SCREEN_HD int screen_round_threads(int work, int most) {
    const int threads = (work + 31) / 32 * 32;
    return threads > most ? most : threads;
}

// Threads of the shared instance's block: a row (then a column) each, up
// to 256.
QPN_SCREEN_HD int screen_block_threads(int m, int n) {
    return screen_round_threads(m > n ? m : n, 256);
}

// The global and the cluster instances' ceilings of threads a block (the
// cluster's lower, so that nvcc may give a thread the registers its two
// stages of loads in flight need: a bound of 1024 threads caps a thread at
// 64).
constexpr int kScreenWideThreads = 1024;
constexpr int kScreenClusterThreads = 512;
// The cluster's largest size: the portable one.
constexpr int kScreenMaxRanks = 8;

// Threads of a global block (a row, then a column each, up to 1024) and
// of a cluster's rank (a row of its row band, then a column of its column
// band, up to 512).
QPN_SCREEN_HD int screen_global_threads(int m, int n) {
    return screen_round_threads(m > n ? m : n, kScreenWideThreads);
}

QPN_SCREEN_HD int screen_cluster_threads(int m, int n, int R) {
    const int nb = screen_band(m, R), nc = screen_band(n, R);
    return screen_round_threads(nb > nc ? nb : nc, kScreenClusterThreads);
}

// Bytes of one polyhedron's working set in the shared instance with `nthr`
// threads: about 1.9 KB at robust_avoid's piece shape (18 rows, dimension
// 18, 32 threads).
QPN_SCREEN_HD size_t screen_lane_bytes(int m, int n, int nthr) {
    return ((size_t)m * screen_ld(n) + 3 * (size_t)m + (size_t)n
            + (size_t)nthr) * sizeof(float);
}

// The vectors of the cluster and global instances, from a 16-byte aligned
// base: x and v first, each aligned, then the bands of A (cluster: `band`
// floats), then l and u for `rows` rows and the nthr partial maxima.
QPN_SCREEN_HD size_t screen_wide_floats(int m, int n, size_t band, int rows,
                                        int nthr) {
    return screen_align4((size_t)n) + screen_align4((size_t)m) + band
           + 2 * (size_t)rows + (size_t)nthr;
}

// Floats of the cluster's bands at rank k of R: rows of n | 1 floats, then
// the columns of the column band, m | 1 floats each.
QPN_SCREEN_HD size_t screen_band_floats(int m, int n, int R) {
    return screen_align4((size_t)screen_band(m, R) * screen_ld(n))
           + screen_align4((size_t)screen_band(n, R) * screen_ld(m));
}

// Bytes of a rank of the cluster instance at R ranks (170472 at R = 3 for
// 260 rows in dimension 240), and of a global block (all but A).
QPN_SCREEN_HD size_t screen_cluster_bytes(int m, int n, int R) {
    return screen_wide_floats(m, n, screen_band_floats(m, n, R),
                              screen_band(m, R),
                              screen_cluster_threads(m, n, R))
           * sizeof(float);
}

QPN_SCREEN_HD size_t screen_global_lane_bytes(int m, int n, int nthr) {
    return screen_wide_floats(m, n, 0, m, nthr) * sizeof(float);
}

QPN_SCREEN_HD void screen_set_ranks(ScreenLane& L, int m, int n, int R,
                                    int rank, float* const* bases) {
    L.m = m;
    L.n = n;
    L.R = R;
    L.rank = rank;
    const int nb = screen_band(m, R), nc = screen_band(n, R);
    L.r0 = rank * nb;
    L.c0 = rank * nc;
    const int rows = m - L.r0, cols = n - L.c0;
    L.rows = rows < 0 ? 0 : (rows < nb ? rows : nb);
    L.cols = cols < 0 ? 0 : (cols < nc ? cols : nc);
    L.As = L.Acs = L.At = nullptr;
    L.bases = bases;
}

// x, v, then `band` floats for the bands, then l, u and the partial maxima.
QPN_SCREEN_HD void screen_carve_wide(ScreenLane& L, float* base,
                                     size_t band) {
    L.vec = true;
    L.dev = band == 0;
    L.x = base;
    L.v = L.x + screen_align4((size_t)L.n);
    float* bands = L.v + screen_align4((size_t)L.m);
    if (band != 0) {
        L.As = bands;
        L.Acs = bands + screen_align4((size_t)screen_band(L.m, L.R)
                                      * screen_ld(L.n));
    }
    L.l = bands + band;
    L.u = L.l + screen_band(L.m, L.R);
    L.red = L.u + screen_band(L.m, L.R);
}

// The shared instance, from a buffer of screen_lane_bytes.
QPN_SCREEN_HD ScreenLane screen_lane_carve(float* base, int m, int n) {
    ScreenLane L;
    screen_set_ranks(L, m, n, 1, 0, nullptr);
    L.ld = L.lc = screen_ld(n);
    L.cs = L.cc = 1;
    L.As = base;
    L.Ar = L.Ac = base;
    L.vec = L.dev = false;
    L.l = base + (size_t)m * L.ld;
    L.u = L.l + m;
    L.v = L.u + m;
    L.x = L.v + m;
    L.red = L.x + n;
    return L;
}

// Rank `rank` of R of the cluster instance, from a buffer of
// screen_cluster_bytes.  `bases` is the host's table of every rank's
// buffer; null on the card.
QPN_SCREEN_HD ScreenLane screen_lane_carve_cluster(float* base, int m, int n,
                                                   int R, int rank,
                                                   float* const* bases) {
    ScreenLane L;
    screen_set_ranks(L, m, n, R, rank, bases);
    screen_carve_wide(L, base, screen_band_floats(m, n, R));
    L.Ar = L.As;
    L.ld = screen_ld(n);
    L.cs = 1;
    L.Ac = L.Acs;
    L.lc = 1;
    L.cc = screen_ld(m);
    return L;
}

// Polyhedron b of the batch in the global instance, from a buffer of
// screen_global_lane_bytes: A read in place in phase 2, and in phase 1
// from `at`, the polyhedron's column-major copy (m · n floats of device
// memory: entry (r, j) at at[j · m + r]).
QPN_SCREEN_HD ScreenLane screen_lane_carve_global(const ScreenBatch& bt,
                                                  size_t b, float* base,
                                                  float* at) {
    ScreenLane L;
    screen_set_ranks(L, bt.m, bt.n, 1, 0, nullptr);
    screen_carve_wide(L, base, 0);
    L.At = at;
    L.Ar = at;
    L.ld = 1;
    L.cs = bt.m;
    L.Ac = bt.A + b * (size_t)bt.m * bt.n;
    L.lc = bt.n;
    L.cc = 1;
    return L;
}

QPN_SCREEN_HD float screen_nanmax(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

QPN_SCREEN_HD float screen_nanmin(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// The barrier of the polyhedron's ranks: the cluster's where it is spread
// over one, else the block's.
QPN_SCREEN_HD void screen_sync_ranks(const ScreenLane& L) {
#if defined(__CUDA_ARCH__)
    if (L.R > 1) cooperative_groups::this_cluster().sync();
    else __syncthreads();
#else
    (void)L;
#endif
}

// val into entry `idx` of the vector `y` (L.v or L.x) of every rank.
QPN_SCREEN_HD void screen_put(const ScreenLane& L, float* y, int idx,
                              float val) {
    if (L.R == 1) {
        y[idx] = val;
        return;
    }
    for (int k = 0; k < L.R; ++k) {
#if defined(__CUDA_ARCH__)
        cooperative_groups::this_cluster().map_shared_rank(y, k)[idx] = val;
#else
        L.bases[k][(y - L.bases[L.rank]) + idx] = val;
#endif
    }
}

// dst[i · dld + j] = src[i · sld + j · scs] for i < rows, j < cols: the
// warps over i, a warp's lanes over neighbouring j (thread 0 of 1 on the
// host: all of it); src in device memory.  On the card the copy is bound
// by the latency of device memory, so it keeps many loads in flight: into
// shared memory (SMEM) as asynchronous copies (cp.async), all issued
// before one wait, else kScreenCopyBatch loads a lane before it stores
// them.
constexpr int kScreenCopyBatch = 8;

template <bool SMEM>
QPN_SCREEN_HD void screen_copy(float* dst, size_t dld, const float* src,
                               size_t sld, size_t scs, int rows, int cols,
                               int tid, int nthr) {
    const int lanes = nthr < 32 ? nthr : 32;
    const int lane = tid % lanes, warp = tid / lanes, warps = nthr / lanes;
    for (int i = warp; i < rows; i += warps) {
        const float* s = src + (size_t)i * sld;
        float* d = dst + (size_t)i * dld;
        int j = lane;
#if defined(__CUDA_ARCH__)
        if (SMEM) {
            for (; j < cols; j += lanes)
                asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                                 (unsigned)__cvta_generic_to_shared(d + j)),
                             "l"(s + (size_t)j * scs)
                             : "memory");
            continue;
        }
        constexpr int U = kScreenCopyBatch;
        for (; j + (U - 1) * lanes < cols; j += U * lanes) {
            float val[U];
#pragma unroll
            for (int q = 0; q < U; ++q) val[q] = s[(size_t)(j + q * lanes) * scs];
#pragma unroll
            for (int q = 0; q < U; ++q) d[j + q * lanes] = val[q];
        }
#endif
        for (; j < cols; j += lanes) d[j] = s[(size_t)j * scs];
    }
#if defined(__CUDA_ARCH__)
    if (SMEM) asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// Polyhedron b of the batch into this rank's part: A's bands or copies,
// this rank's l and u, the whole x.  Ends at a barrier of the ranks, so
// that every rank has started before any writes into another.
QPN_SCREEN_HD void screen_lane_load(const ScreenLane& L, const ScreenBatch& bt,
                                    size_t b, int tid, int nthr) {
    const int m = L.m, n = L.n;
    const float* Ab = bt.A + b * (size_t)m * n;
    if (L.As != nullptr)
        screen_copy<true>(L.As, L.ld, Ab + (size_t)L.r0 * n, n, 1, L.rows, n,
                          tid, nthr);
    // the column band and the column-major copy hold A's columns as rows
    // (a warp writes neighbouring entries of one column; its reads of A's
    // rows meet in the L1)
    if (L.Acs != nullptr)
        screen_copy<true>(L.Acs, L.cc, Ab + L.c0, 1, n, L.cols, m, tid, nthr);
    if (L.At != nullptr)
        screen_copy<false>(L.At, m, Ab, 1, n, n, m, tid, nthr);
    for (int i = tid; i < L.rows; i += nthr) {
        L.l[i] = bt.l[b * m + L.r0 + i];
        L.u[i] = bt.u[b * m + L.r0 + i];
    }
    for (int j = tid; j < n; j += nthr) L.x[j] = bt.x0[b * n + j];
    screen_sync_ranks(L);
}

// Entries of A a thread loads ahead of its sum on the card: from shared
// memory (the shared and cluster instances: two stages in flight cover
// the loads' latency) and from device memory (the global instance: one
// large stage keeps enough bytes in flight to stream A from L2).
constexpr int kScreenStageShared = 16;
constexpr int kScreenStageGlobal = 64;

#if defined(__CUDA_ARCH__)
// Entries k, ..., k+S-1 of a (every s-th float) and of y into registers, y
// four entries a load where it is 16-byte aligned (Y4).
template <bool Y4, int S>
__device__ __forceinline__ void screen_stage_load(float (&av)[S], float (&yv)[S],
                                                  const float* a, size_t s,
                                                  const float* y, int k) {
#pragma unroll
    for (int t = 0; t < S; ++t) av[t] = a[(size_t)(k + t) * s];
    if (Y4) {
#pragma unroll
        for (int t = 0; t < S; t += 4) {
            const float4 q = *reinterpret_cast<const float4*>(y + k + t);
            yv[t] = q.x;
            yv[t + 1] = q.y;
            yv[t + 2] = q.z;
            yv[t + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int t = 0; t < S; ++t) yv[t] = y[k + t];
    }
}

template <int S>
__device__ __forceinline__ float screen_stage_sum(float acc, const float (&av)[S],
                                                  const float (&yv)[S]) {
#pragma unroll
    for (int t = 0; t < S; ++t) acc += av[t] * yv[t];
    return acc;
}

// acc + Σ_t av[t] · y[k + t] over t = 0, ..., S-1 in order, y read four
// entries a load where it is 16-byte aligned (Y4).
template <bool Y4, int S>
__device__ __forceinline__ float screen_stage_sum_y(float acc,
                                                    const float (&av)[S],
                                                    const float* y, int k) {
    if (Y4) {
#pragma unroll
        for (int t = 0; t < S; t += 4) {
            const float4 q = *reinterpret_cast<const float4*>(y + k + t);
            acc += av[t] * q.x;
            acc += av[t + 1] * q.y;
            acc += av[t + 2] * q.z;
            acc += av[t + 3] * q.w;
        }
    } else {
#pragma unroll
        for (int t = 0; t < S; ++t) acc += av[t] * y[k + t];
    }
    return acc;
}

// The stages of a dot product that fit [0, len), from k = 0; k ends after
// the last.  From shared memory (DEV false) two stages of a and y are in
// flight: the next is loaded while the last is summed, so the loads'
// latency hides behind the chain of adds.  From device memory one stage
// of S entries of a is in flight at a time, S large, so that the warps of
// an SM keep enough bytes in flight to stream A from L2.
template <bool Y4, bool DEV, int S>
__device__ __forceinline__ float screen_dot_stages(const float* a, size_t s,
                                                   const float* y, int len,
                                                   int& k) {
    float acc = 0.0f;
    float a0[S];
    if (DEV) {
        for (; k + S <= len; k += S) {
#pragma unroll
            for (int t = 0; t < S; ++t) a0[t] = a[(size_t)(k + t) * s];
            acc = screen_stage_sum_y<Y4, S>(acc, a0, y, k);
        }
        return acc;
    }
    float y0[S], a1[S], y1[S];
    if (len >= S) screen_stage_load<Y4, S>(a0, y0, a, s, y, 0);
    for (; k + 2 * S <= len; k += 2 * S) {
        screen_stage_load<Y4, S>(a1, y1, a, s, y, k + S);
        acc = screen_stage_sum<S>(acc, a0, y0);
        if (k + 3 * S <= len)
            screen_stage_load<Y4, S>(a0, y0, a, s, y, k + 2 * S);
        acc = screen_stage_sum<S>(acc, a1, y1);
    }
    if (k + S <= len) {
        acc = screen_stage_sum<S>(acc, a0, y0);
        k += S;
    }
    return acc;
}
#endif

// Σ_k a[k · s] · y[k] over k = 0, ..., len-1 in order: on the card the
// stages above (the products and sums the same, in the same order), then
// the entries left one at a time.  Y4: y is 16-byte aligned; DEV: a lies in
// device memory.
template <bool Y4, bool DEV>
QPN_SCREEN_HD float screen_dot(const float* a, size_t s, const float* y,
                               int len) {
    float acc = 0.0f;
    int k = 0;
#if defined(__CUDA_ARCH__)
    acc = screen_dot_stages<Y4, DEV,
                            DEV ? kScreenStageGlobal : kScreenStageShared>(
        a, s, y, len, k);
#endif
    for (; k < len; ++k) acc += a[(size_t)k * s] * y[k];
    return acc;
}

QPN_SCREEN_HD float screen_lane_dot(const ScreenLane& L, const float* a,
                                    size_t s, const float* y, int len) {
    if (L.dev) return screen_dot<true, true>(a, s, y, len);
    return L.vec ? screen_dot<true, false>(a, s, y, len)
                 : screen_dot<false, false>(a, s, y, len);
}

// Phase 1: v_r for the rank's rows, into every rank's v.
QPN_SCREEN_HD void screen_violation(const ScreenLane& L, int tid, int nthr) {
    for (int i = tid; i < L.rows; i += nthr) {
        const float ax = screen_lane_dot(L, L.Ar + (size_t)i * L.ld, L.cs,
                                         L.x, L.n);
        screen_put(L, L.v, L.r0 + i,
                   screen_nanmax(L.l[i] - ax, 0.0f)
                   + screen_nanmin(L.u[i] - ax, 0.0f));
    }
    screen_sync_ranks(L);
}

// Phase 2: x_j += lr · Σ_r A_rj v_r for the rank's columns, into every
// rank's x.
QPN_SCREEN_HD void screen_update(const ScreenLane& L, float lr, int tid,
                                 int nthr) {
    for (int k = tid; k < L.cols; k += nthr) {
        const int j = L.c0 + k;
        const float g = screen_lane_dot(L, L.Ac + (size_t)k * L.cc,
                                        (size_t)L.lc, L.v, L.m);
        screen_put(L, L.x, j, L.x[j] + lr * g);
    }
    screen_sync_ranks(L);
}

// The steps of one rank on the card (the host runs the same phases for
// each rank in turn: screen_lane_host.cpp).
QPN_SCREEN_HD void screen_lane_run(const ScreenLane& L, int steps, float lr,
                                   int tid, int nthr) {
    for (int s = 0; s < steps; ++s) {
        screen_violation(L, tid, nthr);
        screen_update(L, lr, tid, nthr);
    }
    screen_violation(L, tid, nthr);
}

// x and max |v| from rank 0's copies: per-thread partial maxima, then
// thread 0 folds them (max is exact, so the order does not change the
// value).  The other ranks store nothing.
QPN_SCREEN_HD void screen_lane_store(const ScreenLane& L, const ScreenBatch& bt,
                                     size_t b, int tid, int nthr) {
    if (L.rank != 0) return;
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
// n: the warp instance where it fits, else the shared instance while
// screen_lane_bytes fits the block's opt-in limit `smem_optin` (232448
// bytes on an H100: m = n up to 238), else the cluster instance while a
// rank of at most 8 fits it (m = n up to 473), else the global instance.
// A choice by shape alone; a limit that could not be read (negative) fits
// nothing.
enum { SCREEN_WARP = 0, SCREEN_SHARED = 1, SCREEN_GLOBAL = 2,
       SCREEN_CLUSTER = 3 };

// The fewest ranks, 2 to kScreenMaxRanks, whose parts fit `smem_optin`; 0
// where none does (or the limit is unknown: negative).
QPN_SCREEN_HD int screen_cluster_ranks(int m, int n, long long smem_optin) {
    if (smem_optin < 0) return 0;
    for (int R = 2; R <= kScreenMaxRanks; ++R)
        if (screen_cluster_bytes(m, n, R) <= (size_t)smem_optin) return R;
    return 0;
}

QPN_SCREEN_HD int screen_instance(int m, int n, long long smem_optin) {
    if (screen_fits_warp(m, n)) return SCREEN_WARP;
    if (smem_optin < 0) return SCREEN_GLOBAL;
    if (screen_lane_bytes(m, n, screen_block_threads(m, n))
        <= (size_t)smem_optin)
        return SCREEN_SHARED;
    return screen_cluster_ranks(m, n, smem_optin) != 0 ? SCREEN_CLUSTER
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
