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
//     for the host instance.  The generic kernel's partition is (1, n): one
//     chunk, plain column order (eg_row), whether the lane's M is spread
//     over blocks on any SMs or stays in device memory (the global
//     instance).  The block and cluster instances' is (kEgGroup,
//     eg_cluster_chunk(n)), the register kernel's order on rows too long for
//     its instances: a group of G threads on a few rows, each thread holding
//     the first entries of its chunk of each in registers and the rest in
//     shared memory (eg_warmstart.cu).
// Floating-point addition commutes, so every thread of a group ends the
// butterfly with the same bits, and the loop reproduces them.  A chunk's sum
// starts from +0, so it is never -0, and the zeros past column n add
// nothing: the card may skip them.
//
// Ranks (the spread global instance, and the host's emulation of the
// cluster instance, whose kernel keeps its band in registers and writes
// through distributed shared memory itself; R = 1 elsewhere).
// Rank k of R holds a band of nb = ceil(n / R) rows of M, k·nb onwards,
// with their q, l and u, and a copy of the whole z and z½.  A half-step
// computes the band's rows of the new vector from this rank's copy of the
// old one and writes each new entry into every rank's copy (eg_put: the
// host's buffers of the emulated cluster), or, in the global instance, into
// the lane's copy of that vector in device memory, which each rank copies
// into its own after the barrier (eg_gather); one barrier of the ranks
// follows the writes.  Between two barriers no rank reads what another
// writes: the first half-step reads z and writes z½, the second reads z½
// and the band's own rows of z, writes z, and each row of z is written by
// its band's rank only; the device-memory pair is read in the gather after
// one barrier and written again only after the next.  So the host's
// emulation, each half-step run for rank 0, 1, ..., R-1 in turn, gives the
// card's bits.
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

#include "lane_barrier.cuh"

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

// One lane's working set, or one rank's part of it, as the host instance
// carves it: all of it in one buffer, the rows of M ld = n | 1 floats apart
// (an odd stride puts the rows that neighbouring threads read on different
// banks); in the host's emulated cluster each rank's buffer.  In the global
// instance, for lanes whose M fits no cluster, a rank's band of M sits in
// its shared memory where it fits (eg_global_band_fits), else in the lane's
// column-major copy in device memory, which eg_lane_load writes and every
// half-step reads (ld = 1, cs = n: the entries of a column that
// neighbouring threads read lie side by side); q, l, u, z and z½ sit in
// shared memory.  The sums read entry (i, j) of the band at
// M[i · ld + j · cs] either way.
struct EGLane {
    int n, ld;
    int cs;          // floats between two columns of M: 1, or n (column-major)
    int R, rank;     // ranks of the lane, and this one
    int nb, r0;      // rows a band, ceil(n / R); this rank's first row
    int rows;        // this rank's rows: nb, fewer in the last band
    const float* M;  // (nb, ld): rows r0 + [0, rows)
    float* Ms;       // the shared copy of M that eg_lane_load fills, or null
    float* Mt;       // the column-major copy that eg_lane_load fills, or null
    float* q;        // (nb) the band's rows
    float* l;
    float* u;
    float* z;        // (n) the whole vector
    float* zh;       // (n) z½
    float* const* bases;  // host: each rank's buffer (emulated cluster)
    float* xg;       // the lane's z and z½ in device memory (global, R > 1)
    unsigned* bar;   // the lane's barrier in device memory (global, R > 1)
};

QPN_EG_HD int eg_ld(int n) { return n | 1; }

QPN_EG_HD int eg_band_height(int n, int R) { return (n + R - 1) / R; }

// Floats rounded up to a multiple of 4 (16 bytes).
QPN_EG_HD constexpr size_t eg_align4(size_t k) { return (k + 3) & ~size_t(3); }

// Floats of the vectors: z and z½ first, each 16-byte aligned (eg_row reads
// them four at a time), then the band's q, l and u.
QPN_EG_HD size_t eg_vector_floats(int n, int nb) {
    return 2 * eg_align4((size_t)n) + 3 * (size_t)nb;
}

// Shared memory of one rank of a lane whose bands are nb rows high, of the
// lane in one buffer (one band: the bound of the block instance's domain),
// and of the global one's.
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
    L.xg = nullptr;
    L.bar = nullptr;
}

// Rank `rank` of R of a lane, carved from a buffer of eg_band_bytes (R = 1:
// the whole lane).  `bases` is the host's table of every rank's buffer,
// read by eg_put where R > 1 (the emulated cluster); null on the card.
QPN_EG_HD EGLane eg_lane_carve(float* base, int n, int R = 1, int rank = 0,
                               float* const* bases = nullptr) {
    EGLane L;
    eg_set_ranks(L, n, R, rank, bases);
    L.ld = eg_ld(n);
    L.cs = 1;
    L.Ms = base;
    L.Mt = nullptr;
    L.M = base;
    eg_carve_vectors(L, base + eg_align4((size_t)L.nb * L.ld));
    return L;
}

// Floats of a lane's z and z½ in device memory (global instance, R > 1).
QPN_EG_HD size_t eg_exchange_floats(int n) {
    return 2 * eg_align4((size_t)n);
}

// Rank `rank` of R of lane b of the batch in the global instance, carved
// from `base` (its shared memory): its band of M copied there (`copy`,
// eg_lane_carve's layout) or else into `mt`, the lane's column-major copy
// (n · n floats of device memory: entry (i, j) of M at mt[j · n + i]),
// which it reads every half-step.  Where R > 1 the ranks write the new
// entries into `xg` (the lane's pair, eg_exchange_floats) and meet at
// `bar`.
QPN_EG_HD EGLane eg_lane_carve_global(const EGBatch& bt, size_t b,
                                      float* base, int R = 1, int rank = 0,
                                      bool copy = false,
                                      float* xg = nullptr,
                                      unsigned* bar = nullptr,
                                      float* mt = nullptr) {
    if (copy) {
        EGLane L = eg_lane_carve(base, bt.n, R, rank);
        L.xg = xg;
        L.bar = bar;
        return L;
    }
    (void)b;
    EGLane L;
    eg_set_ranks(L, bt.n, R, rank, nullptr);
    L.ld = 1;
    L.cs = bt.n;
    L.Ms = nullptr;
    L.Mt = mt + L.r0;
    L.M = L.Mt;
    L.xg = xg;
    L.bar = bar;
    eg_carve_vectors(L, base);
    return L;
}

// The kernel that takes rows of n columns: the register kernel where an
// instance of it does (eg_pick_chunk), else the block instance (EG_SHARED:
// one block a lane, M in its threads' registers and shared memory) while
// its chunk is one the launcher instantiates (eg_cluster_chunk(n) up to
// kEgBlockMaxChunk: n up to 240) and eg_lane_bytes(n) fits the block's
// opt-in limit `smem_optin` (232448 bytes on an H100: n up to 238, the
// boundary with the cluster instance), else the cluster instance while a
// band of M's rows fits the limit at 8 ranks or fewer (8: the portable
// cluster size; n up to 671 on an H100), spread over eg_cluster_ranks(n)
// blocks, else the generic kernel with M in device memory.  A choice by
// shape alone, the same on the card and in the host build.
enum { EG_REGISTER = 0, EG_SHARED = 1, EG_GLOBAL = 2, EG_CLUSTER = 3 };
constexpr int kEgMaxRanks = 8;

// The cluster instance (eg_warmstart.cu::eg_cluster_kernel): a block's
// threads at most (its __launch_bounds__), the rows a thread sums (one
// chunk of each, against the same entries of z), and the entries of its
// chunk of a row that a thread holds in registers for all steps.  nvcc
// -Xptxas -v on an H100 reports the kernel without spill at these.
constexpr int kEgClusterThreads = 320;
constexpr int kEgClusterRows = 2;
constexpr int kEgClusterRegs = 60;

// The cluster instance's chunk: ceil(n / kEgGroup) columns, rounded up to
// a multiple of 4 (a chunk is read 16 bytes a load).
QPN_EG_HD constexpr int eg_cluster_chunk(int n) {
    return (int)eg_align4((size_t)((n + kEgGroup - 1) / kEgGroup));
}

// Floats between two chunks of z (or z½) in the cluster instance's shared
// memory: the chunk, made an odd multiple of 4, so that the four chunks a
// warp reads at once lie on different banks.
QPN_EG_HD int eg_cluster_stride(int n) { return eg_cluster_chunk(n) | 4; }

// Threads of a rank whose band is nb rows high: a group of kEgGroup on
// every kEgClusterRows rows, whole warps.
QPN_EG_HD int eg_cluster_threads(int nb) {
    const int groups = (nb + kEgClusterRows - 1) / kEgClusterRows;
    return (groups * kEgGroup + 31) / 32 * 32;
}

// Shared memory of a rank: z and z½ in chunks, and what its threads do not
// hold of their rows' chunks in registers, 16 bytes a thread at a time.
QPN_EG_HD size_t eg_cluster_rank_bytes(int n, int nb) {
    const int C = eg_cluster_chunk(n);
    const int rest = C > kEgClusterRegs ? C - kEgClusterRegs : 0;
    return (2 * (size_t)kEgGroup * eg_cluster_stride(n)
            + (size_t)eg_cluster_threads(nb) * kEgClusterRows * rest)
           * sizeof(float);
}

// The block instance (eg_warmstart.cu::eg_block_kernel), the cluster
// instance's design on one block, for chunks of C columns: the entries of
// its chunk of a row that a thread holds in registers for all steps, the
// whole chunk up to kEgBlockRegs; and the rows a thread sums (one chunk of
// each, against the same entries of z), three while the registers hold
// the whole chunks, two past that.  nvcc -Xptxas -v on an H100 reports
// each instantiated chunk (36 to kEgBlockMaxChunk columns) without spill
// at these.
constexpr int kEgBlockRegs = 48;
constexpr int kEgBlockMaxChunk = 60;

QPN_EG_HD constexpr int eg_block_regs(int C) {
    return C < kEgBlockRegs ? C : kEgBlockRegs;
}

QPN_EG_HD constexpr int eg_block_rows(int C) {
    return C <= kEgBlockRegs ? 3 : 2;
}

// Threads of the block instance's lane of n rows: a group of kEgGroup on
// every eg_block_rows rows, whole warps.
QPN_EG_HD constexpr int eg_block_threads(int n) {
    const int rows = eg_block_rows(eg_cluster_chunk(n));
    return ((n + rows - 1) / rows * kEgGroup + 31) / 32 * 32;
}

// Shared memory of the block instance's lane: z and z½ in chunks (as the
// cluster instance's), and what its threads do not hold of their rows'
// chunks in registers, 16 bytes a thread at a time.
QPN_EG_HD size_t eg_block_bytes(int n) {
    const int C = eg_cluster_chunk(n);
    return (2 * (size_t)kEgGroup * eg_cluster_stride(n)
            + (size_t)eg_block_threads(n) * eg_block_rows(C)
                  * (C - eg_block_regs(C)))
           * sizeof(float);
}

// Whether some cluster of 2 to kEgMaxRanks blocks holds the bands of M's
// rows in shared memory: the cluster instance's domain.
QPN_EG_HD bool eg_cluster_reach(int n, long long smem_optin) {
    if (smem_optin < 0) return false;
    for (int R = 2; R <= kEgMaxRanks; ++R)
        if (eg_band_bytes(n, eg_band_height(n, R)) <= (size_t)smem_optin)
            return true;
    return false;
}

// The cluster instance's ranks: within its domain, the fewest, 2 to
// kEgMaxRanks, whose rank fits kEgClusterThreads threads and the limit;
// 0 outside it (or where the limit is unknown: negative).
QPN_EG_HD int eg_cluster_ranks(int n, long long smem_optin) {
    if (!eg_cluster_reach(n, smem_optin)) return 0;
    for (int R = 2; R <= kEgMaxRanks; ++R) {
        const int nb = eg_band_height(n, R);
        if (eg_cluster_threads(nb) <= kEgClusterThreads
            && eg_cluster_rank_bytes(n, nb) <= (size_t)smem_optin)
            return R;
    }
    return 0;
}

QPN_EG_HD int eg_instance(int n, long long smem_optin) {
    if (eg_pick_chunk(n) != 0) return EG_REGISTER;
    if (smem_optin < 0) return EG_GLOBAL;
    if (eg_cluster_chunk(n) <= kEgBlockMaxChunk
        && eg_lane_bytes(n) <= (size_t)smem_optin)
        return EG_SHARED;
    return eg_cluster_ranks(n, smem_optin) != 0 ? EG_CLUSTER : EG_GLOBAL;
}

// Whether a rank of the global instance's lane at R ranks holds its band
// of M in shared memory: R > 1 and the band fits `smem_optin`.  At R = 1
// the lane reads M from its column-major copy in device memory.
QPN_EG_HD bool eg_global_band_fits(int n, int R, long long smem_optin) {
    return R > 1 && smem_optin >= 0
        && eg_band_bytes(n, eg_band_height(n, R)) <= (size_t)smem_optin;
}

// The global instance's ranks for a batch of B lanes of n on a card that
// holds `resident` blocks of it at once (eg_warmstart.cu queries them at
// the opt-in limit of shared memory a block: one an SM): the fewest ranks
// whose bands fit `smem_optin` where B lanes of them fit the card, else as
// many as fit the card, resident / B (their bands read from the
// column-major copy), at most n.  R = 1, one block a lane reading M from
// that copy, where B alone fills the card (B · 2 blocks do not fit) or the
// limit is unknown.
QPN_EG_HD int eg_global_ranks(int n, int B, long long resident,
                              long long smem_optin) {
    if (B < 1 || resident < 2LL * B || smem_optin < 0 || n < 2) return 1;
    long long most = resident / B;
    if (most > n) most = n;
    for (int R = 2; R <= most; ++R)
        if (eg_global_band_fits(n, R, smem_optin)) return R;
    return (int)most;
}

// The barrier of the lane's ranks: the lane's barrier in device memory
// where they are spread over any SMs, else the block's (the host: none).
QPN_EG_HD void eg_sync_ranks(const EGLane& L) {
    if (L.bar != nullptr) {
        lane_barrier(L.bar, L.R);
        return;
    }
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
}

// v into entry r of the vector `x` (a field of this rank's part) of every
// rank: in the global instance, into the lane's copy in device memory; in
// the host's emulated cluster, into every rank's buffer.
QPN_EG_HD void eg_put(const EGLane& L, float* x, int r, float v) {
    if (L.R == 1) {
        x[r] = v;
        return;
    }
    if (L.xg != nullptr) {
        L.xg[(x - L.z) + r] = v;
        return;
    }
    for (int k = 0; k < L.R; ++k)
        L.bases[k][(x - L.bases[L.rank]) + r] = v;
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
    // the column-major copy: neighbouring threads write neighbouring
    // entries of a column (their reads of M's rows meet in the L1)
    if (L.Mt != nullptr)
        for (int k = tid; k < L.rows * n; k += nthr) {
            const int j = k / L.rows, i = k - j * L.rows;
            L.Mt[(size_t)j * n + i] = Mb[(size_t)i * n + j];
        }
    for (int i = tid; i < L.rows; i += nthr) {
        L.q[i] = bt.q[row0 + i];
        L.l[i] = bt.l[row0 + i];
        L.u[i] = bt.u[row0 + i];
    }
    for (int i = tid; i < n; i += nthr) L.z[i] = bt.z0[b * n + i];
    eg_sync_ranks(L);
}

// Columns of M whose loads a thread of the column-major read has in flight
// at once on the card.
constexpr int kEgColumnStage = 32;

// (M x)_i for the row at Mi of the column-major copy, L.cs floats between
// two entries: the products and the sum of eg_row's plain column order.
// On the card the neighbouring threads' loads of one column meet in one
// 128-byte line, and each thread loads kEgColumnStage entries before it
// sums them, so that enough bytes are in flight to stream M at the card's
// memory rate.
QPN_EG_HD float eg_row_column_major(const EGLane& L, const float* Mi,
                                    const float* x) {
    const size_t cs = (size_t)L.cs;
    float acc = 0.0f;
    int j = 0;
#ifdef __CUDA_ARCH__
    for (; j + kEgColumnStage <= L.n; j += kEgColumnStage) {
        const float* c = Mi + j * cs;
        float m[kEgColumnStage];
#pragma unroll
        for (int k = 0; k < kEgColumnStage; ++k) m[k] = c[k * cs];
#pragma unroll
        for (int k = 0; k < kEgColumnStage; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(x + j + k);
            acc += m[k] * v.x;
            acc += m[k + 1] * v.y;
            acc += m[k + 2] * v.z;
            acc += m[k + 3] * v.w;
        }
    }
    for (; j + 4 <= L.n; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + j);
        const float* c = Mi + j * cs;
        acc += c[0] * v.x;
        acc += c[cs] * v.y;
        acc += c[2 * cs] * v.z;
        acc += c[3 * cs] * v.w;
    }
#endif
    for (; j < L.n; ++j) acc += Mi[j * cs] * x[j];
    return acc;
}

// (M x)_i + q_i for row i of the band.  G = 1 is one chunk: the plain
// column order.  On the card x (z or z½, 16-byte aligned) is read four
// entries a load, a quarter of the loads that every warp makes of it; the
// products and sums are the same, in the same order.
template <int G>
QPN_EG_HD float eg_row(const EGLane& L, const float* x, int i, int C) {
    const float* Mi = L.M + (size_t)i * L.ld;
    if (G == 1 && L.cs != 1) return eg_row_column_major(L, Mi, x) + L.q[i];
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

// After the ranks' barrier, in the global instance: the lane's copy of
// the vector `x` (z or z½ of this rank's part) from device memory into
// this rank's, 16 bytes a load that bypasses the L1 (a peer wrote it).
QPN_EG_HD void eg_gather(const EGLane& L, float* x, int tid, int nthr) {
    if (L.xg == nullptr) return;
    const float* src = L.xg + (x - L.z);
    const int quads = (int)(eg_align4((size_t)L.n) / 4);
    for (int i = tid; i < quads; i += nthr) {
#if defined(__CUDA_ARCH__)
        reinterpret_cast<float4*>(x)[i] =
            __ldcg(reinterpret_cast<const float4*>(src) + i);
#else
        for (int k = 0; k < 4; ++k) x[4 * i + k] = src[4 * i + k];
#endif
    }
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
}

// The steps of one rank of a lane on the card: z½ from z, then z from z½,
// a barrier of the ranks after each (and the gather of the new vector in
// the global instance).  The host runs the same half-steps for each rank
// in turn (eg_lane_host.cpp).
template <int G>
QPN_EG_HD void eg_lane_run(const EGLane& L, float tau, int steps, int C,
                           int tid, int nthr) {
    for (int s = 0; s < steps; ++s) {
        eg_half_step<G>(L, L.z, L.zh, tau, C, tid, nthr);
        eg_sync_ranks(L);
        eg_gather(L, L.zh, tid, nthr);
        eg_half_step<G>(L, L.zh, L.z, tau, C, tid, nthr);
        eg_sync_ranks(L);
        eg_gather(L, L.z, tid, nthr);
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
