// Per-lane logic of the batched Lemke pivot loop for box AVIs
//     M z + q  ⟂  l ≤ z ≤ u,
// shared by the Hopper kernel (lemke_pivot.cu: one thread block, or R
// blocks, per lane) and a host instance built with g++ for the CPU tests
// (lemke_lane_host.cpp: one "thread", tid 0 of 1, for each rank of the lane
// in turn).
//
// The functions take the thread index and count as arguments.  A pivot is
// four phases between barriers (QPN_SYNC: __syncthreads() in device code,
// a no-op on the host; lane_sync_ranks: the cluster's barrier, or the
// lane's barrier in device memory, where the lane is spread over ranks):
//   A. basic values and the ratio test.  A row's sum is split over a group
//      of G = kLemkeSplit = 4 neighbouring threads: G chunks of neighbouring
//      columns, each summed in column order, joined by a butterfly
//      (lane_basic_value walks the same order in a loop, for the host);
//   B. the decision, by the first warp: min ratio, tie set, the t-row rule
//      and the lexicographic refinement are scans over the rows joined by
//      warp votes and reductions (lk_ballot, lk_reduce_min, lk_broadcast:
//      warp intrinsics in device code; on the host one thread scans every
//      row and they are the identity).  min, compare and first-index do not
//      depend on the order they are taken in, so every thread count makes
//      the same choices;
//   S. for a pivot, the staging of the scaled pivot row and of the entering
//      column, one element a thread, while thread 0 does the bookkeeping
//      (basis exchange, complement rule);
//   C. the rank-1 update as a 2-D loop: warps walk rows, lanes walk columns;
//      the pivot row's owner records the basis exchange.
// A step that is no pivot (bound flip, ray, singular) ends after B.
// The cluster instance runs C and the next step's A as one pass
// (lane_pass, lane_run_fused): A's group of G threads on a row updates its
// chunks of the row and sums them while they are in registers, so the band
// is read and written once a pivot, and each rank publishes the least
// ratio of its band (LaneCtl::tmin), which B reads instead of every ratio.
// Pivot k's bookkeeping (val, the next entering variable: lane_commit and
// lane_advance in S) is final at the barrier after S, where the pass
// starts; the pass's sums and products are A's and C's, in their order, so
// the fused loop gives the bits of the phases apart.
// Rows of the tableau are W | 1 elements apart (lane_stride): an odd stride
// puts the rows that neighbouring threads read on different banks.
//
// The lane's working set is carved by lane_carve from any 16-byte aligned
// buffer: the block's dynamic shared memory while lane_bytes(n) fits the
// block's opt-in limit, else the shared memory of a cluster of R blocks
// while one rank's band fits it, else a device-memory workspace
// (lane_instance picks; the barriers order global memory for the block as
// they order shared memory).  The global instance spreads a lane over R
// blocks on any SMs where the batch leaves SMs idle (lane_global_ranks):
// rank k's band sits in the workspace at a fixed stride from rank 0's
// (lane_carve_spread), its own part in the block's shared memory, and the
// ranks meet at the lane's barrier in device memory (lane_barrier.cuh); at
// R = 1 the whole lane is one block's part of the workspace (lane_carve).
//
// Ranks (the cluster instance and the spread global one; R = 1 elsewhere).
// Rank k of R holds a band
// of nb = ceil(n / R) tableau rows, k·nb onwards, with the per-row vectors
// of that band (xB, d, theta, other, basis, leff, ueff); every rank holds
// the column-length vectors (val, vlb, vub, the staged pivot row pr), the
// tie list and the lane's scalars (LaneCtl), and makes the same decision
// from the same data, so these stay equal on every rank.  A rank reads
// another's band through lk_peer (distributed shared memory in a cluster,
// the band's stride in the spread global instance).  Every rank is carved
// with the layout of a full band, so a field lies at the same offset in
// each.  The barriers that order ranks are two a step:
// after A, and after S (or after B where no pivot follows).  The property
// that makes this correct, and makes the host's emulation (each phase run
// for rank 0, 1, ..., R-1 in turn, between the same two points) give the
// card's bits: between two of these barriers no rank reads what another
// rank writes.  B and S read other ranks' theta, d, basis, tableau rows,
// leff/ueff and least ratio, and write only their own rank's scalars, val,
// pr, other and tie list; C and A (or the pass) read and write their own
// band and least ratio only.  So the basis exchange is written in C, not
// in S, where a peer may still be deciding from the basis.
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
#include <cstring>

#include "lane_barrier.cuh"

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#endif

#if defined(__CUDACC__)
#define QPN_HD __host__ __device__ __forceinline__
#else
#define QPN_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define QPN_SYNC() __syncthreads()
#define QPN_SYNCWARP() __syncwarp()
#define QPN_WARP 32
#define QPN_UNROLL _Pragma("unroll")
#else
#define QPN_SYNC() ((void)0)
#define QPN_SYNCWARP() ((void)0)
#define QPN_WARP 1
#define QPN_UNROLL
#endif

// Phase clocks, compiled in only with -DQPN_LEMKE_PROFILE (see
// benchmarks/torch_lemke_phases.py): thread 0 adds the SM cycles of each
// phase of every iteration to ctl->prof, and the first blocks print them.
#if defined(QPN_LEMKE_PROFILE) && defined(__CUDA_ARCH__)
#include <cstdio>
#define QPN_PROF_START() long long prof_t_ = clock64()
#define QPN_PROF(ctl, slot, on)                                   \
    do {                                                          \
        const long long now_ = clock64();                         \
        if (on) (ctl)->prof[slot] += now_ - prof_t_;              \
        prof_t_ = now_;                                           \
    } while (0)
#else
#define QPN_PROF_START() ((void)0)
#define QPN_PROF(ctl, slot, on) ((void)0)
#endif

namespace qpn {

enum { LEMKE_SUCCESS = 1, LEMKE_RAY = 2, LEMKE_MAX = 3, LEMKE_SINGULAR = 4 };
enum { ACT_NONE = 0, ACT_PIVOT = 1 };
// Threads that share a row's sum in phase A (a power of two), and its log2.
constexpr int kLemkeSplit = 4;
constexpr int kLemkeSplitLog2 = 2;

template <typename T> QPN_HD T lk_inf() { return T(INFINITY); }
template <typename T> QPN_HD bool lk_isnan(T x) { return x != x; }
template <typename T> QPN_HD bool lk_isfinite(T x) {
    return x == x && x != lk_inf<T>() && x != -lk_inf<T>();
}
template <typename T> QPN_HD T lk_abs(T x) { return x < T(0) ? -x : x; }

// ---- votes and reductions over the deciding warp -------------------------
// Warp intrinsics over the 32 lanes in device code; on the host one thread
// scans everything and they are the identity (bit 0 alone).

// The minimum under `<` of every thread's v: a NaN never enters it.
template <typename T> QPN_HD T lk_reduce_min(T v) {
#if defined(__CUDA_ARCH__)
    for (int o = 16; o > 0; o >>= 1) {
        const T w = __shfl_xor_sync(0xffffffffu, v, o);
        if (w < v) v = w;
    }
#endif
    return v;
}

// One bit per thread whose flag is set.
QPN_HD unsigned lk_ballot(bool flag) {
#if defined(__CUDA_ARCH__)
    return __ballot_sync(0xffffffffu, flag);
#else
    return flag ? 1u : 0u;
#endif
}

// The value that thread `src` holds.
template <typename T> QPN_HD T lk_broadcast(T v, int src) {
#if defined(__CUDA_ARCH__)
    v = __shfl_sync(0xffffffffu, v, src);
#endif
    (void)src;
    return v;
}

QPN_HD int lk_popc(unsigned m) {
#if defined(__CUDA_ARCH__)
    return __popc(m);
#else
    return __builtin_popcount(m);
#endif
}

// index of the lowest set bit of m (m != 0)
QPN_HD int lk_lowest(unsigned m) {
#if defined(__CUDA_ARCH__)
    return __ffs((int)m) - 1;
#else
    return __builtin_ctz(m);
#endif
}

// The key of a ratio theta >= 0 (never NaN): its bits, +0 for -0, which
// order as the ratios do.  Two zeros give one key: B uses the least ratio
// only through comparisons and tstar + tol*(1 + |tstar|), where they agree.
template <typename T> QPN_HD unsigned long long lk_ratio_key(T th) {
    if (th == T(0)) return 0ull;
    if constexpr (sizeof(T) == 4) {
        unsigned u;
        memcpy(&u, &th, 4);
        return u;
    } else {
        unsigned long long u;
        memcpy(&u, &th, 8);
        return u;
    }
}

template <typename T> QPN_HD T lk_key_ratio(unsigned long long key) {
    T th;
    if constexpr (sizeof(T) == 4) {
        const unsigned u = (unsigned)key;
        memcpy(&th, &u, 4);
    } else {
        memcpy(&th, &key, 8);
    }
    return th;
}

// Append r to list (at count and above) from every thread whose flag is
// set, in thread order; returns the new count.  Called by all threads.
QPN_HD int lk_append(int* list, int count, int r, bool flag, int lane) {
    const unsigned m = lk_ballot(flag);
    if (flag) list[count + lk_popc(m & ((1u << lane) - 1u))] = r;
    return count + lk_popc(m);
}

// Scans of the rows in chunks of nl (row base + lane), called together by
// the threads of the deciding warp (lane of nl; 0 of 1 on the host); every
// thread gets the same answer.  A thread loads its rows of four chunks
// before it looks at any, so that the loads' latencies (another rank's
// shared memory, in the cluster instance) overlap.
constexpr int kLemkeScanChunks = 4;

// min of v[0:n] under `<`, from +inf: NaN entries are skipped.
template <typename T>
QPN_HD T lk_scan_min(const T* v, int n, int lane, int nl) {
    constexpr int K = kLemkeScanChunks;
    T m = lk_inf<T>();
    for (int base = 0; base < n; base += K * nl) {
        T x[K];
        QPN_UNROLL
        for (int k = 0; k < K; ++k) {
            const int r = base + k * nl + lane;
            x[k] = r < n ? v[r] : lk_inf<T>();
        }
        QPN_UNROLL
        for (int k = 0; k < K; ++k)
            if (x[k] < m) m = x[k];
    }
    return lk_reduce_min(m);
}

// The tie set of the ratio test over the rows r0 + [0, rows) of the lane,
// whose ratios and tags are theta[0:rows] and tag[0:rows]: the rows r0 + r
// with theta[r] <= thr are appended to list[count:], ascending, and
// *first_tagged, while it is still `none`, becomes the first of them with
// tag[r] == want.  Returns the new count.  Called for the bands in row
// order, it builds the lane's tie set.
template <typename T>
QPN_HD int lk_scan_ties(const T* theta, const int* tag, int rows, T thr,
                        int want, int* list, int count, int r0, int none,
                        int* first_tagged, int lane, int nl) {
    constexpr int K = kLemkeScanChunks;
    int first = *first_tagged;
    for (int base = 0; base < rows; base += K * nl) {
        // every load of the K chunks before any vote
        T th[K];
        int tg[K];
        QPN_UNROLL
        for (int k = 0; k < K; ++k) {
            const int r = base + k * nl + lane;
            th[k] = r < rows ? theta[r] : lk_inf<T>();
            tg[k] = r < rows ? tag[r] : want - 1;
        }
        QPN_UNROLL
        for (int k = 0; k < K; ++k) {
            const int r = base + k * nl + lane;
            const bool tie = r < rows && th[k] <= thr;
            const unsigned mt = lk_ballot(tie && tg[k] == want);
            if (mt != 0u && first == none)
                first = r0 + base + k * nl + lk_lowest(mt);
            count = lk_append(list, count, r0 + r, tie, lane);
        }
    }
    *first_tagged = first;
    return count;
}

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
    T edir, ev, pe;
    int ent, status, piv, k, jstar, col, act;
    // the fused loop's least ratio of the rank's band (lk_ratio_key), for
    // the step of parity k & 1: the pass of step k fills its slot and
    // clears the other, which B read a step before
    unsigned long long tmin[2];
#if defined(QPN_LEMKE_PROFILE)
    // cycles of: basic values and ratios, decision, staging, update; inside
    // the decision: min ratio, tie set, lexicographic refinement, the rest
    long long prof[8];
#endif
};

// One lane's working set, or one rank's part of it (shared or device memory
// on the card).
template <typename T>
struct Lane {
    int n, ld;   // ld: elements between tableau rows
    int R, rank; // ranks of the lane, and this one
    int nb;      // rows a band: ceil(n / R)
    int r0;      // this rank's first row, rank · nb
    int rows;    // this rank's rows: nb, fewer in the last band
    T* tab;      // (nb, ld), 3n+2 used: rows r0 + [0, rows)
    T* val;      // (3n+1) nonbasic values
    T* vlb;      // (3n+1) variable bounds
    T* vub;
    T* leff;     // (nb) synthetically boxed bounds of the band's rows
    T* ueff;
    T* xB;       // (nb) basic values
    T* d;        // (nb) entering column times direction
    T* theta;    // (nb) ratios
    T* other;    // (nb) staged entering column
    T* pr;       // (3n+2) scaled pivot row
    int* basis;  // (nb)
    int* clist;  // (n) the tie candidates' rows, ascending
    LaneCtl<T>* ctl;
    unsigned char* const* bases;  // host: each rank's buffer (cluster, R > 1)
    size_t stride;  // bytes from a band to the next rank's (spread global)
    unsigned* bar;  // the lane's barrier in device memory (spread global)
};

QPN_HD size_t lk_align16(size_t x) { return (x + 15) & ~size_t(15); }

// Elements between tableau rows: odd, so that a warp's rows (all at one
// column) fall on different banks.
QPN_HD int lane_stride(int n) { return (3 * n + 2) | 1; }

// Rows of each band of a lane of n spread over R ranks.
QPN_HD int lane_band_height(int n, int R) { return (n + R - 1) / R; }

// Elements of a rank's floats whose band rows are ld apart (0: the odd
// stride).
template <typename T>
QPN_HD size_t lane_floats(int n, int nb, int ld = 0) {
    const size_t W = 3 * (size_t)n + 2, NV = W - 1;
    return (size_t)nb * (ld > 0 ? ld : lane_stride(n)) + 3 * NV
           + 6 * (size_t)nb + W;
}

// Bytes of one rank's part of a lane whose bands are nb rows high, rows ld
// apart (0: the odd stride, which every instance but the cluster's keeps):
// a rank of every instance is carved with this layout.
template <typename T>
QPN_HD size_t lane_band_bytes(int n, int nb, int ld = 0) {
    return lk_align16(sizeof(LaneCtl<T>))
         + lk_align16(lane_floats<T>(n, nb, ld) * sizeof(T))
         + lk_align16((size_t)nb * sizeof(int))
         + lk_align16((size_t)n * sizeof(int));
}

// Bytes of one lane's working set on one rank: f32 at n=38 is about 20 KB.
template <typename T>
QPN_HD size_t lane_bytes(int n) { return lane_band_bytes<T>(n, n); }

// Carve rank `rank` of R of a lane's working set out of a 16-byte aligned
// buffer (R = 1: the whole lane).  `bases` is the host's table of every
// rank's buffer, read by lk_peer where R > 1; null on the card.
// Rows are ld apart (0: the odd stride; the cluster instance's launcher
// may space them further, lane_cluster_stride).
// (The rank fields are set in each carving, not by a shared helper: nvcc
// allotted the cluster instance 64 registers and spilled with one.)
template <typename T>
QPN_HD Lane<T> lane_carve(unsigned char* base, int n, int R = 1,
                          int rank = 0,
                          unsigned char* const* bases = nullptr,
                          int ld = 0) {
    const size_t W = 3 * (size_t)n + 2, NV = W - 1;
    Lane<T> L;
    L.n = n;
    L.R = R;
    L.rank = rank;
    L.nb = lane_band_height(n, R);
    L.ld = ld > 0 ? ld : lane_stride(n);
    L.r0 = rank * L.nb;
    const int left = n - L.r0;
    L.rows = left < 0 ? 0 : (left < L.nb ? left : L.nb);
    L.bases = bases;
    L.stride = 0;
    L.bar = nullptr;
    const size_t nb = (size_t)L.nb;
    L.ctl = reinterpret_cast<LaneCtl<T>*>(base);
    T* f = reinterpret_cast<T*>(base + lk_align16(sizeof(LaneCtl<T>)));
    L.tab = f;       f += nb * L.ld;
    L.val = f;       f += NV;
    L.vlb = f;       f += NV;
    L.vub = f;       f += NV;
    L.leff = f;      f += nb;
    L.ueff = f;      f += nb;
    L.xB = f;        f += nb;
    L.d = f;         f += nb;
    L.theta = f;     f += nb;
    L.other = f;     f += nb;
    L.pr = f;
    unsigned char* rest = base + lk_align16(sizeof(LaneCtl<T>))
                        + lk_align16(lane_floats<T>(n, L.nb, L.ld) * sizeof(T));
    L.basis = reinterpret_cast<int*>(rest);
    L.clist = reinterpret_cast<int*>(rest + lk_align16(nb * sizeof(int)));
    return L;
}

// The spread global instance's parts of a rank.  Its band in device
// memory: the band's tableau rows and per-row vectors, the fields other
// ranks read.  Its own part in the block's shared memory: the scalars, the
// column-length vectors, the staged pivot row and the tie list, which every
// rank holds alike and no peer reads.
template <typename T>
QPN_HD size_t lane_spread_band_bytes(int n, int nb) {
    return lk_align16(((size_t)nb * lane_stride(n) + 6 * (size_t)nb)
                      * sizeof(T))
         + lk_align16((size_t)nb * sizeof(int));
}

template <typename T>
QPN_HD size_t lane_spread_own_bytes(int n) {
    const size_t W = 3 * (size_t)n + 2, NV = W - 1;
    return lk_align16(sizeof(LaneCtl<T>))
         + lk_align16((3 * NV + W) * sizeof(T))
         + lk_align16((size_t)n * sizeof(int));
}

// Rank `rank` of a lane spread over R ranks on any SMs: its own part at
// `own`, its band at `band`, the next rank's band lane_spread_band_bytes
// further on; the ranks meet at `bar`.
template <typename T>
QPN_HD Lane<T> lane_carve_spread(unsigned char* own, unsigned char* band,
                                 int n, int R, int rank, unsigned* bar) {
    const size_t W = 3 * (size_t)n + 2, NV = W - 1;
    Lane<T> L;
    L.n = n;
    L.ld = lane_stride(n);
    L.R = R;
    L.rank = rank;
    L.nb = lane_band_height(n, R);
    L.r0 = rank * L.nb;
    const int left = n - L.r0;
    L.rows = left < 0 ? 0 : (left < L.nb ? left : L.nb);
    L.bases = nullptr;
    L.stride = lane_spread_band_bytes<T>(n, L.nb);
    L.bar = bar;
    const size_t nb = (size_t)L.nb;
    L.ctl = reinterpret_cast<LaneCtl<T>*>(own);
    T* f = reinterpret_cast<T*>(own + lk_align16(sizeof(LaneCtl<T>)));
    L.val = f;       f += NV;
    L.vlb = f;       f += NV;
    L.vub = f;       f += NV;
    L.pr = f;
    L.clist = reinterpret_cast<int*>(own + lk_align16(sizeof(LaneCtl<T>))
                                     + lk_align16((3 * NV + W) * sizeof(T)));
    T* g = reinterpret_cast<T*>(band);
    L.tab = g;       g += nb * L.ld;
    L.leff = g;      g += nb;
    L.ueff = g;      g += nb;
    L.xB = g;        g += nb;
    L.d = g;         g += nb;
    L.theta = g;     g += nb;
    L.other = g;
    L.basis = reinterpret_cast<int*>(
        band + lk_align16((nb * L.ld + 6 * nb) * sizeof(T)));
    return L;
}

// A field of rank k's part of the lane, from the same field of this rank's:
// in the spread global instance the field of rank k's band, (k − rank)
// strides away; in a cluster, in device code its distributed shared memory,
// on the host the same offset in rank k's buffer.
template <typename T, typename P>
QPN_HD P* lk_peer(const Lane<T>& L, P* p, int k) {
    if (L.R == 1 || k == L.rank) return p;
    if (L.stride != 0)
        return (P*)((const unsigned char*)p
                    + (long long)(k - L.rank) * (long long)L.stride);
#if defined(__CUDA_ARCH__)
    return cooperative_groups::this_cluster().map_shared_rank(p, k);
#else
    const unsigned char* at = reinterpret_cast<const unsigned char*>(p);
    return reinterpret_cast<P*>(L.bases[k] + (at - L.bases[L.rank]));
#endif
}

// The rank that holds row r, and the rows of rank k's band.
template <typename T>
QPN_HD int lane_owner(const Lane<T>& L, int r) {
    return L.R == 1 ? 0 : r / L.nb;
}

template <typename T>
QPN_HD int lane_rows_of(const Lane<T>& L, int k) {
    const int left = L.n - k * L.nb;
    return left < 0 ? 0 : (left < L.nb ? left : L.nb);
}

// Row r's entry of a per-row vector, or row r of the tableau, on its owner.
template <typename T, typename P>
QPN_HD P lane_at(const Lane<T>& L, P* v, int r) {
    const int k = lane_owner(L, r);
    return lk_peer(L, v, k)[r - k * L.nb];
}

template <typename T>
QPN_HD const T* lane_row(const Lane<T>& L, int r) {
    const int k = lane_owner(L, r);
    return lk_peer(L, L.tab, k) + (size_t)(r - k * L.nb) * L.ld;
}

// The barrier between phases that read across ranks: the lane's barrier in
// device memory where its ranks are spread over any SMs, the cluster's
// where they are a cluster, else the block's.
template <typename T>
QPN_HD void lane_sync_ranks(const Lane<T>& L) {
    if (L.bar != nullptr) {
        lane_barrier(L.bar, L.R);
        return;
    }
#if defined(__CUDA_ARCH__)
    if (L.R > 1) cooperative_groups::this_cluster().sync();
    else __syncthreads();
#endif
}

// Where a lane's working set lives on the card: LANE_SHARED, the block's
// dynamic shared memory, while lane_bytes(n) fits the block's opt-in limit
// `smem_optin` (232448 bytes on an H100: f32 up to n = 135, f64 up to
// n = 94); else LANE_CLUSTER, spread over the shared memory of a cluster
// of lane_cluster_ranks(n) blocks while a band fits the limit at 8 ranks or
// fewer (8: the portable cluster size); else LANE_GLOBAL, lane_bytes(n)
// bytes of a device-memory workspace a lane (a multiple of 16, so every
// lane stays 16-byte aligned).  A choice by shape alone, made before the
// launch.
enum { LANE_SHARED = 0, LANE_GLOBAL = 1, LANE_CLUSTER = 2 };
constexpr int kLaneMaxRanks = 8;

QPN_HD size_t lane_band_bytes_of(int n, int nb, int itemsize) {
    return itemsize == 4 ? lane_band_bytes<float>(n, nb)
                         : lane_band_bytes<double>(n, nb);
}

// The fewest ranks, 2 to kLaneMaxRanks, whose bands fit `smem_optin`; 0
// where none does (or the limit is unknown: negative).
QPN_HD int lane_cluster_ranks(int n, int itemsize, long long smem_optin) {
    if (smem_optin < 0) return 0;
    for (int R = 2; R <= kLaneMaxRanks; ++R)
        if (lane_band_bytes_of(n, lane_band_height(n, R), itemsize)
            <= (size_t)smem_optin)
            return R;
    return 0;
}

// The row stride of the cluster instance's band of nb rows: the fused
// pass (lane_pass) has a warp read one entry of each of 4 chunks of 8 rows
// at once.  The least stride from 3n+2 on, among the next 64, at which
// those 32 entries lie on different banks (T = double: the 16 of each
// half-warp on different pairs), where the band still fits `smem_optin`;
// else the odd stride (so the ranks stay those of lane_cluster_ranks).
// The bits do not depend on it.
QPN_HD int lane_chunk(int n);

template <typename T>
QPN_HD int lane_cluster_stride(int n, int nb, long long smem_optin) {
    if (smem_optin < 0) return lane_stride(n);
    const int C = lane_chunk(n);
    const int words = sizeof(T) == 4 ? 32 : 16, slots = words / 4;
    for (int ld = 3 * n + 2; ld < 3 * n + 2 + 64; ++ld) {
        bool clear = true;
        for (int h = 0; h < 8 && clear; h += slots) {
            unsigned seen = 0;
            for (int s = h; s < h + slots; ++s)
                for (int g = 0; g < kLemkeSplit; ++g)
                    seen |= 1u << ((s * ld + g * C) % words);
            clear = seen == (words == 32 ? ~0u : 0xffffu);
        }
        if (clear)
            return lane_band_bytes<T>(n, nb, ld) <= (size_t)smem_optin
                       ? ld : lane_stride(n);
    }
    return lane_stride(n);
}

QPN_HD int lane_instance(int n, int itemsize, long long smem_optin) {
    if (smem_optin < 0) return LANE_GLOBAL;
    if (lane_band_bytes_of(n, n, itemsize) <= (size_t)smem_optin)
        return LANE_SHARED;
    return lane_cluster_ranks(n, itemsize, smem_optin) != 0 ? LANE_CLUSTER
                                                            : LANE_GLOBAL;
}

// The global instance's ranks for a batch of B lanes of n on a card that
// holds `resident` blocks of it at once (lemke_pivot.cu queries them at the
// opt-in limit of shared memory a block: one an SM).  Each lane takes an
// equal share of the card, resident / B blocks, at most kLaneMaxGlobalRanks
// (the decision scans every rank's band in turn, so more ranks lengthen
// it) and at most n.  R = 1, the lane whole in one block's part of the
// workspace, where B alone fills the card (B · 2 blocks do not fit), where
// a rank's own part does not fit the limit, or where the limit is unknown.
constexpr int kLaneMaxGlobalRanks = 8;

QPN_HD size_t lane_spread_own_bytes_of(int n, int itemsize) {
    return itemsize == 4 ? lane_spread_own_bytes<float>(n)
                         : lane_spread_own_bytes<double>(n);
}

QPN_HD int lane_global_ranks(int n, int itemsize, int B, long long resident,
                             long long smem_optin) {
    if (B < 1 || resident < 2LL * B || smem_optin < 0) return 1;
    if (lane_spread_own_bytes_of(n, itemsize) > (size_t)smem_optin) return 1;
    long long R = resident / B;
    if (R > kLaneMaxGlobalRanks) R = kLaneMaxGlobalRanks;
    if (R > n) R = n;
    return R < 2 ? 1 : (int)R;
}

// Bytes of the global instance's workspace a lane at R ranks: the whole
// lane at R = 1, else R bands.
QPN_HD size_t lane_global_lane_bytes(int n, int itemsize, int R) {
    if (R <= 1) return lane_band_bytes_of(n, n, itemsize);
    const int nb = lane_band_height(n, R);
    return (size_t)R * (itemsize == 4 ? lane_spread_band_bytes<float>(n, nb)
                                      : lane_spread_band_bytes<double>(n, nb));
}

// Lane b of the batch into this rank's part: its band's rows, and every
// column-length vector.
template <typename T>
QPN_HD void lane_load(const Lane<T>& L, const LemkeBatch<T>& bt, size_t b,
                      int tid, int nthr) {
    const int n = L.n, W = 3 * n + 2, NV = W - 1, rows = L.rows;
    const int lane = tid % QPN_WARP, wp = tid / QPN_WARP;
    const int nw = nthr / QPN_WARP;
    const size_t row0 = b * (size_t)n + L.r0;
    const T* tb = bt.tab_in + row0 * W;
    for (int r = wp; r < rows; r += nw)
        for (int j = lane; j < W; j += QPN_WARP)
            L.tab[r * L.ld + j] = tb[r * W + j];
    for (int j = tid; j < NV; j += nthr) {
        L.val[j] = bt.val_in[b * NV + j];
        L.vlb[j] = bt.vlb[b * NV + j];
        L.vub[j] = bt.vub[b * NV + j];
    }
    for (int r = tid; r < rows; r += nthr) {
        L.basis[r] = bt.basis_in[row0 + r];
        L.leff[r] = bt.leff[row0 + r];
        L.ueff[r] = bt.ueff[row0 + r];
    }
    QPN_SYNC();
    if (tid == 0) {
        LaneCtl<T>* c = L.ctl;
        c->ent = bt.ent_in[b];
        c->edir = bt.edir_in[b];
        c->ev = bt.ev_in[b];
        c->status = bt.status_in[b];
        c->piv = 0;
        c->k = 1;
        c->jstar = 0;
        c->col = 0;
        c->pe = T(0);
        c->act = ACT_NONE;
        c->tmin[0] = c->tmin[1] = lk_ratio_key(lk_inf<T>());
#if defined(QPN_LEMKE_PROFILE)
        for (int i = 0; i < 8; ++i) c->prof[i] = 0;
#endif
        // the entering variable temporarily carries its start value
        if (c->status == 0 && c->k < bt.max_pivots) L.val[c->ent] = c->ev;
    }
    QPN_SYNC();
}

// This rank's band of the outputs; rank 0 writes the lane's values and
// scalars, which every rank holds alike.
template <typename T>
QPN_HD void lane_store(const Lane<T>& L, const LemkeBatch<T>& bt, size_t b,
                       int tid, int nthr) {
    const int n = L.n, NV = 3 * n + 1;
    const size_t row0 = b * (size_t)n + L.r0;
    for (int r = tid; r < L.rows; r += nthr) {
        bt.xB_out[row0 + r] = L.xB[r];
        bt.basis_out[row0 + r] = L.basis[r];
    }
    if (L.rank != 0) return;
    for (int j = tid; j < NV; j += nthr) bt.val_out[b * NV + j] = L.val[j];
    if (tid == 0) {
        bt.piv_out[b] = L.ctl->piv;
        bt.status_out[b] = L.ctl->status;
    }
}

// ---- phase A ---------------------------------------------------------------
// xB[r] = rhs[r] - tab[r, 0:3n+1] . val under the split G = kLemkeSplit:
// chunk g holds the columns [g·C, (g+1)·C) with C = ceil((3n+1)/G); its
// partial sum starts from rhs[r] (g = 0) or 0 and subtracts its products in
// column order; the partial sums are joined by the butterfly
// p_g ← p_g + p_{g xor o}, o = G/2, ..., 1.

// G is a power of two: shifts, where a division would cost the card some
// forty instructions on every pivot's critical path.
QPN_HD int lane_chunk(int n) {
    return (3 * n + 1 + kLemkeSplit - 1) >> kLemkeSplitLog2;
}

// Chunk g's partial sum for row r; eight products at a time, so that their
// shared-memory loads overlap, then their subtractions in order.
template <typename T>
QPN_HD T lane_basic_partial(const Lane<T>& L, int r, int g) {
    const int NV = 3 * L.n + 1, C = lane_chunk(L.n);
    const T* row = L.tab + r * L.ld;
    const T* val = L.val;
    const int end = (g + 1) * C < NV ? (g + 1) * C : NV;
    T s = g == 0 ? row[NV] : T(0);
    int j = g * C;
    for (; j + 8 <= end; j += 8) {
        T p[8];
        QPN_UNROLL
        for (int k = 0; k < 8; ++k) p[k] = row[j + k] * val[j + k];
        QPN_UNROLL
        for (int k = 0; k < 8; ++k) s -= p[k];
    }
    for (; j < end; ++j) s -= row[j] * val[j];
    return s;
}

// The butterfly over a group of G neighbouring threads of a warp (device),
// every thread ending with the same bits.
template <typename T>
QPN_HD T lane_group_sum(T v) {
#if defined(__CUDA_ARCH__)
    QPN_UNROLL
    for (int o = kLemkeSplit / 2; o > 0; o >>= 1)
        v = v + __shfl_xor_sync(0xffffffffu, v, o);
#endif
    return v;
}

// The same sum as a loop over the chunks (host, and the final values).
template <typename T>
QPN_HD T lane_basic_value(const Lane<T>& L, int r) {
    constexpr int G = kLemkeSplit;
    T part[G], next[G];
    for (int g = 0; g < G; ++g) part[g] = lane_basic_partial(L, r, g);
    for (int o = G / 2; o > 0; o >>= 1) {
        for (int g = 0; g < G; ++g) next[g] = part[g] + part[g ^ o];
        for (int g = 0; g < G; ++g) part[g] = next[g];
    }
    return part[0];
}

// The band's basic values into xB, groups of G threads on rows base + slot.
// On the host (nthr = 1) one thread walks every row with the loop above.
template <typename T>
QPN_HD void lane_basic_values(const Lane<T>& L, int tid, int nthr,
                              bool with_ratios, T piv_tol) {
    const int n = L.rows;
    const LaneCtl<T>* c = L.ctl;
    const int ent = c->ent;
    const T edir = c->edir;
    const T INF = lk_inf<T>();
#if defined(__CUDA_ARCH__)
    const int g = tid & (kLemkeSplit - 1), slot = tid >> kLemkeSplitLog2;
    const int P = nthr >> kLemkeSplitLog2;
#else
    const int g = 0, slot = tid, P = nthr;
#endif
    for (int base = 0; base < n; base += P) {
        const int r = base + slot;
        const bool row = r < n;
#if defined(__CUDA_ARCH__)
        const T x = lane_group_sum(
            row ? lane_basic_partial(L, r, g) : T(0));
#else
        const T x = row ? lane_basic_value(L, r) : T(0);
#endif
        if (!row || g != 0) continue;
        L.xB[r] = x;
        if (!with_ratios) continue;
        const T dr = edir * L.tab[r * L.ld + ent];
        const int bv = L.basis[r];
        T th;
        if (dr > piv_tol) th = (x - L.vlb[bv]) / dr;
        else if (dr < -piv_tol) th = (x - L.vub[bv]) / dr;
        else th = INF;
        if (lk_isnan(th)) th = INF;
        if (th < T(0)) th = T(0);
        L.d[r] = dr;
        L.theta[r] = th;
    }
}

// ---- the fused pass: C of a pivot and A of the next step --------------------

// Chunk g of row r (the pivot row where `pivot`) updated from the staged
// pivot row and entering column, and its partial sum taken from the new
// entries while they are in registers: lane_basic_partial's sum, in its
// order, of C's values.  Chunk 0 also updates the right-hand side first,
// which its partial sum starts from.
template <typename T>
QPN_HD T lane_update_partial(const Lane<T>& L, int r, int g, bool pivot) {
    const int NV = 3 * L.n + 1, C = lane_chunk(L.n);
    // three arrays apart: the next eight entries' loads may pass this
    // eight's stores
    T* __restrict__ row = L.tab + r * L.ld;
    const T* __restrict__ pr = L.pr;
    const T* __restrict__ val = L.val;
    const T o = L.other[r];
    const int end = (g + 1) * C < NV ? (g + 1) * C : NV;
    T s = T(0);
    if (g == 0) {
        s = pivot ? pr[NV] : row[NV] - o * pr[NV];
        row[NV] = s;
    }
    int j = g * C;
    for (; j + 8 <= end; j += 8) {
        T e[8], p[8], w[8];
        QPN_UNROLL
        for (int k = 0; k < 8; ++k) {
            e[k] = row[j + k];
            p[k] = pr[j + k];
            w[k] = val[j + k];
        }
        QPN_UNROLL
        for (int k = 0; k < 8; ++k) {
            const T v = pivot ? p[k] : e[k] - o * p[k];
            row[j + k] = v;
            e[k] = v * w[k];
        }
        QPN_UNROLL
        for (int k = 0; k < 8; ++k) s -= e[k];
    }
    for (; j < end; ++j) {
        const T v = pivot ? pr[j] : row[j] - o * pr[j];
        row[j] = v;
        s -= v * val[j];
    }
    return s;
}

// The same update of the whole row, for the host (which then sums the row
// with lane_basic_value).
template <typename T>
QPN_HD void lane_update_row(const Lane<T>& L, int r, bool pivot) {
    const int W = 3 * L.n + 2;
    T* row = L.tab + r * L.ld;
    const T o = L.other[r];
    for (int j = 0; j < W; ++j) row[j] = pivot ? L.pr[j] : row[j] - o * L.pr[j];
}

// The least key of every thread's `key` into slot `slot` of this rank's
// least ratio: the warp's least by shuffles, then one shared-memory atomic
// a warp (the host: one thread, a plain min).
template <typename T>
QPN_HD void lane_publish_min(const Lane<T>& L, unsigned long long key,
                             int slot) {
#if defined(__CUDA_ARCH__)
    key = lk_reduce_min(key);
    if ((threadIdx.x & (QPN_WARP - 1)) == 0) atomicMin(&L.ctl->tmin[slot], key);
#else
    if (key < L.ctl->tmin[slot]) L.ctl->tmin[slot] = key;
#endif
}

// Row r's basic value x and ratio into the band (the basis exchange first
// where r is the pivot row); returns the least of `key` and the ratio's.
template <typename T>
QPN_HD unsigned long long lane_ratio(const Lane<T>& L, int r, T x,
                                     bool pivot, int col, int ent, T edir,
                                     T piv_tol, unsigned long long key) {
    if (pivot) L.basis[r] = col;
    L.xB[r] = x;
    const T dr = edir * L.tab[r * L.ld + ent];
    const int bv = L.basis[r];
    T th;
    if (dr > piv_tol) th = (x - L.vlb[bv]) / dr;
    else if (dr < -piv_tol) th = (x - L.vub[bv]) / dr;
    else th = lk_inf<T>();
    if (lk_isnan(th)) th = lk_inf<T>();
    if (th < T(0)) th = T(0);
    L.d[r] = dr;
    L.theta[r] = th;
    const unsigned long long kth = lk_ratio_key(th);
    return kth < key ? kth : key;
}

// The fused loop's pass: where `update`, the rank-1 update of the band
// from pivot ctl->jstar (with the basis exchange, by the pivot row's
// group); then the band's basic values, ratios and least ratio for step
// ctl->k, published into tmin[k & 1].  A group of G threads on a row, as
// lane_basic_values; on the host one thread walks every row.  (Two rows a
// group, sharing the loads of the staged row and the values, measured
// slower on an H100: half the warps to hide the latencies.)
template <typename T>
QPN_HD void lane_pass(const Lane<T>& L, int tid, int nthr, T piv_tol,
                      bool update) {
    const int n = L.rows;
    LaneCtl<T>* c = L.ctl;
    const int ent = c->ent, col = c->col, slot = c->k & 1;
    const int js = update ? c->jstar - L.r0 : -1;  // off [0, n) off the band
    const T edir = c->edir;
    unsigned long long key = lk_ratio_key(lk_inf<T>());
    // the other slot was B's a step ago; the next pass fills it
    if (tid == 0) c->tmin[slot ^ 1] = key;
#if defined(__CUDA_ARCH__)
    const int g = tid & (kLemkeSplit - 1), slot_ = tid >> kLemkeSplitLog2;
    const int P = nthr >> kLemkeSplitLog2;
#else
    const int g = 0, slot_ = tid, P = nthr;
#endif
    for (int base = 0; base < n; base += P) {
        const int r = base + slot_;
        const bool row = r < n;
#if defined(__CUDA_ARCH__)
        T x = T(0);
        if (row)
            x = update ? lane_update_partial(L, r, g, r == js)
                       : lane_basic_partial(L, r, g);
        x = lane_group_sum(x);
        __syncwarp();                        // the group's new entries
#else
        if (row && update) lane_update_row(L, r, r == js);
        const T x = row ? lane_basic_value(L, r) : T(0);
#endif
        if (!row || g != 0) continue;
        key = lane_ratio(L, r, x, r == js, col, ent, edir, piv_tol, key);
    }
    lane_publish_min(L, key, slot);
}

// The least ratio of the lane for step ctl->k: the ranks' published least
// ratios, thread `lane` of nl reading ranks lane, lane + nl, ...
template <typename T>
QPN_HD T lane_published_min(const Lane<T>& L, int lane, int nl) {
    const int slot = L.ctl->k & 1;
    unsigned long long key = ~0ull;
    for (int k = lane; k < L.R; k += nl) {
        const unsigned long long v = lk_peer(L, L.ctl, k)->tmin[slot];
        if (v < key) key = v;
    }
    return lk_key_ratio<T>(lk_reduce_min(key));
}

// ---- phase B ---------------------------------------------------------------

// Thread 0, at the end of an iteration: count it, and let the next one's
// entering variable carry its start value.
template <typename T>
QPN_HD void lane_advance(const Lane<T>& L, int max_pivots) {
    LaneCtl<T>* c = L.ctl;
    c->k += 1;
    if (c->status == 0 && c->k < max_pivots) L.val[c->ent] = c->ev;
}

// Thread 0, after a pivot is decided: the values' bookkeeping and the
// Lemke complement rule.  Writes val and ctl only; the basis exchange
// itself (basis[jstar] = col) is lane_update's, after the ranks' barrier.
template <typename T>
QPN_HD void lane_commit(const Lane<T>& L) {
    const int n = L.n, T_ID = 3 * n;
    LaneCtl<T>* c = L.ctl;
    const int js = c->jstar, ent = c->ent;
    const int ex = lane_at(L, L.basis, js);
    const T exv = lane_at(L, L.d, js) > T(0) ? L.vlb[ex] : L.vub[ex];
    L.val[ex] = exv;
    L.val[ent] = T(0);
    c->piv += 1;
    if (ex == T_ID) {
        c->status = LEMKE_SUCCESS;
        return;
    }
    const int i = ex % n;
    if (ex < n) {                            // z_i left at a bound
        const bool at_l = lk_abs(exv - lane_at(L, L.leff, i))
                          <= lk_abs(exv - lane_at(L, L.ueff, i));
        c->ent = at_l ? n + i : 2 * n + i;
        c->edir = T(1);
        c->ev = T(0);
    } else if (ex < 2 * n) {                 // u_i left: z_i rises from l_i
        c->ent = i;
        c->edir = T(1);
        c->ev = lane_at(L, L.leff, i);
    } else {                                 // v_i left: z_i falls from u_i
        c->ent = i;
        c->edir = T(-1);
        c->ev = lane_at(L, L.ueff, i);
    }
}

// Lexicographic key of candidate row r in pass kk.
template <typename T>
QPN_HD T lane_lex_key(const Lane<T>& L, int r, int kk, T piv_tol) {
    const T d = lane_at(L, L.d, r);
    const T dr = lk_abs(d) > piv_tol ? d : T(1);
    return -lane_row(L, r)[L.n + kk] / dr;
}

// Lexicographic refinement of the ncand tie candidates in L.clist over the
// -B^{-1} block (u-columns n+kk); returns how many are left, in L.clist.
// Pass kk keeps the candidates whose key is within eps of the least key; a
// pass that keeps them all changes nothing.  The threads look at nl passes
// at once, one each, take the first that drops a candidate, apply it, and
// go on behind it: the passes' outcomes are those of the loop kk = 0, 1, ...
template <typename T>
QPN_HD int lane_lex_refine(const Lane<T>& L, int ncand, T piv_tol, int lane,
                           int nl) {
    const int n = L.n;
    const T INF = lk_inf<T>();
    int kk0 = 0;
    while (ncand > 1 && kk0 < n) {
        const int kk = kk0 + lane;
        T kthr = T(0);
        bool drops = false;
        if (kk < n) {
            T kmin = INF, kmax = -INF;
            bool nan = false;
            for (int c = 0; c < ncand; ++c) {
                const T key = lane_lex_key(L, L.clist[c], kk, piv_tol);
                if (key < kmin) kmin = key;
                if (key > kmax) kmax = key;
                nan = nan || lk_isnan(key);
            }
            kthr = kmin + T(1e-12) * (T(1) + lk_abs(kmin));
            drops = nan || !(kmax <= kthr);
        }
        const unsigned m = lk_ballot(drops);
        if (m == 0u) {
            kk0 += nl;
            continue;
        }
        const int src = lk_lowest(m);
        kthr = lk_broadcast(kthr, src);
        int kept = 0;
        for (int base = 0; base < ncand; base += nl) {
            const int c = base + lane;
            const int r = c < ncand ? L.clist[c] : 0;
            const bool keep =
                c < ncand && lane_lex_key(L, r, kk0 + src, piv_tol) <= kthr;
            QPN_SYNCWARP();                  // reads before the writes below
            kept = lk_append(L.clist, kept, r, keep, lane);
        }
        QPN_SYNCWARP();
        ncand = kept;
        kk0 += src + 1;
    }
    return ncand;
}

// Phase B, called together by the nl threads of the deciding warp (lane of
// nl; 0 of 1 on the host): ray / bound flip / pivot-row choice after the
// ratio test; thread 0 writes the outcome to ctl, with the bookkeeping of a
// step that is no pivot.  Every branch is taken by all the threads alike.
// kPublished: the least ratio from the ranks' published ones (the fused
// loop), else a scan of every rank's ratios.
template <typename T, bool kPublished = false>
QPN_HD void lane_decide(const Lane<T>& L, T tol, T piv_tol, int max_pivots,
                        int lane, int nl) {
    const int n = L.n, T_ID = 3 * n;
    LaneCtl<T>* c = L.ctl;
    const int ent = c->ent;
    const T edir = c->edir, ev = c->ev;
    int act = ACT_NONE, status = 0, js = 0;
    bool flip = false;
    T pe = T(0);

    QPN_PROF_START();
    T tstar = lk_inf<T>();
    if (kPublished) {
        tstar = lane_published_min(L, lane, nl);
    } else {
        for (int k = 0; k < L.R; ++k) {
            const T m = lk_scan_min(lk_peer(L, L.theta, k),
                                    lane_rows_of(L, k), lane, nl);
            if (m < tstar) tstar = m;
        }
    }
    QPN_PROF(c, 4, lane == 0);
    const T theta_e = edir > T(0) ? L.vub[ent] - ev : ev - L.vlb[ent];

    if (!lk_isfinite(tstar) && !lk_isfinite(theta_e)) {
        status = LEMKE_RAY;                  // no pivot counted
    } else if (theta_e <= tstar) {
        flip = true;                         // bound flip: no basis change
    } else {
        const T thr = tstar + tol * (T(1) + lk_abs(tstar));
        int ncand = 0;
        js = n;
        for (int k = 0; k < L.R; ++k)
            ncand = lk_scan_ties(lk_peer(L, L.theta, k),
                                 lk_peer(L, L.basis, k), lane_rows_of(L, k),
                                 thr, T_ID, L.clist, ncand, k * L.nb, n, &js,
                                 lane, nl);
        QPN_SYNCWARP();
        QPN_PROF(c, 5, lane == 0);
        if (js == n) {                       // else t exits on a tie
            ncand = lane_lex_refine(L, ncand, piv_tol, lane, nl);
            js = ncand > 0 ? L.clist[0] : 0; // argmax convention: 0 if none
        }
        QPN_PROF(c, 6, lane == 0);
        pe = lane_row(L, js)[ent];
        if (lk_abs(pe) < piv_tol) status = LEMKE_SINGULAR;  // no pivot
        else act = ACT_PIVOT;
    }

    if (lane == 0) {
        c->act = act;
        if (act == ACT_PIVOT) {              // lane_stage goes on
            c->jstar = js;
            c->col = ent;
            c->pe = pe;
            QPN_PROF(c, 7, true);
            return;
        }
        if (status != 0) {
            c->status = status;
        } else {                             // bound flip
            const int i = ent % n;
            L.val[ent] = edir > T(0) ? L.vub[ent] : L.vlb[ent];
            c->ent = edir > T(0) ? 2 * n + i : n + i;
            c->edir = T(1);
            c->ev = T(0);
            c->piv += 1;
        }
        lane_advance(L, max_pivots);
    }
    QPN_PROF(c, 7, lane == 0);
}

// After a pivot is decided, by all the lane's threads: the scaled pivot row
// (pr, from its owner) and the band's entering column (other) are staged
// for the update, one element a thread, while thread 0 does the
// bookkeeping.  Where the block has more than one warp, the first warp
// stages nothing.
template <typename T>
QPN_HD void lane_stage(const Lane<T>& L, int max_pivots, int tid, int nthr) {
    const int n = L.n, W = 3 * n + 2;
    const LaneCtl<T>* c = L.ctl;
    const int js = c->jstar, col = c->col;
    const T pe = c->pe;
    const int first = nthr > QPN_WARP ? QPN_WARP : 0;
    if (tid >= first) {
        const T* prow = lane_row(L, js);
        for (int i = tid - first; i < W + L.rows; i += nthr - first) {
            if (i < W) L.pr[i] = prow[i] / pe;
            else L.other[i - W] = L.tab[(i - W) * L.ld + col];
        }
    }
    if (tid == 0) {
        lane_commit(L);
        lane_advance(L, max_pivots);
    }
}

// ---- phase C ---------------------------------------------------------------
// The rank-1 update of the band from the staged pivot row and entering
// column.  Each warp takes four of its rows at a time (rows wp, wp + nw,
// ...), keeps their entries of the entering column in registers, and walks
// the columns with its lanes, all four loads before the stores, so that
// the shared-memory latencies overlap.  The pivot row's owner records the
// basis exchange.
template <typename T>
QPN_HD void lane_update(const Lane<T>& L, int tid, int nthr) {
    const int n = L.rows, W = 3 * L.n + 2, ld = L.ld;
    const int lane = tid % QPN_WARP, wp = tid / QPN_WARP;
    const int nw = nthr / QPN_WARP;
    const int js = L.ctl->jstar - L.r0;     // out of [0, rows) off the band
    if (tid == 0 && js >= 0 && js < n) L.basis[js] = L.ctl->col;
    for (int r = wp; r < n; r += 4 * nw) {
        bool on[4];
        T o[4];
        T* e[4];
        QPN_UNROLL
        for (int k = 0; k < 4; ++k) {
            const int rk = r + k * nw;
            on[k] = rk < n;                  // alike across the warp
            o[k] = on[k] ? L.other[rk] : T(0);
            e[k] = L.tab + (size_t)(on[k] ? rk : r) * ld;
        }
        for (int j = lane; j < W; j += QPN_WARP) {
            const T p = L.pr[j];
            T v[4];
            QPN_UNROLL
            for (int k = 0; k < 4; ++k) v[k] = on[k] ? e[k][j] : T(0);
            QPN_UNROLL
            for (int k = 0; k < 4; ++k)
                if (on[k]) e[k][j] = r + k * nw == js ? p : v[k] - o[k] * p;
        }
    }
}

// The pivot loop of one rank of a lane on the card; every thread of the
// rank calls it.  nthr is a multiple of QPN_WARP (so of kLemkeSplit too).
// The host runs the same phases between the same barriers for each rank
// in turn (lemke_lane_host.cpp).
template <typename T>
QPN_HD void lane_run(const Lane<T>& L, int tid, int nthr, T tol, T piv_tol,
                     int max_pivots) {
    LaneCtl<T>* c = L.ctl;
    QPN_PROF_START();
    while (c->status == 0 && c->k < max_pivots) {
        lane_basic_values(L, tid, nthr, true, piv_tol);
        lane_sync_ranks(L);                  // B reads every band's ratios
        QPN_PROF(c, 0, tid == 0);
        if (tid < QPN_WARP)
            lane_decide(L, tol, piv_tol, max_pivots, tid, QPN_WARP);
        QPN_SYNC();
        QPN_PROF(c, 1, tid == 0);
        const bool pivot = c->act == ACT_PIVOT;
        if (pivot) lane_stage(L, max_pivots, tid, nthr);
        // C and the next A overwrite what peers read in B and S
        if (pivot || L.R > 1) lane_sync_ranks(L);
        QPN_PROF(c, 2, tid == 0 && pivot);
        if (pivot) {
            lane_update(L, tid, nthr);
            QPN_SYNC();
            QPN_PROF(c, 3, tid == 0);
        }
    }
#if defined(QPN_LEMKE_PROFILE) && defined(__CUDA_ARCH__)
    if (tid == 0 && blockIdx.x < 2)
        printf("lemke_phases block %d iterations %d cycles ratios %lld "
               "decide %lld stage %lld update %lld | in decide: min %lld "
               "ties %lld lex %lld rest %lld\n", (int)blockIdx.x, c->k - 1,
               c->prof[0], c->prof[1], c->prof[2], c->prof[3], c->prof[4],
               c->prof[5], c->prof[6], c->prof[7]);
#endif
    lane_basic_values(L, tid, nthr, false, piv_tol);
    if (tid == 0 && c->status == 0) c->status = LEMKE_MAX;
    QPN_SYNC();
}

// The cluster instance's pivot loop: a pivot is B, S and the fused pass
// (C of the pivot and A of the next step), with a barrier of the ranks
// after the pass and after S.  A step that is no pivot runs the pass
// without the update (its values changed).  The last pass leaves the final
// basic values.  The host runs the same phases between the same barriers
// for each rank in turn (lemke_lane_host.cpp).  Profile slots: 0 the
// barrier after the pass, 1 B, 2 S with its barrier, 3 the pass.
template <typename T>
QPN_HD void lane_run_fused(const Lane<T>& L, int tid, int nthr, T tol,
                           T piv_tol, int max_pivots) {
    LaneCtl<T>* c = L.ctl;
    lane_pass(L, tid, nthr, piv_tol, false);
    QPN_PROF_START();
    while (c->status == 0 && c->k < max_pivots) {
        lane_sync_ranks(L);                  // B reads every band's ratios
        QPN_PROF(c, 0, tid == 0);
        if (tid < QPN_WARP)
            lane_decide<T, true>(L, tol, piv_tol, max_pivots, tid, QPN_WARP);
        QPN_SYNC();
        QPN_PROF(c, 1, tid == 0);
        const bool pivot = c->act == ACT_PIVOT;
        if (pivot) lane_stage(L, max_pivots, tid, nthr);
        // the pass overwrites what peers read in B and S
        lane_sync_ranks(L);
        QPN_PROF(c, 2, tid == 0 && pivot);
        lane_pass(L, tid, nthr, piv_tol, pivot);
        QPN_PROF(c, 3, tid == 0);
    }
#if defined(QPN_LEMKE_PROFILE) && defined(__CUDA_ARCH__)
    if (tid == 0 && blockIdx.x < 2)
        printf("lemke_fused_phases block %d iterations %d cycles barrier "
               "%lld decide %lld stage %lld pass %lld | in decide: min %lld "
               "ties %lld lex %lld rest %lld\n", (int)blockIdx.x, c->k - 1,
               c->prof[0], c->prof[1], c->prof[2], c->prof[3], c->prof[4],
               c->prof[5], c->prof[6], c->prof[7]);
#endif
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
