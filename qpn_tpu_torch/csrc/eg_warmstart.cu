// Fused extragradient warm start for batches of box AVIs on NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel qpn_tpu/ops/pallas_kernels.py:57
// _eg_kernel (launched by _eg_call): all `steps` extragradient steps of each
// lane run inside one launch, with no device-memory traffic between steps.
//
// What bounds it on this card: latency, not bytes or operations.  A lane
// does 2·n² multiply-adds per half-step (n = 38 on the flagship ensemble),
// thousands of steps in a row, each half-step depending on the one before:
// the time is the length of one half-step's dependent chain times twice the
// steps.  The matrix is read from device memory once.
//
// Design (the register kernel, eg_register_kernel<C>): one thread block
// per lane, and the lane's matrix lives in registers.  A row is split over a
// group of G neighbouring threads of one warp (n·G threads a block: 152 at
// n = 38, G = 4); a thread holds its C entries of the row and the row's q,
// l, u and z for all steps.  A half-step is C multiply-adds on registers
// against z read from shared memory (the threads of a warp read G distinct
// addresses: broadcasts, no bank conflicts), log2 G xor shuffles, the clip,
// and one store of the row's new value by the group's first thread.  z and
// z½ are a ping-pong pair in shared memory with one barrier per half-step.
// G = 4 (eg_lane.cuh::kEgGroup; 8 threads a row measured no faster on an
// H100), and the launcher picks the instance's C from n
// (eg_lane.cuh::eg_pick_chunk).  Rows beyond the instances (n > 128) take
// one of three more instances, which the wrapper picks from n and the
// card's opt-in limit before the launch (eg_lane.cuh::eg_instance):
//   * block (eg_block_kernel<C>, EG_SHARED; n = 129-238 on an H100): the
//     cluster instance's design below on one block.  A row is split over a
//     group of G = 4 neighbouring threads in the partition (kEgGroup,
//     C = eg_cluster_chunk(n)): 36 columns a chunk at n = 129, 48 at 190,
//     60 at 238.  A thread sums eg_block_rows(C) rows, s + h·P (P the
//     block's groups), and holds the first eg_block_regs(C) entries of its
//     chunk of each in registers for all steps: the whole chunk of three
//     rows up to C = kEgBlockRegs = 48 (256 threads at n = 190, all of M
//     in registers), past it the first 48 entries of two rows, the rest in
//     shared memory, 16 bytes a thread, neighbouring threads on
//     neighbouring addresses (480 threads at n = 238).  z and z½
//     are a ping-pong pair in shared memory by chunks, eg_cluster_stride
//     apart (the four chunks a warp reads lie on different banks), and
//     each 16-byte load of z feeds every row of the thread.  A half-step is
//     the chunks' multiply-adds, the butterfly, the clip, the store of each
//     row's new entry and one __syncthreads.  What bounds it: the f32
//     issue, 2·n·4C instructions a half-step with -fmad=false (a product
//     and its sum are two) on the SM's 128 f32 lanes, one lane a block and
//     one block an SM (its threads take the register file), so 256 lanes
//     run in two waves on 132 SMs; then the chain of a chunk's C dependent
//     adds, and the butterfly, clip, store and barrier that end each
//     half-step.  Tuned with -Xptxas -v and the card's clock at n =
//     129-238: four rows a thread, or two lanes an SM with more of M in
//     shared memory, measured slower; three rows past 48 columns spill
//     (times: PERF.md §6, "K2 shared").  Its lanes sum in the 4-chunk
//     partition, not in column order: their z lies within 1e-5 of the
//     lane scale of the plain loop's after 300 steps;
//   * cluster (eg_cluster_kernel): the lane spread over a cluster of
//     R = 2-8 blocks on neighbouring SMs, for n = 239-671 on an H100
//     (eg_cluster_ranks: the fewest whose rank fits 320 threads and the
//     limit; n=304 on 2).  Rank k holds a band of M's rows, split as the
//     register kernel splits a row: a group of G = 4 neighbouring threads
//     on two rows, thread g holding chunk g of C = eg_cluster_chunk(n)
//     columns of each, its first kEgClusterRegs entries in registers for
//     all steps and the rest in shared memory (16 bytes a thread,
//     neighbouring threads on neighbouring addresses), loaded once; z and
//     z½ in shared memory by chunks (eg_cluster_stride apart: the four
//     chunks a warp reads lie on different banks).  A half-step is the
//     chunks' multiply-adds, each 16-byte load of z serving both rows and
//     issued ahead of the adds that wait for it (no guard between the
//     loads: the launcher requires a chunk of at least kEgClusterRegs
//     columns), the butterflies, the clips, and the new entries written
//     into the ranks through distributed shared memory, thread g of a
//     group writing ranks g, g + G, ...; then one cluster barrier (a
//     ping-pong pair, as the register kernel's).  What bounds it: with
//     -fmad=false a product and its sum are two instructions, 2·nb·4C a
//     rank a half-step on the SM's 128 f32 lanes, the latency of a warp's
//     chain of loads and adds, then the cluster barrier, about a third of
//     a half-step at n=304 on an H100; one block an SM (its threads take
//     the register file).  Launched with cudaLaunchKernelEx and a cluster
//     dimension; the first launch at each size checks that such a cluster fits the
//     card (cudaOccupancyMaxActiveClusters) and returns CUDA's error where
//     it does not: there is no fallback to another instance;
//   * global: past 8 ranks.  Where B lanes leave SMs idle, a lane is
//     spread over R blocks on any SMs (eg_global_ranks): rank k keeps its
//     band of M's rows in its own shared memory where the band fits (n=684
//     from R = 9), else in the lane's column-major copy in device memory;
//     each half-step writes the band's new entries into the lane's z or z½
//     in device memory, the ranks meet at the lane's barrier there
//     (lane_barrier.cuh), and each copies the whole vector into its shared
//     memory before the next row sums.  Launched cooperatively
//     (cluster_launch.cuh::launch_cooperative): a grid that cannot be
//     resident at once is refused with CUDA's error, and nothing else is
//     tried.  Bound by the chain of n dependent adds a row, plus the
//     barrier and the gather a half-step.  At R = 1 (B fills the card) it
//     is one block a lane, a plain launch, with z, z½, q, l and u in shared
//     memory and M read every half-step from the lane's column-major copy,
//     which the block writes at its start: a thread sums a row in column
//     order, so the threads of a warp read neighbouring entries of one
//     column, one 128-byte line a load (M's rows in place would be 32
//     lines a load).  Bound by the bytes of M it streams, n² floats a
//     half-step a lane, from device memory where the batch's M passes the
//     L2.  The
//     wrapper's private launcher also runs it at cluster sizes, and at
//     R = 1 where the pick spreads it, to hold the instances against each
//     other on the card.
// Every row sums in plain column order in the generic kernel (the global
// instance) at any ranks, so its carvings give the same bits; the block and
// cluster instances sum in the partition (kEgGroup, eg_cluster_chunk(n)),
// and the host loop walks it too.
//
// The order of every sum is defined in eg_lane.cuh, where a loop walks the
// same partition for the host instance.  Built with nvcc -O3 -fmad=false,
// no fast math (utils/cuda_build.py), so each product and sum rounds
// separately, as in the plain PyTorch version.
//
// C interface (ctypes): qpn_eg_warmstart_f32 (the register kernel or the
// block instance, picked from n), qpn_eg_warmstart_cluster_f32 and
// qpn_eg_warmstart_global_f32 (given their ranks) return 0 or a
// cudaError_t; qpn_eg_instance, qpn_eg_cluster_ranks and
// qpn_eg_global_ranks (and qpn_eg_pick_chunk) are the pure choice,
// qpn_eg_smem_optin and
// qpn_eg_global_resident what it takes from the current card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Phase clocks of the cluster instance, compiled in only with
// -DQPN_EG_PROFILE (tools/torch_cluster_phases.py): thread 0 of each block
// adds the SM cycles of a half-step's chunk sums, of its exchange (the
// butterflies, the clips and the writes into the ranks) and of its
// cluster barrier, and the first two blocks print them.
#if defined(QPN_EG_PROFILE)
#include <cstdio>
#endif

#include "cluster_launch.cuh"
#include "eg_lane.cuh"
#include "lane_barrier.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kGenericMaxThreads = 256;
constexpr int G = qpn::kEgGroup;

// The steps of rank `rank` of lane b of the global instance, every thread
// of the block.
__device__ __forceinline__ void run_rank(const qpn::EGBatch& bt, float* smem,
                                         int R, int rank, size_t b, int copy,
                                         float* xg, unsigned* bars,
                                         float* mt) {
    const bool spread = R > 1;
    const qpn::EGLane L = qpn::eg_lane_carve_global(
        bt, b, smem, R, rank, copy != 0,
        spread ? xg + b * qpn::eg_exchange_floats(bt.n) : nullptr,
        spread ? bars + 2 * b : nullptr,
        copy ? nullptr : mt + b * (size_t)bt.n * bt.n);
    qpn::eg_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::eg_lane_run<1>(L, bt.tau[b], bt.steps, bt.n, threadIdx.x,
                        blockDim.x);
    qpn::eg_lane_store(L, bt, b, threadIdx.x, blockDim.x);
}

// EG_GLOBAL: R blocks a lane on any SMs, rank k's band of M in its shared
// memory (`copy`) or in the lane's column-major copy at mt + b · n², the
// lane's z and z½ at xg + b · eg_exchange_floats(n) and its barrier at
// bars + 2b (R > 1).
__global__ void __launch_bounds__(kGenericMaxThreads)
eg_generic_kernel(qpn::EGBatch bt, int R, int copy, float* xg,
                  unsigned* bars, float* mt) {
    extern __shared__ __align__(16) float smem[];
    if (R == 1) {
        // one block a lane: R = 1 known to the compiler (the launch at
        // R = 1 takes this path, the code it had before it spread)
        run_rank(bt, smem, 1, 0, blockIdx.x, 0, nullptr, nullptr, mt);
        return;
    }
    run_rank(bt, smem, R, (int)(blockIdx.x % R), blockIdx.x / R, copy, xg,
             bars, mt);
}

// EG_SHARED: one block a lane, its rows split between the threads'
// registers and the block's shared memory (the file's notes).  C is the
// chunk, eg_cluster_chunk(n).  Thread tid is chunk g = tid % 4 of rows
// s + h·P, h < eg_block_rows(C), s = tid / 4, P the block's groups; every
// row's sum reads the same entries of z (or z½).
template <int C>
__global__ void __launch_bounds__(qpn::eg_block_threads(G * C), 1)
eg_block_kernel(qpn::EGBatch bt) {
    constexpr int K = qpn::eg_block_regs(C), NR = qpn::eg_block_rows(C);
    constexpr int CS = C | 4;                      // eg_cluster_stride(n)
    constexpr int quads = (C - K) / 4;             // 16-byte groups in smem
    static_assert(C % 4 == 0 && K % 4 == 0, "whole 16-byte groups");
    extern __shared__ __align__(16) float smem[];
    const size_t b = blockIdx.x;
    const int n = bt.n, tid = threadIdx.x, nthr = blockDim.x;
    const int g = tid % G, P = nthr / G;
    float* zs = smem;                              // z, G chunks CS apart
    float* zhs = zs + G * CS;                      // z½
    // (quads, NR, nthr): what the registers do not hold
    float4* ms = reinterpret_cast<float4*>(zhs + G * CS);

    bool on[NR];
    int r[NR], put[NR];
    float m[NR][K], q[NR], lo[NR], hi[NR], z[NR];
#pragma unroll
    for (int h = 0; h < NR; ++h) {
        const int i = tid / G + h * P;
        on[h] = i < n;
        r[h] = on[h] ? i : 0;
        // where the row's entry lies in the chunked vectors
        put[h] = (r[h] / C) * CS + r[h] % C;
        const float* Mi = bt.M + (b * n + r[h]) * (size_t)n + g * C;
#pragma unroll
        for (int k = 0; k < K; ++k)
            m[h][k] = on[h] && g * C + k < n ? Mi[k] : 0.0f;
#pragma unroll
        for (int p = 0; p < quads; ++p) {
            float v[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int k = K + 4 * p + c;
                v[c] = on[h] && g * C + k < n ? Mi[k] : 0.0f;
            }
            ms[(p * NR + h) * nthr + tid] = make_float4(v[0], v[1], v[2], v[3]);
        }
        const size_t at = b * n + r[h];
        q[h] = on[h] ? bt.q[at] : 0.0f;
        lo[h] = on[h] ? bt.l[at] : 0.0f;
        hi[h] = on[h] ? bt.u[at] : 0.0f;
        z[h] = on[h] ? bt.z0[at] : 0.0f;
    }
    const float tau = bt.tau[b];
    // z0 into z by chunks, zeros past column n and in the gaps; z½ zeroed
    for (int p = tid; p < G * CS; p += nthr) {
        const int c = p / CS, k = p - c * CS, j = c * C + k;
        zs[p] = k < C && j < n ? bt.z0[b * n + j] : 0.0f;
        zhs[p] = 0.0f;
    }
    __syncthreads();
    for (int s = 0; s < 2 * bt.steps; ++s) {
        const float* x = (s & 1 ? zhs : zs) + g * CS;
        float* y = s & 1 ? zs : zhs;
        float acc[NR];
#pragma unroll
        for (int h = 0; h < NR; ++h) acc[h] = 0.0f;
#pragma unroll
        for (int k = 0; k < K; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(x + k);
#pragma unroll
            for (int h = 0; h < NR; ++h) {
                acc[h] = acc[h] + m[h][k] * v.x;
                acc[h] = acc[h] + m[h][k + 1] * v.y;
                acc[h] = acc[h] + m[h][k + 2] * v.z;
                acc[h] = acc[h] + m[h][k + 3] * v.w;
            }
        }
#pragma unroll
        for (int p = 0; p < quads; ++p) {
            const float4 v = *reinterpret_cast<const float4*>(x + K + 4 * p);
#pragma unroll
            for (int h = 0; h < NR; ++h) {
                const float4 w = ms[(p * NR + h) * nthr + tid];
                acc[h] = acc[h] + w.x * v.x;
                acc[h] = acc[h] + w.y * v.y;
                acc[h] = acc[h] + w.z * v.z;
                acc[h] = acc[h] + w.w * v.w;
            }
        }
#pragma unroll
        for (int h = 0; h < NR; ++h) {
            const float F = qpn::eg_tree<G>(acc[h]) + q[h];
            const float znew = qpn::eg_clip(z[h] - tau * F, lo[h], hi[h]);
            if (on[h] && g == 0) y[put[h]] = znew;
            if (s & 1) z[h] = znew;         // the second half-step moves z
        }
        __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < NR; ++h)
        if (on[h] && g == 0) bt.z_out[b * n + r[h]] = z[h];
}

// EG_CLUSTER: one cluster of R blocks a lane, rank k's band of M's rows
// split between its threads' registers and its shared memory (the file's
// notes).  Thread tid is chunk g = tid % 4 of band rows s and s + P, s =
// tid / 4, P the block's groups; both rows' sums read the same entries of
// z (or z½).
__global__ void __launch_bounds__(qpn::kEgClusterThreads, 1)
eg_cluster_kernel(qpn::EGBatch bt, int R) {
    constexpr int K = qpn::kEgClusterRegs, NR = qpn::kEgClusterRows;
    static_assert(K % 4 == 0, "registers hold whole 16-byte groups");
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const size_t b = blockIdx.x / R;
    const int n = bt.n, tid = threadIdx.x, nthr = blockDim.x;
    const int C = qpn::eg_cluster_chunk(n), CS = qpn::eg_cluster_stride(n);
    const int nb = qpn::eg_band_height(n, R), r0 = rank * nb;
    const int rows = n - r0 < nb ? (n - r0 < 0 ? 0 : n - r0) : nb;
    const int g = tid % G, P = nthr / G;
    const int quads = C > K ? (C - K) / 4 : 0;    // 16-byte groups in smem
    float* zs = smem;                              // z, G chunks CS apart
    float* zhs = zs + G * CS;                      // z½
    // (quads, NR, nthr): what the registers do not hold
    float4* ms = reinterpret_cast<float4*>(zhs + G * CS);

    bool on[NR];
    int r[NR], put[NR];
    float m[NR][K], q[NR], lo[NR], hi[NR], z[NR];
#pragma unroll
    for (int h = 0; h < NR; ++h) {
        const int i = tid / G + h * P;
        on[h] = i < rows;
        r[h] = r0 + (on[h] ? i : 0);
        // where the row's entry lies in the chunked vectors
        put[h] = (r[h] / C) * CS + r[h] % C;
        const float* Mi = bt.M + (b * n + r[h]) * (size_t)n + g * C;
#pragma unroll
        for (int k = 0; k < K; ++k)
            m[h][k] = on[h] && g * C + k < n ? Mi[k] : 0.0f;
        for (int p = 0; p < quads; ++p) {
            float v[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int k = K + 4 * p + c;
                v[c] = on[h] && g * C + k < n ? Mi[k] : 0.0f;
            }
            ms[(p * NR + h) * nthr + tid] = make_float4(v[0], v[1], v[2], v[3]);
        }
        const size_t at = b * n + r[h];
        q[h] = on[h] ? bt.q[at] : 0.0f;
        lo[h] = on[h] ? bt.l[at] : 0.0f;
        hi[h] = on[h] ? bt.u[at] : 0.0f;
        z[h] = on[h] ? bt.z0[at] : 0.0f;
    }
    const float tau = bt.tau[b];
    // z0 into z by chunks, zeros past column n and in the gaps; z½ zeroed
    for (int p = tid; p < G * CS; p += nthr) {
        const int c = p / CS, k = p - c * CS, j = c * C + k;
        zs[p] = k < C && j < n ? bt.z0[b * n + j] : 0.0f;
        zhs[p] = 0.0f;
    }
    // every rank has started before any writes into another
    cluster.sync();
#if defined(QPN_EG_PROFILE)
    long long t_sum = 0, t_put = 0, t_bar = 0;
#endif
    for (int s = 0; s < 2 * bt.steps; ++s) {
#if defined(QPN_EG_PROFILE)
        const long long t0 = clock64();
#endif
        const float* x = (s & 1 ? zhs : zs) + g * CS;
        float* y = s & 1 ? zs : zhs;
        float acc[NR];
#pragma unroll
        for (int h = 0; h < NR; ++h) acc[h] = 0.0f;
        // K <= C (the launcher's check): no guard between the loads, so
        // that they issue ahead of the adds that wait for them
#pragma unroll
        for (int k = 0; k < K; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(x + k);
#pragma unroll
            for (int h = 0; h < NR; ++h) {
                acc[h] = acc[h] + m[h][k] * v.x;
                acc[h] = acc[h] + m[h][k + 1] * v.y;
                acc[h] = acc[h] + m[h][k + 2] * v.z;
                acc[h] = acc[h] + m[h][k + 3] * v.w;
            }
        }
        for (int p = 0; p < quads; ++p) {
            const float4 v = *reinterpret_cast<const float4*>(x + K + 4 * p);
#pragma unroll
            for (int h = 0; h < NR; ++h) {
                const float4 w = ms[(p * NR + h) * nthr + tid];
                acc[h] = acc[h] + w.x * v.x;
                acc[h] = acc[h] + w.y * v.y;
                acc[h] = acc[h] + w.z * v.z;
                acc[h] = acc[h] + w.w * v.w;
            }
        }
#if defined(QPN_EG_PROFILE)
        const long long ts = clock64();
#endif
#pragma unroll
        for (int h = 0; h < NR; ++h) {
            const float F = qpn::eg_tree<G>(acc[h]) + q[h];
            const float znew = qpn::eg_clip(z[h] - tau * F, lo[h], hi[h]);
            if (on[h])
                for (int k = g; k < R; k += G)
                    cluster.map_shared_rank(y, k)[put[h]] = znew;
            if (s & 1) z[h] = znew;         // the second half-step moves z
        }
#if defined(QPN_EG_PROFILE)
        const long long t1 = clock64();
#endif
        cluster.sync();
#if defined(QPN_EG_PROFILE)
        t_sum += ts - t0;
        t_put += t1 - ts;
        t_bar += clock64() - t1;
#endif
    }
#if defined(QPN_EG_PROFILE)
    if (tid == 0 && blockIdx.x < 2)
        printf("eg_cluster_phases block %d half-steps %d cycles sums %lld "
               "exchange %lld barrier %lld\n", (int)blockIdx.x, 2 * bt.steps,
               t_sum, t_put, t_bar);
#endif
    // the last barrier follows every write into a peer
#pragma unroll
    for (int h = 0; h < NR; ++h)
        if (on[h] && g == 0) bt.z_out[b * n + r[h]] = z[h];
}

constexpr int block_threads(int C) {
    return (G * G * C + 31) / 32 * 32;
}

template <int C>
__global__ void __launch_bounds__(block_threads(C))
eg_register_kernel(qpn::EGBatch bt) {
    constexpr int NP = G * C;               // padded row length
    __shared__ float xs[2][NP];
    const int n = bt.n, tid = threadIdx.x;
    const int g = tid % G, i = tid / G;     // chunk and row of this thread
    const bool row = i < n;
    const size_t b = blockIdx.x;
    const float tau = bt.tau[b];
    const float* Mb = bt.M + b * (size_t)n * n;

    float m[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const int j = g * C + k;
        m[k] = row && j < n ? Mb[(size_t)i * n + j] : 0.0f;
    }
    const float q = row ? bt.q[b * n + i] : 0.0f;
    const float lo = row ? bt.l[b * n + i] : 0.0f;
    const float hi = row ? bt.u[b * n + i] : 0.0f;
    float z = row ? bt.z0[b * n + i] : 0.0f;
    for (int j = tid; j < NP; j += blockDim.x) {
        xs[0][j] = j < n ? bt.z0[b * n + j] : 0.0f;
        xs[1][j] = 0.0f;
    }
    __syncthreads();

    for (int s = 0; s < 2 * bt.steps; ++s) {
        const float* src = xs[s & 1];
        float x[C];
#pragma unroll
        for (int k = 0; k < C; ++k) x[k] = src[g * C + k];
        const float F = qpn::eg_tree<G>(qpn::eg_chunk<C>(m, x)) + q;
        const float znew = qpn::eg_clip(z - tau * F, lo, hi);
        if (g == 0 && row) xs[(s & 1) ^ 1][i] = znew;
        if (s & 1) z = znew;                // the second half-step moves z
        __syncthreads();
    }
    if (g == 0 && row) bt.z_out[b * n + i] = z;
}

template <int C>
int launch_register(const qpn::EGBatch& bt, cudaStream_t stream) {
    const int threads = (bt.n * G + 31) / 32 * 32;
    eg_register_kernel<C><<<bt.B, threads, 0, stream>>>(bt);
    return cudaGetLastError();
}

int generic_threads(int n) {
    const int threads = (n + 31) / 32 * 32;
    return threads > kGenericMaxThreads ? kGenericMaxThreads : threads;
}

template <int C>
int launch_block(const qpn::EGBatch& bt, cudaStream_t stream) {
    const size_t bytes = qpn::eg_block_bytes(bt.n);
    auto kernel = eg_block_kernel<C>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    kernel<<<bt.B, qpn::eg_block_threads(bt.n), bytes, stream>>>(bt);
    return cudaGetLastError();
}

// The register kernel where an instance of it takes n, else the block
// instance where one takes the chunk (n up to 240), else refused.
int launch(const qpn::EGBatch& bt, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0) return 0;
    switch (qpn::eg_pick_chunk(bt.n)) {
    case 4: return launch_register<4>(bt, stream);
    case 10: return launch_register<10>(bt, stream);
    case 16: return launch_register<16>(bt, stream);
    case 32: return launch_register<32>(bt, stream);
    }
    switch (qpn::eg_cluster_chunk(bt.n)) {
    case 36: return launch_block<36>(bt, stream);
    case 40: return launch_block<40>(bt, stream);
    case 44: return launch_block<44>(bt, stream);
    case 48: return launch_block<48>(bt, stream);
    case 52: return launch_block<52>(bt, stream);
    case 56: return launch_block<56>(bt, stream);
    case 60: return launch_block<60>(bt, stream);
    }
    return cudaErrorInvalidValue;
}

// Floats a lane of the column-major copy of M that the global instance at
// R ranks reads on the current card: n · n where the bands are read in
// place (R = 1, or a band past the opt-in limit), else 0.
size_t global_copy_floats(int n, int R) {
    return qpn::eg_global_band_fits(n, R, qpn::smem_optin())
        ? 0 : (size_t)n * n;
}

// R = 1: a plain launch, one block a lane, M read from its column-major
// copy at mt; R > 1: the cooperative launch of B · R blocks, whose
// barriers (2 words a lane) the caller has zeroed, each band in shared
// memory where it fits the card's limit, else in the copy at mt.
int launch_global(const qpn::EGBatch& bt, int R, float* xg, unsigned* bars,
                  float* mt, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0) return 0;
    if (R < 1 || (R > 1 && (xg == nullptr || bars == nullptr)))
        return cudaErrorInvalidValue;
    const bool copy = global_copy_floats(bt.n, R) == 0;
    if (!copy && mt == nullptr) return cudaErrorInvalidValue;
    auto kernel = eg_generic_kernel;
    if (R == 1) {
        const size_t bytes = qpn::eg_global_lane_bytes(bt.n);
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return e;
        kernel<<<bt.B, generic_threads(bt.n), bytes, stream>>>(
            bt, 1, 0, nullptr, nullptr, mt);
        return cudaGetLastError();
    }
    const int nb = qpn::eg_band_height(bt.n, R);
    const size_t bytes =
        copy ? qpn::eg_band_bytes(bt.n, nb)
             : qpn::eg_vector_floats(bt.n, nb) * sizeof(float);
    return qpn::launch_cooperative(kernel, bt.B, R, generic_threads(nb),
                                   bytes, stream, bt, R, (int)copy, xg, bars,
                                   mt);
}

int launch_cluster(const qpn::EGBatch& bt, int R, cudaStream_t stream) {
    if (bt.n <= 0) return 0;
    if (R < 1) return cudaErrorInvalidValue;
    // the largest rank checked at each cluster size
    static size_t checked[qpn::kEgMaxRanks + 1] = {};
    const int nb = qpn::eg_band_height(bt.n, R);
    const int threads = qpn::eg_cluster_threads(nb);
    // a thread's registers hold the first kEgClusterRegs entries of its
    // chunk, which must have as many (n >= 225; the domain starts at 239)
    if (threads > qpn::kEgClusterThreads
        || qpn::eg_cluster_chunk(bt.n) < qpn::kEgClusterRegs)
        return cudaErrorInvalidValue;
    return qpn::launch_cluster(eg_cluster_kernel, checked, bt.B, R, threads,
                               qpn::eg_cluster_rank_bytes(bt.n, nb), stream,
                               bt, R);
}

}  // namespace

extern "C" {

int qpn_eg_warmstart_f32(QPN_EG_PARAMS, void* stream) {
    return launch(QPN_EG_BATCH, (cudaStream_t)stream);
}

// ranks: the lane's blocks (qpn_eg_global_ranks); exchange: B *
// qpn_eg_exchange_floats(n) floats of device memory and bars: 2 * B
// zeroed unsigned ints where ranks > 1; colmajor: B *
// qpn_eg_global_copy_floats(n, ranks) floats of device memory where that
// is not 0
int qpn_eg_warmstart_global_f32(QPN_EG_PARAMS, int ranks, void* exchange,
                                void* bars, void* colmajor, void* stream) {
    return launch_global(QPN_EG_BATCH, ranks, static_cast<float*>(exchange),
                         static_cast<unsigned*>(bars),
                         static_cast<float*>(colmajor), (cudaStream_t)stream);
}

long long qpn_eg_global_copy_floats(int n, int ranks) {
    return (long long)global_copy_floats(n, ranks);
}

// ranks: the cluster's blocks a lane (qpn_eg_cluster_ranks)
int qpn_eg_warmstart_cluster_f32(QPN_EG_PARAMS, int ranks, void* stream) {
    return launch_cluster(QPN_EG_BATCH, ranks, (cudaStream_t)stream);
}

int qpn_eg_instance(int n, long long smem_optin) {
    return qpn::eg_instance(n, smem_optin);
}

int qpn_eg_pick_chunk(int n) { return qpn::eg_pick_chunk(n); }

int qpn_eg_cluster_ranks(int n, long long smem_optin) {
    return qpn::eg_cluster_ranks(n, smem_optin);
}

int qpn_eg_global_ranks(int n, int B, long long resident,
                        long long smem_optin) {
    return qpn::eg_global_ranks(n, B, resident, smem_optin);
}

long long qpn_eg_exchange_floats(int n) {
    return (long long)qpn::eg_exchange_floats(n);
}

// The shared memory a block can opt into on the current card, or minus a
// cudaError_t.
long long qpn_eg_smem_optin(void) { return qpn::smem_optin(); }

// The blocks of the global instance the current card holds at once, each
// with the opt-in limit of shared memory (one an SM), or minus a
// cudaError_t.
long long qpn_eg_global_resident(void) {
    const long long optin = qpn::smem_optin();
    if (optin < 0) return optin;
    return qpn::resident_blocks(eg_generic_kernel,
                                kGenericMaxThreads, (size_t)optin);
}

const char* qpn_eg_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
