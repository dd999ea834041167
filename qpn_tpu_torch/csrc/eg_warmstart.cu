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
// the generic kernel: one thread per row, every row summed in column order.
// It has three instances, which the wrapper picks from n and the card's
// opt-in limit before the launch (eg_lane.cuh::eg_instance):
//   * shared: the matrix in one block's dynamic shared memory (n up to 238
//     on an H100); bound by the latency of a row's chain of n dependent
//     adds a half-step;
//   * cluster: the lane spread over a cluster of R = 2-8 blocks on
//     neighbouring SMs (eg_cluster_ranks: the fewest whose bands fit; n=304
//     on 2, up to n of about 680 on 8).  Rank k holds a band of M's rows
//     in its shared memory, loaded once, and a copy of z and z½; a
//     half-step computes the band's rows from the local copy, writes each
//     new entry into every rank's copy through distributed shared memory,
//     and ends at one cluster barrier (a ping-pong pair, as the register
//     kernel's).  Bound by the same chain as the shared instance, plus the
//     barrier, with one block an SM (a band fills its shared memory).
//     Launched with cudaLaunchKernelEx and a cluster dimension; the first
//     launch at each size checks that such a cluster fits the card
//     (cudaOccupancyMaxActiveClusters) and returns CUDA's error where it
//     does not: there is no fallback to another instance;
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
// Every row sums in plain column order in all of them, so they give the
// same bits.
//
// The order of every sum is defined in eg_lane.cuh, where a loop walks the
// same partition for the host instance.  Built with nvcc -O3 -fmad=false,
// no fast math (utils/cuda_build.py), so each product and sum rounds
// separately, as in the plain PyTorch version.
//
// C interface (ctypes): qpn_eg_warmstart_f32 (the register kernel or the
// shared instance, picked from n), qpn_eg_warmstart_cluster_f32 and
// qpn_eg_warmstart_global_f32 (given their ranks) return 0 or a
// cudaError_t; qpn_eg_instance, qpn_eg_cluster_ranks and
// qpn_eg_global_ranks are the pure choice, qpn_eg_smem_optin and
// qpn_eg_global_resident what it takes from the current card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "eg_lane.cuh"
#include "lane_barrier.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kGenericMaxThreads = 256;
constexpr int G = qpn::kEgGroup;

// The steps of rank `rank` of lane b, every thread of the block.
template <int kInstance>
__device__ __forceinline__ void run_rank(const qpn::EGBatch& bt, float* smem,
                                         int R, int rank, size_t b, int copy,
                                         float* xg, unsigned* bars,
                                         float* mt) {
    const bool spread = R > 1;
    const qpn::EGLane L = kInstance == qpn::EG_GLOBAL
        ? qpn::eg_lane_carve_global(
              bt, b, smem, R, rank, copy != 0,
              spread ? xg + b * qpn::eg_exchange_floats(bt.n) : nullptr,
              spread ? bars + 2 * b : nullptr,
              copy ? nullptr : mt + b * (size_t)bt.n * bt.n)
        : qpn::eg_lane_carve(smem, bt.n, R, rank);
    qpn::eg_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::eg_lane_run<1>(L, bt.tau[b], bt.steps, bt.n, threadIdx.x,
                        blockDim.x);
    qpn::eg_lane_store(L, bt, b, threadIdx.x, blockDim.x);
}

// EG_SHARED: M copied to the block's shared memory; EG_CLUSTER: one
// cluster of R blocks a lane, rank k's band of M in block k's shared
// memory; EG_GLOBAL: R blocks a lane on any SMs, rank k's band of M in its
// shared memory (`copy`) or in the lane's column-major copy at mt + b · n²,
// the lane's z and z½ at xg + b · eg_exchange_floats(n) and its barrier at
// bars + 2b (R > 1).
template <int kInstance>
__global__ void __launch_bounds__(kGenericMaxThreads)
eg_generic_kernel(qpn::EGBatch bt, int R, int copy, float* xg,
                  unsigned* bars, float* mt) {
    extern __shared__ __align__(16) float smem[];
    const bool cluster = kInstance == qpn::EG_CLUSTER;
    if (kInstance == qpn::EG_SHARED
        || (kInstance == qpn::EG_GLOBAL && R == 1)) {
        // one block a lane: R = 1 known to the compiler (the global
        // instance's launch at R = 1 takes this path, the code it had
        // before it spread)
        run_rank<kInstance>(bt, smem, 1, 0, blockIdx.x, 0, nullptr, nullptr,
                            mt);
        return;
    }
    const int rank = cluster ? (int)cg::this_cluster().block_rank()
                             : (int)(blockIdx.x % R);
    run_rank<kInstance>(bt, smem, R, rank, blockIdx.x / R, copy, xg, bars,
                        mt);
    // no block leaves while a peer may still write into its shared memory
    if (cluster) cg::this_cluster().sync();
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

int launch_shared(const qpn::EGBatch& bt, cudaStream_t stream) {
    const size_t bytes = qpn::eg_lane_bytes(bt.n);
    auto kernel = eg_generic_kernel<qpn::EG_SHARED>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    kernel<<<bt.B, generic_threads(bt.n), bytes, stream>>>(bt, 1, 0, nullptr,
                                                           nullptr, nullptr);
    return cudaGetLastError();
}

int launch(const qpn::EGBatch& bt, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0) return 0;
    switch (qpn::eg_pick_chunk(bt.n)) {
    case 4: return launch_register<4>(bt, stream);
    case 10: return launch_register<10>(bt, stream);
    case 16: return launch_register<16>(bt, stream);
    case 32: return launch_register<32>(bt, stream);
    }
    return launch_shared(bt, stream);
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
    auto kernel = eg_generic_kernel<qpn::EG_GLOBAL>;
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
    // the largest band checked at each cluster size
    static size_t checked[qpn::kEgMaxRanks + 1] = {};
    const int nb = R < 1 ? 0 : qpn::eg_band_height(bt.n, R);
    return qpn::launch_cluster(eg_generic_kernel<qpn::EG_CLUSTER>, checked,
                               bt.B, R, generic_threads(nb),
                               qpn::eg_band_bytes(bt.n, nb), stream, bt, R, 0,
                               (float*)nullptr, (unsigned*)nullptr,
                               (float*)nullptr);
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
    return qpn::resident_blocks(eg_generic_kernel<qpn::EG_GLOBAL>,
                                kGenericMaxThreads, (size_t)optin);
}

const char* qpn_eg_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
