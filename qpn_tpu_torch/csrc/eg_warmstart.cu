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
//   * global: past 8 ranks, M read in place from device memory every
//     half-step with z, z½, q, l and u in shared memory: bound by the
//     bytes of M it streams, n² floats a half-step a lane, through L1 and
//     L2.  The wrapper's private launcher also runs it at cluster sizes,
//     to hold the two against each other on the card.
// Every row sums in plain column order in all three, so they give the same
// bits.
//
// The order of every sum is defined in eg_lane.cuh, where a loop walks the
// same partition for the host instance.  Built with nvcc -O3 -fmad=false,
// no fast math (utils/cuda_build.py), so each product and sum rounds
// separately, as in the plain PyTorch version.
//
// C interface (ctypes): qpn_eg_warmstart_f32 (the register kernel or the
// shared instance, picked from n), qpn_eg_warmstart_cluster_f32 (given its
// ranks) and qpn_eg_warmstart_global_f32 return 0 or a cudaError_t;
// qpn_eg_instance and qpn_eg_cluster_ranks are the pure choice,
// qpn_eg_smem_optin the current card's limit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "eg_lane.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kGenericMaxThreads = 256;
constexpr int G = qpn::kEgGroup;

// EG_SHARED: M copied to the block's shared memory; EG_GLOBAL: M read in
// place from device memory; EG_CLUSTER: one cluster of R blocks a lane,
// rank k's band of M in block k's shared memory.
template <int kInstance>
__global__ void __launch_bounds__(kGenericMaxThreads)
eg_generic_kernel(qpn::EGBatch bt, int R) {
    extern __shared__ __align__(16) float smem[];
    const bool spread = kInstance == qpn::EG_CLUSTER;
    const int rank = spread ? (int)cg::this_cluster().block_rank() : 0;
    const size_t b = spread ? blockIdx.x / R : blockIdx.x;
    const qpn::EGLane L = kInstance == qpn::EG_GLOBAL
        ? qpn::eg_lane_carve_global(bt, b, smem)
        : qpn::eg_lane_carve(smem, bt.n, spread ? R : 1, rank);
    qpn::eg_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::eg_lane_run<1>(L, bt.tau[b], bt.steps, bt.n, threadIdx.x,
                        blockDim.x);
    qpn::eg_lane_store(L, bt, b, threadIdx.x, blockDim.x);
    // no block leaves while a peer may still write into its shared memory
    if (spread) cg::this_cluster().sync();
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
    kernel<<<bt.B, generic_threads(bt.n), bytes, stream>>>(bt, 1);
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

int launch_global(const qpn::EGBatch& bt, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0) return 0;
    const size_t bytes = qpn::eg_global_lane_bytes(bt.n);
    auto kernel = eg_generic_kernel<qpn::EG_GLOBAL>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    kernel<<<bt.B, generic_threads(bt.n), bytes, stream>>>(bt, 1);
    return cudaGetLastError();
}

int launch_cluster(const qpn::EGBatch& bt, int R, cudaStream_t stream) {
    if (bt.n <= 0) return 0;
    // the largest band checked at each cluster size
    static size_t checked[qpn::kEgMaxRanks + 1] = {};
    const int nb = R < 1 ? 0 : qpn::eg_band_height(bt.n, R);
    return qpn::launch_cluster(eg_generic_kernel<qpn::EG_CLUSTER>, checked,
                               bt.B, R, generic_threads(nb),
                               qpn::eg_band_bytes(bt.n, nb), stream, bt, R);
}

}  // namespace

extern "C" {

int qpn_eg_warmstart_f32(QPN_EG_PARAMS, void* stream) {
    return launch(QPN_EG_BATCH, (cudaStream_t)stream);
}

int qpn_eg_warmstart_global_f32(QPN_EG_PARAMS, void* stream) {
    return launch_global(QPN_EG_BATCH, (cudaStream_t)stream);
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

// The shared memory a block can opt into on the current card, or minus a
// cudaError_t.
long long qpn_eg_smem_optin(void) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return e == cudaSuccess ? (long long)optin : -(long long)e;
}

const char* qpn_eg_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
