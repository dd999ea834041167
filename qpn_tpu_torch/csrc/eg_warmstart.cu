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
// the generic kernel: one thread per row, the matrix in dynamic shared
// memory, every row summed in column order.
//
// The order of every sum is defined in eg_lane.cuh, where a loop walks the
// same partition for the host instance.  Built with nvcc -O3 -fmad=false,
// no fast math (utils/cuda_build.py), so each product and sum rounds
// separately, as in the plain PyTorch version.
//
// C interface (ctypes): qpn_eg_warmstart_f32 returns 0 or a cudaError_t, or
// QPN_ERR_SMEM when the lane does not fit in shared memory.

#include <cuda_runtime.h>

#include "eg_lane.cuh"

namespace {

constexpr int kGenericMaxThreads = 256;
constexpr int QPN_ERR_SMEM = -1;
constexpr int G = qpn::kEgGroup;

__global__ void __launch_bounds__(kGenericMaxThreads)
eg_generic_kernel(qpn::EGBatch bt) {
    extern __shared__ __align__(16) float smem[];
    const qpn::EGLane L = qpn::eg_lane_carve(smem, bt.n);
    const size_t b = blockIdx.x;
    qpn::eg_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::eg_lane_run<1>(L, bt.tau[b], bt.steps, bt.n, threadIdx.x,
                        blockDim.x);
    qpn::eg_lane_store(L, bt, b, threadIdx.x, blockDim.x);
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

int launch_generic(const qpn::EGBatch& bt, cudaStream_t stream) {
    const size_t bytes = qpn::eg_lane_bytes(bt.n);
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    if (bytes > (size_t)optin) return QPN_ERR_SMEM;
    e = cudaFuncSetAttribute(eg_generic_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    int threads = (bt.n + 31) / 32 * 32;
    if (threads > kGenericMaxThreads) threads = kGenericMaxThreads;
    eg_generic_kernel<<<bt.B, threads, bytes, stream>>>(bt);
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
    return launch_generic(bt, stream);
}

}  // namespace

extern "C" {

int qpn_eg_warmstart_f32(QPN_EG_PARAMS, void* stream) {
    return launch(QPN_EG_BATCH, (cudaStream_t)stream);
}

long long qpn_eg_lane_bytes(int n) {
    return (long long)qpn::eg_lane_bytes(n);
}

const char* qpn_eg_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
