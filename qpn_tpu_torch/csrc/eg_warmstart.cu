// Fused extragradient warm start for batches of box AVIs on NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel qpn_tpu/ops/pallas_kernels.py:57
// _eg_kernel (launched by _eg_call): all `steps` extragradient steps of each
// lane run inside one launch, with no device-memory traffic between steps.
//
// Design: one thread block per lane, a grid of B blocks.  The lane's f32
// matrix (n x n, 5.8 KB at n=38) and its vectors q, l, u, z, z½ are loaded
// into dynamic shared memory once and stay there for all steps; thread i
// owns row i (a strided loop where n exceeds the block), and each step is
// two phases between barriers: z½ from z, then z from z½ (eg_lane.cuh).
// The block has the fewest warps that cover n (64 threads at n=38), so one
// wave of 256 lanes fits the card with room to spare.
//
// What bounds it on this card: latency, not bytes or operations.  A step is
// two dependent matvecs of n terms each, read from shared memory in column
// order, with a barrier after each; at n=38 the whole lane does 2·38² FMAs
// per step, so thousands of steps are a chain of short phases whose length is
// the shared-memory load latency times n plus two barriers.  The design
// keeps that chain free of device memory (M stays resident; the odd row
// stride avoids bank conflicts) and of any third barrier; splitting each
// row's dot product over a warp, or packing several lanes into one block, is
// later work.
//
// Built with nvcc -O3 -fmad=false, no fast math (utils/cuda_build.py), so
// each product and sum rounds separately, as in the plain PyTorch version.
//
// C interface (ctypes): qpn_eg_warmstart_f32 returns 0 or a cudaError_t, or
// QPN_ERR_SMEM when the lane does not fit in shared memory.

#include <cuda_runtime.h>

#include "eg_lane.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int QPN_ERR_SMEM = -1;

__global__ void __launch_bounds__(kMaxThreads)
eg_warmstart_kernel(qpn::EGBatch bt) {
    extern __shared__ __align__(16) float smem[];
    const qpn::EGLane L = qpn::eg_lane_carve(smem, bt.n);
    const size_t b = blockIdx.x;
    qpn::eg_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::eg_lane_run(L, bt.tau[b], bt.steps, threadIdx.x, blockDim.x);
    qpn::eg_lane_store(L, bt, b, threadIdx.x, blockDim.x);
}

int launch(const qpn::EGBatch& bt, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0) return 0;
    const size_t bytes = qpn::eg_lane_bytes(bt.n);
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    if (bytes > (size_t)optin) return QPN_ERR_SMEM;
    e = cudaFuncSetAttribute(eg_warmstart_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    int threads = (bt.n + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    eg_warmstart_kernel<<<bt.B, threads, bytes, stream>>>(bt);
    return cudaGetLastError();
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
