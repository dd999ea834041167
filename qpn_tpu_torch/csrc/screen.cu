// f32 feasibility screen for batches of polyhedra on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel qpn_tpu/ops/pallas_kernels.py:205
// _screen_kernel (launched by _screen_call): all `steps` projected-
// subgradient steps  x ← x + lr·Aᵀv  of each polyhedron run inside one
// launch, with no device-memory traffic between steps, and the kernel
// returns the final x and max |v| per polyhedron.
//
// Design: one thread block per polyhedron, a grid of B blocks.  The row-
// normalised A (m x n f32, odd row stride), l, u, v and x are loaded into
// dynamic shared memory once and stay there for all steps.  Each step is
// two phases, each followed by a barrier: one thread per row computes
// (Ax)_r and the signed violation v_r; one thread per column computes
// g_j = Σ_r A_rj v_r and updates x_j (screen_lane.cuh).  After the last
// step a block reduction gives max |v|.  The block has the fewest warps
// that cover max(m, n), at most 256 threads (32 at robust_avoid's 18 x 18
// pieces), so a batch of thousands of polyhedra fills the card's SMs with
// many resident blocks each.
//
// What bounds it on this card: latency, not bytes or operations.  A step is
// two dependent sums of length n and m read from shared memory, with a
// barrier after each; at 18 x 18 a polyhedron does 2·18² multiply-adds per
// step, so the 120 steps are a chain of short phases whose length is the
// shared-memory load latency times n (or m) plus two barriers.  The design
// keeps device memory out of that chain (everything stays resident; the odd
// row stride avoids bank conflicts) and adds no third barrier; splitting
// the sums over a warp, or packing several polyhedra into one block, is
// later work.
//
// Built with nvcc -O3 -fmad=false, no fast math (utils/cuda_build.py), so
// each product and sum rounds separately, as in the plain PyTorch version.
//
// C interface (ctypes): qpn_screen_f32 returns 0 or a cudaError_t, or
// QPN_ERR_SMEM when a polyhedron does not fit in shared memory.

#include <cuda_runtime.h>

#include "screen_lane.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int QPN_ERR_SMEM = -1;

int block_threads(int m, int n) {
    const int work = m > n ? m : n;
    int threads = (work + 31) / 32 * 32;
    return threads > kMaxThreads ? kMaxThreads : threads;
}

__global__ void __launch_bounds__(kMaxThreads)
screen_kernel(qpn::ScreenBatch bt) {
    extern __shared__ __align__(16) float smem[];
    const qpn::ScreenLane L = qpn::screen_lane_carve(smem, bt.m, bt.n);
    const size_t b = blockIdx.x;
    qpn::screen_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::screen_lane_run(L, bt.steps, bt.lr, threadIdx.x, blockDim.x);
    qpn::screen_lane_store(L, bt, b, threadIdx.x, blockDim.x);
}

int launch(const qpn::ScreenBatch& bt, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0 || bt.m <= 0) return 0;
    const int threads = block_threads(bt.m, bt.n);
    const size_t bytes = qpn::screen_lane_bytes(bt.m, bt.n, threads);
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    if (bytes > (size_t)optin) return QPN_ERR_SMEM;
    e = cudaFuncSetAttribute(screen_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    screen_kernel<<<bt.B, threads, bytes, stream>>>(bt);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int qpn_screen_f32(QPN_SCREEN_PARAMS, void* stream) {
    return launch(QPN_SCREEN_BATCH, (cudaStream_t)stream);
}

long long qpn_screen_lane_bytes(int m, int n) {
    return (long long)qpn::screen_lane_bytes(m, n, block_threads(m, n));
}

const char* qpn_screen_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
