// Batched Lemke pivot loop for box AVIs on NVIDIA Hopper (sm_90a).
//
// Replaces the fused Pallas TPU kernel
// qpn_tpu/ops/lemke_pallas.py::_make_kernel: the whole almost-complementary
// pivot path of each lane runs inside one launch, with no device-memory
// traffic between pivots.
//
// Design: one thread block of 256 threads per lane, a grid of B blocks.
// The lane's tableau (n, 3n+2) and its bookkeeping live in dynamic shared
// memory for the whole path (f32 at n=38: about 20 KB; up to n = 135 in
// f32 and 94 in f64 fits the 227 KB a block can opt into), rows an odd number of
// elements apart.  A pivot is four phases between barriers
// (lemke_lane.cuh): basic values and the ratio test, each row's sum split
// over four threads of a warp; the decision by the first warp, as scans
// joined by warp votes and shuffles (min ratio, tie set, and a
// lexicographic refinement that looks at 32 passes at once); the staging of
// the scaled pivot row and the entering column, one element a thread,
// beside thread 0's bookkeeping; the rank-1 update with warps on rows and
// lanes on columns.  The block size and the split of a row's sum are
// compile-time constants (kThreads here, kLemkeSplit in lemke_lane.cuh): of
// the sizes measured on an H100 (32, 128, 256 threads; splits 1, 4, 8) 256
// with 4 was the fastest.  Lanes run independently: a finished lane's block
// exits.
//
// What bounds it on this card: latency.  A lane takes about 70 dependent
// pivots; the arithmetic (about 1.8e4 operations a pivot) and the device
// memory traffic (the tableau once in, the basis once out) are negligible
// against the chain of phases.  The design shortens the chain: no phase
// runs on one thread but the bookkeeping, no integer division, no bank
// conflict between a warp's rows, and loads batched ahead of the stores
// that may alias them.
//
// Two instances of that design, picked by the wrapper from the shape alone
// (lemke_lane.cuh::lane_instance against the card's opt-in limit): the
// shared instance above, and for lanes that do not fit (f32 n >= 136, f64
// n >= 95 on an H100) the global instance, the same block and phases on a
// lane carved from a device-memory workspace that the wrapper allocates
// (lane_bytes(n) a lane; f32 at n=190 about 0.44 MB).  Its tableau is read
// and written through L1 and L2 every pivot, so it is bound by memory
// traffic where the shared instance is bound by latency; it is the first
// design for such lanes, not a tuned one.
//
// Templated on float (the hot f32 tier) and double (the straggler re-pivot).
// Built with nvcc -O3 -fmad=false, no fast math (utils/cuda_build.py).
//
// C interface (ctypes): qpn_lemke_pivot_f32 / _f64 (the shared instance)
// and qpn_lemke_pivot_global_f32 / _f64 (the global instance, given its
// workspace) return 0 or a cudaError_t; qpn_lemke_lane_instance is the pure
// choice, qpn_lemke_smem_optin the current card's limit.

#include <cuda_runtime.h>

#include "lemke_lane.cuh"

namespace {

constexpr int kThreads = 256;   // a multiple of 32 and of qpn::kLemkeSplit

// One block a lane; kGlobal: the lane's working set is lane b of the
// device-memory workspace, else the block's dynamic shared memory.
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
lemke_pivot_kernel(qpn::LemkeBatch<T> bt, unsigned char* workspace) {
    extern __shared__ __align__(16) unsigned char smem[];
    const size_t b = blockIdx.x;
    unsigned char* base =
        kGlobal ? workspace + b * qpn::lane_bytes<T>(bt.n) : smem;
    const qpn::Lane<T> L = qpn::lane_carve<T>(base, bt.n);
    qpn::lane_load(L, bt, b, threadIdx.x, kThreads);
    qpn::lane_run(L, threadIdx.x, kThreads, bt.tol, bt.piv_tol,
                  bt.max_pivots);
    qpn::lane_store(L, bt, b, threadIdx.x, kThreads);
}

template <typename T>
int launch_shared(const qpn::LemkeBatch<T>& bt, cudaStream_t stream) {
    if (bt.B <= 0) return 0;
    const size_t bytes = qpn::lane_bytes<T>(bt.n);
    cudaError_t e = cudaFuncSetAttribute(
        lemke_pivot_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    lemke_pivot_kernel<T, false><<<bt.B, kThreads, bytes, stream>>>(bt,
                                                                    nullptr);
    return cudaGetLastError();
}

template <typename T>
int launch_global(const qpn::LemkeBatch<T>& bt, void* workspace,
                  cudaStream_t stream) {
    if (bt.B <= 0) return 0;
    if (workspace == nullptr) return cudaErrorInvalidValue;
    lemke_pivot_kernel<T, true><<<bt.B, kThreads, 0, stream>>>(
        bt, static_cast<unsigned char*>(workspace));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int qpn_lemke_pivot_f32(QPN_LEMKE_PARAMS(float), void* stream) {
    return launch_shared(QPN_LEMKE_BATCH(float), (cudaStream_t)stream);
}

int qpn_lemke_pivot_f64(QPN_LEMKE_PARAMS(double), void* stream) {
    return launch_shared(QPN_LEMKE_BATCH(double), (cudaStream_t)stream);
}

// workspace: B * qpn_lemke_lane_bytes(n, itemsize) bytes of device memory
int qpn_lemke_pivot_global_f32(QPN_LEMKE_PARAMS(float), void* workspace,
                               void* stream) {
    return launch_global(QPN_LEMKE_BATCH(float), workspace,
                         (cudaStream_t)stream);
}

int qpn_lemke_pivot_global_f64(QPN_LEMKE_PARAMS(double), void* workspace,
                               void* stream) {
    return launch_global(QPN_LEMKE_BATCH(double), workspace,
                         (cudaStream_t)stream);
}

long long qpn_lemke_lane_bytes(int n, int itemsize) {
    return itemsize == 4 ? (long long)qpn::lane_bytes<float>(n)
                         : (long long)qpn::lane_bytes<double>(n);
}

int qpn_lemke_lane_instance(int n, int itemsize, long long smem_optin) {
    return qpn::lane_instance(n, itemsize, smem_optin);
}

// The shared memory a block can opt into on the current card, or minus a
// cudaError_t.
long long qpn_lemke_smem_optin(void) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return e == cudaSuccess ? (long long)optin : -(long long)e;
}

const char* qpn_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
