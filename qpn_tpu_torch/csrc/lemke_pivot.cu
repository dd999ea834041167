// Batched Lemke pivot loop for box AVIs on NVIDIA Hopper (sm_90a).
//
// Replaces the fused Pallas TPU kernel
// qpn_tpu/ops/lemke_pallas.py::_make_kernel: the whole almost-complementary
// pivot path of each lane runs inside one launch, with no device-memory
// traffic between pivots.
//
// Design: one thread block of 256 threads per lane, a grid of B blocks.
// The lane's tableau (n, 3n+2) and its bookkeeping live in dynamic shared
// memory for the whole path (f32 at n=38: about 20 KB; up to n of about 130
// in f32 fits the 227 KB a block can opt into), rows an odd number of
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
// Templated on float (the hot f32 tier) and double (the straggler re-pivot).
// Built with nvcc -O3 -fmad=false, no fast math (utils/cuda_build.py).
//
// C interface (ctypes): qpn_lemke_pivot_f32 / _f64 return 0 or a
// cudaError_t, or QPN_ERR_SMEM when the lane does not fit in shared memory.

#include <cuda_runtime.h>

#include "lemke_lane.cuh"

namespace {

constexpr int kThreads = 256;   // a multiple of 32 and of qpn::kLemkeSplit
constexpr int QPN_ERR_SMEM = -1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lemke_pivot_kernel(qpn::LemkeBatch<T> bt) {
    extern __shared__ __align__(16) unsigned char smem[];
    const qpn::Lane<T> L = qpn::lane_carve<T>(smem, bt.n);
    const size_t b = blockIdx.x;
    qpn::lane_load(L, bt, b, threadIdx.x, kThreads);
    qpn::lane_run(L, threadIdx.x, kThreads, bt.tol, bt.piv_tol,
                  bt.max_pivots);
    qpn::lane_store(L, bt, b, threadIdx.x, kThreads);
}

template <typename T>
int launch(const qpn::LemkeBatch<T>& bt, cudaStream_t stream) {
    if (bt.B <= 0) return 0;
    const size_t bytes = qpn::lane_bytes<T>(bt.n);
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    if (bytes > (size_t)optin) return QPN_ERR_SMEM;
    e = cudaFuncSetAttribute(lemke_pivot_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    lemke_pivot_kernel<T><<<bt.B, kThreads, bytes, stream>>>(bt);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int qpn_lemke_pivot_f32(QPN_LEMKE_PARAMS(float), void* stream) {
    return launch(QPN_LEMKE_BATCH(float), (cudaStream_t)stream);
}

int qpn_lemke_pivot_f64(QPN_LEMKE_PARAMS(double), void* stream) {
    return launch(QPN_LEMKE_BATCH(double), (cudaStream_t)stream);
}

long long qpn_lemke_lane_bytes(int n, int itemsize) {
    return itemsize == 4 ? (long long)qpn::lane_bytes<float>(n)
                         : (long long)qpn::lane_bytes<double>(n);
}

const char* qpn_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
