// The launches of the instances that spread a lane over R blocks, shared by
// the Lemke pivot kernel (lemke_pivot.cu) and the extragradient kernel
// (eg_warmstart.cu).  A lane is R neighbouring blocks along x: a grid of
// lanes · R blocks, each with `bytes` of dynamic shared memory.
//   * launch_cluster: the lane is one thread-block cluster.  The first
//     launch of a kernel at each (R, bytes) checks with
//     cudaOccupancyMaxActiveClusters that such a cluster fits the card at
//     all, and returns cudaErrorInvalidClusterSize where none does;
//   * launch_cooperative: the lane's blocks live on any SMs and meet at a
//     barrier in device memory (lane_barrier.cuh), so every block of the
//     grid must be resident at once: a cooperative launch, which the card
//     refuses (cudaErrorCooperativeLaunchTooLarge) for a grid that cannot
//     be.  resident_blocks gives the blocks it holds at once.
// Every failure returns CUDA's error.  No other instance is tried.  CUDA
// only (nvcc).
#pragma once

#include <cuda_runtime.h>

namespace qpn {

// A failed runtime call also leaves its error as the thread's last error,
// which the next launch's cudaGetLastError() would report as its own: clear
// it where the error is returned.
inline cudaError_t cluster_returned(cudaError_t e) {
    if (e != cudaSuccess) cudaGetLastError();
    return e;
}

// checked[R] (R < N): the largest band a launch at R has found to fit,
// which the caller keeps for its kernel (a smaller band fits where a larger
// one does).  Returns 0 or a cudaError_t.
template <size_t N, typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), size_t (&checked)[N], int lanes,
                   int R, int threads, size_t bytes, cudaStream_t stream,
                   Args... args) {
    if (lanes <= 0) return 0;
    if (R < 1) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return cluster_returned(e);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)R;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)lanes * (unsigned)R);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const bool cached = (size_t)R < N;
    if (!cached || checked[R] < bytes) {
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
        if (e != cudaSuccess) return cluster_returned(e);
        if (clusters == 0) return cudaErrorInvalidClusterSize;
        if (cached) checked[R] = bytes;
    }
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    return e != cudaSuccess ? cluster_returned(e) : cudaGetLastError();
}

template <typename... Params, typename... Args>
int launch_cooperative(void (*kernel)(Params...), int lanes, int R,
                       int threads, size_t bytes, cudaStream_t stream,
                       Args... args) {
    if (lanes <= 0) return 0;
    if (R < 1 || (long long)lanes * R > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return cluster_returned(e);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)lanes * (unsigned)R);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    return e != cudaSuccess ? cluster_returned(e) : cudaGetLastError();
}

// The blocks of `kernel` at `threads` threads and `bytes` of dynamic shared
// memory that the current card holds at once (its SMs times the blocks an
// SM holds), or minus a cudaError_t.
template <typename... Params>
long long resident_blocks(void (*kernel)(Params...), int threads,
                          size_t bytes) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, bytes);
    if (e != cudaSuccess) return -(long long)cluster_returned(e);
    return (long long)sms * per_sm;
}

// The shared memory a block can opt into on the current card, or minus a
// cudaError_t.
inline long long smem_optin() {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return e == cudaSuccess ? (long long)optin
                            : -(long long)cluster_returned(e);
}

}  // namespace qpn
