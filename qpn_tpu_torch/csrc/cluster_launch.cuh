// The launch of a thread-block cluster instance, shared by the Lemke pivot
// kernel (lemke_pivot.cu) and the extragradient kernel (eg_warmstart.cu).
//
// A lane is one cluster of R blocks along x: a grid of lanes · R blocks,
// each with `bytes` of dynamic shared memory.  The first launch of a kernel
// at each (R, bytes) checks with cudaOccupancyMaxActiveClusters that such a
// cluster fits the card at all, and returns cudaErrorInvalidClusterSize
// where none does; every failure returns CUDA's error.  No other instance
// is tried.  CUDA only (nvcc).
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

}  // namespace qpn
