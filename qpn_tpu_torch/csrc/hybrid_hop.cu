// The hybrid solver's extragradient hop for batches of box AVIs on NVIDIA
// Hopper (sm_90a), in f32 and f64: all `steps` steps of
// ops/avi.py::_eg_phase, with each lane's best-merit iterate, in one launch
// (hop_lane.cuh states the arithmetic).
//
// It replaces no Pallas kernel of the JAX package.  It was written because
// the generic route's hybrid stages ran the hop as a Python loop of about 22
// small PyTorch launches a step, 60 steps a round of every precision pass:
// the host's launches, not the card, held the route.  Here a hop is one
// launch, and the iterates never leave the chip.
//
// What bounds it: the latency of a step's two dependent row sums (each the
// chain of a row's adds, its butterfly and a barrier), not bytes or
// operations: a lane does 2·n² multiply-adds a phase, n = 38 on the flagship.
//
// Instances (hop_lane.cuh::hop_instance, picked by the wrapper from n and
// the precision before the launch; a launch the card refuses returns CUDA's
// error, and no other instance is tried):
//   * register (hybrid_hop_register_kernel<T, C>, n <= 64 in f32, 40 in
//     f64): K2's register partition.  One block a lane, a group of
//     kEgGroup neighbouring threads of a warp on each row, a thread holding
//     its C entries of the row and the row's q, l, u, z and best z in
//     registers for all steps; z, z½ and Φ in shared memory, read a chunk
//     at a time (the threads of a warp read kEgGroup distinct addresses:
//     broadcasts).  Phase A is one chunk sum and butterfly; phase B two,
//     independent (M z½ and Φ·Φ); one barrier a phase.  M of f64 at n = 38
//     is 11.6 KB a lane;
//   * shared (hybrid_hop_generic_kernel<T, true>): one block a lane with M
//     in its dynamic shared memory (rows hop_ld(n) apart), one thread a
//     row, every sum in column order; every thread sums Φ·Φ itself;
//   * global (hybrid_hop_generic_kernel<T, false>): the same with M read in
//     place from device memory, through the L2, past the opt-in limit.
//
// Built into the extragradient kernel's library (eg_cuda.py) with nvcc -O3
// -fmad=false, no fast math (utils/cuda_build.py).  C interface (ctypes):
// qpn_hybrid_hop_f32 / _f64 launch the given instance on a stream and return
// 0 or a cudaError_t; qpn_hop_instance is the pure choice.

#include <cuda_runtime.h>

#include "hop_lane.cuh"

namespace {

constexpr int G = qpn::kEgGroup;
constexpr int kHopGenericThreads = 256;

constexpr int hop_block_threads(int C) { return (G * G * C + 31) / 32 * 32; }

template <typename T, int C>
__global__ void __launch_bounds__(hop_block_threads(C))
hybrid_hop_register_kernel(qpn::HopBatch<T> bt) {
    constexpr int NP = G * C;               // padded row length
    __shared__ T xs[2][NP];                 // z, z½
    __shared__ T ps[NP];                    // Φ(z)
    const int n = bt.n, tid = threadIdx.x;
    const int g = tid % G, i = tid / G;     // chunk and row of this thread
    const bool row = i < n;
    const bool owner = row && g == 0;
    const size_t b = blockIdx.x;
    const T tau = bt.tau[b];
    const T* Mb = bt.M + b * (size_t)n * n;

    T m[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const int j = g * C + k;
        m[k] = row && j < n ? Mb[(size_t)i * n + j] : T(0);
    }
    const T q = row ? bt.q[b * n + i] : T(0);
    const T lo = row ? bt.l[b * n + i] : T(0);
    const T hi = row ? bt.u[b * n + i] : T(0);
    T z = row ? bt.z0[b * n + i] : T(0);
    T best_z = z;
    T best_m = qpn::hop_inf<T>();
    for (int j = tid; j < NP; j += blockDim.x) {
        xs[0][j] = j < n ? bt.z0[b * n + j] : T(0);
        xs[1][j] = T(0);
        ps[j] = T(0);
    }
    __syncthreads();

    for (int s = 0;; ++s) {
        // A: F(z), Φ(z) and z½
        T x[C];
#pragma unroll
        for (int k = 0; k < C; ++k) x[k] = xs[0][g * C + k];
        const T F = qpn::hop_tree<T, G>(qpn::hop_chunk<T, C>(m, x)) + q;
        const bool last = s == bt.steps;
        if (owner) {
            ps[i] = z - qpn::hop_clip(z - F, lo, hi);
            if (!last) xs[1][i] = qpn::hop_clip(z - tau * F, lo, hi);
        }
        __syncthreads();
        // B: the merit of z, and z⁺ from z½
        T p[C];
#pragma unroll
        for (int k = 0; k < C; ++k) p[k] = ps[g * C + k];
        if (!last) {
#pragma unroll
            for (int k = 0; k < C; ++k) x[k] = xs[1][g * C + k];
        }
        const T S = qpn::hop_tree<T, G>(qpn::hop_chunk<T, C>(p, p));
        if (qpn::hop_keep(S, best_m)) best_z = z;
        if (last) break;
        const T Fh = qpn::hop_tree<T, G>(qpn::hop_chunk<T, C>(m, x)) + q;
        z = qpn::hop_clip(z - tau * Fh, lo, hi);
        if (owner) xs[0][i] = z;
        __syncthreads();
    }
    if (owner) {
        bt.z_out[b * n + i] = z;
        bt.best_z[b * n + i] = best_z;
    }
    if (tid == 0) bt.best_m[b] = best_m;
}

// The generic instances: one thread a row (rows tid, tid + blockDim.x, ...),
// every vector of the lane in shared memory, M there too (kShared) or read
// in place.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kHopGenericThreads)
hybrid_hop_generic_kernel(qpn::HopBatch<T> bt) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int n = bt.n, tid = threadIdx.x, nthr = blockDim.x;
    const size_t b = blockIdx.x;
    const size_t vec = (qpn::hop_generic_bytes(n, sizeof(T), false)
                        / sizeof(T)) / qpn::kHopVectors;
    T* base = reinterpret_cast<T*>(smem);
    T* z = base + (kShared ? (qpn::hop_generic_bytes(n, sizeof(T), true)
                              / sizeof(T) - qpn::kHopVectors * vec) : 0);
    T* zh = z + vec;
    T* ph = zh + vec;
    T* bz = ph + vec;
    T* q = bz + vec;
    T* l = q + vec;
    T* u = l + vec;
    const T* Mb = bt.M + b * (size_t)n * n;
    const int ld = kShared ? qpn::hop_ld(n) : n;
    const T* M = kShared ? base : Mb;
    if (kShared)
        for (int k = tid; k < n * n; k += nthr)
            base[(k / n) * ld + k % n] = Mb[k];
    for (int i = tid; i < n; i += nthr) {
        z[i] = bz[i] = bt.z0[b * n + i];
        q[i] = bt.q[b * n + i];
        l[i] = bt.l[b * n + i];
        u[i] = bt.u[b * n + i];
    }
    const T tau = bt.tau[b];
    T best_m = qpn::hop_inf<T>();
    __syncthreads();

    for (int s = 0;; ++s) {
        const bool last = s == bt.steps;
        // A: F(z), Φ(z) and z½
        for (int i = tid; i < n; i += nthr) {
            const T F = qpn::hop_sum<T, 1>(M + (size_t)i * ld, z, n, n) + q[i];
            ph[i] = z[i] - qpn::hop_clip(z[i] - F, l[i], u[i]);
            if (!last) zh[i] = qpn::hop_clip(z[i] - tau * F, l[i], u[i]);
        }
        __syncthreads();
        // B: the merit of z, and z⁺ from z½
        const bool better =
            qpn::hop_keep(qpn::hop_sum<T, 1>(ph, ph, n, n), best_m);
        for (int i = tid; i < n; i += nthr) {
            if (better) bz[i] = z[i];
            if (!last) {
                const T Fh =
                    qpn::hop_sum<T, 1>(M + (size_t)i * ld, zh, n, n) + q[i];
                z[i] = qpn::hop_clip(z[i] - tau * Fh, l[i], u[i]);
            }
        }
        if (last) break;
        __syncthreads();
    }
    for (int i = tid; i < n; i += nthr) {
        bt.z_out[b * n + i] = z[i];
        bt.best_z[b * n + i] = bz[i];
    }
    if (tid == 0) bt.best_m[b] = best_m;
}

template <typename T, int C>
int launch_register(const qpn::HopBatch<T>& bt, cudaStream_t stream) {
    const int threads = (bt.n * G + 31) / 32 * 32;
    hybrid_hop_register_kernel<T, C><<<bt.B, threads, 0, stream>>>(bt);
    return cudaGetLastError();
}

template <typename T, bool kShared>
int launch_generic(const qpn::HopBatch<T>& bt, cudaStream_t stream) {
    const size_t bytes = qpn::hop_generic_bytes(bt.n, sizeof(T), kShared);
    auto kernel = hybrid_hop_generic_kernel<T, kShared>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    int threads = (bt.n + 31) / 32 * 32;
    if (threads > kHopGenericThreads) threads = kHopGenericThreads;
    kernel<<<bt.B, threads, bytes, stream>>>(bt);
    return cudaGetLastError();
}

template <typename T>
int launch(const qpn::HopBatch<T>& bt, int instance, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0) return 0;
    if (bt.steps < 0) return cudaErrorInvalidValue;
    if (instance == qpn::HOP_REGISTER) {
        switch (qpn::hop_pick_chunk(bt.n, sizeof(T))) {
        case 4: return launch_register<T, 4>(bt, stream);
        case 10: return launch_register<T, 10>(bt, stream);
        case 16:
            if constexpr (sizeof(T) == 4)
                return launch_register<T, 16>(bt, stream);
        }
        return cudaErrorInvalidValue;
    }
    if (instance == qpn::HOP_SHARED) return launch_generic<T, true>(bt, stream);
    if (instance == qpn::HOP_GLOBAL) return launch_generic<T, false>(bt, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// instance: qpn_hop_instance's pick (the register instance only where n
// has a chunk: cudaErrorInvalidValue otherwise)
int qpn_hybrid_hop_f32(QPN_HOP_PARAMS(float), int instance, void* stream) {
    return launch(QPN_HOP_BATCH(float), instance, (cudaStream_t)stream);
}

int qpn_hybrid_hop_f64(QPN_HOP_PARAMS(double), int instance, void* stream) {
    return launch(QPN_HOP_BATCH(double), instance, (cudaStream_t)stream);
}

int qpn_hop_instance(int n, int itemsize, long long smem_optin) {
    return qpn::hop_instance(n, itemsize, smem_optin);
}

}  // extern "C"
