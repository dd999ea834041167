// f32 feasibility screen for batches of polyhedra on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel qpn_tpu/ops/pallas_kernels.py:205
// _screen_kernel (launched by _screen_call): all `steps` projected-
// subgradient steps  x ← x + lr·Aᵀv  of each polyhedron run inside one
// launch, with no device-memory traffic between steps, and the kernel
// returns the final x and max |v| per polyhedron.
//
// What bounds it on this card: neither bytes nor operations but the chain
// of 2·steps dependent phases, each a short sum per thread; every
// polyhedron has its own A, so a step is two matrix-vector products and the
// tensor cores do not apply.  The time is the number of instructions a
// phase issues and the latency of handing x and v from one phase to the
// next.
//
// Design, two kernels picked from the shape alone (screen_lane.cuh):
//
// * max(m, n) ≤ 32, the warp kernel: one polyhedron in one warp, kWarps of
//   them in a block.  Thread t keeps row t and column t of A in registers
//   for all steps (loaded once; instances templated on ceilings of m and n
//   that are multiples of 4, so the sums unroll and nothing is indexed at
//   run time).  x and v pass through one shared-memory line each: a thread
//   stores its own entry, __syncwarp(), and every thread reads the line
//   back with 16-byte loads from one address (a broadcast: 5 loads for 18
//   entries).  No block barrier anywhere; max |v| by a shuffle butterfly.
// * larger polyhedra, the generic kernel: one thread block per polyhedron,
//   A (odd row stride), l, u, v and x in dynamic shared memory, a thread per
//   row, then per column, a block barrier after each phase.  Where A does
//   not fit (m = n above 238 on an H100), its global instance: the same
//   phases with A read in place from device memory every phase (bound by
//   those bytes, through L1 and L2), l, u, v and x in shared memory.
//
// The wrapper picks the instance from the shape and the card's opt-in limit
// (screen_lane.cuh::screen_instance) before the launch.
//
// Built with nvcc -O3 -fmad=false, no fast math (utils/cuda_build.py), so
// each product and sum rounds separately, as in the plain PyTorch version,
// and both kernels sum in the order of the g++ host instance.
//
// C interface (ctypes): qpn_screen_f32 (the warp kernel or the generic
// kernel's shared instance, picked from the shape) and qpn_screen_global_f32
// return 0 or a cudaError_t; qpn_screen_instance is the pure choice,
// qpn_screen_smem_optin the current card's limit.

#include <cuda_runtime.h>

#include "screen_lane.cuh"

namespace {

constexpr int kMaxThreads = 256;   // qpn::screen_block_threads' ceiling
constexpr int kWarps = 4;           // polyhedra in a block of the warp kernel
constexpr unsigned kFullMask = 0xffffffffu;

template <int MC, int NC>
__global__ void __launch_bounds__(kWarps * qpn::kScreenWarp)
screen_warp_kernel(qpn::ScreenBatch bt) {
    __shared__ qpn::ScreenVec4 lines[kWarps][(MC + NC) / 4];
    const int w = threadIdx.x / qpn::kScreenWarp;
    const int t = threadIdx.x % qpn::kScreenWarp;
    const size_t b = (size_t)blockIdx.x * kWarps + w;
    if (b >= (size_t)bt.B) return;      // the whole warp: no block barrier
    const int m = bt.m, n = bt.n;
    qpn::ScreenVec4* vline = lines[w];
    qpn::ScreenVec4* xline = lines[w] + MC / 4;
    float* vf = reinterpret_cast<float*>(vline);
    float* xf = reinterpret_cast<float*>(xline);
    for (int k = t; k < MC + NC; k += qpn::kScreenWarp) vf[k] = 0.0f;
    qpn::ScreenRegs<MC, NC> R;
    qpn::screen_regs_load(R, bt, b, t);
    __syncwarp();
    if (t < n) xf[t] = R.x;
    __syncwarp();
    float v = 0.0f;
    for (int s = 0;; ++s) {
        if (t < m) {
            v = qpn::screen_regs_violation(R, xline);
            vf[t] = v;
        }
        if (s == bt.steps) break;
        __syncwarp();
        if (t < n) {
            qpn::screen_regs_update(R, vline, bt.lr);
            xf[t] = R.x;
        }
        __syncwarp();
    }
    float vmax = qpn::screen_nanmax(0.0f, qpn::screen_abs(v));
#pragma unroll
    for (int d = qpn::kScreenWarp / 2; d > 0; d /= 2)
        vmax = qpn::screen_nanmax(vmax, __shfl_xor_sync(kFullMask, vmax, d));
    if (t < n) bt.x_out[b * n + t] = R.x;
    if (t == 0) bt.v_out[b] = vmax;
}

template <int MC, int NC>
cudaError_t launch_warp(const qpn::ScreenBatch& bt, cudaStream_t stream) {
    const int blocks = (bt.B + kWarps - 1) / kWarps;
    screen_warp_kernel<MC, NC>
        <<<blocks, kWarps * qpn::kScreenWarp, 0, stream>>>(bt);
    return cudaGetLastError();
}

using WarpLaunch = cudaError_t (*)(const qpn::ScreenBatch&, cudaStream_t);
const WarpLaunch kWarpLaunch[8][8] = QPN_SCREEN_TABLE(launch_warp);

// kGlobal: A read in place from device memory, else copied to shared memory.
template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
screen_kernel(qpn::ScreenBatch bt) {
    extern __shared__ __align__(16) float smem[];
    const size_t b = blockIdx.x;
    const qpn::ScreenLane L =
        kGlobal ? qpn::screen_lane_carve_global(bt, b, smem)
                : qpn::screen_lane_carve(smem, bt.m, bt.n);
    qpn::screen_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::screen_lane_run(L, bt.steps, bt.lr, threadIdx.x, blockDim.x);
    qpn::screen_lane_store(L, bt, b, threadIdx.x, blockDim.x);
}

template <bool kGlobal>
int launch_generic(const qpn::ScreenBatch& bt, cudaStream_t stream) {
    const int threads = qpn::screen_block_threads(bt.m, bt.n);
    const size_t bytes =
        kGlobal ? qpn::screen_global_lane_bytes(bt.m, bt.n, threads)
                : qpn::screen_lane_bytes(bt.m, bt.n, threads);
    cudaError_t e = cudaFuncSetAttribute(
        screen_kernel<kGlobal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
    screen_kernel<kGlobal><<<bt.B, threads, bytes, stream>>>(bt);
    return cudaGetLastError();
}

int launch(const qpn::ScreenBatch& bt, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0 || bt.m <= 0) return 0;
    if (qpn::screen_fits_warp(bt.m, bt.n))
        return kWarpLaunch[qpn::screen_ceiling_index(bt.m)]
                          [qpn::screen_ceiling_index(bt.n)](bt, stream);
    return launch_generic<false>(bt, stream);
}

}  // namespace

extern "C" {

int qpn_screen_f32(QPN_SCREEN_PARAMS, void* stream) {
    return launch(QPN_SCREEN_BATCH, (cudaStream_t)stream);
}

int qpn_screen_global_f32(QPN_SCREEN_PARAMS, void* stream) {
    const qpn::ScreenBatch bt = QPN_SCREEN_BATCH;
    if (bt.B <= 0 || bt.n <= 0 || bt.m <= 0) return 0;
    return launch_generic<true>(bt, (cudaStream_t)stream);
}

int qpn_screen_instance(int m, int n, long long smem_optin) {
    return qpn::screen_instance(m, n, smem_optin);
}

// The shared memory a block can opt into on the current card, or minus a
// cudaError_t.
long long qpn_screen_smem_optin(void) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return e == cudaSuccess ? (long long)optin : -(long long)e;
}

const char* qpn_screen_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
