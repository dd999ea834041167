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
// Design, four instances picked from the shape alone (screen_lane.cuh):
//
// * max(m, n) ≤ 32, the warp kernel: one polyhedron in one warp, kWarps of
//   them in a block.  Thread t keeps row t and column t of A in registers
//   for all steps (loaded once; instances templated on ceilings of m and n
//   that are multiples of 4, so the sums unroll and nothing is indexed at
//   run time).  x and v pass through one shared-memory line each: a thread
//   stores its own entry, __syncwarp(), and every thread reads the line
//   back with 16-byte loads from one address (a broadcast: 5 loads for 18
//   entries).  No block barrier anywhere; max |v| by a shuffle butterfly.
// * larger polyhedra, the shared kernel: one thread block per polyhedron,
//   A (odd row stride), l, u, v and x in dynamic shared memory, a thread per
//   row, then per column, a block barrier after each phase.  A arrives by
//   cp.async and the sums run in stages of 16 entries, as in the cluster
//   kernel: summed one product at a time, the lane code that the four
//   kernels share ran at half the speed of the earlier one-block code
//   (tools/torch_screen_probe.py --parent times the two).
// * where A does not fit one block (m = n above 238 on an H100) but fits a
//   cluster of R = 2-8 blocks (m = n up to 473), the cluster kernel: rank k
//   holds a band of A's rows (phase 1) and a band of its columns for all
//   rows (phase 2), A on chip twice, with copies of v and x; both bands
//   are copied in with cp.async, every copy issued before one wait.  Each
//   phase writes its new entries into every rank's copy through
//   distributed shared memory and ends at one cluster barrier
//   (barrier.cluster, release and acquire).  Bound by the chain of n, then
//   m, dependent adds a step (a thread loads the next 16 entries of its
//   band and of x or v while it sums the last 16), plus two barriers.
//   Launched with cudaLaunchKernelEx and a cluster dimension
//   (cluster_launch.cuh): the first launch at each size checks that such a
//   cluster fits the card and returns CUDA's error where it does not; no
//   other instance is tried.
// * past the cluster's reach, the global kernel: one block per polyhedron
//   (up to 1024 threads, a row or a column each up to m, n = 1024), l, u,
//   v and x in shared memory, A in device memory.  Phase 2 reads A in
//   place (a warp's loads on one 128-byte line: neighbouring columns of a
//   row); phase 1 reads a column-major copy of A that the block writes at
//   its start into a workspace the wrapper allocates (a warp's loads on
//   one line: neighbouring rows of a column; A's rows in place would be 32
//   lines a load).  Each thread loads 64 entries of A before it sums them
//   (kScreenStageGlobal).  Bound by the bytes of A one SM streams from L2
//   (or device memory) each phase.
//
// The wrapper picks the instance from the shape and the card's opt-in limit
// (screen_lane.cuh::screen_instance) before the launch.  The cluster and
// global kernels have their own __launch_bounds__, apart from the shared
// kernel's.
//
// Built with nvcc -O3 -fmad=false, no fast math (utils/cuda_build.py), so
// each product and sum rounds separately, as in the plain PyTorch version,
// and every kernel sums in the order of the g++ host instance.
//
// C interface (ctypes): qpn_screen_f32 (the warp kernel or the shared
// kernel, picked from the shape), qpn_screen_cluster_f32 (given its ranks)
// and qpn_screen_global_f32 (given its workspace) return 0 or a
// cudaError_t; qpn_screen_instance and qpn_screen_cluster_ranks are the
// pure choice, qpn_screen_smem_optin the current card's limit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "screen_lane.cuh"

namespace {

namespace cg = cooperative_groups;

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

__global__ void __launch_bounds__(kMaxThreads)
screen_shared_kernel(qpn::ScreenBatch bt) {
    extern __shared__ __align__(16) float smem[];
    const size_t b = blockIdx.x;
    const qpn::ScreenLane L = qpn::screen_lane_carve(smem, bt.m, bt.n);
    qpn::screen_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::screen_lane_run(L, bt.steps, bt.lr, threadIdx.x, blockDim.x);
    qpn::screen_lane_store(L, bt, b, threadIdx.x, blockDim.x);
}

// One cluster of R blocks a polyhedron; rank k's part in block k's shared
// memory.
__global__ void __launch_bounds__(qpn::kScreenClusterThreads, 1)
screen_cluster_kernel(qpn::ScreenBatch bt, int R) {
    extern __shared__ __align__(16) float smem[];
    const int rank = (int)cg::this_cluster().block_rank();
    const size_t b = blockIdx.x / R;
    const qpn::ScreenLane L =
        qpn::screen_lane_carve_cluster(smem, bt.m, bt.n, R, rank, nullptr);
    qpn::screen_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    // ends at a cluster barrier, after which no rank writes into another
    qpn::screen_lane_run(L, bt.steps, bt.lr, threadIdx.x, blockDim.x);
    qpn::screen_lane_store(L, bt, b, threadIdx.x, blockDim.x);
}

// One block a polyhedron; polyhedron b's column-major copy of A at
// mt + b · m · n.
__global__ void __launch_bounds__(qpn::kScreenWideThreads, 1)
screen_global_kernel(qpn::ScreenBatch bt, float* mt) {
    extern __shared__ __align__(16) float smem[];
    const size_t b = blockIdx.x;
    const qpn::ScreenLane L = qpn::screen_lane_carve_global(
        bt, b, smem, mt + b * (size_t)bt.m * bt.n);
    qpn::screen_lane_load(L, bt, b, threadIdx.x, blockDim.x);
    qpn::screen_lane_run(L, bt.steps, bt.lr, threadIdx.x, blockDim.x);
    qpn::screen_lane_store(L, bt, b, threadIdx.x, blockDim.x);
}

int launch(const qpn::ScreenBatch& bt, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0 || bt.m <= 0) return 0;
    if (qpn::screen_fits_warp(bt.m, bt.n))
        return kWarpLaunch[qpn::screen_ceiling_index(bt.m)]
                          [qpn::screen_ceiling_index(bt.n)](bt, stream);
    const int threads = qpn::screen_block_threads(bt.m, bt.n);
    const size_t bytes = qpn::screen_lane_bytes(bt.m, bt.n, threads);
    cudaError_t e = cudaFuncSetAttribute(
        screen_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return qpn::cluster_returned(e);
    screen_shared_kernel<<<bt.B, threads, bytes, stream>>>(bt);
    return cudaGetLastError();
}

int launch_cluster(const qpn::ScreenBatch& bt, int R, cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0 || bt.m <= 0) return 0;
    if (R < 1) return cudaErrorInvalidValue;
    // the largest part checked at each cluster size
    static size_t checked[qpn::kScreenMaxRanks + 1] = {};
    return qpn::launch_cluster(
        screen_cluster_kernel, checked, bt.B, R,
        qpn::screen_cluster_threads(bt.m, bt.n, R),
        qpn::screen_cluster_bytes(bt.m, bt.n, R), stream, bt, R);
}

int launch_global(const qpn::ScreenBatch& bt, float* mt,
                  cudaStream_t stream) {
    if (bt.B <= 0 || bt.n <= 0 || bt.m <= 0) return 0;
    if (mt == nullptr) return cudaErrorInvalidValue;
    const int threads = qpn::screen_global_threads(bt.m, bt.n);
    const size_t bytes = qpn::screen_global_lane_bytes(bt.m, bt.n, threads);
    cudaError_t e = cudaFuncSetAttribute(
        screen_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return qpn::cluster_returned(e);
    screen_global_kernel<<<bt.B, threads, bytes, stream>>>(bt, mt);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int qpn_screen_f32(QPN_SCREEN_PARAMS, void* stream) {
    return launch(QPN_SCREEN_BATCH, (cudaStream_t)stream);
}

// ranks: the cluster's blocks a polyhedron (qpn_screen_cluster_ranks)
int qpn_screen_cluster_f32(QPN_SCREEN_PARAMS, int ranks, void* stream) {
    return launch_cluster(QPN_SCREEN_BATCH, ranks, (cudaStream_t)stream);
}

// colmajor: B · m · n floats of device memory, which the kernel writes and
// reads
int qpn_screen_global_f32(QPN_SCREEN_PARAMS, void* colmajor, void* stream) {
    return launch_global(QPN_SCREEN_BATCH, static_cast<float*>(colmajor),
                         (cudaStream_t)stream);
}

int qpn_screen_instance(int m, int n, long long smem_optin) {
    return qpn::screen_instance(m, n, smem_optin);
}

int qpn_screen_cluster_ranks(int m, int n, long long smem_optin) {
    return qpn::screen_cluster_ranks(m, n, smem_optin);
}

// The shared memory a block can opt into on the current card, or minus a
// cudaError_t.
long long qpn_screen_smem_optin(void) { return qpn::smem_optin(); }

const char* qpn_screen_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
