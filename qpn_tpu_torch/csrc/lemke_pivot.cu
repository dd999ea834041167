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
// Three instances of that design, picked by the wrapper from the shape
// alone (lemke_lane.cuh::lane_instance against the card's opt-in limit):
//   * shared: the lane in one block's shared memory, bound by the latency
//     of the chain of phases (above);
//   * cluster: for lanes that do not fit one block (f32 n >= 136, f64
//     n >= 95 on an H100), the lane spread over a cluster of R = 2-8 blocks
//     on neighbouring SMs (lane_cluster_ranks: the fewest whose bands fit
//     the limit; f32 n=190 on 2, f64 n=152 on 3).  Rank k holds a band of
//     the tableau's rows and their vectors, every rank the column-length
//     vectors; the bands stay on chip for the whole path, and the phases
//     read across ranks through distributed shared memory with two cluster
//     barriers a pivot (lemke_lane.cuh).  Each rank decides alike from the
//     same data, so no decision is sent between ranks.  A pivot's update
//     and the next step's basic values and ratios are one pass over the
//     band (lane_run_fused: a group of 4 threads a row updates its chunk
//     and sums it while it is in registers), so the band is read and
//     written once a pivot, and each rank publishes its band's least ratio
//     for the decision; its rows lie at a stride that puts a warp's reads
//     of the pass on different banks (lane_cluster_stride).  What bounds it: the shared-memory traffic of that
//     pass (the band read and written, the staged row and the values read)
//     and the chain of phases, with the decision's scans reading other SMs'
//     shared memory and the cluster barriers, and at most one cluster on
//     each pair of SMs (one band fills an SM's shared memory).  Launched
//     with cudaLaunchKernelEx and a cluster dimension;
//     the first launch at each size checks that such a cluster fits the
//     card (cudaOccupancyMaxActiveClusters) and returns CUDA's error where
//     it does not: there is no fallback to another instance;
//   * global (lemke_pivot_global_kernel): past 8 ranks (f32 n above about
//     370, f64 above about 265), the same phases on a lane carved from a
//     device-memory workspace that the wrapper allocates.  Its tableau is read and written through L1
//     and L2 every pivot, so it is bound by the bandwidth one SM has to
//     them.  Where the batch leaves SMs idle (the f64 re-pivot of a few
//     stragglers), the lane is spread over R blocks on any SMs
//     (lane_global_ranks: the card's resident blocks shared among the
//     lanes, at most 8): rank k's band of the tableau sits in the workspace
//     at a fixed stride from its peers', its own part (scalars, the
//     column-length vectors, the staged row, the tie list) in its shared
//     memory, and the ranks meet at the lane's barrier in device memory
//     (lane_barrier.cuh), two a pivot as in the cluster.  So R SMs stream
//     the lane's tableau where one did.  Launched cooperatively
//     (cluster_launch.cuh::launch_cooperative): a grid that cannot be
//     resident at once is refused with CUDA's error, never run to a
//     deadlock, and nothing else is tried.  At R = 1 (B fills the card) it
//     is one block a lane with the whole lane in the workspace
//     (lane_bytes(n) a lane), a plain launch.  The wrapper's private
//     launcher also runs it at cluster sizes, and at R = 1 where the pick
//     spreads it, to hold the instances against each other on the card.
//
// Templated on float (the hot f32 tier) and double (the straggler re-pivot).
// Built with nvcc -O3 -fmad=false, no fast math (utils/cuda_build.py).
//
// C interface (ctypes): qpn_lemke_pivot_f32 / _f64 (the shared instance),
// qpn_lemke_pivot_cluster_f32 / _f64 (given its ranks) and
// qpn_lemke_pivot_global_f32 / _f64 (given its ranks and workspace) return
// 0 or a cudaError_t; qpn_lemke_lane_instance, qpn_lemke_cluster_ranks and
// qpn_lemke_global_ranks are the pure choice, qpn_lemke_smem_optin and
// qpn_lemke_global_resident what it takes from the current card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "lane_barrier.cuh"
#include "lemke_lane.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;   // a multiple of 32 and of qpn::kLemkeSplit

// Threads a block of the cluster instance, whose bands are larger than any
// lane of the shared instance: more warps hide more of the shared-memory
// latency of phases A and C (512 measured faster than 256 and 1024 on an
// H100).
constexpr int kClusterThreads = 512;

// One block a lane (LANE_SHARED): the block's dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lemke_pivot_kernel(qpn::LemkeBatch<T> bt) {
    extern __shared__ __align__(16) unsigned char smem[];
    const qpn::Lane<T> L = qpn::lane_carve<T>(smem, bt.n);
    qpn::lane_load(L, bt, blockIdx.x, threadIdx.x, kThreads);
    qpn::lane_run(L, threadIdx.x, kThreads, bt.tol, bt.piv_tol,
                  bt.max_pivots);
    qpn::lane_store(L, bt, blockIdx.x, threadIdx.x, kThreads);
}

// One cluster of R blocks a lane (LANE_CLUSTER): rank k's band in block
// k's shared memory, the fused loop.  One block an SM is all a band's
// shared memory allows, so the bound lets nvcc give a thread up to 128
// registers (under the bound of 512 threads alone it held the f32 kernel
// to 64 and spilled).
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1)
lemke_pivot_cluster_kernel(qpn::LemkeBatch<T> bt, int R, int ld) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int rank = (int)cg::this_cluster().block_rank();
    const size_t b = blockIdx.x / R;
    const qpn::Lane<T> L =
        qpn::lane_carve<T>(smem, bt.n, R, rank, nullptr, ld);
    qpn::lane_load(L, bt, b, threadIdx.x, kClusterThreads);
    qpn::lane_run_fused(L, threadIdx.x, kClusterThreads, bt.tol, bt.piv_tol,
                        bt.max_pivots);
    qpn::lane_store(L, bt, b, threadIdx.x, kClusterThreads);
    // no block leaves while a peer may still read its shared memory
    cg::this_cluster().sync();
}

// The global instance: R blocks a lane.  At R = 1, lane b whole in the
// device-memory workspace; at R > 1, rank k of lane b on any SM, its band
// at its stride in the workspace, its own part in shared memory, the
// lane's barrier at bars + 2b.  One block an SM is all it asks for: at
// most one block of it an SM runs when spread, and without the bound nvcc
// traded registers for blocks an SM and spilled in the R = 1 path.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lemke_pivot_global_kernel(qpn::LemkeBatch<T> bt, unsigned char* workspace,
                          unsigned* bars, int R) {
    extern __shared__ __align__(16) unsigned char smem[];
    if (R == 1) {
        const size_t b = blockIdx.x;
        const qpn::Lane<T> L = qpn::lane_carve<T>(
            workspace + b * qpn::lane_bytes<T>(bt.n), bt.n);
        qpn::lane_load(L, bt, b, threadIdx.x, kThreads);
        qpn::lane_run(L, threadIdx.x, kThreads, bt.tol, bt.piv_tol,
                      bt.max_pivots);
        qpn::lane_store(L, bt, b, threadIdx.x, kThreads);
        return;
    }
    const int rank = (int)(blockIdx.x % R);
    const size_t b = blockIdx.x / R;
    const qpn::Lane<T> L = qpn::lane_carve_spread<T>(
        smem,
        workspace + b * qpn::lane_global_lane_bytes(bt.n, sizeof(T), R)
            + rank * qpn::lane_spread_band_bytes<T>(
                  bt.n, qpn::lane_band_height(bt.n, R)),
        bt.n, R, rank, bars + 2 * b);
    qpn::lane_load(L, bt, b, threadIdx.x, kThreads);
    qpn::lane_run(L, threadIdx.x, kThreads, bt.tol, bt.piv_tol,
                  bt.max_pivots);
    qpn::lane_store(L, bt, b, threadIdx.x, kThreads);
}

template <typename T>
int launch_shared(const qpn::LemkeBatch<T>& bt, cudaStream_t stream) {
    if (bt.B <= 0) return 0;
    const size_t bytes = qpn::lane_bytes<T>(bt.n);
    auto kernel = lemke_pivot_kernel<T>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    kernel<<<bt.B, kThreads, bytes, stream>>>(bt);
    return cudaGetLastError();
}

// R = 1: a plain launch, one block a lane; R > 1: the cooperative launch
// of B · R blocks, whose barriers (2 words a lane) the caller has zeroed.
template <typename T>
int launch_global(const qpn::LemkeBatch<T>& bt, int R, void* workspace,
                  void* bars, cudaStream_t stream) {
    if (bt.B <= 0) return 0;
    if (workspace == nullptr || R < 1 || (R > 1 && bars == nullptr))
        return cudaErrorInvalidValue;
    auto kernel = lemke_pivot_global_kernel<T>;
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    if (R == 1) {
        kernel<<<bt.B, kThreads, 0, stream>>>(bt, ws, nullptr, 1);
        return cudaGetLastError();
    }
    return qpn::launch_cooperative(kernel, bt.B, R, kThreads,
                                   qpn::lane_spread_own_bytes<T>(bt.n),
                                   stream, bt, ws,
                                   static_cast<unsigned*>(bars), R);
}

template <typename T>
int launch_cluster(const qpn::LemkeBatch<T>& bt, int R, cudaStream_t stream) {
    // the largest band checked at each cluster size
    static size_t checked[qpn::kLaneMaxRanks + 1] = {};
    if (R < 1) return cudaErrorInvalidValue;
    const int nb = qpn::lane_band_height(bt.n, R);
    const int ld = qpn::lane_cluster_stride<T>(bt.n, nb, qpn::smem_optin());
    return qpn::launch_cluster(lemke_pivot_cluster_kernel<T>, checked, bt.B,
                               R, kClusterThreads,
                               qpn::lane_band_bytes<T>(bt.n, nb, ld), stream,
                               bt, R, ld);
}

}  // namespace

extern "C" {

int qpn_lemke_pivot_f32(QPN_LEMKE_PARAMS(float), void* stream) {
    return launch_shared(QPN_LEMKE_BATCH(float), (cudaStream_t)stream);
}

int qpn_lemke_pivot_f64(QPN_LEMKE_PARAMS(double), void* stream) {
    return launch_shared(QPN_LEMKE_BATCH(double), (cudaStream_t)stream);
}

// ranks: the cluster's blocks a lane (qpn_lemke_cluster_ranks)
int qpn_lemke_pivot_cluster_f32(QPN_LEMKE_PARAMS(float), int ranks,
                                void* stream) {
    return launch_cluster(QPN_LEMKE_BATCH(float), ranks, (cudaStream_t)stream);
}

int qpn_lemke_pivot_cluster_f64(QPN_LEMKE_PARAMS(double), int ranks,
                                void* stream) {
    return launch_cluster(QPN_LEMKE_BATCH(double), ranks,
                          (cudaStream_t)stream);
}

// ranks: the lane's blocks (qpn_lemke_global_ranks); workspace: B *
// qpn_lemke_global_lane_bytes(n, itemsize, ranks) bytes of device memory;
// bars: 2 * B zeroed unsigned ints where ranks > 1
int qpn_lemke_pivot_global_f32(QPN_LEMKE_PARAMS(float), int ranks,
                               void* workspace, void* bars, void* stream) {
    return launch_global(QPN_LEMKE_BATCH(float), ranks, workspace, bars,
                         (cudaStream_t)stream);
}

int qpn_lemke_pivot_global_f64(QPN_LEMKE_PARAMS(double), int ranks,
                               void* workspace, void* bars, void* stream) {
    return launch_global(QPN_LEMKE_BATCH(double), ranks, workspace, bars,
                         (cudaStream_t)stream);
}

long long qpn_lemke_lane_bytes(int n, int itemsize) {
    return (long long)qpn::lane_band_bytes_of(n, n, itemsize);
}

long long qpn_lemke_global_lane_bytes(int n, int itemsize, int ranks) {
    return (long long)qpn::lane_global_lane_bytes(n, itemsize, ranks);
}

int qpn_lemke_global_ranks(int n, int itemsize, int B, long long resident,
                           long long smem_optin) {
    return qpn::lane_global_ranks(n, itemsize, B, resident, smem_optin);
}

// The blocks of the global instance the current card holds at once, each
// with the opt-in limit of shared memory (one an SM), or minus a
// cudaError_t.
long long qpn_lemke_global_resident(int itemsize) {
    const long long optin = qpn::smem_optin();
    if (optin < 0) return optin;
    return itemsize == 4
        ? qpn::resident_blocks(lemke_pivot_global_kernel<float>, kThreads,
                               (size_t)optin)
        : qpn::resident_blocks(lemke_pivot_global_kernel<double>, kThreads,
                               (size_t)optin);
}

int qpn_lemke_cluster_ranks(int n, int itemsize, long long smem_optin) {
    return qpn::lane_cluster_ranks(n, itemsize, smem_optin);
}

long long qpn_lemke_band_bytes(int n, int itemsize, int ranks) {
    return (long long)qpn::lane_band_bytes_of(
        n, qpn::lane_band_height(n, ranks), itemsize);
}

int qpn_lemke_lane_instance(int n, int itemsize, long long smem_optin) {
    return qpn::lane_instance(n, itemsize, smem_optin);
}

// The shared memory a block can opt into on the current card, or minus a
// cudaError_t.
long long qpn_lemke_smem_optin(void) { return qpn::smem_optin(); }

const char* qpn_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
