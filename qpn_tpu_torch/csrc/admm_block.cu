// The batched ADMM's inner block for NVIDIA Hopper (sm_90a), in f64: the
// `iters` bare iterations of ops/batch_qp.py::solve_qp_batch between two
// status checks (_iterate, 25 a block) for every lane, in one launch
// (admm_lane.cuh states the arithmetic and the order of its sums).
//
// It replaces no Pallas kernel: the JAX package's counterpart is the inner
// fori_loop of qpn_tpu/ops/batch_qp.py::_admm_solve, which XLA fuses.  It
// was written because the plain loop ran a block as 25 batched Cholesky
// solves, each of which MAGMA makes wait on the card for a batch of more
// than one lane, and about 15 small PyTorch launches an iteration: on the
// shared-matrix route's ADMM rung (15-20 lanes of n = 96, m = 256) the
// host's launches and waits, not the card, held the rung.
//
// What bounds it: latency.  A lane does 2·m·n + n² multiply-adds an
// iteration (0.06 M at n = 96, m = 256), but its triangular solves are
// chains of n dependent steps each (a shuffle, a division, a multiply and
// a subtraction), and the block's 15-20 lanes occupy as many SMs.  The
// design keeps each chain's step inside one warp with no block barrier:
// the solving warp holds the right-hand side in registers, thread l rows
// l, l + 32, ... (NR = ceil(n / 32) of them, a template parameter, so that
// no step spends instructions on rows a lane does not hold), broadcasts
// the step's entry with a shuffle and divides it by the diagonal with the
// operator.  The two products with A read A once each an iteration, every
// warp of the block on its rows with neighbouring threads on neighbouring
// columns.
//
// One block of kAdmmThreads a lane: L in shared memory, rows admm_ld(n)
// apart (74 KB at n = 96), the lane's vectors beside it, A read in place
// from device memory through the L2 (196 KB a lane at n = 96, m = 256).
// The wrapper launches it only where admm_lane.cuh::admm_fits holds;
// other shapes keep the plain loop.
//
// Built with nvcc -O3 -fmad=false, no fast math (utils/cuda_build.py), into
// a library of its own (ops/admm_cuda.py).  C interface (ctypes):
// qpn_admm_block launches on a stream and returns 0 or a cudaError_t;
// qpn_admm_fits is the pure choice, qpn_admm_smem_optin the current card's
// opt-in limit (or minus a cudaError_t).

#include <cuda_runtime.h>

#include "admm_lane.cuh"

namespace {

constexpr int W = qpn::kAdmmWarps;
constexpr unsigned kFull = 0xffffffffu;

// The forward and back substitution of the solving warp on its rows r
// (thread `lane` rows lane, lane + 32, ...), in place: x̃ = L⁻ᵀ L⁻¹ r, L in
// shared memory with rows ld apart.  Every thread takes the step's entry
// from its owner and divides it itself, so all hold v; the loads of the
// step's column of L come first, ahead of the chain.
template <int NR>
__device__ __forceinline__ void substitute(double (&r)[NR], const double* Ls,
                                           int ld, int n, int lane) {
    // forward: L v = r
#pragma unroll
    for (int kb = 0; kb < NR; ++kb) {
        for (int jl = 0; jl < 32; ++jl) {
            const int j = kb * 32 + jl;
            if (j >= n) break;
            double l[NR];
#pragma unroll
            for (int k = kb; k < NR; ++k) {
                const int i = k * 32 + lane;
                l[k] = i > j && i < n ? Ls[i * ld + j] : 0.0;
            }
            const double v = __shfl_sync(kFull, r[kb], jl) / Ls[j * (ld + 1)];
            if (lane == jl) r[kb] = v;
#pragma unroll
            for (int k = kb; k < NR; ++k) {
                const int i = k * 32 + lane;
                if (i > j && i < n) r[k] = r[k] - l[k] * v;
            }
        }
    }
    // back: Lᵀ x̃ = v
#pragma unroll
    for (int kb = NR - 1; kb >= 0; --kb) {
        for (int jl = 31; jl >= 0; --jl) {
            const int j = kb * 32 + jl;
            if (j >= n) continue;
            double l[NR];
#pragma unroll
            for (int k = kb; k >= 0; --k) {
                const int i = k * 32 + lane;
                l[k] = i < j ? Ls[j * ld + i] : 0.0;
            }
            const double xj = __shfl_sync(kFull, r[kb], jl)
                / Ls[j * (ld + 1)];
            if (lane == jl) r[kb] = xj;
#pragma unroll
            for (int k = kb; k >= 0; --k) {
                const int i = k * 32 + lane;
                if (i < j) r[k] = r[k] - l[k] * xj;
            }
        }
    }
}

// NR = admm_rows(n): the rows of the solving warp's threads and the
// columns of a thread in the products with A.
template <int NR>
__global__ void __launch_bounds__(qpn::kAdmmThreads, 1)
admm_block_kernel(qpn::AdmmBatch bt) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int n = bt.n, m = bt.m, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const size_t b = blockIdx.x;
    const double sigma = bt.sigma, alpha = bt.alpha;
    const double* Ag = bt.A + b * (size_t)m * n;
    const double* Lg = bt.L + b * (size_t)n * n;
    const int ld = qpn::admm_ld(n);
    double* Ls = reinterpret_cast<double*>(smem);        // L(i, j) at i·ld + j
    double* part = Ls + (size_t)n * ld;                  // W × n
    double* x = part + (size_t)W * n;
    double* dx = x + n;
    double* q = dx + n;
    double* xt = q + n;                                  // x̃
    double* z = xt + n;
    double* y = z + m;
    double* dy = y + m;
    double* R = dy + m;
    double* lc = R + m;
    double* uc = lc + m;
    double* w = uc + m;                                  // R∘z − y
    double* ax = w + m;                                  // A x̃
    unsigned char* loose = reinterpret_cast<unsigned char*>(ax + m);

    for (int k = tid; k < n * n; k += blockDim.x) {
        const int a = k / n, c = k % n;
        Ls[bt.L_cm ? (size_t)c * ld + a : (size_t)a * ld + c] = Lg[k];
    }
    for (int j = tid; j < n; j += blockDim.x) {
        x[j] = bt.x[b * n + j];
        dx[j] = bt.dx[b * n + j];
        q[j] = bt.q[b * n + j];
    }
    for (int i = tid; i < m; i += blockDim.x) {
        const size_t g = b * m + i;
        z[i] = bt.z[g];
        y[i] = bt.y[g];
        dy[i] = bt.dy[g];
        R[i] = bt.R[g];
        lc[i] = bt.lc[g];
        uc[i] = bt.uc[g];
        loose[i] = bt.loose[g];
        w[i] = qpn::admm_w(R[i], z[i], y[i]);
    }
    __syncthreads();

    for (int it = 0; it < bt.iters; ++it) {
        // Aᵀw: warp p sums the rows i ≡ p (mod W), thread l the columns
        // l, l + 32, ...
        {
            double acc[NR];
#pragma unroll
            for (int c = 0; c < NR; ++c) acc[c] = 0.0;
#pragma unroll 4
            for (int i = warp; i < m; i += W) {
                const double wi = w[i];
                const double* Ai = Ag + (size_t)i * n;
#pragma unroll
                for (int c = 0; c < NR; ++c) {
                    const int j = c * 32 + lane;
                    if (j < n) acc[c] = acc[c] + __ldg(Ai + j) * wi;
                }
            }
#pragma unroll
            for (int c = 0; c < NR; ++c) {
                const int j = c * 32 + lane;
                if (j < n) part[warp * n + j] = acc[c];
            }
        }
        __syncthreads();
        // warp 0: the right-hand side, the two triangular solves, x
        if (warp == 0) {
            double r[NR];
#pragma unroll
            for (int k = 0; k < NR; ++k) {
                const int j = k * 32 + lane;
                double v = 0.0;
                if (j < n) {
                    double s = part[j];
                    for (int p = 1; p < W; ++p) s = s + part[p * n + j];
                    v = qpn::admm_rhs(sigma, x[j], q[j], s);
                }
                r[k] = v;
            }
            substitute<NR>(r, Ls, ld, n, lane);
#pragma unroll
            for (int k = 0; k < NR; ++k) {
                const int j = k * 32 + lane;
                if (j < n) {
                    xt[j] = r[k];
                    qpn::admm_var(r[k], alpha, x[j], dx[j]);
                }
            }
        }
        __syncthreads();
        // A x̃: a warp a row, thread l on the columns l, l + 32, ..., joined
        // by the butterfly
#pragma unroll 4
        for (int i = warp; i < m; i += W) {
            const double* Ai = Ag + (size_t)i * n;
            double acc = 0.0;
#pragma unroll
            for (int c = 0; c < NR; ++c) {
                const int j = c * 32 + lane;
                if (j < n) acc = acc + __ldg(Ai + j) * xt[j];
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                acc = acc + __shfl_xor_sync(kFull, acc, o);
            if (lane == 0) ax[i] = acc;
        }
        __syncthreads();
        for (int i = tid; i < m; i += blockDim.x)
            w[i] = qpn::admm_row(ax[i], R[i], lc[i], uc[i], loose[i] != 0,
                                 alpha, z[i], y[i], dy[i]);
        __syncthreads();
    }

    for (int j = tid; j < n; j += blockDim.x) {
        bt.x[b * n + j] = x[j];
        bt.dx[b * n + j] = dx[j];
    }
    for (int i = tid; i < m; i += blockDim.x) {
        const size_t g = b * m + i;
        bt.z[g] = z[i];
        bt.y[g] = y[i];
        bt.dy[g] = dy[i];
    }
}

template <int NR>
int launch_rows(const qpn::AdmmBatch& bt, cudaStream_t stream) {
    const size_t bytes = qpn::admm_bytes(bt.n, bt.m);
    auto kernel = admm_block_kernel<NR>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    kernel<<<bt.B, qpn::kAdmmThreads, bytes, stream>>>(bt);
    return cudaGetLastError();
}

int launch(const qpn::AdmmBatch& bt, cudaStream_t stream) {
    if (bt.B <= 0) return 0;
    if (bt.n < 1 || bt.n > qpn::kAdmmMaxN || bt.m < 0 || bt.iters < 0)
        return cudaErrorInvalidValue;
    static_assert(qpn::kAdmmRowsPerLane == 5, "one case a row count");
    switch (qpn::admm_rows(bt.n)) {
    case 1: return launch_rows<1>(bt, stream);
    case 2: return launch_rows<2>(bt, stream);
    case 3: return launch_rows<3>(bt, stream);
    case 4: return launch_rows<4>(bt, stream);
    case 5: return launch_rows<5>(bt, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a shape the card refuses (admm_fits false) returns its cudaError_t
int qpn_admm_block(QPN_ADMM_PARAMS, void* stream) {
    return launch(QPN_ADMM_BATCH, (cudaStream_t)stream);
}

int qpn_admm_fits(int n, int m, long long smem_optin) {
    return qpn::admm_fits(n, m, smem_optin);
}

long long qpn_admm_smem_optin(void) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return e == cudaSuccess ? (long long)optin : -(long long)e;
}

const char* qpn_admm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
