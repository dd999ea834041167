// Per-lane logic of the batched ADMM's inner block, shared by the Hopper
// kernel (admm_block.cu) and a host build compiled with g++ for the CPU
// tests (admm_lane_host.cpp).
//
// The block is `iters` calls of ops/batch_qp.py::_iterate on one lane of
// the scaled QP, in f64: with the lane's Cholesky factor L of
// K(ρ) = P + σI + ρG, R = ρ·base_r, α the relaxation and ω = 1 − α,
//     rhs = (σ·x − q) + Aᵀ(R∘z − y)
//     x̃  = L⁻ᵀ L⁻¹ rhs            (forward, then back substitution)
//     z_r = α·(A x̃) + ω·z,   z_t = z_r + y / R
//     z⁺ = z_t on loose rows, else clamp(z_t, lc, uc)
//     y⁺ = y + R∘(z_r − z⁺)
//     x⁺ = α·x̃ + ω·x
//     dx ← dx·½ + (x⁺ − x),   dy ← dy·½ + (y⁺ − y)
// every product and sum rounded on its own (the card builds with
// -fmad=false), clamp as torch.clamp: NaN passes through.
//
// The order of the sums — the kernel's partition, which the host build
// follows step for step, so the two give the same bits:
//   * (Aᵀw)_j: kAdmmWarps partial sums, partial p over the rows i ≡ p
//     (mod kAdmmWarps) in ascending order from +0, then the partials added
//     in order p = 0, 1, ...;
//   * (A x̃)_i: 32 partial sums, partial l over the columns j ≡ l (mod 32)
//     in ascending order from +0, joined by a butterfly (xor 16, 8, 4, 2,
//     1; each step a partial plus its partner);
//   * the triangular solves, column by column: forward, for j = 0, 1, ...:
//     v_j = r_j / L_jj, then r_i ← r_i − L_ij·v_j for i > j; back, for
//     j = n−1, ..., 0: x_j = v_j / L_jj, then v_i ← v_i − L_ji·x_j for
//     i < j.
// Only the order of the sums differs from the plain loop's PyTorch calls;
// every division is the operator's.

#pragma once

#include <cmath>
#include <cstddef>

#if defined(__CUDACC__)
#define QPN_ADMM_HD __host__ __device__ __forceinline__
#else
#define QPN_ADMM_HD inline
#endif

namespace qpn {

// Batched inputs in device (or host) memory, row-major: A (B, m, n), L (B,
// n, n) lower triangular (the upper part is not read), each matrix
// row-major or, where L_cm is 1, column-major (as torch.linalg.cholesky_ex
// returns it), R, lc, uc (B, m), loose (B, m) bytes 0/1, q (B, n); the
// state x, dx (B, n), z, y, dy (B, m), read at the start and written back
// at the end of the block.
struct AdmmBatch {
    const double* A;
    const double* L;
    const double* R;
    const double* q;
    const double* lc;
    const double* uc;
    const unsigned char* loose;
    double* x;
    double* z;
    double* y;
    double* dx;
    double* dy;
    double sigma, alpha;
    int B, n, m, iters, L_cm;
};

// Warps of a block; the partials of Aᵀw.
constexpr int kAdmmWarps = 16;
constexpr int kAdmmThreads = 32 * kAdmmWarps;
// Rows of the triangular solves a thread of the solving warp holds in
// registers: the kernel takes n <= 32 · kAdmmRowsPerLane, as far as L and
// the vectors of n = 160 fit an H100's opt-in limit.
constexpr int kAdmmRowsPerLane = 5;
constexpr int kAdmmMaxN = 32 * kAdmmRowsPerLane;

// Elements of a row of the shared copy of L: odd, so that the column reads
// of the forward solve spread over the banks.
QPN_ADMM_HD int admm_ld(int n) { return n | 1; }

// Doubles of the lane's vectors in shared memory: x, dx, q, x̃ (n each), the
// partials of Aᵀw (kAdmmWarps · n), z, y, dy, R, lc, uc, w = R∘z − y, A x̃
// (m each).
constexpr int kAdmmVecN = 4 + kAdmmWarps;
constexpr int kAdmmVecM = 8;

// Shared memory of a lane: L (n rows of admm_ld(n)), the vectors, and the
// loose flags (m bytes).
QPN_ADMM_HD size_t admm_bytes(int n, int m) {
    const size_t d = (size_t)kAdmmVecN * n + (size_t)kAdmmVecM * m
        + (size_t)n * admm_ld(n);
    return d * sizeof(double) + ((size_t)m + 15) / 16 * 16;
}

// Whether the kernel takes lanes of n variables and m rows under the card's
// opt-in limit of shared memory a block (232448 bytes on an H100): n up to
// kAdmmMaxN and the lane's L and vectors within the limit (the trajectory
// cell's n = 96, m = 256; n = 154 at m = 256).  Elsewhere the plain loop.
// A choice by shape alone.
QPN_ADMM_HD bool admm_fits(int n, int m, long long smem_optin) {
    if (n < 1 || n > kAdmmMaxN || m < 0 || smem_optin < 0) return false;
    return admm_bytes(n, m) <= (size_t)smem_optin;
}

// The rows a thread of the solving warp holds, ceil(n / 32): the kernel's
// template instance for lanes of n variables.
QPN_ADMM_HD int admm_rows(int n) { return (n + 31) / 32; }

// torch.clamp(v, lo, hi): NaN in any of the three gives NaN.
QPN_ADMM_HD double admm_clamp(double v, double lo, double hi) {
    if (v != v) return v;
    if (lo != lo) return lo;
    if (hi != hi) return hi;
    const double a = v < lo ? lo : v;
    return hi < a ? hi : a;
}

// The start of the right-hand side, σ·x − q; (Aᵀw)_j is added to it.
QPN_ADMM_HD double admm_rhs(double sigma, double x, double q, double s) {
    return (sigma * x - q) + s;
}

// The update of variable j from x̃_j.
QPN_ADMM_HD void admm_var(double xt, double alpha, double& x, double& dx) {
    const double xn = alpha * xt + (1.0 - alpha) * x;
    dx = dx * 0.5 + (xn - x);
    x = xn;
}

// The update of row i from (A x̃)_i; returns the row's w = R·z⁺ − y⁺ of
// the next iteration's Aᵀw.
QPN_ADMM_HD double admm_row(double ax, double R, double lc, double uc,
                            bool loose, double alpha, double& z, double& y,
                            double& dy) {
    const double zr = alpha * ax + (1.0 - alpha) * z;
    const double zt = zr + y / R;
    const double zn = loose ? zt : admm_clamp(zt, lc, uc);
    const double yn = y + R * (zr - zn);
    dy = dy * 0.5 + (yn - y);
    z = zn;
    y = yn;
    return R * zn - yn;
}

// w of the block's first iteration.
QPN_ADMM_HD double admm_w(double R, double z, double y) { return R * z - y; }

}  // namespace qpn

// The C interface's parameter list and the batch built from it.
#define QPN_ADMM_PARAMS                                                     \
    const double *A, const double *L, const double *R, const double *q,    \
        const double *lc, const double *uc, const unsigned char *loose,    \
        double *x, double *z, double *y, double *dx, double *dy,           \
        double sigma, double alpha, int B, int n, int m, int iters,        \
        int L_cm
#define QPN_ADMM_BATCH                                                      \
    qpn::AdmmBatch {                                                        \
        A, L, R, q, lc, uc, loose, x, z, y, dx, dy, sigma, alpha, B, n, m, \
            iters, L_cm                                                     \
    }
