// Per-lane logic of the hybrid solver's extragradient hop, shared by the
// Hopper kernels (hybrid_hop.cu) and a host instance built with g++ for the
// CPU tests (hop_lane_host.cpp).
//
// The hop is ops/avi.py::_eg_phase on one lane of a box AVI
//     M z + q  ⟂  l ≤ z ≤ u,
// in the lane's precision T (float or double): with t = τ,
//     z½ = Π(z − t·F(z)),   z⁺ = Π(z − t·F(z½)),   F(x) = M x + q,
// `steps` times, and after each step the merit of the new iterate,
//     m(z) = ½ ‖Φ(z)‖²,   Φ(z) = z − Π(z − F(z)),
// with the best-merit iterate kept: best_z ← z where m < best_m (strict),
// best_m ← minimum(m, best_m) with NaN taking over as torch.minimum does.
// The merit of the start is best_m's first value (m0 against +inf: best_z
// starts at z).  Π(x) = min(max(x, l), u), NaN passing through and IEEE
// infinities kept, as torch.clamp does.
//
// F(z⁺), computed for the merit, is the next step's first F, so a step
// costs two matrix-vector products where the plain loop computes three,
// with the same arithmetic on the same values.  A step is two phases:
//   A: F = M z + q;  Φ_i and z½_i from it;
//   B: m from Φ (the merit of z), the best-merit update; z⁺ from M z½ + q;
// and the hop ends with a last phase A and merit for the final z.  The two
// sums of phase B do not depend on each other.
//
// The order of every sum — (M x)_i, and S = Σ Φ_j·Φ_j of the merit — is
// the partition (G, C) of eg_lane.cuh (chunks of C neighbouring columns
// summed from +0, joined by a butterfly over G): the register instance's
// (kEgGroup, hop_pick_chunk(n, itemsize)), every thread of a row's group
// holding the row's chunk of M in registers; the generic instances' (1, n),
// plain
// column order, with M in one block's shared memory (shared) or read in
// place from device memory (global).  hop_instance picks from n and the
// precision.  Built with -fmad=false on the card, so every product and sum
// rounds on its own, as on the host.

#pragma once

#include <cmath>
#include <cstddef>

#include "eg_lane.cuh"

namespace qpn {

// Batched inputs and outputs in device (or host) memory, row-major: M (B,
// n, n); q, l, u, z0, z_out, best_z (B, n); tau, best_m (B,).
template <typename T>
struct HopBatch {
    const T* M;
    const T* q;
    const T* l;
    const T* u;
    const T* z0;
    const T* tau;
    T* z_out;
    T* best_z;
    T* best_m;
    int B, n, steps;
};

enum { HOP_REGISTER = 0, HOP_SHARED = 1, HOP_GLOBAL = 2 };

// The register instance's chunk for rows of n columns in elements of
// `itemsize` bytes: K2's partition (eg_pick_chunk) up to n = 64 in f32 and
// n = 40 in f64, 0 past it.  On an H100 at 256 lanes and 60 steps the
// register instance beats the shared one by 1.2-3x up to those n; f64's
// chunk of 16 (n = 41-64, 102 registers a thread) runs 1.3-1.5x slower
// than the shared instance.
QPN_EG_HD int hop_pick_chunk(int n, int itemsize) {
    return n <= (itemsize == 8 ? 40 : 64) ? eg_pick_chunk(n) : 0;
}

// Elements of one row of the shared instance's copy of M: an odd stride, so
// that the rows neighbouring threads read lie on different banks.
QPN_EG_HD int hop_ld(int n) { return n | 1; }

// Elements of the generic instances' vectors: z, z½, Φ, best z, q, l, u.
constexpr int kHopVectors = 7;

// Shared memory of the generic instances' lane: the vectors, and M ahead of
// them in the shared instance.  Every part starts at a multiple of 16 bytes.
QPN_EG_HD size_t hop_generic_bytes(int n, int itemsize, bool with_M) {
    const size_t per16 = 16 / (size_t)itemsize;
    const size_t vec = ((size_t)n + per16 - 1) / per16 * per16;
    const size_t mat = with_M
        ? ((size_t)n * hop_ld(n) + per16 - 1) / per16 * per16 : 0;
    return (mat + kHopVectors * vec) * (size_t)itemsize;
}

// The instance for rows of n in elements of `itemsize` bytes under the
// card's opt-in limit of shared memory a block (232448 bytes on an H100:
// the shared instance up to n = 238 in f32, 168 in f64): a choice by shape.
// On an H100 at 256 lanes and 60 steps the shared instance beats M read in
// place by 1.4x (n = 65) to 10x (f32 n = 160) wherever it fits.
QPN_EG_HD int hop_instance(int n, int itemsize, long long smem_optin) {
    if (hop_pick_chunk(n, itemsize) != 0) return HOP_REGISTER;
    if (smem_optin >= 0
        && hop_generic_bytes(n, itemsize, true) <= (size_t)smem_optin)
        return HOP_SHARED;
    return HOP_GLOBAL;
}

// +inf, best_m's value before the merit of the start.
template <typename T>
QPN_EG_HD T hop_inf() { return T(HUGE_VAL); }

template <typename T>
QPN_EG_HD T hop_clip(T x, T lo, T hi) {
    const T a = x < lo ? lo : x;
    return a > hi ? hi : a;
}

// torch.minimum: NaN if either is NaN.
template <typename T>
QPN_EG_HD T hop_min(T a, T b) {
    if (a != a) return a;
    if (b != b) return b;
    return b < a ? b : a;
}

// One chunk's partial sum from registers.
template <typename T, int C>
QPN_EG_HD T hop_chunk(const T (&a)[C], const T (&x)[C]) {
    T acc = T(0);
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int k = 0; k < C; ++k) acc = acc + a[k] * x[k];
    return acc;
}

#if defined(__CUDACC__)
// The butterfly over a group of G neighbouring threads of a warp.
template <typename T, int G>
__device__ __forceinline__ T hop_tree(T acc) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
        acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
    return acc;
}
#endif

// Σ_j a_j x_j under the partition (G, C) as a loop: the chunks in column
// order, then the butterfly on the array of partial sums (G = 1, C = n:
// plain column order).
template <typename T, int G>
QPN_EG_HD T hop_sum(const T* a, const T* x, int n, int C) {
    T part[G], next[G];
    for (int g = 0; g < G; ++g) {
        T acc = T(0);
        for (int k = 0; k < C; ++k) {
            const int j = g * C + k;
            acc = acc + (j < n ? a[j] : T(0)) * (j < n ? x[j] : T(0));
        }
        part[g] = acc;
    }
    for (int o = G / 2; o > 0; o >>= 1) {
        for (int g = 0; g < G; ++g) next[g] = part[g] + part[g ^ o];
        for (int g = 0; g < G; ++g) part[g] = next[g];
    }
    return part[0];
}

// The best-merit update from the sum S of Φ's squares: m = ½ S against
// best_m.  Returns whether the iterate whose merit this is becomes the best
// (every thread of a lane holds the same bits of S and best_m, so all reach
// the same decision).
template <typename T>
QPN_EG_HD bool hop_keep(T S, T& best_m) {
    const T m = T(0.5) * S;
    const bool better = m < best_m;
    best_m = hop_min(m, best_m);
    return better;
}

}  // namespace qpn

// The C interface's parameter list and the batch built from it.
#define QPN_HOP_PARAMS(T)                                                  \
    const T *M, const T *q, const T *l, const T *u, const T *z0,          \
        const T *tau, T *z_out, T *best_z, T *best_m, int B, int n,       \
        int steps
#define QPN_HOP_BATCH(T)                                                   \
    qpn::HopBatch<T> { M, q, l, u, z0, tau, z_out, best_z, best_m, B, n,  \
                       steps }
