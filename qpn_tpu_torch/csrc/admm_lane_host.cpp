// Host build of the batched ADMM block's lane code (admm_lane.cuh), compiled
// with plain g++ and loaded with ctypes by the CPU tests: each lane runs the
// block's iterations one step after the other, every sum in the kernel's
// partition, so the results are the kernel's bits.  Not on any production
// path.

#include <vector>

#include "admm_lane.cuh"

namespace {

constexpr int W = qpn::kAdmmWarps;

void admm_host(const qpn::AdmmBatch& bt) {
    const int n = bt.n, m = bt.m;
    std::vector<double> x(n), dx(n), q(n), r(n), w(m), z(m), y(m), dy(m),
        part(W);
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const double* A = bt.A + b * m * n;
        const double* Lb = bt.L + b * n * n;
        const size_t sr = bt.L_cm ? 1 : n, sc = bt.L_cm ? n : 1;
        auto L = [&](int i, int j) { return Lb[i * sr + j * sc]; };
        const double* R = bt.R + b * m;
        const double* lc = bt.lc + b * m;
        const double* uc = bt.uc + b * m;
        const unsigned char* loose = bt.loose + b * m;
        for (int j = 0; j < n; ++j) {
            x[j] = bt.x[b * n + j];
            dx[j] = bt.dx[b * n + j];
            q[j] = bt.q[b * n + j];
        }
        for (int i = 0; i < m; ++i) {
            z[i] = bt.z[b * m + i];
            y[i] = bt.y[b * m + i];
            dy[i] = bt.dy[b * m + i];
            w[i] = qpn::admm_w(R[i], z[i], y[i]);
        }
        for (int it = 0; it < bt.iters; ++it) {
            // rhs: σx − q + Aᵀw, Aᵀw in kAdmmWarps partials over the rows
            for (int j = 0; j < n; ++j) {
                for (int p = 0; p < W; ++p) {
                    double acc = 0.0;
                    for (int i = p; i < m; i += W)
                        acc = acc + A[(size_t)i * n + j] * w[i];
                    part[p] = acc;
                }
                double s = part[0];
                for (int p = 1; p < W; ++p) s = s + part[p];
                r[j] = qpn::admm_rhs(bt.sigma, x[j], q[j], s);
            }
            // forward L v = rhs, then back Lᵀ x̃ = v, column by column
            for (int j = 0; j < n; ++j) {
                const double v = r[j] / L(j, j);
                r[j] = v;
                for (int i = j + 1; i < n; ++i)
                    r[i] = r[i] - L(i, j) * v;
            }
            for (int j = n - 1; j >= 0; --j) {
                const double xj = r[j] / L(j, j);
                r[j] = xj;
                for (int i = 0; i < j; ++i)
                    r[i] = r[i] - L(j, i) * xj;
            }
            // A x̃ in 32 partials over the columns and a butterfly; the rows
            for (int i = 0; i < m; ++i) {
                double lane[32], next[32];
                for (int l = 0; l < 32; ++l) {
                    double acc = 0.0;
                    for (int j = l; j < n; j += 32)
                        acc = acc + A[(size_t)i * n + j] * r[j];
                    lane[l] = acc;
                }
                for (int o = 16; o > 0; o >>= 1) {
                    for (int l = 0; l < 32; ++l) next[l] = lane[l] + lane[l ^ o];
                    for (int l = 0; l < 32; ++l) lane[l] = next[l];
                }
                w[i] = qpn::admm_row(lane[0], R[i], lc[i], uc[i],
                                     loose[i] != 0, bt.alpha, z[i], y[i],
                                     dy[i]);
            }
            for (int j = 0; j < n; ++j)
                qpn::admm_var(r[j], bt.alpha, x[j], dx[j]);
        }
        for (int j = 0; j < n; ++j) {
            bt.x[b * n + j] = x[j];
            bt.dx[b * n + j] = dx[j];
        }
        for (int i = 0; i < m; ++i) {
            bt.z[b * m + i] = z[i];
            bt.y[b * m + i] = y[i];
            bt.dy[b * m + i] = dy[i];
        }
    }
}

}  // namespace

extern "C" {

// the block on every lane, in place on x, z, y, dx, dy
void qpn_admm_block_host(QPN_ADMM_PARAMS) { admm_host(QPN_ADMM_BATCH); }

int qpn_admm_fits(int n, int m, long long smem_optin) {
    return qpn::admm_fits(n, m, smem_optin);
}

}  // extern "C"
