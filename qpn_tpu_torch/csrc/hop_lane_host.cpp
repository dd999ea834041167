// Host instance of the hybrid hop's lane code (hop_lane.cuh), built with
// plain g++ into the extragradient kernel's host library and loaded with
// ctypes by the CPU tests: each lane runs phases A and B in turn, every sum
// in the partition of the instance that the card's launcher picks for this
// n and precision (hop_instance under `smem_optin`), or of the instance
// asked for, so the results are that instance's bits on the card.  Not on
// any production path.

#include <vector>

#include "hop_lane.cuh"

namespace {

template <typename T>
int hop_host(const qpn::HopBatch<T>& bt, long long smem_optin,
             int instance) {
    const int n = bt.n;
    if (instance < 0) instance = qpn::hop_instance(n, (int)sizeof(T),
                                                   smem_optin);
    const bool reg = instance == qpn::HOP_REGISTER;
    const int chunk = qpn::hop_pick_chunk(n, (int)sizeof(T));
    if (reg && chunk == 0) return -1;
    const int C = reg ? chunk : n;
    auto sum = [&](const T* a, const T* x) {
        return reg ? qpn::hop_sum<T, qpn::kEgGroup>(a, x, n, C)
                   : qpn::hop_sum<T, 1>(a, x, n, C);
    };
    std::vector<T> z(n), zh(n), ph(n), bz(n);
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const T* M = bt.M + b * n * n;
        const T* q = bt.q + b * n;
        const T* l = bt.l + b * n;
        const T* u = bt.u + b * n;
        const T tau = bt.tau[b];
        for (int i = 0; i < n; ++i) z[i] = bz[i] = bt.z0[b * n + i];
        T best_m = qpn::hop_inf<T>();
        for (int s = 0;; ++s) {
            for (int i = 0; i < n; ++i) {
                const T F = sum(M + (size_t)i * n, z.data()) + q[i];
                ph[i] = z[i] - qpn::hop_clip(z[i] - F, l[i], u[i]);
                zh[i] = qpn::hop_clip(z[i] - tau * F, l[i], u[i]);
            }
            if (qpn::hop_keep(sum(ph.data(), ph.data()), best_m)) bz = z;
            if (s == bt.steps) break;
            for (int i = 0; i < n; ++i) {
                const T Fh = sum(M + (size_t)i * n, zh.data()) + q[i];
                z[i] = qpn::hop_clip(z[i] - tau * Fh, l[i], u[i]);
            }
        }
        for (int i = 0; i < n; ++i) {
            bt.z_out[b * n + i] = z[i];
            bt.best_z[b * n + i] = bz[i];
        }
        bt.best_m[b] = best_m;
    }
    return 0;
}

}  // namespace

extern "C" {

// instance: the instance whose order of sums to take, or -1 for the one the
// card's launcher picks under smem_optin; returns 0, or -1 where the
// register instance has no chunk for n
int qpn_hybrid_hop_host_f32(QPN_HOP_PARAMS(float), long long smem_optin,
                            int instance) {
    return hop_host(QPN_HOP_BATCH(float), smem_optin, instance);
}

int qpn_hybrid_hop_host_f64(QPN_HOP_PARAMS(double), long long smem_optin,
                            int instance) {
    return hop_host(QPN_HOP_BATCH(double), smem_optin, instance);
}

int qpn_hop_instance(int n, int itemsize, long long smem_optin) {
    return qpn::hop_instance(n, itemsize, smem_optin);
}

}  // extern "C"
