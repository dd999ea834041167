// Host instance of the feasibility screen kernels' lane code
// (screen_lane.cuh), built with plain g++ and loaded with ctypes by the CPU
// tests.  It picks the instance as the card's launcher does, from the shape
// alone: polyhedra that fit a warp run the warp instance's register code with
// the 32 threads as a loop; larger ones run the phase functions as thread 0
// of 1 with no-op barriers, on a working set carved as the shared, the
// cluster or the global instance carves it.  The cluster's R ranks are R
// buffers, each phase run for rank 0, 1, ..., R-1 in turn: between two of
// the card's barriers no rank reads what another writes (screen_lane.cuh),
// so that gives the card's bits.  The global instance writes and reads the
// column-major copy of A as the card's block does.  Not on any production
// path.

#include <vector>

#include "screen_lane.cuh"

namespace {

using WarpHost = void (*)(const qpn::ScreenBatch&);
const WarpHost kWarpHost[8][8] = QPN_SCREEN_TABLE(qpn::screen_warp_host);

void one_block_host(const qpn::ScreenBatch& bt, bool global) {
    const size_t bytes = global
        ? qpn::screen_global_lane_bytes(bt.m, bt.n, 1)
        : qpn::screen_lane_bytes(bt.m, bt.n, 1);
    std::vector<float> buf(bytes / sizeof(float));
    std::vector<float> mt(global ? (size_t)bt.m * bt.n : 0);
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const qpn::ScreenLane L =
            global ? qpn::screen_lane_carve_global(bt, b, buf.data(),
                                                   mt.data())
                   : qpn::screen_lane_carve(buf.data(), bt.m, bt.n);
        qpn::screen_lane_load(L, bt, b, 0, 1);
        qpn::screen_lane_run(L, bt.steps, bt.lr, 0, 1);
        qpn::screen_lane_store(L, bt, b, 0, 1);
    }
}

void cluster_host(const qpn::ScreenBatch& bt, int R) {
    const size_t words = qpn::screen_cluster_bytes(bt.m, bt.n, R)
                         / sizeof(float);
    std::vector<float> buf(words * R);
    std::vector<float*> bases(R);
    for (int k = 0; k < R; ++k) bases[k] = buf.data() + k * words;
    std::vector<qpn::ScreenLane> L(R);
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        for (int k = 0; k < R; ++k) {
            L[k] = qpn::screen_lane_carve_cluster(bases[k], bt.m, bt.n, R, k,
                                                  bases.data());
            qpn::screen_lane_load(L[k], bt, b, 0, 1);
        }
        for (int s = 0;; ++s) {
            for (const auto& r : L) qpn::screen_violation(r, 0, 1);
            if (s == bt.steps) break;
            for (const auto& r : L) qpn::screen_update(r, bt.lr, 0, 1);
        }
        for (const auto& r : L) qpn::screen_lane_store(r, bt, b, 0, 1);
    }
}

}  // namespace

extern "C" {

// The instance the card's launcher picks under the opt-in limit
// smem_optin, the cluster's at the ranks screen_cluster_ranks picks; or,
// where ranks > 0, the cluster instance at that many ranks whatever the
// shape and the limit.
void qpn_screen_host_f32(QPN_SCREEN_PARAMS, long long smem_optin,
                         int ranks) {
    const qpn::ScreenBatch bt = QPN_SCREEN_BATCH;
    if (bt.B <= 0 || bt.m <= 0 || bt.n <= 0) return;
    if (ranks > 0) {
        cluster_host(bt, ranks);
        return;
    }
    const int instance = qpn::screen_instance(bt.m, bt.n, smem_optin);
    if (instance == qpn::SCREEN_WARP)
        kWarpHost[qpn::screen_ceiling_index(bt.m)]
                 [qpn::screen_ceiling_index(bt.n)](bt);
    else if (instance == qpn::SCREEN_CLUSTER)
        cluster_host(bt, qpn::screen_cluster_ranks(bt.m, bt.n, smem_optin));
    else
        one_block_host(bt, instance == qpn::SCREEN_GLOBAL);
}

// The shared instance with A in the working set at any shape: the tests
// hold the warp instance to its bits.
void qpn_screen_host_generic_f32(QPN_SCREEN_PARAMS) {
    const qpn::ScreenBatch bt = QPN_SCREEN_BATCH;
    if (bt.B <= 0 || bt.m <= 0 || bt.n <= 0) return;
    one_block_host(bt, false);
}

int qpn_screen_instance(int m, int n, long long smem_optin) {
    return qpn::screen_instance(m, n, smem_optin);
}

int qpn_screen_cluster_ranks(int m, int n, long long smem_optin) {
    return qpn::screen_cluster_ranks(m, n, smem_optin);
}

// Bytes of one rank's part of a polyhedron of m rows in dimension n spread
// over `ranks` blocks.
long long qpn_screen_cluster_bytes(int m, int n, int ranks) {
    return (long long)qpn::screen_cluster_bytes(m, n, ranks);
}

}  // extern "C"
