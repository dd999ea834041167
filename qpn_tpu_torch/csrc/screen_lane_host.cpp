// Host instance of the feasibility screen kernels' lane code
// (screen_lane.cuh), built with plain g++ and loaded with ctypes by the CPU
// tests.  It picks the instance as the card's launcher does, from the shape
// alone: polyhedra that fit a warp run the warp instance's register code with
// the 32 threads as a loop; larger ones run the generic phase functions as
// thread 0 of 1 with no-op barriers, on a working set carved as the shared
// or the global instance carves it.  Not on any production path.

#include <vector>

#include "screen_lane.cuh"

namespace {

using WarpHost = void (*)(const qpn::ScreenBatch&);
const WarpHost kWarpHost[8][8] = QPN_SCREEN_TABLE(qpn::screen_warp_host);

void generic_host(const qpn::ScreenBatch& bt, bool global) {
    std::vector<float> buf(qpn::screen_lane_bytes(bt.m, bt.n, 1)
                           / sizeof(float));
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const qpn::ScreenLane L =
            global ? qpn::screen_lane_carve_global(bt, b, buf.data())
                   : qpn::screen_lane_carve(buf.data(), bt.m, bt.n);
        qpn::screen_lane_load(L, bt, b, 0, 1);
        qpn::screen_lane_run(L, bt.steps, bt.lr, 0, 1);
        qpn::screen_lane_store(L, bt, b, 0, 1);
    }
}

}  // namespace

extern "C" {

// The instance the card's launcher picks under the opt-in limit smem_optin.
void qpn_screen_host_f32(QPN_SCREEN_PARAMS, long long smem_optin) {
    const qpn::ScreenBatch bt = QPN_SCREEN_BATCH;
    if (bt.B <= 0 || bt.m <= 0 || bt.n <= 0) return;
    const int instance = qpn::screen_instance(bt.m, bt.n, smem_optin);
    if (instance == qpn::SCREEN_WARP)
        kWarpHost[qpn::screen_ceiling_index(bt.m)]
                 [qpn::screen_ceiling_index(bt.n)](bt);
    else
        generic_host(bt, instance == qpn::SCREEN_GLOBAL);
}

// The generic instance with A in the working set at any shape: the tests
// hold the warp instance to its bits.
void qpn_screen_host_generic_f32(QPN_SCREEN_PARAMS) {
    const qpn::ScreenBatch bt = QPN_SCREEN_BATCH;
    if (bt.B <= 0 || bt.m <= 0 || bt.n <= 0) return;
    generic_host(bt, false);
}

int qpn_screen_instance(int m, int n, long long smem_optin) {
    return qpn::screen_instance(m, n, smem_optin);
}

}  // extern "C"
