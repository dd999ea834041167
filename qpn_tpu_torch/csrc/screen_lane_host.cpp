// Host instance of the feasibility screen kernel's lane code
// (screen_lane.cuh), built with plain g++ and loaded with ctypes by the CPU
// tests: each polyhedron runs the same phase functions as a thread block on
// the card, as thread 0 of 1 with no-op barriers.  Not on any production
// path.

#include <vector>

#include "screen_lane.cuh"

extern "C" {

void qpn_screen_host_f32(QPN_SCREEN_PARAMS) {
    const qpn::ScreenBatch bt = QPN_SCREEN_BATCH;
    std::vector<float> buf(qpn::screen_lane_bytes(bt.m, bt.n, 1)
                           / sizeof(float));
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const qpn::ScreenLane L = qpn::screen_lane_carve(buf.data(), bt.m,
                                                         bt.n);
        qpn::screen_lane_load(L, bt, b, 0, 1);
        qpn::screen_lane_run(L, bt.steps, bt.lr, 0, 1);
        qpn::screen_lane_store(L, bt, b, 0, 1);
    }
}

}  // extern "C"
