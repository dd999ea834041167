// Host instance of the extragradient kernel's lane code (eg_lane.cuh),
// built with plain g++ and loaded with ctypes by the CPU tests: each lane
// runs the same step functions as a thread block on the card, as thread 0
// of 1 with no-op barriers.  Not on any production path.

#include <vector>

#include "eg_lane.cuh"

extern "C" {

void qpn_eg_warmstart_host_f32(QPN_EG_PARAMS) {
    const qpn::EGBatch bt = QPN_EG_BATCH;
    std::vector<float> buf(qpn::eg_lane_bytes(bt.n) / sizeof(float));
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const qpn::EGLane L = qpn::eg_lane_carve(buf.data(), bt.n);
        qpn::eg_lane_load(L, bt, b, 0, 1);
        qpn::eg_lane_run(L, bt.tau[b], bt.steps, 0, 1);
        qpn::eg_lane_store(L, bt, b, 0, 1);
    }
}

}  // extern "C"
