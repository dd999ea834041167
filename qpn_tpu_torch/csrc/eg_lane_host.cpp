// Host instance of the extragradient kernel's lane code (eg_lane.cuh),
// built with plain g++ and loaded with ctypes by the CPU tests: each lane
// runs the step loop as thread 0 of 1 with no-op barriers, every row summed
// by the loop that walks the partition of the kernel that takes this n.
// Not on any production path.

#include <vector>

#include "eg_lane.cuh"

extern "C" {

// The partition is the one the launcher picks from n: the register kernel's
// (kEgGroup, chunk) where an instance takes n, else the generic kernel's one
// chunk of n columns.
void qpn_eg_warmstart_host_f32(QPN_EG_PARAMS) {
    const qpn::EGBatch bt = QPN_EG_BATCH;
    const int chunk = qpn::eg_pick_chunk(bt.n);
    std::vector<float> buf(qpn::eg_lane_bytes(bt.n) / sizeof(float));
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const qpn::EGLane L = qpn::eg_lane_carve(buf.data(), bt.n);
        qpn::eg_lane_load(L, bt, b, 0, 1);
        const float tau = bt.tau[b];
        if (chunk == 0) qpn::eg_lane_run<1>(L, tau, bt.steps, bt.n, 0, 1);
        else qpn::eg_lane_run<qpn::kEgGroup>(L, tau, bt.steps, chunk, 0, 1);
        qpn::eg_lane_store(L, bt, b, 0, 1);
    }
}

int qpn_eg_pick_chunk(int n) { return qpn::eg_pick_chunk(n); }

}  // extern "C"
