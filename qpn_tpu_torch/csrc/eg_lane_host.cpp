// Host instance of the extragradient kernel's lane code (eg_lane.cuh),
// built with plain g++ and loaded with ctypes by the CPU tests: each lane
// runs the step loop as thread 0 of 1 with no-op barriers, every row summed
// by the loop that walks the partition of the kernel that takes this n, on
// a lane carved as that kernel carves it.  Not on any production path.

#include <vector>

#include "eg_lane.cuh"

extern "C" {

// The kernel is the one the card's launcher picks from n under the opt-in
// limit `smem_optin` (eg_instance): the register kernel's partition
// (kEgGroup, chunk), else the generic kernel's one chunk of n columns with
// M copied (shared instance) or read in place (global instance).
void qpn_eg_warmstart_host_f32(QPN_EG_PARAMS, long long smem_optin) {
    const qpn::EGBatch bt = QPN_EG_BATCH;
    const int instance = qpn::eg_instance(bt.n, smem_optin);
    const int chunk = qpn::eg_pick_chunk(bt.n);
    std::vector<float> buf(qpn::eg_lane_bytes(bt.n) / sizeof(float));
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const qpn::EGLane L =
            instance == qpn::EG_GLOBAL
                ? qpn::eg_lane_carve_global(bt, b, buf.data())
                : qpn::eg_lane_carve(buf.data(), bt.n);
        qpn::eg_lane_load(L, bt, b, 0, 1);
        const float tau = bt.tau[b];
        if (instance == qpn::EG_REGISTER)
            qpn::eg_lane_run<qpn::kEgGroup>(L, tau, bt.steps, chunk, 0, 1);
        else
            qpn::eg_lane_run<1>(L, tau, bt.steps, bt.n, 0, 1);
        qpn::eg_lane_store(L, bt, b, 0, 1);
    }
}

int qpn_eg_pick_chunk(int n) { return qpn::eg_pick_chunk(n); }

int qpn_eg_instance(int n, long long smem_optin) {
    return qpn::eg_instance(n, smem_optin);
}

}  // extern "C"
