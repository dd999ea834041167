// Host instance of the Lemke pivot kernel's lane code (lemke_lane.cuh),
// built with plain g++ and loaded with ctypes by the CPU tests: each lane
// runs the same step functions as a thread block on the card, as thread 0
// of 1 with no-op barriers.  Not on any production path.

#include <vector>

#include "lemke_lane.cuh"

namespace {

template <typename T>
void run_lanes(const qpn::LemkeBatch<T>& bt) {
    // double storage keeps the working set 8-byte aligned
    std::vector<double> buf(qpn::lane_bytes<T>(bt.n) / sizeof(double) + 2);
    unsigned char* base = reinterpret_cast<unsigned char*>(buf.data());
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        const qpn::Lane<T> L = qpn::lane_carve<T>(base, bt.n);
        qpn::lane_load(L, bt, b, 0, 1);
        qpn::lane_run(L, 0, 1, bt.tol, bt.piv_tol, bt.max_pivots);
        qpn::lane_store(L, bt, b, 0, 1);
    }
}

}  // namespace

extern "C" {

void qpn_lemke_pivot_host_f32(QPN_LEMKE_PARAMS(float)) {
    run_lanes(QPN_LEMKE_BATCH(float));
}

void qpn_lemke_pivot_host_f64(QPN_LEMKE_PARAMS(double)) {
    run_lanes(QPN_LEMKE_BATCH(double));
}

}  // extern "C"
