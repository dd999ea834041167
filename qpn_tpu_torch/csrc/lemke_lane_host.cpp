// Host instance of the Lemke pivot kernel's lane code (lemke_lane.cuh),
// built with plain g++ and loaded with ctypes by the CPU tests: each lane
// runs the same step functions as a thread block on the card, as thread 0
// of 1 with no-op barriers, on a lane carved by the same lane_carve as both
// of the card's instances.  Not on any production path.

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

// The decision's scans (host bodies), for the tests that hold them against
// numpy.
double qpn_lk_scan_min_f64(const double* v, int n) {
    return qpn::lk_scan_min(v, n, 0, 1);
}

float qpn_lk_scan_min_f32(const float* v, int n) {
    return qpn::lk_scan_min(v, n, 0, 1);
}

int qpn_lk_scan_ties_f64(const double* theta, const int* tag, int n,
                         double thr, int want, int* list, int* first_tagged) {
    return qpn::lk_scan_ties(theta, tag, n, thr, want, list, first_tagged, 0,
                             1);
}

int qpn_lemke_lane_stride(int n) { return qpn::lane_stride(n); }

// The instance the card's launcher picks for a lane (lemke_lane.cuh), and
// the bytes of its working set: the same functions as the CUDA library's.
int qpn_lemke_lane_instance(int n, int itemsize, long long smem_optin) {
    return qpn::lane_instance(n, itemsize, smem_optin);
}

long long qpn_lemke_lane_bytes(int n, int itemsize) {
    return itemsize == 4 ? (long long)qpn::lane_bytes<float>(n)
                         : (long long)qpn::lane_bytes<double>(n);
}

}  // extern "C"
