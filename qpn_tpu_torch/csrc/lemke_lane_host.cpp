// Host instance of the Lemke pivot kernel's lane code (lemke_lane.cuh),
// built with plain g++ and loaded with ctypes by the CPU tests: each lane
// runs the same step functions as the card's blocks, as thread 0 of 1 with
// no-op barriers, on a lane carved by the same lane_carve as every
// instance on the card.  A lane of R ranks is R buffers carved as the
// cluster's blocks are, or, for the spread global instance, R bands at
// their stride in one workspace and R own parts, carved as its blocks are
// (lane_carve_spread); each phase runs for rank 0, 1, ..., R-1 in turn
// between the points where the card's ranks meet at their barrier, in the
// loop of the instance emulated (the cluster's fuses C with the next A).  That
// gives the card's bits because between two such points no rank reads what
// another writes (lemke_lane.cuh).  Not on any production path.

#include <vector>

#include "lemke_lane.cuh"

namespace {

// The pivot loop of lemke_lane.cuh::lane_run for the R ranks of one lane.
template <typename T>
void run_ranks(const std::vector<qpn::Lane<T>>& L, T tol, T piv_tol,
               int max_pivots) {
    const qpn::LaneCtl<T>* c = L[0].ctl;     // every rank's scalars alike
    while (c->status == 0 && c->k < max_pivots) {
        for (const auto& r : L) qpn::lane_basic_values(r, 0, 1, true, piv_tol);
        // the ranks' barrier
        for (const auto& r : L) {
            qpn::lane_decide(r, tol, piv_tol, max_pivots, 0, 1);
            if (r.ctl->act == qpn::ACT_PIVOT) qpn::lane_stage(r, max_pivots, 0, 1);
        }
        // the ranks' barrier
        for (const auto& r : L)
            if (r.ctl->act == qpn::ACT_PIVOT) qpn::lane_update(r, 0, 1);
    }
    for (const auto& r : L) {
        qpn::lane_basic_values(r, 0, 1, false, piv_tol);
        if (r.ctl->status == 0) r.ctl->status = qpn::LEMKE_MAX;
    }
}

// The cluster instance's loop, lemke_lane.cuh::lane_run_fused, for the R
// ranks of one lane: B and S, then the pass (C and the next A), each for
// rank 0, 1, ..., R-1 in turn between the barriers.
template <typename T>
void run_ranks_fused(const std::vector<qpn::Lane<T>>& L, T tol, T piv_tol,
                     int max_pivots) {
    const qpn::LaneCtl<T>* c = L[0].ctl;     // every rank's scalars alike
    for (const auto& r : L) qpn::lane_pass(r, 0, 1, piv_tol, false);
    while (c->status == 0 && c->k < max_pivots) {
        // the ranks' barrier
        for (const auto& r : L) {
            qpn::lane_decide<T, true>(r, tol, piv_tol, max_pivots, 0, 1);
            if (r.ctl->act == qpn::ACT_PIVOT) qpn::lane_stage(r, max_pivots, 0, 1);
        }
        // the ranks' barrier
        for (const auto& r : L)
            qpn::lane_pass(r, 0, 1, piv_tol, r.ctl->act == qpn::ACT_PIVOT);
    }
    for (const auto& r : L)
        if (r.ctl->status == 0) r.ctl->status = qpn::LEMKE_MAX;
}

template <typename T>
void run_lanes(const qpn::LemkeBatch<T>& bt, int R, bool spread) {
    const int nb = qpn::lane_band_height(bt.n, R);
    // cluster: rank k's buffer; spread global: rank k's own part, and the
    // lane's bands in `bands`, one stride apart
    const size_t bytes = spread ? qpn::lane_spread_own_bytes<T>(bt.n)
                                : qpn::lane_band_bytes<T>(bt.n, nb);
    // double storage keeps each buffer 8-byte aligned
    const size_t words = bytes / sizeof(double) + 2;
    std::vector<double> buf(words * R);
    std::vector<double> bands(
        spread ? R * qpn::lane_spread_band_bytes<T>(bt.n, nb) / sizeof(double)
               : 0);
    std::vector<unsigned char*> bases(R);
    for (int k = 0; k < R; ++k)
        bases[k] = reinterpret_cast<unsigned char*>(buf.data() + k * words);
    unsigned char* band0 = reinterpret_cast<unsigned char*>(bands.data());
    std::vector<qpn::Lane<T>> L(R);
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        for (int k = 0; k < R; ++k) {
            L[k] = spread ? qpn::lane_carve_spread<T>(
                                bases[k],
                                band0 + k * qpn::lane_spread_band_bytes<T>(
                                                bt.n, nb),
                                bt.n, R, k, nullptr)
                          : qpn::lane_carve<T>(bases[k], bt.n, R, k,
                                               bases.data());
            qpn::lane_load(L[k], bt, b, 0, 1);
        }
        if (spread || R == 1) run_ranks(L, bt.tol, bt.piv_tol, bt.max_pivots);
        else run_ranks_fused(L, bt.tol, bt.piv_tol, bt.max_pivots);
        for (int k = 0; k < R; ++k) qpn::lane_store(L[k], bt, b, 0, 1);
    }
}

}  // namespace

extern "C" {

// ranks: the lane spread over that many ranks (1: one block's lane, as
// the shared instance and the global one at R = 1 run it); spread: carved
// and run as the global instance spreads it (else as a cluster, in the
// cluster instance's fused loop).
void qpn_lemke_pivot_host_f32(QPN_LEMKE_PARAMS(float), int ranks,
                              int spread) {
    run_lanes(QPN_LEMKE_BATCH(float), ranks, spread != 0 && ranks > 1);
}

void qpn_lemke_pivot_host_f64(QPN_LEMKE_PARAMS(double), int ranks,
                              int spread) {
    run_lanes(QPN_LEMKE_BATCH(double), ranks, spread != 0 && ranks > 1);
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
    *first_tagged = n;
    return qpn::lk_scan_ties(theta, tag, n, thr, want, list, 0, 0, n,
                             first_tagged, 0, 1);
}

int qpn_lemke_lane_stride(int n) { return qpn::lane_stride(n); }

// The row stride of the cluster instance's band at R ranks under the
// opt-in limit (the emulation keeps the odd stride: the bits do not
// depend on it).
int qpn_lemke_cluster_stride(int n, int itemsize, int ranks,
                             long long smem_optin) {
    const int nb = qpn::lane_band_height(n, ranks);
    return itemsize == 4 ? qpn::lane_cluster_stride<float>(n, nb, smem_optin)
                         : qpn::lane_cluster_stride<double>(n, nb, smem_optin);
}

// The instance the card's launcher picks for a lane (lemke_lane.cuh), and
// the bytes of its working set: the same functions as the CUDA library's.
int qpn_lemke_lane_instance(int n, int itemsize, long long smem_optin) {
    return qpn::lane_instance(n, itemsize, smem_optin);
}

long long qpn_lemke_lane_bytes(int n, int itemsize) {
    return (long long)qpn::lane_band_bytes_of(n, n, itemsize);
}

// The ranks of the cluster instance for a lane of n (0: it takes none),
// and the bytes of one rank's part when the lane is spread over R ranks.
int qpn_lemke_cluster_ranks(int n, int itemsize, long long smem_optin) {
    return qpn::lane_cluster_ranks(n, itemsize, smem_optin);
}

long long qpn_lemke_band_bytes(int n, int itemsize, int ranks) {
    return (long long)qpn::lane_band_bytes_of(
        n, qpn::lane_band_height(n, ranks), itemsize);
}

// The global instance's ranks for B lanes on a card that holds `resident`
// of its blocks at once, and its workspace a lane at R ranks.
int qpn_lemke_global_ranks(int n, int itemsize, int B, long long resident,
                           long long smem_optin) {
    return qpn::lane_global_ranks(n, itemsize, B, resident, smem_optin);
}

long long qpn_lemke_global_lane_bytes(int n, int itemsize, int ranks) {
    return (long long)qpn::lane_global_lane_bytes(n, itemsize, ranks);
}

long long qpn_lemke_spread_own_bytes(int n, int itemsize) {
    return (long long)qpn::lane_spread_own_bytes_of(n, itemsize);
}

}  // extern "C"
