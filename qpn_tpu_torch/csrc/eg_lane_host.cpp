// Host instance of the extragradient kernel's lane code (eg_lane.cuh),
// built with plain g++ and loaded with ctypes by the CPU tests: each lane
// runs the step loop as thread 0 of 1 with no-op barriers, every row summed
// by the loop that walks the partition of the kernel that takes this n, on
// a lane carved in one buffer (the register, block and cluster instances'
// registers hold what this carving holds here: only the order of the sums
// matters for the bits).  A lane of R ranks is R buffers
// carved as the cluster's blocks are, or as the global instance's blocks
// are (each band in its buffer where it fits the limit, else in the lane's
// column-major copy, and the lane's z and z½ in one more buffer, gathered
// by every rank after each barrier), each half-step run for rank 0, 1,
// ..., R-1 in turn: between two of the card's barriers no rank reads what
// another writes (eg_lane.cuh), so that gives the card's bits.  Not on any
// production path.

#include <vector>

#include "eg_lane.cuh"

extern "C" {

// The kernel is the one the card's launcher picks from n under the opt-in
// limit `smem_optin` (eg_instance): the register kernel's partition
// (kEgGroup, chunk); the block and cluster instances' (kEgGroup,
// eg_cluster_chunk(n)), at one rank or spread over the cluster's; else the
// generic kernel's one chunk of n columns (the global instance), spread
// over the ranks that eg_global_ranks picks for B lanes on a card that
// holds `resident` of its blocks at once.  ranks > 0 spreads the lane over
// that many ranks whatever the limit picks (1: one block's lane), in the
// partition of the instance the limit picks.
void qpn_eg_warmstart_host_f32(QPN_EG_PARAMS, long long smem_optin,
                               int ranks, long long resident) {
    const qpn::EGBatch bt = QPN_EG_BATCH;
    const int instance = qpn::eg_instance(bt.n, smem_optin);
    const bool global = instance == qpn::EG_GLOBAL;
    const int G = global ? 1 : qpn::kEgGroup;
    const int C = instance == qpn::EG_REGISTER ? qpn::eg_pick_chunk(bt.n)
                  : global ? bt.n : qpn::eg_cluster_chunk(bt.n);
    int R = ranks;
    if (R <= 0)
        R = instance == qpn::EG_CLUSTER
            ? qpn::eg_cluster_ranks(bt.n, smem_optin)
            : global ? qpn::eg_global_ranks(bt.n, bt.B, resident, smem_optin)
                     : 1;
    const bool copy = !global || qpn::eg_global_band_fits(bt.n, R, smem_optin);
    const size_t words =
        qpn::eg_band_bytes(bt.n, qpn::eg_band_height(bt.n, R)) / sizeof(float);
    std::vector<float> buf(words * R);
    std::vector<float> xg(global && R > 1 ? qpn::eg_exchange_floats(bt.n) : 0);
    std::vector<float> mt(global && !copy ? (size_t)bt.n * bt.n : 0);
    unsigned bar[2] = {0, 0};
    std::vector<float*> bases(R);
    for (int k = 0; k < R; ++k) bases[k] = buf.data() + k * words;
    std::vector<qpn::EGLane> L(R);
    for (size_t b = 0; b < (size_t)bt.B; ++b) {
        for (int k = 0; k < R; ++k) {
            L[k] = global ? qpn::eg_lane_carve_global(
                                bt, b, bases[k], R, k, copy,
                                R > 1 ? xg.data() : nullptr,
                                R > 1 ? bar : nullptr,
                                copy ? nullptr : mt.data())
                          : qpn::eg_lane_carve(bases[k], bt.n, R, k,
                                               bases.data());
            qpn::eg_lane_load(L[k], bt, b, 0, 1);
        }
        const float tau = bt.tau[b];
        for (int s = 0; s < bt.steps; ++s) {
            for (const auto& r : L) {
                if (G == 1) qpn::eg_half_step<1>(r, r.z, r.zh, tau, C, 0, 1);
                else qpn::eg_half_step<qpn::kEgGroup>(r, r.z, r.zh, tau, C, 0, 1);
            }
            // the ranks' barrier
            for (const auto& r : L) qpn::eg_gather(r, r.zh, 0, 1);
            for (const auto& r : L) {
                if (G == 1) qpn::eg_half_step<1>(r, r.zh, r.z, tau, C, 0, 1);
                else qpn::eg_half_step<qpn::kEgGroup>(r, r.zh, r.z, tau, C, 0, 1);
            }
            for (const auto& r : L) qpn::eg_gather(r, r.z, 0, 1);
        }
        for (const auto& r : L) qpn::eg_lane_store(r, bt, b, 0, 1);
    }
}

int qpn_eg_pick_chunk(int n) { return qpn::eg_pick_chunk(n); }

int qpn_eg_instance(int n, long long smem_optin) {
    return qpn::eg_instance(n, smem_optin);
}

int qpn_eg_cluster_ranks(int n, long long smem_optin) {
    return qpn::eg_cluster_ranks(n, smem_optin);
}

int qpn_eg_global_ranks(int n, int B, long long resident,
                        long long smem_optin) {
    return qpn::eg_global_ranks(n, B, resident, smem_optin);
}

int qpn_eg_global_band_fits(int n, int ranks, long long smem_optin) {
    return qpn::eg_global_band_fits(n, ranks, smem_optin);
}

// Bytes of one rank's part of a lane of n spread over R ranks with its band
// of M in shared memory.
long long qpn_eg_band_bytes(int n, int ranks) {
    return (long long)qpn::eg_band_bytes(n, qpn::eg_band_height(n, ranks));
}

// The cluster instance's chunk of a row, and one rank's shared memory at R
// ranks (the part of its band that its threads do not hold in registers).
int qpn_eg_cluster_chunk(int n) { return qpn::eg_cluster_chunk(n); }

long long qpn_eg_cluster_rank_bytes(int n, int ranks) {
    return (long long)qpn::eg_cluster_rank_bytes(
        n, qpn::eg_band_height(n, ranks));
}

int qpn_eg_cluster_reach(int n, long long smem_optin) {
    return qpn::eg_cluster_reach(n, smem_optin);
}

// The block instance's threads and shared memory for a lane of n.
int qpn_eg_block_threads(int n) { return qpn::eg_block_threads(n); }

long long qpn_eg_block_bytes(int n) {
    return (long long)qpn::eg_block_bytes(n);
}

}  // extern "C"
