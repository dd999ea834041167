// The barrier of the R blocks of one lane whose ranks live on any SMs (the
// spread global-memory instances of lemke_pivot.cu and eg_warmstart.cu).
//
// A lane's blocks meet at a counter with a generation, two words of a small
// device workspace that the wrapper zeroes (torch.zeros) before the launch:
// bar[0] counts the ranks that have arrived, bar[1] is the generation.
// Only the lane's own blocks meet there, never the whole grid: lanes end
// after different numbers of pivots or steps, so a grid-wide barrier would
// deadlock.  Every rank must be resident while another spins, which the
// cooperative launch guarantees (cluster_launch.cuh::launch_cooperative).
//
// One thread of each block arrives with a release at device scope and
// waits with an acquire load, between two __syncthreads(): the block's
// writes before the barrier are visible to the peers' reads after it.  The
// L1 is not coherent across SMs, so a peer's band or an exchanged vector
// is read correctly only after such an acquire (a volatile spin with no
// fence is not enough).  A rank that waits longer than
// kLaneBarrierNanoseconds of wall time (%globaltimer: a minute, where a
// phase between two barriers takes under a millisecond, and a grid that
// time-slicing takes off the card is off it whole, for milliseconds) stops
// the launch with a trap, so that a lane whose ranks fail to meet ends in
// an error instead of a hung card.  A trap is sticky: it ends the
// process's CUDA context, so every later launch of the process fails too.
// On the host, where the emulation runs the ranks in turn, it is a no-op.
#pragma once

#if defined(__CUDACC__)
#include <cuda/atomic>
#endif

namespace qpn {

constexpr unsigned long long kLaneBarrierNanoseconds = 60000000000ULL;

#if defined(__CUDACC__)
// The card's wall clock in nanoseconds.
__device__ __forceinline__ unsigned long long lane_barrier_now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#endif

// The barrier of the lane's R ranks at `bar`: device code; a no-op on the
// host.
#if defined(__CUDACC__)
__host__ __device__ __forceinline__
#else
inline
#endif
void lane_barrier(unsigned* bar, int R) {
#if defined(__CUDA_ARCH__)
    __syncthreads();
    if (threadIdx.x == 0) {
        cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(bar[0]);
        cuda::atomic_ref<unsigned, cuda::thread_scope_device> gen(bar[1]);
        // this block saw the generation change last time (or did it)
        const unsigned g = gen.load(cuda::std::memory_order_relaxed);
        if (count.fetch_add(1u, cuda::std::memory_order_acq_rel)
            == (unsigned)R - 1u) {
            count.store(0u, cuda::std::memory_order_relaxed);
            gen.store(g + 1u, cuda::std::memory_order_release);
        } else {
            const unsigned long long t0 = lane_barrier_now();
            while (gen.load(cuda::std::memory_order_acquire) == g)
                if (lane_barrier_now() - t0 > kLaneBarrierNanoseconds)
                    __trap();
        }
    }
    __syncthreads();
#endif
    (void)bar;
    (void)R;
}

}  // namespace qpn
