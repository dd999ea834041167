#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qpn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one Hopper card (sm_90a)
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each, with their seconds; any failure exits non-zero:

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: the three CUDA kernels from the sources in this checkout, one
   nvcc for each source, and the native host library
   (``csrc/qpn_host.cpp``, g++), all started together;
3. ensemble: the flagship scenario ensemble (robust_avoid, S=256, T=2,
   num_obj=1, num_poly_faces=4, seed 0; n=38 per lane), moved to the card;
4. the Lemke pivot kernel against its plain PyTorch version in f32 on all
   256 lanes: identical status and pivot counts, f64-refactorized residual
   at most 1e-9, refactorized z equal to 1e-9; median of 7 warm runs each,
   timed with CUDA events;
5. the same for the kernel's f64 instance on 16 lanes (tol 1e-11);
6. the KKT main path, ``ops.avi.solve_kkt_avi_batch(..., tol=1e-8)``: every
   lane certified, the kernel's launch count above 0 (its shared instance;
   none of its cluster or global instance), the natural residual
   re-audited in numpy, z against the port's CPU path on 8 lanes; solves/s
   as the median of 7 warm runs, with the kernel and with the plain loop;
7. the extragradient kernel against its plain PyTorch version on all 256
   lanes from the same prepared f32 inputs, at 300 and 20000 steps: z and
   the natural residual of the unscaled output within the stated bounds,
   the same lanes accepted by the residual audit; the kernel timed as the
   median of 7 runs, the plain loop as the median of 3 at 20000 steps;
8. the generic main path, ``ops.avi.solve_avi_batch_adaptive(...,
   tol=1e-8, mixed=True, onchip_eg_steps=20000)``: every lane certified,
   the extragradient kernel launched, the residual re-audited in numpy, z
   against the KKT path's on all lanes and against the port's CPU path on
   8 lanes; solves/s (median of 7) with the kernels, with the plain
   extragradient loops (the pre-pass and the hybrid stages' hop:
   ``CONFIG.eg_kernel = "torch"``), and with ``mixed=False``;
9. forced stragglers: far starts and one short budget stage on 16 lanes,
   so that ``lemke.lemke_escalate`` takes them and the Lemke kernel's f64
   instance runs on this path; at least one lane certified through it;
10. the feasibility screen kernel against its plain PyTorch version on a
   seeded batch of 4096 polyhedra at robust_avoid's piece shape (dimension
   18, 18 rows, half of them empty by construction, no strict rows): x and
   max |v| within the stated bounds, the same polyhedra witnessed outside
   the margin band, no empty one witnessed; both timed with CUDA events,
   median of 7;
11. the geometry entry point ``geometry.is_empty_batch`` on that batch on
   the port's default device (the card), once with the screen on and once
   off: both
   verdicts equal to each other and to the truth by construction, at least
   one screen kernel launch, the witnessed count, polyhedra/s both ways;
12. ``solve()`` end to end on the default device (the card): the ten zoo
   models of ``benchmarks/framework_bench.py`` and the 8 golden
   simple_bilevel points, each solved, with the QEP and piece counts of
   ``ZOO_r05_cpu.json`` (robust_avoid: 7 QEP, 60 pieces) and x_opt equal to
   a ``device="cpu"`` solve on the same machine; wall time per model both
   ways, the ADMM counters and the kernels' launch counts (the screen's is
   expected to be 0: no zoo model reaches it); then phase 10's comparison
   on the closures of robust_avoid's solution-graph pieces;
13. the shared-matrix route at full width: robust_avoid T=8, num_obj=4,
   num_poly_faces=4, S=1024, seed 0 (n=608 per lane), tol 1e-8, through
   ``solve_kkt_avi_batch`` so that the routing is on the path: every lane
   counted in ``kkt_shared_route`` and certified, the natural residual
   re-audited in numpy, the generic escalation cold; solves/s as the median
   of 3 warm calls, the route's ``stats`` with ``phase_t``, peak device
   memory; the label hash on the card against its host mirror; then the
   route on the flagship ensemble (T=2, one solution) against the KKT
   path's z, and on 8 lanes of the large ensemble on the CPU;
14. the hard seed (seed 2, S=32) of the same model: the ADMM rung runs on
   the card (``shared_kkt_chip_admm_rung`` above 0), every lane certified,
   three repeats identical bit for bit in z, per-lane iterations and rung
   populations;
15. lockstep ensembles through ``parallel.lockstep.solve_many_lockstep`` on
   the card: 16 simple_bilevel scenarios (x0 = [0.1 i, 1, 0, 0], as
   ``benchmarks/scaling_bench.py``) and robust_avoid at the zoo's
   configuration, S=3 (the default init, and the flat init plus
   0.05·N(0,1) from ``default_rng(1)`` and ``(2)``): every scenario solved,
   x_opt within 1e-6 of its serial solve on the card (each timed in the
   phase) with equal piece counts, at least one fused wave, fused ADMM calls
   below the serial sum; walls both ways (the lockstep wall's share in the
   fused engine calls, each serial solve's), waves, ADMM calls and blocks,
   host-LP waves, kernel launches;
16. the banded x-update (``ops/banded.py``) against the dense one in
   ``batch_qp.solve_qp_batch`` on the card (``benchmarks/banded_bench.py``'s
   sweep: B=64, k=6, T = 8..64, median of 3 warm calls each, x within
   1e-6; each T's dense / banded ratio; a route wins a T only when each
   of its calls beats each of the other's by 1.25 times, a smaller edge is
   a tie), the measured crossover (the smallest T from which the banded
   route won to the end of the sweep), which, where there is one, must
   equal the shipped ``config.banded_min_blocks()`` on the card, and one
   call of
   ``solve_qp_batch_padded`` through the automatic route switched on
   (``banded_route`` counts its lanes);
17. ``solve(robust_avoid, checkpoint_path=...)`` on the card, then
   ``load_state`` and ``resume``: x_opt and pieces equal to phase 12's; and
   ``parallel.procpool.map_processes`` from this CUDA parent (spawned
   workers, which take the card from the parent's CONFIG): identical
   results, conv 1.0, the checksum within 1e-9 of the same job in this
   process.
18. the multi-device layer (``parallel/``, ``entry.py``): (a) one rank of
   a ``torch.distributed`` group over NCCL on the card runs
   ``equilibrium_superstep`` on the flagship ensemble (tol 1e-8): z and the
   residuals identical bit for bit to ``solve_avi_batch``'s, the keep mask
   to a numpy prune's; and ``solve_kkt_avi_shared(mesh=)`` on phase 13's
   ensemble, identical to phase 13's result; (b)
   ``entry.dryrun_multichip(2)``, two spawned gloo ranks on the one card,
   with the flagship superstep: z within 1e-10 of (a), convergence and keep
   equal; the 8192+64-piece dedup at n − n//4 pieces with at least one ring
   wave; the three lockstep scenarios within 1e-6 of their serial solves on
   the card with equal pieces.  Each stage's seconds and the bytes its
   collectives sent are printed.
19. ``solve()`` on the six registered models outside the zoo
   (robust_constrained, bilevel_escape from two starts, simple_network in
   its three versions, repeated_variable_control, control_avoid,
   interpolation_avoid; ``tests/test_models.py``'s kwargs) on the card and
   with ``device="cpu"``: the QEP and piece counts and ``solved`` of
   ``REST`` on both devices (simple_network v2 ends in a reported failure
   on both), x_opt within 1e-6 between the devices, each model's analytic
   check from ``tests/test_models.py``, host LPs counted on the card
   wherever the CPU solve runs them (the native library answered them);
   the native library's path, which must lie under ``build/qpn_tpu_torch/``,
   each model's wall on both devices and the kernels' launches.
20. the kernels' whole domain: lanes past a block's shared memory run in
   the kernels' cluster instances (the lane spread over the shared memory
   of a cluster of 2-8 blocks) and past that in their global-memory
   instances.  (a)
   robust_avoid S=256 at T=4 and T=5 with num_obj=2 (n=152, 190;
   num_poly_faces=4, seed 0) through ``solve_kkt_avi_batch(tol=1e-8)``:
   every lane certified, 0 uncertified, the numpy re-audit, at least one
   launch of K1's cluster instance a call and none of the others; the same
   calls with the plain loop on the card: equal pivots and certification
   on all lanes; K1 against the plain loop from one f32 setup on all 256
   lanes (status and pivots identical, the refactorized residual and z as
   in phase 4), solves/s both ways; (b) phase 9's forced stragglers at
   n=152: ``lemke_escalate`` in K1's cluster f64 instance, and K1 f64
   against the plain loop on 16 lanes; (c) the generic route at T=8,
   num_obj=2 (n=304, S=256) with the EG pre-pass of phase 8, which runs in
   K2's cluster instance and no other: every lane certified, the numpy
   re-audit, its wall warm, then K2 against the plain loop at 300 and
   20000 steps as in phase 7; (d) ``is_empty_batch`` with the screen on for
   4 seeded polyhedra of 260 rows in dimension 240 (no strict rows, centred
   on the origin, every second one empty): the verdicts the truth, at least
   one launch of K3's cluster instance and none of its others; then on 4
   such polyhedra centred off the origin (phase 10's centre), where x
   moves on every one: the kernel's x and max |v| equal to the g++
   emulation of its ranks bit for bit, K3 against the plain loop as in
   phase 10, and the A/B on those 4 and on 128: the cluster instance
   against the global instance through the private launcher, equal bit
   for bit, both timed (median of 7 launches between CUDA events), the
   ratio and the ranks printed; then past the cluster's reach, 520 rows in
   dimension 500: ``is_empty_batch`` on 4 nonempty polyhedra that contain
   the screen's start (witnessed, no host LP) with one launch of K3's
   global instance and none of its others, and that instance against its
   host bits and the plain loop on 4 polyhedra centred off the origin,
   every second one empty; each K3 line prints the chain floor of its
   shape; (e) each instance on 8 lanes against the bits of its g++ host
   build (K1 f32 at n=190 and f64 at n=152 and K2 at n=304 and 300 steps,
   emulating the cluster's ranks); (f) the A/B in
   this run: K1's and K2's global instances through the wrappers' private
   launchers at the cluster instances' shapes (K1 f32 S=256 n=190, f64 16
   lanes n=152; K2 n=304, 20000 steps), K1 equal to the cluster instance
   bit for bit, K2 within 1e-4 of the lane scale (its cluster instance
   sums a row in four chunks joined by a butterfly, the global one in
   one), both timed (median of 7 launches between CUDA events; K2 of 3),
   the ratio printed; the cluster instances' lines also print their
   share of the bound and their computed floors (K1: the band read and
   written once a pivot from shared memory; K2: the f32 issue of its
   multiplies and adds, the chain of a row's dependent adds, and the first
   design's band streamed from shared memory every half-step); (g) phase 9's forced stragglers at n=304, whose
   f64 re-pivot lanes are past K1's cluster reach: ``lemke_escalate`` in
   K1's global instance, at least one launch spread over R > 1 blocks a
   lane (the ranks printed), then that instance against the plain loop on
   the 16 lanes (f64 at n=304, as in (b)), and its A/B: the ranks the
   wrapper picks for 16 lanes against R = 1 through the private launcher,
   equal bit for bit and to the g++ emulation of those ranks on 4 lanes,
   both timed (median of 3), the ratio printed; (h) the generic route at
   T=18, num_obj=2 (n=684), past K2's cluster reach, on the ensemble's
   whole batch (S=256): its EG pre-pass in K2's global instance and no
   other, one block a lane (R = 1: the lanes fill the card) reading M from
   its column-major copy, every lane certified, the numpy re-audit, its
   bits at 300 steps against the g++ emulation of one block a lane on 4
   lanes, then that instance against the plain loop on the 256 lanes at
   300 and 20000 steps, as in phase 7, beside the floor of streaming M
   from device memory every half-step; then the route on 4 of its lanes,
   at least one launch spread over R > 1 blocks a lane (the ranks
   printed), and its A/B at 20000 steps as (g)'s (the emulation at 300
   steps); a spread grid too large to be resident at once raises for both
   kernels with the cooperative launch's own refusal, and the next launch
   runs.
21. the hybrid solver's extragradient hop kernel (``ops/hop_cuda.py``) on
   the first hop of ``solve_avi_batch`` over the flagship ensemble (all 256
   lanes, 60 steps), in f32 and in f64: z, ‖Φ‖ of the best merit and of
   the best z's merit within ``HOP_TOL`` of the lane scale against the
   plain loop ``avi._eg_phase``, each of its instances through the private
   launcher equal to its g++ build's bits on 8 lanes, the kernel and the
   plain loop timed (median of 7 between CUDA events, and the device's busy
   time of one call from ``torch.profiler``), the bound; then the
   generic route on the 32 pool ensembles of the benchmark cell
   ``ra_T2o1.generic_s256`` (``qpnbench/``): every lane certified, one hop
   kernel launch for every round run and every hop lane fused, the pass
   over the pool timed with the kernel and with the plain hop (median of
   3 passes).

Then one JSON line for the kernels, a row for each instance (K1, K2 and
K3: shared, register or warp, cluster, global; the hop kernel in f32 and
f64): launches
on the main paths, error against the plain version, the kernel's, the plain
version's and the bound's milliseconds: the larger of the bytes each call
must move over 3.35 TB/s and its operations over the rate of their type
outside the tensor cores (f32 67 TFLOP/s; 34 for K1's global row, whose
lanes are f64), counted from this run's shapes, steps and pivots.  K3's
comparison lines (not the JSON line) also print the chain floor of their
shape: the dependent adds of its fixed order of sums, (steps + 1)·n +
steps·m, at 4 cycles an add and the card's largest SM clock, a yardstick
computed, not measured.
The global rows of K1 and K2 count their launches on (g) and on (h)'s
whole batch and take their error, times and bound from the comparisons at
those shapes, at the ranks the wrappers pick (K1 R = 8, K2 R = 1); the
A/B's times, the spread and R = 1 on the few lanes among them, are printed
on its own lines.  K3's cluster row counts its launches on (d)'s
``is_empty_batch`` at 260 x 240, its global row on the one at 520 x 500,
and each takes its error, times and bound from the comparison at its
shape.
Then the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
S, T_STEPS, NUM_OBJ, FACES, SEED = 256, 2, 1, 4, 0
HOT = dict(tol=1e-6, piv_tol=1e-5, max_pivots=1024)     # avi.py f32 route
F64 = dict(tol=1e-11, piv_tol=1e-11, max_pivots=1024)   # straggler re-pivot
RESID_TOL = 1e-9      # refactorized natural residual of every pivot outcome
Z_TOL = 1e-9          # kernel vs plain, refactorized z (f64)
SOLVE_TOL = 1e-8      # the main path's certification tolerance
REPEATS = 7
EG_STEPS = 20000      # the generic path's extragradient pre-pass
# Kernel vs plain extragradient loop, relative to the lane's scale (z) or to
# 1 + the plain residual.  Both step in f32 and differ only in the order of
# each matvec's sum, a few ulps per step; the iteration contracts, so the
# difference stays near 1e-6 of the scale over 300 steps.  Over 20000 steps
# of a slowly contracting lane those differences are amplified: 5e-6 was
# measured on the flagship lanes, and the bound leaves 20 times that.
EG_TOL = {300: 1e-5, EG_STEPS: 1e-4}
KKT_Z_TOL = 1e-6      # generic path vs KKT path: the solution is unique
FAR_START = 1e4       # forced stragglers: z0 = FAR_START * N(0, 1)
# Feasibility screen: robust_avoid's piece shape, the JAX package's steps,
# step size and is_empty_batch's margin (its tol).
SCREEN_B, SCREEN_M, SCREEN_N = 4096, 18, 18
SCREEN_STEPS, SCREEN_LR, SCREEN_MARGIN = 120, 0.05, 1e-4
# Kernel vs plain screen, relative to 1 + the polyhedron's max |x| (x) or
# 1 + the plain max |v| (v).  Both step in f32 and differ only in the order
# and fusing of each sum (the kernel sums in order without FMA, cuBLAS
# does neither), a few ulps per step; the steps contract toward the
# polyhedron, so 120 of them keep the difference near 1e-6.  A polyhedron
# may be witnessed by one engine only where a max |v| lies within the band
# of the margin.
SCREEN_TOL = 1e-4
# The zoo of benchmarks/framework_bench.py with ZOO_r05_cpu.json's counts:
# (name, setup kwargs, x_init, QEP solves, pieces projected).
ZOO = [
    ("simple_bilevel", dict(gen_solution_map=True), [0.0, 1.0, 0.0, 0.0],
     1, 4),
    ("shepherd_sheep", dict(), None, 1, 2),
    ("toll_setting", dict(), None, 2, 2),
    ("rock_paper_scissors", dict(bilevel=True), None, 0, 1),
    ("trilevel_escape", dict(), None, 3, 5),
    ("four_player_matrix_game", dict(edge_list=[(1, 2), (3, 4)], seed=2),
     [0.0] * 8, 2, 4),
    ("robust_avoid_simple", dict(num_obj=1), None, 9, 58),
    ("chainstore", dict(num_towns=3), None, 0, 7),
    ("deep_synthetic", dict(levels=8, width=1), None, 0, 7),
    ("robust_avoid", dict(T=2, num_obj=1, num_poly_faces=3), None, 7, 60),
]
# tests/test_simple_bilevel.py (the reference's test/simple_bilevel.jl):
# parameter point w, the admissible follower responses, min piece count
R2 = 2.0 ** 0.5
GOLDEN = [
    ([-2.0, -3.0], [[-2.0, 0.0]], 1), ([0.0, -1.0], [[0.0, 0.0]], 2),
    ([1.0, -3.0], [[0.0, 0.0]], 1), ([1.0, -1.0], [[0.0, 0.0]], 2),
    ([1.0, 0.0], [[0.5, 0.5]], 1), ([0.0, 1.0], [[0.5, 0.5], [0.0, 0.0]], 1),
    ([-1.0, 1 + R2], [[-1.0, 0.0], [R2 / 2, R2 / 2]], 1),
    ([0.0, 0.0], [[0.0, 0.0]], 3),
]
X_OPT_TOL = 1e-6      # solve() on the card vs on the CPU, same machine
# The six registered models outside the zoo at tests/test_models.py's kwargs
# and starts, with the counts both packages give on the CPU
# (tests/test_torch_models_rest.py): (row, model, setup kwargs, x_init,
# QEP solves, pieces projected, solved).
REST = [
    ("robust_constrained", "robust_constrained", dict(T=2, num_obj=1), None,
     1, 0, True),
    ("bilevel_escape_far", "bilevel_escape", dict(), [2.0, 0.0, 1.0, 0.0],
     0, 1, True),
    ("bilevel_escape_origin", "bilevel_escape", dict(), [0.0] * 4, 0, 1,
     True),
    ("simple_network_v1", "simple_network", dict(edge_version=1), None,
     0, 2, True),
    ("simple_network_v2", "simple_network", dict(edge_version=2), None,
     11, 7, False),
    ("simple_network_v3", "simple_network", dict(edge_version=3), None,
     1, 6, True),
    ("repeated_variable_control", "repeated_variable_control", dict(), None,
     1, 3, True),
    ("control_avoid", "control_avoid", dict(T=2, num_obj=1), None, 2, 4,
     True),
    ("interpolation_avoid", "interpolation_avoid", dict(T=1, num_samples=3),
     None, 3, 11, True),
]
# K1 launches of each REST row's solve on the card; K2 and K3 launch in none.
# simple_network v2's failing QEP solves escalate through lemke_escalate:
# 36 calls of lemke.solve_lemke_batch_padded, one f64 launch each (the same
# 36 calls on the CPU run the plain loop).
REST_K1_LAUNCHES = {"simple_network_v2": 36}
# K1 against the plain loop on phase 19's escalation calls (f64, refactorized
# z), relative to max(1, max |z|): these rays reach |z| ~ 2e10.
ESCALATION_Z_RTOL = 1e-10
# The shared-matrix route's design scale (the JAX package's bench row) and
# its hard seed.
LARGE = dict(num_scenarios=1024, T=8, num_obj=4, num_poly_faces=4, seed=0)
HARD = dict(num_scenarios=32, T=8, num_obj=4, num_poly_faces=4, seed=2)
# Phase 20: the ensembles between the flagship and the shared route, whose
# lanes pass a block's shared memory (T, num_obj; n = 152 and 190 per lane),
# the generic route's row for K2's global instance (n = 304), and the
# polyhedra for K3's (rows, dimension); the lanes held to the host bits.
MIDSIZE = [(4, 2), (5, 2)]
MIDSIZE_GENERIC = (8, 2)
# (h): the generic route past K2's cluster reach (S, T, num_obj; n = 684)
# on the ensemble's whole batch, and on a few of its lanes, which K2's
# global instance spreads over many SMs
LARGE_GENERIC = (256, 18, 2)
LARGE_GENERIC_FEW = 4
DOMAIN_SCREEN_B, DOMAIN_SCREEN_M, DOMAIN_SCREEN_N = 4, 260, 240
# (d): the A/B's larger batch (3 waves of clusters of 3 on an H100), and
# the polyhedra past K3's cluster reach (rows, dimension)
SCREEN_AB_B = 128
SCREEN_GLOBAL_MN = (520, 500)
HOST_BIT_LANES = 8
# Timed calls of phase 20 (the plain loops take 1-3 s a call there).
DOMAIN_REPEATS = 3
# (g)'s and (h)'s spread global lanes held to their g++ emulation
SPREAD_HOST_LANES = 4
# blocks a lane that no card holds at once for (g)'s and (h)'s lanes
REFUSED_RANKS = 4096
# cudaGetErrorString(cudaErrorCooperativeLaunchTooLarge)
COOPERATIVE_REFUSAL = "too many blocks in cooperative launch"
# Phase 16: a route wins a block count only when each of its calls beats
# each of the other's by this factor; a smaller edge is a tie, which keeps
# the shipped value (the two routes tie at T=64 on some machines).
BANDED_MARGIN = 1.25
# Phase 21: the hop kernel against avi._eg_phase, relative to the lane's
# scale (z, and ||Phi|| of the best merit): the same arithmetic on the same
# values in another order of sums (tests/test_torch_hop.py's bounds), and
# the benchmark cell whose pool the route runs.
HOP_STEPS = 60
HOP_TOL = {"torch.float32": 1e-5, "torch.float64": 1e-12}
HOP_CELL = "ra_T2o1.generic_s256"
SHARED_Z_TOL = 1e-8   # shared route vs KKT path at T=2: one solution
SHARED_RUNGS = ("shared_kkt_chip_admm_rung", "shared_kkt_admm_escalation",
                "shared_kkt_generic_escalation")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: float, flops: float, f64: bool = False):
    """(least ms the card could take, which resource sets it, bytes, flops):
    every input read once and every output written once over the memory
    rate, against the operations over the rate of their type outside the
    tensor cores (what these kernels can use): f32, or f64 for K1's f64
    tier."""
    from qpn_tpu_torch.utils.flops import (H100_HBM_BYTES_S, H100_PEAK_F32,
                                           H100_PEAK_F64)
    peak = H100_PEAK_F64 if f64 else H100_PEAK_F32
    t_b, t_f = nbytes / H100_HBM_BYTES_S, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations",
            nbytes, flops)


def lemke_bound(init, res):
    """K1: the tableau and the lane vectors in, the basis and values out; an
    iteration's basic values are 2·n·(3n+1) operations and its rank-1
    update 2·n·(3n+2), times the iterations these lanes took."""
    n = init.T.shape[1]
    iters = float((res.piv.double() + 1).sum())
    return bound(tensor_bytes(*init) + tensor_bytes(*res),
                 iters * (2 * n * (3 * n + 1) + 2 * n * (3 * n + 2)),
                 f64=init.T.dtype.itemsize == 8)


def eg_bound(ins, out, steps):
    """K2: M and the lane vectors in, z out; a half-step is n rows of n
    multiply-adds plus 5 operations (add q, scale, subtract, two clips)."""
    B, n = out.shape
    return bound(tensor_bytes(*ins, out), B * steps * 2.0 * (2 * n * n + 5 * n))


def hop_bound(ins, outs, steps):
    """The hop kernel: M and the lane vectors in, z, best z and best merit
    out; a phase is n rows of n multiply-adds, 2·steps + 1 of them, and a
    merit's n squares and adds a step and one more at the end (the
    elementwise work left out)."""
    B, n = ins[5].shape
    return bound(tensor_bytes(*ins, *outs),
                 B * ((2.0 * steps + 1) * 2 * n * n + (steps + 1) * 2 * n),
                 ins[5].dtype.itemsize == 8)


def screen_bound(ins, outs, steps):
    """K3: A, l, u, x0 in, x and max |v| out; a step is A x and Aᵀ v (2·m·n
    operations each), the violation (4 per row) and the update (2 per
    variable); one more violation at the end."""
    B, m, n = ins[0].shape
    return bound(tensor_bytes(*ins, *outs),
                 B * (steps * (4.0 * m * n + 4 * m + 2 * n) + 2 * m * n + 4 * m))


def screen_chain_floor(m, n, steps):
    """K3's chain floor: each step sums n, then m, products one after the
    other in a fixed order (phase 1, phase 2), and one more phase 1 ends
    the run.  Returns (dependent adds, ms at 4 cycles an f32 add and the
    card's largest SM clock)."""
    adds = (steps + 1) * n + steps * m
    return adds, adds * 4 / (card_max_sm_mhz() * 1e6) * 1e3


# The SM's shared memory serves 128 bytes a cycle; an f32 add waits 4
# cycles for the one before (assumed, as K3's chain floor).
SMEM_BYTES_CYCLE = 128
ADD_CYCLES = 4


def cycles_ms(cycles):
    """Milliseconds of ``cycles`` at the card's largest SM clock."""
    return cycles / (card_max_sm_mhz() * 1e6) * 1e3


def cluster_waves(lanes, ranks):
    """Rounds of clusters of ``ranks`` blocks, one an SM, for ``lanes``."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-lanes // max(1, sms // ranks))


def k2_cluster_floors(n, ranks, lanes, steps):
    """K2's cluster instance, computed from the shape (not measured), ms:
    (issue: a rank's 2·nb·4C multiplies and adds a half-step, two
    instructions each with -fmad=false, on an SM's 128 f32 lanes; chain:
    the C + 2 dependent adds of a row a half-step; the first design's floor
    of streaming the band from shared memory every half-step), over the
    waves of clusters the batch takes."""
    from qpn_tpu_torch.ops import eg_cuda
    C = eg_cuda.host_cluster_chunk(n)
    nb = -(-n // ranks)
    half = 2 * steps * cluster_waves(lanes, ranks)
    return (cycles_ms(half * 2 * nb * 4 * C / 128),
            cycles_ms(half * (C + 2) * ADD_CYCLES),
            cycles_ms(half * nb * n * 4 / SMEM_BYTES_CYCLE))


def k1_cluster_floor(n, itemsize, pivots, ranks):
    """K1's cluster instance, computed (ms): each rank's band read and
    written once a pivot from shared memory, over the waves of clusters,
    each as long as its slowest lane's ``pivots``."""
    import torch
    nb = -(-n // ranks)
    per_pivot = 2 * nb * (3 * n + 2) * itemsize / SMEM_BYTES_CYCLE
    piv = pivots.double() + 1
    B = piv.shape[0]
    per = max(1, torch.cuda.get_device_properties(0).multi_processor_count
              // ranks)
    rounds = sum(float(piv[i:i + per].max()) for i in range(0, B, per))
    return cycles_ms(rounds * per_pivot)


_MAX_SM_MHZ = []


def card_max_sm_mhz() -> float:
    """The card's largest SM clock in MHz (``nvidia-smi``), read once."""
    if not _MAX_SM_MHZ:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        if smi.returncode != 0:
            fail(f"nvidia-smi clocks.max.sm: {smi.stderr.strip()}")
        _MAX_SM_MHZ.append(float(smi.stdout.split()[0]))
    return _MAX_SM_MHZ[0]


def kernel_row(name, source, replaces, launches, err, t_k, t_p, bnd):
    """One entry of the kernels line.  No single PyTorch call computes any of
    these loops (a data-dependent pivot path, thousands of dependent
    steps), so library_ms is null."""
    ms, by, nbytes, flops = bnd
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t_k * 1e3, "plain_ms": t_p * 1e3, "bound_ms": ms,
            "bound_by": by, "share_of_bound": ms / (t_k * 1e3),
            "bound_bytes": nbytes, "bound_operations": flops,
            "library_ms": None}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_all(fn, device, repeats=REPEATS):
    """Wall seconds of each of ``repeats`` warm calls (one warm-up first),
    host clock around work that ends in a device synchronize."""
    fn()
    _sync(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times


def timed(fn, device, repeats=REPEATS):
    """Median of :func:`timed_all`."""
    return statistics.median(timed_all(fn, device, repeats))


def device_timed(fn, device, repeats=REPEATS):
    """Median seconds of ``repeats`` warm calls (one warm-up first) between
    CUDA events recorded on the current stream around each call."""
    import torch
    if device.type != "cuda":
        return timed(fn, device, repeats)
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def busy_seconds(fn, device):
    """Seconds of device activity of one warm call of ``fn``: the sum of
    the self device times of its kernels and copies in ``torch.profiler``'s
    trace (gaps between them left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    us = 0.0
    for e in prof.key_averages():
        us += getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
    return us * 1e-6


def timed_build(build):
    t0 = time.perf_counter()
    build()
    return time.perf_counter() - t0


def compare_engines(data, lanes, dtype, kw, kernel, device,
                    repeats=REPEATS):
    """Kernel vs plain pivot loop on the same setup: status and pivot counts
    equal on every lane, refactorized residual and z within tolerance.
    Returns (max |z_kernel - z_plain|, kernel s, plain s, kernel result,
    the bound of that launch)."""
    import torch
    from qpn_tpu_torch.ops import lemke
    from qpn_tpu_torch.ops.avi import natural_residual
    M, q, l, u = (data[k][:lanes] for k in ("M", "q", "l", "u"))
    vm = data["mask"][:lanes]
    init = lemke.lemke_setup(M.to(dtype), q.to(dtype), l.to(dtype),
                             u.to(dtype), torch.zeros_like(q, dtype=dtype),
                             vm, tol=kw["tol"])
    outs = {}
    for name, engine in (("kernel", kernel),
                         ("plain", lemke.lemke_pivot_torch)):
        res = engine(init, **kw)
        z, ok = lemke.refactor_batch(M, q, l, u, res.basis, res.val, vm)
        r = natural_residual(M, q, l, u, z, vm)
        if not bool(ok.all()) or not float(r.max()) <= RESID_TOL:
            fail(f"{name} {dtype}: refactorization ok on {int(ok.sum())}/"
                 f"{lanes} lanes, max residual {float(r.max())!r}")
        outs[name] = (res, z)
    (rk, zk), (rp, zp) = outs["kernel"], outs["plain"]
    if not torch.equal(rk.status, rp.status):
        bad = int((rk.status != rp.status).sum())
        fail(f"{dtype}: status differs on {bad} lanes")
    if not torch.equal(rk.piv, rp.piv):
        bad = int((rk.piv != rp.piv).sum())
        fail(f"{dtype}: pivot counts differ on {bad} lanes")
    err = float((zk - zp).abs().max())
    if not err <= Z_TOL:
        fail(f"{dtype}: refactorized z differs by {err!r}")
    t_k = device_timed(lambda: kernel(init, **kw), device, repeats)
    t_p = device_timed(lambda: lemke.lemke_pivot_torch(init, **kw), device,
                       repeats)
    return err, t_k, t_p, rk, lemke_bound(init, rk)


class Clock:
    """Prints a phase's line with the seconds since the previous one."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, msg: str) -> None:
        now = time.perf_counter()
        print(f"{msg} ({now - self.t:.1f} s)", flush=True)
        self.t = now


KEYS = ("M", "q", "l", "u", "z0", "mask")


def numpy_audit(batch, z, lanes=None):
    """Natural residual Φ(z) = z − clip(z − (Mz+q), l, u) on the host in
    numpy, f64, per lane."""
    import numpy as np
    M, q, l, u = (batch[k] if lanes is None else batch[k][:lanes]
                  for k in ("M", "q", "l", "u"))
    F = np.einsum("bij,bj->bi", M, z) + q
    return np.abs(z - np.clip(z - F, l, u)).max(axis=1)


def compare_eg(data, device, say, card, repeats=REPEATS):
    """Kernel vs plain extragradient loop on all lanes from the same
    prepared inputs, at 300 and EG_STEPS steps, the kernel timed as the
    median of ``repeats`` runs (the plain loop at EG_STEPS of at most 3).
    Returns (max |dz| at EG_STEPS, kernel s, plain s, the bound of that
    launch)."""
    import torch
    from qpn_tpu_torch.ops import eg, eg_cuda
    from qpn_tpu_torch.ops.avi import natural_residual
    p = eg.eg_prepare(*(data[k] for k in KEYS))
    M, q, l, u, z0, vm = (data[k] for k in KEYS)
    r0 = natural_residual(M, q, l, u, z0, vm)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    for steps, tol in EG_TOL.items():
        zk = eg_cuda.eg_warmstart_cuda(*ins, steps)
        zp = eg.eg_steps_torch(*ins, steps)
        torch.cuda.synchronize(device)
        dz = (zk - zp).abs().amax(1)
        err = float((dz / (1.0 + zp.abs().amax(1))).max())
        res = [natural_residual(M, q, l, u, torch.where(vm, z.double() * p.e,
                                                        0.0), vm)
               for z in (zk, zp)]
        rk, rp = res
        rerr = float(((rk - rp).abs() / (1.0 + rp)).max())
        if not (err <= tol and rerr <= tol):
            fail(f"eg_warmstart {steps} steps: z differs by {err!r}, "
                 f"residual by {rerr!r} (relative), bound {tol}")
        acc = [torch.isfinite(r) & (r < r0) for r in res]
        near = ((rk - r0).abs() <= tol * (1.0 + r0)) | \
            ((rp - r0).abs() <= tol * (1.0 + r0))
        if bool(((acc[0] != acc[1]) & ~near).any()):
            fail(f"eg_warmstart {steps} steps: the residual audit accepts "
                 "other lanes for the kernel than for the plain loop")
        plain_repeats = repeats if steps < EG_STEPS else min(3, repeats)
        t_k = device_timed(lambda: eg_cuda.eg_warmstart_cuda(*ins, steps),
                           device, repeats)
        t_p = device_timed(lambda: eg.eg_steps_torch(*ins, steps), device,
                           plain_repeats)
        max_abs = float(dz.max())
        say(f"eg_warmstart B={p.M.shape[0]} n={p.M.shape[1]} steps={steps}: "
            f"max |dz| {max_abs:.3g} ({err:.3g} of the lane scale), residual "
            f"{rerr:.3g} relative, both <= {tol}; accepted lanes "
            f"{int(acc[0].sum())} kernel, {int(acc[1].sum())} plain; median "
            f"residual {float(r0.median()):.3g} -> {float(rk.median()):.3g}; "
            f"kernel {t_k * 1e3:.4f} ms (median of {repeats}), plain "
            f"{t_p * 1e3:.4f} ms (median of {plain_repeats}) [{card}]")
    return max_abs, t_k, t_p, eg_bound(ins, zk, EG_STEPS)


def generic_path(data, batch, device, z_kkt, say, card):
    """The generic route on the flagship ensemble, as the JAX package's
    accelerator configuration runs it.  Returns the extragradient kernel's
    launches in that run."""
    import numpy as np
    import torch
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.ops import eg_cuda, lemke_cuda
    from qpn_tpu_torch.ops.avi import batch_from_numpy, solve_avi_batch_adaptive
    from qpn_tpu_torch.utils.metrics import METRICS
    args = [data[k] for k in KEYS]
    kw = dict(tol=SOLVE_TOL, mixed=True, onchip_eg_steps=EG_STEPS)
    B = args[1].shape[0]
    METRICS.reset()
    res = solve_avi_batch_adaptive(*args, **kw)
    torch.cuda.synchronize(device)
    launches = METRICS.launches[eg_cuda.KERNEL]
    pivots = METRICS.launches[lemke_cuda.KERNEL]
    hops = METRICS.launches["hybrid_hop"]
    accepted = int(METRICS.counters["eg_accepted_lanes"])
    escalated = int(METRICS.counters["escalated_lanes"])
    if launches < 1:
        fail("the generic path did not launch the eg_warmstart kernel")
    z = res.z.cpu().numpy()
    conv = float(res.converged.double().mean())
    if z.shape != tuple(args[1].shape) or not np.isfinite(z).all():
        fail(f"generic path: z has shape {z.shape} or non-finite values")
    if conv != 1.0:
        fail(f"generic path: conv {conv}")
    resid = numpy_audit(batch, z)
    if not resid.max() <= SOLVE_TOL:
        fail(f"generic path, numpy audit: max natural residual "
             f"{resid.max()!r}")
    dk = float((res.z - z_kkt).abs().max())
    if not dk <= KKT_Z_TOL:
        fail(f"generic path: z differs from the KKT path's by {dk!r}")
    it = res.iters.double()
    t_kernel = timed(lambda: solve_avi_batch_adaptive(*args, **kw), device)
    CONFIG.eg_kernel = "torch"
    try:
        t_plain = timed(lambda: solve_avi_batch_adaptive(*args, **kw), device)
    finally:
        CONFIG.eg_kernel = "auto"
    t_f64 = timed(lambda: solve_avi_batch_adaptive(
        *args, **dict(kw, mixed=False)), device)
    # small-input reference, after the timings: the port's CPU path
    cpu = batch_from_numpy({k: v[:8] for k, v in batch.items()
                            if k in KEYS}, "cpu")
    ref = solve_avi_batch_adaptive(*(cpu[k] for k in KEYS), **kw)
    dc = float(np.abs(ref.z.numpy() - z[:8]).max())
    if not (bool(ref.converged.all()) and dc <= KKT_Z_TOL):
        fail(f"generic path: CPU reference conv {ref.converged.tolist()}, "
             f"max |dz| {dc!r}")
    say(f"generic path solve_avi_batch_adaptive S={B} tol={SOLVE_TOL} "
        f"mixed=True onchip_eg_steps={EG_STEPS}: conv {conv}, max resid "
        f"{resid.max():.3g}, {launches} eg kernel launch(es), {hops} hop "
        f"kernel launch(es), EG accepted on "
        f"{accepted}/{B} lanes, {escalated} escalated ({pivots} pivot kernel "
        f"launches), iters median {float(it.median()):.0f} max "
        f"{int(it.max())}; z within {dk:.3g} of the KKT path, within "
        f"{dc:.3g} of the CPU path on 8 lanes; {B / t_kernel:.1f} solves/s "
        f"with the kernels ({t_kernel * 1e3:.3f} ms), {B / t_plain:.1f} with "
        f"the plain EG loops ({t_plain * 1e3:.3f} ms), {B / t_f64:.1f} with "
        f"mixed=False ({t_f64 * 1e3:.3f} ms); median of {REPEATS} [{card}]")
    return launches


def forced_stragglers(data, batch, device, say, card, lanes=16,
                      kernel="lemke_pivot"):
    """Far starts and one short budget stage leave the lanes to
    lemke_escalate, whose f64 pivot loop runs in the Lemke kernel's
    instance ``kernel`` (its launch count's name)."""
    import numpy as np
    import torch
    from qpn_tpu_torch.ops.avi import solve_avi_batch_adaptive
    from qpn_tpu_torch.utils.metrics import METRICS
    M, q, l, u, _, vm = (data[k][:lanes] for k in KEYS)
    rng = np.random.default_rng(SEED)
    z0 = torch.as_tensor(FAR_START * rng.standard_normal(tuple(q.shape)),
                         device=device)
    METRICS.reset()
    res = solve_avi_batch_adaptive(M, q, l, u, z0, vm, tol=SOLVE_TOL,
                                   budgets=(1,), mixed=True)
    torch.cuda.synchronize(device)
    escalated = int(METRICS.counters["escalated_lanes"])
    pivots = METRICS.launches[kernel]
    conv = res.converged.cpu().numpy()
    if escalated < 1 or pivots < 1:
        fail(f"forced stragglers: {escalated} escalated lanes, {pivots} "
             "pivot kernel launches")
    if not conv.sum() > lanes - escalated:
        fail(f"forced stragglers: no lane certified through lemke_escalate "
             f"({conv.sum()}/{lanes} certified, {escalated} escalated)")
    resid = numpy_audit(batch, res.z.cpu().numpy(), lanes)
    if not resid[conv].max() <= SOLVE_TOL:
        fail(f"forced stragglers, numpy audit: {resid[conv].max()!r}")
    say(f"forced stragglers n={q.shape[1]}: {lanes} lanes from z0 = "
        f"{FAR_START:g}*N(0,1), budgets=(1,): {escalated} escalated, "
        f"{pivots} {kernel} launch(es) (f64), {int(conv.sum())}/{lanes} "
        f"certified, max resid {resid[conv].max():.3g} [{card}]")


def screen_batch(B, m, n, seed, centre=0.1, empty=True):
    """Seeded polyhedra l ≤ Ax ≤ u (no strict rows): A ~ N(0,1), bounds a
    random width around a centre of scale ``centre`` near the origin, ~30%
    of the rows one-sided; with ``empty`` every odd one made empty by two
    rows with the same normal and bounds 2 apart.  Returns (polys, empty
    truth)."""
    import numpy as np
    from qpn_tpu_torch.geometry import Poly
    rng = np.random.default_rng(seed)
    polys, truth = [], np.zeros(B, dtype=bool)
    for b in range(B):
        A = rng.standard_normal((m, n))
        ax = A @ (centre * rng.standard_normal(n))
        w = 0.5 + rng.random(m)
        one_sided = rng.random(m) < 0.3
        low_open = one_sided & (rng.random(m) < 0.5)
        l = np.where(low_open, -np.inf, ax - w)
        u = np.where(one_sided & ~low_open, np.inf, ax + w)
        if empty and b % 2:
            A[1] = A[0]
            l[0], u[0] = ax[0] + 1.0, np.inf
            l[1], u[1] = -np.inf, ax[0] - 1.0
            truth[b] = True
        polys.append(Poly(A, l, u, normalize=False, dedupe=False))
    return polys, truth


def compare_screen(polys, truth, device, say, card, label):
    """Screen kernel vs plain loop on the same prepared inputs.  Returns
    (max |dx|, kernel s, plain s, the bound of that launch)."""
    import torch
    from qpn_tpu_torch.ops import screen, screen_cuda
    prob = screen.screen_prepare(polys)
    ins = [torch.as_tensor(a, device=device) for a in prob]
    B, m, n = prob.A.shape
    xk, vk = screen_cuda.feasibility_screen_cuda(*ins, SCREEN_STEPS, SCREEN_LR)
    xp, vp = screen.screen_steps_torch(*ins, SCREEN_STEPS, SCREEN_LR)
    torch.cuda.synchronize(device)
    if not (bool(torch.isfinite(xk).all()) and bool(torch.isfinite(vk).all())):
        fail(f"screen {label}: non-finite kernel output")
    dx = (xk - xp).abs().amax(1)
    xerr = float((dx / (1.0 + xp.abs().amax(1))).max())
    verr = float(((vk - vp).abs() / (1.0 + vp)).max())
    if not (xerr <= SCREEN_TOL and verr <= SCREEN_TOL):
        fail(f"screen {label}: x differs by {xerr!r}, max |v| by {verr!r} "
             f"(relative), bound {SCREEN_TOL}")
    wk, _ = screen.feasibility_screen(
        polys, margin=SCREEN_MARGIN, engine=screen_cuda.feasibility_screen_cuda)
    wp, _ = screen.feasibility_screen(
        polys, margin=SCREEN_MARGIN, engine=screen.screen_steps_torch)
    band = SCREEN_TOL * (1.0 + SCREEN_MARGIN)
    near = (((vk - SCREEN_MARGIN).abs() <= band)
            | ((vp - SCREEN_MARGIN).abs() <= band)).cpu().numpy()
    if ((wk != wp) & ~near).any():
        fail(f"screen {label}: the kernel witnesses other polyhedra than "
             "the plain loop outside the margin band")
    if truth is not None and (wk & truth).any():
        fail(f"screen {label}: an empty polyhedron was witnessed")
    t_k = device_timed(lambda: screen_cuda.feasibility_screen_cuda(
        *ins, SCREEN_STEPS, SCREEN_LR), device)
    t_p = device_timed(lambda: screen.screen_steps_torch(
        *ins, SCREEN_STEPS, SCREEN_LR), device)
    max_abs = float(dx.max())
    bnd = screen_bound(ins, (xk, vk), SCREEN_STEPS)
    adds, floor_ms = screen_chain_floor(m, n, SCREEN_STEPS)
    say(f"feasibility_screen {label} B={B} m={m} n={n} steps={SCREEN_STEPS}: "
        f"max |dx| {max_abs:.3g} ({xerr:.3g} of the scale), max |v| "
        f"{verr:.3g} relative, both <= {SCREEN_TOL}; witnessed "
        f"{int(wk.sum())} kernel, {int(wp.sum())} plain (margin "
        f"{SCREEN_MARGIN}); kernel {t_k * 1e3:.4f} ms, plain "
        f"{t_p * 1e3:.4f} ms (median of {REPEATS}); bound {bnd[0]:.5f} ms by "
        f"{bnd[1]}, chain floor {floor_ms:.4f} ms ({adds} dependent adds) "
        f"[{card}]")
    return max_abs, t_k, t_p, bnd


def geometry_entry(polys, truth, device, say, card):
    """is_empty_batch on the card with the screen on and off.  Returns the
    screen kernel's launches in the run with the screen on."""
    import numpy as np
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.geometry import is_empty_batch
    from qpn_tpu_torch.geometry.query_cache import CACHE
    from qpn_tpu_torch.ops import screen_cuda
    from qpn_tpu_torch.utils.metrics import METRICS
    B = len(polys)
    out, secs, launches, witnessed = {}, {}, {}, {}
    for on in (True, False):
        CONFIG.use_screen = on
        times = []
        for rep in range(4):        # the first run is the one counted
            CACHE.clear()           # verdicts are memoized by content
            if rep == 0:
                METRICS.reset()
            t0 = time.perf_counter()
            verdict = is_empty_batch(polys)
            times.append(time.perf_counter() - t0)
            if rep == 0:
                launches[on] = METRICS.launches[screen_cuda.KERNEL]
                witnessed[on] = int(METRICS.counters["screen_witnessed"])
                out[on] = verdict
        secs[on] = statistics.median(times[1:])
    CONFIG.use_screen = None
    if not (np.array_equal(out[True], truth)
            and np.array_equal(out[False], truth)):
        fail(f"is_empty_batch: {int((out[True] != truth).sum())} (screen on) "
             f"and {int((out[False] != truth).sum())} (screen off) verdicts "
             "differ from the truth")
    if launches[True] < 1 or launches[False] != 0:
        fail(f"is_empty_batch: {launches[True]} screen kernel launches with "
             f"the screen on, {launches[False]} with it off")
    say(f"geometry is_empty_batch B={B} device=cuda: verdicts equal to the "
        f"truth with the screen on and off ({int(truth.sum())} empty); "
        f"screen on: {launches[True]} kernel launch(es), {witnessed[True]} "
        f"polyhedra witnessed, {B / secs[True]:.1f} polyhedra/s "
        f"({secs[True]:.3f} s); screen off: {B / secs[False]:.1f} "
        f"polyhedra/s ({secs[False]:.3f} s); median of 3 [{card}]")
    return launches[True]


def solve_zoo(device, say, card):
    """solve() end to end on the card and on the CPU.  Returns the pieces of
    robust_avoid's solution graph from the card's solve, and that solve's
    (result, counters, wall seconds)."""
    import numpy as np
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.geometry.query_cache import CACHE
    from qpn_tpu_torch.ops import eg_cuda, lemke_cuda, screen_cuda
    from qpn_tpu_torch.utils.metrics import METRICS
    kernels = (lemke_cuda.KERNEL, eg_cuda.KERNEL, screen_cuda.KERNEL)
    METRICS.reset()
    default_device = CONFIG.device
    walls = {"cuda": 0.0, "cpu": 0.0}
    pieces = None
    for name, kw, x0, want_qep, want_pieces in ZOO:
        row = {}
        for dev in ("cuda", "cpu"):
            CONFIG.device = dev
            CACHE.clear()       # each solve starts without memoized queries
            qpn = qt.setup(name, **kw)
            t0 = time.perf_counter()
            ret = qt.solve(qpn, None if x0 is None else np.asarray(x0))
            wall = time.perf_counter() - t0
            walls[dev] += wall
            c = dict(qpn.metrics.counters)
            qep = int(c.get("qep_solves", 0))
            npieces = int(c.get("pieces_projected", 0))
            if not (ret.solved and qep == want_qep
                    and npieces == want_pieces):
                fail(f"solve {name} device={dev}: solved {ret.solved}, "
                     f"{qep} QEP / {npieces} pieces, expected {want_qep} / "
                     f"{want_pieces}")
            x = np.asarray(ret.x_opt)
            if not np.isfinite(x).all():
                fail(f"solve {name} device={dev}: non-finite x_opt")
            row[dev] = (wall, x, c)
            if dev == "cuda" and name == "robust_avoid":
                pieces = [p for pu in ret.Sol.values() if pu is not None
                          for p in pu]
                ra_card = (ret, c, wall)
        dx = float(np.abs(row["cuda"][1] - row["cpu"][1]).max())
        if not dx <= X_OPT_TOL:
            fail(f"solve {name}: x_opt on the card differs from the CPU's by "
                 f"{dx!r}")
        c = row["cuda"][2]
        say(f"solve {name}: solved, {want_qep} QEP, {want_pieces} pieces on "
            f"both devices, x_opt within {dx:.3g}; wall {row['cuda'][0]:.3f} "
            f"s device=cuda, {row['cpu'][0]:.3f} s device=cpu; on the card "
            f"{int(c.get('admm_calls', 0))} ADMM calls, "
            f"{int(c.get('admm_blocks', 0))} ADMM blocks of 25 iterations, "
            f"{int(c.get('lp_host', 0))} host LPs [{card}]")
    CONFIG.device = default_device      # the card again, for the rest
    CACHE.clear()
    golden_wall = 0.0
    qpn = qt.setup("simple_bilevel", gen_solution_map=True)
    for w, xs, min_pieces in GOLDEN:
        t0 = time.perf_counter()
        ret = qt.solve(qpn, np.concatenate([w, [0.0, 0.0]]))
        golden_wall += time.perf_counter() - t0
        ok = ret.solved and any(
            np.allclose(ret.x_opt, np.concatenate([w, xi]), atol=1e-4)
            for xi in xs)
        if not ok or len(list(ret.Sol[2])) < min_pieces:
            fail(f"simple_bilevel golden point w={w}: solved {ret.solved}, "
                 f"x_opt {ret.x_opt}")
    launches = {k: METRICS.launches[k] for k in kernels}
    say(f"solve() zoo: {len(ZOO)}/{len(ZOO)} models solved at ZOO_r05_cpu.json's counts on "
        f"both devices, wall {walls['cuda']:.3f} s device=cuda, "
        f"{walls['cpu']:.3f} s device=cpu; golden simple_bilevel 8/8 on the "
        f"card ({golden_wall:.3f} s); kernel launches on the card (zoo and "
        f"golden points): {launches} [{card}]")
    return pieces, ra_card


def rest_analytic(row, ret, qpn):
    """tests/test_models.py's analytic check of a REST row on ``ret``; the
    reason it fails, or None."""
    import numpy as np
    x = np.asarray(ret.x_opt) if ret.solved else None
    if row == "robust_constrained":
        T, F = 2, 4
        i = 4 + 4 * T
        U, S = x[i:i + 2 * T], x[i + 2 * T + F * T:i + 2 * T + F * T + T]
        c, v = x[i + 2 * T + F * T + T + 2], x[i + 2 * T + F * T + T + 3]
        ok = (np.allclose(U[0::2], 10.0, atol=1e-6)
              and np.allclose(U[1::2], 0.0, atol=1e-6)
              and abs(c - S.min()) <= 1e-6 and abs(v - max(0.0, c)) <= 1e-6)
    elif row.startswith("bilevel_escape"):
        want = [2.0, 0.0, 1.0, 0.0] if row.endswith("far") else [0.0] * 4
        ok = np.allclose(x, want, atol=1e-4)
    elif row == "simple_network_v2":
        ok = ret.solved is False          # a clean, reported failure
    elif row.startswith("simple_network"):
        want = [0.0] * 3 if row.endswith("v1") else [0.5, 0.5, 0.0]
        ok = np.allclose(x, want, atol=1e-4)
    elif row == "repeated_variable_control":
        from qpn_tpu_torch.ops import batch_qp
        d = qpn.problem_data
        sol = batch_qp.solve_qp_np(d["Q"], d["q"], d["A"], d["l"], d["u"])
        ok = (np.allclose(x[:3], np.asarray(sol.x), atol=1e-5)
              and abs(x[3]) <= 1e-6)
    elif row == "control_avoid":
        from qpn_tpu_torch.models.robust_constrained import dyn
        T, F = 2, 4
        i = 2 + 4 + 4 * T + 2 * T + F * T
        u1 = x[6 + 4 * T:6 + 4 * T + 2]
        ok = (bool(np.all(x[i:i + T] >= -1e-6))
              and np.allclose(x[6:10], dyn(list(x[2:6]), list(u1)),
                              atol=1e-6))
    else:                                 # interpolation_avoid
        K = 3
        i = 4 + 4 + 2 + 2 * K
        ok = abs(x[i + K] - x[i:i + K].min()) <= 1e-5 and x[i + K] >= -1e-6
    return None if ok else f"analytic check failed, x_opt {x}"


class _Capture:
    """Wraps ``lemke.solve_lemke_batch_padded`` (lemke_escalate's pivot
    call) while it is installed, keeping each call's inputs and outputs."""

    def __init__(self):
        from qpn_tpu_torch.ops import lemke
        self.lemke, self.orig, self.calls = lemke, \
            lemke.solve_lemke_batch_padded, []

    def __enter__(self):
        def wrapped(*args, **kw):
            out = self.orig(*args, **kw)
            self.calls.append(([a.clone() for a in args], kw,
                               [o.clone() for o in out]))
            return out
        self.lemke.solve_lemke_batch_padded = wrapped
        return self

    def __exit__(self, *exc):
        self.lemke.solve_lemke_batch_padded = self.orig


def check_escalations(row, calls):
    """Reruns each captured card call of solve_lemke_batch_padded with the
    plain pivot loop on the same tensors: equal status and pivots, z within
    ESCALATION_Z_RTOL.  Returns the largest relative |dz|."""
    import torch
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.ops import lemke
    worst = 0.0
    mode = CONFIG.lemke_kernel
    CONFIG.lemke_kernel = "torch"
    try:
        for k, (args, kw, (z, status, piv)) in enumerate(calls):
            zp, sp, pp = lemke.solve_lemke_batch_padded(*args, **kw)
            if not (torch.equal(status, sp) and torch.equal(piv, pp)):
                fail(f"{row} escalation call {k}: K1 status {status.tolist()}"
                     f" pivots {piv.tolist()}, plain loop {sp.tolist()} "
                     f"{pp.tolist()}")
            scale = max(1.0, float(zp.abs().max()))
            err = float((z - zp).abs().max()) / scale
            if not err <= ESCALATION_Z_RTOL:
                fail(f"{row} escalation call {k}: K1's z differs from the "
                     f"plain loop's by {err!r} of max(1, |z|) = {scale!r}")
            worst = max(worst, err)
    finally:
        CONFIG.lemke_kernel = mode
    return worst


def solve_rest(device, say, card):
    """The six models outside the zoo (REST) through solve() on the card and
    on the CPU: the counts of REST on both devices, x_opt within X_OPT_TOL
    between them, each model's analytic check, host LPs answered by the
    native library on the card wherever the CPU solve runs them, the kernel
    launches of REST_K1_LAUNCHES on the card, and K1 held against the plain
    loop on every escalation call it answered."""
    import numpy as np
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.geometry.query_cache import CACHE
    from qpn_tpu_torch.ops import eg_cuda, lemke_cuda, screen_cuda
    from qpn_tpu_torch.utils import native
    lib = native.library_path()
    if os.path.realpath(lib.parent) != os.path.realpath(
            os.path.join(HERE, "build", "qpn_tpu_torch")):
        fail(f"the native library was loaded from {lib}, not from "
             f"build/qpn_tpu_torch/")
    say(f"native host library: {lib} (from {native._SOURCE})")
    default_device = CONFIG.device
    walls = {"cuda": 0.0, "cpu": 0.0}
    before = _kernel_launches()
    for row, name, kw, x0, want_qep, want_pieces, want_solved in REST:
        got = {}
        for dev in ("cuda", "cpu"):
            CONFIG.device = dev
            CACHE.clear()
            qpn = qt.setup(name, **kw)
            k0 = _kernel_launches()
            with _Capture() as cap:
                t0 = time.perf_counter()
                ret = qt.solve(qpn, None if x0 is None else np.asarray(x0))
                wall = time.perf_counter() - t0
            walls[dev] += wall
            c = dict(qpn.metrics.counters)
            counts = (int(c.get("qep_solves", 0)),
                      int(c.get("pieces_projected", 0)), bool(ret.solved))
            if counts != (want_qep, want_pieces, want_solved):
                fail(f"solve {row} device={dev}: (QEP, pieces, solved) "
                     f"{counts}, expected {(want_qep, want_pieces, want_solved)}")
            if ret.solved and not np.isfinite(ret.x_opt).all():
                fail(f"solve {row} device={dev}: non-finite x_opt")
            why = rest_analytic(row, ret, qpn)
            if why:
                fail(f"solve {row} device={dev}: {why}")
            launched = {k: v - k0[k] for k, v in _kernel_launches().items()}
            got[dev] = (wall, ret, int(c.get("lp_host", 0)), launched,
                        cap.calls)
        (w_card, r_card, lp_card, k_card, esc_card), \
            (w_cpu, r_cpu, lp_cpu, _, esc_cpu) = got["cuda"], got["cpu"]
        want_k = {lemke_cuda.KERNEL: REST_K1_LAUNCHES.get(row, 0),
                  eg_cuda.KERNEL: 0, screen_cuda.KERNEL: 0}
        if k_card != want_k:
            fail(f"solve {row}: kernel launches on the card {k_card}, "
                 f"expected {want_k}")
        if len(esc_card) != want_k[lemke_cuda.KERNEL] or \
                len(esc_cpu) != len(esc_card):
            fail(f"solve {row}: {len(esc_card)} escalation pivot calls on "
                 f"the card, {len(esc_cpu)} on the CPU, expected one a K1 "
                 f"launch ({want_k[lemke_cuda.KERNEL]})")
        esc_err = check_escalations(row, esc_card)
        dx = 0.0
        if want_solved:
            dx = float(np.abs(np.asarray(r_card.x_opt)
                              - np.asarray(r_cpu.x_opt)).max())
            if not dx <= X_OPT_TOL:
                fail(f"solve {row}: x_opt on the card differs from the "
                     f"CPU's by {dx!r}")
        if lp_cpu > 0 and lp_card == 0:
            fail(f"solve {row}: the CPU solve ran {lp_cpu} host LPs, the "
                 f"card's none: the native engine did not answer them")
        say(f"solve {row}: solved={want_solved}, {want_qep} QEP, "
            f"{want_pieces} pieces on both devices, x_opt within {dx:.3g}, "
            f"analytic check met; wall {w_card:.3f} s device=cuda, "
            f"{w_cpu:.3f} s device=cpu; host LPs {lp_card} on the card, "
            f"{lp_cpu} on the CPU; kernel launches on the card {k_card}, "
            f"K1 against the plain loop on its {len(esc_card)} escalation "
            f"calls: equal status and pivots, z within {esc_err:.3g} of "
            f"max(1, |z|) [{card}]")
    CONFIG.device = default_device
    CACHE.clear()
    launched = {k: v - before[k] for k, v in _kernel_launches().items()}
    say(f"solve() rest: {len(REST)}/{len(REST)} rows at their counts on "
        f"both devices, wall {walls['cuda']:.3f} s device=cuda, "
        f"{walls['cpu']:.3f} s device=cpu; kernel launches on the card "
        f"{launched} [{card}]")


def shared_large(data, z_kkt, device, say, card):
    """Phase 13: the shared-matrix route at its design scale, through the
    routed entry point."""
    import numpy as np
    import torch
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import shared_kkt
    from qpn_tpu_torch.ops.avi import batch_from_numpy, solve_kkt_avi_batch
    from qpn_tpu_torch.utils.metrics import METRICS
    t0 = time.perf_counter()
    batch = scenario_batch_gavis(**LARGE)
    big = batch_from_numpy(batch)
    t_build = time.perf_counter() - t0
    B, n = big["q"].shape
    args = (big["M"], big["q"], big["l"], big["u"], big["mask"],
            big["structure"])
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    METRICS.reset()
    res = solve_kkt_avi_batch(*args, tol=SOLVE_TOL)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    routed = int(METRICS.counters["kkt_shared_route"])
    rungs = {k: int(METRICS.counters[k]) for k in SHARED_RUNGS}
    z = res.z.cpu().numpy()
    conv = float(res.converged.double().mean())
    if routed != B:
        fail(f"shared route: kkt_shared_route counted {routed} of {B} lanes")
    if z.shape != (B, n) or not np.isfinite(z).all():
        fail(f"shared route: z has shape {z.shape} or non-finite values")
    if conv != 1.0:
        fail(f"shared route: conv {conv}")
    M0 = batch["M"][0]
    F = z @ M0.T + batch["q"]
    resid = np.abs(z - np.clip(z - F, batch["l"], batch["u"])).max(axis=1)
    if not resid.max() <= SOLVE_TOL:
        fail(f"shared route, numpy audit: max natural residual "
             f"{resid.max()!r}")
    if rungs["shared_kkt_generic_escalation"] != 0:
        fail(f"shared route: the generic escalation ran ({rungs})")
    # the same call with the ledger, then the timed calls
    stats = {}
    shared_kkt.solve_kkt_avi_shared(big["M"], big["q"], big["l"], big["u"],
                                    big["mask"], tol=SOLVE_TOL,
                                    structure=big["structure"], stats=stats)
    t_call = timed(lambda: solve_kkt_avi_batch(*args, tol=SOLVE_TOL), device,
                   3)
    # the label hash on the card is its host mirror's, bit for bit
    rng = np.random.default_rng(SEED)
    at_l = rng.random((64, n)) < 0.3
    at_u = (rng.random((64, n)) < 0.3) & ~at_l
    h_dev = shared_kkt._label_hash_dev(
        torch.as_tensor(at_l, device=device),
        torch.as_tensor(at_u, device=device)).cpu().numpy()
    h_host = shared_kkt._label_hash(at_l, at_u, shared_kkt._hash_weights(n))
    if not np.array_equal(h_dev, h_host):
        fail("shared route: the label hash on the card is not its host "
             "mirror's")
    say(f"shared route solve_kkt_avi_batch robust_avoid S={B} T={LARGE['T']} "
        f"num_obj={LARGE['num_obj']} n={n} tol={SOLVE_TOL}: "
        f"kkt_shared_route {routed}, conv {conv}, max resid "
        f"{resid.max():.3g} (numpy audit), rungs {rungs}; "
        f"{B / t_call:.1f} solves/s ({t_call:.3f} s a call, median of 3 "
        f"warm calls); stats {json.dumps(stats)}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
        f"ensemble's {base / 2**30:.2f}); ensemble built in {t_build:.1f} s "
        f"on the host [{card}]")
    # small-input references: one solution at T=2, so z against the KKT
    # path's on the flagship ensemble; the CPU path on 8 lanes of this one
    res2 = shared_kkt.solve_kkt_avi_shared(
        data["M"], data["q"], data["l"], data["u"], data["mask"],
        tol=SOLVE_TOL, structure=data["structure"])
    dz = float((res2.z - z_kkt).abs().max())
    if not (bool(res2.converged.all()) and dz <= SHARED_Z_TOL):
        fail(f"shared route on the flagship ensemble: conv "
             f"{float(res2.converged.double().mean())}, z differs from the "
             f"KKT path's by {dz!r}")
    cpu = shared_kkt.solve_kkt_avi_shared(
        M0, *(torch.as_tensor(batch[k][:8]) for k in ("q", "l", "u")), None,
        tol=SOLVE_TOL, structure=batch["structure"])
    if cpu.z.device.type != "cpu" or not bool(cpu.converged.all()):
        fail("shared route, CPU path on 8 lanes: not every lane certified")
    dc = float((cpu.z - res.z[:8].cpu()).abs().max())
    say(f"shared route references: flagship ensemble (T=2, S={S}) z within "
        f"{dz:.3g} of the KKT path's (<= {SHARED_Z_TOL}); CPU path on 8 "
        f"lanes of the large ensemble certified, max resid "
        f"{float(cpu.resid.max()):.3g}, z within {dc:.3g} of the card's (M "
        f"is rank-deficient at T=8: not a gate) [{card}]")
    return big, res


def shared_hard(device, say, card):
    """Phase 14: the hard seed, whose round-0-singular lanes go to the ADMM
    rung on the card; three repeats must be identical bit for bit."""
    import torch
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import shared_kkt
    from qpn_tpu_torch.ops.avi import batch_from_numpy
    from qpn_tpu_torch.utils.metrics import METRICS
    hard = batch_from_numpy(scenario_batch_gavis(**HARD))
    B, n = hard["q"].shape
    runs, secs = [], []
    for _ in range(3):
        METRICS.reset()
        stats = {}
        t0 = time.perf_counter()
        res = shared_kkt.solve_kkt_avi_shared(
            hard["M"], hard["q"], hard["l"], hard["u"], hard["mask"],
            tol=SOLVE_TOL, structure=hard["structure"], stats=stats)
        torch.cuda.synchronize(device)
        secs.append(time.perf_counter() - t0)
        rungs = {k: int(METRICS.counters[k]) for k in SHARED_RUNGS}
        if not bool(res.converged.all()):
            fail(f"hard seed: {int((~res.converged).sum())} of {B} lanes "
                 "not certified")
        runs.append((res.z.clone(), res.iters.clone(), rungs,
                     stats["host_solves"], stats))
    z0, it0, rungs0, hs0, stats0 = runs[0]
    if rungs0["shared_kkt_chip_admm_rung"] < 1:
        fail(f"hard seed: the ADMM rung did not run ({rungs0})")
    for z, it, rungs, hs, _ in runs[1:]:
        if not (torch.equal(z, z0) and torch.equal(it, it0)
                and rungs == rungs0 and hs == hs0):
            fail("hard seed: three repeats are not identical (z equal: "
                 f"{torch.equal(z, z0)}, iterations equal: "
                 f"{torch.equal(it, it0)}, rungs {rungs} against {rungs0})")
    say(f"shared route hard seed S={B} n={n} seed={HARD['seed']}: every lane "
        f"certified, max resid {float(res.resid.max()):.3g}, "
        f"rungs {rungs0}, three repeats identical bit for bit (z, per-lane "
        f"iterations, rung populations, host solves); {min(secs):.3f}-"
        f"{max(secs):.3f} s a call; stats {json.dumps(stats0)} [{card}]")


def _kernel_launches():
    from qpn_tpu_torch.ops import eg_cuda, lemke_cuda, screen_cuda
    from qpn_tpu_torch.utils.metrics import METRICS
    return {k: METRICS.launches[k] for k in (lemke_cuda.KERNEL, eg_cuda.KERNEL,
                                             screen_cuda.KERNEL)}


def _n_pieces(ret):
    return {k: len(list(v)) for k, v in ret.Sol.items() if v is not None}


def lockstep_ensemble(name, qpns, x0s, device, say, card):
    """One lockstep ensemble on the card against its serial solves, each
    timed here.  Returns the largest |dx_opt|."""
    import numpy as np
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.geometry.query_cache import CACHE
    from qpn_tpu_torch.parallel.lockstep import solve_many_lockstep
    from qpn_tpu_torch.utils.metrics import METRICS
    serial = []
    for qpn, x0 in zip(qpns, x0s):
        CACHE.clear()
        t0 = time.perf_counter()
        ret = qt.solve(qpn(), x0)
        _sync(device)
        serial.append((ret, dict(METRICS.counters),
                       time.perf_counter() - t0))
    keys = ("admm_calls", "admm_blocks", "qep_solves", "pieces_projected")
    sums = {k: sum(c.get(k, 0) for _, c, _ in serial) for k in keys}
    CACHE.clear()
    nets = [qpn() for qpn in qpns]
    METRICS.reset()                     # the counts of this path alone
    t0 = time.perf_counter()
    outs, broker = solve_many_lockstep(nets, x0s)
    _sync(device)
    wall = time.perf_counter() - t0
    fused = {k: METRICS.counters.get(k, 0) for k in keys + (
        "broker_lp_host_waves", "broker_lp_host_fused")}
    launches = _kernel_launches()
    dx = 0.0
    for i, (o, (s, _, _)) in enumerate(zip(outs, serial)):
        if not (o.solved and s.solved):
            fail(f"lockstep {name}: scenario {i} solved {o.solved} under the "
                 f"broker, {s.solved} serially")
        d = float(np.abs(np.asarray(o.x_opt) - np.asarray(s.x_opt)).max())
        if not d <= X_OPT_TOL or _n_pieces(o) != _n_pieces(s):
            fail(f"lockstep {name}: scenario {i} x_opt differs from its "
                 f"serial solve by {d!r}, pieces {_n_pieces(o)} against "
                 f"{_n_pieces(s)}")
        dx = max(dx, d)
    if broker.waves < 1:
        fail(f"lockstep {name}: the broker fused no wave")
    if not fused["admm_calls"] < sums["admm_calls"]:
        fail(f"lockstep {name}: {fused['admm_calls']} fused ADMM calls, not "
             f"below the serial sum {sums['admm_calls']}")
    walls = [w for _, _, w in serial]
    t_serial = sum(walls)
    per = (", ".join(f"{w:.3f}" for w in walls) if len(walls) <= 4 else
           f"{min(walls):.3f}-{max(walls):.3f}")
    say(f"lockstep {name} S={len(nets)}: every scenario solved at its serial "
        f"solve's pieces, x_opt within {dx:.3g} (gate {X_OPT_TOL}); wall "
        f"{wall:.3f} s lockstep, of which {broker.dispatch_s:.3f} s in the "
        f"fused engine calls, against {t_serial:.3f} s for the serial loop "
        f"({t_serial / wall:.2f}x; serial solves {per} s); "
        f"{broker.waves} waves; admm_calls "
        f"{int(fused['admm_calls'])} against {int(sums['admm_calls'])} "
        f"serial, admm_blocks {int(fused['admm_blocks'])} against "
        f"{int(sums['admm_blocks'])}; QEP {int(fused['qep_solves'])} and "
        f"pieces {int(fused['pieces_projected'])} against "
        f"{int(sums['qep_solves'])} and {int(sums['pieces_projected'])}; "
        f"broker_lp_host_waves {int(fused['broker_lp_host_waves'])}, "
        f"broker_lp_host_fused {int(fused['broker_lp_host_fused'])}; kernel "
        f"launches {launches} [{card}]")
    return dx


def lockstep_phase(device, say, card):
    """Phase 15: scaling_bench's lockstep ensemble and a robust_avoid
    ensemble through ``solve_many_lockstep`` on the card."""
    import numpy as np
    import qpn_tpu_torch as qt
    sb = [lambda: qt.setup("simple_bilevel", gen_solution_map=False)] * 16
    sb_x0 = [np.array([0.1 * i, 1.0, 0.0, 0.0]) for i in range(16)]
    lockstep_ensemble("simple_bilevel", sb, sb_x0, device, say, card)
    kw = dict(T=2, num_obj=1, num_poly_faces=3)
    flat = qt.setup("robust_avoid", **kw).get_flat_initialization()
    ra_x0 = [None] + [flat + 0.05 * np.random.default_rng(k).standard_normal(
        flat.shape) for k in (1, 2)]
    lockstep_ensemble("robust_avoid", [lambda: qt.setup("robust_avoid", **kw)]
                      * 3, ra_x0, device, say, card)


def banded_phase(device, say, card):
    """Phase 16: benchmarks/banded_bench.py's sweep on the card, dense
    against banded x-update of ``solve_qp_batch``, then the automatic route
    of ``solve_qp_batch_padded`` once.  At each block count T one route
    wins only when each of its 3 calls beats each of the other's by the
    factor BANDED_MARGIN; a smaller edge either way is a tie, and a tie
    keeps the shipped value.  The measured crossover is the smallest T from
    which the banded route won at every larger count of the sweep, or 0.
    The phase fails when a crossover was measured and differs from
    ``config.banded_min_blocks()``, the value the port ships for the card
    (0, off: the banded route won by the margin from some T to the end of
    the sweep)."""
    import numpy as np
    import torch
    from qpn_tpu_torch import config
    from qpn_tpu_torch.ops import batch_qp
    from qpn_tpu_torch.ops.banded import dense_from_blocks, horizon_kkt_blocks
    from qpn_tpu_torch.utils.metrics import METRICS
    rng = np.random.default_rng(0)
    B, k = 64, 6
    rows, verdicts = [], []
    for T in (8, 16, 32, 64):
        n = T * k
        Ps, qs = [], []
        for _ in range(B):
            A_, B_, C_, g = horizon_kkt_blocks(T, k, rng)
            Q = dense_from_blocks(A_, B_, C_)
            Ps.append(0.5 * (Q + Q.T) + 0.5 * np.eye(n))
            qs.append(g.flatten())
        host = (np.stack(Ps), np.stack(qs),
                np.repeat(np.eye(n)[None], B, axis=0), np.full((B, n), -2.0),
                np.full((B, n), 2.0))
        args = [torch.as_tensor(a, device=device) for a in host] + [
            torch.ones(B, n, dtype=torch.bool, device=device)]
        out = {}
        for bk in (0, k):
            out[bk] = batch_qp.solve_qp_batch(*args, banded_k=bk)
            out[bk] = (out[bk], timed_all(
                lambda: batch_qp.solve_qp_batch(*args, banded_k=bk), device,
                3))
        (dense, all_d), (band, all_b) = out[0], out[k]
        t_d, t_b = statistics.median(all_d), statistics.median(all_b)
        dx = float((dense.x - band.x).abs().max())
        if not (bool((band.status == batch_qp.SOLVED).all()) and dx <= 1e-6):
            fail(f"banded T={T}: statuses {band.status.unique().tolist()}, x "
                 f"differs from the dense route's by {dx!r}")
        verdict = ("banded" if max(all_b) * BANDED_MARGIN < min(all_d)
                   else "dense" if max(all_d) * BANDED_MARGIN < min(all_b)
                   else "tie")
        rows.append(f"T={T} n={n}: dense {t_d:.4f} s ({min(all_d):.4f}-"
                    f"{max(all_d):.4f}), banded {t_b:.4f} s ({min(all_b):.4f}"
                    f"-{max(all_b):.4f}), dense / banded {t_d / t_b:.2f}, "
                    f"{verdict}, x within {dx:.2g}")
        verdicts.append((T, verdict))
    crossover = 0
    for T, verdict in reversed(verdicts):
        if verdict != "banded":
            break
        crossover = T
    # the automatic route once: detection on a 16-block trajectory batch,
    # with the route switched on for this call at the sweep's smallest size
    P, q, A, lo, hi = host
    P, q, A, lo, hi = (a[:4, :96, :96] if a.ndim == 3 else a[:4, :96]
                       for a in (P, q, A, lo, hi))
    shipped = config.banded_min_blocks()
    if crossover not in (0, shipped):
        fail(f"banded crossover measured {crossover} (a win by at least "
             f"{BANDED_MARGIN}x), but the port ships "
             f"config.banded_min_blocks() = {shipped} for the card: "
             + "; ".join(rows))
    METRICS.reset()
    batch_qp.banded_min_blocks = lambda: 8
    try:
        sol = batch_qp.solve_qp_batch_padded(P, q, A, lo, hi,
                                             np.ones((4, 96), bool))
    finally:
        batch_qp.banded_min_blocks = config.banded_min_blocks
    routed = int(METRICS.counters.get("banded_route", 0))
    if routed != 4 or not (sol.status == batch_qp.SOLVED).all():
        fail(f"banded auto route: banded_route {routed} of 4 lanes, statuses "
             f"{sol.status.tolist()}")
    say(f"banded x-update B={B} k={k} solve_qp_batch, median of 3 warm "
        f"calls: " + "; ".join(rows) + f"; crossover "
        f"{crossover or 'none'} (a win needs {BANDED_MARGIN}x), consistent "
        f"with the shipped config.banded_min_blocks() = {shipped}; automatic "
        f"route "
        f"(solve_qp_batch_padded, 16 blocks, switched on for the call): "
        f"banded_route {routed} [{card}]")


def checkpoint_phase(ra_card, device, say, card):
    """Phase 17: a checkpointed robust_avoid solve on the card and its
    resume, then the process pool started from this CUDA parent: its
    workers take the parent's device, the card, and must give this
    process's own result."""
    import shutil
    import tempfile
    import numpy as np
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.geometry.query_cache import CACHE
    from qpn_tpu_torch.config import numeric_device
    from qpn_tpu_torch.models.robust_avoid import hard_chunk_job
    from qpn_tpu_torch.parallel.procpool import map_processes
    from qpn_tpu_torch.utils.checkpoint import load_state, resume
    kw = dict(T=2, num_obj=1, num_poly_faces=3)
    ref_ret = ra_card[0]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                           dir=os.path.join(HERE, "build"))
    try:
        path = os.path.join(tmp, "robust_avoid")
        CACHE.clear()
        t0 = time.perf_counter()
        ret = qt.solve(qt.setup("robust_avoid", **kw), checkpoint_path=path)
        t_ck = time.perf_counter() - t0
        state = load_state(path)
        CACHE.clear()
        t0 = time.perf_counter()
        res = resume(qt.setup("robust_avoid", **kw), path)
        t_res = time.perf_counter() - t0
        n_frontiers = len(os.listdir(path + ".frontiers"))
    finally:
        shutil.rmtree(tmp)
    for what, r in (("checkpointed solve", ret), ("resume", res)):
        d = float(np.abs(np.asarray(r.x_opt) - ref_ret.x_opt).max())
        if not (r.solved and d <= X_OPT_TOL
                and _n_pieces(r) == _n_pieces(ref_ret)):
            fail(f"checkpoint: {what} solved {r.solved}, x_opt {d!r} from "
                 f"phase 12's, pieces {_n_pieces(r)} against "
                 f"{_n_pieces(ref_ret)}")
    if not (state["meta"] == {"solved": True}
            and np.array_equal(state["x"], ret.x_opt)):
        fail(f"checkpoint: the file holds {state['meta']}")
    job = (2, 2, 1, 3, 0, 1e-8)
    t0 = time.perf_counter()
    out = map_processes(hard_chunk_job, [job] * 2, n_workers=2)
    t_pool = time.perf_counter() - t0
    devs = map_processes(numeric_device, [()] * 2, n_workers=2)
    want = hard_chunk_job(*job)         # this process, on the card
    d_sum = abs(out[0][2] - want[2]) / want[2]
    if not (out[0] == out[1] and out[0][0] == 1.0 == want[0]
            and d_sum <= 1e-9 and [d.type for d in devs] == ["cuda"] * 2):
        fail(f"map_processes from the CUDA parent: {out} on {devs}, against "
             f"{want} in this process")
    say(f"checkpoint robust_avoid on the card: solved with checkpoint_path "
        f"({t_ck:.3f} s, {n_frontiers} frontier files), load_state holds x_opt "
        f"and {sorted(state['Sol'])} solution graphs; resume ({t_res:.3f} s) "
        f"and the checkpointed solve at phase 12's x_opt and pieces "
        f"{_n_pieces(ref_ret)}; map_processes(hard_chunk_job, {job} x 2, "
        f"n_workers=2) from this CUDA parent, workers on {devs[0]}: "
        f"identical results {out[0]}, conv 1.0, |z| checksum within "
        f"{d_sum:.3g} (relative, gate 1e-9) of this process's "
        f"({'bit-identical' if out[0] == want else 'not bit-identical'}; "
        f"{t_pool:.1f} s) [{card}]")


def _host_prune(act, resid):
    """The keep mask of the strict (round(resid·1e12), index) prune as a
    plain numpy loop: piece i goes iff a piece with its signature is
    smaller in that order."""
    import numpy as np
    rq = np.round(resid * 1e12)
    keep = np.ones(len(act), dtype=bool)
    for i in range(len(act)):
        same = (act == act[i]).all(axis=1)
        better = (rq < rq[i]) | ((rq == rq[i]) & (np.arange(len(act)) < i))
        keep[i] = not (same & better).any()
    return keep


def multi_device_phase(batch, data, big, res_large, device, say, card):
    """Phase 18: (a) one rank over NCCL on the card: the sharded superstep
    on the flagship ensemble bit-identical to the single-process
    solve_avi_batch and the host prune, and the shared route with the mesh
    on the large row identical to phase 13's result; (b)
    ``entry.dryrun_multichip(2)``, two gloo ranks on the card, with the
    flagship superstep: its z within 1e-10 of (a), convergence and keep
    equal, the 8256-piece ring dedup at its set, the lockstep scenarios at
    their serial solves."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.entry import LOCKSTEP_WS, RING_PIECES, dryrun_multichip
    from qpn_tpu_torch.ops.avi import solve_avi_batch
    from qpn_tpu_torch.ops.shared_kkt import solve_kkt_avi_shared
    from qpn_tpu_torch.parallel import multihost
    from qpn_tpu_torch.parallel.sharded import equilibrium_superstep
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rdv_",
                           dir=os.path.join(HERE, "build"))
    launches0 = _kernel_launches()
    backend = multihost.init("file://" + os.path.join(tmp, "rdv"), 1, 0)
    try:
        if backend != "nccl":
            fail(f"one rank on the card took {backend}, not nccl")
        mesh = multihost.global_mesh()
        t0 = time.perf_counter()
        out = equilibrium_superstep(mesh, batch, tol=SOLVE_TOL)
        torch.cuda.synchronize(device)
        t_step = time.perf_counter() - t0
        t0 = time.perf_counter()
        shr = solve_kkt_avi_shared(big["M"], big["q"], big["l"], big["u"],
                                   None, tol=SOLVE_TOL,
                                   structure=big["structure"], mesh=mesh)
        torch.cuda.synchronize(device)
        t_shared = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    launches_a = {k: v - launches0[k]
                  for k, v in _kernel_launches().items()}
    one = solve_avi_batch(data["M"], data["q"], data["l"], data["u"],
                          data["z0"], data["mask"], tol=SOLVE_TOL,
                          max_iter=840)
    z = one.z.cpu().numpy()
    lq = np.where(np.isfinite(batch["l"]), batch["l"], -1e20)
    uq = np.where(np.isfinite(batch["u"]), batch["u"], 1e20)
    act = ((np.abs(z - lq) < 1e-6).astype(np.int32)
           + 2 * (np.abs(z - uq) < 1e-6).astype(np.int32))
    keep_host = _host_prune(act, one.resid.cpu().numpy())
    keep_a = out["keep"].cpu().numpy()
    if not (torch.equal(out["z"], one.z)
            and torch.equal(out["resid"], one.resid)
            and np.array_equal(keep_a, keep_host)):
        fail("phase 18(a): the one-rank NCCL superstep differs from the "
             "single-process solve or the host prune")
    if not all(torch.equal(a, b) for a, b in zip(shr, res_large)):
        fail("phase 18(a): the shared route with the mesh differs from "
             "phase 13's result")
    conv_a = float(out["converged_frac"])
    say(f"multi-device (a) one rank over nccl on {mesh.device}: superstep "
        f"S={S} T={T_STEPS} tol={SOLVE_TOL} ({t_step:.3f} s): z, resid "
        f"identical to solve_avi_batch, keep identical to the host prune "
        f"({int(keep_a.sum())} kept), conv {conv_a}; shared route "
        f"S={LARGE['num_scenarios']} n={big['q'].shape[1]} with the mesh "
        f"({t_shared:.3f} s): z, resid, iters, converged identical to phase "
        f"13's; no collective at one rank (0 bytes); kernel launches "
        f"{launches_a} [{card}]")

    t0 = time.perf_counter()
    ranks = dryrun_multichip(2, superstep=dict(
        num_scenarios=S, T=T_STEPS, num_obj=NUM_OBJ, num_poly_faces=FACES,
        seed=SEED, tol=SOLVE_TOL, max_iter=840), timeout_s=600)
    t_dry = time.perf_counter() - t0
    conv_one = (one.resid <= SOLVE_TOL).cpu().numpy()
    serial = [qt.solve(qt.setup("simple_bilevel"),
                       np.concatenate([w, [0.0, 0.0]])) for w in LOCKSTEP_WS]
    dz_max = 0.0
    for r in ranks:
        dz = float(np.abs(r["z"] - z).max())
        dz_max = max(dz_max, dz)
        if not (r["backend"] == "gloo" and r["device"].startswith("cuda")):
            fail(f"phase 18(b): rank {r['rank']} on {r['backend']}, "
                 f"{r['device']}")
        if not (dz <= 1e-10 and np.array_equal(r["converged"], conv_one)
                and np.array_equal(r["keep"], keep_a)):
            fail(f"phase 18(b): rank {r['rank']}'s superstep: z {dz!r} from "
                 f"(a), converged or keep differ")
        if not (r["ring_kept"] == RING_PIECES - RING_PIECES // 4
                and r["ring_waves"] >= 1):
            fail(f"phase 18(b): ring dedup kept {r['ring_kept']} with "
                 f"{r['ring_waves']} ring waves")
        for k, s in enumerate(serial):
            dx = float(np.abs(r["x_opts"][k] - s.x_opt).max())
            pieces = {j: len(v) for j, v in s.Sol.items() if v is not None}
            if not (s.solved and dx <= X_OPT_TOL
                    and r["pieces"][k] == pieces):
                fail(f"phase 18(b): lockstep scenario {k}: x_opt {dx!r} "
                     f"from its serial solve, pieces {r['pieces'][k]} "
                     f"against {pieces}")
    r0 = ranks[0]
    stages = ", ".join(f"{k} {r0['secs'][k]:.3f} s / {r0['bytes'][k]} B"
                       for k in r0["secs"])
    say(f"multi-device (b) dryrun_multichip(2): two gloo ranks on "
        f"{r0['device']} ({t_dry:.1f} s with the spawn); rank 0's stages "
        f"(seconds / bytes its collectives sent): {stages}; superstep "
        f"S={S} z within {dz_max:.3g} of (a) (<= 1e-10), converged and "
        f"keep equal; ring dedup {RING_PIECES}->{r0['ring_kept']} in "
        f"{r0['ring_waves']} ring wave(s); lockstep x_opt within "
        f"{X_OPT_TOL} of the serial solves on the card, equal pieces; "
        f"kernel launches in the ranks {[r['launches'] for r in ranks]} "
        f"[{card}]")


def host_bits(name, kernel_out, host_out):
    """Fail unless every output tensor of a kernel equals its host
    instance's bit for bit."""
    import torch
    for i, (k, h) in enumerate(zip(kernel_out, host_out)):
        if not torch.equal(k.cpu(), h):
            fail(f"{name}: output {i} differs from the g++ host instance's "
                 f"on {int((k.cpu() != h).sum())} entries")


def midsize_kkt(T, num_obj, device, say, card, repeats):
    """Phase 20 (a) at one size: the KKT route on the card with K1's cluster
    instance, the same calls with the plain loop, and K1 against the plain
    loop from one f32 setup.  Returns (launches of the cluster instance, the
    data and batch, compare_engines' result)."""
    import numpy as np
    import torch
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import lemke_cuda
    from qpn_tpu_torch.ops.avi import batch_from_numpy, solve_kkt_avi_batch
    from qpn_tpu_torch.utils.metrics import METRICS
    batch = scenario_batch_gavis(num_scenarios=S, T=T, num_obj=num_obj,
                                 num_poly_faces=FACES, seed=SEED)
    data = batch_from_numpy(batch)
    B, n = data["q"].shape
    args = (data["M"], data["q"], data["l"], data["u"], data["mask"],
            data["structure"])
    METRICS.reset()
    res = solve_kkt_avi_batch(*args, tol=SOLVE_TOL)
    torch.cuda.synchronize(device)
    launches = METRICS.launches[lemke_cuda.KERNEL_CLUSTER]
    others = (METRICS.launches[lemke_cuda.KERNEL]
              + METRICS.launches[lemke_cuda.KERNEL_GLOBAL])
    uncertified = METRICS.counters["kkt_uncertified_lanes"]
    routed = METRICS.counters["kkt_shared_route"]
    if launches < 1 or others != 0:
        fail(f"n={n}: {launches} launches of K1's cluster instance and "
             f"{others} of its shared and global ones in the KKT call")
    z = res.z.cpu().numpy()
    conv = float(res.converged.double().mean())
    if z.shape != (B, n) or not np.isfinite(z).all():
        fail(f"n={n}: z has shape {z.shape} or non-finite values")
    if conv != 1.0 or uncertified != 0 or routed != 0:
        fail(f"n={n}: conv {conv}, {uncertified} uncertified lanes, "
             f"{routed} lanes on the shared route")
    resid = numpy_audit(batch, z)
    if not resid.max() <= SOLVE_TOL:
        fail(f"n={n}, numpy audit: max natural residual {resid.max()!r}")
    CONFIG.lemke_kernel = "torch"
    try:
        plain = solve_kkt_avi_batch(*args, tol=SOLVE_TOL)
        t_plain = timed(lambda: solve_kkt_avi_batch(*args, tol=SOLVE_TOL),
                        device, repeats)
    finally:
        CONFIG.lemke_kernel = "auto"
    if not (torch.equal(plain.iters, res.iters)
            and torch.equal(plain.converged, res.converged)):
        bad = int((plain.iters != res.iters).sum())
        fail(f"n={n}: the plain loop's pivots differ on {bad} lanes")
    dz = float((plain.z - res.z).abs().max())
    if not dz <= Z_TOL:
        fail(f"n={n}: z differs from the plain loop's by {dz!r}")
    t_kernel = timed(lambda: solve_kkt_avi_batch(*args, tol=SOLVE_TOL),
                     device, repeats)
    eng = compare_engines(data, B, torch.float32, HOT,
                          lemke_cuda.lemke_pivot_cuda, device, repeats)
    err, t_k, t_p, rk, bnd = eng
    piv = res.iters.double()
    _, ranks = lemke_cuda.card_instance(n, 4, device)
    floor = k1_cluster_floor(n, 4, rk.piv, ranks)
    say(f"midsize KKT robust_avoid S={B} T={T} num_obj={num_obj} n={n}: "
        f"conv {conv}, max resid {resid.max():.3g}, {int(uncertified)} "
        f"uncertified, {launches} launch(es) of {lemke_cuda.KERNEL_CLUSTER} "
        f"({ranks} blocks a lane); pivots "
        f"{int(piv.min())}-{int(piv.max())} equal to the plain loop's on all "
        f"lanes, z within {dz:.3g}; {B / t_kernel:.1f} solves/s with the "
        f"kernel ({t_kernel * 1e3:.3f} ms), {B / t_plain:.1f} with the plain "
        f"loop ({t_plain * 1e3:.3f} ms), median of {repeats}; f32 pivot loop "
        f"alone: status and pivots identical, max |dz| {err:.3g}, kernel "
        f"{t_k * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms, bound {bnd[0]:.5f} "
        f"ms by {bnd[1]}, share {bnd[0] / (t_k * 1e3) * 100:.2f} %, the "
        f"band read and written once a pivot from shared memory (computed) "
        f"{floor:.4f} ms [{card}]")
    return launches, data, batch, eng


def k1_host_bits(data, dtype, kw, say, label):
    """K1's cluster instance on HOST_BIT_LANES lanes against the bits of its
    g++ host emulation (the lane spread over the same ranks)."""
    from qpn_tpu_torch.ops import lemke, lemke_cuda
    M, q, l, u, z0, vm = (data[k][:HOST_BIT_LANES] for k in KEYS)
    init = lemke.lemke_setup(*(a.to(dtype) for a in (M, q, l, u, z0)), vm,
                             tol=kw["tol"])
    n = q.shape[1]
    instance, ranks = lemke_cuda.card_instance(n, init.T.element_size(),
                                               q.device)
    if instance != lemke_cuda.LANE_CLUSTER:
        fail(f"K1 {label}: n={n} does not take the cluster instance")
    rk = lemke_cuda.lemke_pivot_cuda(init, **kw)
    rh = lemke_cuda.lemke_pivot_host(lemke.LemkeInit(*(a.cpu() for a in
                                                       init)),
                                     optin=lemke_cuda.card_optin(q.device),
                                     **kw)
    host_bits(f"K1 cluster {label}", [rk.status, rk.piv, rk.basis, rk.val,
                                      rk.xB],
              [rh.status, rh.piv, rh.basis, rh.val, rh.xB])
    say(f"K1 cluster {label} n={n} on {ranks} blocks a lane: status, pivots, "
        f"basis, values and basic values equal to the g++ host emulation's "
        f"of {ranks} ranks bit for bit on {HOST_BIT_LANES} lanes")


def k1_ab(data, lanes, dtype, kw, device, say, card, label):
    """The A/B of phase 20: K1's global instance at a cluster size through
    the wrapper's private launcher, against the cluster instance on the same
    setup: the same bits, both timed (median of REPEATS launches between
    CUDA events)."""
    import torch
    from qpn_tpu_torch.ops import lemke, lemke_cuda
    M, q, l, u = (data[k][:lanes] for k in ("M", "q", "l", "u"))
    vm = data["mask"][:lanes]
    init = lemke.lemke_setup(*(a.to(dtype) for a in (M, q, l, u)),
                             torch.zeros_like(q, dtype=dtype), vm,
                             tol=kw["tol"])
    n = q.shape[1]

    def glob():
        return lemke_cuda._launch(init, instance=lemke_cuda.LANE_GLOBAL,
                                  **kw)

    rc = lemke_cuda.lemke_pivot_cuda(init, **kw)
    rg = glob()
    torch.cuda.synchronize(device)
    for name, a, b in zip(rc._fields, rc, rg):
        if not torch.equal(a, b):
            fail(f"K1 A/B {label} n={n}: {name} of the global instance "
                 f"differs from the cluster instance's on "
                 f"{int((a != b).sum())} entries")
    t_c = device_timed(lambda: lemke_cuda.lemke_pivot_cuda(init, **kw),
                       device)
    t_g = device_timed(glob, device)
    say(f"K1 A/B {label} B={lanes} n={n}: global instance (private launcher) "
        f"equal to the cluster instance bit for bit; cluster {t_c * 1e3:.4f} "
        f"ms, global {t_g * 1e3:.4f} ms (median of {REPEATS}), global / "
        f"cluster {t_g / t_c:.2f} [{card}]")


def midsize_generic(device, say, card):
    """Phase 20 (c): the generic route at n=304 with the EG pre-pass in K2's
    cluster instance; then K2 against the plain loop, its host bits and the
    A/B with the global instance; (g) the forced stragglers at n=304, whose
    f64 re-pivot takes K1's global instance, and that instance against the
    plain loop on their lanes.  Returns (launches, compare_eg's (err, kernel
    s, plain s, bound), K1 global launches, compare_engines' (err, kernel s,
    plain s, bound) for K1's global instance)."""
    import numpy as np
    import torch
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import eg, eg_cuda, lemke_cuda
    from qpn_tpu_torch.ops.avi import batch_from_numpy, solve_avi_batch_adaptive
    from qpn_tpu_torch.utils.metrics import METRICS
    T, num_obj = MIDSIZE_GENERIC
    batch = scenario_batch_gavis(num_scenarios=S, T=T, num_obj=num_obj,
                                 num_poly_faces=FACES, seed=SEED)
    data = batch_from_numpy(batch)
    args = [data[k] for k in KEYS]
    B, n = data["q"].shape
    kw = dict(tol=SOLVE_TOL, mixed=True, onchip_eg_steps=EG_STEPS)
    METRICS.reset()
    t0 = time.perf_counter()
    res = solve_avi_batch_adaptive(*args, **kw)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = METRICS.launches[eg_cuda.KERNEL_CLUSTER]
    others = (METRICS.launches[eg_cuda.KERNEL]
              + METRICS.launches[eg_cuda.KERNEL_GLOBAL])
    accepted = int(METRICS.counters["eg_accepted_lanes"])
    escalated = int(METRICS.counters["escalated_lanes"])
    if launches < 1 or others != 0:
        fail(f"generic n={n}: {launches} launches of K2's cluster instance, "
             f"{others} of the others")
    z = res.z.cpu().numpy()
    conv = float(res.converged.double().mean())
    if z.shape != (B, n) or not np.isfinite(z).all() or conv != 1.0:
        fail(f"generic n={n}: z shape {z.shape}, conv {conv}")
    resid = numpy_audit(batch, z)
    if not resid.max() <= SOLVE_TOL:
        fail(f"generic n={n}, numpy audit: max natural residual "
             f"{resid.max()!r}")
    t_warm = timed(lambda: solve_avi_batch_adaptive(*args, **kw), device,
                   DOMAIN_REPEATS)
    _, ranks = eg_cuda.card_instance(n, device)
    say(f"midsize generic solve_avi_batch_adaptive S={B} T={T} "
        f"num_obj={num_obj} n={n} mixed=True onchip_eg_steps={EG_STEPS}: "
        f"conv {conv}, max resid {resid.max():.3g}, {launches} launch(es) "
        f"of {eg_cuda.KERNEL_CLUSTER} ({ranks} blocks a lane), EG accepted "
        f"on {accepted}/{B} lanes, "
        f"{escalated} escalated; {wall:.3f} s the first call, "
        f"{t_warm:.3f} s warm (median of {DOMAIN_REPEATS}), "
        f"{B / t_warm:.1f} solves/s [{card}]")
    p = eg.eg_prepare(*(a[:HOST_BIT_LANES] for a in args))
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    optin = eg_cuda.card_optin(device)
    if eg_cuda.host_instance(n, optin) != eg_cuda.EG_CLUSTER:
        fail(f"K2: n={n} does not take the cluster instance")
    zk = eg_cuda.eg_warmstart_cuda(*ins, 300)
    zh = eg_cuda.eg_steps_host(*(a.cpu() for a in ins), 300, optin=optin)
    host_bits("K2 cluster", [zk], [zh])
    say(f"K2 cluster n={n} on {ranks} blocks a lane: z after 300 steps equal "
        f"to the g++ host emulation's of {ranks} ranks bit for bit on "
        f"{HOST_BIT_LANES} lanes")
    eg_row = compare_eg(data, device, say, card, repeats=DOMAIN_REPEATS)
    issue, chain, stream = k2_cluster_floors(n, ranks, B, EG_STEPS)
    say(f"K2 cluster B={B} n={n} steps={EG_STEPS}: {eg_row[1] * 1e3:.4f} ms, "
        f"bound {eg_row[3][0]:.5f} ms by {eg_row[3][1]}, share "
        f"{eg_row[3][0] / (eg_row[1] * 1e3) * 100:.2f} %; computed floors: "
        f"f32 issue {issue:.3f} ms, chain {chain:.3f} ms, the first design's "
        f"band streamed from shared memory {stream:.3f} ms [{card}]")
    # the A/B: the global instance at the same shape, 20000 steps; it sums
    # every row in one chunk, the cluster instance in four
    p = eg.eg_prepare(*args)
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    zc = eg_cuda.eg_warmstart_cuda(*ins, EG_STEPS)
    zg = eg_cuda._launch(*ins, EG_STEPS, instance=eg_cuda.EG_GLOBAL)
    torch.cuda.synchronize(device)
    dz = float(((zc - zg).abs().amax(1) / (1.0 + zg.abs().amax(1))).max())
    if not dz <= EG_TOL[EG_STEPS]:
        fail(f"K2 A/B n={n}: the cluster instance's z differs from the "
             f"global instance's by {dz!r} of the lane scale")
    t_c = device_timed(lambda: eg_cuda.eg_warmstart_cuda(*ins, EG_STEPS),
                       device, DOMAIN_REPEATS)
    t_g = device_timed(lambda: eg_cuda._launch(
        *ins, EG_STEPS, instance=eg_cuda.EG_GLOBAL), device, DOMAIN_REPEATS)
    say(f"K2 A/B B={B} n={n} steps={EG_STEPS}: global instance (private "
        f"launcher) within {dz:.3g} of the lane scale of the cluster "
        f"instance (another partition of the sums; bound "
        f"{EG_TOL[EG_STEPS]}); cluster {t_c * 1e3:.4f} ms, global "
        f"{t_g * 1e3:.4f} ms (median of {DOMAIN_REPEATS}), global / cluster "
        f"{t_g / t_c:.2f} [{card}]")
    # (g) stragglers at n=304: f64 lanes past 8 ranks, K1's global instance
    lanes = 16
    forced_stragglers(data, batch, device, say, card, lanes=lanes,
                      kernel=lemke_cuda.KERNEL_GLOBAL)
    k1_global = METRICS.launches[lemke_cuda.KERNEL_GLOBAL]
    spread_launches(k1_global, METRICS.counters[lemke_cuda.GLOBAL_RANKS],
                    f"K1 f64 n={n} stragglers", say)
    if lemke_cuda.card_instance(n, 8, device)[0] != lemke_cuda.LANE_GLOBAL:
        fail(f"K1 f64 n={n} does not take the global instance")
    err, t_k, t_p, _, bnd = compare_engines(
        data, lanes, torch.float64, F64, lemke_cuda.lemke_pivot_cuda, device,
        DOMAIN_REPEATS)
    _, ranks = lemke_cuda.card_instance(n, 8, device, lanes=lanes)
    say(f"{lemke_cuda.KERNEL_GLOBAL} f64 B={lanes} n={n} on {ranks} blocks "
        f"a lane: status and pivots identical to the plain loop's, max |dz| "
        f"{err:.3g}; kernel {t_k * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms "
        f"(median of {DOMAIN_REPEATS}), bound {bnd[0]:.5f} ms by {bnd[1]} "
        f"[{card}]")
    k1_spread_ab(data, lanes, device, say, card)
    return launches, eg_row, k1_global, (err, t_k, t_p, bnd)


def spread_launches(launches, ranks_sum, label, say):
    """Fail unless at least one of a global instance's ``launches`` in a
    path ran at R > 1 (its ranks, summed over the launches, exceed their
    count)."""
    if not launches >= 1 or not ranks_sum > launches:
        fail(f"{label}: {launches} launch(es) of the global instance over "
             f"{ranks_sum:g} blocks a lane in all: none at R > 1")
    say(f"{label}: {launches} launch(es) of the global instance, "
        f"{ranks_sum / launches:g} blocks a lane on average")


def k1_spread_ab(data, lanes, device, say, card):
    """(g)'s A/B: K1's global instance at the ranks the wrapper picks for
    ``lanes`` f64 lanes against R = 1 through the private launcher, equal
    bit for bit and to the g++ emulation of those ranks on
    SPREAD_HOST_LANES lanes, both timed (median of DOMAIN_REPEATS launches
    between CUDA events)."""
    import torch
    from qpn_tpu_torch.ops import lemke, lemke_cuda
    M, q, l, u = (data[k][:lanes] for k in ("M", "q", "l", "u"))
    init = lemke.lemke_setup(*(a.double() for a in (M, q, l, u)),
                             torch.zeros_like(q, dtype=torch.float64),
                             data["mask"][:lanes], tol=F64["tol"])
    n = q.shape[1]
    _, ranks = lemke_cuda.card_instance(n, 8, device, lanes=lanes)

    def one():
        return lemke_cuda._launch(init, instance=lemke_cuda.LANE_GLOBAL,
                                  ranks=1, **F64)

    rs = lemke_cuda.lemke_pivot_cuda(init, **F64)
    r1 = one()
    torch.cuda.synchronize(device)
    for name, a, b in zip(rs._fields, rs, r1):
        if not torch.equal(a, b):
            fail(f"K1 spread A/B n={n}: {name} at {ranks} blocks a lane "
                 f"differs from R = 1's on {int((a != b).sum())} entries")
    k = SPREAD_HOST_LANES
    rh = lemke_cuda.lemke_pivot_host(
        lemke.LemkeInit(*(a[:k].cpu() for a in init)), ranks=ranks,
        optin=lemke_cuda.card_optin(device), **F64)
    host_bits(f"K1 global f64 n={n} at {ranks} ranks",
              [t[:k] for t in (rs.status, rs.piv, rs.basis, rs.val, rs.xB)],
              [rh.status, rh.piv, rh.basis, rh.val, rh.xB])
    t_1 = device_timed(one, device, DOMAIN_REPEATS)
    t_s = device_timed(lambda: lemke_cuda.lemke_pivot_cuda(init, **F64),
                       device, DOMAIN_REPEATS)
    say(f"K1 spread A/B f64 B={lanes} n={n}: the global instance at {ranks} "
        f"blocks a lane (picked) equal to R = 1 (private launcher) bit for "
        f"bit, and to the g++ emulation of {ranks} ranks on {k} lanes; "
        f"R = 1 {t_1 * 1e3:.4f} ms, spread {t_s * 1e3:.4f} ms (median of "
        f"{DOMAIN_REPEATS}), R = 1 / spread {t_1 / t_s:.2f} [{card}]")


def k2_spread_ab(data, device, say, card):
    """(h)'s A/B: K2's global instance at the ranks the wrapper picks
    against R = 1 through the private launcher at EG_STEPS steps, equal bit
    for bit, both timed (median of DOMAIN_REPEATS); the picked ranks
    against the g++ emulation at 300 steps on SPREAD_HOST_LANES lanes; a
    grid too large to be resident raises for both kernels, and the next
    launches run."""
    import torch
    from qpn_tpu_torch.ops import eg, eg_cuda, lemke_cuda
    from qpn_tpu_torch.utils.metrics import METRICS
    p = eg.eg_prepare(*(data[k] for k in KEYS))
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    B, n = p.q.shape
    _, ranks = eg_cuda.card_instance(n, device, lanes=B)
    k = SPREAD_HOST_LANES
    zk = eg_cuda.eg_warmstart_cuda(*(a[:k] for a in ins), 300)
    _, ranks_k = eg_cuda.card_instance(n, device, lanes=k)
    zh = eg_cuda.eg_steps_host(*(a[:k].cpu() for a in ins), 300,
                               optin=eg_cuda.card_optin(device),
                               ranks=ranks_k)
    host_bits(f"K2 global n={n} at {ranks_k} ranks", [zk], [zh])

    def one():
        return eg_cuda._launch(*ins, EG_STEPS, instance=eg_cuda.EG_GLOBAL,
                               ranks=1)

    zs = eg_cuda.eg_warmstart_cuda(*ins, EG_STEPS)
    z1 = one()
    torch.cuda.synchronize(device)
    if not torch.equal(zs, z1):
        fail(f"K2 spread A/B n={n}: z at {ranks} blocks a lane differs from "
             f"R = 1's on {int((zs != z1).sum())} entries")
    t_1 = device_timed(one, device, DOMAIN_REPEATS)
    t_s = device_timed(lambda: eg_cuda.eg_warmstart_cuda(*ins, EG_STEPS),
                       device, DOMAIN_REPEATS)
    say(f"K2 spread A/B B={B} n={n} steps={EG_STEPS}: the global instance at "
        f"{ranks} blocks a lane (picked) equal to R = 1 (private launcher) "
        f"bit for bit, and at 300 steps to the g++ emulation of {ranks_k} "
        f"ranks on {k} lanes; R = 1 {t_1 * 1e3:.4f} ms, spread "
        f"{t_s * 1e3:.4f} ms (median of {DOMAIN_REPEATS}), R = 1 / spread "
        f"{t_1 / t_s:.2f} [{card}]")
    # a refused cooperative launch raises, and nothing else runs instead
    from qpn_tpu_torch.ops import lemke
    init = lemke.lemke_setup(*(data[key][:2].float() for key in
                               ("M", "q", "l", "u", "z0")),
                             data["mask"][:2], tol=HOT["tol"])
    METRICS.reset()
    messages = {}
    for name, refused in (
            ("K1", lambda: lemke_cuda._launch(
                init, instance=lemke_cuda.LANE_GLOBAL, ranks=REFUSED_RANKS,
                **HOT)),
            ("K2", lambda: eg_cuda._launch(
                *(a[:2] for a in ins), 10, instance=eg_cuda.EG_GLOBAL,
                ranks=REFUSED_RANKS))):
        try:
            refused()
        except RuntimeError as e:
            messages[name] = str(e)
        else:
            fail(f"{name}: a spread global grid of 2 x {REFUSED_RANKS} "
                 "blocks was not refused")
        if COOPERATIVE_REFUSAL not in messages[name]:
            fail(f"{name}: the launch of 2 x {REFUSED_RANKS} blocks raised "
                 f"for another reason than a refused cooperative launch: "
                 f"{messages[name]}")
    torch.cuda.synchronize(device)
    if sum(METRICS.launches.values()) != 0:
        fail(f"refused launches counted {dict(METRICS.launches)}")
    eg_cuda.eg_warmstart_cuda(*(a[:2] for a in ins), 10)
    lemke_cuda.lemke_pivot_cuda(init, **HOT)
    torch.cuda.synchronize(device)
    say(f"refused cooperative launches at {REFUSED_RANKS} blocks a lane: "
        f"K1 raised ({messages['K1']}), K2 raised ({messages['K2']}); the "
        f"next launches ran ({dict(METRICS.launches)})")


def generic_route(lanes, device, say, card):
    """The generic route of (h) on ``lanes`` lanes of LARGE_GENERIC's model,
    past K2's cluster reach, where its EG pre-pass takes the global
    instance; every lane certified and audited in numpy.  Returns (the
    global instance's launches, their ranks summed, the batch's tensors)."""
    import numpy as np
    import torch
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import eg_cuda
    from qpn_tpu_torch.ops.avi import batch_from_numpy, solve_avi_batch_adaptive
    from qpn_tpu_torch.utils.metrics import METRICS
    _, T, num_obj = LARGE_GENERIC
    batch = scenario_batch_gavis(num_scenarios=lanes, T=T, num_obj=num_obj,
                                 num_poly_faces=FACES, seed=SEED)
    data = batch_from_numpy(batch)
    B, n = data["q"].shape
    METRICS.reset()
    t0 = time.perf_counter()
    res = solve_avi_batch_adaptive(*(data[k] for k in KEYS), tol=SOLVE_TOL,
                                   mixed=True, onchip_eg_steps=EG_STEPS)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = METRICS.launches[eg_cuda.KERNEL_GLOBAL]
    ranks = METRICS.counters[eg_cuda.GLOBAL_RANKS]
    others = (METRICS.launches[eg_cuda.KERNEL]
              + METRICS.launches[eg_cuda.KERNEL_CLUSTER])
    if launches < 1 or others != 0:
        fail(f"generic n={n}: {launches} launches of K2's global instance, "
             f"{others} of the others")
    z = res.z.cpu().numpy()
    conv = float(res.converged.double().mean())
    if z.shape != (B, n) or not np.isfinite(z).all() or conv != 1.0:
        fail(f"generic n={n}: z shape {z.shape}, conv {conv}")
    resid = numpy_audit(batch, z)
    if not resid.max() <= SOLVE_TOL:
        fail(f"generic n={n}, numpy audit: max natural residual "
             f"{resid.max()!r}")
    say(f"large generic solve_avi_batch_adaptive S={B} T={T} "
        f"num_obj={num_obj} n={n}: conv {conv}, max resid "
        f"{resid.max():.3g}, {launches} launch(es) of "
        f"{eg_cuda.KERNEL_GLOBAL} over {ranks / launches:g} blocks a lane, "
        f"EG accepted on {int(METRICS.counters['eg_accepted_lanes'])}/{B} "
        f"lanes, {int(METRICS.counters['escalated_lanes'])} escalated; "
        f"{wall:.3f} s the first call [{card}]")
    return launches, ranks, data


def large_generic(device, say, card):
    """Phase 20 (h): the generic route past K2's cluster reach on the
    ensemble's whole batch, where the lanes fill the card and K2's global
    instance runs one block a lane (R = 1) from the column-major copy of M;
    its bits against the g++ emulation on a few lanes, and that instance
    against the plain loop on the same lanes, beside the streaming floor.  Then the route on a few lanes, which the instance
    spreads over many SMs, and its A/B.  Returns (its launches in the
    whole batch's route, compare_eg's (err, kernel s, plain s, bound))."""
    from qpn_tpu_torch.ops import eg, eg_cuda
    S = LARGE_GENERIC[0]
    launches, ranks, data = generic_route(S, device, say, card)
    B, n = data["q"].shape
    if eg_cuda.card_instance(n, device, lanes=B) != (eg_cuda.EG_GLOBAL, 1) \
            or ranks != launches:
        fail(f"K2 n={n} on {B} lanes: not the global instance at R = 1 "
             f"({ranks:g} blocks a lane over {launches} launch(es))")
    p = eg.eg_prepare(*(data[k] for k in KEYS))
    ins = (p.M, p.q, p.l, p.u, p.z0, p.tau)
    k = SPREAD_HOST_LANES
    zk = eg_cuda.eg_warmstart_cuda(*ins, 300)
    zh = eg_cuda.eg_steps_host(*(a[:k].cpu() for a in ins), 300,
                               optin=eg_cuda.card_optin(device), ranks=1)
    host_bits(f"K2 global n={n} on {B} lanes at R = 1", [zk[:k]], [zh])
    say(f"K2 global n={n} on {B} lanes at R = 1: z after 300 steps equal to "
        f"the g++ host emulation's of one block a lane bit for bit on {k} "
        f"lanes")
    row = compare_eg(data, device, say, card, repeats=DOMAIN_REPEATS)
    from qpn_tpu_torch.utils.flops import H100_HBM_BYTES_S
    floor = 4.0 * B * n * n * 2 * EG_STEPS / H100_HBM_BYTES_S
    say(f"K2 global B={B} n={n} at R = 1: {row[1] * 1e3:.4f} ms against a "
        f"floor of {floor * 1e3:.4f} ms for streaming M from device memory "
        f"every half-step ({B * n * n * 4:.4g} bytes, {2 * EG_STEPS} "
        f"half-steps, at {H100_HBM_BYTES_S:.4g} B/s) [{card}]")
    few, ranks, data = generic_route(LARGE_GENERIC_FEW, device, say, card)
    spread_launches(few, ranks,
                    f"K2 generic route n={n} on {LARGE_GENERIC_FEW} lanes",
                    say)
    k2_spread_ab(data, device, say, card)
    return launches, row


def screen_entry(polys, truth, label, device, say, card):
    """is_empty_batch with the screen on for polyhedra past a block's
    shared memory: the verdicts the truth, the launches of each K3
    instance.  Returns them."""
    import numpy as np
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.geometry import is_empty_batch
    from qpn_tpu_torch.geometry.query_cache import CACHE
    from qpn_tpu_torch.ops import screen_cuda
    from qpn_tpu_torch.utils.metrics import METRICS
    B, m, n = len(polys), polys[0].m, polys[0].dim
    CONFIG.use_screen = True
    try:
        CACHE.clear()
        METRICS.reset()
        t0 = time.perf_counter()
        verdict = is_empty_batch(polys)
        wall = time.perf_counter() - t0
        launches = {k: METRICS.launches[k] for k in (
            screen_cuda.KERNEL, screen_cuda.KERNEL_CLUSTER,
            screen_cuda.KERNEL_GLOBAL)}
        witnessed = int(METRICS.counters["screen_witnessed"])
        lps = int(METRICS.counters["lp_host"])
    finally:
        CONFIG.use_screen = None
        CACHE.clear()
    if not np.array_equal(verdict, truth):
        fail(f"is_empty_batch {m} x {n}: {int((verdict != truth).sum())} "
             "verdicts differ from the truth")
    say(f"geometry is_empty_batch B={B} m={m} n={n} ({label}): verdicts the "
        f"truth ({int(truth.sum())} empty), K3 launches {launches}, "
        f"{witnessed} witnessed, {lps} host LPs, {wall:.3f} s [{card}]")
    return launches


def k3_host_bits(ins, label, say):
    """K3 on the card (the instance the wrapper picks) against the bits of
    its g++ host build under the card's limit (the cluster's ranks
    emulated).  Fails where x stays at its start on some polyhedron: there
    every step's sums would be of zeros, and the bits would check none."""
    from qpn_tpu_torch.ops import screen_cuda
    device = ins[0].device
    instance, ranks = screen_cuda.card_instance(*ins[0].shape[1:], device)
    xk, vk = screen_cuda.feasibility_screen_cuda(*ins, SCREEN_STEPS,
                                                 SCREEN_LR)
    xh, vh = screen_cuda.screen_steps_host(
        *(a.cpu() for a in ins), SCREEN_STEPS, SCREEN_LR,
        optin=screen_cuda.card_optin(device))
    host_bits(f"K3 {label}", [xk, vk], [xh, vh])
    moved = (xk != ins[3]).any(1)
    if not bool(moved.all()):
        fail(f"K3 {label}: x stayed at its start on "
             f"{int((~moved).sum())} of {len(moved)} polyhedra")
    say(f"K3 {label} {tuple(ins[0].shape)} (instance {instance}, {ranks} "
        f"block(s) a polyhedron): x moved on every polyhedron, x and max "
        f"|v| equal to the g++ host instance's bit for bit")


def k3_ab(polys, device, say, card):
    """The A/B of phase 20 (d): K3's cluster instance, as the wrapper picks
    it, against the global instance through the private launcher on the
    same inputs: the same bits, both timed (median of REPEATS launches
    between CUDA events).  Returns (cluster s, global s)."""
    import torch
    from qpn_tpu_torch.ops import screen, screen_cuda
    ins = [torch.as_tensor(a, device=device)
           for a in screen.screen_prepare(polys)]
    B, m, n = ins[0].shape
    instance, ranks = screen_cuda.card_instance(m, n, device)
    if instance != screen_cuda.SCREEN_CLUSTER:
        fail(f"K3 A/B: {m} x {n} does not take the cluster instance")

    def cluster():
        return screen_cuda.feasibility_screen_cuda(*ins, SCREEN_STEPS,
                                                   SCREEN_LR)

    def glob():
        return screen_cuda._launch_global(*ins, SCREEN_STEPS, SCREEN_LR)

    (xc, vc), (xg, vg) = cluster(), glob()
    torch.cuda.synchronize(device)
    if not (torch.equal(xc, xg) and torch.equal(vc, vg)):
        fail(f"K3 A/B B={B} m={m} n={n}: the global instance differs from "
             f"the cluster instance on {int((xc != xg).sum())} entries of x, "
             f"{int((vc != vg).sum())} of max |v|")
    t_c = device_timed(cluster, device)
    t_g = device_timed(glob, device)
    say(f"K3 A/B B={B} m={m} n={n}: global instance (private launcher) "
        f"equal to the cluster instance ({ranks} blocks a polyhedron) bit "
        f"for bit; cluster {t_c * 1e3:.4f} ms, global {t_g * 1e3:.4f} ms "
        f"(median of {REPEATS}), global / cluster {t_g / t_c:.2f} [{card}]")
    return t_c, t_g


def midsize_screen(device, say, card):
    """Phase 20 (d): is_empty_batch on polyhedra past a block's shared
    memory in K3's cluster instance, K3 against its host bits and the plain
    loop, the A/B against the global instance at B = 4 and 128; then the
    global instance past the cluster's reach.  Returns the cluster's and
    the global instance's (launches, compare_screen's result)."""
    import torch
    from qpn_tpu_torch.ops import screen, screen_cuda
    B, m, n = DOMAIN_SCREEN_B, DOMAIN_SCREEN_M, DOMAIN_SCREEN_N
    polys, truth = screen_batch(B, m, n, SEED, centre=0.0)
    launches = screen_entry(polys, truth, "cluster", device, say, card)
    if (launches[screen_cuda.KERNEL_CLUSTER] < 1
            or sum(launches.values()) != launches[screen_cuda.KERNEL_CLUSTER]):
        fail(f"is_empty_batch {m} x {n}: K3 launches {launches}, expected "
             "the cluster instance's alone")
    # the bits, the plain loop and the A/B on polyhedra off the origin,
    # where x moves on all of them (centred on it, x stays at the start on
    # the nonempty ones, and the empty ones' two rows cancel)
    polys, truth = screen_batch(B, m, n, SEED + 1)
    k3_host_bits([torch.as_tensor(a, device=device)
                  for a in screen.screen_prepare(polys)], "cluster", say)
    cluster = compare_screen(polys, truth, device, say, card,
                             "cluster instance")
    for ab in (B, SCREEN_AB_B):
        k3_ab(screen_batch(ab, m, n, SEED + 1)[0], device, say, card)
    # past the cluster's reach: the main path on polyhedra the screen
    # witnesses at its start (no host LP), then the comparisons on polyhedra
    # off the origin
    B, m, n = DOMAIN_SCREEN_B, *SCREEN_GLOBAL_MN
    polys, truth = screen_batch(B, m, n, SEED, centre=0.0, empty=False)
    glaunches = screen_entry(polys, truth, "global", device, say, card)
    if (glaunches[screen_cuda.KERNEL_GLOBAL] < 1
            or sum(glaunches.values()) != glaunches[screen_cuda.KERNEL_GLOBAL]):
        fail(f"is_empty_batch {m} x {n}: K3 launches {glaunches}, expected "
             "the global instance's alone")
    polys, truth = screen_batch(B, m, n, SEED)
    k3_host_bits([torch.as_tensor(a, device=device)
                  for a in screen.screen_prepare(polys)], "global", say)
    glob = compare_screen(polys, truth, device, say, card,
                          "past the cluster's reach")
    return ((launches[screen_cuda.KERNEL_CLUSTER], cluster),
            (glaunches[screen_cuda.KERNEL_GLOBAL], glob))


def domain_phase(device, say, card):
    """Phase 20: the kernels' instances for lanes past a block's shared
    memory on the normal entry points.  Returns the kernel rows of the JSON
    line: K1, K2 and K3 cluster and global."""
    import torch
    from qpn_tpu_torch.ops import eg_cuda, lemke_cuda, screen_cuda
    rows = {}
    for i, (T, num_obj) in enumerate(MIDSIZE):
        last = i == len(MIDSIZE) - 1
        launches, data, batch, eng = midsize_kkt(T, num_obj, device, say,
                                                 card, DOMAIN_REPEATS)
        if i == 0:
            # (b) the forced stragglers at n=152, in the cluster f64 instance
            forced_stragglers(data, batch, device, say, card,
                              kernel=lemke_cuda.KERNEL_CLUSTER)
            err64, t_k64, t_p64, _, _ = compare_engines(
                data, 16, torch.float64, F64, lemke_cuda.lemke_pivot_cuda,
                device, DOMAIN_REPEATS)
            say(f"lemke_pivot_cluster f64 B=16 n={data['q'].shape[1]}: "
                f"status and pivots identical, max |dz| {err64:.3g}; kernel "
                f"{t_k64 * 1e3:.4f} ms, plain {t_p64 * 1e3:.4f} ms [{card}]")
            k1_host_bits(data, torch.float64, F64, say, "f64")
            k1_ab(data, 16, torch.float64, F64, device, say, card, "f64")
        if last:
            k1_host_bits(data, torch.float32, HOT, say, "f32")
            err, t_k, t_p, _, bnd = eng
            k1_ab(data, S, torch.float32, HOT, device, say, card, "f32")
            rows["k1c"] = (lemke_cuda.KERNEL_CLUSTER, launches, err, t_k, t_p,
                           bnd)
    launches, k2c, k1_global, k1g = midsize_generic(device, say, card)
    # each global row: launches, error and times at the shape it launches at
    # on the path, (g) and (h)
    rows["k1g"] = (lemke_cuda.KERNEL_GLOBAL, k1_global, *k1g)
    rows["k2c"] = (eg_cuda.KERNEL_CLUSTER, launches, *k2c)
    launches, k2g = large_generic(device, say, card)
    rows["k2g"] = (eg_cuda.KERNEL_GLOBAL, launches, *k2g)
    (lc, k3c), (lg, k3g) = midsize_screen(device, say, card)
    rows["k3c"] = (screen_cuda.KERNEL_CLUSTER, lc, *k3c)
    rows["k3g"] = (screen_cuda.KERNEL_GLOBAL, lg, *k3g)
    sources = {"k1": ("qpn_tpu_torch/csrc/lemke_pivot.cu",
                      "qpn_tpu/ops/lemke_pallas.py:118"),
               "k2": ("qpn_tpu_torch/csrc/eg_warmstart.cu",
                      "qpn_tpu/ops/pallas_kernels.py:57"),
               "k3": ("qpn_tpu_torch/csrc/screen.cu",
                      "qpn_tpu/ops/pallas_kernels.py:205")}
    return [kernel_row(name, *sources[key[:2]], launches, err, t_k, t_p, bnd)
            for key, (name, launches, err, t_k, t_p, bnd) in rows.items()]


def first_hop(args, dtype):
    """The inputs of ``solve_avi_batch``'s first extragradient hop in
    ``dtype`` (a tolerance below rounding, so that every lane hops),
    recorded where they lie: the scaled problem and the Newton polish's
    iterate.  ``args``: M, q, l, u, z0 and mask of the lanes."""
    import torch
    from qpn_tpu_torch.ops import avi
    seen = []
    real = avi._hop_engine

    def record(device):
        def hop(*a):
            seen.append(tuple(t.clone() if torch.is_tensor(t) else t
                              for t in a))
            return avi._eg_phase(*a)
        return hop
    avi._hop_engine = record
    try:
        avi.solve_avi_batch(*(a.to(dtype) for a in args[:5]), args[5],
                            tol=1e-300, max_iter=130)
    finally:
        avi._hop_engine = real
    return seen[0][:-1]


def same_bits(a, b) -> bool:
    """Equal values, and NaN where the other has NaN (the card and the host
    write NaNs of other signs and payloads)."""
    import torch
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, 0.0), torch.nan_to_num(b, 0.0)))


def cell_pool(cell, device):
    """The benchmark cell's pool as its route takes it: (M, q, l, u, z0,
    mask, mix), q and l by ensemble."""
    from pathlib import Path
    import numpy as np
    import torch
    from qpnbench import traffic
    from qpnbench.harness import Bench, on_device
    bench = Bench(Path(HERE))
    _, _, mix, config = bench.cell(cell)
    model = bench.module("models", config["model"])
    sys_ = model.assemble(config)
    n, S = sys_.M.shape[0], mix["lanes"]
    draws = traffic.draw_pool(mix, sys_.shifted, n)
    lanes = on_device(model.lanes(sys_, draws.shift, draws.jitter), device)
    f64 = torch.float64
    M = torch.as_tensor(np.asarray(sys_.M), dtype=f64,
                        device=device).expand(S, n, n).contiguous()
    return (M, lanes["q"], lanes["l"], lanes["u"],
            torch.zeros(S, n, dtype=f64, device=device),
            torch.ones(S, n, dtype=torch.bool, device=device), mix)


def hop_phase(data, device, say, card):
    """Phase 21 (the file's notes).  Returns the kernels line's rows."""
    import numpy as np
    import torch
    from qpn_tpu_torch.ops import avi, hop_cuda
    from qpn_tpu_torch.ops.avi import solve_avi_batch_adaptive
    from qpn_tpu_torch.utils.metrics import METRICS
    args = [data[k] for k in KEYS]
    found = []
    for dtype in (torch.float32, torch.float64):
        ins = first_hop(args, dtype)
        B, n = ins[5].shape
        got = hop_cuda.hybrid_hop_cuda(*ins, HOP_STEPS)
        want = avi._eg_phase(*ins, HOP_STEPS)
        torch.cuda.synchronize(device)
        scale = 1.0 + ins[5].abs().amax(1)
        ez = float(((got[0] - want[0]).abs().amax(1) / scale).max())

        def phi_err(a, b):
            # ||Phi|| of two merits 1/2 ||Phi||^2, relative to the scale
            return float(((2 * a).sqrt() - (2 * b).sqrt()).abs().div(scale)
                         .max())
        ephi = phi_err(got[2], want[2])
        # the best z by its merit: where merits tie to rounding, the two
        # orders of sums keep different iterates
        ebest = phi_err(*(avi._merit(*ins[:4], z)[0]
                          for z in (got[1], want[1])))
        tol = HOP_TOL[str(dtype)]
        if not (ez <= tol and ephi <= tol and ebest <= tol):
            fail(f"hop kernel {dtype}: z differs by {ez!r}, ||Phi|| of the "
                 f"best merit by {ephi!r}, of the best z's merit by "
                 f"{ebest!r} of the lane scale, bound {tol}")
        few = [a[:HOST_BIT_LANES].contiguous() for a in ins]
        for inst in (hop_cuda.HOP_REGISTER, hop_cuda.HOP_SHARED,
                     hop_cuda.HOP_GLOBAL):
            k = hop_cuda._launch(*few, HOP_STEPS, instance=inst)
            h = hop_cuda.hybrid_hop_host(*(a.cpu() for a in few), HOP_STEPS,
                                         instance=inst)
            if not all(same_bits(a.cpu(), b) for a, b in zip(k, h)):
                fail(f"hop kernel {dtype}: instance {inst} differs from its "
                     "host bits")
        pick = hop_cuda.card_instance(n, dtype, device)
        t_k = device_timed(lambda: hop_cuda.hybrid_hop_cuda(*ins, HOP_STEPS),
                           device)
        t_p = device_timed(lambda: avi._eg_phase(*ins, HOP_STEPS), device)
        busy_k = busy_seconds(lambda: hop_cuda.hybrid_hop_cuda(
            *ins, HOP_STEPS), device)
        busy_p = busy_seconds(lambda: avi._eg_phase(*ins, HOP_STEPS), device)
        bnd = hop_bound(ins, got, HOP_STEPS)
        found.append((dtype, float((got[0] - want[0]).abs().max()), t_k, t_p,
                      bnd))
        say(f"hybrid_hop {dtype} B={B} n={n} steps={HOP_STEPS}: instance "
            f"{pick}, z within {ez:.3g}, ||Phi|| of the best merit within "
            f"{ephi:.3g} and of the best z's merit within {ebest:.3g} of the "
            f"lane scale (<= {tol}); the instances equal to their host bits "
            f"on {HOST_BIT_LANES} lanes; kernel {t_k * 1e3:.4f} ms, plain "
            f"loop {t_p * 1e3:.4f} ms (median of {REPEATS}); device busy "
            f"{busy_k * 1e3:.4f} ms and {busy_p * 1e3:.4f} ms (profiler); "
            f"bound {bnd[0]:.5f} ms by {bnd[1]} [{card}]")

    # the generic route on the benchmark cell's pool
    M, q, l, u, z0, mask, mix = cell_pool(HOP_CELL, device)
    kw = dict(tol=mix["tol"], onchip_eg_steps=mix["onchip_eg_steps"])

    def one_pass():
        return [solve_avi_batch_adaptive(M, q[e], l[e], u, z0, mask, **kw)
                for e in range(mix["pool"])]
    rounds = []
    real = hop_cuda.hybrid_hop_cuda

    def counted(*a):
        rounds.append(a[0].shape[0])
        return real(*a)
    hop_cuda.hybrid_hop_cuda = counted
    METRICS.reset()
    try:
        results = one_pass()
        torch.cuda.synchronize(device)
    finally:
        hop_cuda.hybrid_hop_cuda = real
    launches = METRICS.launches[hop_cuda.KERNEL]
    c = METRICS.counters
    if not rounds or launches != len(rounds) or not (
            c["hop_lanes"] == c["hop_fused_lanes"] == sum(rounds)):
        fail(f"generic route on {HOP_CELL}'s pool: {len(rounds)} hops, "
             f"{launches} hop kernel launches, hop lanes {c['hop_lanes']}, "
             f"fused {c['hop_fused_lanes']}")
    worst = max(float(r.resid.max()) for r in results)
    conv = all(bool(r.converged.all()) for r in results)
    if not (conv and worst <= mix["tol"]):
        fail(f"generic route on {HOP_CELL}'s pool: conv {conv}, max resid "
             f"{worst!r}")
    t_kernel = timed(one_pass, device, 3)
    real_engine = avi._hop_engine
    avi._hop_engine = lambda device: avi._eg_phase
    try:
        t_plain = timed(one_pass, device, 3)
    finally:
        avi._hop_engine = real_engine
    lanes = mix["pool"] * mix["lanes"]
    say(f"generic route on {HOP_CELL}'s pool ({mix['pool']} ensembles of "
        f"{mix['lanes']}): every lane certified, max resid {worst:.3g}; "
        f"{launches} hop kernel launches for {len(rounds)} rounds, "
        f"{int(sum(rounds))} hop lanes (median {np.median(rounds):.0f} a "
        f"hop); a pass {t_kernel:.3f} s with the hop kernel "
        f"({lanes / t_kernel:.1f} solves/s), {t_plain:.3f} s with the plain "
        f"hop ({lanes / t_plain:.1f} solves/s), median of 3 [{card}]")
    return [kernel_row(f"{hop_cuda.KERNEL} {dtype}",
                       "qpn_tpu_torch/csrc/hybrid_hop.cu", None, launches,
                       err, t_k, t_p, bnd)
            for dtype, err, t_k, t_p, bnd in found]


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "qpn_tpu_torch")):
        fail("the qpn_tpu_torch package is not next to chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    from qpn_tpu_torch.config import CONFIG
    if CONFIG.device != "cuda":
        fail(f"the port's default device is {CONFIG.device!r}, not the card")
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpn_tpu_torch.ops import eg_cuda, lemke_cuda, screen_cuda
    from qpn_tpu_torch.ops.avi import (batch_from_numpy,
                                       solve_avi_batch_adaptive,
                                       solve_kkt_avi_batch)
    from qpn_tpu_torch.utils import native
    from qpn_tpu_torch.utils.metrics import METRICS

    say = Clock()

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    say(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    print(card)

    # 2. build: one nvcc for each source and g++ for the native host
    # library, started together
    with ThreadPoolExecutor(4) as pool:
        builds = {name: pool.submit(timed_build, build) for name, build in (
            ("csrc/lemke_pivot.cu", lemke_cuda.build),
            ("csrc/eg_warmstart.cu", eg_cuda.build),
            ("csrc/screen.cu", screen_cuda.build),
            ("csrc/qpn_host.cpp", native.library_path))}
        secs = {name: f.result() for name, f in builds.items()}
    say("build: " + ", ".join(f"{name} in {t:.1f} s"
                              for name, t in secs.items()))

    # 3. ensemble
    batch = scenario_batch_gavis(num_scenarios=S, T=T_STEPS, num_obj=NUM_OBJ,
                                 num_poly_faces=FACES, seed=SEED)
    data = batch_from_numpy(batch)      # on CONFIG.device: the card
    if data["M"].device.type != "cuda":
        fail(f"batch_from_numpy put the ensemble on {data['M'].device}")
    B, n = data["q"].shape
    say(f"ensemble: robust_avoid S={B} T={T_STEPS} num_obj={NUM_OBJ} "
          f"n={n} structure={data['structure']}")

    # 4. kernel vs plain, f32, all lanes
    err32, t_k32, t_p32, r32, bound32 = compare_engines(
        data, B, torch.float32, HOT, lemke_cuda.lemke_pivot_cuda, device)
    piv = r32.piv.double() + 1
    say(f"lemke_pivot f32 B={B} n={n}: status and pivots identical on all "
          f"lanes (pivots {int(piv.min())}-{int(piv.max())}, median "
          f"{float(piv.median()):.0f}), max |dz| {err32:.3g} <= {Z_TOL}; "
          f"kernel {t_k32 * 1e3:.4f} ms, plain {t_p32 * 1e3:.4f} ms "
          f"(median of {REPEATS}), bound {bound32[0]:.5f} ms by "
          f"{bound32[1]} [{card}]")

    # 5. kernel vs plain, f64 instance
    err64, t_k64, t_p64, _, _ = compare_engines(
        data, 16, torch.float64, F64, lemke_cuda.lemke_pivot_cuda, device)
    say(f"lemke_pivot f64 B=16 n={n}: status and pivots identical, max "
          f"|dz| {err64:.3g}; kernel {t_k64 * 1e3:.4f} ms, plain "
          f"{t_p64 * 1e3:.4f} ms [{card}]")

    # 6. main path
    args = (data["M"], data["q"], data["l"], data["u"], data["mask"],
            data["structure"])
    METRICS.reset()
    res = solve_kkt_avi_batch(*args, tol=SOLVE_TOL)
    torch.cuda.synchronize(device)
    z_kkt = res.z
    launches = METRICS.launches[lemke_cuda.KERNEL]
    uncertified = METRICS.counters["kkt_uncertified_lanes"]
    if launches < 1:
        fail("the main path did not launch the lemke_pivot kernel")
    if (METRICS.launches[lemke_cuda.KERNEL_GLOBAL]
            + METRICS.launches[lemke_cuda.KERNEL_CLUSTER]) != 0:
        fail("the flagship's lanes took K1's cluster or global instance")
    z = res.z.cpu().numpy()
    conv = float(res.converged.double().mean())
    if z.shape != (B, n) or not np.isfinite(z).all():
        fail(f"z has shape {z.shape} or non-finite values")
    if conv != 1.0 or uncertified != 0:
        fail(f"conv {conv}, {uncertified} uncertified lanes")
    resid = numpy_audit(batch, z)
    if not resid.max() <= SOLVE_TOL:
        fail(f"numpy audit: max natural residual {resid.max()!r}")
    # small-input reference: the port's CPU path (plain loop) on 8 lanes
    cpu = batch_from_numpy({k: v[:8] if k != "structure" else v
                            for k, v in batch.items()}, "cpu")
    ref = solve_kkt_avi_batch(cpu["M"], cpu["q"], cpu["l"], cpu["u"],
                              cpu["mask"], cpu["structure"], tol=SOLVE_TOL)
    same = ref.iters.numpy() == res.iters[:8].cpu().numpy()
    dz = np.abs(ref.z.numpy() - z[:8])[same]
    if not same.any() or not dz.max() <= Z_TOL:
        fail(f"CPU reference: {same.sum()}/8 lanes with equal pivots, "
             f"max |dz| {dz.max() if dz.size else None}")
    t_kernel = timed(lambda: solve_kkt_avi_batch(*args, tol=SOLVE_TOL),
                     device)
    CONFIG.lemke_kernel = "torch"
    try:
        t_plain = timed(lambda: solve_kkt_avi_batch(*args, tol=SOLVE_TOL),
                        device)
    finally:
        CONFIG.lemke_kernel = "auto"
    say(f"main path solve_kkt_avi_batch S={B} tol={SOLVE_TOL}: conv "
          f"{conv}, max resid {resid.max():.3g}, {launches} kernel "
          f"launch(es), {int(uncertified)} uncertified; "
          f"{B / t_kernel:.1f} solves/s with the kernel "
          f"({t_kernel * 1e3:.3f} ms), {B / t_plain:.1f} solves/s with the "
          f"plain loop ({t_plain * 1e3:.3f} ms); CPU reference z within "
          f"{dz.max():.3g} on {int(same.sum())}/8 lanes [{card}]")

    # 7. extragradient kernel vs plain loop
    eg_err, t_eg, t_eg_plain, eg_bnd = compare_eg(data, device, say, card)

    # 8. the generic main path
    eg_launches = generic_path(data, batch, device, z_kkt, say, card)

    # 9. forced stragglers through lemke_escalate
    forced_stragglers(data, batch, device, say, card)

    # 10. feasibility screen kernel vs plain loop
    polys, truth = screen_batch(SCREEN_B, SCREEN_M, SCREEN_N, SEED)
    say(f"screen batch: {SCREEN_B} seeded polyhedra, dimension {SCREEN_N}, "
        f"{SCREEN_M} rows, {int(truth.sum())} empty by construction")
    scr_err, t_scr, t_scr_plain, scr_bnd = compare_screen(
        polys, truth, device, say, card, "seeded")

    # 11. the geometry entry point
    scr_launches = geometry_entry(polys, truth, device, say, card)

    # 12. solve() end to end, then the screen on robust_avoid's pieces
    pieces, ra_card = solve_zoo(device, say, card)
    compare_screen([p.closure() for p in pieces], None, device, say, card,
                   "robust_avoid solution-graph closures")

    # 13. the shared-matrix route at its design scale
    big, res_large = shared_large(data, z_kkt, device, say, card)

    # 14. the hard seed: the ADMM rung on the card, three repeats
    shared_hard(device, say, card)

    # 15. lockstep ensembles: the scenarios' batched calls fused
    lockstep_phase(device, say, card)

    # 16. the banded x-update against the dense one
    banded_phase(device, say, card)

    # 17. checkpoint and resume; the process pool from this parent
    checkpoint_phase(ra_card, device, say, card)

    # 18. the multi-device layer: one rank over NCCL, two gloo ranks
    multi_device_phase(batch, data, big, res_large, device, say, card)

    # 19. the six models outside the zoo, on the card and on the CPU
    solve_rest(device, say, card)

    # 20. lanes past shared memory: each kernel's global instance
    domain_rows = domain_phase(device, say, card)

    # 21. the hybrid hop kernel, and the generic route on the cell's pool
    hop_rows = hop_phase(data, device, say, card)

    if CONFIG.device != "cuda":
        fail(f"CONFIG.device was left at {CONFIG.device!r}")
    print(json.dumps({"kernels": [
        kernel_row(lemke_cuda.KERNEL, "qpn_tpu_torch/csrc/lemke_pivot.cu",
                   "qpn_tpu/ops/lemke_pallas.py:118", launches, err32, t_k32,
                   t_p32, bound32),
        kernel_row(eg_cuda.KERNEL, "qpn_tpu_torch/csrc/eg_warmstart.cu",
                   "qpn_tpu/ops/pallas_kernels.py:57", eg_launches, eg_err,
                   t_eg, t_eg_plain, eg_bnd),
        kernel_row(screen_cuda.KERNEL, "qpn_tpu_torch/csrc/screen.cu",
                   "qpn_tpu/ops/pallas_kernels.py:205", scr_launches,
                   scr_err, t_scr, t_scr_plain, scr_bnd),
        *domain_rows, *hop_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
