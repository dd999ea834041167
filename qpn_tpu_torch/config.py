"""Numeric configuration of the PyTorch port.

Counterpart of ``qpn_tpu/config.py`` without its TPU-only parts: no x64
switch (PyTorch takes the dtype from each tensor), no XLA compile cache, and
no size- or backend-driven dispatch placement.  Batched numeric work that the
host algorithm (``algorithm.solve`` and the geometry layer) starts from numpy
data runs on one explicit device, :attr:`NumericConfig.device`; the batched
engines called on tensors run on the device of their inputs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NumericConfig:
    # Device of the batched numeric work that the host algorithm starts from
    # numpy data (ADMM, AVI, Lemke, the feasibility screen): "cuda" (or
    # "cuda:<index>"), the default, or "cpu" when the caller asks for it.
    # There is no auto-detection and no fallback: with "cuda" and no CUDA
    # device, numeric_device() raises.  The f64 sign-split glue of the host
    # algorithm (the dual recovery of algorithm.verify_solutions_batch, the
    # multi-start choice of avi.solve_avi) stays in numpy on the host
    # whatever the device.
    device: str = "cuda"
    # Row-count bucket sizes.  The geometry layer groups its LP batches by
    # the bucket of the row count (and pads rows to it, as the JAX package
    # does; masked rows change no lane's numbers); the Lemke pivot budget of
    # ``lemke.solve_lemke_batch_padded`` is sized from the bucket of n.
    row_buckets: tuple = (16, 64, 256, 1024)
    # Variable-count buckets: the JAX package pads n to them for XLA's
    # compile cache.  The port's LP and QP engines run at exact n;
    # ``lemke.solve_lp_lemke_batch`` sizes its pivot budget from the bucket.
    dim_buckets: tuple = (8, 32, 128, 256)
    # Batch-size buckets for padded ensemble calls (the KKT-AVI solve and the
    # generic adaptive solve run at exact shapes).
    batch_buckets: tuple = (1, 8, 64, 512, 2048)
    # Shared-matrix scenario ensembles (structure tag shared_M) at or above
    # this AVI dimension belong to the shared-matrix route (ROADMAP slice 3),
    # whose per-iteration work is GEMMs against one resident matrix instead
    # of one (n, 3n+2) pivot tableau per lane.
    shared_kkt_min_n: int = 192
    # Pivot loop of the batched Lemke engine: "auto" = the hand-written CUDA
    # kernel (ops/lemke_cuda.py) for CUDA tensors and the plain PyTorch loop
    # (ops/lemke.lemke_pivot_torch) for CPU tensors; "cuda" = the kernel
    # always (raises on CPU tensors); "torch" = the plain loop always.
    lemke_kernel: str = "auto"
    # Fused extragradient steps of the warm start (ops/eg.py) and of the
    # hybrid solver's hop (ops/avi.py), with the same meaning: "auto" = the
    # CUDA kernels (ops/eg_cuda.py, ops/hop_cuda.py) for CUDA tensors and the
    # plain PyTorch loops (ops/eg.eg_steps_torch, avi._eg_phase) for CPU
    # tensors.
    eg_kernel: str = "auto"
    # Projected-subgradient feasibility screen of geometry.is_empty_batch
    # (ops/screen.py), with the same meaning: "auto" = the CUDA kernel
    # (ops/screen_cuda.py) for CUDA tensors, the plain PyTorch loop
    # (ops/screen.screen_steps_torch) for CPU tensors.
    screen_kernel: str = "auto"
    # Run the f32 feasibility screen before the exact emptiness LPs of
    # is_empty_batch.  None = auto (see screen_enabled): off when the native
    # exact pivot engine answers those LPs (empty_engine "host"), otherwise
    # on for a CUDA device.
    use_screen: bool | None = None
    # Engine for pure LPs routed through solve_qp_batch_padded: "admm" (the
    # batched first-order engine; its interior-ish choice among optimal
    # points is what the enumeration trajectories follow) or "lemke" (exact
    # complementary pivoting on the LP's KKT AVI; uncertified lanes fall
    # back to ADMM).
    lp_engine: str = "admm"
    # Engine for support-value queries (setops.support_batch): "host" = the
    # native exact-shape pivot engine (utils/native.lemke_batch; audited,
    # ADMM fallback), "lemke" = the batched pivot route, "admm".  Support
    # values are unique, so the engine cannot steer a trajectory.
    support_engine: str = "host"
    # Engine for the ε-inflation exemplar LPs, whose witness POINT steers
    # enumeration: "admm" (the reference's OSQP witness character) or
    # "host" (opt-in; a vertex witness).
    exemplar_engine: str = "admm"
    # Engine for verdict-only emptiness / membership queries: "host" lets
    # the native pivot engine decide the clean lanes (the verdict is value-
    # determined), "admm" sends them to the batched ADMM.
    empty_engine: str = "host"
    # Two-tier ADMM in solve_qp_batch_padded: every lane runs this many
    # iterations first; only lanes that used them all re-solve with the
    # full 4000-iteration budget.  0 disables tiering.
    admm_tier1_iters: int = 250
    # Above this many pieces, remove_subsets runs a signature-duplicate
    # prune first and a blockwise exemplar screen instead of materializing
    # all O(N²) pairs.
    prune_dedup_threshold: int = 512
    # Route block-tridiagonal trajectory KKTs through the cyclic-reduction
    # x-update (ops/banded.py): QP batches of solve_qp_batch_padded with at
    # least ``banded_auto_min_n`` variables whose P / A'A patterns are
    # block-banded with at least banded_min_blocks() blocks.
    banded_auto: bool = True
    banded_auto_min_n: int = 48
    # Block-count crossover on the CPU (the dense Cholesky wins below): the
    # JAX package's value, so that CPU runs take its route.
    banded_min_blocks_cpu: int = 64


CONFIG = NumericConfig()


def numeric_device():
    """``CONFIG.device`` as a ``torch.device``.  Raises when it names a CUDA
    device and PyTorch finds none: the CPU is used only when asked for."""
    import torch
    dev = torch.device(CONFIG.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'CONFIG.device is "{CONFIG.device}" and PyTorch finds no CUDA '
            'device; set qpn_tpu_torch.CONFIG.device = "cpu" to run on the '
            "CPU")
    return dev


def screen_enabled() -> bool:
    """Whether geometry.is_empty_batch runs the feasibility screen (the rule
    of ``qpn_tpu/config.py::pallas_screen_enabled``, with a CUDA device in
    the place of the TPU backend)."""
    if CONFIG.use_screen is not None:
        return CONFIG.use_screen
    if CONFIG.empty_engine == "host":
        # the native exact pivot engine answers the same query on the host
        return False
    return CONFIG.device.startswith("cuda")


def banded_min_blocks() -> int:
    """Minimum block count for the automatic banded route on
    ``CONFIG.device``; 0 when the route is off there.  It is off on the
    card, where the banded x-update won at no block count measured
    (chip_smoke.py phase 16, B=64, k=6, T=8..64: the dense route won below
    T=64, and the two tie at T=64).  Phase 16 counts a block count as a
    banded win only when each banded call beats each dense call by 1.25
    times; a smaller edge either way is a tie, which keeps this value.  It
    fails when the banded route wins from some T to the end of the sweep
    while this is 0.  An explicit banded_k still takes the banded route."""
    if CONFIG.device.startswith("cuda"):
        return 0
    return CONFIG.banded_min_blocks_cpu


def bucket(n: int, buckets) -> int:
    """Smallest bucket >= n (last bucket grows by doubling if exceeded)."""
    if n <= 0:
        return buckets[0]
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def row_bucket(n: int) -> int:
    return bucket(n, CONFIG.row_buckets)
