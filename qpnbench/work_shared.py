"""Operations and bytes of the shared-matrix route's extragradient pre-pass
(``qpn_tpu_torch/ops/shared_kkt.py``, ``_eg_run``), counted from shapes and
from the products the program reports (``METRICS`` ``shared_eg_gemms``), and
which device operations those products are.

Each product of the pre-pass is an (S, n) @ (n, n) GEMM against the one
shared M in float32, 2·S·n² operations.  The route's elementwise work (the
step, the clip) is not counted.  Bytes: each call reads M (n, n), q, l, u
and the start z (S, n each) once and writes z once, float32.  Peaks and the
least time are ``work.py``'s.

The products' kernels are those of cuBLAS's float32 GEMM kernels that a
traced window launches most often.  Every product has the same shape and
launches the same kernels, once each: on an H100 cuBLAS names them
``sm80_xmma_gemm_f32f32_*_execute_split_k_kernel*`` and
``..._execute_kernel*``, and ``*sgemm*`` in its older naming.  The route
launches a few dozen other float32 GEMMs a call, of other shapes and so
other kernels (74 against 24006 products in a call at the cell's shapes on
an H100); its other matrix products are float64.
"""

from __future__ import annotations

from qpnbench import work


def is_f32_gemm(name: str) -> bool:
    """Whether a device operation's short name is one of cuBLAS's float32
    GEMM kernels."""
    low = name.lower()
    return "batched" not in low and ("gemm_f32f32" in low or "sgemm" in low)


def eg_gemm_kernels(trace) -> dict:
    """The pre-pass's products' kernels in a traced window: name ->
    (launches, device seconds) of the float32 GEMM kernels launched most
    often."""
    seen: dict = {}
    for name, _, d in trace.ops:
        if is_f32_gemm(name):
            k, s = seen.get(name, (0, 0.0))
            seen[name] = (k + 1, s + d)
    most = max((k for k, _ in seen.values()), default=0)
    return {name: ks for name, ks in seen.items() if ks[0] == most}


def eg_gemm_seconds(trace) -> float:
    """Device seconds of the pre-pass's products in a traced window."""
    return sum(s for _, s in eg_gemm_kernels(trace).values())


def eg_flops(n: int, lanes: int, gemms: float) -> float:
    """The operations of ``gemms`` products of ``lanes`` lanes."""
    return gemms * 2.0 * lanes * n * n


def eg_bytes(n: int, lanes: int) -> float:
    """A call's pre-pass inputs read once and output written once: M (n,
    n), q, l, u and z0 in, z out (lanes, n each), float32."""
    return work.F32 * (n * n + 5.0 * lanes * n)


def eg_least_s(n: int, lanes: int, gemms: float) -> float:
    """The least time the card could take for a call's pre-pass of
    ``gemms`` products."""
    return work.least_s(eg_flops(n, lanes, gemms), eg_bytes(n, lanes))
