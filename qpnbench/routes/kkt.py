"""Route ``kkt``: the program's structured KKT-AVI ensemble solve,
``ops.avi.solve_kkt_avi_batch(M, q, l, u, mask, structure, tol=...)``."""

from __future__ import annotations


def build() -> None:
    """Build (or find) the kernel libraries this route launches."""
    from qpn_tpu_torch.ops import lemke_cuda
    lemke_cuda.build()


def prepare(data: dict, traffic: dict):
    """The timed call on pool ensemble ``e``: the solve, then z and the
    certified flags copied to the host."""
    from qpn_tpu_torch.ops import avi
    tol = traffic["tol"]

    def call(e: int):
        res = avi.solve_kkt_avi_batch(data["M"], data["q"][e], data["l"][e],
                                      data["u"], data["mask"],
                                      data["structure"], tol=tol)
        return res.z.cpu().numpy(), res.converged.cpu().numpy()
    return call
