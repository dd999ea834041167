"""Route ``generic``: the program's adaptive AVI ensemble solve,
``ops.avi.solve_avi_batch_adaptive(M, q, l, u, z0, mask, tol=...,
onchip_eg_steps=...)``, with no structure and ``mixed`` at the entry's
default."""

from __future__ import annotations


def build() -> None:
    """Build (or find) the kernel libraries this route launches: the
    extragradient kernel, and the pivot kernel of the last escalation."""
    from qpn_tpu_torch.ops import eg_cuda, lemke_cuda
    eg_cuda.build()
    lemke_cuda.build()


def prepare(data: dict, traffic: dict):
    """The timed call on pool ensemble ``e``: the solve, then z and the
    certified flags copied to the host."""
    from qpn_tpu_torch.ops import avi
    tol, steps = traffic["tol"], traffic["onchip_eg_steps"]

    def call(e: int):
        res = avi.solve_avi_batch_adaptive(
            data["M"], data["q"][e], data["l"][e], data["u"], data["z0"],
            data["mask"], tol=tol, onchip_eg_steps=steps)
        return res.z.cpu().numpy(), res.converged.cpu().numpy()
    return call
