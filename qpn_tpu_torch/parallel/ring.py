"""Ring-rotated frontier processing, the ring-attention analogue for piece
batches (PyTorch port of ``qpn_tpu/parallel/ring.py``).

Each rank holds a block of the enumeration frontier (candidate pieces) and a
block of the reference set (accepted pieces).  To test every candidate
against every reference piece without gathering the whole set, the
reference blocks rotate around the ring of ranks: after ``world`` steps
every (candidate, reference) pair has met on some rank, and memory stays
O(block) instead of O(total).

The JAX package's ``ppermute`` becomes one ``batch_isend_irecv`` a step
(``mesh.rotate``: send to rank+1, receive from rank−1); a row-major 2-D
mesh is one ring over the ranks in order, the ring its ``_ppermute2``
builds.  The JAX package's last rotation, which only brings each block home,
is not made.  Both axes of the input must divide into equal blocks, as
under ``shard_map``.  The JAX package caches one compiled sweep per (mesh,
shapes); the port has nothing to compile.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, block_rows, gather, rotate
from .sharded import _dominated

#: candidate rows compared at a time (bounds the (rows, block, k) compare)
_CHUNK = 1024


def _check(mesh: Mesh, what: str, *sizes: int) -> None:
    axes = mesh.axis_names
    if len(axes) > 2:
        raise ValueError(
            f"{what} supports 1-D and 2-D meshes; got axes {axes} — the "
            f"rotation ring would skip axis {axes[2:]} pairs")
    for b in sizes:
        if b % mesh.size:
            raise ValueError(f"{what}: {b} rows do not split into "
                             f"{mesh.size} equal blocks")


def _sweep(mesh: Mesh, local, ref, compare):
    """``world`` steps of ``compare(local rows, reference block)`` OR-ed
    into one mask over the local rows, the reference blocks rotating."""
    hit = torch.zeros(local[0].shape[0], dtype=torch.bool,
                      device=local[0].device)
    for step in range(mesh.size):
        for c0 in range(0, hit.shape[0], _CHUNK):
            rows = slice(c0, c0 + _CHUNK)
            hit[rows] |= compare(*(a[rows] for a in local), *ref)
        if step + 1 < mesh.size:
            ref = [rotate(mesh, a) for a in ref]
    return hit


def ring_duplicate_mask(mesh: Mesh, sig, ref_sig) -> torch.Tensor:
    """For each candidate signature, is an equal signature present in the
    (distributed) reference set?  ``sig`` (B, k) and ``ref_sig`` (R, k),
    the same on every rank (numpy or tensors); each rank sweeps its block of
    both.  Returns bool (B,) on the mesh's device, full on every rank:
    True = duplicate."""
    _check(mesh, "ring_duplicate_mask", sig.shape[0], ref_sig.shape[0])
    dev = mesh.device
    sig = torch.as_tensor(sig, device=dev)
    ref = torch.as_tensor(ref_sig, device=dev)
    mine = block_rows(mesh, sig.shape[0])

    def compare(s, r):
        return (s[:, None, :] == r[None, :, :]).all(-1).any(1)

    hit = _sweep(mesh, [sig[mine]], [ref[block_rows(mesh, ref.shape[0])]],
                 compare)
    return gather(mesh, hit)


def ring_containment_prune(mesh: Mesh, act, resid) -> torch.Tensor:
    """Keep-mask over duplicate piece groups with O(block) memory a rank.
    Semantics and mask identical to ``sharded.sharded_containment_prune``:
    piece i is dropped iff a piece with the same signature is smaller in
    the strict lexicographic order of (round(resid·1e12), index)."""
    B = act.shape[0]
    _check(mesh, "ring prune", B)
    dev = mesh.device
    act = torch.as_tensor(act, device=dev)
    rq = torch.round(torch.as_tensor(resid, dtype=torch.float64,
                                     device=dev) * 1e12)
    idx = torch.arange(B, device=dev)
    mine = block_rows(mesh, B)
    local = [act[mine], rq[mine], idx[mine]]
    dominated = _sweep(mesh, local, [a.clone() for a in local], _dominated)
    return gather(mesh, ~dominated)
