"""Does a lane's result depend on its batchmates?  The batched operations of
the port's ADMM (``ops/batch_qp.solve_qp_batch``) run on a lane alone and
inside batches of several sizes, on one device, and the largest difference
of the lane's result is printed per operation.

The lockstep broker (``parallel/lockstep.py``) fuses scenarios' calls into
one batch; a scenario gets its serial numbers only as far as these
operations give a lane the same bits whatever the batch.  Run on the card:

    python3 benchmarks/torch_batch_invariance.py [--device cuda|cpu]

Prints one line per (operation, n, batch size) and a JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = (2, 4, 8, 38)           # the zoo's QPs are 2-38 variables wide
BATCHES = (2, 3, 16, 64, 256)


def problems(B, n, m, seed):
    """Seeded strictly convex QPs with box rows, as numpy f64."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", R, R) / n + 0.1 * np.eye(n)
    A = rng.standard_normal((B, m, n))
    q = rng.standard_normal((B, n))
    return P, q, A, -np.ones((B, m)), np.ones((B, m))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from qpn_tpu_torch.ops import batch_qp
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    f64 = torch.float64
    rows = []
    for n in SIZES:
        m = 2 * n
        for B in BATCHES:
            P, q, A, lo, hi = (torch.as_tensor(a, dtype=f64, device=dev)
                               for a in problems(B, n, m, seed=n))
            K = P + 0.5 * A.mT @ A
            x = torch.as_tensor(np.random.default_rng(1).standard_normal(
                (B, n)), dtype=f64, device=dev)
            L, _ = torch.linalg.cholesky_ex(K)
            LU, piv, _ = torch.linalg.lu_factor_ex(K)
            ops = {
                "bmm": lambda s: (A[s] @ x[s, :, None])[:, :, 0],
                "cholesky_ex": lambda s: torch.linalg.cholesky_ex(K[s])[0],
                "cholesky_solve": lambda s: torch.cholesky_solve(
                    x[s, :, None], L[s])[:, :, 0],
                "lu_factor_ex": lambda s: torch.linalg.lu_factor_ex(K[s])[0],
                "lu_solve": lambda s: torch.linalg.lu_solve(
                    LU[s], piv[s], x[s, :, None])[:, :, 0],
                "solve_qp_batch": lambda s: batch_qp.solve_qp_batch(
                    P[s], q[s], A[s], lo[s], hi[s],
                    torch.ones(q[s].shape[0], m, dtype=torch.bool,
                               device=dev)).x,
            }
            for name, op in ops.items():
                whole = op(slice(0, B))
                diff = 0.0
                for i in (0, B // 2, B - 1):
                    alone = op(slice(i, i + 1))
                    diff = max(diff, float((alone[0] - whole[i]).abs().max()))
                rows.append(dict(op=name, n=n, B=B, max_abs_diff=diff))
                print(f"{name} n={n} B={B}: lane alone vs in the batch, max "
                      f"|diff| {diff:.3g}", flush=True)
    worst = {}
    for r in rows:
        worst[r["op"]] = max(worst.get(r["op"], 0.0), r["max_abs_diff"])
    name = "cpu"
    if dev.type == "cuda":
        import subprocess
        name = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({"device": name, "worst": worst, "rows": rows}))


if __name__ == "__main__":
    main()
