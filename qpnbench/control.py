"""The control of the correctness check: the plain reference solve put in
the program's place, in float32, the precision below the configuration's
float64, judged by the same check as a run.  It has to come out not
correct; its reading is the upper end of the limit (``PERF.md``).

    python3 qpnbench/control.py --workload ra_T5o2.kkt_s256 --pool-seeds 0 11 12 [--dtype float64]

For each pool seed: the cell's pool drawn from it (the cell's own pool at
its mix's ``pool_seed``), every ensemble solved once, and the largest
residual of any lane on the reference's statement, beside the limit.
``--dtype float64`` runs the reference at the configuration's own
precision, which has to pass.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(bench, workload: str, pool_seed: int, dtype, device):
    """(largest residual, lanes not ended on a complementary basis, limit)
    of the reference solve in ``dtype`` on the cell's pool drawn from
    ``pool_seed``."""
    from qpnbench.reference import check, lemke, pool
    _, _, mix, config = bench.cell(workload)
    prob, q, l, u, out = pool.solve(config, dict(mix, pool_seed=pool_seed),
                                    dtype, device)
    worst = max(float(check.residuals(prob.M, q[e], l[e], u[e], z).max())
                for e, (z, _, _) in enumerate(out))
    unsolved = sum(int((s != lemke.SUCCESS).sum()) for _, s, _ in out)
    return worst, unsolved, mix["tol"]


def main() -> int:
    import torch
    from qpnbench.harness import Bench
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--pool-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = Bench()
    for seed in args.pool_seeds:
        t0 = time.perf_counter()
        worst, unsolved, tol = readings(bench, args.workload, seed, dtype,
                                        dev)
        print(json.dumps({"workload": args.workload, "pool_seed": seed,
                          "dtype": args.dtype, "resid_max": worst,
                          "limit": tol, "correct": worst <= tol,
                          "lanes_unsolved": unsolved, "device": str(dev),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
