"""Count the fixed work of the pivot kernel K1 for a configuration: the mean
pivots a lane takes, the covering one included, in the benchmark's own plain
float32 pivoting (``reference/lemke.py``) over the configuration's pool at
seed 0.  The count goes into the configuration's ``k1_pivots_per_lane``; it
is counted once and never from the program.

    python3 qpnbench/fixed_work.py --config robust_avoid_T5_o2 [--mix kkt_s256]

On a CUDA card when there is one (the plain loop is slow on the CPU at
n=190), else on the CPU.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import numpy as np
    import torch
    from qpnbench.harness import Bench
    from qpnbench.reference import lemke, pool
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--mix", default="kkt_s256")
    args = ap.parse_args()
    bench = Bench()
    entry = next(c for c in bench.spec["configs"] if c["name"] == args.config)
    config = json.loads((bench.root / entry["file"]).read_text())
    mix = json.loads((bench.dir / "mixes" / f"{args.mix}.json").read_text())
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    prob, _, _, _, out = pool.solve(config, dict(mix, pool_seed=0),
                                    torch.float32, dev)
    piv = np.concatenate([p for _, _, p in out]).astype(np.float64)
    status = np.concatenate([s for _, s, _ in out])
    n = prob.M.shape[0]
    print(json.dumps({
        "config": args.config, "mix": args.mix, "n": n, "lanes": len(piv),
        "k1_pivots_per_lane": float(piv.mean()),
        "min": int(piv.min()), "max": int(piv.max()),
        "solved": int((status == lemke.SUCCESS).sum()),
        "device": str(dev), "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
