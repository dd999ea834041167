"""Run one cell of the benchmark once and print its result line.

    python3 qpnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error are the same checks.  Without a card, or
with fewer than the cell asks for, it exits with 2 and prints no result; if
a forbidden module (JAX or the JAX package) is loaded when the result is
due, after the window, the comparison and the metric readers, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qpnbench import harness  # noqa: E402


def main(argv=None, root=None, device=None) -> int:
    """The command.  ``root`` (a checkout) and ``device`` (``"cpu"``) are
    for tests, which drive the run without a card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    bench = harness.Bench() if root is None else harness.Bench(root)
    try:
        result, lines = harness.run(bench, args.workload, args.seed,
                                    args.seconds, bool(args.trace), T_START,
                                    device=device, log=log)
    except harness.NoCard as e:
        log(f"qpnbench: no result: {e}")
        return 2
    found = harness.forbidden_modules()
    if found:
        log("qpnbench: no result: loaded in the run's process: "
            + ", ".join(found))
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
