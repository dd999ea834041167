"""The traffic generator: a pool of scenario ensembles and the order in
which the calls take them, as a traffic mix (``qpnbench/mixes/<name>.json``)
describes it.

A scenario is the draw of ``models.robust_avoid.scenario_batch_gavis``:
standard-normal shifts of the ego's and each obstacle's start position
(scaled by ``position_sigma``) and a normal jitter of the finite lower
bounds that are not equalities (scaled by ``bound_jitter``), in that order
for each scenario, from one generator.  The pool is drawn from the mix's
``pool_seed``, so every run times the same set of ensembles (at pool seed
0 and the model's seed 0 the first is that function's ensemble); the run's
seed sets the order: each pass over the pool is a permutation of it drawn
from the run's seed.  The work a call takes depends on its scenarios (the
hardest lanes of an ensemble set its time), so a pool drawn anew for each
seed would change the timed work from seed to seed.

The check ensembles are drawn from the run's seed, on a stream of their
own: after the window the run solves them through the same call and judges
them with the window's answers, so that every seed checks scenarios that no
other seed and no warm-up has seen.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Pool:
    shift: np.ndarray    # (ensembles, lanes, shifted) start-position shifts
    jitter: np.ndarray   # (ensembles, lanes, n) bound jitter


# the stream of the check ensembles, apart from the pool's and the order's
CHECK_STREAM = 1


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of a run's draws; any whole number is a seed.  Stream
    0 is the seed's own; another stream gives draws apart from it."""
    key = int(seed) % (1 << 64)
    return np.random.default_rng(key if stream == 0 else [key, stream])


def draw_pool(traffic: dict, shifted: int, n: int) -> Pool:
    """The mix's pool, drawn from its ``pool_seed``."""
    return _draw(traffic, shifted, n, rng(traffic["pool_seed"]),
                 traffic["pool"])


def draw_check(traffic: dict, shifted: int, n: int, seed: int) -> Pool:
    """The mix's ``check_ensembles`` ensembles, drawn from the run's seed."""
    return _draw(traffic, shifted, n, rng(seed, CHECK_STREAM),
                 traffic["check_ensembles"])


def _draw(traffic: dict, shifted: int, n: int, g: np.random.Generator,
          P: int) -> Pool:
    S = traffic["lanes"]
    shift = np.empty((P, S, shifted))
    jitter = np.empty((P, S, n))
    for e in range(P):
        for s in range(S):
            shift[e, s] = traffic["position_sigma"] * g.standard_normal(shifted)
            jitter[e, s] = traffic["bound_jitter"] * g.standard_normal(n)
    return Pool(shift=shift, jitter=jitter)


class Order:
    """The pool ensemble of each call: pass after pass over the pool, each
    pass a permutation drawn from the run's seed."""

    def __init__(self, seed: int, pool: int):
        self.rng = rng(seed)
        self.pool = pool
        self.seq: list = []

    def __call__(self, call: int) -> int:
        while call >= len(self.seq):
            self.seq.extend(self.rng.permutation(self.pool).tolist())
        return self.seq[call]
