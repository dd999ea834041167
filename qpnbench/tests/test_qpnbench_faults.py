"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a small size, with the program's entry replaced by a broken one.

The faults a cell of this benchmark can have: a solve that returns its
start unchanged; half of the ensemble left out, its lanes given the mean of
the rest; one answer altered where it is produced; answers from a table of
the pool's, which are right on the pool and wrong on the scenarios drawn
from the seed after the window.  (There is no exchange between chips: every
cell takes one.)  The control, the reference's own
solve in float32 in the program's place, comes out not correct too."""

import time

import numpy as np
import pytest
import torch

from qpnbench import harness
from qpnbench.reference import lemke
from qpnbench.tests.small_bench import SMALL_POOL, one_thread, small_root

ROUTES = {"ra_T2o1.kkt_s256": "solve_kkt_avi_batch",
          "ra_T2o1.generic_s256": "solve_avi_batch_adaptive"}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def unchanged(solve, *args, **kw):
    res = solve(*args, **kw)
    return res._replace(z=torch.zeros_like(res.z),
                        converged=torch.ones_like(res.converged))


def half_left_out(solve, *args, **kw):
    res = solve(*args, **kw)
    z = res.z.clone()
    h = z.shape[0] // 2
    z[h:] = z[:h].mean(0)
    return res._replace(z=z, converged=torch.ones_like(res.converged))


CALLS = [0]


def answer_altered(solve, *args, **kw):
    res = solve(*args, **kw)
    CALLS[0] += 1
    if CALLS[0] % 3:
        return res
    z = res.z.clone()
    z[1, 2] += 1e-6 * (1.0 + z[1, 2].abs())
    return res._replace(z=z)


MEMO: dict = {}


def memo_of_the_pool(solve, M, q, *rest, **kw):
    """A program that keeps the answers to the first inputs it sees (the
    pool, in the warm-up) and answers any other input from that table."""
    key = q.cpu().numpy().tobytes()
    if key not in MEMO and len(MEMO) < SMALL_POOL:
        MEMO[key] = solve(M, q, *rest, **kw)
    res = MEMO.get(key, next(iter(MEMO.values())))
    return res._replace(converged=torch.ones_like(res.converged))


def control_float32(solve, M, q, l, u, *rest, **kw):
    """The reference in float32 in the program's place."""
    n = q.shape[1]
    f32 = torch.float32
    z, _, _ = lemke.solve(M.to(f32), q.to(f32), l.to(f32), u.to(f32),
                          max_pivots=lemke.max_pivots(n), **lemke.F32)
    res = solve(M, q, l, u, *rest, **kw)
    return res._replace(z=z.double(),
                        converged=torch.ones_like(res.converged))


def run_broken(tmp_path, monkeypatch, workload, fault):
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.ops import avi
    monkeypatch.setattr(CONFIG, "device", "cpu")
    entry = ROUTES[workload]
    solve = getattr(avi, entry)
    MEMO.clear()
    monkeypatch.setattr(avi, entry,
                        lambda *a, **kw: fault(solve, *a, **kw))
    bench = harness.Bench(small_root(tmp_path))
    result, lines = harness.run(bench, workload, 3001234570, 0.5, False,
                                time.perf_counter(), device="cpu",
                                log=lambda m: None)
    return result


@pytest.mark.parametrize("workload", sorted(ROUTES))
@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered,
                                   memo_of_the_pool, control_float32])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, workload, fault):
    result = run_broken(tmp_path, monkeypatch, workload, fault)
    assert result["correct"] is False
    resid = result["checks"]["resid_max"]
    assert resid["value"] > 10 * resid["limit"]


@pytest.mark.parametrize("workload", sorted(ROUTES))
def test_sound_path_is_correct(tmp_path, monkeypatch, workload):
    result = run_broken(tmp_path, monkeypatch, workload,
                        lambda solve, *a, **kw: solve(*a, **kw))
    assert result["correct"] is True
    assert np.isfinite(result["checks"]["resid_max"]["value"])
