"""The port's default device is the card.

``NumericConfig.device`` defaults to "cuda"; every entry point that starts
batched work from numpy data takes it from there, and raises, on a machine
without a CUDA device, an error that names ``CONFIG.device = "cpu"`` as the
way to ask for the CPU.  Nothing falls back to the CPU by itself; asked for
the CPU, the same calls run.  This file imports neither JAX nor the JAX
package.
"""

import numpy as np
import pytest
import torch

import qpn_tpu_torch as qt
from qpn_tpu_torch import config
from qpn_tpu_torch.config import CONFIG, NumericConfig
from qpn_tpu_torch.geometry import Poly, is_empty_batch
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import batch_qp, lemke
from qpn_tpu_torch.ops.avi import batch_from_numpy
from qpn_tpu_torch.ops.screen import feasibility_screen
from qpn_tpu_torch.parallel.sharded import level_sweep_scan


def _ensemble():
    return scenario_batch_gavis(num_scenarios=2, T=2, num_obj=1,
                                num_poly_faces=4, seed=0)


def _box(lo, hi):
    return Poly(np.eye(2), np.full(2, lo), np.full(2, hi))


def _solve():
    return qt.solve(qt.setup("simple_bilevel"), np.array([0.0, 1.0, 0.0, 0.0]))


def _qp():
    return batch_qp.solve_qp_np(np.eye(2), -np.ones(2), np.eye(2),
                                np.zeros(2), np.full(2, 0.5))


def _lp():
    return lemke.solve_lp_lemke_batch(
        -np.ones((1, 2)), np.eye(2)[None], np.zeros((1, 2)),
        np.ones((1, 2)), np.ones((1, 2), dtype=bool))


def _sweep():
    k = 2
    return level_sweep_scan(np.eye(k)[None], np.zeros((1, k, k)),
                            -np.ones((1, k)), np.zeros((1, k)),
                            np.full((1, k), np.inf), k, np.zeros(k))


# every entry point that takes its device from CONFIG.device
ENTRY_POINTS = [
    ("batch_from_numpy", lambda: batch_from_numpy(_ensemble())),
    ("solve", _solve),
    ("solve_qp_np", _qp),
    ("solve_lp_lemke_batch", _lp),
    ("feasibility_screen", lambda: feasibility_screen([_box(0.0, 1.0)] * 4)),
    ("level_sweep_scan", _sweep),
]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs")


def test_default_device_is_the_card():
    assert NumericConfig().device == "cuda"
    assert CONFIG.device == "cuda"


def test_numeric_device_follows_the_config(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    assert config.numeric_device() == torch.device("cpu")


def test_numeric_device_raises_without_a_card(no_cuda):
    with pytest.raises(RuntimeError, match='CONFIG.device = "cpu"'):
        config.numeric_device()


@pytest.mark.parametrize("name,call", ENTRY_POINTS,
                         ids=[e[0] for e in ENTRY_POINTS])
def test_default_raises_without_a_card(no_cuda, name, call):
    """No detection and no fallback: the error names the CPU setting."""
    with pytest.raises(RuntimeError, match='CONFIG.device = "cpu"'):
        call()


@pytest.mark.parametrize("name,call", ENTRY_POINTS,
                         ids=[e[0] for e in ENTRY_POINTS])
def test_runs_on_the_cpu_when_asked(monkeypatch, name, call):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    out = call()
    if name == "batch_from_numpy":
        assert out["M"].device.type == "cpu" and out["M"].dtype == torch.float64
    elif name == "solve":
        assert out.solved
        assert np.allclose(out.x_opt[2:], [0.5, 0.5], atol=1e-4)
    elif name == "solve_qp_np":
        assert np.allclose(out.x, [0.5, 0.5], atol=1e-5)


def test_explicit_device_overrides_the_default():
    data = batch_from_numpy(_ensemble(), "cpu")
    assert data["q"].device.type == "cpu" and data["mask"].dtype == torch.bool


def test_emptiness_queries_run_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    verdicts = is_empty_batch([_box(0.0, 1.0), _box(1.0, 0.0)] * 2)
    assert verdicts.tolist() == [False, True, False, True]
