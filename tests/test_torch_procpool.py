"""The port's process pool (``qpn_tpu_torch/parallel/procpool.py``): the
analogue of ``tests/test_procpool.py`` less its two ``slow`` tests, with 2
spawned workers, held to the serial loop and to the JAX package's pool.

The workers take the parent's CONFIG (here the CPU) and one intra-op thread,
so a job's result equals the same job solved in this process: bit for bit
for the hard-class chunk job, whose checksum is an exact sum of |z|."""

import numpy as np
import pytest
import torch

from qpn_tpu.models.robust_avoid import hard_chunk_job as ref_hard_chunk_job

import qpn_tpu_torch as qt
from qpn_tpu_torch.config import CONFIG, banded_min_blocks, numeric_device
from qpn_tpu_torch.models.robust_avoid import hard_chunk_job
from qpn_tpu_torch.parallel.procpool import (map_processes,
                                             solve_many_processes)

torch.set_num_threads(1)

HARD = (2, 2, 1, 3, 0, 1e-8)        # S, T, num_obj, faces, seed, tol


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def test_procpool_single_worker_is_serial_loop():
    qpns = [qt.setup("simple_bilevel") for _ in range(2)]
    x0s = [np.array([0.0, 1.0, 0.0, 0.0])] * 2
    rets = solve_many_processes(qpns, x0s, n_workers=1)
    assert all(r.solved for r in rets)
    ser = qt.solve_many([qt.setup("simple_bilevel") for _ in range(2)], x0s)
    for a, b in zip(rets, ser):
        np.testing.assert_array_equal(a.x_opt, b.x_opt)


def test_procpool_rejects_mismatched_inits():
    qpns = [qt.setup("simple_bilevel") for _ in range(2)]
    with pytest.raises(ValueError, match="length"):
        solve_many_processes(qpns, [None])


def test_map_processes_generic():
    """map_processes ships a module-level fn to pinned spawned workers and
    preserves job order: identical jobs give identical results, and the
    serial CPU run's and the JAX package's numbers."""
    out = map_processes(hard_chunk_job, [HARD] * 2, n_workers=2)
    assert len(out) == 2
    assert all(o[0] == 1.0 for o in out)
    assert out[0] == out[1]
    assert out[0] == hard_chunk_job(*HARD)
    want = ref_hard_chunk_job(*HARD)
    assert want[0] == 1.0
    np.testing.assert_allclose(out[0][2], want[2], rtol=1e-8)


def test_workers_take_the_parent_config(monkeypatch):
    """A worker runs with the parent's CONFIG and one intra-op thread: the
    parent's CPU device and fields reach it, and a parent set to the card
    gives workers on the card, which raise where there is none (no CPU
    fallback)."""
    monkeypatch.setattr(CONFIG, "banded_min_blocks_cpu", 17)
    assert map_processes(numeric_device, [()] * 2, n_workers=2) == \
        [torch.device("cpu")] * 2
    assert map_processes(banded_min_blocks, [()] * 2, n_workers=2) == [17] * 2
    threads = map_processes(torch.get_num_threads, [()], n_workers=1)
    assert threads == [1]
    if not torch.cuda.is_available():
        monkeypatch.setattr(CONFIG, "device", "cuda")
        with pytest.raises(RuntimeError, match="finds no CUDA"):
            map_processes(numeric_device, [()] * 2, n_workers=2)


def test_map_processes_unpinned_single_worker_runs_in_process():
    """n_workers=1 with pin=False runs in this process (on its device); with
    pin=True it runs in a spawned child (the JAX package's behaviour, which
    its docstring misstates)."""
    import os
    assert map_processes(os.getpid, [()], n_workers=1, pin=False) == \
        [os.getpid()]
    assert map_processes(os.getpid, [()], n_workers=1) != [os.getpid()]


def test_solve_many_processes_matches_serial():
    """Two spawned workers solve four simple_bilevel scenarios to the
    serial loop's x_opt, in input order."""
    x0s = [np.array([0.5 * i - 0.5, 1.0, 0.0, 0.0]) for i in range(4)]
    rets = solve_many_processes([qt.setup("simple_bilevel") for _ in x0s],
                                x0s, n_workers=2)
    ser = qt.solve_many([qt.setup("simple_bilevel") for _ in x0s], x0s)
    assert all(r.solved for r in rets)
    for a, b in zip(rets, ser):
        np.testing.assert_allclose(a.x_opt, b.x_opt, rtol=0, atol=1e-10)
