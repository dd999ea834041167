"""The port's FLOP/byte accounting (``qpn_tpu_torch/utils/flops.py``, a copy
of ``qpn_tpu/utils/flops.py`` with the H100's peaks) and its profiler entry
point (``qpn_tpu_torch/utils/profiling.py`` over ``torch.profiler``)."""

import json
import os

import numpy as np
import pytest
import torch

from qpn_tpu.utils import flops as ref_flops

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import batch_qp
from qpn_tpu_torch.utils import flops, profiling


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.mark.parametrize("n,m,iters", [(6, 16, 250), (38, 0, [25, 750]),
                                       (608, 64, np.arange(5) * 100)])
def test_counts_equal_reference(n, m, iters):
    """The same formulas as the JAX package's, scalar or per lane."""
    assert flops.admm_flops(n, m, iters) == ref_flops.admm_flops(n, m, iters)
    assert flops.admm_flops(n, m, iters, polish=False) == \
        ref_flops.admm_flops(n, m, iters, polish=False)
    assert flops.newton_flops(n, iters) == ref_flops.newton_flops(n, iters)
    assert flops.lemke_flops(n, iters) == ref_flops.lemke_flops(n, iters)
    assert flops.admm_bytes(n, m, iters) == ref_flops.admm_bytes(n, m, iters)


def test_peaks_are_the_cards():
    """Published H100 SXM peaks, the ones chip_smoke.py bounds with; none
    of the JAX package's TPU constants."""
    assert flops.H100_PEAK_F32 == 67e12
    assert flops.H100_PEAK_F64 == 34e12
    assert flops.H100_HBM_BYTES_S == 3.35e12
    assert not any(name.startswith("V5E") for name in dir(flops))


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    """trace() records the block and writes <dir>/trace.json on exit; an
    annotate() range shows in it by name."""
    P = np.eye(3)[None]
    q = np.ones((1, 3))
    A = np.eye(3)[None]
    lo, hi = -np.ones((1, 3)), np.ones((1, 3))
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("qpn_admm_call"):
            sol = batch_qp.solve_qp_batch_padded(P, q, A, lo, hi,
                                                 np.ones((1, 3), bool))
    assert sol.status[0] == batch_qp.SOLVED
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "qpn_admm_call" for e in events)
    assert any(e.key == "qpn_admm_call" for e in prof.key_averages())


def test_annotate_outside_a_trace_is_harmless():
    with profiling.annotate("no_trace"):
        x = torch.ones(2) + 1
    assert x.sum().item() == 4.0
    assert not os.path.exists("no_trace")
