"""On the card: one short run of each cell through the command, correct,
with the result line's keys.  Skips where there is no card (decided inside
the fixture)."""

import json
import subprocess
import sys

import pytest

from qpnbench.tests.small_bench import REPO


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ra_T2o1.kkt_s256", "ra_T5o2.kkt_s256",
                                      "ra_T2o1.generic_s256"])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "qpnbench/run.py", "--workload",
                          workload, "--seed", "4000000001", "--seconds", "2",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
