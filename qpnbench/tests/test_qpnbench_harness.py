"""The harness: it finds a configuration, mix, cell and metric added as new
files; a run prints the result line's keys and no others; without a card the
command exits non-zero and prints no result, and so it does where a piece
loads JAX before the result is due."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from qpnbench import harness
from qpnbench.tests.small_bench import REPO, one_thread, small_root

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture
def cpu(monkeypatch):
    from qpn_tpu_torch.config import CONFIG
    monkeypatch.setattr(CONFIG, "device", "cpu")


def test_finds_added_files(tmp_path):
    root = small_root(tmp_path)
    d = root / "qpnbench"
    shutil.copy(d / "configs" / "robust_avoid_T2_o1.json",
                d / "configs" / "robust_avoid_T3_o1.json")
    cfg = json.loads((d / "configs" / "robust_avoid_T3_o1.json").read_text())
    cfg["T"] = 3
    (d / "configs" / "robust_avoid_T3_o1.json").write_text(json.dumps(cfg))
    (d / "mixes" / "kkt_s8_small.json").write_text(
        (d / "mixes" / "kkt_s256.json").read_text())
    (d / "cells" / "ra_T3o1.kkt_s8_small.json").write_text(json.dumps(
        {"config": "robust_avoid_T3_o1", "traffic": "kkt_s8_small",
         "trace_calls": 2}))
    (d / "metrics" / "calls_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec.latencies))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "robust_avoid_T3_o1",
                            "source": "https://arxiv.org/abs/2404.03767",
                            "file": "qpnbench/configs/robust_avoid_T3_o1.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "ra_T3o1.kkt_s8_small",
                              "config": "robust_avoid_T3_o1",
                              "traffic": "kkt_s8_small", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "solves_per_s",
                              "workloads": ["ra_T3o1.kkt_s8_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(root)
    entry, cell, mix, config = bench.cell("ra_T3o1.kkt_s8_small")
    assert config["T"] == 3 and mix["route"] == "kkt"
    names = [m["name"] for m in bench.metrics("ra_T3o1.kkt_s8_small", True)]
    assert names == ["calls_in_window"]
    assert [m["name"] for m in bench.metrics("ra_T2o1.kkt_s256", True)] == [
        "device_idle_pct", "straggler_pct.kkt", "k1_ms.kkt",
        "k1_roofline_pct.kkt"]
    assert bench.module("metrics", "calls_in_window").read(
        harness.Record(cell, config, mix, 0, 0.0, [1.0, 2.0], 1.0, 0, 0, {},
                       None)) == 2.0


def test_unknown_workload_raises(tmp_path):
    with pytest.raises(KeyError):
        harness.Bench(small_root(tmp_path)).cell("no_such_cell")


@pytest.mark.parametrize("workload", ["ra_T2o1.kkt_s256",
                                      "ra_T2o1.generic_s256"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_its_keys(tmp_path, cpu, workload, traced):
    bench = harness.Bench(small_root(tmp_path))
    result, lines = harness.run(bench, workload, 2 ** 31 + 7, 0.3, traced,
                                time.perf_counter(), device="cpu",
                                log=lambda m: None)
    keys = RESULT_KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if traced:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    want = {m["name"] for m in bench.metrics(workload, traced)}
    got = set(result["metrics"])
    # device-trace readers find nothing to read on the CPU
    assert got <= want
    if not traced:
        assert got == {"solves_per_s", "call_p95_ms", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert result["checks"] == {"resid_max": {
        "value": result["checks"]["resid_max"]["value"], "limit": 1e-8}}
    assert lines[-1].startswith("check resid_max:")
    json.dumps(result)


def test_command_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "qpnbench/run.py", "--workload",
                          "ra_T2o1.kkt_s256", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_command_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and qpnbench/, the
    command fails and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "qpnbench", tmp_path / "qpnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "qpnbench/run.py", "--workload",
                          "ra_T2o1.kkt_s256", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


DRIVE = """
import sys
import torch
torch.set_num_threads(1)
from qpn_tpu_torch.config import CONFIG
CONFIG.device = "cpu"
from qpnbench import run
sys.exit(run.main(["--workload", "ra_T2o1.kkt_s256", "--seed", "3001234571",
                   "--seconds", "0.3", "--trace", "0"],
                  root=sys.argv[1], device="cpu"))
"""


@pytest.mark.parametrize("planted", [False, True])
def test_command_prints_no_result_with_jax_loaded(tmp_path, planted):
    """A metric reader that loads ``jax`` (a stand-in package here), read
    after the window and the comparison: the command exits 3 and prints no
    result.  The same run without it prints its line."""
    root = tmp_path / "root"
    root.mkdir()
    small_root(root)
    fake = tmp_path / "fake" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text('"""A stand-in for JAX."""\n')
    if planted:
        reader = root / "qpnbench" / "metrics" / "setup_s.py"
        reader.write_text("import jax  # noqa: F401\n" + reader.read_text())
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(fake.parent), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", DRIVE, str(root)], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    if planted:
        assert out.returncode == 3, out.stderr[-2000:]
        assert out.stdout.strip() == ""
        assert out.stderr.strip().splitlines()[-1].endswith(": jax")
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is True
