"""The port imports neither JAX nor the JAX package: ``qpn_tpu/config.py``
switches on x64 and the XLA cache at import, and the GPU machine has no JAX.
Checked in a fresh interpreter, since this test process imports both.  The
port also stands on its own files: no path into ``qpn_tpu/``, its own copy
of the native host source, and a failed native build raises on the route's
first call instead of switching the route to another engine."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import qpn_tpu_torch
import qpn_tpu_torch.algorithm, qpn_tpu_torch.ops.lemke_cuda
import qpn_tpu_torch.ops.avi, qpn_tpu_torch.ops.eg, qpn_tpu_torch.ops.eg_cuda
import qpn_tpu_torch.utils.cuda_build, qpn_tpu_torch.utils.native
import qpn_tpu_torch.ops.batch_qp, qpn_tpu_torch.ops.screen
import qpn_tpu_torch.ops.screen_cuda, qpn_tpu_torch.geometry.setops
import qpn_tpu_torch.geometry.project, qpn_tpu_torch.geometry.vertices
import qpn_tpu_torch.geometry.rays, qpn_tpu_torch.geometry.query_cache
import qpn_tpu_torch.enumeration, qpn_tpu_torch.requests
import qpn_tpu_torch.parallel.sharded, qpn_tpu_torch.ops.shared_kkt
import qpn_tpu_torch.ops.banded, qpn_tpu_torch.printing
import qpn_tpu_torch.utils.checkpoint, qpn_tpu_torch.utils.flops
import qpn_tpu_torch.utils.profiling, qpn_tpu_torch.parallel.lockstep
import qpn_tpu_torch.parallel.procpool, qpn_tpu_torch.parallel.mesh
import qpn_tpu_torch.parallel.multihost, qpn_tpu_torch.parallel.ring
import qpn_tpu_torch.parallel.launch, qpn_tpu_torch.entry
for name in ("simple_bilevel", "four_player_matrix_game", "robust_avoid",
             "deep_synthetic", "rock_paper_scissors", "toll_setting",
             "chainstore", "trilevel_escape", "shepherd_sheep",
             "robust_constrained", "control_avoid", "interpolation_avoid"):
    qpn_tpu_torch.setup(name)
qpn_tpu_torch.CONFIG.device = "cpu"     # the default is the card
qpn_tpu_torch.entry.entry()
qpn_tpu_torch.solve(qpn_tpu_torch.setup("shepherd_sheep"))
qpn_tpu_torch.parallel.lockstep.solve_many_lockstep(
    [qpn_tpu_torch.setup("shepherd_sheep")])
b = qpn_tpu_torch.models.robust_avoid.scenario_batch_gavis(num_scenarios=2,
                                                           T=2)
qpn_tpu_torch.ops.shared_kkt.solve_kkt_avi_shared(
    b["M"], b["q"], b["l"], b["u"], b["mask"], structure=b["structure"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "qpn_tpu"))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


# ---- the port stands on its own files ----------------------------------

PORT = Path(REPO) / "qpn_tpu_torch"
_REF_WORD = re.compile(r"\bqpn_tpu(?!\w)")


def _python_references(path):
    """Imports of JAX or the JAX package, and string constants naming
    ``qpn_tpu``, in a Python file; docstrings and other bare string
    statements are comments and may cite the reference."""
    tree = ast.parse(path.read_text())
    prose = {id(node.value) for node in ast.walk(tree)
             if isinstance(node, ast.Expr)
             and isinstance(node.value, ast.Constant)}
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            hits += [a.name for a in node.names
                     if a.name.split(".")[0] in ("qpn_tpu", "jax")]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and \
                node.module.split(".")[0] in ("qpn_tpu", "jax"):
            hits.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in prose and _REF_WORD.search(node.value):
            hits.append(node.value)
        elif isinstance(node, (ast.Name, ast.Attribute)) and \
                getattr(node, "id", getattr(node, "attr", "")) == "qpn_tpu":
            hits.append("qpn_tpu")
    return hits


def _c_references(path):
    """``qpn_tpu`` in C++/CUDA code outside comments."""
    code = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    code = re.sub(r"//[^\n]*", "", code)
    return _REF_WORD.findall(code)


def test_no_path_into_the_jax_package():
    """No file of the port builds, opens or imports anything of
    ``qpn_tpu/``: only comments and docstrings may cite it."""
    scanned, bad = 0, {}
    for path in sorted(PORT.rglob("*")):
        if path.suffix == ".py":
            hits = _python_references(path)
        elif path.suffix in (".cu", ".cuh", ".cpp"):
            hits = _c_references(path)
        else:
            continue
        scanned += 1
        if hits:
            bad[str(path.relative_to(REPO))] = hits
    assert scanned > 50 and bad == {}


def test_scan_sees_a_path_into_the_jax_package(tmp_path):
    """The scan above catches what the port's loader once did: build a
    path to the JAX package's C++ source."""
    src = tmp_path / "loader.py"
    src.write_text('"""Docstrings may cite qpn_tpu/native."""\n'
                   '# so may comments: qpn_tpu\n'
                   'SOURCE = ROOT / "qpn_tpu" / "native" / "qpn_host.cpp"\n')
    assert _python_references(src) == ["qpn_tpu"]
    cu = tmp_path / "k.cpp"
    cu.write_text('// qpn_tpu\n/* qpn_tpu */\nconst char* p = "qpn_tpu";\n')
    assert _c_references(cu) == ["qpn_tpu"]


def test_native_source_lies_under_the_port():
    from qpn_tpu_torch.utils import native
    assert native._SOURCE == PORT / "csrc" / "qpn_host.cpp"
    assert native._SOURCE.exists()
    assert native.library_path().parent == \
        Path(REPO) / "build" / "qpn_tpu_torch"


STANDALONE = """
import sys
sys.modules["jax"] = None              # any import of JAX fails,
sys.modules["qpn_tpu"] = None          # and of the JAX package
import numpy as np
import qpn_tpu_torch as qt
from qpn_tpu_torch.utils import native
qt.CONFIG.device = "cpu"
ret = qt.solve(qt.setup("simple_bilevel", gen_solution_map=True),
               np.array([1.0, 0.0, 0.0, 0.0]))
assert ret.solved
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "qpn_tpu")
             and sys.modules[m] is not None)
print(native.library_path())
print(",".join(bad))
print(" ".join(repr(float(v)) for v in ret.x_opt))
"""


def test_port_alone_builds_its_library_and_solves(tmp_path):
    """A copy of ``qpn_tpu_torch/`` alone, with JAX and the JAX package
    blocked and no ``qpn_tpu`` beside it, builds its native library inside
    the copy and solves simple_bilevel at the golden point w=(1,0) on the
    CPU."""
    shutil.copytree(PORT, tmp_path / "qpn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", STANDALONE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lib, bad, x = out.stdout.strip().splitlines()
    assert Path(lib).parent == tmp_path / "build" / "qpn_tpu_torch"
    assert bad == ""
    np.testing.assert_allclose([float(v) for v in x.split()],
                               [1.0, 0.0, 0.5, 0.5], atol=1e-4)


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """The port's native module with its library unloaded and its source
    missing; models are built before, while it loads."""
    from qpn_tpu_torch.config import CONFIG
    from qpn_tpu_torch.geometry.query_cache import CACHE
    from qpn_tpu_torch.utils import native
    import qpn_tpu_torch as qt
    monkeypatch.setattr(CONFIG, "device", "cpu")
    qpn = qt.setup("simple_bilevel", gen_solution_map=True)
    CACHE.clear()
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SOURCE", tmp_path / "missing.cpp")
    yield qpn
    CACHE.clear()


def _box_polys():
    """The unit box, and the unit box with x + y >= 3 (empty)."""
    from qpn_tpu_torch.geometry.poly import Poly
    return [Poly(np.eye(2), np.zeros(2), np.ones(2)),
            Poly(np.vstack([np.eye(2), [[1.0, 1.0]]]),
                 np.array([0.0, 0.0, 3.0]), np.array([1.0, 1.0, np.inf]))]


def test_missing_source_raises_on_the_routes_first_call(no_library):
    """A missing native source raises on each route's first call; neither
    solve() nor is_empty_batch switches to another engine, and the screen
    stays off."""
    import qpn_tpu_torch as qt
    from qpn_tpu_torch.config import screen_enabled
    from qpn_tpu_torch.geometry import setops
    from qpn_tpu_torch.ops.lemke import solve_lp_host_batch
    from qpn_tpu_torch.utils import native
    from qpn_tpu_torch.utils.metrics import METRICS
    METRICS.reset()
    with pytest.raises(RuntimeError, match="missing.cpp"):
        qt.solve(no_library, np.array([1.0, 0.0, 0.0, 0.0]))
    with pytest.raises(RuntimeError, match="missing.cpp"):
        setops.is_empty_batch(_box_polys())
    assert not screen_enabled()
    with pytest.raises(RuntimeError, match="missing.cpp"):
        solve_lp_host_batch(np.ones((1, 2)), np.eye(2)[None],
                            np.zeros((1, 2)), np.ones((1, 2)),
                            np.ones((1, 2), bool))
    with pytest.raises(RuntimeError, match="missing.cpp"):
        native.recipe_product([{1, 2}, {3}], 10)
    # no other engine answered in their place
    c = METRICS.counters
    assert c.get("admm_calls", 0) == 0 and c.get("screen_polys", 0) == 0
    assert c.get("lp_host", 0) == 0


def test_failed_build_raises_with_the_compilers_stderr(monkeypatch,
                                                       tmp_path):
    from qpn_tpu_torch.utils import native
    bad = tmp_path / "qpn_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.library_path()
    assert native._LIB is None


def test_missing_compiler_raises_runtime_error(monkeypatch, tmp_path):
    """A compiler that cannot be started (no g++: not supported) raises
    RuntimeError naming the command, on the route's first call, and no
    plain version answers in its place."""
    from qpn_tpu_torch.utils import native
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_SOURCE", tmp_path / "qpn_host.cpp")
    native._SOURCE.write_text("// a fresh source: no cached library\n")
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+.*needs g\\+\\+"):
        native.recipe_product([{1, 2}, {3}], 10)
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.dedupe_rows_mask(np.eye(2))
    assert native._LIB is None
