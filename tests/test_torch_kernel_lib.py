"""The seam of the port's hand-written kernels (``utils/cuda_build.py``):
each wrapper's declared library (``KernelLibrary``), built, loaded and
typed from its tables on first use and never at import; the one input
check (``KernelInputs``), whose faults name the kernel and the tensor; and
the one launch helper's decode and count, on a stand-in for the CUDA
build (the CPU has none).

This file imports neither JAX nor the JAX package.
"""

import contextlib
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.ops import admm_cuda, eg_cuda, hop_cuda, lemke_cuda
from qpn_tpu_torch.ops import screen_cuda
from qpn_tpu_torch.utils import cuda_build
from qpn_tpu_torch.utils.cuda_build import (EITHER_FLOAT, DtypeError,
                                            KernelInputs, KernelLibrary)
from qpn_tpu_torch.utils.metrics import METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = {"lemke": lemke_cuda, "eg": eg_cuda, "screen": screen_cuda,
            "hop": hop_cuda, "admm": admm_cuda}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_host_build_is_typed_from_its_tables(wrapper):
    """Each wrapper's host build loads through its declared library, and
    every function of its host and shape tables carries the declared
    restype and argtypes; its CUDA table names the error decoder and the
    opt-in query."""
    lib = WRAPPERS[wrapper].LIB
    host = lib.host()
    table = {**lib.builds["host"].table, **lib.shape}
    assert table
    for name, (restype, argtypes) in table.items():
        fn = getattr(host, name)
        assert fn.restype is restype, name
        assert tuple(fn.argtypes) == tuple(argtypes), name
    cuda = lib.builds["cuda"].table
    assert lib.error in cuda and lib._optin in cuda


def test_the_hop_shares_the_extragradient_library():
    """The hop's kernel is built into K2's library, whose one table
    declares the hop's entries."""
    assert hop_cuda.LIB is eg_cuda.LIB
    cuda, host = eg_cuda.LIB.builds["cuda"], eg_cuda.LIB.builds["host"]
    assert "hybrid_hop.cu" in cuda.sources
    for t in ("f32", "f64"):
        assert f"qpn_hybrid_hop_{t}" in cuda.table
        assert f"qpn_hybrid_hop_host_{t}" in host.table
    assert "qpn_hop_instance" in eg_cuda.LIB.shape


IMPORTS = """
from qpn_tpu_torch.utils import cuda_build
calls = []
cuda_build.build_library = lambda *a, **k: calls.append(a)
from qpn_tpu_torch.ops import (admm_cuda, eg_cuda, hop_cuda, lemke_cuda,
                               screen_cuda)
libs = [m.LIB for m in (admm_cuda, eg_cuda, hop_cuda, lemke_cuda,
                        screen_cuda)]
print(len(calls), sum(len(lib._loaded) for lib in libs))
"""


def test_importing_the_wrappers_builds_and_loads_nothing():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", IMPORTS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0"]


def _eg_inputs(B=2, n=3):
    return [torch.zeros(B, n, n), *(torch.zeros(B, n) for _ in range(4)),
            torch.ones(B)]


def _swap(i, fn):
    return lambda ts: [fn(t) if k == i else t for k, t in enumerate(ts)]


# fault -> (the inputs made faulty, the device the check asks for, the
# error and the words of its message)
FAULTS = {
    "dtype": (_swap(5, torch.Tensor.double), "cpu", DtypeError,
              "eg kernel: tau is torch.float64, expected dtype "
              "torch.float32"),
    "shape": (_swap(1, lambda t: t[:, :2]), "cpu", ValueError,
              "eg kernel: q shape (2, 2), expected (2, 3)"),
    "rank": (_swap(0, lambda t: t[0]), "cpu", ValueError,
             "eg kernel: M shape (3, 3), expected (B, n, n)"),
    "device": (_swap(2, lambda t: t.to("meta")), "cpu", ValueError,
               "eg kernel: l on meta, M on cpu"),
    "device type": (lambda ts: ts, "cuda", ValueError,
                    "eg kernel takes CUDA tensors; M is on cpu"),
    "contiguity": (_swap(0, lambda t: t.transpose(1, 2)), "cpu", ValueError,
                   "eg kernel: M is not contiguous"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_one_check_names_the_kernel_the_tensor_and_the_fault(fault):
    faulty, device_type, error, words = FAULTS[fault]
    with pytest.raises(error) as info:
        eg_cuda._INPUTS(faulty(_eg_inputs()), device_type, steps=1)
    assert str(info.value) == words
    eg_cuda._INPUTS(_eg_inputs(), "cpu", steps=1)


def test_a_dtype_fault_is_a_type_and_a_value_error():
    assert issubclass(DtypeError, TypeError)
    assert issubclass(DtypeError, ValueError)


def test_counts_may_not_be_negative():
    with pytest.raises(ValueError, match="eg kernel: steps=-1 < 0"):
        eg_cuda._INPUTS(_eg_inputs(), "cpu", steps=-1)


def test_derived_dims_and_picked_dtypes():
    """A dim that is a multiple of a bound symbol plus a constant, and a
    dtype that the first tensor picks among several for the others."""
    check = KernelInputs("k", T=("B n 3n+2", EITHER_FLOAT),
                         v=("B 3n+1", EITHER_FLOAT))
    check([torch.zeros(2, 3, 11), torch.zeros(2, 10)], "cpu")
    with pytest.raises(ValueError, match=r"k: T shape \(2, 3, 10\), "
                       r"expected \(2, 3, 11\)"):
        check([torch.zeros(2, 3, 10), torch.zeros(2, 10)], "cpu")
    with pytest.raises(DtypeError, match="k: v is torch.float32, expected "
                       "dtype torch.float64"):
        check([torch.zeros(2, 3, 11, dtype=torch.float64),
               torch.zeros(2, 10)], "cpu")
    with pytest.raises(DtypeError, match="k: T is torch.float16, expected "
                       "dtype torch.float32 or torch.float64"):
        check([torch.zeros(2, 3, 11).half(), torch.zeros(2, 10)], "cpu")


def _admm_inputs(B=2, m=5, n=4):
    shapes = dict(A=(B, m, n), L=(B, n, n), R=(B, m), q=(B, n), lc=(B, m),
                  uc=(B, m), loose=(B, m), x=(B, n), z=(B, m), y=(B, m),
                  dx=(B, n), dy=(B, m))
    return [torch.zeros(shape, dtype=torch.bool if name == "loose"
                        else torch.float64)
            for name, shape in shapes.items()]


def test_a_factor_may_be_column_major():
    """ADMM's L may be stored column-major (as cholesky_ex returns it); A
    may not, in the whole check or in its layout part alone."""
    ins = _admm_inputs()
    ins[1] = ins[1].transpose(1, 2).contiguous().transpose(1, 2)
    admm_cuda._INPUTS(ins, "cpu", iters=1)
    admm_cuda._INPUTS.contiguous(ins)
    ins[0] = ins[0].transpose(1, 2).contiguous().transpose(1, 2)
    for check in (lambda: admm_cuda._INPUTS(ins, "cpu", iters=1),
                  lambda: admm_cuda._INPUTS.contiguous(ins)):
        with pytest.raises(ValueError,
                           match="admm kernel: A is not contiguous"):
            check()


@pytest.fixture
def stand_in(monkeypatch):
    """A declared library whose CUDA build is a stand-in: an entry that
    returns its first argument as the launch's code, a decoder, and a
    per-card query that counts its calls; the CUDA runtime's stream and
    device guard replaced for the CPU."""
    calls = []

    def entry(rc, stream):
        calls.append(("entry", rc, stream))
        return rc

    def query():
        calls.append(("query",))
        return 1000

    fake = SimpleNamespace(entry=entry, query=query,
                           error=lambda rc: f"error {rc}".encode())
    lib = KernelLibrary(
        cuda=cuda_build.Build("stand_in", [], [], {}),
        host=cuda_build.Build("stand_in_host", [], [], {}), shape={},
        error="error", optin="query")
    lib._loaded["cuda"] = fake
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(cuda_build, "_CARD", {})
    return lib, calls


def test_a_launch_takes_the_stream_and_is_counted(stand_in):
    lib, calls = stand_in
    METRICS.reset()
    lib.launch("stand_in_kernel", "entry", torch.device("cuda", 0), 0)
    assert calls == [("entry", 0, 77)]
    assert METRICS.launches["stand_in_kernel"] == 1


def test_a_refused_launch_raises_with_its_decoded_code_uncounted(stand_in):
    lib, _ = stand_in
    METRICS.reset()
    with pytest.raises(RuntimeError,
                       match="^stand_in_kernel launch failed: error 7$"):
        lib.launch("stand_in_kernel", "entry", torch.device("cuda", 0), 7)
    assert METRICS.launches.get("stand_in_kernel", 0) == 0


def test_a_card_query_is_read_once_a_device(stand_in):
    lib, calls = stand_in
    for _ in range(3):
        assert lib.optin(torch.device("cuda", 0)) == 1000
    assert lib.optin(torch.device("cuda", 1)) == 1000
    assert calls == [("query",), ("query",)]
