"""Build the port's native sources into shared libraries with a plain C
interface, loaded with ``ctypes``; load, type, check and launch the
hand-written kernels.

CUDA sources (``qpn_tpu_torch/csrc/*.cu``) are compiled by ``nvcc`` for
Hopper (``sm_90a``) on first use; host C++ sources by ``g++``.  Every build
goes to ``build/qpn_tpu_torch/`` at the root of the checkout (git-ignored),
keyed by a hash of the sources, the headers they include and the command, so
an edit rebuilds and an unchanged tree reuses the library.  Nothing is built
at import time, and a failed build raises with the compiler's stderr.

Each kernel's wrapper (``ops/*_cuda.py``) declares its two builds, nvcc's
and g++'s of the same lane code, as a :class:`KernelLibrary` of C
signature tables, and the tensors its kernel reads as :class:`KernelInputs`.
This module builds, loads and types a build on its first use, reads the
card's limits once per device, checks the inputs, and issues, decodes and
counts each launch; a wrapper keeps only its tables and what its launch
does of its own (workspaces, barriers, ranks).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Sequence

import torch

from .metrics import METRICS

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "qpn_tpu_torch"

# No fast math: approximate division would move ratio-test ties.  No FMA
# contraction either, so the pivot arithmetic rounds like the plain PyTorch
# version it is compared against (separate multiply and subtract).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises when there is none (no CUDA toolkit here)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build_library(name: str, sources: Sequence[Path], command: Sequence[str],
                  depends: Sequence[Path] = ()) -> Path:
    """Compile ``sources`` with ``command`` (compiler and flags, without
    ``-o``) into ``BUILD_DIR/lib{name}_{hash}.so`` unless it exists.

    The hash covers the sources, the ``depends`` (headers) and the command.
    Concurrent builds (pytest workers) each write a private temporary
    file and rename it into place, so none sees a half-written library."""
    h = hashlib.sha256(" ".join(command).encode())
    for path in (*sources, *depends):
        h.update(Path(path).read_bytes())
    so = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*command, "-o", str(tmp), *(str(s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


# Bytes of shared memory a block can opt into on an H100 (sm_90): what the
# card's launchers find there, and what the host instances take to pick the
# instance the card would run.
HOPPER_SMEM_OPTIN = 232448
# Blocks of a spread global instance that an H100 SXM holds at once, each
# with that much shared memory: one on each of its 132 SMs.
HOPPER_RESIDENT_BLOCKS = 132

_CARD: dict = {}


def card_query(name: str, query, device, *args) -> int:
    """``query(*args)`` of the CUDA ``device`` (a count, or minus a
    ``cudaError_t``), made with the device current and cached per device
    under ``name`` and ``args``.  Raises when the query fails."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (name, args, index)
    value = _CARD.get(key)
    if value is None:
        with torch.cuda.device(index):
            value = query(*args)
        if value < 0:
            raise RuntimeError(f"{name}{args} of cuda:{index} could not be "
                               f"read (cudaError {-value})")
        _CARD[key] = value
    return value


class Build(NamedTuple):
    """One build of a kernel's ``csrc/`` sources: the library's name, its
    sources and the headers they include (all in the build's hash), and the
    C signature of each function it exports, ``name -> (restype,
    argtypes)``."""
    name: str
    sources: Sequence[str]
    headers: Sequence[str]
    table: Dict[str, tuple]


class KernelLibrary:
    """A hand-written kernel's two builds: ``cuda`` (nvcc, sm_90a) and
    ``host`` (g++, the same lane code for the CPU tests), each built, loaded
    and typed from its table on its first use, never at import.  ``shape``
    types the pure functions of the shape that both builds export.
    ``error`` and ``optin`` name the CUDA build's functions that decode a
    launch's return code and read the card's shared-memory opt-in limit."""

    def __init__(self, *, cuda: Build, host: Build, shape: Dict[str, tuple],
                 error: str, optin: str):
        self.builds = {"cuda": cuda, "host": host}
        self.shape = shape
        self.error, self._optin = error, optin
        self._loaded: Dict[str, ctypes.CDLL] = {}

    def _load(self, which: str, command: Sequence[str]) -> ctypes.CDLL:
        build = self.builds[which]
        so = build_library(build.name, [CSRC_DIR / s for s in build.sources],
                           command, [CSRC_DIR / h for h in build.headers])
        lib = ctypes.CDLL(str(so))
        for name, (restype, argtypes) in {**build.table, **self.shape}.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        self._loaded[which] = lib
        return lib

    def cuda(self) -> ctypes.CDLL:
        """The CUDA build (nvcc for sm_90a), built or found on first use."""
        return self._loaded.get("cuda") or self._load(
            "cuda", [nvcc_path(), *NVCC_FLAGS])

    def host(self) -> ctypes.CDLL:
        """The host build (g++), built or found on first use."""
        return self._loaded.get("host") or self._load(
            "host", ["g++", *GXX_FLAGS])

    def build(self) -> None:
        """Build (or find) the CUDA build now, so a caller can time the
        build apart from the first launch."""
        self.cuda()

    def card(self, query: str, device, *args) -> int:
        """The CUDA build's per-card ``query(*args)`` of ``device``, read
        once per device."""
        return card_query(query, getattr(self.cuda(), query), device, *args)

    def optin(self, device) -> int:
        """The shared memory a block can opt into on the CUDA ``device``, as
        the kernel library reads it (the limit its instances are picked
        by)."""
        return self.card(self._optin, device)

    def launch(self, counted: str, entry: str, device, *args) -> None:
        """Launch the CUDA build's ``entry(*args, stream)`` on the current
        stream of ``device``, under its device guard, and count it in
        ``METRICS.launches[counted]``.  A launch the card refuses raises
        ``RuntimeError`` with CUDA's message and is not counted."""
        lib = self.cuda()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = getattr(lib, entry)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{counted} launch failed: "
                               + getattr(lib, self.error)(rc).decode())
        METRICS.launched(counted)


class DtypeError(TypeError, ValueError):
    """A kernel input of the wrong dtype: a TypeError, and a ValueError like
    the input's other faults, so a caller may catch it as either."""


# A dtype entry of KernelInputs: the first tensor's dtype, float32 or
# float64, for every tensor that names it.
EITHER_FLOAT = (torch.float32, torch.float64)
# A layout flag of KernelInputs: each matrix of the tensor may also be
# stored column-major (as torch.linalg.cholesky_ex returns its factors).
EITHER_MAJOR = "row- or column-major"
_DIM = re.compile(r"(\d*)([A-Za-z]\w*)([+-]\d+)?")


class KernelInputs:
    """The tensors a kernel reads, as a table ``name -> (shape, dtype)`` or
    ``(shape, dtype, EITHER_MAJOR)`` in the order its wrapper passes them.
    A shape is a string of dims, each a symbol that the first tensor binds
    (``"B n n"``) or a multiple of one plus a constant (``"B 3n+2"``); the
    first tensor's shape names every symbol plainly.  A dtype is one dtype,
    or a tuple of them: the first tensor's dtype, which is one of them.

    Calling it with the tensors checks that the first is on a
    ``device_type`` device and the others on its device, every dtype and
    shape, that each tensor is contiguous (or, with ``EITHER_MAJOR``, each
    of its matrices column-major), and that every count given is not
    negative.  A fault raises naming the kernel, the tensor and the fault:
    ``DtypeError`` for a dtype, else ``ValueError``."""

    def __init__(self, kernel: str, **table):
        self.kernel = kernel
        self._rows, self._dims, self._shapes = [], [], {}
        for name, (shape, dtype, *layout) in table.items():
            dims = []
            for text in shape.split():
                coef, sym, const = _DIM.fullmatch(text).groups()
                dims.append((text, int(coef or 1), sym, int(const or 0)))
            self._rows.append((name, dtype, bool(layout)))
            self._dims.append(dims)

    def _bind(self, size) -> list:
        """Every tensor's shape when the first one's is ``size``, kept for
        the next call at that size (a launch's check then compares)."""
        dims = self._dims[0]
        if len(size) != len(dims):
            texts = ", ".join(text for text, _, _, _ in dims)
            raise ValueError(f"{self.kernel}: {self._rows[0][0]} shape "
                             f"{tuple(size)}, expected ({texts})")
        bound = {sym: n for (text, _, sym, _), n in zip(dims, size)
                 if text == sym}
        shapes = [tuple(coef * bound[sym] + const for _, coef, sym, const in d)
                  for d in self._dims]
        if len(self._shapes) >= 64:
            self._shapes.clear()
        self._shapes[size] = shapes
        return shapes

    def __call__(self, tensors, device_type: str, **counts) -> None:
        kernel, first = self.kernel, tensors[0]
        device = first.device
        if device.type != device_type:
            raise ValueError(f"{kernel} takes {device_type.upper()} tensors; "
                             f"{self._rows[0][0]} is on {device}")
        shapes = self._shapes.get(first.shape) or self._bind(first.shape)
        lead = first.dtype
        for (name, dtype, _), t, shape in zip(self._rows, tensors, shapes):
            if t.device != device:
                raise ValueError(f"{kernel}: {name} on {t.device}, "
                                 f"{self._rows[0][0]} on {device}")
            dt = t.dtype
            if dt is not dtype and (dt is not lead or type(dtype) is not tuple
                                    or lead not in dtype):
                want = dtype
                if type(dtype) is tuple:
                    want = lead if lead in dtype else " or ".join(
                        map(str, dtype))
                raise DtypeError(f"{kernel}: {name} is {dt}, expected dtype "
                                 f"{want}")
            if t.shape != shape:
                raise ValueError(f"{kernel}: {name} shape {tuple(t.shape)}, "
                                 f"expected {shape}")
        self.contiguous(tensors)
        for count, value in counts.items():
            if value < 0:
                raise ValueError(f"{kernel}: {count}={value} < 0")

    def contiguous(self, tensors) -> None:
        """The layout part of the check alone: every tensor contiguous, or
        with ``EITHER_MAJOR`` each of its matrices column-major."""
        for (name, _, either), t in zip(self._rows, tensors):
            if not (t.is_contiguous()
                    or either and t.transpose(-2, -1).is_contiguous()):
                raise ValueError(f"{self.kernel}: {name} is not contiguous")
