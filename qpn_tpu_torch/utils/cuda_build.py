"""Build the port's native sources into shared libraries with a plain C
interface, loaded with ``ctypes``.

CUDA sources (``qpn_tpu_torch/csrc/*.cu``) are compiled by ``nvcc`` for
Hopper (``sm_90a``) on first use; host C++ sources by ``g++``.  Every build
goes to ``build/qpn_tpu_torch/`` at the root of the checkout (git-ignored),
keyed by a hash of the sources, the headers they include and the command, so
an edit rebuilds and an unchanged tree reuses the library.  Nothing is built
at import time, and a failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

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


def load_cuda_library(name: str, sources: Sequence[str],
                      headers: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``csrc/`` CUDA sources with nvcc for sm_90a and load them."""
    so = build_library(name, [CSRC_DIR / s for s in sources],
                       [nvcc_path(), *NVCC_FLAGS],
                       [CSRC_DIR / h for h in headers])
    return ctypes.CDLL(str(so))


def load_host_library(name: str, sources: Sequence[str],
                      headers: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``csrc/`` host C++ sources with g++ and load them."""
    so = build_library(name, [CSRC_DIR / s for s in sources],
                       ["g++", *GXX_FLAGS], [CSRC_DIR / h for h in headers])
    return ctypes.CDLL(str(so))


# Bytes of shared memory a block can opt into on an H100 (sm_90): what the
# card's launchers find there, and what the host instances take to pick the
# instance the card would run.
HOPPER_SMEM_OPTIN = 232448
# Blocks of a spread global instance that an H100 SXM holds at once, each
# with that much shared memory: one on each of its 132 SMs.
HOPPER_RESIDENT_BLOCKS = 132

_CARD: dict = {}


def card_query(name: str, query, device) -> int:
    """A kernel library's ``query`` of the CUDA ``device`` (a count, or
    minus a ``cudaError_t``), made with the device current and cached per
    device under ``name``.  Raises when the query fails."""
    import torch
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if (name, index) not in _CARD:
        with torch.cuda.device(index):
            value = query()
        if value < 0:
            raise RuntimeError(f"{name} of cuda:{index} could not be read "
                               f"(cudaError {-value})")
        _CARD[name, index] = value
    return _CARD[name, index]


def smem_optin(query, device) -> int:
    """The shared memory a block can opt into on the CUDA ``device``, from a
    kernel library's ``query`` function (the opt-in limit, or minus a
    ``cudaError_t``); cached per device.  Raises when the query fails."""
    return card_query("the shared-memory limit", query, device)
