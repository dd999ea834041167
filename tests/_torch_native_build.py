"""Builds the JAX package's native host library once per machine before any
test runs, so that parallel test workers never race to build it.

``qpn_tpu/utils/native.py`` builds ``qpn_tpu/native/qpn_host.cpp`` on first
use into ``~/.cache/qpn_tpu_native/libqpn_host_<sha1[:12]>.so`` through one
shared temporary name (``<so>.tmp``).  Test workers that start on a machine
without the library build at the same time: one worker's ``os.replace``
moves the file another is still writing, the loser's own replace fails, and
that worker keeps the pure-Python fallback for its life, so the JAX
package's native tests fail or take the fallback there.

:func:`ensure_reference_native` builds it first: under an exclusive
``flock`` on ``.build.lock`` in the cache it builds the library with the
loader's own g++ commands into a name of this process's own and moves it
into place with ``os.replace``, unless the library is there.  The loader
then only loads a finished file.  If g++ cannot build it, nothing is left
behind and the loader's own attempt fails as before
(``tests/test_native.py::test_native_builds`` says so).

A worker may have imported the loader and lost the race before the build:
the loader remembers its failure (``_TRIED`` set, ``_LIB`` None) for the
worker's life.  :func:`forget_a_lost_race` runs after the build: where the
library file now exists and the loader still remembers the failure, it
clears the memo, so the next call loads the finished file.

``tests/test_0_native_prebuild.py`` runs both when it is imported.  Every
pytest-xdist worker collects the test files in name order before it runs a
test, and that name sorts before every JAX test file, so each worker waits
on the lock before any file asks ``native_available()`` when it is
imported (``tests/test_host_engine.py``).  This module imports neither JAX
nor the JAX package.

This concerns the JAX package's library only, which the parity tests load
as the reference.  The port builds its own copy of the source,
``qpn_tpu_torch/csrc/qpn_host.cpp``, into ``build/qpn_tpu_torch/`` through
``utils/cuda_build.build_library`` (a private temporary per process, so no
race), and raises when that build fails.
"""


import fcntl
import hashlib
import os
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "qpn_tpu", "native",
                      "qpn_host.cpp")


def library_path(cache_dir=None) -> str:
    """The path ``qpn_tpu.utils.native._load()`` computes."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    cache = cache_dir or os.path.expanduser("~/.cache/qpn_tpu_native")
    return os.path.join(cache, f"libqpn_host_{tag}.so")


def ensure_reference_native(cache_dir=None) -> bool:
    """Build the library into place unless it is there; True when this call
    built it.  Safe to call from many processes and threads at once."""
    so = library_path(cache_dir)
    if os.path.exists(so):
        return False
    cache = os.path.dirname(so)
    try:
        os.makedirs(cache, exist_ok=True)
        lock = open(os.path.join(cache, ".build.lock"), "w")
    except OSError:
        return False
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return False
        try:
            # the loader's commands: with OpenMP, else serial
            for omp in (["-fopenmp"], []):
                try:
                    subprocess.run(["g++", "-O3", *omp, "-shared", "-fPIC",
                                    SOURCE, "-o", tmp],
                                   check=True, capture_output=True,
                                   timeout=120)
                    break
                except subprocess.CalledProcessError:
                    continue
            else:
                return False
            os.replace(tmp, so)
            return True
        except (OSError, subprocess.TimeoutExpired):
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def forget_a_lost_race(cache_dir=None) -> bool:
    """Clear the loader's memo of a failed load when the library is there
    now; True when it did."""
    native = sys.modules.get("qpn_tpu.utils.native")
    if native is None or not native._TRIED or native._LIB is not None:
        return False
    if not os.path.exists(library_path(cache_dir)):
        return False
    native._TRIED = False
    return True
