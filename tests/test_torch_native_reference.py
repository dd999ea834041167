"""The JAX package's native host library, built once per machine before any
test runs (``tests/_torch_native_build.py``): the loader loads exactly the
library that the prebuild put in place.  Collecting this file runs the
prebuild too, for a run that leaves out ``tests/test_0_native_prebuild.py``.
"""

import ctypes
import os
import subprocess
import sys

from _torch_native_build import (HERE, ensure_reference_native,
                                 forget_a_lost_race, library_path)

ensure_reference_native()
forget_a_lost_race()


def test_reference_loader_loads_exactly_that_library():
    from qpn_tpu.utils import native
    lib = native._load()
    assert lib is not None
    assert lib._name == library_path()
    assert os.path.exists(library_path())


def test_step_is_idempotent(tmp_path):
    cache = str(tmp_path / "cache")
    assert ensure_reference_native(cache) is True
    so = library_path(cache)
    before = os.stat(so)
    assert ensure_reference_native(cache) is False
    after = os.stat(so)
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                 before.st_mtime_ns)
    # the machine-wide library from collection is there as well
    assert ensure_reference_native() is False


def test_concurrent_callers_leave_one_valid_library(tmp_path):
    cache = str(tmp_path / "cache")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import _torch_native_build as t; "
            "print(t.ensure_reference_native(sys.argv[2]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, HERE, cache],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0
        outs.append(out.strip())
    assert sorted(outs) == ["False"] * 3 + ["True"]
    assert sorted(os.listdir(cache)) == [".build.lock",
                                         os.path.basename(library_path(
                                             cache))]
    lib = ctypes.CDLL(library_path(cache))
    assert hasattr(lib, "qpn_lemke_batch")


def test_a_lost_race_is_forgotten_once_the_library_is_there(monkeypatch):
    """A loader that remembers a failed load (a worker that lost the race)
    loads the finished library after the memo is cleared; a loader that
    has its library, or has not tried, is left as it is."""
    from qpn_tpu.utils import native
    assert native._load() is not None
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.native_available() is False
    assert forget_a_lost_race() is True
    assert native.native_available() is True
    assert native._LIB is not None
    assert forget_a_lost_race() is False
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert forget_a_lost_race() is False
