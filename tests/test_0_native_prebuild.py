"""Builds the JAX package's native host library before any JAX test file is
collected (``tests/_torch_native_build.py`` says why and how).

The name breaks the ``test_torch_*`` naming of the port's tests on purpose:
pytest-xdist workers collect the test files in name order, and this one
sorts before every file of the JAX package's suite, among them
``tests/test_host_engine.py``, which decides when it is imported whether
the library is there.
"""

import os

from _torch_native_build import (ensure_reference_native, forget_a_lost_race,
                                 library_path)

ensure_reference_native()
forget_a_lost_race()


def test_the_library_is_in_place_after_the_prebuild():
    assert os.path.exists(library_path())
