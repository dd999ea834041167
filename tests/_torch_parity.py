"""Helpers of the parity tests that run one case through both packages.

A case is a function of ``M``, where ``M(name)`` imports the module ``name``
of one package (``M()`` the package itself), so that the same code builds
the same inputs and calls the same function in the JAX package and in the
port.
"""

import importlib

import numpy as np

PACKAGES = ("qpn_tpu", "qpn_tpu_torch")


def run_both(case):
    """``case(M)`` on each package: the JAX package's result, then the
    port's."""
    def accessor(pkg):
        return lambda name="": importlib.import_module(
            f"{pkg}.{name}" if name else pkg)
    return [case(accessor(p)) for p in PACKAGES]


def assert_same(got, want, atol=0.0):
    """The same structure; floats (scalars and arrays) within ``atol``;
    everything else equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w, atol)
    elif isinstance(want, np.ndarray) and want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (float, np.floating, np.ndarray)):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        assert got == want


def clear_query_caches():
    """Both packages memoize geometry queries process-wide by content."""
    for pkg in PACKAGES:
        importlib.import_module(f"{pkg}.geometry.query_cache").CACHE.clear()
