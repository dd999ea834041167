"""Problem zoo of the port — the two robust-avoidance models of slice 1
(the JAX package's ``qpn_tpu/models`` holds all sixteen; the rest come with
ROADMAP slice 2).

``setup(name, **kwargs)`` mirrors the reference's ``setup(::Val{name})``
convention (programs.jl:139-141)."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def setup(name, **kwargs):
    name = str(name).lstrip(":")
    if name not in _REGISTRY:
        raise KeyError(f"Unknown example {name!r}. "
                       f"Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


from . import robust_avoid_simple     # noqa: E402,F401
from . import robust_avoid            # noqa: E402,F401

__all__ = ["setup", "register"]
