"""String-keyed strategy registry (port of ``repro.fl.registry``).

``@register("name")`` maps a method name to a zero-arg strategy factory;
``get_strategy(name)`` returns a fresh instance per call.
"""
from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}


def register(name: str) -> Callable:
    def deco(factory: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"strategy {name!r} already registered")
        _REGISTRY[name] = factory
        return factory
    return deco


def get_strategy(name: str):
    """Instantiate the strategy registered under ``name``; ``KeyError``
    listing the ported methods for unknown names."""
    _ensure_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"unknown or not yet ported FL strategy {name!r}; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def available() -> List[str]:
    """Names of all registered strategies."""
    _ensure_builtin()
    return sorted(_REGISTRY)


def _ensure_builtin() -> None:
    import repro_torch.fl.strategies  # noqa: F401
