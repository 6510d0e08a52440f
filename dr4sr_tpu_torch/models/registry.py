"""Model registry: name -> architecture class (copy of the JAX package's)."""

from __future__ import annotations

from typing import Dict

_REGISTRY: Dict[str, type] = {}


def register_model(name: str):
    def deco(cls):
        _REGISTRY[name.lower()] = cls
        cls.model_name = name
        return cls

    return deco


def get_model_class(name: str) -> type:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
