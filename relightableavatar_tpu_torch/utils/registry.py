"""Component registry: a copy of ``relightableavatar_tpu/utils/registry.py``
for the port.

The reference resolves config strings like ``lib.networks.deform.base_network``
with ``importlib.import_module(...)`` (``lib/networks/make_network.py:4-7``).
The same config strings resolve here through an explicit registry of
constructors, so every reference YAML keeps working unmodified.
"""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register(kind: str, *names: str):
    """Decorator: register a constructor under one or more config strings."""
    def deco(fn):
        table = _REGISTRY.setdefault(kind, {})
        for name in names:
            table[name] = fn
        return fn
    return deco


def resolve(kind: str, name: str) -> Callable:
    table = _REGISTRY.get(kind, {})
    if name not in table:
        known = ", ".join(sorted(table))
        raise KeyError(f"unknown {kind} module '{name}'; known: {known}")
    return table[name]


def known(kind: str):
    return sorted(_REGISTRY.get(kind, {}))
