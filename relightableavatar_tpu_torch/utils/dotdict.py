"""Attribute-access dict container for batches, render outputs and configs.

A copy of ``relightableavatar_tpu/utils/dotdict.py`` without the JAX pytree
registration: a plain ``dict`` whose items are also reachable as attributes,
recursively wrapping nested dicts on access.
"""
from __future__ import annotations

from typing import Any


class dotdict(dict):
    """dict with attribute access; nested dicts are wrapped lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, dotdict):
            value = dotdict(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self) -> "dotdict":
        return dotdict(dict.copy(self))
