"""Config tree with yacs-compatible semantics: a copy of
``relightableavatar_tpu/config/node.py`` for the port.

An attribute-access config node (CN), recursive ``parent_cfg``/``parent_cfgs``
inheritance (reference ``yacs.py:285-294`` ``merge_strain``), recursive
merging of overlay sub-configs, and ``merge_from_list`` CLI ``k v`` pairs with
type coercion (reference ``yacs.py:177``).  YAML files are read by the
port's own :mod:`~relightableavatar_tpu_torch.config.yaml_subset`, typed as
PyYAML's ``safe_load`` types them, so the CPU and the card read the same
tree without PyYAML.
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, List

from relightableavatar_tpu_torch.config.yaml_subset import load_file
from relightableavatar_tpu_torch.utils.dotdict import dotdict


def _read_yaml(path: str) -> dict:
    return load_file(path) or {}


class CN(dotdict):
    """Config node: a dotdict with yacs-style merge operations."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CN(v) if isinstance(v, dict) and not isinstance(v, CN) else v

    def clone(self) -> "CN":
        return copy.deepcopy(self)

    def merge_from_other_cfg(self, other: dict) -> None:
        """Recursively merge ``other`` into self (other wins)."""
        _merge_into(self, other)

    def merge_strain(self, cfg_or_path) -> None:
        """Merge a YAML config (a path) or a dict, first recursively merging
        its ``parent_cfg``/``parent_cfgs`` chain (deepest ancestor first)."""
        if isinstance(cfg_or_path, str):
            data = _read_yaml(cfg_or_path)
        else:
            data = dict(cfg_or_path)

        parents: List[str] = []
        if "parent_cfg" in data:
            parents.append(data.pop("parent_cfg"))
        if "parent_cfgs" in data:
            parents.extend(data.pop("parent_cfgs"))
        for p in parents:
            if os.path.exists(p):
                self.merge_strain(p)

        _merge_into(self, data)

    def merge_from_list(self, opts: List[str]) -> None:
        """Merge flat ``[k, v, k, v, ...]`` command-line pairs."""
        if not opts:
            return
        if len(opts) % 2:
            raise ValueError(f"override list must be key/value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for part in parts[:-1]:
                if part not in node or not isinstance(node[part], dict):
                    node[part] = CN()
                node = node[part]
            leaf = parts[-1]
            old = node.get(leaf, None)
            node[leaf] = _coerce(value, old)


def _merge_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            if k in dst and isinstance(dst[k], dict):
                _merge_into(dst[k], v)
            else:
                dst[k] = CN(v)
        else:
            if k in dst and dst[k] is not None and v is not None:
                dst[k] = _coerce_typed(v, dst[k])
            else:
                dst[k] = v


def _coerce(value: str, old: Any):
    """Parse a CLI string literal, then coerce toward the old value's type."""
    try:
        parsed = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        parsed = value
    if old is None:
        return parsed
    return _coerce_typed(parsed, old)


def _coerce_typed(new: Any, old: Any):
    """Best-effort type reconciliation matching yacs's coercion rules."""
    if isinstance(old, bool) and isinstance(new, (int, str)):
        if isinstance(new, str):
            if new.lower() in ("true", "1"):
                return True
            if new.lower() in ("false", "0"):
                return False
            return new
        return bool(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, int) and isinstance(new, float) and new.is_integer():
        return int(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    return new
