"""Config assembly for the port: code defaults, a YAML chain, CLI ``k v``
pairs and the relighting / sphere-tracing mode overlays, in the merge order
of ``relightableavatar_tpu/config/__init__.py:update_cfg`` (reference
``lib/config/config.py:487-519``).  No platform switch and no global config:
callers build a tree with :func:`default_cfg` or :func:`make_cfg` and pass it.
"""
from __future__ import annotations

from relightableavatar_tpu_torch.config.defaults import Output, default_cfg
from relightableavatar_tpu_torch.config.node import CN

__all__ = ["CN", "Output", "default_cfg", "apply_mode_overlays", "make_cfg"]


def apply_mode_overlays(cfg: CN) -> CN:
    """Merge the ``relighting_cfg`` and ``sphere_tracing_cfg`` overlays when
    their mode is on (the two modes this slice renders)."""
    if cfg.relighting and 'relighting_cfg' in cfg:
        cfg.merge_from_other_cfg(cfg.relighting_cfg)
    if cfg.vis_sphere_tracing and 'sphere_tracing_cfg' in cfg:
        cfg.merge_from_other_cfg(cfg.sphere_tracing_cfg)
    return cfg


def make_cfg(cfg_file: str | None = None, opts: list | None = None) -> CN:
    """defaults -> YAML chain -> CLI opts -> mode overlays -> CLI opts."""
    cfg = default_cfg()
    if cfg_file:
        cfg.merge_strain(cfg_file)
    cfg.merge_from_list(opts or [])
    apply_mode_overlays(cfg)
    cfg.merge_from_list(opts or [])
    if cfg.cond_dim < 0:
        cfg.cond_dim = cfg.n_bones * 3
    return cfg
