"""Factories: config strings -> network parameters, renderer, evaluator and
visualizer (``relightableavatar_tpu/models/factory.py``, reference
``lib/networks/make_network.py``, ``make_renderer.py``), through the
registry, so the reference module strings keep working.

Checkpoints follow the reference's bootstrap: the relight stage first takes
its stage-1 geometry (``resd``, ``sdf``, ``beta``, ``rgb``) from
``cfg.geometry_pretrain`` (strict=False, ``relight_network.py:36-37``),
then the newest checkpoint of ``cfg.trained_model_dir`` replaces every
parameter; a reference ``latest.pth`` is imported through the ``.pth``
mapping.  The JAX package starts every network from a random initialisation
and renders whatever no checkpoint covered; the port starts from
``init_anisdf`` only when the caller asks for a cold start (the train
entry), and otherwise raises on a network that no checkpoint covers, naming
what it searched.
"""
from __future__ import annotations

from os.path import exists, isdir, join

import torch

from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig, init_anisdf
from relightableavatar_tpu_torch.renderer.mesh import MeshRenderer
from relightableavatar_tpu_torch.renderer.orchestrate import (NovelLightRenderer,
                                                             SphereTracingRenderer)
from relightableavatar_tpu_torch.renderer.volume import VolumeRenderer
from relightableavatar_tpu_torch.utils.log import log
from relightableavatar_tpu_torch.utils.registry import register, resolve
from relightableavatar_tpu_torch.weights import param_shapes, params_from_flat, read_checkpoint

GEOMETRY_KEYS = ('resd', 'sdf', 'beta', 'rgb')


register('renderer', 'lib.networks.renderer.base_renderer', 'base_renderer')(VolumeRenderer)
register('renderer', 'lib.networks.renderer.sphere_tracing_renderer',
         'sphere_tracing_renderer')(SphereTracingRenderer)
register('renderer', 'lib.networks.renderer.novel_light_sphere_tracing',
         'novel_light_sphere_tracing')(NovelLightRenderer)
register('renderer', 'lib.networks.renderer.mesh_renderer', 'mesh_renderer')(MeshRenderer)


def _read_flat(model_dir: str):
    """Flat parameters of the newest checkpoint of ``model_dir`` (a folder
    with ``latest.npz`` or ``<epoch>.npz``, or an npz file of bare
    parameter keys, as ``fixtures/`` holds), or None."""
    if not model_dir:
        return None
    if isdir(model_dir):
        flat, _, _ = read_checkpoint(model_dir)
        if flat is not None:
            return flat
        if exists(join(model_dir, 'latest.pth')):
            from relightableavatar_tpu_torch.train.checkpoints import pth_to_flat
            return pth_to_flat(join(model_dir, 'latest.pth'))
        return None
    if model_dir.endswith('.npz') and exists(model_dir):
        import numpy as np
        with np.load(model_dir) as f:
            return {k: f[k] for k in f.files}
    return None


def make_network(cfg, device="cuda", cold_start: bool = False, seed: int = 0):
    """Returns (params, mcfg). ``network_module`` (or ``cfg.relighting``)
    selects the stage (deform vs relight) as the reference config strings
    do.  Without ``cold_start`` it raises when no checkpoint holds every
    parameter of the network; with it, what no checkpoint covers comes from
    ``init_anisdf`` with a generator seeded by ``seed`` (the JAX package's
    ``make_network`` seeds its PRNG key with 0 too)."""
    relight = ('relight' in cfg.network_module) or cfg.relighting
    cfg.relighting = cfg.relighting or relight
    mcfg = AniSDFConfig.from_cfg(cfg)

    flat = {}
    searched = []
    if relight and cfg.geometry_pretrain:
        searched.append(f"geometry_pretrain {cfg.geometry_pretrain}")
        geo = _read_flat(cfg.geometry_pretrain)
        if geo is not None:
            geo = {k: v for k, v in geo.items() if k.split('/')[0] in GEOMETRY_KEYS}
            try:
                params_from_flat(geo, device="cpu", mcfg=mcfg._replace(relight=False))
            except (KeyError, ValueError) as e:
                log(f'partial load from {cfg.geometry_pretrain}: {e}', 'yellow')
            else:
                flat.update(geo)
                log(f'loaded geometry pretrain from {cfg.geometry_pretrain}', 'green')

    searched.append(f"trained_model_dir {cfg.trained_model_dir}")
    full = _read_flat(cfg.trained_model_dir)
    if full is not None:
        try:
            params = params_from_flat(full, device=device, mcfg=mcfg)
        except (KeyError, ValueError) as e:
            log(f'partial load from {cfg.trained_model_dir}: {e}', 'yellow')
        else:
            log(f'loaded network from {cfg.trained_model_dir}', 'green')
            return params, mcfg
    missing = sorted(set(param_shapes(mcfg)) - set(flat))
    if missing and cold_start:
        from relightableavatar_tpu_torch.train.checkpoints import named_params
        init = dict(named_params(init_anisdf(torch.Generator().manual_seed(seed), mcfg)))
        log(f'cold start: {len(missing)} parameters from init_anisdf (seed {seed})', 'green')
        flat = {**{k: v.numpy() for k, v in init.items()}, **flat}
        missing = []
    if missing:
        raise FileNotFoundError(
            f"no checkpoint holds every parameter of the network: {len(missing)} "
            f"missing ({', '.join(missing[:4])}, ...); searched " + "; ".join(searched)
            + ". The port has no random initialisation to render instead: point "
            "trained_model_dir at a folder with latest.npz")
    return params_from_flat(flat, device=device, mcfg=mcfg), mcfg


def make_renderer(cfg, params, mcfg, device="cuda"):
    ctor = resolve('renderer', cfg.renderer_module)
    return ctor(cfg, params, mcfg, device=device)


def make_evaluator(cfg):
    import relightableavatar_tpu_torch.eval.evaluator  # noqa: F401 registration
    return resolve('evaluator', cfg.evaluator_module)(cfg)


def make_visualizer(cfg):
    import relightableavatar_tpu_torch.vis.visualizer  # noqa: F401 registration
    return resolve('visualizer', cfg.visualizer_module)(cfg)
