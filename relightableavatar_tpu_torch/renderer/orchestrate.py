"""Frame orchestration (``relightableavatar_tpu/renderer/orchestrate.py``):
envmap selection, ray padding and blocking, per-block render, assembly.

The exact path of ``SphereTracingRenderer.render`` only: no ground pass, no
miss skip, no novel-light sweep (reference ``Renderer`` :943-1115).
"""
from __future__ import annotations

import numpy as np
import torch

from relightableavatar_tpu_torch.device import resolve_device
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.envmap import gen_light_xyz
from relightableavatar_tpu_torch.renderer.sphere_tracing import (
    RelightRenderConfig, render_human_block)
from relightableavatar_tpu_torch.renderer.tracing import STConfig
from relightableavatar_tpu_torch.utils.dotdict import dotdict


def _pad_rays(ray_o, ray_d, near, far, block):
    """Pad the ray arrays (numpy) to a multiple of ``block`` with short
    dummy rays; returns them and the real count."""
    P = len(ray_o)
    pad = (-P) % block
    if pad:
        ray_o = np.concatenate([ray_o, np.zeros((pad, 3), np.float32)])
        ray_d = np.concatenate([ray_d, np.tile([[0, 0, 1.0]], (pad, 1)).astype(np.float32)])
        near = np.concatenate([near, np.full(pad, 0.1, np.float32)])
        far = np.concatenate([far, np.full(pad, 0.11, np.float32)])
    return ray_o, ray_d, near, far, P


class SphereTracingRenderer:
    """The relight / sphere-traced renderer (reference Renderer :943-1115).

    ``params`` and the batch's ``ctx`` hold tensors on ``device``; ray
    arrays in the batch may be numpy."""

    def __init__(self, cfg, params, mcfg: AniSDFConfig, device="cuda"):
        if cfg.get('bruteforce_st', False):
            raise NotImplementedError(
                "bruteforce_st is broken in the reference and not built")
        if cfg.vis_ground_shading:
            raise NotImplementedError("vis_ground_shading (the ground pass) is not ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.mcfg = mcfg
        self.rcfg = RelightRenderConfig.from_cfg(cfg)
        self.st_surf = STConfig.from_cfg(cfg.sphere_tracing,
                                         clay_book=not cfg.no_claybook)
        self.st_obj = STConfig.from_cfg(
            {**dict(cfg.sphere_tracing), **dict(cfg.obj_lvis)},
            clay_book=not cfg.no_claybook)
        self.light_xyz, self.light_area = gen_light_xyz(cfg.env_h, cfg.env_w,
                                                        cfg.env_r, device=self.device)
        self.light_sharp = 1.0 / torch.sqrt(self.light_area / np.pi)
        self.block = int(cfg.tpu.ray_block)
        self._term_sdf_sum = 0.0
        self._term_sdf_cnt = 0.0

    def select_envmap(self, batch):
        if self.cfg.replace_light and 'novel_lights' in batch:
            raise NotImplementedError("replace_light (novel lights) is not ported")
        if 'env' in self.params:
            return dotdict(probe=anisdf.global_env_map(self.params, self.mcfg))
        return None

    @torch.no_grad()
    def render(self, batch) -> dotdict:
        """batch: ray_o, ray_d (..., 3), near, far (...), ctx -> dotdict of
        per-ray maps ((P, ...) tensors on the device) and ``envmap``."""
        cfg = self.cfg
        dev = self.device
        envmap = self.select_envmap(batch)
        probe = envmap.probe if envmap is not None else torch.ones(
            (cfg.env_h, cfg.env_w, 3), device=dev)
        if probe.dim() == 4:
            probe = probe[0]

        ray_o = np.asarray(batch.ray_o, np.float32).reshape(-1, 3)
        ray_d = np.asarray(batch.ray_d, np.float32).reshape(-1, 3)
        near = np.asarray(batch.near, np.float32).reshape(-1)
        far = np.asarray(batch.far, np.float32).reshape(-1)
        near = np.clip(near, cfg.clip_near, None)
        far = np.clip(far, None, cfg.clip_far)
        ray_o, ray_d, near, far, P = _pad_rays(ray_o, ray_d, near, far, self.block)
        if P == 0:
            return dotdict(rgb_map=torch.zeros((0, 3), device=dev),
                           acc_map=torch.zeros((0,), device=dev), envmap=envmap)

        put = lambda a: torch.as_tensor(a, device=dev)
        outs = []
        for i in range(0, len(ray_o), self.block):
            s = slice(i, i + self.block)
            outs.append(render_human_block(
                self.params, self.mcfg, batch.ctx, put(ray_o[s]), put(ray_d[s]),
                put(near[s]), put(far[s]), probe, self.light_xyz,
                self.light_area, self.light_sharp, self.st_surf, self.st_obj,
                self.rcfg))

        ret = dotdict()
        for k in outs[0]:
            if k.startswith('term_sdf_'):
                ret[k] = sum(float(o[k][0]) for o in outs)
            else:
                ret[k] = torch.cat([o[k] for o in outs], dim=0)[:P]
        ret.envmap = envmap

        if cfg.check_termination_sdf:
            # running average |sdf| at termination (reference :765-778)
            self._term_sdf_sum += ret.pop('term_sdf_sum')
            self._term_sdf_cnt += ret.pop('term_sdf_cnt')
            print(f'avg sdf abs: {self._term_sdf_sum / max(self._term_sdf_cnt, 1.0):.8f}')
        return ret
