"""Frame orchestration (``relightableavatar_tpu/renderer/orchestrate.py``):
envmap selection, ray padding and blocking, the per-frame SDF grid bake and
slice sweep, the frame-global miss skip, per-block render, assembly.

``SphereTracingRenderer.render`` only: no ground pass, no novel-light sweep
and no fused frame (reference ``Renderer`` :943-1115).
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from relightableavatar_tpu_torch.device import resolve_device
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.aabb import pad_box
from relightableavatar_tpu_torch.ops.envmap import gen_light_xyz
from relightableavatar_tpu_torch.ops.lvis_sweep import sweep_ratio_volume
from relightableavatar_tpu_torch.ops.sdf_grid import (axis_resolutions, build_hdq_grid,
                                                      grid_sdf_lower_bound, pack_grid_corners)
from relightableavatar_tpu_torch.renderer.sphere_tracing import (
    RelightRenderConfig, render_human_block)
from relightableavatar_tpu_torch.renderer.tracing import STConfig, safe_miss_march
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


def _assemble_unsort(outs, order_prefix: torch.Tensor, pp: int, p_out: int) -> dict:
    """Concatenate the rendered blocks, zero-fill the skipped proven-miss
    rays, undo the frame-global sort and cut to ``p_out``, key by key.
    Clean-miss pixels are all zero after the renderer's acc masking, so the
    zero rows equal rendering those blocks."""
    res = {}
    for k in outs[0]:
        cat = torch.cat([o[k] for o in outs], dim=0)
        full = cat.new_zeros((pp,) + tuple(cat.shape[1:]))
        full[order_prefix] = cat
        res[k] = full[:p_out]
    return res


class SphereTracingRenderer:
    """The relight / sphere-traced renderer (reference Renderer :943-1115).

    ``params`` and the batch's ``ctx`` hold tensors on ``device``; ray
    arrays in the batch may be numpy.  With ``time_stages`` set, ``render``
    synchronises the device after each stage and records the stages' wall
    seconds in ``last_frame``."""

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
        self._grid_res = None
        self._grid_ext = None
        self.time_stages = False
        self.last_frame = dotdict()

    # ------------------------------------------------------------- grid
    def grid_box(self, ctx) -> torch.Tensor:
        """(2, 3) box of the SDF grid: the body's world bounds padded by
        ``grid_margin``."""
        return pad_box(ctx["wbounds"], self.rcfg.grid_margin)

    def grid_resolution(self, gbox: torch.Tensor) -> tuple:
        """Per-axis lattice sizes, fixed on the first frame; warns when a
        later frame's box aspect drifts from it by more than 1.5x (the
        sweep's path-deviation bound assumes near-isotropic voxels)."""
        ext = (gbox[1] - gbox[0]).cpu().numpy()
        if self._grid_res is None:
            self._grid_res = axis_resolutions(ext, self.rcfg.shadow_grid)
            self._grid_ext = ext
        else:
            ratio = ext / np.maximum(self._grid_ext, 1e-6)
            if np.max(ratio) / np.min(ratio) > 1.5:
                warnings.warn(
                    f"shadow-grid box aspect drifted {ratio} from the first frame; "
                    "voxels are no longer near-isotropic and shadow accuracy may "
                    "degrade (recreate the renderer to recalibrate)", stacklevel=3)
                self._grid_ext = ext    # warn once per regime, not per frame
        return self._grid_res

    def bake_grid(self, ctx, gbox: torch.Tensor, packed: bool) -> torch.Tensor:
        """The frame's HDQ SDF on the grid (raw, or the packed corner table)."""
        return build_hdq_grid(self.params, self.mcfg, ctx, gbox[0], gbox[1],
                              self.grid_resolution(gbox), self.st_obj.dist_th,
                              packed=packed)

    def sweep_dirs(self) -> np.ndarray:
        """The sweep's directions: the coarse light grid that
        ``render_human_block`` traces at under ``lvis_downscale``."""
        eH, eW = int(self.cfg.env_h), int(self.cfg.env_w)
        k = self.rcfg.lvis_downscale
        hc, wc = (max(eH // k, 1), max(eW // k, 2)) if k > 1 else (eH, eW)
        xyz_c, _ = gen_light_xyz(hc, wc, self.rcfg.env_r, device="cpu")
        dirs = xyz_c.numpy().reshape(-1, 3)
        return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    def sweep_volume(self, grid3d: torch.Tensor, gbox: torch.Tensor) -> torch.Tensor:
        """The frame's DFSS ratio volume over the sweep directions."""
        return sweep_ratio_volume(grid3d, gbox[0], gbox[1], self.sweep_dirs(),
                                  float(self.st_obj.near_offset))

    def miss_march(self, grid, gbox, ray_o, ray_d, near, far) -> torch.Tensor:
        """(P,) bool: the rays the lower-bound march over the grid proves to
        be clean misses (``tracing.safe_miss_march``).  A raw grid is packed
        once here, not in each of the march's lookups."""
        if grid.dim() == 3:
            grid = pack_grid_corners(grid)
        lb = lambda x: grid_sdf_lower_bound(grid, gbox[0], gbox[1], x)
        return safe_miss_march(lb, ray_o, ray_d, near, far, float(self.st_surf.tan_i),
                               float(self.rcfg.surf_skip_margin),
                               int(self.rcfg.surf_skip_iters))

    # ------------------------------------------------------------- envmap
    def select_envmap(self, batch):
        if self.cfg.replace_light and 'novel_lights' in batch:
            raise NotImplementedError("replace_light (novel lights) is not ported")
        if 'env' in self.params:
            return dotdict(probe=anisdf.global_env_map(self.params, self.mcfg))
        return None

    def _stage(self, name: str, t0: float) -> float:
        """Under ``time_stages``: synchronise and record the stage's seconds."""
        if not self.time_stages:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.last_frame[name + '_s'] = t1 - t0
        return t1

    # ------------------------------------------------------------- render
    @torch.no_grad()
    def render(self, batch) -> dotdict:
        """batch: ray_o, ray_d (..., 3), near, far (...), ctx -> dotdict of
        per-ray maps ((P, ...) tensors on the device) and ``envmap``."""
        cfg = self.cfg
        rcfg = self.rcfg
        dev = self.device
        ctx = batch.ctx
        self.last_frame = dotdict()
        if self.time_stages and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
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

        # the shadow SDF grid, baked once per frame (the HDQ field is frozen
        # at inference) and shared by every ray block; under lvis_sweep it
        # also feeds the slice-sweep visibility volume
        shadow_sdf_grid = lvis_volume = gbox = None
        if rcfg.shadow_grid > 0:
            gbox = self.grid_box(ctx)
            shadow_sdf_grid = self.bake_grid(ctx, gbox, packed=not rcfg.lvis_sweep)
            self.last_frame.grid_res = self._grid_res
            t0 = self._stage('bake', t0)
            if rcfg.lvis_sweep:
                lvis_volume = self.sweep_volume(shadow_sdf_grid, gbox)
                t0 = self._stage('sweep', t0)

        # frame-global miss skip: the rays proven to be clean misses by one
        # march over the grid's lower bound are sorted to the tail, and the
        # ray blocks left with only such rays do no device work (their maps
        # are zero, exactly as rendering them would give)
        put = lambda a: torch.as_tensor(a, device=dev)
        order = None
        n_active = len(ray_o)
        block_rcfg = rcfg
        if (rcfg.surf_miss_skip and shadow_sdf_grid is not None
                and not rcfg.want_light_maps and not rcfg.check_bound_sdf
                and not rcfg.check_termination_sdf):
            miss = self.miss_march(shadow_sdf_grid, gbox, put(ray_o), put(ray_d),
                                   put(near), put(far)).cpu().numpy()
            order = np.argsort(miss, kind='stable')          # active rays first
            ray_o, ray_d, near, far = ray_o[order], ray_d[order], near[order], far[order]
            n_active = int((~miss).sum())
            # the in-block skip would only re-march the now dense blocks
            block_rcfg = rcfg._replace(surf_miss_skip=False)
            t0 = self._stage('march', t0)

        outs = []
        for i in range(0, len(ray_o), self.block):
            if order is not None and i >= n_active and outs:
                continue                                     # proven-miss block
            s = slice(i, i + self.block)
            outs.append(render_human_block(
                self.params, self.mcfg, ctx, put(ray_o[s]), put(ray_d[s]),
                put(near[s]), put(far[s]), probe, self.light_xyz,
                self.light_area, self.light_sharp, self.st_surf, self.st_obj,
                block_rcfg, shadow_sdf_grid=shadow_sdf_grid, lvis_volume=lvis_volume))
        self.last_frame.blocks = len(ray_o) // self.block
        self.last_frame.blocks_rendered = len(outs)
        t0 = self._stage('blocks', t0)

        ret = dotdict()
        if order is not None:
            prefix = torch.as_tensor(order[:len(outs) * self.block], device=dev)
            ret.update(_assemble_unsort(outs, prefix, len(ray_o), P))
        else:
            for k in outs[0]:
                if k.startswith('term_sdf_'):
                    ret[k] = sum(float(o[k][0]) for o in outs)
                else:
                    ret[k] = torch.cat([o[k] for o in outs], dim=0)[:P]
        ret.envmap = envmap
        self._stage('assemble', t0)

        if cfg.check_termination_sdf:
            # running average |sdf| at termination (reference :765-778)
            self._term_sdf_sum += ret.pop('term_sdf_sum')
            self._term_sdf_cnt += ret.pop('term_sdf_cnt')
            print(f'avg sdf abs: {self._term_sdf_sum / max(self._term_sdf_cnt, 1.0):.8f}')
        return ret
