"""Frame orchestration (``relightableavatar_tpu/renderer/orchestrate.py``):
envmap selection (learned or ``replace_light``), ray padding and blocking,
the per-frame SDF grid bake and slice sweep, the frame-global miss skip,
per-block render, assembly, the full-frame ground pass, and the novel-light
sweep that traces geometry and visibility once and re-shades per light
(reference ``sphere_tracing_renderer.py:1066-1115`` and
``novel_light_sphere_tracing.py:21-221``).

``tpu.frame_fuse`` (the JAX package's one executable a frame: the bake, the
sweep and a ``lax.scan`` over the ray blocks) renders through the per-block
loop, whose pixels the fused frame equals.

Under a process group (``torchrun``, ``parallel/mesh.py``) each ray block
is split over the ranks (the block padded to a multiple of the world): each
rank renders its slice and the maps are gathered, so every rank holds the
frame, as the JAX package's sharded arrays are global.  The grid bake and
the slice sweep run whole on every rank (JAX's context is replicated), the
frame-global miss skip is off (JAX's ``self.mesh is None``) while the
in-block skip stays, the termination statistic is summed over the ranks,
and the novel-light re-shade runs on each rank's slice of the base maps.
The ground pass runs whole on every rank.
"""
from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch

from relightableavatar_tpu_torch.data.rays import get_rays
from relightableavatar_tpu_torch.device import resolve_device, to_device
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.aabb import pad_box
from relightableavatar_tpu_torch.ops.brdf import evaluate_shade, microfacet_brdf, safe_divide
from relightableavatar_tpu_torch.ops.envmap import (gen_light_xyz, linear2srgb, probe_at_texels,
                                                    rotate_envmap_dict, sample_envmap_image)
from relightableavatar_tpu_torch.ops.lbs import normalize
from relightableavatar_tpu_torch.ops.lvis_sweep import sweep_ratio_volume
from relightableavatar_tpu_torch.ops.sdf_grid import (axis_resolutions, build_hdq_grid,
                                                      grid_sdf_lower_bound, pack_grid_corners)
from relightableavatar_tpu_torch.parallel.mesh import (all_sum, distributed, gather_rays,
                                                       get_mesh, shard_rays)
from relightableavatar_tpu_torch.renderer.ground import render_ground_block
from relightableavatar_tpu_torch.renderer.sphere_tracing import (
    RelightRenderConfig, render_human_block)
from relightableavatar_tpu_torch.renderer.tracing import STConfig, safe_miss_march
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.log import log
from relightableavatar_tpu_torch.utils.profiling import host_sync, span


def pad_rays(ray_o, ray_d, near, far, block, far_pad: float = 0.11):
    """Pad the ray arrays (numpy) to a multiple of ``block`` with short
    dummy rays from the origin along +z over [0.1, ``far_pad``] (the volume
    renderer's reach to 0.2); returns them and the real count."""
    P = len(ray_o)
    pad = (-P) % block
    if pad:
        ray_o = np.concatenate([ray_o, np.zeros((pad, 3), np.float32)])
        ray_d = np.concatenate([ray_d, np.tile([[0, 0, 1.0]], (pad, 1)).astype(np.float32)])
        near = np.concatenate([near, np.full(pad, 0.1, np.float32)])
        far = np.concatenate([far, np.full(pad, far_pad, np.float32)])
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
    arrays in the batch may be numpy.  ``last_frame`` holds the frame's
    counts (``blocks``, ``blocks_rendered``, ``grid_res``; ``shadow_rays``,
    the ground pass's traced shadow rays); its stages are program spans
    (``render.frame`` > ``render.bake``, ``render.sweep``, ``render.march``,
    ``render.block``, ``render.assemble``, ``render.ground``;
    ``utils/profiling.py``)."""

    def __init__(self, cfg, params, mcfg: AniSDFConfig, device="cuda"):
        if cfg.get('bruteforce_st', False):
            raise NotImplementedError(
                "bruteforce_st is broken in the reference and not built")
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
        if cfg.tpu.frame_fuse:
            log('tpu.frame_fuse: the frame renders through the per-block loop, whose pixels '
                "the JAX package's fused frame equals", 'yellow')
        # multi-GPU rendering: each rank owns a slice of every ray block
        self.mesh = get_mesh(cfg, device=self.device) if distributed() else None
        if self.mesh is not None:
            self.block += (-self.block) % self.mesh.world
        self._term_sdf_sum = 0.0
        self._term_sdf_cnt = 0.0
        self._grid_res = None
        self._grid_ext = None
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
        host_sync("grid_extent")
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
        """The frame's HDQ SDF on the grid (raw, or the packed corner table),
        against the vertex subsample under ``tpu.shadow_verts_sub``."""
        return build_hdq_grid(self.params, self.mcfg, ctx, gbox[0], gbox[1],
                              self.grid_resolution(gbox), self.st_obj.dist_th,
                              packed=packed, verts_sub=self.rcfg.shadow_verts_sub)

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
    def to_device(self, a) -> torch.Tensor:
        """A probe or image (numpy or tensor) as a float32 tensor on the device."""
        if isinstance(a, torch.Tensor) and a.device == self.device:
            return a.to(torch.float32)
        return to_device(a, self.device, torch.float32)

    def select_envmap(self, batch):
        """The light of the frame: ``batch.novel_lights[cfg.replace_light]``
        when that is set (its arrays moved to the device), else the learned
        env map, else None."""
        if self.cfg.replace_light and 'novel_lights' in batch:
            env = batch.novel_lights[self.cfg.replace_light]
            return dotdict({k: self.to_device(v) for k, v in env.items()})
        if 'env' in self.params:
            return dotdict(probe=anisdf.global_env_map(self.params, self.mcfg))
        return None

    # ------------------------------------------------------------- render
    @torch.no_grad()
    def render(self, batch) -> dotdict:
        """batch: ray_o, ray_d (..., 3), near, far (...), ctx -> dotdict of
        per-ray maps ((P, ...) tensors on the device) and ``envmap``."""
        with span("render.frame"):
            return self._render(batch)

    def _render(self, batch) -> dotdict:
        cfg = self.cfg
        rcfg = self.rcfg
        dev = self.device
        ctx = batch.ctx
        self.last_frame = dotdict()
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
        ray_o, ray_d, near, far, P = pad_rays(ray_o, ray_d, near, far, self.block)
        if P == 0:
            return dotdict(rgb_map=torch.zeros((0, 3), device=dev),
                           acc_map=torch.zeros((0,), device=dev), envmap=envmap)

        # the shadow SDF grid, baked once per frame (the HDQ field is frozen
        # at inference) and shared by every ray block; under lvis_sweep it
        # also feeds the slice-sweep visibility volume
        shadow_sdf_grid = lvis_volume = gbox = None
        if rcfg.shadow_grid > 0:
            with span("render.bake"):
                gbox = self.grid_box(ctx)
                shadow_sdf_grid = self.bake_grid(ctx, gbox, packed=not rcfg.lvis_sweep)
            self.last_frame.grid_res = self._grid_res
            if rcfg.lvis_sweep:
                with span("render.sweep"):
                    lvis_volume = self.sweep_volume(shadow_sdf_grid, gbox)
                    if rcfg.surf_grid_iters > 0:
                        # every ray block's pre-march reads the lower bound: pack
                        # the corners once here, not in each lookup
                        shadow_sdf_grid = pack_grid_corners(shadow_sdf_grid)

        # frame-global miss skip: the rays proven to be clean misses by one
        # march over the grid's lower bound are sorted to the tail, and the
        # ray blocks left with only such rays do no device work (their maps
        # are zero, exactly as rendering them would give)
        put = lambda a: to_device(a, dev)
        order = None
        n_active = len(ray_o)
        block_rcfg = rcfg
        if (rcfg.surf_miss_skip and shadow_sdf_grid is not None and self.mesh is None
                and rcfg.ablate_mode == 'hdq' and not rcfg.want_light_maps
                and not rcfg.check_bound_sdf and not rcfg.check_termination_sdf):
            with span("render.march"):
                miss = self.miss_march(shadow_sdf_grid, gbox, put(ray_o), put(ray_d),
                                       put(near), put(far))
                host_sync("miss_mask")
                miss = miss.cpu().numpy()
                order = np.argsort(miss, kind='stable')          # active rays first
                ray_o, ray_d, near, far = ray_o[order], ray_d[order], near[order], far[order]
                n_active = int((~miss).sum())
                # the in-block skip would only re-march the now dense blocks
                block_rcfg = rcfg._replace(surf_miss_skip=False)

        own = (lambda a: a) if self.mesh is None else (lambda a: shard_rays(self.mesh, a))
        outs = []
        for i in range(0, len(ray_o), self.block):
            if order is not None and i >= n_active and outs:
                continue                                     # proven-miss block
            s = slice(i, i + self.block)
            with span("render.block"):
                outs.append(render_human_block(
                    self.params, self.mcfg, ctx, put(own(ray_o[s])), put(own(ray_d[s])),
                    put(own(near[s])), put(own(far[s])), probe, self.light_xyz,
                    self.light_area, self.light_sharp, self.st_surf, self.st_obj,
                    block_rcfg, shadow_sdf_grid=shadow_sdf_grid, lvis_volume=lvis_volume))
        self.last_frame.blocks = len(ray_o) // self.block
        self.last_frame.blocks_rendered = len(outs)

        ret = dotdict()
        with span("render.assemble"):
            if order is not None:
                prefix = put(order[:len(outs) * self.block])
                ret.update(_assemble_unsort(outs, prefix, len(ray_o), P))
            elif self.mesh is not None:
                ret.update(self._gather_blocks(outs, P))
            else:
                for k in outs[0]:
                    if k.startswith('term_sdf_'):
                        for _ in outs:
                            host_sync("term_sdf")
                        ret[k] = sum(float(o[k][0]) for o in outs)
                    else:
                        ret[k] = torch.cat([o[k] for o in outs], dim=0)[:P]
        ret.envmap = envmap

        if cfg.check_termination_sdf:
            # running average |sdf| at termination (reference :765-778)
            self._term_sdf_sum += ret.pop('term_sdf_sum')
            self._term_sdf_cnt += ret.pop('term_sdf_cnt')
            print(f'avg sdf abs: {self._term_sdf_sum / max(self._term_sdf_cnt, 1.0):.8f}')

        if cfg.vis_ground_shading and 'H' in batch:
            with span("render.ground"):
                ret = self._render_ground(batch, ret, envmap)
        return ret

    def _gather_blocks(self, outs, P: int) -> dict:
        """The maps of every rank's block slices, in the frame's ray order
        (block by block, each block rank by rank), cut to ``P``; the
        termination statistic summed over the ranks."""
        res = {}
        W, nb = self.mesh.world, len(outs)
        for k in outs[0]:
            if k.startswith('term_sdf_'):
                res[k] = float(all_sum(self.mesh, sum(o[k][0] for o in outs)))
                continue
            mine = torch.cat([o[k] for o in outs], dim=0)        # (nb * b/W, ...)
            full = gather_rays(self.mesh, mine)                  # rank by rank
            tail = tuple(full.shape[1:])
            full = full.reshape((W, nb, -1) + tail).transpose(0, 1)
            res[k] = full.reshape((-1,) + tail)[:P]
        return res

    # ------------------------------------------------------------- ground
    def _render_ground(self, batch, ret, envmap, mutate_mask: bool = True) -> dotdict:
        """Full-frame ground pass and alpha blend (reference
        sphere_tracing_renderer.py:1084-1113, blend_output_): every pixel of
        the H x W frame hits the ground plane, and each map becomes
        human x acc (scattered to the frame) + ground x (1 - acc).  The batch
        carries ``H``, ``W``, ``cam_K``, ``cam_R``, ``cam_T`` and the flat
        ``mask_at_box`` of the rays in ``ret``.  ``acc_map`` becomes all ones,
        and with ``mutate_mask`` ``batch.mask_at_box`` becomes the full frame;
        ``mutate_mask=False`` keeps it, so the pass can run once per novel
        light against the same base."""
        cfg = self.cfg
        dev = self.device
        H, W = int(batch.H), int(batch.W)
        F = H * W
        ray_o, ray_d = get_rays(H, W, np.asarray(batch.cam_K), np.asarray(batch.cam_R),
                                np.asarray(batch.cam_T))
        ray_o = ray_o.reshape(F, 3)
        ray_d = ray_d.reshape(F, 3)

        # the body's alpha over the full frame; the ground sees its complement
        mab = to_device(np.asarray(batch.mask_at_box).reshape(F), dev)
        acc = ret.acc_map
        acc_full = acc.new_zeros(F)
        host_sync("ground_mask")
        acc_full[mab] = acc
        bg_alpha = 1.0 - acc_full

        st_env = STConfig.from_cfg({**dict(cfg.sphere_tracing), **dict(cfg.env_lvis)},
                                   clay_book=not cfg.no_claybook)
        probe = envmap.probe if envmap is not None else torch.ones(
            (cfg.env_h, cfg.env_w, 3), device=dev)
        if probe.dim() == 4:
            probe = probe[0]
        image = envmap.get('image', None) if envmap is not None else None
        if image is not None and image.dim() == 4:
            image = image[0]
        vec = lambda a: to_device(np.asarray(a, np.float32), dev)
        g_norm, g_orig, g_albedo = vec(cfg.ground_normal), vec(cfg.ground_origin), \
            vec(cfg.ground_albedo)

        pad = (-F) % self.block
        ro = to_device(np.concatenate([ray_o, np.zeros((pad, 3), np.float32)]), dev)
        rd = to_device(np.concatenate(
            [ray_d, np.tile([[0, 0, 1.0]], (pad, 1)).astype(np.float32)]), dev)
        af = torch.cat([bg_alpha, bg_alpha.new_zeros(pad)])
        stats = {}
        grounds = []
        for i in range(0, F + pad, self.block):
            s = slice(i, i + self.block)
            grounds.append(render_ground_block(
                self.params, self.mcfg, batch.ctx, ro[s], rd[s], af[s], probe,
                image if image is not None else probe, self.light_xyz, self.light_area,
                self.light_sharp, g_norm, g_orig, g_albedo, st_env, self.rcfg,
                bool(cfg.ground_attach_envmap), stats=stats))
        self.last_frame.shadow_rays = self.last_frame.get('shadow_rays', 0) + \
            stats.get('shadow_rays', 0)

        merged = dotdict(ret)
        for k in _GROUND_BLEND_KEYS:
            if k not in grounds[0]:
                continue
            gv = torch.cat([g[k] for g in grounds], dim=0)[:F]
            full = torch.zeros_like(gv)
            if k in ret:
                a = acc if ret[k].dim() == 1 else acc[:, None]
                host_sync("ground_mask")
                full[mab] = ret[k] * a
            merged[k] = full + gv * (bg_alpha if gv.dim() == 1 else bg_alpha[:, None])
        merged.acc_map = torch.ones(F, dtype=acc.dtype, device=dev)
        if mutate_mask:
            batch.mask_at_box = np.ones((H, W), bool)
        merged.envmap = envmap
        return merged


# the maps the ground pass blends under the body (reference blend_output_)
_GROUND_BLEND_KEYS = ('rgb_map', 'surf_map', 'albedo_map', 'roughness_map', 'norm_map',
                      'cpts_map', 'bpts_map', 'spec_map', 'depth_map', 'shade_map')


# ---------------------------------------------------------------- re-shade
def reshade_dense(surf, norm, albedo, roughness, lvis, ldot, acc, ray_o,
                  probe, light_xyz, light_area, rcfg: RelightRenderConfig) -> dotdict:
    """Re-shade in the reference's layout: the plain (P, L, 3) composition
    of microfacet_brdf and evaluate_shade (novel_light_sphere_tracing.py:21-98).
    The oracle of :func:`reshade_block`; its (P, L, 3) buffers make it the
    memory-heavy form, so the sweep does not run it."""
    P = surf.shape[0]
    L = light_xyz.shape[0] * light_xyz.shape[1]
    xyz = light_xyz.reshape(L, 3)
    area = light_area.reshape(L)

    surf2light = normalize(xyz[None, :, :] - surf[:, None, :])
    surf2cam = normalize(ray_o - surf)
    if rcfg.distant_envmap:
        light = probe_at_texels(probe, light_xyz)[None].expand(P, L, 3)
    else:
        light = sample_envmap_image(probe, surf2light)

    ldot_shade = torch.ones_like(ldot) if rcfg.cancel_cosine else ldot
    shade = evaluate_shade(lvis, ldot_shade, area, light)
    brdf = microfacet_brdf(surf2light, surf2cam, norm, albedo, roughness,
                           f0=rcfg.fresnel_f0, lambert_only=rcfg.lambert_only,
                           glossy_only=rcfg.glossy_only, cancel_cosine=rcfg.cancel_cosine)
    rgb = torch.sum(brdf * shade, dim=-2)
    if rcfg.tonemapping:
        rgb = linear2srgb(rgb)
    rgb = rgb * acc[:, None]

    shade_map = torch.sum(evaluate_shade(lvis, ldot, area, light), dim=-2)
    shade_map = shade_map * rcfg.shading_albedo / np.pi * acc[:, None]
    return dotdict(rgb_map=rgb, shade_map=shade_map)


def _reshade_weights(surf, norm, albedo, roughness, lvis, ldot, ray_o,
                     light_xyz, light_area, rcfg: RelightRenderConfig):
    """The probe-independent part of the re-shade: per (point, texel)
    contraction weights, each (P, L) with the texels minor.  They depend
    only on the cached geometry and visibility, so a sweep of K lights
    computes them once.

    Returns (A, B, w2, sx, sy, sz): glossy, lambert and shade-map weights
    and the normalised surface-to-light components the equirect lookup of a
    non-distant envmap needs."""
    L = light_xyz.shape[0] * light_xyz.shape[1]
    xyz = light_xyz.reshape(L, 3)
    area = light_area.reshape(L)

    sx = xyz[None, :, 0] - surf[:, 0, None]
    sy = xyz[None, :, 1] - surf[:, 1, None]
    sz = xyz[None, :, 2] - surf[:, 2, None]
    inv = torch.rsqrt(sx * sx + sy * sy + sz * sz + 1e-16)     # normalize eps 1e-8
    sx, sy, sz = sx * inv, sy * inv, sz * inv
    # the brdf normalises its inputs again at eps 1e-7 (microfacet_brdf)
    inv = torch.rsqrt(sx * sx + sy * sy + sz * sz + 1e-14)
    lx, ly, lz = sx * inv, sy * inv, sz * inv

    pts2c = normalize(normalize(ray_o - surf), eps=1e-7)       # (P, 3)
    n = normalize(norm, eps=1e-7)
    vx, vy, vz = pts2c[:, 0:1], pts2c[:, 1:2], pts2c[:, 2:3]   # (P, 1)
    nx, ny, nz = n[:, 0:1], n[:, 1:2], n[:, 2:3]

    l_dot_n = torch.clamp(lx * nx + ly * ny + lz * nz, 1e-4, 1.0)             # (P, L)
    v_dot_n = torch.clamp(torch.sum(pts2c * n, dim=-1, keepdim=True), 1e-4, 1.0)

    hx, hy, hz = lx + vx, ly + vy, lz + vz                     # half vector
    hinv = torch.rsqrt(hx * hx + hy * hy + hz * hz + 1e-14)
    hx, hy, hz = hx * hinv, hy * hinv, hz * hinv

    alpha = roughness ** 2                                     # (P, 1)
    cos_lh = lx * hx + ly * hy + lz * hz
    f0 = rcfg.fresnel_f0
    fres = f0 + (1 - f0) * (1 - cos_lh) ** 5
    cos_theta_m = hx * nx + hy * ny + hz * nz
    chi_d = (cos_theta_m > 0).to(cos_theta_m.dtype)
    cos_m_sq = torch.square(cos_theta_m)
    tan_m_sq = safe_divide(1 - cos_m_sq, cos_m_sq)
    denom_d = math.pi * torch.square(cos_m_sq) * torch.square(alpha ** 2 + tan_m_sq)
    dist = safe_divide(alpha ** 2 * chi_d, denom_d)

    cos_theta_v = torch.sum(n * pts2c, dim=-1, keepdim=True)   # (P, 1)
    cos_theta = hx * vx + hy * vy + hz * vz
    div = safe_divide(cos_theta, cos_theta_v)
    chi_g = (div > 0).to(div.dtype)
    cos_v_sq = torch.clamp(torch.square(cos_theta_v), 0.0, 1.0)
    tan_v_sq = torch.clamp(safe_divide(1 - cos_v_sq, cos_v_sq), 0.0, 1e10)
    denom_g = 1 + torch.sqrt(1 + alpha ** 2 * tan_v_sq)
    g = safe_divide(chi_g * 2, denom_g)

    ldn = torch.ones_like(l_dot_n) if rcfg.cancel_cosine else l_dot_n
    micro = safe_divide(fres * g * dist, 4 * torch.abs(ldn) * torch.abs(v_dot_n))
    lamb = (l_dot_n / math.pi) if rcfg.cancel_cosine \
        else torch.full_like(l_dot_n, 1.0 / math.pi)

    ldot_shade = torch.ones_like(ldot) if rcfg.cancel_cosine else ldot
    w = lvis * ldot_shade * area[None, :]                      # (P, L)
    w2 = lvis * ldot * area[None, :]                           # shade-map weights
    return micro * w, lamb * w, w2, sx, sy, sz


def _equirect_contract(img, A, B, w2, sx, sy, sz):
    """Contract the (P, L) weight planes against the bilinear equirect
    lookup of ``img`` in each (point, texel) direction, without building
    the (P, L, 3) light.  Returns (sumA, sumB, shade_sum), each (P, 3)."""
    eH, eW = img.shape[:2]
    sn = torch.sqrt(sx * sx + sy * sy + sz * sz)
    dz = sz / (sn + 1e-13)
    theta = torch.arccos(torch.clamp(dz, -1.0, 1.0)) - 1e-6
    phi = torch.atan2(sy, sx)           # scale-invariant: sy / sx == dy / dx
    px = (-phi / math.pi + 1) * 0.5 * eW
    py = (theta / math.pi) * eH
    x0 = torch.floor(px - 0.5)
    y0 = torch.floor(py - 0.5)
    wx = (px - 0.5) - x0
    wy = (py - 0.5) - y0
    x0l, y0l = x0.to(torch.int64), y0.to(torch.int64)
    x0i, x1i = x0l.clamp(0, eW - 1), (x0l + 1).clamp(0, eW - 1)
    y0i, y1i = y0l.clamp(0, eH - 1), (y0l + 1).clamp(0, eH - 1)
    sums = []
    for wgt in (A, B, w2):
        ch = []
        for c in range(3):
            pc = img[..., c]
            lc = ((pc[y0i, x0i] * (1 - wx) + pc[y0i, x1i] * wx) * (1 - wy)
                  + (pc[y1i, x0i] * (1 - wx) + pc[y1i, x1i] * wx) * wy)
            ch.append(torch.sum(wgt * lc, dim=-1))
        sums.append(torch.stack(ch, dim=-1))                   # (P, 3)
    return sums


def _finish_reshade(sumA, sumB, shade_sum, albedo, acc, rcfg: RelightRenderConfig) -> dotdict:
    """Lobes, tone mapping and the body's alpha of the contracted sums;
    ``albedo`` and ``acc`` broadcast against them."""
    if rcfg.lambert_only:
        rgb = albedo * sumB
    elif rcfg.glossy_only:
        rgb = sumA
    else:
        rgb = sumA + albedo * sumB
    if rcfg.tonemapping:
        rgb = linear2srgb(rgb)
    rgb = rgb * acc
    shade_map = shade_sum * rcfg.shading_albedo / np.pi * acc
    return dotdict(rgb_map=rgb, shade_map=shade_map)


@torch.no_grad()
def reshade_block(surf, norm, albedo, roughness, lvis, ldot, acc, ray_o,
                  probe, light_xyz, light_area, rcfg: RelightRenderConfig) -> dotdict:
    """Re-shade cached geometry and visibility under a new envmap with the
    light axis contracted: the GGX lobe does not depend on the channel and
    the lambert lobe separates as albedo_c x B, so

        rgb_c = sum_L glossy w light_c + albedo_c sum_L lambert w light_c,

    which under a distant envmap is (P, L) @ (L, 3) products (float32; TF32
    is off on the card).  Same normalize eps chain and safe_divide clamps
    as :func:`reshade_dense`."""
    A, B, w2, sx, sy, sz = _reshade_weights(surf, norm, albedo, roughness, lvis, ldot,
                                            ray_o, light_xyz, light_area, rcfg)
    if rcfg.distant_envmap:
        lt = probe_at_texels(probe, light_xyz)                 # (L, 3)
        sumA, sumB, shade_sum = A @ lt, B @ lt, w2 @ lt
    else:
        img = probe[0] if probe.dim() == 4 else probe
        sumA, sumB, shade_sum = _equirect_contract(img, A, B, w2, sx, sy, sz)
    return _finish_reshade(sumA, sumB, shade_sum, albedo, acc[:, None], rcfg)


@torch.no_grad()
def reshade_sweep_block(surf, norm, albedo, roughness, lvis, ldot, acc, ray_o, probes,
                        light_xyz, light_area, rcfg: RelightRenderConfig) -> dotdict:
    """Re-shade under K envmaps at once: ``probes`` (K, eH, eW, 3) -> maps
    (K, P, 3).  The weights are computed once; under a distant envmap the K
    probes' (L, 3) texel colours stack into (L, 3K) and the sweep is three
    (P, L) @ (L, 3K) products.  Other probes keep one equirect contraction
    each."""
    K = probes.shape[0]
    P = surf.shape[0]
    A, B, w2, sx, sy, sz = _reshade_weights(surf, norm, albedo, roughness, lvis, ldot,
                                            ray_o, light_xyz, light_area, rcfg)
    if rcfg.distant_envmap:
        lt = torch.stack([probe_at_texels(p, light_xyz) for p in probes])   # (K, L, 3)
        LT = lt.permute(1, 0, 2).reshape(lt.shape[1], K * 3)
        sumA, sumB, shade = [(m @ LT).reshape(P, K, 3).permute(1, 0, 2) for m in (A, B, w2)]
    else:
        sums = [_equirect_contract(img, A, B, w2, sx, sy, sz) for img in probes]
        sumA, sumB, shade = [torch.stack([s[i] for s in sums]) for i in range(3)]
    return _finish_reshade(sumA, sumB, shade, albedo[None], acc[None, :, None], rcfg)


class NovelLightRenderer(SphereTracingRenderer):
    """Relight sweep: one geometry and visibility pass, then a re-shade per
    light (reference novel_light_sphere_tracing.Renderer :103-221).

    ``batch.novel_lights`` maps names to envmaps (``probe``, ``image``;
    numpy or tensors).  With ``cfg.vis_rotate_light`` each light becomes
    ``env_w x rotate_ratio`` probes rotated in longitude.  Returns the base
    pass's maps, ``base``, ``diff`` (the base pass's seconds, the device
    synchronised) and ``novel_light``: name -> maps on the device."""

    CHUNK = 32      # lights a reshade_sweep_block call

    def _own_rays(self, *maps) -> list:
        """This rank's slice of each (P, ...) map (all of them without a
        mesh); under a mesh P is padded to a multiple of the world with
        copies of the last row, which the gather cuts off."""
        if self.mesh is None:
            return list(maps)
        pad = (-maps[0].shape[0]) % self.mesh.world
        return [shard_rays(self.mesh, torch.cat([m, m[-1:].expand((pad,) + m.shape[1:])]))
                for m in maps]

    @torch.no_grad()
    def render(self, batch) -> dotdict:
        cfg = self.cfg
        dev = self.device
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        # the cached maps the re-shade reads; the frame-global miss skip
        # declines under them
        self.rcfg = self.rcfg._replace(want_light_maps=True)

        # ground shading depends on the envmap: it moves to the per-light
        # loop, and the base pass keeps maps of the rays in the box
        ground = bool(cfg.vis_ground_shading and 'H' in batch)
        if ground:
            cfg.vis_ground_shading = False
        sync()
        t0 = time.perf_counter()
        try:
            base = super().render(batch)
        finally:
            if ground:
                cfg.vis_ground_shading = True
        sync()
        net_time = time.perf_counter() - t0
        self.last_frame.base_s = net_time
        ret = dotdict(diff=net_time, base=base)

        surf, norm, albedo = base.surf_map, base.norm_map, base.albedo_map
        rough = base.roughness_map[..., None]
        lvis, ldot, acc = base.lvis_map, base.ldot_map, base.acc_map
        ray_o = self.to_device(np.asarray(batch.ray_o, np.float32).reshape(-1, 3))

        lights = {name: dotdict({k: self.to_device(v) for k, v in env.items()})
                  for name, env in batch.get('novel_lights', {}).items()}
        names = list(lights)
        rotate = int(cfg.rotate_ratio) if cfg.vis_rotate_light else 0
        n_total = len(names) * cfg.env_w * rotate if rotate > 0 else len(names)
        entries = []
        for idx in range(n_total):
            if rotate > 0:
                name, envmap = rotate_envmap_dict(lights, idx, rotate, cfg.env_w)
            else:
                name, envmap = names[idx], lights[names[idx]]
            p = envmap['probe']
            entries.append((name, p[0] if p.dim() == 4 else p, envmap))

        t0 = time.perf_counter()
        novel = dotdict()
        cached = self._own_rays(surf, norm, albedo, rough, lvis, ldot, acc, ray_o)
        for s in range(0, len(entries), self.CHUNK):
            chunk = entries[s:s + self.CHUNK]
            maps = reshade_sweep_block(*cached, torch.stack([p for _, p, _ in chunk]),
                                       self.light_xyz, self.light_area, self.rcfg)
            if self.mesh is not None:
                maps = dotdict({k: gather_rays(self.mesh, v, axis=1)[:, :acc.shape[0]]
                                for k, v in maps.items()})
            for j, (name, p, envmap) in enumerate(chunk):
                frame = dotdict(rgb_map=maps.rgb_map[j], shade_map=maps.shade_map[j],
                                albedo_map=albedo, norm_map=norm, acc_map=acc,
                                envmap=dotdict(probe=p))
                if ground:
                    # the ground's shading and attached albedo depend on the light
                    sub = dotdict(base)
                    sub.rgb_map = maps.rgb_map[j]
                    sub.shade_map = maps.shade_map[j]
                    merged = self._render_ground(batch, sub, dotdict(envmap),
                                                 mutate_mask=False)
                    for k in ('rgb_map', 'shade_map', 'albedo_map', 'norm_map', 'acc_map'):
                        frame[k] = merged[k]
                novel[name] = frame
        sync()
        self.last_frame.reshade_s = time.perf_counter() - t0
        self.last_frame.lights = len(entries)
        ret.novel_light = novel
        if ground:
            # the top-level maps under the frame's own envmap, over the
            # ground; the mask becomes the full frame, as the per-light maps are
            base = self._render_ground(batch, base, base.envmap, mutate_mask=True)
        ret.update({k: v for k, v in base.items() if k.endswith('_map')})
        ret.envmap = base.envmap
        return ret
