"""Sphere-traced relight render of one ray block
(``relightableavatar_tpu/renderer/sphere_tracing.py``; reference
``lib/networks/renderer/sphere_tracing_renderer.py:265-784``): surface
sphere trace -> 3-sample surface-band volume render with autodiff normals ->
DFSS shadow rays toward every light texel -> GGX shading -> sRGB.

Inference, on the exact path or with the acceleration stack: shadow rays
on a baked SDF grid (``tpu.shadow_grid``), the slice-sweep visibility
volume (``tpu.lvis_sweep``), the camera trace's exact miss skip
(``tpu.surf_miss_skip``) or its pre-march on the grid's lower bound
(``tpu.surf_grid_iters``, ``tpu.surf_exact_iters``), the shadow HDQ's
options (``tpu.shadow_skip_resd``, ``tpu.shadow_compact``,
``tpu.shadow_verts_sub``) and the HDQ ablations (``ablate_hdq_mode``
'world', 'can', 'curve'); and the stage-2 training render, with the graph
to the parameters.  ``tpu.frame_fuse`` is the frame orchestrator's
(``renderer/orchestrate.py``), not a block's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.aabb import get_near_far_aabb, pad_box
from relightableavatar_tpu_torch.ops.brdf import evaluate_shade, microfacet_brdf
from relightableavatar_tpu_torch.ops.envmap import (gen_light_xyz, linear2srgb,
                                                    lvis_upsample_matrix,
                                                    probe_at_texels,
                                                    sample_envmap_image)
from relightableavatar_tpu_torch.ops.lbs import normalize
from relightableavatar_tpu_torch.ops.lvis_sweep import query_ratio_volume
from relightableavatar_tpu_torch.ops.sdf import volume_rendering
from relightableavatar_tpu_torch.ops.sdf_grid import (build_sdf_grid, grid_sdf,
                                                      grid_sdf_lower_bound)
from relightableavatar_tpu_torch.renderer.tracing import (STConfig, sphere_trace,
                                                          sphere_trace_miss_skip)
from relightableavatar_tpu_torch.device import to_device
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.profiling import host_sync, span

ABLATE_MODES = ('hdq', 'world', 'can', 'curve')


class RelightRenderConfig(NamedTuple):
    """Render knobs of the sphere-traced path."""
    n_samples: int = 3
    surf_sample_range: float = 0.005
    bg_brightness: float = 0.0
    tonemapping: bool = True
    relighting: bool = True
    fresnel_f0: float = 0.02
    lambert_only: bool = False
    glossy_only: bool = False
    cancel_cosine: bool = True
    no_visibility: bool = False
    local_visibility: bool = False
    no_dfss: bool = False
    only_visibility: bool = False
    shading_albedo: float = 0.8
    env_r: float = 10.0
    bbox_margin: float = 0.25
    shadow_block: int = 32768
    shadow_grid: int = 0              # SDF voxel grid for shadow rays (0 = exact HDQ)
    surf_grid_iters: int = 0          # conservative pre-march iterations on the grid
    surf_exact_iters: int = 0         # exact trace iterations after it (0 = st.iter)
    surf_miss_skip: bool = False      # exact miss skip of the camera trace
    surf_skip_iters: int = 32         # lower-bound march iterations of the skip
    surf_skip_margin: float = 0.01    # safety margin m0 of the skip march (m)
    lvis_sweep: bool = False          # slice-sweep DFSS volume instead of shadow rays
    lvis_query_offset: float = 0.5    # sweep lookup offset along the normal (voxels)
    grid_margin: float = 0.05         # box pad of the SDF grid
    shadow_skip_resd: bool = False    # shadow HDQ without the residual MLP
    shadow_compact: float = 0.0       # share of a shadow block through the MLPs (0 = all)
    shadow_verts_sub: bool = False    # shadow HDQ and bake against the vertex subsample
    lvis_downscale: int = 1           # trace visibility on an (eH/k, eW/k) light grid
    distant_envmap: bool = False      # light[l] = probe texel l (skip per-dir sampling)
    want_light_maps: bool = False     # keep (P, L) lvis/ldot maps
    want_spec_map: bool = True
    vis_lvis_map: bool = False
    vis_ldot_map: bool = False
    ablate_mode: str = 'hdq'          # 'hdq' | 'world' | 'can' | 'curve'
    check_bound_sdf: bool = False     # debug: colormap |sdf| at termination, early exit
    check_termination_sdf: bool = False  # debug: |sdf| statistics at hit points

    @classmethod
    def from_cfg(cls, cfg) -> "RelightRenderConfig":
        if cfg.ablate_hdq_mode not in ABLATE_MODES:
            raise ValueError(f"ablate_hdq_mode={cfg.ablate_hdq_mode!r}: one of {ABLATE_MODES}")
        return cls(
            n_samples=int(cfg.n_samples),
            surf_sample_range=float(cfg.surf_sample_range),
            bg_brightness=float(cfg.bg_brightness),
            tonemapping=bool(cfg.tonemapping_rendering),
            relighting=bool(cfg.relighting),
            fresnel_f0=float(cfg.fresnel_f0),
            lambert_only=bool(cfg.lambert_only),
            glossy_only=bool(cfg.glossy_only),
            no_visibility=bool(cfg.no_visibility),
            local_visibility=bool(cfg.local_visibility),
            no_dfss=bool(cfg.no_dfss),
            only_visibility=bool(cfg.only_visibility),
            shading_albedo=float(cfg.shading_albedo),
            env_r=float(cfg.env_r),
            bbox_margin=float(cfg.env_lvis.bbox_margin),
            shadow_block=min(int(cfg.network_chunk_size), 32768),
            shadow_grid=int(cfg.tpu.shadow_grid),
            surf_grid_iters=int(cfg.tpu.surf_grid_iters),
            surf_exact_iters=int(cfg.tpu.surf_exact_iters),
            surf_miss_skip=bool(cfg.tpu.surf_miss_skip),
            surf_skip_iters=int(cfg.tpu.surf_skip_iters),
            surf_skip_margin=float(cfg.tpu.surf_skip_margin),
            lvis_sweep=bool(cfg.tpu.lvis_sweep),
            lvis_query_offset=float(cfg.tpu.lvis_query_offset),
            grid_margin=float(cfg.tpu.grid_margin),
            shadow_skip_resd=bool(cfg.tpu.shadow_skip_resd),
            shadow_compact=float(cfg.tpu.shadow_compact),
            shadow_verts_sub=int(cfg.tpu.shadow_verts_sub) > 1,
            lvis_downscale=int(cfg.tpu.lvis_downscale),
            distant_envmap=bool(cfg.tpu.distant_envmap),
            want_light_maps=bool(cfg.vis_novel_light),
            vis_lvis_map=bool(cfg.vis_lvis_map),
            vis_ldot_map=bool(cfg.vis_ldot_map),
            ablate_mode=str(cfg.ablate_hdq_mode),
            check_bound_sdf=bool(cfg.check_bound_sdf),
            check_termination_sdf=bool(cfg.check_termination_sdf),
        )


def _debug_colormap(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear jet colormap for the ``check_bound_sdf`` view."""
    x = torch.clamp(x, 0.0, 1.0)
    r = torch.clamp(1.5 - torch.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = torch.clamp(1.5 - torch.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = torch.clamp(1.5 - torch.abs(4.0 * x - 1.0), 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


# ---------------------------------------------------------------- visibility
@torch.no_grad()
def light_visibility(params, mcfg: AniSDFConfig, ctx,
                     surf: torch.Tensor,   # (P, 3)
                     norm: torch.Tensor,   # (P, 3)
                     acc: torch.Tensor,    # (P,)
                     xyz: torch.Tensor,    # (L, 3) light texel positions
                     sharp: torch.Tensor,  # (L,)
                     bbox: torch.Tensor,   # (2, 3)
                     lv: STConfig, rcfg: RelightRenderConfig,
                     soft_shadow: bool = True, sdf_override=None,
                     stats: dict | None = None):
    """lvis (P, L), ldot (P, L) (sphere_tracing_renderer.py:265-344).

    Only the active shadow rays (front-facing texel of a hit pixel whose ray
    meets the bbox) are traced, in chunks of ``rcfg.shadow_block``: per ray
    the trace is independent of the others, so this equals the JAX
    package's sorted block skip (``sphere_tracing.py:201-237``) and its
    masked trace of every ray on the SDF grid.  ``sdf_override`` replaces
    the HDQ SDF (the grid lookup; ``bbox`` is then the grid's box).
    Under ``rcfg.shadow_compact`` the rays of a block are not independent
    (they compete for the block's M network queries), so the blocks are
    the JAX package's: all F rays and its padding lanes, stable-sorted
    active first, inactive lanes collapsed to near == far (:func:`_jax_blocks`).
    ``stats['shadow_rays']``, when given, adds the number of active rays."""
    P = surf.shape[0]
    L = xyz.shape[0]

    ray_d_l = normalize(xyz).to(norm.dtype)       # a float32 grid promotes, as in JAX
    ldot = norm @ ray_d_l.T                                   # (P, L)
    if rcfg.no_visibility:
        return torch.ones_like(ldot), ldot
    if rcfg.local_visibility:
        return (ldot > 0).to(surf.dtype), ldot

    lfrt = (ldot > 0) & (acc[:, None] > 0)                    # front-facing
    F = P * L
    ray_o = surf[:, None, :].expand(P, L, 3).reshape(F, 3)
    ray_d = ray_d_l[None, :, :].expand(P, L, 3).reshape(F, 3)
    tan_i = sharp[None, :].expand(P, L).reshape(F, 1)

    nb, fb, _ = get_near_far_aabb(bbox[None], ray_o[None], ray_d[None])
    nb = torch.clamp(nb[0], min=lv.near_offset)[:, None]
    fb = torch.clamp(fb[0], min=lv.near_offset)[:, None]
    lbox = nb < fb                                            # (F, 1)
    active = lfrt.reshape(F, 1) & lbox

    blk = min(rcfg.shadow_block, F)
    n_compact = 0
    if rcfg.shadow_compact > 0 and sdf_override is None:
        # the network budget of a block, a multiple of 256 (JAX :177-187)
        n_compact = max(256, int(blk * rcfg.shadow_compact) // 256 * 256)
    sdf_fn = sdf_override if sdf_override is not None else (
        lambda x: anisdf.hdq_sdf(params, mcfg, ctx, x, smooth_transition=True,
                                 dist_th=lv.dist_th, skip_resd=rcfg.shadow_skip_resd,
                                 compact=n_compact, verts_sub=rcfg.shadow_verts_sub))
    occ = torch.ones((F, 1), dtype=surf.dtype, device=surf.device)
    host_sync("shadow_nonzero")
    sel_all = torch.nonzero(active[:, 0]).squeeze(1)
    if stats is not None:
        stats['shadow_rays'] = stats.get('shadow_rays', 0) + sel_all.shape[0]
    if n_compact:
        ro, rd, nr, fr, ti, order = _jax_blocks(ray_o, ray_d, nb, fb, tan_i, lbox, active,
                                                blk, lv.near_offset, rcfg.env_r)
        occ_p = torch.ones_like(nr)
        for s in range(0, sel_all.shape[0], blk):         # blocks holding an active ray
            b = slice(s, s + blk)
            _, _, occ_p[b], _, _ = sphere_trace(sdf_fn, ro[b], rd[b], nr[b], fr[b], lv,
                                                tan_i=ti[b], soft_shadow=soft_shadow)
        host_sync("shadow_unsort")
        host_sync("shadow_unsort")
        occ[order[order < F]] = occ_p[order < F]
    else:
        for s in range(0, sel_all.shape[0], blk):
            sel = sel_all[s:s + blk]
            _, _, o, _, _ = sphere_trace(sdf_fn, ray_o[sel], ray_d[sel], nb[sel],
                                         fb[sel], lv, tan_i=tan_i[sel],
                                         soft_shadow=soft_shadow)
            occ[sel] = o

    # assemble per reference scatter rules (:331-343)
    lvis = occ * active
    lvis = lvis * lbox + 1.0 * (~lbox)                        # no bbox hit => lit
    lvis = lvis * lfrt.reshape(F, 1)                          # back-facing => dark
    return lvis.reshape(P, L), ldot


def _jax_blocks(ray_o, ray_d, nb, fb, tan_i, lbox, active, blk: int,
                near_offset: float, env_r: float):
    """The JAX package's shadow-ray layout (``sphere_tracing.py:164-220``):
    near/far from the bbox where the ray meets it (else near_offset /
    env_r), far = near on inactive rays, padding lanes (origin, +z, near =
    far = 0.1, tan_i 1) up to a multiple of ``blk``, then every lane in the
    stable order active first.  Returns the sorted (ray_o, ray_d, near, far,
    tan_i) and the order (indices >= F are padding)."""
    F = ray_o.shape[0]
    near = torch.where(lbox, nb, torch.full_like(nb, near_offset))
    far = torch.where(lbox, fb, torch.full_like(fb, env_r))
    far = torch.where(active, far, near)
    pad = (-F) % blk
    act = active[:, 0]
    if pad:
        z = ray_o.new_zeros((pad, 1))
        ray_o = torch.cat([ray_o, z.expand(pad, 3)])
        ray_d = torch.cat([ray_d, torch.cat([z, z, z + 1.0], dim=1)])
        near = torch.cat([near, z + 0.1])
        far = torch.cat([far, z + 0.1])
        tan_i = torch.cat([tan_i, z + 1.0])
        act = torch.cat([act, act.new_zeros(pad)])
    order = torch.argsort((~act).to(torch.uint8), stable=True)
    return ray_o[order], ray_d[order], near[order], far[order], tan_i[order], order


# ---------------------------------------------------------------- main pass
def render_human_block(params, mcfg: AniSDFConfig, ctx,
                       ray_o, ray_d, near, far,             # (P,3) (P,3) (P,) (P,)
                       envmap_probe,                         # (eH, eW, 3)
                       light_xyz, light_area, light_sharp,   # (eH,eW,3),(eH,eW),(eH,eW)
                       st_surf: STConfig, st_obj: STConfig,
                       rcfg: RelightRenderConfig, shadow_sdf_grid=None,
                       lvis_volume=None, training: bool = False,
                       jitter_noise: torch.Tensor | None = None,
                       stats: dict | None = None) -> dotdict:
    """One pixel block of render_human (sphere_tracing_renderer.py:551-784).

    With ``rcfg.shadow_grid`` the shadow rays march ``shadow_sdf_grid`` (the
    frame's baked grid over the body box padded by ``rcfg.grid_margin``,
    raw or packed), or a cubic grid baked here when none is passed; with
    ``rcfg.surf_miss_skip`` the camera trace skips the proven misses on its
    lower bound; with ``rcfg.lvis_sweep`` and a ``lvis_volume`` the
    visibility is one lookup of that volume.

    Inference runs without a graph.  ``training`` keeps the graph to the
    parameters, as the JAX package's training branch does: the surface
    trace, the grid bake and the visibility stay off it (the miss skip is
    not taken); one HDQ re-query of the edge and closest points gives the
    differentiable ``acc_map``, ``edge_sdf`` and ``closest_sdf``; the band
    forward runs in training with ``jitter_noise`` (P * n_samples, 3) for
    the smoothness pair; the outputs are ``rgb_map``, ``acc_map`` and the
    loss terms (``reg_mask``, ``residuals``, the gradients, ``albedo``,
    ``roughness``, their jittered pair and ``volume_albedo``), with no
    background masking.  ``stats['shadow_rays']``, when given, adds the
    number of shadow rays traced."""
    with torch.set_grad_enabled(training):
        return _human_block(params, mcfg, ctx, ray_o, ray_d, near, far, envmap_probe,
                            light_xyz, light_area, light_sharp, st_surf, st_obj, rcfg,
                            shadow_sdf_grid, lvis_volume, training, jitter_noise, stats)


def _surface_trace(params, mcfg, ctx, surf_sdf, lower_bound_sdf, ray_o, ray_d, near_c,
                   far_c, st_surf: STConfig, rcfg: RelightRenderConfig, training: bool):
    """The camera trace (``relightableavatar_tpu/renderer/sphere_tracing.py:309-363``).
    The HDQ ablations: 'world' traces the network SDF everywhere
    (``hdq_sdf(hierarchical=False)``); 'can' and 'curve' carry each ray to
    the bigpose space by its origin's world -> bigpose transform, trace the
    observed SDF there and carry the hit and edge points back by their own
    bigpose -> world transforms.  'hdq' with a grid (``lower_bound_sdf``)
    and outside training: the miss skip, or the pre-march of
    ``surf_grid_iters`` steps on the grid's lower bound followed by
    ``surf_exact_iters`` exact iterations (when > 0).  Returns the tuple of
    :func:`sphere_trace`."""
    if rcfg.ablate_mode == 'world':
        world_sdf = lambda x: anisdf.hdq_sdf(params, mcfg, ctx, x, hierarchical=False)
        return sphere_trace(world_sdf, ray_o, ray_d, near_c, far_c, st_surf,
                            soft_shadow=False)
    if rcfg.ablate_mode in ('can', 'curve'):
        obs_sdf = lambda x: anisdf.observed_sdf(params, mcfg, ctx, x)
        w2b = anisdf.world_to_bigpose_transform(mcfg, ctx, ray_o)
        ro_c = torch.einsum('pab,pb->pa', w2b[:, :3, :3], ray_o) + w2b[:, :3, 3]
        rd_c = normalize(torch.einsum('pab,pb->pa', w2b[:, :3, :3], ray_d))
        surf_c, edge_c, occ, st_t, ot_t = sphere_trace(obs_sdf, ro_c, rd_c, near_c, far_c,
                                                       st_surf, soft_shadow=False)
        back = []
        for pts in (surf_c, edge_c):
            b2w = anisdf.bigpose_to_world_transform(mcfg, ctx, pts)
            back.append(torch.einsum('pab,pb->pa', b2w[:, :3, :3], pts) + b2w[:, :3, 3])
        return back[0], back[1], occ, st_t, ot_t
    if rcfg.surf_miss_skip and lower_bound_sdf is not None and not training:
        # the full st_surf budget from each ray's own near: the reduced
        # surf_exact_iters is sound only after the pre-march it banks
        return sphere_trace_miss_skip(surf_sdf, lower_bound_sdf, ray_o, ray_d, near_c,
                                      far_c, st_surf, skip_iter=rcfg.surf_skip_iters,
                                      margin=rcfg.surf_skip_margin)
    # training is excluded: a clean miss would pre-march to far instead of
    # its closest approach, where the differentiable acc reads the edge SDF
    pre = lower_bound_sdf if rcfg.surf_grid_iters > 0 and not training else None
    st_cam = st_surf
    if pre is not None and rcfg.surf_exact_iters > 0:
        st_cam = st_surf._replace(iter=rcfg.surf_exact_iters)
    return sphere_trace(surf_sdf, ray_o, ray_d, near_c, far_c, st_cam, soft_shadow=False,
                        premarch_sdf_fn=pre, premarch_iter=rcfg.surf_grid_iters)


def _human_block(params, mcfg, ctx, ray_o, ray_d, near, far, envmap_probe, light_xyz,
                 light_area, light_sharp, st_surf, st_obj, rcfg, shadow_sdf_grid,
                 lvis_volume, training, jitter_noise, stats) -> dotdict:
    P = ray_o.shape[0]
    dev, dt = ray_o.device, ray_o.dtype
    near_c = near.reshape(P, 1)
    far_c = far.reshape(P, 1)

    surf_sdf = lambda x: anisdf.hdq_sdf(params, mcfg, ctx, x, smooth_transition=True)

    bbox = pad_box(ctx["wbounds"], rcfg.bbox_margin)
    shadow_sdf = lower_bound_sdf = gbox = None
    if rcfg.shadow_grid > 0:
        # the SDF grid is tight around the body (the occluders are the body)
        gbox = pad_box(ctx["wbounds"], rcfg.grid_margin)
        grid = shadow_sdf_grid
        if grid is None:
            hdq = lambda x: anisdf.hdq_sdf(params, mcfg, ctx, x, smooth_transition=True,
                                           dist_th=st_obj.dist_th)
            with torch.no_grad():
                grid = build_sdf_grid(hdq, gbox[0], gbox[1], rcfg.shadow_grid)
        shadow_sdf = lambda x: grid_sdf(grid, gbox[0], gbox[1], x)
        lower_bound_sdf = lambda x: grid_sdf_lower_bound(grid, gbox[0], gbox[1], x)

    # ---- surface intersection (the tracer runs without a graph)
    with torch.no_grad(), span("block.trace"):
        surf, edge, occ, st_t, ot_t = _surface_trace(
            params, mcfg, ctx, surf_sdf, lower_bound_sdf, ray_o, ray_d, near_c,
            far_c, st_surf, rcfg, training)
    depth = (surf[:, 0] - ray_o[:, 0]) / ray_d[:, 0]
    acc = 1.0 - occ[:, 0]
    if training:
        # differentiable acc from the edge SDF (reference :593-598); the
        # closest-approach point rides the same query for the silhouette loss
        dd = surf_sdf(torch.cat([edge, surf], dim=0))
        d, d_cl = dd[:P], dd[P:]
        acc_g = 1.0 - torch.clamp(d, min=0.0) / torch.clamp(
            torch.maximum(ot_t, near_c), min=st_surf.eps) / (1 / st_surf.tan_i * 2)
        acc = torch.clamp(acc_g[:, 0], 0.0, 1.0)
    hit = acc > 0

    if rcfg.check_bound_sdf:
        # colormap of |blended sdf| at ray termination (reference :577-587)
        d = torch.where(acc[:, None] > 0, surf_sdf(surf), surf_sdf(edge))
        return dotdict(acc_map=torch.ones_like(acc),
                       rgb_map=_debug_colormap(torch.abs(d[:, 0]) * 2.0))

    if rcfg.check_termination_sdf:
        # |sdf| at hit points (reference :765-778), of the network itself
        d_term = anisdf.hdq_sdf(params, mcfg._replace(smpl_distance=False), ctx, surf,
                                smooth_transition=True)
        w = hit.to(d_term.dtype)
        term_sdf_sum = torch.sum(torch.abs(d_term[:, 0]) * w).reshape(1)
        term_sdf_cnt = torch.sum(w).reshape(1)

    # ---- 3-sample surface-band volume render (reference :607-620)
    with span("block.band"):
        S = rcfg.n_samples
        if S == 1:
            zval = to_device([0.5], dev, dt)
        else:
            zval = torch.linspace(0.0, 1.0, S, dtype=dt, device=dev)
        net_z = zval * (2 * rcfg.surf_sample_range) - rcfg.surf_sample_range
        net_pts = surf[:, None, :] + net_z[None, :, None] * ray_d[:, None, :]
        net_view = ray_d[:, None, :].expand(P, S, 3)

        ret = anisdf.forward(params, mcfg, ctx, net_pts.reshape(P * S, 3),
                             net_view.reshape(P * S, 3), training=training,
                             jitter_noise=jitter_noise if training else None)
        raw = ret.raw.reshape(P, S, -1)
        raw, occ_s = raw[..., :-1], raw[..., -1]
        _, raw, occ_v = volume_rendering(raw, occ_s, bg_brightness=rcfg.bg_brightness)
        raw = raw / (occ_v[..., None] + 1e-8)     # un-normalize (reference :621)

        out = dotdict()
        out.acc_map = acc
        if training:
            out.edge_sdf = d[:, 0]
            out.closest_sdf = d_cl[:, 0]
            for key in ('reg_mask', 'residuals', 'observed_gradients', 'gradients', 'albedo',
                        'roughness', 'albedo_jitter', 'roughness_jitter'):
                if key in ret:
                    out[key] = ret[key]
        else:
            out.surf_map = surf * hit[:, None]
            out.depth_map = depth * hit

        # channel conventions (reference :632-639)
        C = raw.shape[-1]
        rgb = albedo = roughness = cpts = None
        if C == 3 + 1 + 3:                  # relight training: albedo rough norm
            albedo, roughness, norm = raw[..., :3], raw[..., 3:4], raw[..., 4:7]
        elif C == 3 + 3:                    # anisdf training: norm rgb
            norm, rgb = raw[..., :3], raw[..., 3:6]
        elif C == 3 + 3 + 3 + 3 + 1 + 3:    # relight: cpts bpts resd albedo rough norm
            cpts, bpts, resd = raw[..., :3], raw[..., 3:6], raw[..., 6:9]
            albedo, roughness, norm = raw[..., 9:12], raw[..., 12:13], raw[..., 13:16]
        elif C == 3 + 3 + 3 + 3 + 3:        # anisdf: cpts bpts resd norm rgb
            cpts, bpts, resd = raw[..., :3], raw[..., 3:6], raw[..., 6:9]
            norm, rgb = raw[..., 9:12], raw[..., 12:15]
        else:
            raise NotImplementedError(f"raw channels {C}")

        norm = torch.where(torch.sum(norm, dim=-1, keepdim=True) == 0,
                           torch.ones_like(norm), norm)
        norm = normalize(norm)

        if albedo is not None:
            albedo = torch.clamp(albedo, mcfg.albedo_bias, mcfg.albedo_bias + mcfg.albedo_slope)
            roughness = torch.clamp(roughness, mcfg.roughness_bias,
                                    mcfg.roughness_bias + mcfg.roughness_slope)
            if training:
                out.volume_albedo = albedo

        if not training:
            out.norm_map = norm * hit[:, None]
            if albedo is not None:
                out.albedo_map = albedo * hit[:, None]
                out.roughness_map = roughness[..., 0] * hit
            if cpts is not None:
                out.cpts_map = cpts * hit[:, None]
                out.bpts_map = bpts * hit[:, None]
                out.resd_map = resd * hit[:, None]

    # ---- relight shading (reference :707-760)
    if rcfg.relighting and albedo is not None:
        eH, eW = light_xyz.shape[:2]
        L = eH * eW
        xyz = light_xyz.reshape(L, 3)
        area = light_area.reshape(L)
        sharp = light_sharp.reshape(L)

        k = rcfg.lvis_downscale
        if k > 1:
            # visibility on a coarse (eH/k, eW/k) light grid, lifted back by
            # a bilinear matrix
            hc, wc = max(eH // k, 1), max(eW // k, 2)
            xyz_c, area_c = gen_light_xyz(hc, wc, rcfg.env_r, device=dev)
            sharp_c = 1.0 / torch.sqrt(area_c / np.pi)
            xyz_v = xyz_c.reshape(hc * wc, 3)
            sharp_v = sharp_c.reshape(hc * wc)
            U = to_device(lvis_upsample_matrix(hc, wc, eH, eW), dev)
        else:
            xyz_v, sharp_v, U = xyz, sharp, None

        with span("block.visibility"):
            if (rcfg.lvis_sweep and lvis_volume is not None and gbox is not None
                    and not rcfg.no_visibility and not rcfg.local_visibility):
                # one trilinear read of the sweep volume per surface point,
                # offset along the normal so it stays on outside cells
                voxel = torch.max(gbox[1] - gbox[0]) / (rcfg.shadow_grid - 1)
                q = surf + norm * (rcfg.lvis_query_offset * voxel)
                r_vol = query_ratio_volume(lvis_volume, gbox[0], gbox[1], q)
                if rcfg.no_dfss:
                    tan_iv = torch.full_like(sharp_v, st_obj.tan_i)
                else:
                    tan_iv = st_obj.tan_i_multiplier * sharp_v
                occ_v = torch.clamp(r_vol * (tan_iv[None, :] * 0.5), 0.0, 1.0)
                ldot = norm @ normalize(xyz_v).to(norm.dtype).T
                lvis = (occ_v * ((ldot > 0) & (acc[:, None] > 0))).detach()
            else:
                lvis, ldot = light_visibility(
                    params, mcfg, ctx, surf, norm, acc, xyz_v, sharp_v,
                    gbox if shadow_sdf is not None else bbox, st_obj, rcfg,
                    soft_shadow=not rcfg.no_dfss, sdf_override=shadow_sdf, stats=stats)
            if U is not None:
                lvis = torch.clamp(lvis @ U.to(lvis.dtype), 0.0, 1.0)
                ldot = norm @ normalize(xyz).to(norm.dtype).T
                ldot_mask = (ldot > 0) & (acc[:, None] > 0)
                lvis = lvis * ldot_mask

        with span("block.shade"):
            surf2light = normalize(xyz[None, :, :] - surf[:, None, :])   # (P, L, 3)
            surf2cam = normalize(ray_o - surf)                            # (P, 3)
            if rcfg.distant_envmap:
                # light[l] = the probe at texel l's own direction
                light = probe_at_texels(envmap_probe, light_xyz)[None].expand(P, L, 3)
            else:
                light = sample_envmap_image(envmap_probe, surf2light)     # (P, L, 3)

            if rcfg.only_visibility:
                ldot_shade = torch.ones_like(ldot)
                light = torch.mean(light, dim=-1, keepdim=True).expand(light.shape)
            elif rcfg.cancel_cosine:
                ldot_shade = torch.ones_like(ldot)
            else:
                ldot_shade = ldot

            shade = evaluate_shade(lvis, ldot_shade, area, light)
            brdf = microfacet_brdf(surf2light, surf2cam, norm, albedo, roughness,
                                   f0=rcfg.fresnel_f0, lambert_only=rcfg.lambert_only,
                                   glossy_only=rcfg.glossy_only,
                                   cancel_cosine=rcfg.cancel_cosine)
            rgb = torch.sum(brdf * shade, dim=-2)
            if rcfg.tonemapping:
                rgb = linear2srgb(rgb)
            out.rgb_map = rgb

            if not training:
                if rcfg.want_spec_map:
                    spec_brdf = microfacet_brdf(
                        surf2light, surf2cam, norm, torch.zeros_like(albedo), roughness,
                        f0=rcfg.fresnel_f0, cancel_cosine=rcfg.cancel_cosine)
                    if rcfg.cancel_cosine:
                        spec_ldot = 1 / (torch.abs(ldot) + 1e-8)
                    else:
                        spec_ldot = torch.ones_like(ldot)
                    spec_shade = evaluate_shade(torch.ones_like(lvis), spec_ldot, area, light)
                    out.spec_map = torch.sum(spec_brdf * spec_shade, dim=-2)

                shade_vis = evaluate_shade(lvis, ldot, area, light)
                out.shade_map = torch.sum(shade_vis, dim=-2) * rcfg.shading_albedo / np.pi
                if rcfg.vis_lvis_map:
                    out.shade_map = torch.mean(lvis, dim=-1, keepdim=True).expand(P, 3)
                if rcfg.vis_ldot_map:
                    out.shade_map = torch.mean(ldot, dim=-1, keepdim=True).expand(P, 3)
                if rcfg.want_light_maps:
                    out.lvis_map = lvis
                    out.ldot_map = ldot
    else:
        out.rgb_map = rgb if rgb is not None else torch.zeros((P, 3), dtype=dt, device=dev)

    # background masking like the reference alpha_output_ (:453-460)
    if not training:
        for key in ('rgb_map', 'spec_map', 'shade_map'):
            if key in out:
                out[key] = out[key] * acc[:, None]
    if rcfg.check_termination_sdf:
        out.term_sdf_sum = term_sdf_sum
        out.term_sdf_cnt = term_sdf_cnt
    return out
