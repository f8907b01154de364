"""Ground-plane shading pass for relit full-frame rendering
(``relightableavatar_tpu/renderer/ground.py``; reference
``lib/networks/renderer/sphere_tracing_renderer.py:463-548``, render_ground):
Moller-Trumbore ray-plane hit, soft shadows of the body traced with the
``env_lvis`` schedule toward every light texel, envmap-attached ground
albedo, and a distance blend into the environment.
"""
from __future__ import annotations

import numpy as np
import torch

from relightableavatar_tpu_torch.device import to_device
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.aabb import pad_box
from relightableavatar_tpu_torch.ops.brdf import evaluate_shade
from relightableavatar_tpu_torch.ops.envmap import linear2srgb, sample_envmap_image
from relightableavatar_tpu_torch.ops.lbs import normalize
from relightableavatar_tpu_torch.renderer.sphere_tracing import (RelightRenderConfig,
                                                                 light_visibility)
from relightableavatar_tpu_torch.renderer.tracing import STConfig
from relightableavatar_tpu_torch.utils.dotdict import dotdict


def moller_trumbore(ray_o, ray_d, tris, eps: float = 1e-8):
    """ray_o/ray_d (P, 3); tris (F, 3, 3) -> u, v, t each (P, F)
    (reference mesh_utils.py:710-739)."""
    E1 = tris[..., 1, :] - tris[..., 0, :]
    E2 = tris[..., 2, :] - tris[..., 0, :]
    N = torch.linalg.cross(E1, E2)
    invdet = 1.0 / -(torch.sum(ray_d[:, None, :] * N[None], dim=-1) + eps)
    A0 = ray_o[:, None, :] - tris[None, :, 0, :]
    DA0 = torch.linalg.cross(A0, ray_d[:, None, :].expand(A0.shape))
    u = torch.sum(DA0 * E2[None], dim=-1) * invdet
    v = -torch.sum(DA0 * E1[None], dim=-1) * invdet
    t = torch.sum(A0 * N[None], dim=-1) * invdet
    return u, v, t


def compute_ground_tris(orig: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """A big triangle spanning the ground plane (net_utils.py:392-396)."""
    n = normalize(to_device([0.3574, 0.8624, 0.3712], norm.device,
                            norm.dtype))                # fixed 'random' vector
    a = torch.linalg.cross(norm, n)
    b = torch.linalg.cross(norm, a)
    return torch.stack([orig, orig + a, orig + b], dim=0)


@torch.no_grad()
def render_ground_block(params, mcfg: AniSDFConfig, ctx,
                        ray_o, ray_d, acc,                 # (P,3) (P,3) (P,)
                        envmap_probe, envmap_image,
                        light_xyz, light_area, light_sharp,
                        ground_normal, ground_origin, ground_albedo,
                        st_env: STConfig, rcfg: RelightRenderConfig,
                        attach_envmap: bool = True, stats: dict | None = None) -> dotdict:
    """Ground maps of one ray block.  ``acc`` is the ground's share of each
    pixel (1 - the body's alpha): a pixel the body covers fully traces no
    shadow rays.  The shadow rays march the exact HDQ SDF toward all L
    texels; ``stats['shadow_rays']`` counts those traced."""
    P = ray_o.shape[0]
    eH, eW = light_xyz.shape[:2]
    L = eH * eW
    xyz = light_xyz.reshape(L, 3)
    area = light_area.reshape(L)
    sharp = light_sharp.reshape(L)

    norm = normalize(ground_normal)
    tris = compute_ground_tris(ground_origin, norm)
    _, _, t = moller_trumbore(ray_o, ray_d, tris[None])
    t = t[:, 0:1]                                          # (P, 1)
    surf = ray_o + t * ray_d
    norm_p = norm[None].expand(P, 3)

    bbox = pad_box(ctx["wbounds"], rcfg.bbox_margin)
    lvis, ldot = light_visibility(params, mcfg, ctx, surf, norm_p, acc, xyz, sharp,
                                  bbox, st_env, rcfg, soft_shadow=not rcfg.no_dfss,
                                  stats=stats)

    if attach_envmap:
        img = envmap_image if envmap_image is not None else envmap_probe
        albedo = sample_envmap_image(img, ray_d)
    else:
        albedo = ground_albedo[None].expand(P, 3)

    # ease shading into the environment with distance (reference :504-509)
    dist = torch.where(t[:, 0] <= 0, torch.full_like(t[:, 0], 1e9),
                       torch.linalg.vector_norm(surf - ground_origin[None], dim=-1))
    weight = torch.clamp((dist - rcfg.env_r) / rcfg.env_r, 0.0, 1.0)[:, None]

    ldot = torch.sum(normalize(xyz)[None] * norm_p[:, None, :], dim=-1)   # (P, L)
    lvis = lvis * (1 - weight) + weight

    brdf = albedo[:, None, :] / np.pi                                      # (P, 1, 3)
    surf2light = normalize(xyz[None, :, :] - torch.zeros_like(surf)[:, None, :])
    light = sample_envmap_image(envmap_probe, surf2light)                  # (P, L, 3)
    if rcfg.only_visibility:
        ldot = torch.ones_like(ldot)
        light = torch.mean(light, dim=-1, keepdim=True).expand(light.shape)
    shade = evaluate_shade(lvis, ldot, area, light)
    rgb = torch.sum(brdf * shade, dim=-2)
    if rcfg.tonemapping:
        rgb = linear2srgb(rgb)
    shade_sum = torch.sum(shade, dim=-2) * rcfg.shading_albedo / np.pi

    out = dotdict()
    out.rgb_map = rgb
    out.surf_map = surf
    out.albedo_map = albedo
    out.roughness_map = torch.ones((P,), dtype=rgb.dtype, device=rgb.device)
    out.spec_map = shade_sum / 20
    out.norm_map = norm_p
    out.shade_map = shade_sum
    out.cpts_map = torch.zeros_like(surf)
    out.bpts_map = torch.zeros_like(surf)
    out.depth_map = torch.clamp(t[:, 0], -rcfg.env_r, rcfg.env_r)
    if rcfg.want_light_maps:
        out.lvis_map = lvis
        out.ldot_map = ldot
    return out
