"""Plain PyTorch reference of the exact relit frame: the camera sphere trace
over the HDQ world SDF, the 3-sample surface band with autodiff normals,
DFSS soft-shadow rays toward every light texel, GGX microfacet shading
under the learned environment map, sRGB, and the maps a frame returns.

A frozen copy of the exact float32 path of the port's
``renderer/tracing.sphere_trace``, ``renderer/sphere_tracing`` (no grid, no
sweep, no miss skip, no shadow options), ``ops/{brdf,envmap,aabb}`` and
``renderer/orchestrate.SphereTracingRenderer.render``'s blocking.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import net as N

MAPS = ("rgb_map", "acc_map", "norm_map", "albedo_map", "roughness_map", "shade_map")


class Trace:
    """Sphere-tracing settings (``cfg.sphere_tracing``, merged with
    ``cfg.obj_lvis`` for the shadow rays)."""

    def __init__(self, node: dict):
        self.iter = int(node.get('iter', 16))
        self.tan_i = float(node.get('tan_i', 1000.0))
        self.relax = float(node.get('relax', 0.0))
        self.offset = float(node.get('offset', 0.02))
        self.eps = float(node.get('eps', 1e-8))
        self.near_offset = float(node.get('near_offset', 0.01))
        self.skip = int(node.get('shadow_skip_iter', 1))
        self.tan_mult = float(node.get('tan_i_multiplier', 1.0))
        self.dist_th = node.get('dist_th', None)


@torch.no_grad()
def sphere_trace(sdf_fn, ray_o, ray_d, near, far, st: Trace, tan_i=None, soft=False):
    """(surf, occ): the surface point (camera rays) and the DFSS occlusion."""
    P = ray_o.shape[0]
    ones = torch.ones((P, 1), dtype=ray_o.dtype, device=ray_o.device)
    near = near.reshape(P, 1) * ones
    far = far.reshape(P, 1) * ones
    ti = ones * st.tan_i if not soft else st.tan_mult * tan_i.reshape(P, 1)
    tan = ones / ti
    t, d0, occ, st_t, ot = near, ones * 1e9, ones, far, far
    cd, dt = ones * 1e9, ones * 1e9
    off, rlx = ones * st.offset, ones * st.relax
    for i in range(st.iter):
        d1 = sdf_fn(ray_o + t * ray_d)
        counts = i >= st.skip
        if soft:
            # Claybook banding removal
            dx0 = d0 + rlx * d0 + off
            dx1 = d1 + rlx * d1 + off
            dy = (dx1 ** 2) / (2 * dx0)
            dx = (torch.sqrt(torch.clamp(dx1 ** 2 - dy ** 2, min=0.0)) - off) / (1 + rlx)
            cls = (torch.clamp(dx, min=0.0)
                   / torch.clamp(torch.maximum(t - dy, near), min=st.eps) / (tan * 2))
            msk = ((cls < occ) & counts & (dy < t) & (dx1 > 0) & (dx0 > 0) & (dx > 0) & (dy > 0)
                   & (dy < dx0) & torch.isfinite(cls))
            ot = torch.where(msk, t - dy, ot)
            occ = torch.where(msk, cls, occ)
        cls = torch.clamp(d1, min=0.0) / torch.clamp(torch.maximum(t, near), min=st.eps) / (tan * 2)
        msk = (cls < occ) & counts
        ot = torch.where(msk, t, ot)
        occ = torch.where(msk, cls, occ)
        if not soft:
            a1, a0 = torch.abs(d1), torch.abs(d0)
            msk = torch.sign(d0) != torch.sign(d1)
            interp = t - dt * torch.clamp(a1 / (a0 + a1 + st.eps), 0.0, 1.0)
            st_t = torch.where(msk, interp, st_t)
            off = torch.where(msk, torch.zeros_like(off), off)
            rlx = torch.where(msk, torch.zeros_like(rlx), rlx)
            msk = a1 < cd
            cd = torch.where(msk, a1, cd)
            st_t = torch.where(msk, t, st_t)
        dt = d1 + rlx * d1 + off
        t = torch.maximum(torch.minimum(t + dt, far), near)
        d0 = d1
    return ray_o + st_t * ray_d, occ


def light_grid(env_h: int, env_w: int, env_r: float, device):
    """Texel centres (L, 3) on a radius-``env_r`` sphere and solid angles (L,)."""
    lat_half, lng_half = math.pi / env_h / 2, 2 * math.pi / env_w / 2
    lats = np.linspace(math.pi / 2 - lat_half, -math.pi / 2 + lat_half, env_h)
    lngs = np.linspace(math.pi - lng_half, -math.pi + lng_half, env_w)
    lng, lat = np.meshgrid(lngs, lats)
    xyz = np.stack([env_r * np.cos(lat) * np.cos(lng), env_r * np.cos(lat) * np.sin(lng),
                    env_r * np.sin(lat)], axis=-1)
    s = np.sin(math.pi / 2 - lat)
    area = 4 * math.pi * s / np.sum(s)
    return (torch.as_tensor(xyz.reshape(-1, 3).astype(np.float32), device=device),
            torch.as_tensor(area.reshape(-1).astype(np.float32), device=device))


def sample_envmap(image, d):
    """Bilinear lat-long lookup of ``image`` (H, W, 3) along directions d (..., 3)."""
    H, W = image.shape[:2]
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-13)
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0)) - 1e-6
    phi = torch.atan2(d[..., 1], d[..., 0])
    x = (-phi / math.pi + 1) * 0.5 * W
    y = ((theta / math.pi) * 2 - 1 + 1) * 0.5 * H
    x0, y0 = torch.floor(x - 0.5), torch.floor(y - 0.5)
    wx, wy = ((x - 0.5) - x0)[..., None], ((y - 0.5) - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    x1i, y1i = (x0i + 1).clamp(0, W - 1), (y0i + 1).clamp(0, H - 1)
    x0i, y0i = x0i.clamp(0, W - 1), y0i.clamp(0, H - 1)
    return ((image[y0i, x0i] * (1 - wx) + image[y0i, x1i] * wx) * (1 - wy)
            + (image[y1i, x0i] * (1 - wx) + image[y1i, x1i] * wx) * wy)


def _safe_divide(a, b, eps=1e-8):
    a = torch.where((a < eps) & (a >= 0), torch.full_like(a, eps), a)
    a = torch.where((a > -eps) & (a < 0), torch.full_like(a, -eps), a)
    b = torch.where((b < eps) & (b >= 0), torch.full_like(b, eps), b)
    b = torch.where((b > -eps) & (b < 0), torch.full_like(b, -eps), b)
    div = a / b
    div = torch.where(torch.isnan(div) | torch.isinf(div), torch.zeros_like(div), div)
    return torch.clamp(div, -1e10, 1e10)


def ggx(l, c, n, albedo, rough, f0):
    """Microfacet BRDF (P, L, 3), the cosine cancelled."""
    l, c, n = N.normalize(l, 1e-7), N.normalize(c, 1e-7), N.normalize(n, 1e-7)
    nn, v = n[:, None, :], c[:, None, :]
    l_dot_n = torch.clamp(torch.sum(l * nn, dim=-1), 1e-4, 1.0)
    v_dot_n = torch.clamp(torch.sum(c * n, dim=-1), 1e-4, 1.0)
    lambert = (albedo[:, None, :] / math.pi).expand(l.shape) * l_dot_n[..., None]
    h = N.normalize(l + v, 1e-7)
    alpha = rough ** 2
    f = f0 + (1 - f0) * (1 - torch.sum(l * h, dim=-1)) ** 5
    cos_m = torch.sum(h * nn, dim=-1)
    chi_d = (cos_m > 0).to(cos_m.dtype)
    cos_m_sq = cos_m ** 2
    tan_m_sq = _safe_divide(1 - cos_m_sq, cos_m_sq)
    d = _safe_divide(alpha ** 2 * chi_d, math.pi * cos_m_sq ** 2 * (alpha ** 2 + tan_m_sq) ** 2)
    cos_v = torch.sum(n * c, dim=-1)
    div = _safe_divide(torch.sum(h * v, dim=-1), cos_v[:, None])
    chi_g = (div > 0).to(div.dtype)
    cos_v_sq = torch.clamp(cos_v ** 2, 0.0, 1.0)
    tan_v_sq = torch.clamp(_safe_divide(1 - cos_v_sq, cos_v_sq), 0.0, 1e10)
    g = _safe_divide(chi_g * 2, 1 + torch.sqrt(1 + alpha ** 2 * tan_v_sq[:, None]))
    micro = _safe_divide(f * g * d, 4 * torch.abs(v_dot_n)[:, None])
    return micro[..., None].expand(l.shape) + lambert


def aabb(box, ray_o, ray_d, eps=1e-8):
    d = torch.where((ray_d < eps) & (ray_d > -eps ** 2), torch.full_like(ray_d, eps), ray_d)
    d = torch.where((d > -eps ** 2) & (d < eps), torch.full_like(d, -eps), d)
    tmin, tmax = (box[0] - ray_o) / d, (box[1] - ray_o) / d
    return torch.amax(torch.minimum(tmin, tmax), dim=-1), torch.amin(torch.maximum(tmin, tmax),
                                                                     dim=-1)


class Frame:
    """The reference renderer of a relit frame (the exact stack)."""

    def __init__(self, cfg, params, net: N.Net, device):
        self.cfg, self.params, self.net, self.device = cfg, params, net, device
        self.st_surf = Trace(dict(cfg.sphere_tracing))
        self.st_obj = Trace({**dict(cfg.sphere_tracing), **dict(cfg.obj_lvis)})
        self.xyz, self.area = light_grid(int(cfg.env_h), int(cfg.env_w), float(cfg.env_r), device)
        self.sharp = 1.0 / torch.sqrt(self.area / np.pi)
        self.block = int(cfg.tpu.ray_block)
        self.shadow_block = min(int(cfg.network_chunk_size), 32768)
        self.probe = F.softplus(params["env"].expand(*params["env"].shape[:2], 3))

    @torch.no_grad()
    def render(self, ctx, ray_o, ray_d, near, far) -> dict:
        """Maps (P, ...) of the rays, rendered in blocks of ``tpu.ray_block``."""
        near = torch.clamp(near, min=float(self.cfg.clip_near))
        far = torch.clamp(far, max=float(self.cfg.clip_far))
        outs = [self._block(ctx, ray_o[s:s + self.block], ray_d[s:s + self.block],
                            near[s:s + self.block], far[s:s + self.block])
                for s in range(0, ray_o.shape[0], self.block)]
        return {k: torch.cat([o[k] for o in outs]) for k in MAPS}

    def _visibility(self, ctx, surf, norm, acc):
        """lvis (P, L): DFSS occlusion of the active shadow rays."""
        P, L = surf.shape[0], self.xyz.shape[0]
        st = self.st_obj
        dirs = N.normalize(self.xyz)
        ldot = norm @ dirs.T
        lfrt = (ldot > 0) & (acc[:, None] > 0)
        Fn = P * L
        ro = surf[:, None, :].expand(P, L, 3).reshape(Fn, 3)
        rd = dirs[None].expand(P, L, 3).reshape(Fn, 3)
        ti = self.sharp[None].expand(P, L).reshape(Fn, 1)
        box = torch.stack([ctx["wbounds"][0] - float(self.cfg.env_lvis.bbox_margin),
                           ctx["wbounds"][1] + float(self.cfg.env_lvis.bbox_margin)])
        nb, fb = aabb(box, ro, rd)
        nb = torch.clamp(nb, min=st.near_offset)[:, None]
        fb = torch.clamp(fb, min=st.near_offset)[:, None]
        lbox = nb < fb
        active = lfrt.reshape(Fn, 1) & lbox
        sdf = lambda x: N.hdq_sdf(self.params, self.net, ctx, x, dist_th=st.dist_th)
        occ = torch.ones((Fn, 1), dtype=surf.dtype, device=surf.device)
        sel_all = torch.nonzero(active[:, 0]).squeeze(1)
        for s in range(0, sel_all.shape[0], self.shadow_block):
            sel = sel_all[s:s + self.shadow_block]
            occ[sel] = sphere_trace(sdf, ro[sel], rd[sel], nb[sel], fb[sel], st,
                                    tan_i=ti[sel], soft=True)[1]
        lvis = occ * active
        lvis = lvis * lbox + 1.0 * (~lbox)
        return (lvis * lfrt.reshape(Fn, 1)).reshape(P, L), ldot

    def _block(self, ctx, ray_o, ray_d, near, far) -> dict:
        cfg, net = self.cfg, self.net
        P = ray_o.shape[0]
        sdf = lambda x: N.hdq_sdf(self.params, net, ctx, x)
        surf, occ = sphere_trace(sdf, ray_o, ray_d, near, far, self.st_surf)
        acc = 1.0 - occ[:, 0]
        hit = acc > 0
        S = int(cfg.n_samples)
        r = float(cfg.surf_sample_range)
        z = torch.linspace(0.0, 1.0, S, device=ray_o.device) * (2 * r) - r
        pts = surf[:, None, :] + z[None, :, None] * ray_d[:, None, :]
        raw, _ = N.forward(self.params, net, ctx, pts.reshape(P * S, 3),
                           ray_d[:, None, :].expand(P, S, 3).reshape(P * S, 3),
                           training=False, relight=True)
        raw = raw.detach().reshape(P, S, -1)
        alpha = raw[..., -1]
        shifted = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + 1e-8], -1)
        w = alpha * torch.cumprod(shifted, dim=-1)
        comp = torch.sum(w[..., None] * raw[..., :-1], dim=-2)
        comp = comp / (torch.sum(w, dim=-1)[..., None] + 1e-8)
        albedo, rough, norm = comp[..., :3], comp[..., 3:4], comp[..., 4:7]
        norm = torch.where(torch.sum(norm, dim=-1, keepdim=True) == 0, torch.ones_like(norm), norm)
        norm = N.normalize(norm)
        albedo = torch.clamp(albedo, net.albedo_bias, net.albedo_bias + net.albedo_slope)
        rough = torch.clamp(rough, net.roughness_bias, net.roughness_bias + net.roughness_slope)
        lvis, ldot = self._visibility(ctx, surf, norm, acc)
        s2l = N.normalize(self.xyz[None, :, :] - surf[:, None, :])
        s2c = N.normalize(ray_o - surf)
        light = sample_envmap(self.probe, s2l)
        area = self.area[:, None]
        brdf = ggx(s2l, s2c, norm, albedo, rough, float(cfg.fresnel_f0))
        rgb = torch.sum(brdf * (lvis[..., None] * area * light), dim=-2)
        rgb = torch.clamp(rgb, 0.0, 1.0)
        rgb = torch.where(rgb <= 0.0031308, rgb * 12.92,
                          1.055 * torch.pow(rgb + 1e-7, 1 / 2.4) - 0.055)
        shade = torch.sum(lvis[..., None] * ldot[..., None] * area * light, dim=-2) \
            * float(cfg.shading_albedo) / np.pi
        a = acc[:, None]
        return dict(rgb_map=rgb * a, acc_map=acc, norm_map=norm * hit[:, None],
                    albedo_map=albedo * hit[:, None], roughness_map=rough[..., 0] * hit,
                    shade_map=shade * a)
