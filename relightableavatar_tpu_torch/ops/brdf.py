"""GGX microfacet BRDF over a light axis (``relightableavatar_tpu/ops/brdf.py``;
reference ``lib/utils/relight_utils.py:468-632``).  The eps clamps of
``safe_divide`` change values, not only stability, so they are kept."""
from __future__ import annotations

import math

import torch

from relightableavatar_tpu_torch.ops.lbs import normalize


def safe_divide(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Clamp |a|,|b| >= eps keeping signs, divide, zero nan/inf, clip 1e10."""
    a = torch.where((a < eps) & (a >= 0), torch.full_like(a, eps), a)
    a = torch.where((a > -eps) & (a < 0), torch.full_like(a, -eps), a)
    b = torch.where((b < eps) & (b >= 0), torch.full_like(b, eps), b)
    b = torch.where((b > -eps) & (b < 0), torch.full_like(b, -eps), b)
    div = a / b
    div = torch.where(torch.isnan(div) | torch.isinf(div), torch.zeros_like(div), div)
    return torch.clamp(div, -1e10, 1e10)


def microfacet_brdf(pts2l: torch.Tensor,     # (..., L, 3) surface-to-light
                    pts2c: torch.Tensor,     # (..., 3) surface-to-camera
                    normal: torch.Tensor,    # (..., 3)
                    albedo: torch.Tensor,    # (..., 3)
                    rough: torch.Tensor,     # (..., 1)
                    f0: float = 0.04,
                    lambert_only: bool = False,
                    glossy_only: bool = False,
                    cancel_cosine: bool = True) -> torch.Tensor:
    """Returns brdf (..., L, 3)."""
    pts2l = normalize(pts2l, eps=1e-7)
    pts2c = normalize(pts2c, eps=1e-7)
    normal = normalize(normal, eps=1e-7)

    n = normal[..., None, :]
    v = pts2c[..., None, :]

    l_dot_n = torch.clamp(torch.sum(pts2l * n, dim=-1), 1e-4, 1.0)      # (..., L)
    v_dot_n = torch.clamp(torch.sum(pts2c * normal, dim=-1), 1e-4, 1.0)  # (...,)

    # diffuse
    brdf_lambert = (albedo[..., None, :] / math.pi).expand(pts2l.shape)
    if cancel_cosine:
        brdf_lambert = brdf_lambert * l_dot_n[..., None]

    # glossy (GGX)
    h = normalize(pts2l + v, eps=1e-7)
    alpha = rough ** 2

    # Fresnel (Schlick)
    cos_lh = torch.sum(pts2l * h, dim=-1)
    f = f0 + (1 - f0) * (1 - cos_lh) ** 5

    # distribution (GGX)
    cos_theta_m = torch.sum(h * n, dim=-1)
    chi_d = (cos_theta_m > 0).to(cos_theta_m.dtype)
    cos_m_sq = torch.square(cos_theta_m)
    tan_m_sq = safe_divide(1 - cos_m_sq, cos_m_sq)
    denom_d = math.pi * torch.square(cos_m_sq) * torch.square(alpha ** 2 + tan_m_sq)
    d = safe_divide(alpha ** 2 * chi_d, denom_d)

    # geometry (GGX Smith-like, reference _get_g)
    cos_theta_v = torch.sum(normal * pts2c, dim=-1)
    cos_theta = torch.sum(h * v, dim=-1)
    div = safe_divide(cos_theta, cos_theta_v[..., None])
    chi_g = (div > 0).to(div.dtype)
    cos_v_sq = torch.clamp(torch.square(cos_theta_v), 0.0, 1.0)
    tan_v_sq = torch.clamp(safe_divide(1 - cos_v_sq, cos_v_sq), 0.0, 1e10)
    denom_g = 1 + torch.sqrt(1 + alpha ** 2 * tan_v_sq[..., None])
    g = safe_divide(chi_g * 2, denom_g)

    ldn = torch.ones_like(l_dot_n) if cancel_cosine else l_dot_n
    denom = 4 * torch.abs(ldn) * torch.abs(v_dot_n)[..., None]
    micro = safe_divide(f * g * d, denom)
    brdf_glossy = micro[..., None].expand(pts2l.shape)

    if lambert_only:
        return brdf_lambert
    if glossy_only:
        return brdf_glossy
    return brdf_glossy + brdf_lambert


def evaluate_shade(lvis: torch.Tensor,   # (..., L)
                   ldot: torch.Tensor,   # (..., L)
                   area: torch.Tensor,   # (L,)
                   light: torch.Tensor   # (..., L, 3)
                   ) -> torch.Tensor:
    """Per-texel incident radiance (reference sphere_tracing_renderer.py:364-376)."""
    return lvis[..., None] * ldot[..., None] * area[..., :, None] * light
