"""Environment-map utilities (``relightableavatar_tpu/ops/envmap.py``):
lat-long light grid, equirect bilinear lookup, probe rotation, sRGB
transfer (reference ``lib/utils/relight_utils.py:55-465``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from relightableavatar_tpu_torch.device import to_device


def gen_light_xyz(env_h: int, env_w: int, env_r: float = 1e2,
                  device: str | torch.device = "cpu"):
    """xyz (eH, eW, 3) texel centers on a radius-r sphere and areas (eH, eW)
    solid angles, in the reference's z-up lat-long layout."""
    lat_half = math.pi / env_h / 2
    lng_half = 2 * math.pi / env_w / 2
    lats = np.linspace(math.pi / 2 - lat_half, -math.pi / 2 + lat_half, env_h)
    lngs = np.linspace(math.pi - lng_half, -math.pi + lng_half, env_w)
    lngs_g, lats_g = np.meshgrid(lngs, lats)

    z = env_r * np.sin(lats_g)
    x = env_r * np.cos(lats_g) * np.cos(lngs_g)
    y = env_r * np.cos(lats_g) * np.sin(lngs_g)
    xyz = np.stack([x, y, z], axis=-1)

    sin_colat = np.sin(math.pi / 2 - lats_g)
    areas = 4 * math.pi * sin_colat / np.sum(sin_colat)
    device = torch.device(device)
    return to_device(xyz.astype(np.float32), device), to_device(areas.astype(np.float32), device)


def probe_at_texels(probe: torch.Tensor, light_xyz: torch.Tensor) -> torch.Tensor:
    """Probe (eh, ew, 3) sampled at each light-grid texel direction -> (L, 3)."""
    L = light_xyz.shape[0] * light_xyz.shape[1]
    d = light_xyz.reshape(L, 3)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    return sample_envmap_image(probe, d)


def lvis_upsample_matrix(hc: int, wc: int, H: int, W: int) -> np.ndarray:
    """(hc*wc, H*W) bilinear weights lifting a coarse lat-long light grid to
    the full grid (longitude wraps, latitude clamps)."""
    U = np.zeros((hc * wc, H * W), np.float32)
    for i in range(H):
        y = (i + 0.5) * hc / H - 0.5
        y0 = int(np.floor(y))
        ty = y - y0
        ys = [(max(0, min(hc - 1, y0)), 1 - ty),
              (max(0, min(hc - 1, y0 + 1)), ty)]
        for j in range(W):
            x = (j + 0.5) * wc / W - 0.5
            x0 = int(np.floor(x))
            tx = x - x0
            xs = [(x0 % wc, 1 - tx), ((x0 + 1) % wc, tx)]
            for yy, wy in ys:
                for xx, wx in xs:
                    U[yy * wc + xx, i * W + j] += wy * wx
    return U


def _bilinear_sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """image (H, W, C); continuous pixel coords with centers at i+0.5
    (align_corners=False), border padding.  Returns (..., C)."""
    H, W = image.shape[:2]
    x0 = torch.floor(x - 0.5)
    y0 = torch.floor(y - 0.5)
    wx = ((x - 0.5) - x0)[..., None]
    wy = ((y - 0.5) - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = (x0i + 1).clamp(0, W - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    x0i = x0i.clamp(0, W - 1)
    y0i = y0i.clamp(0, H - 1)

    v00 = image[y0i, x0i]
    v01 = image[y0i, x1i]
    v10 = image[y1i, x0i]
    v11 = image[y1i, x1i]
    return ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
            + (v10 * (1 - wx) + v11 * wx) * wy)


def sample_envmap_image(image: torch.Tensor, ray_d: torch.Tensor) -> torch.Tensor:
    """image (eH, eW, 3) or (1, eH, eW, 3); ray_d (..., 3) -> (..., 3), as the
    reference's grid_sample call (relight_utils.py:106-127)."""
    if image.dim() == 4:
        image = image[0]
    H, W = image.shape[:2]
    d = ray_d / (torch.linalg.vector_norm(ray_d, dim=-1, keepdim=True) + 1e-13)
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0)) - 1e-6
    phi = torch.atan2(d[..., 1], d[..., 0])

    query_y = (theta / math.pi) * 2 - 1
    query_x = -phi / math.pi
    px = (query_x + 1) * 0.5 * W
    py = (query_y + 1) * 0.5 * H
    return _bilinear_sample(image, px, py)


def linear2srgb(linear: torch.Tensor) -> torch.Tensor:
    linear = torch.clamp(linear, 0.0, 1.0)
    lin = linear * 12.92
    nonlin = 1.055 * torch.pow(linear + 1e-7, 1 / 2.4) - 0.055
    return torch.where(linear <= 0.0031308, lin, nonlin)


def srgb2linear(srgb: torch.Tensor) -> torch.Tensor:
    srgb = torch.clamp(srgb, 0.0, 1.0)
    lin = srgb / 12.92
    nonlin = torch.pow(srgb, 2.4)
    return torch.where(srgb <= 0.04045, lin, nonlin)


def shift_image(image: torch.Tensor, shift: float) -> torch.Tensor:
    """Horizontal sub-pixel wrap-around shift of an (H, W, C) or (B, H, W, C)
    image by bilinear resampling (reference ``rotate_envmap``'s
    ``shift_image``, relight_utils.py:79-99)."""
    H, W = image.shape[-3:-1]
    batched = image.dim() == 4
    if not batched:
        image = image[None]
    x = (torch.arange(W, dtype=torch.float32, device=image.device) + 0.5 + shift) % W
    y = torch.arange(H, dtype=torch.float32, device=image.device) + 0.5
    yy, xx = torch.meshgrid(y, x, indexing="ij")                   # (H, W)
    out = torch.stack([_bilinear_sample(im, xx, yy) for im in image])
    return out if batched else out[0]


def rotate_envmap_dict(novel_light: dict, index: int, repeat: int, probe_width: int):
    """Reference ``rotate_envmap`` (relight_utils.py:55-103): light ``i`` and
    sub-rotation ``j`` of a flat index; returns (name, envmap dict).  The
    probes are tensors (or arrays, taken to the CPU as float32 tensors)."""
    keys = list(novel_light.keys())
    if repeat <= 0:
        return keys[index], novel_light[keys[index]]
    n_rotation = probe_width * repeat
    i = index // n_rotation
    j = index % n_rotation
    name = f'{keys[i]}-{j:04d}'
    envmap = novel_light[keys[i]]
    probe = torch.as_tensor(envmap['probe'], dtype=torch.float32)
    image = torch.as_tensor(envmap['image'], dtype=torch.float32)
    eW = probe.shape[-2]
    iW = image.shape[-2]
    uW = eW * repeat
    return name, dict(probe=shift_image(probe, eW / uW * j),
                      image=shift_image(image, iW / uW * j))


def reflect(ray_d: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    dot = torch.sum(ray_d * norm, dim=-1, keepdim=True)
    return 2 * (norm * dot) - ray_d
