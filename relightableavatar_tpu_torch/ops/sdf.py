"""VolSDF density and volume rendering (``relightableavatar_tpu/ops/sdf.py``;
reference ``lib/utils/net_utils.py:851-999``)."""
from __future__ import annotations

import torch


def sdf_to_sigma(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Laplace CDF density, branchless like the reference (:873-893)."""
    x = -sdf
    ind0 = x <= 0
    ind1 = ~ind0
    zero = torch.zeros_like(x)
    val0 = 1 / beta * (0.5 * torch.exp(torch.where(ind0, x, zero) / beta)) * ind0
    val1 = 1 / beta * (1 - 0.5 * torch.exp(-torch.where(ind1, x, zero) / beta)) * ind1
    return val0 + val1


def raw2alpha(raw: torch.Tensor, dists=0.005, bias: float = 0.0) -> torch.Tensor:
    return 1.0 - torch.exp(-torch.relu(raw + bias) * dists)


def sdf_to_occ(sdf: torch.Tensor, beta: torch.Tensor, dists=0.005) -> torch.Tensor:
    return raw2alpha(sdf_to_sigma(sdf, beta), dists)


def render_weights(alpha: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """alpha (..., S) -> compositing weights (..., S)."""
    shifted = torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + eps], dim=-1)
    return alpha * torch.cumprod(shifted, dim=-1)


def volume_rendering(rgb: torch.Tensor, alpha: torch.Tensor, eps: float = 1e-8,
                     bg_brightness: float = 0.0):
    """rgb (..., S, C), alpha (..., S) ->
    (weights (..., S), rgb_map (..., C), acc_map (...,))."""
    weights = render_weights(alpha, eps)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc_map = torch.sum(weights, dim=-1)
    rgb_map = rgb_map + (1.0 - acc_map[..., None]) * bg_brightness
    return weights, rgb_map, acc_map
