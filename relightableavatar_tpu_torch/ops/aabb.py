"""Ray-AABB intersection (``relightableavatar_tpu/ops/aabb.py``; reference
``lib/utils/net_utils.py:1683-1719``), without compaction."""
from __future__ import annotations

import torch


def pad_box(box: torch.Tensor, margin: float) -> torch.Tensor:
    """(2, 3) box grown by ``margin`` on every side."""
    return torch.stack([box[0] - margin, box[1] + margin])


def get_near_far_aabb(bounds: torch.Tensor, ray_o: torch.Tensor,
                      ray_d: torch.Tensor, epsilon: float = 1e-8):
    """bounds (..., 2, 3); ray_o/ray_d (..., P, 3) ->
    near (..., P), far (..., P), hit (..., P) bool."""
    if bounds.dim() < ray_o.dim():
        bounds = bounds.unsqueeze(-3)

    # the reference's in-place clamps of tiny direction components
    d = ray_d
    d = torch.where((d < epsilon) & (d > -epsilon ** 2), torch.full_like(d, epsilon), d)
    d = torch.where((d > -epsilon ** 2) & (d < epsilon), torch.full_like(d, -epsilon), d)

    tmin = (bounds[..., :1, :] - ray_o) / d
    tmax = (bounds[..., 1:2, :] - ray_o) / d
    t1 = torch.minimum(tmin, tmax)
    t2 = torch.maximum(tmin, tmax)
    near = torch.amax(t1, dim=-1)
    far = torch.amin(t2, dim=-1)
    return near, far, near < far
