"""Linear blend skinning algebra (``relightableavatar_tpu/ops/lbs.py``),
broadcast over leading dims (reference ``lib/utils/blend_utils.py``)."""
from __future__ import annotations

import torch


def affine_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid/affine transforms (blend_utils.py:11-21)."""
    R = A[..., :3, :3]
    T = A[..., :3, 3:]
    P = A[..., 3:, :]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ T], dim=-1)
    return torch.cat([top, P], dim=-2)


def inverse_3x3(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Adjugate inverse of (..., 3, 3) with +eps on the determinant
    (blend_utils.py:125-165)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    m00 = r11 * r22 - r21 * r12
    m10 = -r10 * r22 + r20 * r12
    m20 = r10 * r21 - r20 * r11
    m01 = -r01 * r22 + r21 * r02
    m11 = r00 * r22 - r20 * r02
    m21 = -r00 * r21 + r20 * r01
    m02 = r01 * r12 - r11 * r02
    m12 = -r00 * r12 + r10 * r02
    m22 = r00 * r11 - r10 * r01

    D = r00 * m00 + r01 * m10 + r02 * m20
    M = torch.stack([
        torch.stack([m00, m01, m02], dim=-1),
        torch.stack([m10, m11, m12], dim=-1),
        torch.stack([m20, m21, m22], dim=-1),
    ], dim=-2)
    return M / (D[..., None, None] + eps)


def blend_transform(bw: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """bw (..., P, J); A (..., J, 4, 4) -> (..., P, 4, 4)."""
    return torch.einsum('...pj,...jab->...pab', bw, A)


def world_points_to_pose_points(wpts, R, Th):
    """wpts (..., P, 3); R (..., 3, 3); Th (..., 3) or (..., 1, 3)."""
    if Th.dim() == R.dim() - 1:
        Th = Th[..., None, :]
    return (wpts - Th) @ R


def pose_points_to_world_points(ppts, R, Th):
    if Th.dim() == R.dim() - 1:
        Th = Th[..., None, :]
    return ppts @ R.transpose(-1, -2) + Th


def world_dirs_to_pose_dirs(wdirs, R):
    return wdirs @ R


def pose_dirs_to_world_dirs(pdirs, R):
    return pdirs @ R.transpose(-1, -2)


def pose_points_to_tpose_points(ppts, A_bw, R_inv=None):
    """x_t = R^-1 (x_p - t) with per-point blended transforms."""
    pts = ppts - A_bw[..., :3, 3]
    if R_inv is None:
        R_inv = inverse_3x3(A_bw[..., :3, :3])
    return torch.einsum('...pab,...pb->...pa', R_inv, pts)


def tpose_points_to_pose_points(tpts, A_bw, R_inv=None):
    pts = torch.einsum('...pab,...pb->...pa', A_bw[..., :3, :3], tpts)
    return pts + A_bw[..., :3, 3]


def pose_dirs_to_tpose_dirs(pdirs, A_bw, R_inv=None):
    """Directions transform with the transpose."""
    R = A_bw[..., :3, :3]
    return torch.einsum('...pba,...pb->...pa', R, pdirs)


def tpose_dirs_to_pose_dirs(tdirs, A_bw, R_inv=None):
    if R_inv is None:
        R_inv = inverse_3x3(A_bw[..., :3, :3])
    return torch.einsum('...pba,...pb->...pa', R_inv, tdirs)


def normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """v / ||v||, finite (value and gradient) at v == 0."""
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps)
