"""Point-to-triangle-mesh distance (``relightableavatar_tpu/ops/point_mesh.py``).

Used by ``cfg.smpl_distance`` (the exact canonical-SMPL mesh SDF in
``anisdf.hdq_sdf``, reference ``base_network.py:417-427``) in place of the
reference's ``bvh_distance_queries`` BVH: a brute-force closest point over
blocks of faces with a running minimum, so the (P, F) matrix never exists;
Ericson's region tests (Real-Time Collision Detection 5.1.5) vectorised
with ``torch.where``.  Ties keep the JAX package's order: the first face of
a block wins inside it (``argmin``), an earlier block against a later one
(strict ``<``).
"""
from __future__ import annotations

import torch


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def closest_point_on_triangles(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """p (..., 3) broadcast against triangles tri (..., 3, 3) -> closest
    point (..., 3).  Branch-free Ericson 5.1.5 region tests."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)

    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-12

    def safe(den):
        return torch.where(torch.abs(den) < eps, torch.full_like(den, eps), den)

    # edge/vertex barycentric params (clamped)
    v_ab = torch.clamp(d1 / safe(d1 - d3), 0, 1)
    v_ac = torch.clamp(d2 / safe(d2 - d6), 0, 1)
    v_bc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0, 1)
    denom = safe(va + vb + vc)
    v_in = vb / denom
    w_in = vc / denom

    cp_ab = a + v_ab[..., None] * ab
    cp_ac = a + v_ac[..., None] * ac
    cp_bc = b + v_bc[..., None] * (c - b)
    cp_in = a + v_in[..., None] * ab + w_in[..., None] * ac

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (~in_a) & (~in_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (~in_a) & (~in_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (~in_b) & (~in_c) & (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    out = cp_in
    out = torch.where(on_bc[..., None], cp_bc, out)
    out = torch.where(on_ac[..., None], cp_ac, out)
    out = torch.where(on_ab[..., None], cp_ab, out)
    out = torch.where(in_c[..., None], c, out)
    out = torch.where(in_b[..., None], b, out)
    out = torch.where(in_a[..., None], a, out)
    return out


PAIRS = 1 << 24     # (point, face) pairs a step holds: about 20 float32 temporaries of this size


def point_mesh_distance(pts: torch.Tensor, verts: torch.Tensor,
                        faces: torch.Tensor, block: int = 1024):
    """pts (P, 3), verts (V, 3), faces (F, 3) int -> (d2 (P,), closest (P, 3),
    fid (P,) int32).  Face blocks scanned with a running minimum, in chunks
    of ``PAIRS // block`` points (the JAX package's XLA loop fuses them)."""
    tris = verts[faces.long()]                                # (F, 3, 3)
    chunk = max(1, PAIRS // block)
    if pts.shape[0] > chunk:
        parts = [_scan_faces(pts[s:s + chunk], tris, block)
                 for s in range(0, pts.shape[0], chunk)]
        return tuple(torch.cat(t) for t in zip(*parts))
    return _scan_faces(pts, tris, block)


def _scan_faces(pts: torch.Tensor, tris: torch.Tensor, block: int):
    P = pts.shape[0]
    best_d2 = torch.full((P,), float("inf"), dtype=pts.dtype, device=pts.device)
    best_cp = torch.zeros((P, 3), dtype=pts.dtype, device=pts.device)
    best_id = torch.zeros((P,), dtype=torch.int32, device=pts.device)
    for s in range(0, tris.shape[0], block):
        tri = tris[s:s + block]
        cp = closest_point_on_triangles(pts[:, None, :], tri[None])  # (P, B, 3)
        d2 = torch.sum((pts[:, None, :] - cp) ** 2, dim=-1)          # (P, B)
        d2m, j = torch.min(d2, dim=1)          # the first index of the minimum
        cpm = torch.gather(cp, 1, j[:, None, None].expand(P, 1, 3))[:, 0]
        better = d2m < best_d2
        best_d2 = torch.where(better, d2m, best_d2)
        best_cp = torch.where(better[:, None], cpm, best_cp)
        best_id = torch.where(better, (j + s).to(torch.int32), best_id)
    return best_d2, best_cp, best_id


def face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(F, 3) unit normals (pytorch3d faces_normals_padded equivalent)."""
    tris = verts[faces.long()]
    n = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)


def signed_mesh_distance(pts: torch.Tensor, verts: torch.Tensor,
                         faces: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """(P,) signed distance: |closest| with the sign of
    dot(p - closest, n_closest_face), the reference's BVH-SDF convention
    (base_network.py:421-427)."""
    d2, cp, fid = point_mesh_distance(pts, verts, faces, block=block)
    n = face_normals(verts, faces)[fid.long()]
    s = torch.sign(torch.sum((pts - cp) * n, dim=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.sqrt(torch.clamp(d2, min=0.0)) * s
