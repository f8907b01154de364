"""Exact top-3 nearest neighbours against the posed vertex cloud.

The JAX package's exact path is the Pallas kernel ``_knn_kernel``
(``relightableavatar_tpu/ops/pallas_knn.py:28``).  Here :func:`knn_top3`
dispatches on where its input lies: a CPU tensor goes to the plain version
:func:`knn_top3_reference`, a CUDA tensor to the Hopper kernel
(``ops/knn_cuda.py``), which launches or raises.

Contract shared by both: squared distances by coordinate difference
``(px-vx)^2 + (py-vy)^2 + (pz-vz)^2`` summed left to right in float32 (not
the ``|p|^2 - 2 p.v + |v|^2`` identity), ascending, ties to the lowest
vertex index, indices int32.

:func:`knn` is the blocked public query for K <= 3 (the mesh renderer's band
filter and skinning-weight transfer), built on the same top 3.
"""
from __future__ import annotations

import torch

K = 3


def knn_top3_reference(pts: torch.Tensor, verts: torch.Tensor,
                       block: int = 4096):
    """pts (P, 3), verts (N, 3) f32 -> d2 (P, 3) f32, idx (P, 3) int32.

    Chunks of ``block`` points; each takes its top 3 by three passes of
    min-and-mask, where ``argmin`` returns the first (lowest) index of the
    minimum, so exact ties go to the lowest index."""
    if verts.shape[0] < K:
        raise ValueError(f"need at least {K} vertices, got {verts.shape[0]}")
    out_d, out_i = [], []
    for s in range(0, pts.shape[0], block):
        p = pts[s:s + block]
        dx = p[:, 0:1] - verts[None, :, 0]                         # (B, N)
        dy = p[:, 1:2] - verts[None, :, 1]
        dz = p[:, 2:3] - verts[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        ds, js = [], []
        for _ in range(K):
            j = torch.argmin(d2, dim=1, keepdim=True)             # (B, 1)
            ds.append(torch.gather(d2, 1, j))
            js.append(j)
            d2.scatter_(1, j, float("inf"))
        out_d.append(torch.cat(ds, dim=1))
        out_i.append(torch.cat(js, dim=1))
    if not out_d:
        return (pts.new_zeros((0, K)),
                torch.zeros((0, K), dtype=torch.int32, device=pts.device))
    return torch.cat(out_d), torch.cat(out_i).to(torch.int32)


def knn_top3(pts: torch.Tensor, verts: torch.Tensor):
    """Exact top-3: the plain version for CPU tensors, the Hopper kernel for
    CUDA tensors (no fallback from one to the other)."""
    if pts.device.type == "cpu" and verts.device.type == "cpu":
        return knn_top3_reference(pts, verts)
    from relightableavatar_tpu_torch.ops.knn_cuda import knn_top3_cuda
    return knn_top3_cuda(pts, verts)


CHUNK = 1 << 20     # points a kernel launch of knn() takes (a volume block's size)


def knn(pts: torch.Tensor, verts: torch.Tensor, K: int = 3):
    """pts (P, 3), verts (N, 3) -> d2 (P, K) f32, idx (P, K) int32, K <= 3:
    the first K columns of :func:`knn_top3`, in chunks of ``CHUNK`` points.

    The JAX package's ``ops/knn.py:knn`` picks a 2K + 2 superset on a
    bfloat16 distance matrix and measures it exactly in float32; this is
    exact throughout, so the two agree but on near-ties."""
    if not 1 <= K <= 3:
        raise ValueError(f"K={K}: the KNN is top-3 only")
    parts = [knn_top3(pts[s:s + CHUNK].contiguous(), verts)
             for s in range(0, pts.shape[0], CHUNK)]
    if not parts:
        return (pts.new_zeros((0, K)),
                torch.zeros((0, K), dtype=torch.int32, device=pts.device))
    d2 = torch.cat([p[0][:, :K] for p in parts])
    idx = torch.cat([p[1][:, :K] for p in parts])
    return d2, idx
