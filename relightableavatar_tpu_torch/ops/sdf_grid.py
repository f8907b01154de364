"""Per-frame SDF voxel grid for shadow rays (``relightableavatar_tpu/ops/sdf_grid.py``).

The HDQ world SDF is frozen within a frame, so it is baked once into a
dense lattice over the padded body box; shadow rays and the slice-sweep
visibility volume (``ops/lvis_sweep.py``) read trilinear lookups of it
instead of running KNN -> LBS -> MLP chains.  The camera trace stays on the
exact HDQ SDF; the miss skip marches :func:`grid_sdf_lower_bound`.

Resolution is per axis (``axis_resolutions``): near-isotropic voxels over
the strongly anisotropic body box.  The packed cell-corner table of
:func:`pack_grid_corners` is kept for parity with the JAX package; on the
GPU the lookups are plain index gathers either way.
"""
from __future__ import annotations

import numpy as np
import torch

from relightableavatar_tpu_torch.device import to_device

BAKE_CHUNK = 262144     # ceiling of one bake call's points


def resolve_res(res) -> tuple:
    """int -> cubic tuple; a 3-tuple passes through."""
    if isinstance(res, (tuple, list)):
        if len(res) != 3:
            raise ValueError(f"need 3 axis resolutions, got {res!r}")
        return tuple(int(r) for r in res)
    return (int(res),) * 3


def axis_resolutions(extents, n: int, min_res: int = 17) -> tuple:
    """Per-axis lattice sizes: ``n`` nodes on the longest axis, the others
    scaled by extent.  ``extents`` is host-side (numpy or a list)."""
    e = np.asarray(extents, np.float64).reshape(3)
    scale = e / max(float(e.max()), 1e-6)
    return tuple(int(max(min_res, round(n * s))) for s in scale)


def _linspace(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, n)`` for scalar tensors by its float32 formula,
    ``lo * (1 - s) + hi * s`` with ``s = i / (n - 1)`` and the last node
    exactly ``hi``.  XLA's fused evaluation rounds some interior nodes one
    ulp apart from this, so lattices agree with the JAX package's to about
    1e-7 m, not bit for bit."""
    if n == 1:
        return lo.reshape(1)
    div = n - 1
    step = torch.arange(div, dtype=lo.dtype, device=lo.device) / div
    out = lo * (1 - step) + hi * step
    return torch.cat([out, hi.reshape(1)])


def bake_chunk(n: int, chunk: int = BAKE_CHUNK) -> int:
    """Points per bake call for an ``n``-node lattice: the smallest multiple
    of 1024 that covers ``n`` in as many calls as a block of ``chunk``
    would (``relightableavatar_tpu/ops/sdf_grid.py:56-62``)."""
    nblk = -(-n // min(chunk, n))
    per_blk = -(-n // nblk)
    return -(-per_blk // 1024) * 1024


def build_sdf_grid(sdf_fn, lo: torch.Tensor, hi: torch.Tensor, res,
                   chunk: int = BAKE_CHUNK) -> torch.Tensor:
    """``sdf_fn`` at the nodes of an (Rx, Ry, Rz) lattice spanning [lo, hi]
    (corners included) -> (Rx, Ry, Rz) float32.  The padded tail of the last
    call repeats the first node, as the JAX package does, so the KNN calls
    have the same sizes."""
    res = resolve_res(res)
    ax = [_linspace(lo[i], hi[i], res[i]) for i in range(3)]
    X, Y, Z = torch.meshgrid(*ax, indexing="ij")
    pts = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)
    n = pts.shape[0]
    chunk = bake_chunk(n, chunk)
    pad = (-n) % chunk
    if pad:
        pts = torch.cat([pts, pts[:1].expand(pad, 3)])
    vals = [sdf_fn(pts[s:s + chunk])[:, 0] for s in range(0, pts.shape[0], chunk)]
    return torch.cat(vals)[:n].reshape(res)


@torch.no_grad()
def build_hdq_grid(params, mcfg, ctx, lo, hi, res, dist_th: float | None = None,
                   packed: bool = False, verts_sub: bool = False) -> torch.Tensor:
    """Per-frame bake of the HDQ world SDF; ``packed=True`` returns the
    cell-corner table.  ``verts_sub`` bakes with the KNN against the vertex
    subsample (``tpu.shadow_verts_sub``: the grid feeds only shadow
    visibility and the camera trace's lower bounds)."""
    from relightableavatar_tpu_torch.models import anisdf
    hdq = lambda x: anisdf.hdq_sdf(params, mcfg, ctx, x, smooth_transition=True,
                                   dist_th=dist_th, verts_sub=verts_sub)
    grid = build_sdf_grid(hdq, lo, hi, res)
    return pack_grid_corners(grid) if packed else grid


def pack_grid_corners(grid: torch.Tensor) -> torch.Tensor:
    """(Rx, Ry, Rz) -> (Rx-1, Ry-1, Rz-1, 8) cell-corner table, corners in
    (dx, dy, dz) order, dx major."""
    Rx, Ry, Rz = grid.shape
    c = [grid[dx:Rx - 1 + dx, dy:Ry - 1 + dy, dz:Rz - 1 + dz]
         for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    return torch.stack(c, dim=-1)


def _cell_rows(grid, lo, hi, x):
    """Cell coordinates of ``x`` in the packed table: (rows (P, 8), f, b,
    res) with ``f`` the clamped fractional lattice coordinate and ``b`` its
    floor."""
    if grid.dim() == 3:
        grid = pack_grid_corners(grid)
    cx, cy, cz = grid.shape[:3]
    flat = grid.reshape(cx * cy * cz, 8)
    res = to_device([cx + 1, cy + 1, cz + 1], x.device, x.dtype)
    f = (x - lo) / (hi - lo) * (res - 1)
    f = torch.minimum(torch.clamp(f, min=0.0), res - 1 - 1e-4)
    b = torch.floor(f)
    bi = b.to(torch.int64)
    rows = flat[(bi[:, 0] * cy + bi[:, 1]) * cz + bi[:, 2]]
    return rows, f, b, res


def grid_sdf_lower_bound(grid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Conservative lower bound of a 1-Lipschitz SDF, (P, 3) -> (P, 1): the
    smallest corner of the cell minus half its diagonal.  Marching it can
    never pass a true surface (the trilerp can, near sub-voxel features)."""
    rows, _, _, res = _cell_rows(grid, lo, hi, x)
    voxel = (hi - lo) / (res - 1)
    half_diag = 0.5 * torch.sqrt(torch.sum(voxel ** 2))
    return torch.amin(rows, dim=-1, keepdim=True) - half_diag


def grid_sdf(grid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup, (P, 3) -> (P, 1); queries clamp to the box.
    ``grid`` is the (Rx, Ry, Rz) lattice or its packed corner table."""
    rows, f, b, _ = _cell_rows(grid, lo, hi, x)
    t = f - b
    tx, ty, tz = t[:, 0:1], t[:, 1:2], t[:, 2:3]
    wx = torch.cat([1 - tx, tx], dim=-1)
    wy = torch.cat([1 - ty, ty], dim=-1)
    wz = torch.cat([1 - tz, tz], dim=-1)
    w = (wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]).reshape(-1, 8)
    return torch.sum(rows * w, dim=-1, keepdim=True)
