"""Nearest neighbours against the posed vertex cloud: the exact top 3 and
the other routes of ``tpu.knn_impl`` and ``sample_vert_cnt``.

The JAX package's exact path is the Pallas kernel ``_knn_kernel``
(``relightableavatar_tpu/ops/pallas_knn.py:28``).  Here :func:`knn_top3`
dispatches on where its input lies: a CPU tensor goes to the plain version
:func:`knn_top3_reference`, a CUDA tensor to the Hopper kernel
(``ops/knn_cuda.py``), which launches or raises.

Contract shared by both: squared distances by coordinate difference
``(px-vx)^2 + (py-vy)^2 + (pz-vz)^2`` summed left to right in float32 (not
the ``|p|^2 - 2 p.v + |v|^2`` identity), ascending, ties to the lowest
vertex index, indices int32.

:func:`knn` is the blocked public query (the mesh renderer's band filter
and skinning-weight transfer), built on the same top 3 for K <= 3.

The other routes run no hand-written kernel, as their JAX counterparts run
no Pallas kernel:

- :func:`knn_topk_reference`, the exact top K for K > 3
  (``knn_unchunked(exact=True)``, ``relightableavatar_tpu/ops/knn.py:124-129``);
- :func:`knn_select`, the bfloat16 selection of ``tpu.knn_impl='xla'``
  (``:263-274``);
- :func:`knn_grouped`, the two-level bounding-sphere KNN of
  ``tpu.knn_impl='grouped'`` over the k-d leaves of
  :func:`build_vertex_groups` (``:157-248``);
- :func:`subsample_verts`, the vertex subsample of
  ``tpu.shadow_verts_sub`` (``:251-260``).
"""
from __future__ import annotations

import numpy as np
import torch

from relightableavatar_tpu_torch.utils.log import log

K = 3


def knn_top3_reference(pts: torch.Tensor, verts: torch.Tensor,
                       block: int = 4096):
    """pts (P, 3), verts (N, 3) f32 -> d2 (P, 3) f32, idx (P, 3) int32.

    Chunks of ``block`` points; each takes its top 3 by three passes of
    min-and-mask, where ``argmin`` returns the first (lowest) index of the
    minimum, so exact ties go to the lowest index."""
    return knn_topk_reference(pts, verts, K, block)


def knn_topk_reference(pts: torch.Tensor, verts: torch.Tensor, k: int,
                       block: int = 4096):
    """:func:`knn_top3_reference` for any ``k``: (P, k) d2 f32 ascending and
    idx int32, ties to the lowest index."""
    if verts.shape[0] < k:
        raise ValueError(f"need at least {k} vertices, got {verts.shape[0]}")
    out_d, out_i = [], []
    for s in range(0, pts.shape[0], block):
        p = pts[s:s + block]
        dx = p[:, 0:1] - verts[None, :, 0]                         # (B, N)
        dy = p[:, 1:2] - verts[None, :, 1]
        dz = p[:, 2:3] - verts[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        ds, js = [], []
        for _ in range(k):
            j = torch.argmin(d2, dim=1, keepdim=True)             # (B, 1)
            ds.append(torch.gather(d2, 1, j))
            js.append(j)
            d2.scatter_(1, j, float("inf"))
        out_d.append(torch.cat(ds, dim=1))
        out_i.append(torch.cat(js, dim=1))
    if not out_d:
        return (pts.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int32, device=pts.device))
    return torch.cat(out_d), torch.cat(out_i).to(torch.int32)


_LOGGED_TOPK = False


def knn_topk(pts: torch.Tensor, verts: torch.Tensor, k: int):
    """The exact top ``k`` for k > 3 (``sample_vert_cnt`` > 3): the plain
    version on either device.  The JAX package's counterpart is its
    ``|p|^2 - 2 p.v + |v|^2`` matmul and ``lax.top_k`` (no Pallas kernel
    for K != 3); this one sums coordinate differences, as K1 does, so the two
    agree but on near-ties.  Says once that no hand-written kernel runs."""
    global _LOGGED_TOPK
    if k <= K:
        raise ValueError(f"k={k}: the top {K} or fewer is knn_top3's")
    if not _LOGGED_TOPK:
        log(f"KNN top {k}: the plain PyTorch top-k (K1 is the top 3 only)", "yellow")
        _LOGGED_TOPK = True
    return knn_topk_reference(pts, verts, k)


def knn_top3(pts: torch.Tensor, verts: torch.Tensor):
    """Exact top-3: the plain version for CPU tensors, the Hopper kernel for
    CUDA tensors (no fallback from one to the other)."""
    if pts.device.type == "cpu" and verts.device.type == "cpu":
        return knn_top3_reference(pts, verts)
    from relightableavatar_tpu_torch.ops.knn_cuda import knn_top3_cuda
    return knn_top3_cuda(pts, verts)


CHUNK = 1 << 20     # points a kernel launch of knn() takes (a volume block's size)


def knn(pts: torch.Tensor, verts: torch.Tensor, K: int = 3):
    """pts (P, 3), verts (N, 3) -> d2 (P, K) f32, idx (P, K) int32: for
    K <= 3 the first K columns of :func:`knn_top3`, for K > 3
    :func:`knn_topk`, in chunks of ``CHUNK`` points.

    The JAX package's ``ops/knn.py:knn`` picks a 2K + 2 superset on a
    bfloat16 distance matrix and measures it exactly in float32; this is
    exact throughout, so the two agree but on near-ties."""
    if K < 1:
        raise ValueError(f"K={K}: need at least one neighbour")
    top = knn_top3 if K <= 3 else lambda p, v: knn_topk(p, v, K)
    parts = [top(pts[s:s + CHUNK].contiguous(), verts)
             for s in range(0, pts.shape[0], CHUNK)]
    if not parts:
        return (pts.new_zeros((0, K)),
                torch.zeros((0, K), dtype=torch.int32, device=pts.device))
    d2 = torch.cat([p[0][:, :K] for p in parts])
    idx = torch.cat([p[1][:, :K] for p in parts])
    return d2, idx


# ------------------------------------------------------------- bf16 selection
SELECT_BLOCK = 4096     # points a selection matrix holds (4096 x N float32)


def knn_select(pts: torch.Tensor, verts: torch.Tensor, K: int = 3,
               block: int = SELECT_BLOCK) -> torch.Tensor:
    """Indices (P, K) int64 of ``tpu.knn_impl='xla'``: the JAX package's
    selection matrix, coordinate differences cast to bfloat16, squared and
    summed ``(dx^2 + dy^2) + dz^2`` in bfloat16 with a rounding after each
    operation (JAX's CPU matrix to the bit; torch rounds every bfloat16
    op), then the K smallest of each row by a stable sort, ties to the
    lowest index.  JAX takes them with ``approx_min_k``, which on the CPU is
    a full sort that is not stable, so rows whose K values tie in bfloat16
    may hold other vertices of the same values (``tests/test_torch_options.py``
    counts them).  No values: the caller measures the exact distances from
    its own gather."""
    out = []
    for s in range(0, pts.shape[0], block):
        p = pts[s:s + block]
        d = [(p[:, i:i + 1] - verts[None, :, i]).to(torch.bfloat16) for i in range(3)]
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        del d
        out.append(torch.sort(d2.float(), dim=1, stable=True).indices[:, :K])
    if not out:
        return torch.zeros((0, K), dtype=torch.int64, device=pts.device)
    return torch.cat(out)


# ------------------------------------------------------------- grouped KNN
# The two-level KNN of the JAX package: the posed vertices in G balanced k-d
# leaves of S members; a query ranks the leaves by the bounding-sphere lower
# bound max(|p - centroid| - radius, 0), gathers the C best leaves' C * S
# candidates and takes the exact top K among them.

GROUP_SIZE = 16          # S: vertices a leaf (padded)
GROUP_TOPC = 12          # C: candidate leaves a query


def build_vertex_groups(tverts):
    """Balanced k-d partition of a vertex cloud (host numpy): gvid (G, S)
    int32 vertex ids and gmask (G, S) bool (False = padding slot).  Each
    split halves a leaf at the median of its longest axis (stable sort)."""
    tverts = np.asarray(tverts, np.float32)
    N = len(tverts)
    G = 1
    while G * GROUP_SIZE < N:
        G *= 2
    ids = [np.arange(N)]
    while len(ids) < G:
        nxt = []
        for leaf in ids:
            pts = tverts[leaf]
            ax = int(np.argmax(pts.max(0) - pts.min(0)))
            order = np.argsort(pts[:, ax], kind="stable")
            half = (len(leaf) + 1) // 2
            nxt.append(leaf[order[:half]])
            nxt.append(leaf[order[half:]])
        ids = nxt
    gvid = np.zeros((G, GROUP_SIZE), np.int32)
    gmask = np.zeros((G, GROUP_SIZE), bool)
    for g, leaf in enumerate(ids):
        gvid[g, :len(leaf)] = leaf
        gmask[g, :len(leaf)] = True
    return gvid, gmask


def group_frame_arrays(pverts, gvid, gmask):
    """A frame's grouped arrays (host numpy): gverts (G, S, 3) with padding
    slots at 1e6 m so that they never win, gcent (G, 3) the members'
    centroids and gradius (G,) the bounding-sphere radii around them."""
    pverts = np.asarray(pverts, np.float32)
    gverts = pverts[gvid]
    cnt = gmask.sum(-1, keepdims=True).clip(1)
    gcent = (gverts * gmask[..., None]).sum(1) / cnt
    d = np.sqrt((((gverts - gcent[:, None]) ** 2).sum(-1)) * gmask)
    gradius = d.max(-1)
    gverts = np.where(gmask[..., None], gverts, 1e6)
    return (gverts.astype(np.float32), gcent.astype(np.float32),
            gradius.astype(np.float32))


def _top_c_min(d2: torch.Tensor, C: int) -> torch.Tensor:
    """Columns (P, C) of the C smallest entries of each row, in order, by C
    passes of argmin-and-mask (ties to the lowest column)."""
    d2 = d2.clone()
    idx = []
    for _ in range(C):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        idx.append(i)
        d2.scatter_(1, i, float("inf"))
    return torch.cat(idx, dim=-1)


def knn_grouped(pts: torch.Tensor, gverts: torch.Tensor, gcent: torch.Tensor,
                gradius: torch.Tensor, gvid: torch.Tensor, K: int = 3):
    """pts (P, 3) against the grouped cloud (gverts (G, S, 3), ids gvid (G,
    S)) -> d2 (P, K) f32 ascending, idx (P, K) int32: the brute-force top K
    whenever it lies in the C leaves of smallest bounding-sphere lower
    bound.  The leaves are ranked on the JAX package's ``|p|^2 - 2 p.c +
    |c|^2`` centroid distances; the candidates' distances are exact."""
    P = pts.shape[0]
    G = gverts.shape[0]
    csq = torch.sum(gcent * gcent, dim=-1)
    d2c = torch.sum(pts * pts, dim=-1, keepdim=True) - 2.0 * (pts @ gcent.T) + csq[None, :]
    lb = torch.clamp(torch.sqrt(torch.clamp(d2c, min=0.0)) - gradius[None, :], min=0.0)
    top_g = _top_c_min(lb, min(GROUP_TOPC, G))
    cand_v = gverts[top_g].reshape(P, -1, 3)
    cand_i = gvid[top_g].reshape(P, -1)
    diff = pts[:, None, :] - cand_v
    d2 = torch.sum(diff * diff, dim=-1)
    j = _top_c_min(d2, K)
    return (torch.clamp(torch.gather(d2, 1, j), min=0.0),
            torch.gather(cand_i, 1, j).to(torch.int32))


def subsample_verts(gvid, gmask, stride: int) -> np.ndarray:
    """Global ids (host numpy int32) of every ``stride``-th member of each
    k-d leaf of :func:`build_vertex_groups`: a spatially uniform subsample,
    unlike a stride over vertex ids."""
    ids = [gvid[g][gmask[g]][::stride] for g in range(gvid.shape[0])]
    return np.concatenate(ids).astype(np.int32)
