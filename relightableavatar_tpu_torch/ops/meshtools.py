"""Offline mesh utilities: winding number, Loop subdivision, decimation; a
copy of ``relightableavatar_tpu/ops/meshtools.py`` for the port.

Covers the reference's mesh_utils toolbox (lib/utils/mesh_utils.py):
- generalized winding number inside/outside test (:614-896 uses it for
  remeshing) — here the exact solid-angle sum, vectorized and blocked;
- halfedge Loop subdivision (:382-612) — matrix form, one iteration per call;
- quadric decimation (mesh_renderer.py:95-96 via trimesh) — the host C++
  QEM (``csrc/decimate.cpp`` through ``ops/native.py``, which raises when it
  does not build); :func:`_cluster_decimate`, the JAX package's fallback, is
  kept as a plain version for the tests.

All host-side numpy: these run in offline tools (mesh extraction, remeshing),
not on the device hot path.
"""
from __future__ import annotations

import numpy as np


# ------------------------------------------------------------- winding number
def winding_number(pts: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                   block: int = 2048) -> np.ndarray:
    """Generalized winding number of each point (P,) — ~1 inside a closed
    mesh, ~0 outside (van Oosterom–Strackee signed solid angle per tri)."""
    P = len(pts)
    out = np.zeros(P, np.float64)
    tri = verts[faces]                       # (F, 3, 3)
    for s in range(0, P, block):
        p = pts[s:s + block][:, None, :]     # (B, 1, 3)
        a = tri[None, :, 0] - p              # (B, F, 3)
        b = tri[None, :, 1] - p
        c = tri[None, :, 2] - p
        la = np.linalg.norm(a, axis=-1)
        lb = np.linalg.norm(b, axis=-1)
        lc = np.linalg.norm(c, axis=-1)
        num = np.einsum('bfi,bfi->bf', a, np.cross(b, c))
        den = (la * lb * lc + np.einsum('bfi,bfi->bf', a, b) * lc
               + np.einsum('bfi,bfi->bf', b, c) * la
               + np.einsum('bfi,bfi->bf', c, a) * lb)
        out[s:s + block] = np.arctan2(num, den).sum(-1) / (2 * np.pi)
    return out


def inside_mesh(pts: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                th: float = 0.5) -> np.ndarray:
    return winding_number(pts, verts, faces) > th


# ------------------------------------------------------------- subdivision
def loop_subdivide(verts: np.ndarray, faces: np.ndarray):
    """One Loop-subdivision iteration: (V,3),(F,3) -> (V',3),(4F,3).

    Standard stencils: interior edge point (3/8,3/8,1/8,1/8), boundary edge
    midpoint; even vertices re-weighted by Loop's beta, boundary 1/8-3/4-1/8."""
    V, F = len(verts), len(faces)
    # unique edges + opposite vertices
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    opp = np.concatenate([faces[:, 2], faces[:, 0], faces[:, 1]])
    key = np.sort(e, axis=1)
    uniq, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                  return_counts=True)
    E = len(uniq)

    # odd (edge) points
    edge_pt = np.zeros((E, 3), np.float64)
    sum_opp = np.zeros((E, 3), np.float64)
    np.add.at(sum_opp, inv, verts[opp])
    interior = counts == 2
    mids = 0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]])
    edge_pt[:] = mids
    edge_pt[interior] = (3 / 8) * (verts[uniq[interior, 0]]
                                   + verts[uniq[interior, 1]]) \
        + (1 / 8) * sum_opp[interior]

    # even (original) points
    boundary_edges = uniq[~interior]
    is_boundary_v = np.zeros(V, bool)
    is_boundary_v[boundary_edges.reshape(-1)] = True

    deg = np.zeros(V, np.int64)
    nb_sum = np.zeros((V, 3), np.float64)
    np.add.at(deg, uniq[:, 0], 1)
    np.add.at(deg, uniq[:, 1], 1)
    np.add.at(nb_sum, uniq[:, 0], verts[uniq[:, 1]])
    np.add.at(nb_sum, uniq[:, 1], verts[uniq[:, 0]])

    n = np.maximum(deg, 1).astype(np.float64)
    beta = np.where(deg == 3, 3 / 16, 3 / (8 * n))
    even = (1 - n * beta)[:, None] * verts + beta[:, None] * nb_sum

    # boundary evens: 3/4 self + 1/8 each boundary neighbor
    bnb_sum = np.zeros((V, 3), np.float64)
    bdeg = np.zeros(V, np.int64)
    np.add.at(bnb_sum, boundary_edges[:, 0], verts[boundary_edges[:, 1]])
    np.add.at(bnb_sum, boundary_edges[:, 1], verts[boundary_edges[:, 0]])
    np.add.at(bdeg, boundary_edges[:, 0], 1)
    np.add.at(bdeg, boundary_edges[:, 1], 1)
    bmask = is_boundary_v & (bdeg == 2)
    even[bmask] = 0.75 * verts[bmask] + 0.125 * bnb_sum[bmask]

    new_verts = np.concatenate([even, edge_pt]).astype(verts.dtype)

    # face split: v0-e01-e20, v1-e12-e01, v2-e20-e12, e01-e12-e20
    eid = inv.reshape(3, F).T + V                # (F, 3): e01, e12, e20
    f0 = np.stack([faces[:, 0], eid[:, 0], eid[:, 2]], 1)
    f1 = np.stack([faces[:, 1], eid[:, 1], eid[:, 0]], 1)
    f2 = np.stack([faces[:, 2], eid[:, 2], eid[:, 1]], 1)
    f3 = eid
    new_faces = np.concatenate([f0, f1, f2, f3]).astype(faces.dtype)
    return new_verts, new_faces


# ------------------------------------------------------------- decimation
def _cluster_decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """Uniform vertex clustering sized to roughly hit the target (the JAX
    package's fallback; here only a plain version for the tests)."""
    lo, hi = verts.min(0), verts.max(0)
    res = max(4, int((target_faces / 2) ** (1 / 3) * 1.5))
    cell = np.clip(((verts - lo) / (hi - lo + 1e-9) * res).astype(np.int64),
                   0, res - 1)
    key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    new_v = np.zeros((len(uniq), 3), np.float64)
    cnt = np.zeros(len(uniq), np.int64)
    np.add.at(new_v, inv, verts)
    np.add.at(cnt, inv, 1)
    new_v = (new_v / cnt[:, None]).astype(verts.dtype)
    f = inv[faces]
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    return new_v, f[keep]


def decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """(V,3),(F,3) -> simplified mesh with ~target_faces faces."""
    if target_faces >= len(faces):
        return verts, faces
    from relightableavatar_tpu_torch.ops.native import decimate_native
    v, f = decimate_native(verts, faces, target_faces)
    return v, f.astype(faces.dtype)
