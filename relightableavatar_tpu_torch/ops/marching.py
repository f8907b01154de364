"""Marching tetrahedra: isosurface extraction from a dense SDF grid; a copy
of ``relightableavatar_tpu/ops/marching.py`` for the port (numpy and the host
C++ library, no device work).

Replaces the reference's PyMCubes C++ marching cubes
(``lib/networks/renderer/mesh_renderer.py:80``).  Marching tetrahedra splits
each cube into 6 tetrahedra; per tet only three non-trivial sign cases exist
(1, 2 or 3 corners inside), handled generically by sorting each tet's corners
by inside-ness — no 256-entry tables.  Produces a watertight triangle mesh
with vertices on linearly interpolated zero crossings, deduplicated by global
grid-edge id.  :func:`marching_tets` runs the C++ version
(``csrc/marching.cpp`` through ``ops/native.py``, which raises when it does
not build); :func:`_marching_tets_numpy` is its plain version for the tests.
"""
from __future__ import annotations

import numpy as np

# 6 tetrahedra per cube (corner ids 0..7; corner i has coords _CORNERS[i])
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
], np.int64)

_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int64)


def _edge_points(ga, gb, fa, fb, Y, Z):
    """Interpolated zero crossings on edges (ga, gb) with values (fa, fb).
    Returns (points (N, 3) float64, keys (N,) int64)."""
    t = fa / (fa - fb + 1e-12)
    pa = np.stack([ga // (Y * Z), (ga // Z) % Y, ga % Z], -1).astype(np.float64)
    pb = np.stack([gb // (Y * Z), (gb // Z) % Y, gb % Z], -1).astype(np.float64)
    p = pa + t[..., None] * (pb - pa)
    lo = np.minimum(ga, gb).astype(np.int64)
    hi = np.maximum(ga, gb).astype(np.int64)
    return p, lo * np.int64(1 << 32) + hi


def _trilerp_gradient(field: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Analytic gradient of the trilinear interpolant of ``field`` at grid
    coordinates ``p`` (N, 3). Exact for the interpolant; vectorized."""
    X, Y, Z = field.shape
    p = np.clip(p, 0.0, np.asarray([X, Y, Z], np.float64) - 1.000001)
    i0 = p.astype(np.int64)
    u = (p - i0).astype(np.float64)
    # 8 corner values c[di, dj, dk] -> (N, 2, 2, 2)
    ii = i0[:, 0, None, None, None] + np.arange(2)[None, :, None, None]
    jj = i0[:, 1, None, None, None] + np.arange(2)[None, None, :, None]
    kk = i0[:, 2, None, None, None] + np.arange(2)[None, None, None, :]
    c = field[ii, jj, kk].astype(np.float64)
    wu = np.stack([1 - u[:, 0], u[:, 0]], -1)  # (N, 2)
    wv = np.stack([1 - u[:, 1], u[:, 1]], -1)
    ww = np.stack([1 - u[:, 2], u[:, 2]], -1)
    dx = np.einsum('njk,nj,nk->n', c[:, 1] - c[:, 0], wv, ww)
    dy = np.einsum('nik,ni,nk->n', c[:, :, 1] - c[:, :, 0], wu, ww)
    dz = np.einsum('nij,ni,nj->n', c[:, :, :, 1] - c[:, :, :, 0], wu, wv)
    return np.stack([dx, dy, dz], -1)


def orient_faces(verts: np.ndarray, faces: np.ndarray, field: np.ndarray,
                 origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Flip faces so every normal points toward INCREASING field values —
    outward for an SDF (inside = ``field < level``).

    Marching tetrahedra's generic sort-by-insideness case handling (below)
    loses the tet parity that encodes orientation, so raw face windings are
    arbitrary per-triangle.  Downstream consumers need consistent windings:
    the ``can_mesh.npz`` geometry prior derives vertex normals from them, and
    those normals provide the SIGN of the HDQ point-cloud signed distance
    (models/anisdf.py hdq_sdf; reference sample_utils.py:103-162) — scrambled
    windings make free space read as inside and break stage-2 training."""
    if len(faces) == 0:
        return faces
    grid = (verts.astype(np.float64) - np.asarray(origin)[None]) \
        / np.asarray(spacing)[None]
    cent = grid[faces].mean(1)
    g = _trilerp_gradient(field, cent)
    n = np.cross(grid[faces[:, 1]] - grid[faces[:, 0]],
                 grid[faces[:, 2]] - grid[faces[:, 0]])
    flip = np.sum(n * g, -1) < 0  # normal points downhill (inward) -> flip
    faces = faces.copy()
    faces[flip] = faces[flip][:, ::-1]
    return faces


def marching_tets(sdf: np.ndarray, level: float = 0.0,
                  origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
    """sdf (X, Y, Z) -> (verts (V, 3) float32, faces (F, 3) int64).

    Faces are consistently oriented: normals point toward increasing field
    (outward for an SDF, whose inside is ``field < level``).

    Runs the C++ version (``csrc/marching.cpp``); the numpy version below is
    its plain version, with the same vertex set in another order."""
    from relightableavatar_tpu_torch.ops.native import marching_tets_native
    verts, faces = marching_tets_native(sdf, level, origin, spacing)
    return verts, orient_faces(verts, faces, sdf, origin, spacing)


def _marching_tets_numpy(sdf: np.ndarray, level: float = 0.0,
                         origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
    X, Y, Z = sdf.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    f = (sdf - level).astype(np.float64).ravel()

    xs, ys, zs = np.meshgrid(np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1),
                             indexing='ij')
    base = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    cid = ((base[:, None, 0] + _CORNERS[None, :, 0]) * (Y * Z)
           + (base[:, None, 1] + _CORNERS[None, :, 1]) * Z
           + (base[:, None, 2] + _CORNERS[None, :, 2]))
    fvals = f[cid]
    keep = ~((fvals > 0).all(1) | (fvals < 0).all(1))
    cid, fvals = cid[keep], fvals[keep]
    if len(cid) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tg = cid[:, _TETS].reshape(-1, 4)        # (T, 4) global corner ids
    tf = fvals[:, _TETS].reshape(-1, 4)      # (T, 4) values
    inside = tf < 0
    cnt = inside.sum(1)

    pts_list, key_list, tri_sizes = [], [], []

    # sort corners so inside ones come first (stable)
    order = np.argsort(~inside, axis=1, kind='stable')
    sg = np.take_along_axis(tg, order, 1)
    sf = np.take_along_axis(tf, order, 1)

    # case: exactly 1 inside (corner s0), crossings on (s0,s1) (s0,s2) (s0,s3)
    for n_in in (1, 3):
        m = cnt == n_in
        if not m.any():
            continue
        g = sg[m]
        v = sf[m]
        if n_in == 1:
            ia, others = 0, (1, 2, 3)
        else:  # 3 inside = 1 outside at sorted position 3
            ia, others = 3, (0, 1, 2)
        for o in others:
            p, k = _edge_points(g[:, ia], g[:, o], v[:, ia], v[:, o], Y, Z)
            pts_list.append(p)
            key_list.append(k)
        tri_sizes.append((m.sum(), 1))

    # case: 2 inside (s0, s1), 2 outside (s2, s3): quad on edges
    # (s0,s2) (s0,s3) (s1,s3) (s1,s2) -> triangles (e0,e1,e2) and (e0,e2,e3)
    m = cnt == 2
    if m.any():
        g = sg[m]
        v = sf[m]
        quads = []
        for (a, b) in ((0, 2), (0, 3), (1, 3), (1, 2)):
            p, k = _edge_points(g[:, a], g[:, b], v[:, a], v[:, b], Y, Z)
            quads.append((p, k))
        # tri 1: e0 e1 e2
        for i in (0, 1, 2):
            pts_list.append(quads[i][0])
            key_list.append(quads[i][1])
        tri_sizes.append((m.sum(), 1))
        # tri 2: e0 e2 e3
        for i in (0, 2, 3):
            pts_list.append(quads[i][0])
            key_list.append(quads[i][1])
        tri_sizes.append((m.sum(), 1))

    if not pts_list:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # assemble faces: each group of 3 consecutive arrays is the 3 corners of
    # a triangle batch
    all_pts, all_keys, faces = [], [], []
    offset = 0
    for i in range(0, len(pts_list), 3):
        pa, pb, pc = pts_list[i:i + 3]
        ka, kb, kc = key_list[i:i + 3]
        n = len(pa)
        all_pts.extend([pa, pb, pc])
        all_keys.extend([ka, kb, kc])
        idx = np.arange(n)
        faces.append(np.stack([offset + idx, offset + n + idx,
                               offset + 2 * n + idx], -1))
        offset += 3 * n
    all_pts = np.concatenate(all_pts)
    all_keys = np.concatenate(all_keys)
    faces = np.concatenate(faces)

    uniq, inv = np.unique(all_keys, return_inverse=True)
    V = np.zeros((len(uniq), 3), np.float64)
    V[inv] = all_pts
    F = inv[faces.reshape(-1)].reshape(-1, 3)
    good = (F[:, 0] != F[:, 1]) & (F[:, 1] != F[:, 2]) & (F[:, 0] != F[:, 2])
    F = F[good]

    V = V * np.asarray(spacing)[None] + np.asarray(origin)[None]
    return V.astype(np.float32), F.astype(np.int64)


def largest_component(verts: np.ndarray, faces: np.ndarray):
    """Keep the largest connected face component (replaces trimesh's
    split+largest used at mesh_renderer.py:92-96); sparse-graph BFS."""
    if len(faces) == 0:
        return verts, faces
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    V = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(V, V))
    _, labels = connected_components(adj, directed=False)
    vals, counts = np.unique(labels[faces[:, 0]], return_counts=True)
    keep = vals[np.argmax(counts)]
    faces = faces[labels[faces[:, 0]] == keep]
    used = np.unique(faces)
    remap = np.full(V, -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]
