"""Mesh extraction renderer (``relightableavatar_tpu/renderer/mesh.py``;
reference ``lib/networks/renderer/mesh_renderer.py:33-158``): canonical,
posed and T-pose marching-tetrahedra surfaces.  Its output is written as
``can_mesh.npz``, the stage-2 geometry prior (``use_geometry True
geometry_mesh ...``).

On the device: the voxel grid's band filter (the top-3 KNN's first column
against the reference vertex cloud, ``ops/knn.py:knn``), the SDF of the
band's points in chunks of ``network_chunk_size``, the filled cube, the
per-vertex albedo and roughness and the K = 3 skinning-weight transfer.  On
the host: marching tetrahedra and decimation (C++, ``ops/native.py``) and
the largest connected component (scipy).  Only the padded cube (about 12 M
floats for tubeman at 5 mm) and the mesh cross between the two.

Each call leaves its sizes and stage seconds in ``last_mesh``: the device
stages end in a synchronisation, the host stages are host clock.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from relightableavatar_tpu_torch.device import resolve_device
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.knn import knn
from relightableavatar_tpu_torch.ops.marching import largest_component, marching_tets
from relightableavatar_tpu_torch.ops.meshtools import decimate
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.log import log

PAD = 10            # voxels of free space around the cube (mesh_renderer.py:77)
FREE = -10.0        # the cube's value outside the band: occupancy-signed, free


def alpha2sdf(alpha, beta, dists=0.005):
    return beta * np.log(2 * beta * (-np.log(1 - alpha) / dists))


def reference_cloud(ctx, canonical: bool) -> np.ndarray:
    """The vertex cloud the band filter and the skinning transfer measure
    against: the bigpose vertices for a canonical or T-pose mesh, the posed
    ones in world space for a posed mesh (float32 numpy)."""
    if canonical:
        return np.ascontiguousarray(ctx['tverts'].cpu().numpy(), np.float32)
    R = ctx['R'].cpu().numpy()
    Th = ctx['Th'].cpu().numpy().reshape(1, 3)
    return np.ascontiguousarray(ctx['pverts'].cpu().numpy() @ R.T + Th, np.float32)


class MeshRenderer:
    def __init__(self, cfg, params, mcfg: AniSDFConfig, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.mcfg = mcfg
        self.device = resolve_device(device)
        self.last_mesh = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _chunked(fn, pts: torch.Tensor, chunk: int) -> torch.Tensor:
        return torch.cat([fn(pts[i:i + chunk])
                          for i in range(0, max(pts.shape[0], 1), chunk)])

    def _sdf_fn(self, batch, ctx, cond):
        """The occupancy-signed SDF (-sdf) of the mode and item."""
        cfg, params, mcfg = self.cfg, self.params, self.mcfg
        if cfg.vis_can_mesh or (cfg.vis_tpose_mesh
                                and int(batch.meta.get('latent_index', 0)) == -1):
            return lambda x: -anisdf.sdf_feat(params, mcfg, x)[0][..., 0]
        if cfg.vis_posed_mesh:
            return lambda x: -anisdf.hdq_sdf(params, mcfg, ctx, x)[..., 0]

        def tpose_sdf(x):   # T-pose mesh with pose-conditioned residuals
            c = cond[None].expand(x.shape[0], cond.shape[0])
            resd = anisdf.residuals(params, mcfg, x, c)
            return -anisdf.sdf_feat(params, mcfg, x + resd)[0][..., 0]
        return tpose_sdf

    def _material_fn(self, ctx, cond, canonical: bool):
        params, mcfg = self.params, self.mcfg

        def material(x):
            if canonical:
                _, feat = anisdf.sdf_feat(params, mcfg, x)
            else:
                out = anisdf.world_to_bigpose(mcfg, ctx, x)
                c = cond[None].expand(x.shape[0], cond.shape[0])
                resd = anisdf.residuals(params, mcfg, out.bpts, c)
                _, feat = anisdf.sdf_feat(params, mcfg, out.bpts + resd)
            return torch.cat([anisdf.albedo_head(params, mcfg, feat),
                              anisdf.roughness_head(params, mcfg, feat)], -1)
        return material

    @torch.no_grad()
    def render(self, batch: dotdict) -> dotdict:
        cfg, mcfg, dev = self.cfg, self.mcfg, self.device
        ctx = batch.ctx
        stats = dotdict()
        t0 = time.perf_counter()
        pts = np.asarray(batch.pts, np.float32)
        shape = pts.shape[:3]
        flat = torch.as_tensor(pts.reshape(-1, 3), device=dev)

        canonical = cfg.vis_can_mesh or cfg.vis_tpose_mesh
        verts_ref = torch.as_tensor(reference_cloud(ctx, canonical), device=dev)

        log('filtering')
        d2, _ = knn(flat, verts_ref, K=1)
        inside = torch.sqrt(d2[:, 0]) < cfg.dist_th
        sel = flat[inside]
        stats.grid_points, stats.band_points = flat.shape[0], sel.shape[0]
        self._sync()
        t1 = time.perf_counter()
        stats.filter_s = t1 - t0

        cond = anisdf.condition_vector(ctx)
        log('inferencing')
        occ = self._chunked(self._sdf_fn(batch, ctx, cond), sel, cfg.network_chunk_size)
        cube = torch.full((flat.shape[0],), FREE, dtype=torch.float32, device=dev)
        cube[inside] = occ
        cube = F.pad(cube.reshape(shape), (PAD,) * 6, value=FREE)
        self._sync()
        t2 = time.perf_counter()
        stats.sdf_s = t2 - t1
        cube = cube.cpu().numpy()
        stats.cube_d2h_s = time.perf_counter() - t2

        if cfg.mesh_th_to_sdf:
            beta = float(anisdf.beta_of(self.params))
            mesh_th = float(alpha2sdf(cfg.mesh_th, beta))
        else:
            mesh_th = cfg.mesh_th

        log('marching tetrahedra')
        t3 = time.perf_counter()
        vs = np.asarray(batch.voxel_size, np.float32)
        bounds = np.asarray(batch.bounds, np.float32)
        # cube is inside-POSITIVE (occupancy-signed: the SDF negated, free
        # space filled with FREE); negate so marching_tets' SDF convention
        # (inside < level) orients face windings outward: the geometry prior
        # derives HDQ's sign from the resulting vertex normals
        verts, faces = marching_tets(-cube, -mesh_th)
        verts = (verts - PAD) * vs[0] + bounds[0]
        t4 = time.perf_counter()
        stats.marching_s = t4 - t3
        stats.marched_faces = len(faces)
        verts, faces = largest_component(verts, faces)
        t5 = time.perf_counter()
        stats.component_s = t5 - t4
        stats.decimate_s = 0.0
        if cfg.mesh_simp_face > 0 and len(faces) > cfg.mesh_simp_face:
            # QEM simplification (reference mesh_renderer.py:95-96)
            log(f'simplifying mesh {len(faces)} -> {cfg.mesh_simp_face} faces')
            verts, faces = decimate(verts, faces, int(cfg.mesh_simp_face))
            stats.decimate_s = time.perf_counter() - t5

        ret = dotdict()
        ret.verts = verts
        ret.faces = faces.astype(np.int32)
        verts_t = torch.as_tensor(np.ascontiguousarray(verts, np.float32), device=dev)

        t6 = time.perf_counter()
        if 'albedo' in self.params:
            log('extracting albedo and roughness')
            mat = self._chunked(self._material_fn(ctx, cond, canonical), verts_t,
                                cfg.network_chunk_size).cpu().numpy()
            ret.albedo = mat[:, :3]
            ret.roughness = mat[:, 3:]
        t7 = time.perf_counter()
        stats.material_s = t7 - t6

        log('extracting blend weights')
        d2, nn = knn(verts_t, verts_ref, K=mcfg.sample_vert_cnt)
        d2 = d2.cpu().numpy()
        nn = nn.cpu().numpy()
        w = np.exp(-d2 / (2 * mcfg.blend_radius ** 2))
        w /= w.sum(-1, keepdims=True) + 1e-12
        W = ctx['weights'].cpu().numpy()
        ret.weights = (w[..., None] * W[nn]).sum(-2).astype(np.float32)
        stats.weights_s = time.perf_counter() - t7

        ret.tjoints = batch.get('tjoints', None)
        ret.parents = batch.get('parents', None)
        stats.verts, stats.faces = len(verts), len(faces)
        self.last_mesh = stats
        log(f'statistics: verts: {len(verts)}, faces: {len(faces)}')
        log('mesh: ' + ', '.join(f'{k} {v:.4f}' if isinstance(v, float) else f'{k} {v}'
                                 for k, v in stats.items()))
        return ret
