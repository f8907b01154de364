"""The mesh extraction on one device held against the same extraction on
another, shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``: the
card's mesh against the CPU's at a coarse voxel.

Both run tubeman's config from the working directory of the repo (the
configs name their parents relative to it) with float32 MLPs and the exact
KNN.  Their SDFs differ by the order of the MLPs' float32 sums (cuBLAS
against the CPU's), as the port's and the JAX package's do, so the bars are
``tests/test_torch_mesh.py``'s: equal faces, vertices within 1e-4 m,
skinning weights and materials within 2e-5.  The skinning transfer keeps
each vertex's 3 nearest reference vertices, so where the 3rd and 4th are
nearly tied a 1e-6 m vertex shift swaps them and moves that vertex's
weights (by 0.027 at 2.5 cm on an H100): the weights are held on the
vertices whose top-3 sets agree, and at most 1 % may differ.
"""
from __future__ import annotations

import numpy as np
import torch

from relightableavatar_tpu_torch.config import setup
from relightableavatar_tpu_torch.data.datasets import make_dataset
from relightableavatar_tpu_torch.models.factory import make_network, make_renderer
from relightableavatar_tpu_torch.ops.knn import knn
from relightableavatar_tpu_torch.renderer.mesh import reference_cloud

TUBEMAN = "configs/synthetic/tubeman.yaml"
CHECK_VOXEL = 0.025     # m: 79,730 grid points over tubeman's bigpose box
VERT_ATOL = 1e-4        # m
ATTR_ATOL = 2e-5        # skinning weights, albedo, roughness
TIE_SHARE = 0.01        # vertices whose top-3 reference sets may differ
EXACT = ["tpu.bf16_mlp", "False", "tpu.knn_impl", "pallas"]


def mesh_cfg(data_root: str, model_dir: str, mode: str = "vis_can_mesh",
             voxel: float = CHECK_VOXEL, opts=()):
    """``run -t visualize <mode> True`` config of tubeman on ``data_root``
    with checkpoints under ``model_dir`` (``deform/tubeman`` for stage 1,
    ``relight/tubeman_relight`` with ``relighting True``)."""
    cfg, _ = setup(["-t", "visualize", "-c", TUBEMAN, mode, "True",
                    "test_dataset.data_root", data_root, "train_dataset.data_root", data_root,
                    "trained_model_dir", model_dir, "voxel_size", f"[{voxel},{voxel},{voxel}]",
                    *EXACT, *opts])
    return cfg


def extract(cfg, item: int, device):
    """(mesh, the renderer's ``last_mesh`` stats, the reference vertex cloud
    as numpy) of dataset item ``item`` (-1: the canonical item) on
    ``device``."""
    params, mcfg = make_network(cfg, device=device)
    renderer = make_renderer(cfg, params, mcfg, device=device)
    batch = make_dataset(cfg, is_train=False, device=device)[item]
    out = renderer.render(batch)
    return out, renderer.last_mesh, reference_cloud(batch.ctx,
                                                    cfg.vis_can_mesh or cfg.vis_tpose_mesh)


def same_top3(verts_a: np.ndarray, verts_b: np.ndarray, cloud: np.ndarray) -> np.ndarray:
    """(V,) bool: vertices whose 3 nearest cloud vertices are the same set in
    both meshes (exact KNN on the CPU)."""
    c = torch.as_tensor(cloud)
    a = knn(torch.as_tensor(verts_a, dtype=torch.float32), c, K=3)[1].sort(1).values
    b = knn(torch.as_tensor(verts_b, dtype=torch.float32), c, K=3)[1].sort(1).values
    return (a == b).all(1).numpy()


def compare(ours, ref, cloud: np.ndarray) -> dict:
    """Face counts, whether the face arrays are equal, the largest vertex
    difference and the largest difference of each per-vertex attribute both
    have (the weights on the vertices whose top-3 sets agree), and the
    share of vertices whose sets differ."""
    ret = dict(faces=(len(ours.faces), len(ref.faces)),
               faces_equal=bool(np.array_equal(ours.faces, ref.faces)))
    if ours.verts.shape == ref.verts.shape:
        ret["verts"] = float(np.abs(ours.verts - ref.verts).max(initial=0.0))
        same = same_top3(ours.verts, ref.verts, cloud)
        ret["top3_differ"] = float(1.0 - same.mean()) if len(same) else 0.0
        for k in ("weights", "albedo", "roughness"):
            if ours.get(k) is not None and ref.get(k) is not None:
                rows = same if k == "weights" else slice(None)
                ret[k] = float(np.abs(ours[k][rows] - ref[k][rows]).max(initial=0.0))
    return ret


def agrees(diff: dict) -> bool:
    """Equal faces, vertices and attributes within the bars, top-3 sets
    differing on at most ``TIE_SHARE`` of the vertices."""
    return (diff["faces_equal"] and diff.get("verts", np.inf) <= VERT_ATOL
            and diff["top3_differ"] <= TIE_SHARE
            and all(diff[k] <= ATTR_ATOL for k in ("weights", "albedo", "roughness")
                    if k in diff))
