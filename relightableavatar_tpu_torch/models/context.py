"""Per-frame pose/skinning context (``relightableavatar_tpu/models/context.py``).

Built on the host in numpy (SMPL-H forward, vertex normals, bounds), then
moved to ``device`` as a dict of tensors that every render function takes.
The fused ``knn_table = [pverts | pnorm | tverts | weights]`` (6890, 9 + J)
lets the HDQ gather all neighbour attributes in one indexing op.  The
grouped KNN's arrays (``knn_gvid``, ``knn_gverts``, ``knn_gcent``,
``knn_gradius``: a balanced k-d partition of the posed vertices) and the
shadow rays' vertex subsample ``knn_sub_ids`` are built with them, as the
JAX package builds them (``relightableavatar_tpu/models/context.py:39-58``).
"""
from __future__ import annotations

import numpy as np
import torch

from relightableavatar_tpu_torch.device import resolve_device
from relightableavatar_tpu_torch.ops.knn import (build_vertex_groups, group_frame_arrays,
                                                 subsample_verts)
from relightableavatar_tpu_torch.smpl.body_model import (
    BodyModel, batch_rodrigues, get_bounds, get_rigid_transform, vertex_normals)


def _assemble_context(wverts: np.ndarray, pverts: np.ndarray, tverts: np.ndarray,
                      W: np.ndarray, faces: np.ndarray, R: np.ndarray,
                      Th: np.ndarray, poses: np.ndarray, A: np.ndarray,
                      big_A: np.ndarray, device="cuda") -> dict:
    """Context assembly from posed/canonical vertex clouds (numpy in, tensors
    on ``device`` out)."""
    dev = resolve_device(device)
    pverts = pverts.astype(np.float32)
    tverts = tverts.astype(np.float32)
    pnorm = vertex_normals(pverts, faces)
    tnorm = vertex_normals(tverts, faces)
    # tpu.knn_impl='grouped': k-d leaves of the posed vertices (partitioned
    # in query space, so the leaves stay compact); tpu.shadow_verts_sub:
    # every 4th member of each leaf, as global ids
    gvid, gmask = build_vertex_groups(pverts)
    gverts, gcent, gradius = group_frame_arrays(pverts, gvid, gmask)
    arrays = {
        "knn_gvid": gvid,
        "knn_gverts": gverts,
        "knn_gcent": gcent,
        "knn_gradius": gradius,
        "knn_sub_ids": subsample_verts(gvid, gmask, 4),
        "knn_table": np.concatenate(
            [pverts, pnorm.astype(np.float32), tverts, W.astype(np.float32)],
            axis=-1),
        "R": R,
        "Th": Th,
        "poses": poses,
        "A": A,
        "big_A": big_A,
        "weights": W.astype(np.float32),
        "pverts": pverts,
        "pnorm": pnorm,
        "tverts": tverts,
        "tnorm": tnorm,
        "faces": faces.astype(np.int32),
        "wbounds": get_bounds(wverts.astype(np.float32)),
        "tbounds": get_bounds(tverts),
        "pbounds": get_bounds(pverts),
    }
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in arrays.items()}


def make_frame_context(model: BodyModel, tverts: np.ndarray, tjoints: np.ndarray,
                       big_A: np.ndarray, poses: np.ndarray, Rh: np.ndarray,
                       Th: np.ndarray, shapes: np.ndarray | None = None,
                       device="cuda") -> dict:
    """Context for one motion frame.  tverts/tjoints: canonical (bigpose)
    vertices/joints; big_A: bigpose bone transforms; poses (J, 3)
    axis-angle; Rh/Th global rigid."""
    poses = np.asarray(poses, np.float32).reshape(-1, 3)
    A, _ = get_rigid_transform(poses, tjoints, model.parents)
    R = batch_rodrigues(np.asarray(Rh, np.float32).reshape(1, 3))[0]
    Th = np.asarray(Th, np.float32).reshape(1, 3)

    # posed verts from the body model forward (reference base_dataset.py:330-333)
    wverts = model.forward(poses, shapes=shapes, Rh=Rh, Th=Th)
    pverts = (wverts - Th) @ R  # world -> pose (remove global rigid)

    return _assemble_context(wverts, pverts, tverts, model.weights, model.faces,
                             R, Th, poses, A, big_A, device=device)


def make_frame_context_mesh(prior: dict, poses: np.ndarray, Rh: np.ndarray,
                            Th: np.ndarray, device="cuda") -> dict:
    """Context from a ``can_mesh.npz`` geometry prior (the stage-2
    ``use_geometry`` path, reference ``base_dataset.py:196-204,324-329``):
    the prior's verts (bigpose canonical space), transferred skinning
    weights, faces, tjoints and parents replace the SMPL body model, and the
    posed verts come from LBS (:func:`lbs_bigpose_to_pose`), then the global
    rigid."""
    tverts = np.asarray(prior['verts'], np.float32)
    W = np.asarray(prior['weights'], np.float32)
    faces = np.asarray(prior['faces'], np.int64)
    tjoints = np.asarray(prior['tjoints'], np.float32)
    parents = np.asarray(prior['parents'], np.int64)

    poses = np.asarray(poses, np.float32).reshape(-1, 3)
    big_A, _ = bigpose_A(tjoints, parents)
    A, _ = get_rigid_transform(poses, tjoints, parents)
    R = batch_rodrigues(np.asarray(Rh, np.float32).reshape(1, 3))[0]
    Th = np.asarray(Th, np.float32).reshape(1, 3)

    pverts = lbs_bigpose_to_pose(tverts, W, big_A, A)
    wverts = pverts @ R.T + Th
    return _assemble_context(wverts, pverts, tverts, W, faces, R, Th,
                             poses, A, big_A, device=device)


def lbs_bigpose_to_pose(tverts: np.ndarray, W: np.ndarray, big_A: np.ndarray,
                        A: np.ndarray) -> np.ndarray:
    """Host-side LBS re-posing of a canonical (bigpose) vertex cloud: back to
    the T-pose through the weight-blended inverse ``big_A``, then to the
    pose through the blended ``A`` (reference ``blend_utils.py:234-333``)."""
    Abw_big = np.einsum('vj,jab->vab', W, big_A)
    txyz = np.einsum('vab,vb->va',
                     np.linalg.inv(Abw_big[:, :3, :3]),
                     tverts - Abw_big[:, :3, 3])
    Abw = np.einsum('vj,jab->vab', W, A)
    pverts = np.einsum('vab,vb->va', Abw[:, :3, :3], txyz) + Abw[:, :3, 3]
    return pverts.astype(np.float32)


def bigpose_vector(n_bones: int) -> np.ndarray:
    """Canonical big-pose axis-angles: 30 deg leg spread
    (reference base_dataset.py:222-228)."""
    big_poses = np.zeros(n_bones * 3, np.float32)
    angle = 30
    big_poses[5] = np.deg2rad(angle)
    big_poses[8] = np.deg2rad(-angle)
    return big_poses.reshape(-1, 3)


def bigpose_A(tjoints: np.ndarray, parents: np.ndarray):
    """Bigpose bone transforms from canonical joints (base_dataset.py:222-236)."""
    return get_rigid_transform(bigpose_vector(len(tjoints)), tjoints, parents)


def make_bigpose(model: BodyModel, shapes: np.ndarray | None = None):
    """Canonical big-pose prep (reference base_dataset.py:222-241); returns
    (tverts, tjoints, big_A, big_joints)."""
    tjoints = model.joints(shapes)
    big_A, big_joints = bigpose_A(tjoints, model.parents)
    tverts = model.forward(bigpose_vector(model.n_bones), shapes=shapes)
    return tverts.astype(np.float32), tjoints.astype(np.float32), big_A, big_joints
