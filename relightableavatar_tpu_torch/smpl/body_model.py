"""Host-side SMPL-H-style body model: standard LBS forward in numpy.

A copy of ``relightableavatar_tpu/smpl/body_model.py``; the port keeps its own.

Removes the reference's EasyMocap/smplx dependency
(``lib/datasets/base_dataset.py:207-218``, ``lib/config/config.py:437-441``)
with a self-contained implementation of the standard SMPL skinning model,
reading a plain ``.npz`` with keys::

    v_template (V, 3)   rest-pose vertices
    shapedirs  (V, 3, S) shape blendshapes (optional)
    posedirs   (V, 3, (J-1)*9) pose blendshapes (optional)
    J_regressor (J, V)  joint regressor
    weights    (V, J)   skinning weights
    parents    (J,)     kinematic tree (topological order, parents[0] == -1)
    faces      (F, 3)   triangles

Rigid-transform chain math mirrors the reference exactly
(``lib/utils/data_utils.py:1026-1070``).
"""
from __future__ import annotations

import numpy as np


def batch_rodrigues(poses: np.ndarray) -> np.ndarray:
    """poses (N, 3) axis-angle -> (N, 3, 3), reference data_utils.py:1004-1023."""
    angle = np.linalg.norm(poses + 1e-8, axis=1, keepdims=True)
    rot_dir = poses / angle
    cos = np.cos(angle)[:, None]
    sin = np.sin(angle)[:, None]
    rx, ry, rz = np.split(rot_dir, 3, axis=1)
    zeros = np.zeros([poses.shape[0], 1])
    K = np.concatenate([zeros, -rz, ry, rz, zeros, -rx, -ry, rx], axis=1)
    K = np.concatenate([K, zeros], axis=1).reshape([-1, 3, 3])
    ident = np.eye(3)[None]
    return (ident + sin * K + (1 - cos) * np.matmul(K, K)).astype(np.float32)


def get_rigid_transform(poses: np.ndarray, joints: np.ndarray, parents: np.ndarray):
    """poses (J, 3), joints (J, 3), parents (J,) -> (A (J, 4, 4), posed_joints (J, 3)).

    Forward kinematics then removal of the rest-pose joint translation, matching
    reference ``get_rigid_transformation_and_joints`` (data_utils.py:1026-1070)
    — note the reference returns (transforms, joints); we return (A, J) too via
    a tuple ordered (J, A) at the caller for parity with net_utils.
    """
    n_bones = len(joints)
    rot_mats = batch_rodrigues(poses.reshape(-1, 3))

    rel_joints = joints.copy()
    rel_joints[1:] -= joints[parents[1:]]

    transforms_mat = np.concatenate([rot_mats, rel_joints[..., None]], axis=2)
    padding = np.zeros([n_bones, 1, 4])
    padding[..., 3] = 1
    transforms_mat = np.concatenate([transforms_mat, padding], axis=1)

    chain = [transforms_mat[0]]
    for i in range(1, n_bones):
        chain.append(chain[parents[i]] @ transforms_mat[i])
    transforms = np.stack(chain, axis=0)

    # subtract the rotated rest joints so A maps rest-space points directly
    joints_h = np.concatenate([joints, np.zeros([n_bones, 1])], axis=1)
    rot_joints = np.einsum('jab,jb->ja', transforms, joints_h)
    transforms = transforms.copy()
    transforms[..., 3] = transforms[..., 3] - rot_joints

    # posed joints: apply the final transforms to the rest joints
    # (reference data_utils.py:1066-1067)
    posed_joints = transforms[:, :3, 3] + np.einsum(
        'jab,jb->ja', transforms[:, :3, :3], joints)

    return transforms.astype(np.float32), posed_joints.astype(np.float32)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals; replaces pytorch3d Meshes.verts_normals
    (reference base_dataset.py:378-387)."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    vn = np.zeros_like(verts)
    np.add.at(vn, faces[:, 0], fn)
    np.add.at(vn, faces[:, 1], fn)
    np.add.at(vn, faces[:, 2], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.clip(norm, 1e-12, None)).astype(np.float32)


class BodyModel:
    """Minimal SMPL-H forward: verts/joints from (poses, shapes, Rh, Th)."""

    def __init__(self, npz_path_or_dict):
        if isinstance(npz_path_or_dict, (str,)):
            data = dict(np.load(npz_path_or_dict, allow_pickle=False))
        else:
            data = dict(npz_path_or_dict)
        self.v_template = data['v_template'].astype(np.float32)
        self.J_regressor = data['J_regressor'].astype(np.float32)
        self.weights = data['weights'].astype(np.float32)
        self.parents = data['parents'].astype(np.int64)
        self.faces = data['faces'].astype(np.int64)
        self.shapedirs = data.get('shapedirs', None)
        self.posedirs = data.get('posedirs', None)
        if self.shapedirs is not None:
            self.shapedirs = self.shapedirs.astype(np.float32)
        if self.posedirs is not None:
            self.posedirs = self.posedirs.astype(np.float32)
        self.n_verts = self.v_template.shape[0]
        self.n_bones = self.weights.shape[1]

    # ------------------------------------------------------------------ core
    def shaped_verts(self, shapes: np.ndarray | None) -> np.ndarray:
        v = self.v_template
        if shapes is not None and self.shapedirs is not None and shapes.size:
            S = min(shapes.shape[-1], self.shapedirs.shape[-1])
            v = v + np.einsum('vds,s->vd', self.shapedirs[..., :S], shapes[..., :S].reshape(-1)[:S])
        return v

    def joints(self, shapes: np.ndarray | None = None) -> np.ndarray:
        return self.J_regressor @ self.shaped_verts(shapes)

    def forward(self, poses: np.ndarray, shapes: np.ndarray | None = None,
                Rh: np.ndarray | None = None, Th: np.ndarray | None = None,
                return_joints: bool = False):
        """poses (J*3,) or (J, 3) axis-angle; returns world verts (V, 3)."""
        poses = np.asarray(poses, np.float32).reshape(-1, 3)
        v = self.shaped_verts(shapes)
        J = self.J_regressor @ v

        if self.posedirs is not None:
            rot = batch_rodrigues(poses[1:])
            pose_feat = (rot - np.eye(3)[None]).reshape(-1)
            D = min(pose_feat.shape[0], self.posedirs.shape[-1])
            v = v + np.einsum('vdp,p->vd', self.posedirs[..., :D], pose_feat[:D])

        A, posed_J = get_rigid_transform(poses, J, self.parents)
        A_bw = np.einsum('vj,jab->vab', self.weights, A)
        verts = np.einsum('vab,vb->va', A_bw[:, :3, :3], v) + A_bw[:, :3, 3]

        if Rh is not None:
            R = batch_rodrigues(np.asarray(Rh, np.float32).reshape(1, 3))[0]
            verts = verts @ R.T
            posed_J = posed_J @ R.T
        if Th is not None:
            Th = np.asarray(Th, np.float32).reshape(1, 3)
            verts = verts + Th
            posed_J = posed_J + Th

        if return_joints:
            return verts.astype(np.float32), posed_J.astype(np.float32)
        return verts.astype(np.float32)


def get_bounds(xyz: np.ndarray, padding: float = 0.05) -> np.ndarray:
    """(V, 3) -> (2, 3) min/max with padding (reference data_utils get_bounds)."""
    mn = xyz.min(axis=0) - padding
    mx = xyz.max(axis=0) + padding
    return np.stack([mn, mx]).astype(np.float32)
