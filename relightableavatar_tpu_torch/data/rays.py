"""Host-side camera rays (numpy): ``get_rays`` and ``get_full_near_far`` of
``relightableavatar_tpu/data/rays.py``, copied for the port (reference
``lib/utils/data_utils.py:812-875``)."""
from __future__ import annotations

import numpy as np


def get_rays(H: int, W: int, K: np.ndarray, R: np.ndarray, T: np.ndarray):
    """Returns ray_o, ray_d (H, W, 3); w2c convention x_cam = R x_world + T."""
    ray_o = -np.dot(R.T, T).ravel()
    i, j = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing='ij')
    xy1 = np.stack([j, i, np.ones_like(i)], axis=2)
    pixel_camera = np.dot(xy1, np.linalg.inv(K).T)
    pixel_world = np.dot(pixel_camera - T.ravel(), R)
    ray_d = pixel_world - ray_o[None, None]
    ray_d = ray_d / np.linalg.norm(ray_d, axis=2, keepdims=True)
    ray_o = np.broadcast_to(ray_o, ray_d.shape)
    return ray_o.astype(np.float32), ray_d.astype(np.float32)


def get_full_near_far(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """bounds (2, 3); rays (..., 3).  Returns near, far, mask_at_box
    (reference data_utils.py:860-875 incl. its epsilon clamps and the
    norm_d division)."""
    norm_d = np.linalg.norm(ray_d, axis=-1, keepdims=True)
    viewdir = ray_d / norm_d
    viewdir = viewdir.copy()
    viewdir[(viewdir < 1e-5) & (viewdir > -1e-10)] = 1e-5
    viewdir[(viewdir > -1e-5) & (viewdir < 1e-10)] = -1e-5
    tmin = (bounds[:1] - ray_o) / viewdir
    tmax = (bounds[1:2] - ray_o) / viewdir
    t1 = np.minimum(tmin, tmax)
    t2 = np.maximum(tmin, tmax)
    near = np.max(t1, axis=-1)
    far = np.min(t2, axis=-1)
    mask_at_box = near < far
    near = near / norm_d[..., 0]
    far = far / norm_d[..., 0]
    return near.astype(np.float32), far.astype(np.float32), mask_at_box
