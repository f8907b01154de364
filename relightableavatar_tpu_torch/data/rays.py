"""Host-side ray generation and sampling (numpy): a copy of
``relightableavatar_tpu/data/rays.py`` for the port (reference
``lib/utils/data_utils.py:812-1001``): pixel-grid camera rays, AABB
near/far with the same epsilon clamps, train-time body/face/edge/random ray
sampling, and bounded full-image rays for rendering.  The silhouette band
of :func:`edge_band_coords` is dilated and eroded in numpy, as OpenCV's
``dilate``/``erode`` do it with a square kernel.
"""
from __future__ import annotations

import numpy as np


def get_rays(H: int, W: int, K: np.ndarray, R: np.ndarray, T: np.ndarray,
             subpixel: bool = False, rng: np.random.Generator | None = None):
    """Returns ray_o, ray_d (H, W, 3); w2c convention x_cam = R x_world + T."""
    ray_o = -np.dot(R.T, T).ravel()
    i, j = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing='ij')
    xy1 = np.stack([j, i, np.ones_like(i)], axis=2)
    if subpixel:
        rng = rng or np.random.default_rng()
        xy1[:, :, :2] += rng.random((H, W, 2)) - 0.5
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


def get_near_far(bounds, ray_o, ray_d):
    near, far, mask_at_box = get_full_near_far(bounds, ray_o, ray_d)
    return near[mask_at_box], far[mask_at_box], mask_at_box


def _morph(m: np.ndarray, k: int, op, pad_value: int) -> np.ndarray:
    """OpenCV's dilate (``op`` max, outside pixels 0) or erode (``op`` min,
    outside pixels 1) of a 0/1 image with a k x k kernel anchored at k // 2."""
    a = k // 2
    p = np.pad(m, ((a, k - 1 - a), (a, k - 1 - a)), constant_values=pad_value)
    H, W = m.shape
    out = p[:H, :W].copy()
    for dy in range(k):
        for dx in range(k):
            out = op(out, p[dy:dy + H, dx:dx + W])
    return out


def edge_band_coords(msk, mask_at_box, band_px: int = 5):
    """Pixel coords of the silhouette band: within ``band_px`` of the
    foreground-mask boundary (dilate XOR erode), inside the ray AABB
    (the ``edge_sample_ratio`` pool of the train-time sampler)."""
    m = (msk > 0).astype(np.uint8)
    band = (_morph(m, band_px, np.maximum, 0).astype(bool)
            ^ _morph(m, band_px, np.minimum, 1).astype(bool))
    return np.argwhere(band & (mask_at_box > 0))


def sample_ray(img, msk, K, R, T, bounds, nrays, split='train',
               subpixel=False, body_ratio=0.5, face_ratio=0.0,
               rng: np.random.Generator | None = None,
               edge_ratio=0.0, edge_band_px=5):
    """Ray sampling (reference data_utils.py:892-922): on a train split,
    body / face / random-in-box ratios plus the silhouette-band pool
    (``edge_ratio``); otherwise every ray in the box, in pixel order."""
    rng = rng or np.random.default_rng()
    H, W = img.shape[:2]
    ray_o, ray_d = get_rays(H, W, K, R, T, subpixel, rng)
    near, far, mask_at_box = get_full_near_far(bounds, ray_o, ray_d)
    msk = msk * mask_at_box
    if "train" in split:
        n_body = int(nrays * body_ratio)
        n_face = int(nrays * face_ratio)
        n_edge = int(nrays * edge_ratio)
        n_rand = nrays - n_body - n_face - n_edge
        coord_body = np.argwhere(msk == 1)
        coord_face = np.argwhere(msk == 13)
        coord_rand = np.argwhere(mask_at_box == 1)
        if len(coord_body) == 0:
            coord_body = coord_rand
        if len(coord_face) == 0:
            coord_face = coord_body
        coord_body = coord_body[rng.integers(len(coord_body), size=n_body)]
        coord_face = coord_face[rng.integers(len(coord_face), size=n_face)]
        if n_edge > 0:
            coord_edge = edge_band_coords(msk, mask_at_box, edge_band_px)
            if len(coord_edge) == 0:
                coord_edge = coord_rand
            coord_edge = coord_edge[rng.integers(len(coord_edge),
                                                 size=n_edge)]
        else:
            coord_edge = np.zeros((0, 2), np.int64)
        coord_rand = coord_rand[rng.integers(len(coord_rand), size=n_rand)]
        coord = np.concatenate([coord_body, coord_face, coord_edge,
                                coord_rand], axis=0)
        mask_at_box = mask_at_box[coord[:, 0], coord[:, 1]]
    else:
        coord = np.argwhere(mask_at_box == 1)
    ray_o = ray_o[coord[:, 0], coord[:, 1]].astype(np.float32)
    ray_d = ray_d[coord[:, 0], coord[:, 1]].astype(np.float32)
    near = near[coord[:, 0], coord[:, 1]].astype(np.float32)
    far = far[coord[:, 0], coord[:, 1]].astype(np.float32)
    rgb = img[coord[:, 0], coord[:, 1]].astype(np.float32)
    return rgb, ray_o, ray_d, near, far, coord, mask_at_box


def get_rays_within_bounds(H, W, K, R, T, bounds):
    """Test-time: all rays whose AABB test passes
    (reference data_utils.py:925-938)."""
    ray_o, ray_d = get_rays(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3).astype(np.float32)
    ray_d = ray_d.reshape(-1, 3).astype(np.float32)
    near, far, mask_at_box = get_near_far(bounds, ray_o.reshape(H, W, 3),
                                          ray_d.reshape(H, W, 3))
    mask = mask_at_box.reshape(-1)
    ray_o = ray_o[mask]
    ray_d = ray_d[mask]
    return (ray_o, ray_d, near.ravel().astype(np.float32),
            far.ravel().astype(np.float32), mask_at_box.reshape(H, W))
