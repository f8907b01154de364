"""Relit frames of novel poses and views: a sequence of ``len(poses)``
frames, frame j of fixture motion pose ``poses[j]`` seen from azimuth
360 (j + 0.5) / len(poses) degrees on the camera ring of ``make_cameras``
(``radius`` m from ``center``, 5 % above it, focal 0.9 x the size), each
azimuth moved by a draw of the seed within +-``jitter_deg``; the window
renders the sequence over and over in an order drawn from the seed.  Every
seed renders the same views to within the jitter (the frames' cost varies
about twofold from view to view), so the seed changes the inputs and the
order, not the work.  The rays of a frame are its pixels whose ray meets
the posed body's box (``get_full_near_far``), handed alike to the port and
to the reference."""
from __future__ import annotations

import os

import numpy as np

from portbench.reference.net import Body, bounds


def camera_rays(size: int, az: float, radius: float, center) -> tuple:
    """ray_o, ray_d (size * size, 3) of the ring camera at azimuth ``az``."""
    center = np.asarray(center, np.float64)
    pos = center + radius * np.array([np.cos(az), np.sin(az), 0.05])
    z = (center - pos) / np.linalg.norm(center - pos)
    x = np.cross(z, [0, 0, 1.0])
    x /= np.linalg.norm(x)
    Rw2c = np.stack([x, np.cross(z, x), z]).astype(np.float32)
    T = (-Rw2c @ pos)[:, None].astype(np.float32)
    f = 0.9 * size
    K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    i, j = np.meshgrid(np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32),
                       indexing='ij')
    xy1 = np.stack([j, i, np.ones_like(i)], axis=2)
    world = np.dot(np.dot(xy1, np.linalg.inv(K).T) - T.ravel(), Rw2c)
    ray_o = -np.dot(Rw2c.T, T).ravel()
    ray_d = world - ray_o[None, None]
    ray_d /= np.linalg.norm(ray_d, axis=2, keepdims=True)
    return (np.broadcast_to(ray_o, ray_d.shape).reshape(-1, 3).astype(np.float32),
            ray_d.reshape(-1, 3).astype(np.float32))


def box_near_far(box: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """near, far and the rays that meet the box (``get_full_near_far``)."""
    v = ray_d.copy()
    v[(v < 1e-5) & (v > -1e-10)] = 1e-5
    v[(v > -1e-5) & (v < 1e-10)] = -1e-5
    tmin, tmax = (box[:1] - ray_o) / v, (box[1:2] - ray_o) / v
    near = np.max(np.minimum(tmin, tmax), axis=-1)
    far = np.min(np.maximum(tmin, tmax), axis=-1)
    return near.astype(np.float32), far.astype(np.float32), near < far


class Traffic:
    def __init__(self, params: dict, seed: int, root: str):
        self.p = params
        self.seed = int(seed)
        with np.load(os.path.join(root, "fixtures", "synthetic_motion.npz")) as m:
            self.motion = {k: m[k] for k in m.files}
        self.body = Body(os.path.join(root, "fixtures", "synthetic_body.npz"))
        self.poses = [int(p) for p in params["poses"]]
        n = len(self.poses)
        rng = np.random.default_rng([self.seed])
        jitter = np.deg2rad(float(params["jitter_deg"])) * rng.uniform(-1, 1, n)
        self.azimuths = [2 * np.pi * (j + 0.5) / n + jitter[j] for j in range(n)]
        self.order = [int(x) for x in rng.permutation(n)]

    def frame(self, j: int) -> dict:
        """Frame j of the set: its pose and its rays in the body's box."""
        p, m = self.p, self.motion
        pose = self.poses[j]
        wverts = self.body.verts(m["poses"][pose], m["shapes"][pose], Rh=m["Rh"][pose],
                                 Th=m["Th"][pose])
        ray_o, ray_d = camera_rays(int(p["size"]), self.azimuths[j], float(p["radius"]),
                                   p["center"])
        near, far, mab = box_near_far(bounds(wverts), ray_o, ray_d)
        return dict(pose=pose, ray_o=ray_o[mab], ray_d=ray_d[mab], near=near[mab],
                    far=far[mab], n_pixels=int(mab.sum()))
