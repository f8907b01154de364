"""Synthetic camera rig (numpy): ``make_cameras`` of
``relightableavatar_tpu/smpl/synthetic.py``, copied for the port."""
from __future__ import annotations

import numpy as np


def make_cameras(n_views: int, H: int = 512, W: int = 512, radius: float = 3.0,
                 center=(0.0, 0.0, 0.9)):
    """Ring of cameras looking at the body center; returns the annots.npy
    cams dict layout: K, R, T, D lists (world-to-cam, T stored in mm as the
    reference's annots convention)."""
    Ks, Rs, Ts, Ds = [], [], [], []
    center = np.array(center, np.float32)
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        pos = center + radius * np.array([np.cos(a), np.sin(a), 0.05], np.float32)
        z = center - pos
        z = z / np.linalg.norm(z)
        up = np.array([0, 0, 1.0], np.float32)
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rw2c = np.stack([x, y, z])  # rows are camera axes
        T = (-Rw2c @ pos)[:, None] * 1000.0  # annots convention stores mm
        f = 0.9 * max(H, W)
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        Ks.append(K)
        Rs.append(Rw2c.astype(np.float32))
        Ts.append(T.astype(np.float32))
        Ds.append(np.zeros((5, 1), np.float32))
    return dict(K=Ks, R=Rs, T=Ts, D=Ds)
