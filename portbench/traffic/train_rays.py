"""Training batches aimed at the body: frame i of a run draws, from
``numpy.random.default_rng([seed, i])``, one of the fixture motion's poses,
a camera azimuth on a ring of ``radius`` around the body's centre lifted
``lift`` m, ``rays`` targets N(0, ``target_std``) m around that centre and
their target colours (uniform), with full masks and near / far fixed (the
layout of ``eval/train_check.make_step``).  Batch k is frames
[k B, (k + 1) B).  Every batch has the same sizes, so the seed changes
what a step computes and not how much."""
from __future__ import annotations

import os

import numpy as np


class Traffic:
    def __init__(self, params: dict, seed: int, root: str):
        self.p = params
        self.seed = int(seed)
        with np.load(os.path.join(root, "fixtures", "synthetic_motion.npz")) as m:
            self.motion = {k: m[k] for k in m.files}
        self.batch_size = int(params["batch"])
        self.rays = int(params["rays"])

    def frame(self, i: int) -> dict:
        """Frame i: its motion index ``pose`` and its rays (numpy float32)."""
        p, R = self.p, self.rays
        rng = np.random.default_rng([self.seed, int(i)])
        pose = int(rng.integers(len(self.motion["poses"])))
        az = rng.uniform(0.0, 2 * np.pi)
        center = self.motion["Th"][pose].reshape(3) + [0.0, 0.0, float(p["lift"])]
        o = center + float(p["radius"]) * np.array([np.cos(az), np.sin(az), 0.0])
        tgt = center + rng.normal(0.0, float(p["target_std"]), (R, 3))
        d = tgt - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
        return dict(pose=pose, ray_o=f32(np.tile(o, (R, 1))), ray_d=f32(d),
                    near=np.full(R, float(p["near"]), np.float32),
                    far=np.full(R, float(p["far"]), np.float32),
                    rgb=f32(rng.random((R, 3))), msk=np.ones(R, np.float32))

    def batch(self, k: int) -> list:
        B = self.batch_size
        return [self.frame(k * B + b) for b in range(B)]
