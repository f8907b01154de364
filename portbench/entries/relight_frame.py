"""The exact relit frame (``renderer/orchestrate.py:SphereTracingRenderer.render``)
under the learned environment map.

Set-up builds the renderer from the fixture avatar, the frame contexts of
the traffic's sequence and renders one frame to warm up.  The window
renders the sequence in the traffic's order, over and over, and keeps
every frame's maps; it closes at the end of a whole sequence
(``granule``), since the frames' cost varies about twofold from view to
view and a window cut inside a sequence would read as a change of speed.
Once it has closed, the reference (``reference/relight.py``) renders a
sample of the window's frames, drawn from the seed, on the same rays, and
each map is compared.  It also counts the FLOPs of what it renders, which
``frame_mfu`` reads (:meth:`Entry.unit_flops`).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench.reference import net as RN
from portbench.reference import relight as RR


class Entry:
    unit = "frame"

    def __init__(self, cell, seed: int, device, root: str, mesh_world: int = 1):
        self.cell, self.seed, self.device, self.root = cell, int(seed), torch.device(device), root
        self.cfg = cell.make_cfg()
        self.traffic = cell.generator().Traffic(cell.traffic, self.seed, root)
        self.frames = [self.traffic.frame(j) for j in range(len(self.traffic.order))]
        self.granule = len(self.frames)     # the window closes after whole sequences
        self.renderer = None
        self.rendered = []      # (frame index, maps) of every frame the program rendered
        self.ref_flops = {}     # set index -> FLOPs the float32 reference counted on it
        self.phases = {}
        self.it = 0

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
        from relightableavatar_tpu_torch.models.context import make_bigpose, make_frame_context
        from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
        from relightableavatar_tpu_torch.smpl.body_model import BodyModel
        from relightableavatar_tpu_torch.utils.dotdict import dotdict
        from relightableavatar_tpu_torch.weights import load_params

        cfg, dev = self.cfg, self.device
        fx = os.path.join(self.root, "fixtures")
        model = BodyModel(os.path.join(fx, "synthetic_body.npz"))
        m = self.traffic.motion
        mcfg = AniSDFConfig.from_cfg(cfg)
        params = load_params(os.path.join(fx, "synthetic_avatar_params.npz"), device=dev,
                             mcfg=mcfg)
        self.renderer = SphereTracingRenderer(cfg, params, mcfg, device=dev)
        self.batches = []
        for fr in self.frames:
            p = fr["pose"]
            tv, tj, bA, _ = make_bigpose(model, m["shapes"][p])
            ctx = make_frame_context(model, tv, tj, bA, m["poses"][p], m["Rh"][p], m["Th"][p],
                                     m["shapes"][p], device=dev)
            self.batches.append(dotdict(ray_o=fr["ray_o"], ray_d=fr["ray_d"], near=fr["near"],
                                        far=fr["far"], ctx=ctx))
        t = time.perf_counter()
        self.renderer.render(self.batches[self.traffic.order[0]])
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        self.phases["warm_frame"] = time.perf_counter() - t

    def run_one(self):
        """Render the set's next frame; keep its maps."""
        j = self.traffic.order[self.it % len(self.frames)]
        out = self.renderer.render(self.batches[j])
        self.rendered.append((j, {k: out[k] for k in RR.MAPS}))
        self.it += 1
        return out

    def release(self) -> None:
        self.renderer = self.batches = None

    # ------------------------------------------------------------ reference
    def check_sample(self) -> list:
        """Positions in the window's frames that the reference renders: a
        sample drawn from the seed, ``check_frames`` of them."""
        n = len(self.rendered)
        k = min(int(self.cell.traffic["check_frames"]), n)
        rng = np.random.default_rng([self.seed, 1])
        return sorted(int(i) for i in rng.choice(n, size=k, replace=False))

    def reference(self, precision: str = "float32", frames=None) -> dict:
        """The reference's maps of the frames ``frames`` (set indices; the
        sample of the window's frames by default), at ``precision``."""
        cfg, dev = self.cfg, self.device
        fx = os.path.join(self.root, "fixtures")
        body = RN.Body(os.path.join(fx, "synthetic_body.npz"))
        m = self.traffic.motion
        params = RN.load_params(os.path.join(fx, "synthetic_avatar_params.npz"), dev,
                                relight=True)
        frame = RR.Frame(cfg, params, RN.Net.from_cfg(cfg, precision), dev)
        if frames is None:
            frames = [self.rendered[i][0] for i in self.check_sample()]
        out = {}
        for j in frames:
            if j in out:
                continue
            fr = self.frames[j]
            p = fr["pose"]
            ctx = RN.frame_context(body, m["poses"][p], m["Rh"][p], m["Th"][p], m["shapes"][p],
                                   dev)
            t = lambda a: torch.as_tensor(a, device=dev)
            with RN.COUNT as count:
                out[j] = frame.render(ctx, t(fr["ray_o"]), t(fr["ray_d"]), t(fr["near"]),
                                      t(fr["far"]))
            if precision == "float32":
                self.ref_flops[j] = count.flops
        return out

    def unit_flops(self) -> float:
        """The FLOPs a frame of the window needs: the mean over the set of
        what the reference counts rendering each frame (``reference/net.py``,
        ``COUNT``), those frames the check did not render rendered for it.
        The window holds whole sequences, so each frame of the set is in it
        equally often.  Call it after :meth:`reference`."""
        rest = [j for j in range(len(self.frames)) if j not in self.ref_flops]
        if rest:
            self.reference(frames=rest)
        return sum(self.ref_flops[j] for j in range(len(self.frames))) / len(self.frames)

    def program_readings(self) -> list:
        """(set index, maps) of the sampled window frames."""
        return [self.rendered[i] for i in self.check_sample()]

    def control(self, precision: str) -> list:
        """The reference at ``precision`` in the program's place, on the
        sampled frames."""
        js = [self.rendered[i][0] for i in self.check_sample()]
        maps = self.reference(precision, frames=js)
        return [(j, maps[j]) for j in js]


def compare(prog: list, ref: dict, detail: dict | None = None) -> dict:
    """Per map, the worst compared frame's mean absolute difference over its
    pixels and channels."""
    out = {}
    for name in RR.MAPS:
        key = name.replace("_map", "") + "_mae"
        out[key] = max(float(torch.mean(torch.abs(maps[name].float() - ref[j][name].float())))
                       for j, maps in prog)
    if detail is not None:
        detail.update(frames=[j for j, _ in prog],
                      pixels=[int(maps["acc_map"].shape[0]) for _, maps in prog])
    return out
