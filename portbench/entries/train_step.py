"""The stage-1 training step (``train/trainer.py:Trainer.step``), on one card
or data-parallel over the ranks of a process group.

Set-up builds one Trainer from the fixture avatar, collates the traffic's
pool of batches (``Trainer.collate``) and drives the trainer through its
first ``CHECKED`` steps on the pool's first batches, the window's own call
on rows that all differ: the first is the warm step at the cell's shapes,
and the three give what the reference checks (each step's loss, the first
gradient as Adam holds it after step 1, the parameters' change after step
3).  The window then takes the pool's batches in turn, from the fourth on.

The reference (``reference/train.py``) repeats the three steps in float32
from the avatar's file, on the same rays and the same stratified draws
(a generator of the seed, as the trainer's), in one process.
"""
from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from portbench import flops
from portbench.reference import net as RN
from portbench.reference import train as RT

CHECKED = 3
ADAM_BETA1 = 0.9
# leaves whose first reference gradient is under this share of the median
# leaf's move under Adam by round-off alone: left out of the change
ZERO_GRAD_SHARE = 1e-3


class Entry:
    unit = "step"

    def __init__(self, cell, seed: int, device, root: str, mesh_world: int = 1):
        self.cell, self.seed, self.device, self.root = cell, int(seed), torch.device(device), root
        self.cfg = cell.make_cfg()
        self.cfg.seed = self.seed
        self.record_dir = tempfile.mkdtemp(prefix="portbench_record_")
        self.cfg.record_dir = self.record_dir
        self.traffic = cell.generator().Traffic(cell.traffic, self.seed, root)
        self.pool = int(cell.traffic["pool_batches"])
        self.world = mesh_world
        self.granule = 1
        self.phases = {}
        self.trainer = None
        self.readings = None
        self.it = 0

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
        from relightableavatar_tpu_torch.models.context import make_bigpose, make_frame_context
        from relightableavatar_tpu_torch.smpl.body_model import BodyModel
        from relightableavatar_tpu_torch.train.trainer import Trainer
        from relightableavatar_tpu_torch.utils.dotdict import dotdict
        from relightableavatar_tpu_torch.weights import load_params

        cfg, dev = self.cfg, self.device
        t = time.perf_counter()
        fx = os.path.join(self.root, "fixtures")
        model = BodyModel(os.path.join(fx, "synthetic_body.npz"))
        motion = self.traffic.motion
        mcfg = AniSDFConfig.from_cfg(cfg)
        params = load_params(os.path.join(fx, "synthetic_avatar_params.npz"), device=dev,
                             mcfg=mcfg)
        self.trainer = Trainer(cfg, params, mcfg, device=dev)
        t = self._phase("trainer", t)
        frames = [self.traffic.batch(k) for k in range(self.pool)]
        ctxs = {}
        for fr in (f for b in frames for f in b):
            p = fr["pose"]
            if p not in ctxs:
                sh = motion["shapes"][p]
                tv, tj, bA, _ = make_bigpose(model, sh)
                ctxs[p] = make_frame_context(model, tv, tj, bA, motion["poses"][p],
                                             motion["Rh"][p], motion["Th"][p], sh, device=dev)
        self.batches = [self.trainer.collate([dotdict(fr, ctx=ctxs[fr["pose"]]) for fr in b])
                        for b in frames]
        self.n_verts = int(next(iter(ctxs.values()))["pverts"].shape[0])
        B, R = self.batches[0].rgb.shape[:2]
        self.n_samples = B * R * int(cfg.n_samples) // self.world
        t = self._phase("batches", t)
        named = self.trainer.named
        p0 = {k: t.detach().clone() for k, t in named}
        losses, grads = [], None
        for _ in range(CHECKED):
            losses.append(float(self.run_one().loss))
            if grads is None:
                st = self.trainer.optimizer.opt.state
                grads = {k: (st[v]["exp_avg"] / (1 - ADAM_BETA1) if v in st and "exp_avg" in st[v]
                             else torch.zeros_like(v)).detach().float().cpu() for k, v in named}
            t = self._phase(f"step{len(losses)}", t)
        change = {k: float(torch.linalg.vector_norm(v.detach() - p0[k])) for k, v in named}
        self.readings = dict(losses=losses, grads=grads, change=change)

    def _phase(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - t
        return now

    def run_one(self):
        """One optimiser step on the pool's next batch."""
        batch = self.batches[self.it % self.pool]
        stats = self.trainer.step(batch, self.it)
        self.it += 1
        return stats

    def unit_flops(self) -> int:
        """This rank's analytic FLOPs a step (its share of the rays)."""
        cfg = self.cfg
        return flops.train_step_flops(int(cfg.xyz_res), int(cfg.sdf_res), int(cfg.view_res),
                                      int(cfg.cond_dim), int(cfg.feat_dim), self.n_samples,
                                      self.n_verts)

    def program_readings(self) -> dict:
        return self.readings

    def control(self, precision: str) -> dict:
        """The reference at ``precision`` in the program's place."""
        return self.reference(precision)

    def release(self) -> None:
        """Free the program's state and its (empty) record folder; the
        readings stay."""
        self.trainer.recorder.close()
        shutil.rmtree(self.record_dir, ignore_errors=True)
        self.trainer = self.batches = None

    # ------------------------------------------------------------ reference
    def reference(self, precision: str = "float32", half_batch: bool = False) -> dict:
        """The reference's readings of the checked steps, at ``precision``;
        ``half_batch`` leaves the second half of each batch out (a fault)."""
        cfg, dev = self.cfg, self.device
        fx = os.path.join(self.root, "fixtures")
        body = RN.Body(os.path.join(fx, "synthetic_body.npz"))
        m = self.traffic.motion
        net = RN.Net.from_cfg(cfg, precision)
        params = RN.load_params(os.path.join(fx, "synthetic_avatar_params.npz"), dev,
                                relight=False)
        p0 = {k: t.detach().clone() for k, t in RN.named(params)}
        w = {k: float(cfg[k]) for k in ("resd_loss_weight", "resd_loss_weight_gamma",
                                        "eikonal_loss_weight", "observed_eikonal_loss_weight",
                                        "msk_loss_weight", "img_loss_weight")}
        w["resd_loss_weight_milestone"] = int(cfg.resd_loss_weight_milestone)
        sched = cfg.train.scheduler
        steps = RT.Steps(params, net, w, float(cfg.train.lr), float(sched.gamma),
                         int(sched.decay_epochs) * int(cfg.ep_iter), float(cfg.train.eps),
                         float(cfg.clip_grad_norm), float(cfg.clip_grad_value),
                         int(cfg.n_samples), int(cfg.tpu.grad_sample_budget))
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        ctxs = {}
        losses, grads = [], None
        for k in range(CHECKED):
            frames = self.traffic.batch(k)
            B, R = len(frames), frames[0]["rgb"].shape[0]
            t_rand = torch.rand((B, R, int(cfg.n_samples)), generator=gen, device=dev)
            if half_batch:
                frames, t_rand = frames[:B // 2], t_rand[:B // 2]
            for fr in frames:
                p = fr["pose"]
                if p not in ctxs:
                    ctxs[p] = RN.frame_context(body, m["poses"][p], m["Rh"][p], m["Th"][p],
                                               m["shapes"][p], dev)
            batch = {key: torch.as_tensor(np.stack([fr[key] for fr in frames]), device=dev)
                     for key in ("ray_o", "ray_d", "near", "far", "rgb", "msk")}
            batch["ctx"] = [ctxs[fr["pose"]] for fr in frames]
            out = steps.step(batch, t_rand)
            losses.append(out["loss"])
            if grads is None:
                grads = {key: g.float().cpu() for key, g in out["grads"].items()}
        change = {k: float(torch.linalg.vector_norm(t.detach() - p0[k]))
                  for k, t in RN.named(params)}
        return dict(losses=losses, grads=grads, change=change)


def compare(prog: dict, ref: dict, detail: dict | None = None) -> dict:
    """The compared numbers, on the leaves that the reference's first
    gradient moves (a leaf on one side only reads as zero on the other):
    - ``grad_gap``: the median such leaf's gap of first-gradient norms,
      |program norm - reference norm| over the reference leaf's norm or the
      median leaf's, whichever is larger;
    - ``grad_angle``: 1 - the cosine between the program's and the
      reference's first gradient over all those leaves;
    - ``change_gap``: the worst such leaf's gap of the parameters' change
      over the three steps, measured as ``grad_gap``.
    The worst leaf's gradient gap and each step's loss gap are not compared
    (PERF.md, "How correct is decided": one scalar leaf, ``beta``, whose
    gradient nearly cancels, sets the first; neither the control nor a
    fault reads three times the sound runs' on the second); ``detail``
    receives them beside the worst leaves."""
    zero = torch.zeros(0)
    keys = sorted(set(ref["grads"]) | set(prog["grads"]))
    norm = lambda d, k: float(torch.linalg.vector_norm(d.get(k, zero).double()))
    rg = {k: norm(ref["grads"], k) for k in keys}
    pg = {k: norm(prog["grads"], k) for k in keys}
    med_g = statistics.median(rg.values())
    moved = [k for k in keys if rg[k] >= ZERO_GRAD_SHARE * med_g]
    gg = {k: abs(pg[k] - rg[k]) / max(rg[k], med_g, 1e-30) for k in moved}
    vec = lambda d: torch.cat([d[k].double().flatten() if k in d else
                               torch.zeros(ref["grads"][k].numel(), dtype=torch.float64)
                               for k in moved])
    a, b = vec(prog["grads"]), vec(ref["grads"])
    angle = 1.0 - float(a @ b / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)
                                 + 1e-300))
    rc = {k: ref["change"].get(k, 0.0) for k in moved}
    med_c = statistics.median(rc.values())
    cg = {k: abs(prog["change"].get(k, 0.0) - rc[k]) / max(rc[k], med_c, 1e-30) for k in moved}
    if detail is not None:
        worst = lambda d: sorted(d, key=lambda k: -d[k])[:3]
        losses = [abs(x - y) / max(abs(y), 1e-30) for x, y in zip(prog["losses"], ref["losses"])]
        detail.update(loss_gap=max(losses) if len(losses) == len(ref["losses"]) else None,
                      worst_grad_gap=max(gg.values()),
                      grad_worst={k: [gg[k], pg[k], rg[k]] for k in worst(gg)},
                      change_worst={k: [cg[k], prog["change"].get(k, 0.0), rc[k]]
                                    for k in worst(cg)},
                      median_grad=med_g, median_change=med_c,
                      left_out=sorted(set(keys) - set(moved)))
    return dict(grad_gap=statistics.median(gg.values()), grad_angle=angle,
                change_gap=max(cg.values()))
