"""The stage-1 train step on the fixture avatar, for ``chip_smoke.py``'s
``[train]`` phase and the gpu tests: ``bench.py``'s reference geometry
(``bench.py:201-262``: B = 4 frames of R = 1024 rays, S = 128 samples, its
ray layout, the default ``tpu.grad_sample_budget``) and a small step that
holds the card to the CPU.

Rays (``bench.py:236-250``): from 2 m in front of fixture frame 0's body
toward N(0, 0.3 m) targets around its centre lifted 1 m, near 0.5 m, far
4 m, random colours (numpy rng ``seed``), full masks; every frame of the
batch is frame 0.  The network is the fixture's stage-1 network (8 x 256
residual and SDF MLPs) with the fixture config (``golden.fixture_cfg``:
HDQ band 0.125 m).
"""
from __future__ import annotations

import tempfile

import numpy as np
import torch

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.train.trainer import Trainer
from relightableavatar_tpu_torch.utils.dotdict import dotdict

BENCH_B, BENCH_R, BENCH_S = 4, 1024, 128
CHECK_B, CHECK_R, CHECK_S = 2, 64, 16


def step_cfg(B: int, S: int, bf16: bool, perturb: bool, record_dir: str | None = None):
    """The fixture's stage-1 config for a train step of B frames and S
    samples a ray, with bf16 MLPs or float32 and stratified samples or not;
    the recorder writes into ``record_dir`` (a new temporary folder by
    default)."""
    cfg = golden.fixture_cfg()
    cfg.relighting = False
    cfg.n_samples = S
    cfg.train.batch_size = B
    cfg.tpu.bf16_mlp = bf16
    cfg.perturb = 1.0 if perturb else 0.0
    cfg.record_tb = False
    cfg.record_dir = record_dir or tempfile.mkdtemp(prefix="train_check_")
    return cfg


def make_step(cfg, device, R: int, seed: int = 0):
    """(trainer, batch): a Trainer of the fixture's stage-1 parameters on
    ``device`` and a collated batch of ``cfg.train.batch_size`` frames of R
    rays in bench.py's layout."""
    ctx, params, mcfg = golden.load_fixture(cfg, device=device)
    trainer = Trainer(cfg, params, mcfg, device=device)
    B = int(cfg.train.batch_size)
    rng = np.random.default_rng(seed)
    center = ctx["Th"].cpu().numpy().reshape(3) + [0, 0, 1.0]
    ray_o = np.tile(center + [2.0, 0, 0], (B, R, 1)).astype(np.float32)
    tgt = center[None, None] + rng.normal(0, 0.3, (B, R, 3)).astype(np.float32)
    ray_d = (tgt - ray_o).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    rgb = rng.random((B, R, 3), np.float32)
    items = [dotdict(ctx=ctx, ray_o=ray_o[b], ray_d=ray_d[b], near=np.full(R, 0.5, np.float32),
                     far=np.full(R, 4.0, np.float32), rgb=rgb[b], msk=np.ones(R, np.float32))
             for b in range(B)]
    return trainer, trainer.collate(items)


def live_residual(trainer, seed: int = 0) -> None:
    """Re-draw the residual MLP's last weight (nn.Linear's init, seeded):
    the fixture's is zero, which leaves the residual MLP's other layers
    without a gradient."""
    w = trainer.params["resd"]["layers"][-1]["w"]
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) / w.shape[0] ** 0.5)


def step_result(trainer, batch) -> dict:
    """One step: the loss and each parameter's (clipped) gradient, on the host."""
    stats = trainer.step(batch, 0)
    return dict(loss=float(stats.loss),
                grads={k: t.grad.detach().float().cpu() for k, t in trainer.named})


def compare_grads(card: dict, cpu: dict) -> dict:
    """Per parameter: (max |card - cpu| / max |cpu|, cosine of the two, card's max |g|)."""
    out = {}
    for k, g in cpu["grads"].items():
        c = card["grads"][k]
        rel = float((c - g).abs().max() / g.abs().max().clamp_min(1e-30))
        cos = float(torch.nn.functional.cosine_similarity(c.flatten().double(),
                                                          g.flatten().double(), dim=0))
        out[k] = (rel, cos, float(c.abs().max()))
    return out
