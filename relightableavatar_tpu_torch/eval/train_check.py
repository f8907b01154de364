"""The train steps on the fixture avatar, for ``chip_smoke.py``'s
``[train]`` and ``[train-relight]`` phases, ``eval/profile_frame.py`` and
the gpu tests.

Stage 1: ``bench.py``'s reference geometry (``bench.py:201-262``: B = 4
frames of R = 1024 rays, S = 128 samples, its ray layout, the default
``tpu.grad_sample_budget``) and a small step that holds the card to the CPU.

Stage 2 (:func:`relight_step_cfg`): the reference relight config
(``configs/base.yaml``'s relighting_cfg with ``configs/synthetic/tubeman.yaml``'s):
B = 2 frames of R = 1024 rays, 3 band samples, 16 surface and 4 shadow
iterations, 16 x 32 light texels, HDQ band 0.125 m, shadow blocks of
32,768 rays (``network_chunk_size`` 1,048,576), no SDF grid, bfloat16
MLPs, its lr table and loss weights; the fixture's parameters with its
relight heads and envmap; rays in the same layout.  Its small step for the
card against the CPU aims 3/4 of the rays at posed vertices that face the
camera and 1/4 at points 0.5 m beside the body, so that no ray grazes the
silhouette, where float32 sums in another order can flip the trace's hit.

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
RELIGHT_B, RELIGHT_R = 2, 1024
RELIGHT_CHECK_R = 64
# configs/base.yaml relighting_cfg (train.lr, lr_table and loss weights)
RELIGHT_LR = 5e-3
RELIGHT_LR_TABLE = {'residual_deformation_network': 5e-6, 'signed_distance_network': 5e-6,
                    'roughness_network': 5e-5}
RELIGHT_WEIGHTS = {'albedo_sparsity': 5e-5, 'albedo_smooth_weight': 5e-3,
                   'roughness_smooth_weight': 5e-5, 'img_loss_weight': 10.0,
                   'eikonal_loss_weight': 0.05, 'observed_eikonal_loss_weight': 0.025,
                   'msk_loss_weight': 0.1}


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


def relight_step_cfg(bf16: bool, record_dir: str | None = None):
    """The reference relight config for a stage-2 step of ``RELIGHT_B``
    frames, with bf16 MLPs or float32."""
    cfg = golden.frame_cfg()
    cfg.train.batch_size = RELIGHT_B
    cfg.network_chunk_size = 1048576
    cfg.tpu.bf16_mlp = bf16
    cfg.train.lr = RELIGHT_LR
    cfg.train.lr_table = type(cfg.train.lr_table)(RELIGHT_LR_TABLE)
    for k, v in RELIGHT_WEIGHTS.items():
        cfg[k] = v
    cfg.record_tb = False
    cfg.record_dir = record_dir or tempfile.mkdtemp(prefix="train_check_")
    return cfg


def reference_step(stage: str, device, record_dir: str | None = None):
    """(trainer, batch) of a reference step in float32 from a fresh trainer
    (so that its generator's draws are the first): ``stage1``, bench.py's
    geometry with stratified samples, or ``stage2``, the reference relight
    step.  Under a process group the trainer shards the rays; its draws
    are the same on every rank and in one process."""
    if stage == "stage1":
        cfg = step_cfg(BENCH_B, BENCH_S, bf16=False, perturb=True, record_dir=record_dir)
        return make_step(cfg, device, BENCH_R)
    return make_step(relight_step_cfg(bf16=False, record_dir=record_dir), device, RELIGHT_R)


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


def make_relight_check(cfg, device, seed: int = 0):
    """(trainer, batch, jitter) of the small stage-2 step: ``RELIGHT_B``
    frames of ``RELIGHT_CHECK_R`` rays from 2 m in front of fixture frame
    0's body, 3/4 toward posed vertices whose normal faces the camera
    (cosine > 0.5), 1/4 toward points 0.5 m beside the body, near 0.5 m, far
    4 m; the smoothness pair's jitter drawn on the CPU (numpy rng ``seed``),
    so that the card and the CPU take the same."""
    ctx, params, mcfg = golden.load_fixture(cfg, device=device)
    trainer = Trainer(cfg, params, mcfg, device=device)
    B, R = int(cfg.train.batch_size), RELIGHT_CHECK_R
    rng = np.random.default_rng(seed)
    Rm, Th = ctx["R"].cpu().numpy(), ctx["Th"].cpu().numpy().reshape(3)
    pv = ctx["pverts"].cpu().numpy() @ Rm.T + Th
    pn = ctx["pnorm"].cpu().numpy() @ Rm.T
    center = Th + [0, 0, 1.0]
    o = center + [2.0, 0, 0]
    facing = np.nonzero(np.sum(pn * (o - pv), -1) / np.linalg.norm(o - pv, axis=-1) > 0.5)[0]
    n_hit = 3 * R // 4
    items = []
    for _ in range(B):
        tgt = np.concatenate([pv[rng.choice(facing, n_hit)],
                              center + [0, 0.5, 0] + rng.normal(0, 0.05, (R - n_hit, 3))])
        ray_d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
        items.append(dotdict(ctx=ctx, ray_o=np.tile(o, (R, 1)).astype(np.float32),
                             ray_d=ray_d.astype(np.float32), near=np.full(R, 0.5, np.float32),
                             far=np.full(R, 4.0, np.float32),
                             rgb=rng.random((R, 3)).astype(np.float32),
                             msk=np.ones(R, np.float32)))
    S = int(cfg.n_samples)
    jitter = torch.as_tensor(rng.normal(0, 0.02, (B, R, S, 3)).astype(np.float32), device=device)
    return trainer, trainer.collate(items), jitter


def ray_hits(trainer, batch) -> torch.Tensor:
    """(B, R) bool: the rays whose surface trace hits (acc > 0), from the
    inference render of the batch's rays without the shading."""
    from relightableavatar_tpu_torch.renderer.sphere_tracing import render_human_block
    rcfg = trainer.rcfg._replace(relighting=False)
    probe = torch.zeros((1, 1, 3), device=batch.rgb.device)
    return torch.stack([
        render_human_block(trainer.params, trainer.mcfg, ctx, batch.ray_o[b], batch.ray_d[b],
                           batch.near[b], batch.far[b], probe, *trainer.lights, trainer.st_surf,
                           trainer.st_obj, rcfg).acc_map > 0
        for b, ctx in enumerate(batch.ctx)])


def step_result(trainer, batch, jitter=None) -> dict:
    """One step: the loss and each parameter's (clipped) gradient, on the
    host; the relight step takes ``jitter`` for its smoothness pair."""
    stats = trainer.step(batch, 0, jitter_noise=jitter)
    return dict(loss=float(stats.loss),
                grads={k: t.grad.detach().float().cpu() for k, t in trainer.named})


def compare_nets(card: dict, cpu: dict) -> dict:
    """Per sub-network (the parameters' top-level key) with a gradient on
    the CPU: the cosine of the card's gradient to the CPU's over all its
    tensors together."""
    nets: dict = {}
    for k in cpu["grads"]:
        nets.setdefault(k.split('/')[0], []).append(k)
    flat = lambda r, ks: torch.cat([r["grads"][k].flatten().double() for k in ks])
    return {n: float(torch.nn.functional.cosine_similarity(flat(card, ks), flat(cpu, ks), dim=0))
            for n, ks in nets.items() if flat(cpu, ks).any()}


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
