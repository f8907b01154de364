"""Plain PyTorch reference of the stage-1 (AniSDF) training step: stratified
samples along each ray, the network's training forward on every sample
(the eikonal terms' gradients taken with ``create_graph``), transmittance
compositing, the losses, one backward a frame and ray chunk weighted
1 / (B NC), the global-norm and value clipping, and Adam with the
exponential schedule.

A frozen copy of the port's ``renderer/volume.train_block``,
``train/loss.anisdf_losses`` (the terms a stage-1 batch without normals or
semantics turns on), ``train/optimizer`` (Adam, clipping) and
``Trainer.step``'s chunking (``ray_chunks``); one process, so a step over W
ranks is the same step over all their rays.
"""
from __future__ import annotations

import torch

from portbench.reference import net as N


def ray_chunks(B: int, R: int, S: int, budget: int) -> tuple:
    """(rays a chunk, chunks): halve while B * RC * S exceeds the budget."""
    RC = R
    while B * RC * max(S, 1) > budget and RC % 2 == 0:
        RC //= 2
    return RC, R // RC


def sample_fractions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) * torch.tensor(
        1.0 / (n - 1), dtype=torch.float32, device=device)


def render_rays(params, net, ctx, ray_o, ray_d, near, far, t_rand, S: int):
    """Composited [norm, rgb] (P, 6), acc (P,) and the regularisers."""
    P = ray_o.shape[0]
    t = sample_fractions(S, ray_o.device)
    z = near[:, None] * (1.0 - t) + far[:, None] * t
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    lower = torch.cat([z[:, :1], mids], dim=-1)
    z = lower + (upper - lower) * t_rand
    pts = ray_o[:, None, :] + ray_d[:, None, :] * z[..., None]
    raw, terms = N.forward(params, net, ctx, pts.reshape(P * S, 3),
                           ray_d[:, None, :].expand(P, S, 3).reshape(P * S, 3),
                           training=True, relight=False)
    raw = raw.reshape(P, S, -1)
    alpha = raw[..., -1]
    shifted = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + 1e-8], dim=-1)
    weights = alpha * torch.cumprod(shifted, dim=-1)
    comp = torch.sum(weights[..., None] * raw[..., :-1], dim=-2)
    return comp, torch.sum(weights, dim=-1), terms


def _safe_norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-12)


def _masked_mean(x, m):
    m = m.to(x.dtype)
    return torch.sum(x * m) / (torch.sum(m) + 1e-8)


def losses(w: dict, comp, acc, terms, rgb, msk, step: int):
    """The stage-1 loss of one frame's rays (its terms as the port's)."""
    m = terms["reg_mask"]
    resd_w = w["resd_loss_weight"] * w["resd_loss_weight_gamma"] ** (
        step // w["resd_loss_weight_milestone"])
    loss = resd_w * _masked_mean(_safe_norm(terms["residuals"]), m)
    loss = loss + w["eikonal_loss_weight"] * _masked_mean(
        (_safe_norm(terms["gradients"]) - 1.0) ** 2, m)
    loss = loss + w["observed_eikonal_loss_weight"] * _masked_mean(
        (_safe_norm(terms["observed_gradients"]) - 1.0) ** 2, m)
    inter = torch.sum(acc * msk)
    union = torch.sum(acc) + torch.sum(msk) - inter
    loss = loss + w["msk_loss_weight"] * (1.0 - inter / (union + 1e-8))
    loss = loss + w["img_loss_weight"] * torch.mean((comp[..., 3:6] - rgb) ** 2)
    return loss


class Steps:
    """Adam over the parameters (one group), clipping and the schedule
    ``lr * gamma ** (step / decay_steps)``."""

    def __init__(self, params, net, weights: dict, lr: float, gamma: float, decay_steps: int,
                 eps: float, clip_norm: float, clip_value: float, S: int, budget: int):
        self.params, self.net, self.w = params, net, weights
        self.leaves = N.named(params)
        for _, t in self.leaves:
            t.requires_grad_(True)
        self.lr, self.gamma, self.decay = lr, gamma, decay_steps
        self.opt = torch.optim.Adam([t for _, t in self.leaves], lr=lr, eps=eps, foreach=False)
        self.clip_norm, self.clip_value = clip_norm, clip_value
        self.S, self.budget = S, budget
        self.count = 0

    def step(self, batch: dict, t_rand: torch.Tensor) -> dict:
        """One step; returns its loss and each leaf's clipped gradient."""
        B, R = batch["rgb"].shape[:2]
        RC, NC = ray_chunks(B, R, self.S, self.budget)
        for _, t in self.leaves:
            t.grad = None
        total = 0.0
        for c in range(NC):
            sl = slice(c * RC, (c + 1) * RC)
            for b in range(B):
                comp, acc, terms = render_rays(
                    self.params, self.net, batch["ctx"][b], batch["ray_o"][b, sl],
                    batch["ray_d"][b, sl], batch["near"][b, sl], batch["far"][b, sl],
                    t_rand[b, sl], self.S)
                loss = losses(self.w, comp, acc, terms, batch["rgb"][b, sl],
                              batch["msk"][b, sl], self.count) / (B * NC)
                loss.backward()
                total += float(loss.detach())
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for _, t in self.leaves]
        for (_, t), g in zip(self.leaves, grads):
            t.grad = g
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        with torch.no_grad():
            for g in grads:
                if norm >= self.clip_norm:
                    g.mul_(self.clip_norm / norm)
                g.clamp_(-self.clip_value, self.clip_value)
        for group in self.opt.param_groups:
            group["lr"] = self.lr * self.gamma ** (self.count / self.decay)
        self.opt.step()
        self.count += 1
        return dict(loss=total, grads={k: g.detach().clone() for (k, _), g in
                                       zip(self.leaves, grads)})
