"""Loss functions of AniSDF and relight training
(``relightableavatar_tpu/train/loss.py``): residual norm with an annealed
weight, eikonal terms (canonical and observed), mask soft-IoU, the
silhouette hinge or BCE, the view-weighted normal loss, semantic CE, rgb
MSE and PSNR, and the relight priors (albedo entropy, jitter smoothness).
Both training stages share them (reference
``lib/train/trainers/base_trainer.py:58-105``, ``relight_trainer.py:46-118``,
``lib/utils/loss_utils.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from relightableavatar_tpu_torch.utils.dotdict import dotdict


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Norm with eps inside the square root: its gradient is finite at 0,
    where the masked lanes are (``torch.linalg.norm``'s is NaN there)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    m = mask.to(x.dtype)
    return torch.sum(x * m) / (torch.sum(m) + 1e-8)


def eikonal(grad: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 3) -> scalar (loss_utils.py:162-163), mean over active lanes."""
    return masked_mean((safe_norm(grad) - 1.0) ** 2, mask)


def mIoU_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """1 - soft IoU (loss_utils.py:223-227)."""
    inter = torch.sum(pred * gt)
    union = torch.sum(pred) + torch.sum(gt) - inter
    return 1.0 - inter / (union + 1e-8)


def gaussian_entropy(albedo: torch.Tensor, bins: int = 15, sigma: float = 0.1) -> torch.Tensor:
    """Histogram-entropy sparsity prior on albedo values
    (loss_utils.py:51-76): soft bins by Gaussian kernels."""
    x = albedo.reshape(-1)
    centers = torch.linspace(0.0, 1.0, bins, dtype=x.dtype, device=x.device)
    w = torch.exp(-0.5 * ((x[None, :] - centers[:, None]) / sigma) ** 2)
    p = torch.mean(w, dim=1)
    p = p / (torch.sum(p) + 1e-8)
    return -torch.sum(p * torch.log(p + 1e-8))


def anneal_loss_weight(weight: float, gamma: float, iter_step: int, milestone: int) -> float:
    return weight * gamma ** (int(iter_step) // milestone)


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Channel-last soft-label CE (loss_utils.py:183-188): logits (..., C)
    against a one-hot or soft target (..., C), mean over lanes."""
    x = logits.reshape(-1, logits.shape[-1])
    y = target.reshape(-1, target.shape[-1])
    return -torch.mean(torch.sum(y * F.log_softmax(x, dim=-1), dim=-1))


def anisdf_losses(cfg_w: dotdict, out: dotdict, batch: dotdict, iter_step: int) -> tuple:
    """(loss, scalar stats); ``cfg_w`` carries the loss weights
    (:func:`loss_weights_from_cfg`).  A term is on when its inputs are in
    ``out`` and ``batch``."""
    stats = dotdict()
    loss = 0.0
    mask = out.get('reg_mask', None)

    if 'residuals' in out:
        resd_loss = masked_mean(safe_norm(out.residuals), mask)
        w = anneal_loss_weight(cfg_w.resd_loss_weight, cfg_w.resd_loss_weight_gamma,
                               iter_step, cfg_w.resd_loss_weight_milestone)
        stats.resd_loss = resd_loss
        loss = loss + w * resd_loss

    if 'gradients' in out:
        grad_loss = eikonal(out.gradients, mask)
        stats.grad_loss = grad_loss
        loss = loss + cfg_w.eikonal_loss_weight * grad_loss

    if 'observed_gradients' in out:
        ograd_loss = eikonal(out.observed_gradients, mask)
        stats.ograd_loss = ograd_loss
        loss = loss + cfg_w.observed_eikonal_loss_weight * ograd_loss

    if 'acc_map' in out and 'msk' in batch:
        msk_loss = mIoU_loss(out.acc_map, batch.msk)
        stats.msk_loss = msk_loss
        loss = loss + cfg_w.msk_loss_weight * msk_loss

    if cfg_w.silh_loss_weight > 0 and 'msk' in batch:
        # per-ray silhouette supervision at the traced surface (no reference
        # counterpart): 'hinge' a symmetric deadband at the closest-approach
        # SDF, 'bce' the logistic loss of sigmoid(-edge_sdf / scale)
        silh_loss = None
        m = batch.msk
        if cfg_w.silh_mode == 'hinge' and 'closest_sdf' in out:
            d = out.closest_sdf
            s, mg = cfg_w.silh_scale, cfg_w.silh_margin
            silh_loss = torch.mean(m * torch.relu(d - mg) / s
                                   + (1.0 - m) * torch.relu(mg - d) / s)
        elif cfg_w.silh_mode == 'bce' and 'edge_sdf' in out:
            p = torch.sigmoid(-out.edge_sdf / cfg_w.silh_scale)
            silh_loss = torch.mean(-(m * torch.log(p + 1e-6)
                                     + (1.0 - m) * torch.log(1.0 - p + 1e-6)))
        if silh_loss is not None:
            stats.silh_loss = silh_loss
            loss = loss + cfg_w.silh_loss_weight * silh_loss

    if 'norm_map' in out and 'norm' in batch:
        # view-weighted L1 + (1 - cos) (base_trainer.py:78-88)
        nm = out.norm_map / safe_norm(out.norm_map)[..., None]
        ng = batch.norm / safe_norm(batch.norm)[..., None]
        view_dot = torch.clamp(torch.sum(nm * (-batch.ray_d), -1), 0.0, 1.0)
        per_ray = (torch.sum(torch.abs(nm - ng), -1) + (1.0 - torch.sum(nm * ng, -1))) * view_dot
        norm_loss = torch.mean(per_ray)
        stats.norm_loss = norm_loss
        loss = loss + cfg_w.norm_loss_weight * norm_loss

    if 'sem_map' in out and 'sem' in batch:
        sem_loss = cross_entropy(out.sem_map, batch.sem)
        stats.sem_loss = sem_loss
        loss = loss + cfg_w.sem_loss_weight * sem_loss

    if 'rgb_map' in out and 'rgb' in batch:
        img_loss = torch.mean((out.rgb_map - batch.rgb) ** 2)
        stats.img_loss = img_loss
        stats.psnr = -10.0 * torch.log(img_loss.detach() + 1e-12) / math.log(10.0)
        loss = loss + cfg_w.img_loss_weight * img_loss

    # relight priors
    if 'albedo' in out:
        ent = gaussian_entropy(out.albedo)
        stats.albedo_entropy = ent
        loss = loss + cfg_w.albedo_sparsity * ent
    if 'volume_albedo' in out:
        ent = gaussian_entropy(out.volume_albedo)
        stats.volume_entropy = ent
        loss = loss + cfg_w.albedo_sparsity * ent
    if 'albedo' in out and 'albedo_jitter' in out:
        sm = torch.mean(torch.abs(out.albedo - out.albedo_jitter))
        stats.albedo_smooth = sm
        loss = loss + cfg_w.albedo_smooth_weight * sm
    if 'roughness' in out and 'roughness_jitter' in out:
        sm = torch.mean(torch.abs(out.roughness - out.roughness_jitter))
        stats.roughness_smooth = sm
        loss = loss + cfg_w.roughness_smooth_weight * sm

    stats.loss = loss
    return loss, stats


def loss_weights_from_cfg(cfg) -> dotdict:
    return dotdict(
        resd_loss_weight=float(cfg.resd_loss_weight),
        resd_loss_weight_gamma=float(cfg.resd_loss_weight_gamma),
        resd_loss_weight_milestone=int(cfg.resd_loss_weight_milestone),
        eikonal_loss_weight=float(cfg.eikonal_loss_weight),
        observed_eikonal_loss_weight=float(cfg.observed_eikonal_loss_weight),
        msk_loss_weight=float(cfg.msk_loss_weight),
        silh_loss_weight=float(cfg.silh_loss_weight),
        silh_scale=float(cfg.silh_scale),
        silh_mode=str(cfg.silh_mode),
        silh_margin=float(cfg.silh_margin),
        sem_loss_weight=float(cfg.sem_loss_weight),
        norm_loss_weight=float(cfg.norm_loss_weight),
        img_loss_weight=float(cfg.img_loss_weight),
        albedo_sparsity=float(cfg.albedo_sparsity),
        albedo_smooth_weight=float(cfg.albedo_smooth_weight),
        roughness_smooth_weight=float(cfg.roughness_smooth_weight),
    )
