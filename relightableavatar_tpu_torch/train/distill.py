"""Geometry distillation (``relightableavatar_tpu/train/distill.py``): fit
the canonical SDF MLP to a body point cloud, a stage-1 geometry to start
from where no trained checkpoint exists.

The target signed distance comes from the canonical vertex cloud and its
normals (the construction of ``geodesic_knn``,
``lib/utils/sample_utils.py:118-127``): the distance to the nearest vertex,
the sign a majority vote over the 4 nearest.  The JAX package takes those 4
with its plain XLA ``knn_unchunked`` (an approximate top-K, not the Pallas
kernel); here it is an exact top-4 in plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from relightableavatar_tpu_torch.ops.embedder import positional_encoding
from relightableavatar_tpu_torch.ops.grads import spatial_gradient_fwd
from relightableavatar_tpu_torch.ops.mlp import ssdf_apply

TARGET_BLOCK = 4096     # points a block of the (P, V) distance matrix


def target_sdf(pts: torch.Tensor, tverts: torch.Tensor, tnorm: torch.Tensor,
               K: int = 4) -> torch.Tensor:
    """(P, 1) signed distance of ``pts`` to the vertex cloud: the distance
    to the nearest vertex, the sign from the normals' side of the K nearest
    (a majority, ties outside)."""
    out = []
    for s in range(0, pts.shape[0], TARGET_BLOCK):
        p = pts[s:s + TARGET_BLOCK]
        d2 = ((p[:, None, :] - tverts[None]) ** 2).sum(-1)
        d2k, nn = torch.topk(d2, K, dim=1, largest=False)
        dots = torch.sum((p[:, None, :] - tverts[nn]) * tnorm[nn], dim=-1)
        sign = torch.sign(torch.sum(torch.sign(dots), dim=-1) + 0.5)
        out.append(torch.sqrt(torch.clamp(d2k[:, 0], min=0.0)) * sign)
    return torch.cat(out)[:, None]


def sample_points(tverts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, batch: int,
                  generator: torch.Generator) -> torch.Tensor:
    """A batch of training points: half at vertices + N(0, 2 cm), a quarter
    at vertices + N(0, 8 cm), a quarter uniform in the box [lo, hi]."""
    V = tverts.shape[0]
    dev, dt = tverts.device, tverts.dtype
    draw = lambda *s: torch.randn(s, generator=generator, device=dev, dtype=dt)
    pick = lambda n: tverts[torch.randint(0, V, (n,), generator=generator, device=dev)]
    near = pick(batch // 2) + draw(batch // 2, 3) * 0.02
    mid = pick(batch // 4) + draw(batch // 4, 3) * 0.08
    unif = lo + (hi - lo) * torch.rand((batch // 4, 3), generator=generator, device=dev,
                                       dtype=dt)
    return torch.cat([near, mid, unif], dim=0)


def distill_loss(sdf_params: dict, mcfg, pts: torch.Tensor, tverts: torch.Tensor,
                 tnorm: torch.Tensor) -> torch.Tensor:
    """L1 to the target signed distance + 0.1 x the eikonal term."""
    gt = target_sdf(pts, tverts, tnorm)
    pred, grad_p = spatial_gradient_fwd(
        lambda p: ssdf_apply(sdf_params, positional_encoding(p, mcfg.sdf_res))[..., :1], pts)
    l1 = torch.mean(torch.abs(pred - gt))
    eik = torch.mean((torch.linalg.vector_norm(grad_p, dim=-1) - 1.0) ** 2)
    return l1 + 0.1 * eik


def distill_geometry(params: dict, mcfg, tverts: np.ndarray, tnorm: np.ndarray,
                     steps: int = 600, batch: int = 8192, lr: float = 5e-4, seed: int = 0,
                     beta_final: float = 0.01, zero_residuals: bool = True):
    """Returns (params with the SDF MLP fitted to the canonical body
    surface, the last step's loss).  Adam (optax's defaults) on the ``sdf``
    subtree only, ``steps`` batches of ``batch`` points from a generator
    seeded by ``seed``, on the device and in the dtype of ``params``; then
    ``beta`` set to ``beta_final`` and, with ``zero_residuals``, the
    residual MLP's last layer zeroed, so that the geometry does not depend
    on the pose."""
    ref = params["sdf"]["layers"][0]["v"]
    dev = ref.device
    tv = torch.tensor(np.asarray(tverts), dtype=ref.dtype, device=dev)
    tn = torch.tensor(np.asarray(tnorm), dtype=ref.dtype, device=dev)
    lo, hi = tv.min(0).values - 0.3, tv.max(0).values + 0.3
    sdf = {"layers": [{k: v.detach().clone().requires_grad_(True) for k, v in layer.items()}
                      for layer in params["sdf"]["layers"]]}
    leaves = [t for layer in sdf["layers"] for t in layer.values()]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    loss = torch.zeros(())
    for _ in range(steps):
        pts = sample_points(tv, lo, hi, batch, gen)
        loss = distill_loss(sdf, mcfg, pts, tv, tn)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    out = dict(params)
    out["sdf"] = {"layers": [{k: v.detach() for k, v in layer.items()}
                             for layer in sdf["layers"]]}
    out["beta"] = torch.tensor(beta_final, dtype=torch.float32, device=dev)
    if zero_residuals:
        layers = list(params["resd"]["layers"])
        layers[-1] = {k: torch.zeros_like(v) if k in ("w", "v", "b") else v
                      for k, v in layers[-1].items()}
        out["resd"] = dict(params["resd"], layers=layers)
    return out, float(loss.detach())
