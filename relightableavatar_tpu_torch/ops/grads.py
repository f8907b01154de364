"""Spatial SDF gradients (``relightableavatar_tpu/ops/grads.py``).

The JAX package takes the training path's spatial gradients in forward mode
(reverse-over-reverse did not compile on its TPU).  In torch the reverse
pass with ``create_graph=True`` is itself differentiable, so
:func:`spatial_gradient` serves training and inference alike;
:func:`spatial_gradient_fwd` keeps the JAX function's ``(value, grad)``
contract on top of it.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def spatial_gradient(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                     create_graph: bool = True) -> torch.Tensor:
    """d f(x)[..., 0] / dx for f: (..., 3) -> (..., C); with ``create_graph``
    the result stays differentiable (towards f's parameters too)."""
    return spatial_gradient_fwd(f, x, create_graph)[1]


def spatial_gradient_fwd(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                         create_graph: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value (..., C), grad (..., 3)) of f at x, f evaluated once."""
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        val = f(xg)
        (grad,) = torch.autograd.grad(val[..., 0].sum(), xg, create_graph=create_graph)
    return val, grad


def spatial_gradient_fd(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                        eps: float = 0.005) -> torch.Tensor:
    """Forward differences, 4 evaluations (reference sdf_finite_diff,
    base_network.py:111-119)."""
    f0 = f(x)[..., 0]
    cols = []
    for d in range(3):
        dx = torch.zeros_like(x)
        dx[..., d] = eps
        cols.append((f(x + dx)[..., 0] - f0) / eps)
    return torch.stack(cols, dim=-1)
