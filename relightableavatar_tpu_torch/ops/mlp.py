"""Functional MLP stack (``relightableavatar_tpu/ops/mlp.py``), f32 only.

Parameters are plain dicts of tensors with linear weights stored (in, out):
``{"w", "b"}``, or ``{"v", "g", "b"}`` for weight-normed layers, which are
folded at call time as ``v * g / (||v||_0 + 1e-12)``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def fold_weight_norm(p: dict) -> torch.Tensor:
    """The (in, out) weight of a linear layer, folding weight norm (norm over
    the input dim, per output unit, as torch's ``weight_norm`` on (out, in))."""
    if "v" in p:
        v = p["v"]
        return v * (p["g"] / (torch.linalg.vector_norm(v, dim=0) + 1e-12))
    return p["w"]


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ fold_weight_norm(p) + p["b"]


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus with beta=100 and torch's threshold=20 linearization."""
    return F.softplus(x, beta=100.0, threshold=20.0)


ACTVN = {
    "relu": torch.relu,
    "softplus100": softplus100,
    "identity": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def mlp_apply(p: dict, x: torch.Tensor, actvn: str = "relu",
              out_actvn: str = "identity",
              skips: Sequence[int] = (4,)) -> torch.Tensor:
    """Reference MLP (net_utils.py:1242-1273): skip concat of the input
    before layer i for i in skips."""
    inp = x
    layers = p["layers"]
    act = ACTVN[actvn]
    oact = ACTVN[out_actvn]
    for i, layer in enumerate(layers):
        if i in skips:
            x = torch.cat([x, inp], dim=-1)
        x = linear_apply(layer, x)
        x = oact(x) if i == len(layers) - 1 else act(x)
    return x


def ssdf_apply(p: dict, x: torch.Tensor,
               skips: Sequence[int] = (4,)) -> torch.Tensor:
    """(..., d_out) = [sdf, features]; the skip concat is divided by sqrt(2)
    (reference net_utils.py:1345-1346)."""
    inp = x
    layers = p["layers"]
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for i, layer in enumerate(layers):
        if i in skips:
            x = torch.cat([x, inp], dim=-1) * inv_sqrt2
        x = linear_apply(layer, x)
        if i < len(layers) - 1:
            x = softplus100(x)
    return x
