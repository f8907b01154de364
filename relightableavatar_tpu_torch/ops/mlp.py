"""Functional MLP stack (``relightableavatar_tpu/ops/mlp.py``).

Parameters are plain dicts of tensors with linear weights stored (in, out):
``{"w", "b"}``, or ``{"v", "g", "b"}`` for weight-normed layers, which are
folded at call time as ``v * g / (||v||_0 + 1e-12)``.

``bf16`` runs a linear layer as the JAX package does
(``dot_general`` of bfloat16 operands with ``preferred_element_type=f32``):
input and weight are rounded to bfloat16 and the product is summed and
emitted in float32.  On CUDA that is ``torch.mm(..., out_dtype=float32)``
(cuBLAS bf16 inputs, f32 accumulate and output); on the CPU, which has no
kernel for that op, the rounded operands are multiplied in float32, where
the products of two bfloat16 values are exact.  ``bf16_act`` keeps the
hidden activations in bfloat16 between layers.
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


class _Bf16MatMul(torch.autograd.Function):
    """bfloat16 x (N, I) @ bfloat16 w (I, O) -> float32 on CUDA, with the
    input gradient the JAX transpose rule gives: the float32 cotangent times
    the bfloat16 weight in float32, rounded to the input's bfloat16."""

    @staticmethod
    def forward(ctx, xb, wb):
        ctx.save_for_backward(wb)
        return torch.mm(xb, wb, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        (wb,) = ctx.saved_tensors
        return (g @ wb.float().T).to(torch.bfloat16), None


def _bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., I) @ w (I, O) on bfloat16-rounded operands, float32 out."""
    xb = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
    wb = w.to(torch.bfloat16)
    if xb.is_cuda:
        y = _Bf16MatMul.apply(xb, wb)
    else:
        y = xb.float() @ wb.float()
    return y.reshape(*x.shape[:-1], w.shape[-1])


def linear_apply(p: dict, x: torch.Tensor, bf16: bool = False,
                 keep_bf16: bool = False) -> torch.Tensor:
    """``keep_bf16`` (with ``bf16``): emit the layer's output in bfloat16."""
    w = fold_weight_norm(p)
    if not bf16:
        return x @ w + p["b"]
    y = _bf16_matmul(x, w) + p["b"]
    return y.to(torch.bfloat16) if keep_bf16 else y


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
              out_actvn: str = "identity", bf16: bool = False,
              bf16_act: bool = False,
              skips: Sequence[int] = (4,)) -> torch.Tensor:
    """Reference MLP (net_utils.py:1242-1273): skip concat of the input
    before layer i for i in skips.  The last layer emits float32."""
    inp = x
    layers = p["layers"]
    act = ACTVN[actvn]
    oact = ACTVN[out_actvn]
    for i, layer in enumerate(layers):
        if i in skips:
            x = torch.cat([x, inp.to(x.dtype)], dim=-1)
        last = i == len(layers) - 1
        x = linear_apply(layer, x, bf16=bf16, keep_bf16=bf16_act and not last)
        x = oact(x) if last else act(x)
    return x


def ssdf_apply(p: dict, x: torch.Tensor, bf16: bool = False,
               bf16_act: bool = False,
               skips: Sequence[int] = (4,)) -> torch.Tensor:
    """(..., d_out) = [sdf, features]; the skip concat is divided by sqrt(2)
    (reference net_utils.py:1345-1346).  The last layer emits float32."""
    inp = x
    layers = p["layers"]
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for i, layer in enumerate(layers):
        if i in skips:
            # the factor in the activations' dtype, as JAX's weak-typed scalar
            x = torch.cat([x, inp.to(x.dtype)], dim=-1) * torch.tensor(inv_sqrt2, dtype=x.dtype)
        last = i == len(layers) - 1
        x = linear_apply(layer, x, bf16=bf16, keep_bf16=bf16_act and not last)
        if not last:
            x = softplus100(x)
    return x
