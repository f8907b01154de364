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

The initialisers (:func:`linear_init`, :func:`mlp_init`, :func:`ssdf_init`,
:func:`to_weight_norm`) follow the JAX package's layouts and formulas; they
draw from an explicit ``torch.Generator``, so their values are the port's own.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ init
def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def to_weight_norm(p: dict) -> dict:
    """Split ``w`` (in, out) into ``v = w`` and ``g = ||w||`` over the input
    dim, as torch's ``weight_norm`` on the (out, in) weight."""
    w = p["w"]
    return {"v": w, "g": torch.linalg.vector_norm(w, dim=0), "b": p["b"]}


def linear_init(gen: torch.Generator, d_in: int, d_out: int, weight_norm: bool = False,
                w_init: str = "torch") -> dict:
    """``nn.Linear``'s initialisation (kaiming-uniform over fan_in), or
    ``kaiming_normal`` weights (std sqrt(2 / fan_in)) with the same bias."""
    bound = 1.0 / math.sqrt(d_in)
    if w_init == "torch":
        w = _uniform(gen, (d_in, d_out), bound)
    elif w_init == "kaiming_normal":
        w = torch.randn((d_in, d_out), generator=gen) * math.sqrt(2.0 / d_in)
    else:
        raise ValueError(w_init)
    p = {"w": w, "b": _uniform(gen, (d_out,), bound)}
    return to_weight_norm(p) if weight_norm else p


def mlp_init(gen: torch.Generator, input_ch: int, W: int = 256, D: int = 8,
             out_ch: int = 257, skips: Sequence[int] = (4,), weight_norm: bool = False,
             w_init: str = "torch", zero_out_bias: bool = False) -> dict:
    """Reference MLP (net_utils.py:1242-1262): D + 1 linears, the input
    concatenated before layer i for i in ``skips``; ``zero_out_bias`` zeroes
    the last bias (ResidualDeformation, base_network.py:32)."""
    layers = []
    for i in range(D + 1):
        d_in = input_ch if i == 0 else W
        if i in skips:
            d_in = input_ch + W
        layers.append(linear_init(gen, d_in, out_ch if i == D else W,
                                  weight_norm=weight_norm, w_init=w_init))
    if zero_out_bias:
        layers[-1]["b"] = torch.zeros_like(layers[-1]["b"])
    return {"layers": layers}


def ssdf_init(gen: torch.Generator, d_in: int, d_hidden: int = 256, n_layers: int = 8,
              d_out: int = 257, skips: Sequence[int] = (4,), bias: float = 0.5) -> dict:
    """IDR geometric initialisation with weight norm (reference
    net_utils.py:1276-1334): the layer before a skip emits d_hidden - d_in;
    the first layer reads only xyz (its positional-encoding rows are zero),
    the skip layer's encoding rows are zero, and the last layer starts near
    sqrt(pi / d_in) with bias -``bias``, so the field starts as a sphere
    around the origin (nominal radius ``bias``; the softplus units move the
    zero level inward, to about 0.3 at ``bias`` 0.5)."""
    dims = [d_in] + [d_hidden] * n_layers + [d_out]
    layers = []
    for l in range(len(dims) - 1):
        i_dim = dims[l]
        o_dim = dims[l + 1] - dims[0] if l + 1 in skips else dims[l + 1]
        if l == len(dims) - 2:
            w = (torch.randn((i_dim, o_dim), generator=gen) * 1e-4
                 + math.sqrt(math.pi) / math.sqrt(i_dim))
            b = torch.full((o_dim,), -float(bias))
        elif l == 0:
            w = torch.zeros((i_dim, o_dim))
            w[:3, :] = torch.randn((3, o_dim), generator=gen) * (math.sqrt(2) / math.sqrt(o_dim))
            b = torch.zeros((o_dim,))
        else:
            w = torch.randn((i_dim, o_dim), generator=gen) * (math.sqrt(2) / math.sqrt(o_dim))
            if l in skips:
                w[-(dims[0] - 3):, :] = 0.0     # the skip input's encoding rows
            b = torch.zeros((o_dim,))
        layers.append(to_weight_norm({"w": w, "b": b}))
    return {"layers": layers}


def fold_weight_norm(p: dict) -> torch.Tensor:
    """The (in, out) weight of a linear layer, folding weight norm (norm over
    the input dim, per output unit, as torch's ``weight_norm`` on (out, in))."""
    if "v" in p:
        v = p["v"]
        return v * (p["g"] / (torch.linalg.vector_norm(v, dim=0) + 1e-12))
    return p["w"]


class _Bf16MatMul(torch.autograd.Function):
    """bfloat16 x (N, I) @ bfloat16 w (I, O) -> float32 on CUDA, with the
    cotangents the JAX transpose rule gives: for the input, the float32
    cotangent times the bfloat16 weight in float32, rounded to bfloat16; for
    the weight, the bfloat16 input transposed times the float32 cotangent in
    float32, rounded to bfloat16 (the cast that made ``wb`` takes it back to
    float32).  The backward is made of differentiable ops, so it can itself
    be differentiated (``create_graph=True``: the eikonal terms back-propagate
    through the normals' backward)."""

    @staticmethod
    def forward(ctx, xb, wb):
        ctx.save_for_backward(xb, wb)
        return torch.mm(xb, wb, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ wb.float().T).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            gw = (xb.float().T @ g).to(torch.bfloat16)
        return gx, gw


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
