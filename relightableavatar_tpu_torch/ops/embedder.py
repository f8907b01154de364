"""NeRF positional encoding (``relightableavatar_tpu/ops/embedder.py``).

Layout per frequency i: [sin(fi*x), sin(fi*y), sin(fi*z), cos(fi*x),
cos(fi*y), cos(fi*z)], after the raw input (reference
``lib/networks/embedder.py:12-37``); checkpoint import depends on it.
"""
from __future__ import annotations

import torch


def embed_dim(input_dims: int, multires: int, retain_input: bool = True) -> int:
    return multires * 2 * input_dims + (input_dims if retain_input else 0)


def positional_encoding(x: torch.Tensor, multires: int,
                        retain_input: bool = True) -> torch.Tensor:
    """x: (..., D) -> (..., D + multires*2*D)."""
    if multires <= 0:
        return x if retain_input else x[..., :0]
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                        # (..., L, D)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)    # (..., L, 2, D)
    enc = enc.reshape(*x.shape[:-1], multires * 2 * x.shape[-1])
    if retain_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
