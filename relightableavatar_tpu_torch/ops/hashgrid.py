"""Multi-resolution hash-grid encoding (Instant-NGP style) for ``e_type='hash'``
(``relightableavatar_tpu/ops/hashgrid.py``; reference ``HashEncoding``,
``lib/networks/embedder.py:40-214``, dormant in its live configs).

The layout and the two deliberate deviations from the reference are the JAX
package's: one flat ``(L, T*F)`` table, ``T = 2**log2_hashmap_size`` so the
modulo is a bitwise AND, the full trilinear weight x*y*z (the reference
drops z) and a border clamp of out-of-box queries.  Levels whose dense grid
fits the table index it directly; finer levels hash with the XOR-prime
spatial hash.  JAX hashes in int32 with wrapping multiplies; here the hash
is computed in int64, and the final ``& (T - 1)`` keeps the same low bits,
so the rows are the same.

Plain PyTorch: the JAX package runs no Pallas kernel here.  The table's
gradient is a scatter-add of the gathered rows: atomics on the card, so its
float32 summation order varies between runs, and the card's gradient is
held to the CPU's within 1e-5 of its largest entry
(``tests/test_torch_gpu.py``; the forward within 1e-6).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

# XOR-prime spatial hash constants (the reference's first three, p0 = 1)
_PRIMES = (1, 19349663, 83492791)

# 8 corner offsets of a unit cell, (dx, dy, dz) with dx major
_OFFSETS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), -1).reshape(8, 3)


# the canonical volume the grid spans, and the per-level resolution growth
BOUNDS = (-2.0, 2.0)
GROWTH = 1.38


class HashGridConfig(NamedTuple):
    """The grid's sizes; the defaults are the model's (``AniSDFConfig.hash_cfg``).
    Each level's F features are summed, and the normalised input comes
    first, as in the JAX package's only configuration."""
    n_levels: int = 16
    n_features: int = 2           # F per level
    log2_hashmap_size: int = 19   # T = 2**this
    base_resolution: int = 16

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(int(self.base_resolution * GROWTH ** i)
                     for i in range(self.n_levels))

    @property
    def out_dim(self) -> int:
        return 3 + self.n_levels


def hash_encoding_init(generator: torch.Generator, hcfg: HashGridConfig) -> torch.Tensor:
    """Kaiming-normal flat (L, T*F) float32 table drawn from ``generator``
    (a CPU generator); the entries of cell t of a level are at
    ``[t*F : t*F + F]``."""
    L, T, F = hcfg.n_levels, hcfg.table_size, hcfg.n_features
    std = float(np.sqrt(2.0 / T))
    return std * torch.randn((L, T * F), generator=generator, dtype=torch.float32)


def _trilerp_weight(frac: torch.Tensor, k: int) -> torch.Tensor:
    ox, oy, oz = (int(v) for v in _OFFSETS[k])
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    return ((fx if ox else 1.0 - fx) * (fy if oy else 1.0 - fy)
            * (fz if oz else 1.0 - fz))


def hash_encode(table: torch.Tensor, hcfg: HashGridConfig, xyz: torch.Tensor) -> torch.Tensor:
    """xyz (..., 3) -> (..., 3 + L): the input normalised to the grid's box,
    then per level the sum of its F features, each blended trilinearly from
    the 8 corners of the query's cell (a direct index where the level's r^3
    grid fits the table, the XOR-prime hash otherwise).  Every sum runs in
    the JAX package's order."""
    shape = xyz.shape
    x = xyz.reshape(-1, 3)
    lo, hi = BOUNDS
    xn = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    T = hcfg.table_size
    F = hcfg.n_features
    per_level = []                                    # (N,) a level
    for li, r in enumerate(hcfg.level_resolutions):
        dense = r ** 3 <= T
        flt = xn * float(r - 1)
        top = max(r - 2, 0) if dense else r - 1       # highest base index
        base = torch.clamp(torch.floor(flt).to(torch.int64), 0, top)
        frac = flt - base
        rows = table[li].reshape(T, F)
        feats = [torch.zeros_like(flt[:, 0]) for _ in range(F)]
        for k in range(8):
            c = [base[:, a] + int(_OFFSETS[k][a]) for a in range(3)]
            if dense:
                idx = (c[0] * r + c[1]) * r + c[2]
            else:
                c = [torch.clamp(ca, max=r - 1) for ca in c]
                idx = ((c[0] * _PRIMES[0]) ^ (c[1] * _PRIMES[1])
                       ^ (c[2] * _PRIMES[2])) & (T - 1)
            row = rows[idx]                           # (N, F)
            wk = _trilerp_weight(frac, k)
            for f in range(F):
                feats[f] = feats[f] + wk * row[:, f]
        acc = feats[0]
        for f in range(1, F):
            acc = acc + feats[f]
        per_level.append(acc)
    feat = torch.cat([xn, torch.stack(per_level, dim=1)], dim=-1)
    return feat.reshape(*shape[:-1], hcfg.out_dim)
