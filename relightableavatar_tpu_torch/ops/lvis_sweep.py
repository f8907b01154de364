"""Slice-sweep light visibility (``relightableavatar_tpu/ops/lvis_sweep.py``).

For every voxel of the baked SDF grid (``ops/sdf_grid.py``) and every
distant light direction d, the DFSS cone ratio

    r(x, d) = min_{k >= 1} clip(sdf(x + k h d), 0) / max(k h, near)

comes from one backward recurrence over the grid's slices along d's
dominant axis, carrying three (s, t) pairs per cell (the minimisers of the
ratio at the current origin, of s, and of the ratio at a middle horizon).
Surface points then read lvis with one trilinear lookup of the volume
instead of tracing P x L shadow rays; the cone factor is applied there:
``occ = clip(r * tan_i / 2, 0, 1)``.

The JAX package shifts the carried state between slices with per-direction
permutation matrices (Bresenham-quantised integer shifts) and samples the
first ``M`` steps with exact bilinear operators, both as matmuls.  Here the
shifts are index gathers: an integer shift is exact (the permutation
product adds only zeros to the one picked value, so both give the same
float), and the bilinear shifts sum the same two weighted taps per axis.
No matmul runs in the sweep, so TF32 cannot touch the ``BIG = 1e6`` pad
it carries.  The in-range weights ``wsum`` are exact elementwise arithmetic
(a ones field pushed through the shifts is what the JAX docstring warns
against).  The direction grouping is static numpy; each group's S - 1
slice steps are a Python loop.
"""
from __future__ import annotations

import numpy as np
import torch

from relightableavatar_tpu_torch.device import to_device

BIG = 1e6
PREFIX = 3          # M: leading samples of each ray taken with exact bilinear shifts


def _shift(F: torch.Tensor, off: torch.Tensor, dim: int) -> torch.Tensor:
    """Integer shift with zero fill along ``dim`` (-2 or -1) of
    F (..., Lg, R1, R2): ``out[.., l, i] = F[.., l, i + off[.., l]]``, zero
    where ``i + off`` leaves [0, R).  ``off`` (..., Lg) integer."""
    R = F.shape[dim]
    idx = torch.arange(R, device=F.device) + off[..., None]          # (..., Lg, R)
    ok = (idx >= 0) & (idx < R)
    idx = idx.clamp(0, R - 1)
    if dim == -2:
        idx, ok = idx[..., :, None], ok[..., :, None]
    else:
        idx, ok = idx[..., None, :], ok[..., None, :]
    g = torch.gather(F, dim, idx.expand(F.shape))
    return torch.where(ok, g, torch.zeros((), dtype=F.dtype, device=F.device))


def _bilinear_shift(F: torch.Tensor, d: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift by a fractional ``d`` (..., Lg) along ``dim``: the two taps of
    the JAX operator ``clip(1 - |j - i - d|, 0, 1)``, zero outside."""
    j0 = torch.floor(d)
    w0 = torch.clamp(1.0 - torch.abs(j0 - d), 0.0, 1.0)[..., None, None]
    w1 = torch.clamp(1.0 - torch.abs(j0 + 1.0 - d), 0.0, 1.0)[..., None, None]
    j0 = j0.to(torch.int64)
    return w0 * _shift(F, j0, dim) + w1 * _shift(F, j0 + 1, dim)


def _in_range(drift_floor: torch.Tensor, R: int) -> torch.Tensor:
    """(Lg, R) float: 1 where row i + floor(drift) lies in [0, R)."""
    i = torch.arange(R, device=drift_floor.device, dtype=drift_floor.dtype)[None, :]
    m = drift_floor[:, None]
    return ((i + m >= 0) & (i + m < R)).to(torch.float32)


def _frac_wsum(drift: torch.Tensor, R: int, k: int) -> torch.Tensor:
    """Exact row weight (Lg, R) of the bilinear shift by ``k * drift``."""
    i = torch.arange(R, device=drift.device, dtype=torch.float32)[None, :]
    pos = i + (k * drift)[:, None]
    j0 = torch.floor(pos)
    f = pos - j0
    in0 = ((j0 >= 0) & (j0 < R)).to(torch.float32)
    in1 = ((j0 + 1 >= 0) & (j0 + 1 < R)).to(torch.float32)
    return (1.0 - f) * in0 + f * in1


def _canonical_sweep(grid_c: torch.Tensor, drift_b: torch.Tensor,
                     drift_c: torch.Tensor, h: torch.Tensor,
                     near_offset: float) -> torch.Tensor:
    """Sweep rays marching toward +axis0 of ``grid_c`` (S, R1, R2).
    drift_b/drift_c (Lg,): in-plane index drift per slice step; h (Lg,):
    world step length.  Returns the ratio volume (S, Lg, R1, R2)."""
    S_, R1, R2 = grid_c.shape
    Lg = drift_b.shape[0]
    n_steps = S_ - 1
    dev = grid_c.device
    h = h.to(torch.float32).reshape(Lg, 1, 1)
    M = min(PREFIX, n_steps)

    # Bresenham schedule: at step k the state shifts by floor(drift) plus
    # floor(k frac) - floor((k-1) frac)
    mb_, mc_ = torch.floor(drift_b), torch.floor(drift_c)
    inb0, inb1 = _in_range(mb_, R1), _in_range(mb_ + 1, R1)
    inc0, inc1 = _in_range(mc_, R2), _in_range(mc_ + 1, R2)
    k = torch.arange(1, n_steps + 1, device=dev, dtype=torch.float32)[:, None]
    fb = (drift_b - mb_)[None, :]
    fc = (drift_c - mc_)[None, :]
    maskb = torch.floor(k * fb) - torch.floor((k - 1) * fb)          # (steps, Lg)
    maskc = torch.floor(k * fc) - torch.floor((k - 1) * fc)
    mb_i, mc_i = mb_.to(torch.int64), mc_.to(torch.int64)

    # exact-prefix samples at t = k h, k = 1..M: bilinear shifts by k * drift
    kk = torch.arange(1, M + 1, device=dev, dtype=torch.float32)[:, None]
    db, dc = kk * drift_b[None, :], kk * drift_c[None, :]           # (M, Lg)
    pad_fs = torch.stack([
        (1.0 - _frac_wsum(drift_b, R1, j)[:, :, None]
         * _frac_wsum(drift_c, R2, j)[:, None, :]) * BIG
        for j in range(1, M + 1)])                                  # (M, Lg, R1, R2)
    ex_t = [h * float(j + 1) for j in range(M)]                     # (Lg, 1, 1) each

    def ratio(s, t):
        return torch.clamp(s, min=0.0) / torch.clamp(t, min=near_offset)

    d_mid = torch.clamp(h, min=near_offset) * (0.5 * n_steps)

    def argmin_pair(keys, cs, ct):
        """(s, t) of the first candidate with the smallest key."""
        best = torch.amin(keys, dim=0)
        s, t = cs[-1], ct[-1]
        for i in range(keys.shape[0] - 2, -1, -1):
            pick = keys[i] == best
            s = torch.where(pick, cs[i], s)
            t = torch.where(pick, ct[i], t)
        return s, t

    shape = (Lg, R1, R2)
    big = torch.full(shape, BIG, device=dev)
    one = torch.ones(shape, device=dev)
    # carried pairs, stacked: [As, At, Bs, Bt, Cs, Ct]
    state = torch.stack([big, one, big, one, big, one])
    gp = [torch.full((R1, R2), BIG, device=dev) for _ in range(M - 1)]
    out = torch.empty((S_, Lg, R1, R2), device=dev)
    out[S_ - 1] = BIG                                  # the far slice: unoccluded
    for n in range(n_steps):
        g_next = grid_c[S_ - 1 - n]
        mb, mc = maskb[n], maskc[n]
        sh = _shift(_shift(state, mb_i + mb.to(torch.int64), -2),
                    mc_i + mc.to(torch.int64), -1)
        wb = inb0 + mb[:, None] * (inb1 - inb0)
        wc = inc0 + mc[:, None] * (inc1 - inc0)
        wsum = wb[:, :, None] * wc[:, None, :]
        pad = (1.0 - wsum) * BIG
        tfix = (1.0 - wsum) + h

        raw = torch.stack([g_next] + gp).unsqueeze(1).expand(M, Lg, R1, R2)
        ex_s = _bilinear_shift(_bilinear_shift(raw, db, -2), dc, -1) + pad_fs

        cs = torch.stack([ex_s[M - 1], sh[0] + pad, sh[2] + pad, sh[4] + pad])
        ct = torch.stack([ex_t[M - 1].expand(shape), sh[1] + tfix, sh[3] + tfix,
                          sh[5] + tfix])
        keys_a = ratio(cs, ct)
        As, At = argmin_pair(keys_a, cs, ct)
        Bs, Bt = argmin_pair(cs, cs, ct)
        Cs, Ct = argmin_pair(torch.clamp(cs, min=0.0)
                             / torch.clamp(ct + d_mid, min=near_offset), cs, ct)
        state = torch.stack([As, At, Bs, Bt, Cs, Ct])

        # output: the exact prefix (k < M) and the candidates, leaving out
        # samples inside the self-occlusion guard t < near
        r_all = [torch.where(ct >= near_offset, keys_a, BIG)]
        for j in range(M - 1):
            r_all.append(torch.where(ex_t[j] >= near_offset, ratio(ex_s[j], ex_t[j]),
                                     BIG)[None])
        r_out = torch.clamp(torch.amin(torch.cat(r_all), dim=0), max=BIG)
        out[S_ - 2 - n] = r_out
        gp = [g_next] + gp[:-1] if M > 1 else gp
    return out


@torch.no_grad()
def sweep_ratio_volume(grid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                       dirs: np.ndarray, near_offset: float) -> torch.Tensor:
    """grid (Rx, Ry, Rz) world-space SDF over [lo, hi]; dirs (L, 3) unit
    directions from the surface toward the light, static numpy (they set
    the grouping by dominant axis).  Returns the ratio volume
    (Rx, Ry, Rz, L) float32."""
    dev = grid.device
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev).reshape(3)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev).reshape(3)
    dirs = np.asarray(dirs, np.float32).reshape(-1, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    res = grid.shape
    voxel = (hi - lo) / (to_device(res, dev, torch.float32) - 1)

    a_dom = np.argmax(np.abs(dirs), axis=-1)
    sgn_dom = np.where(np.take_along_axis(dirs, a_dom[:, None], 1)[:, 0] >= 0, 1.0, -1.0)
    vols, id_chunks = [], []
    for a in range(3):
        for sgn in (1.0, -1.0):
            ids = np.nonzero((a_dom == a) & (sgn_dom == sgn))[0]
            if len(ids) == 0:
                continue
            b, c = [ax for ax in range(3) if ax != a]
            g = grid.permute(a, b, c)
            if sgn < 0:
                g = g.flip(0)
            d_g = to_device(dirs[ids], dev)
            # one voxel along a per slice step (toward +axis0 after the
            # flip); in-plane drift in index units
            h = voxel[a] / torch.abs(d_g[:, a])
            drift_b = d_g[:, b] / torch.abs(d_g[:, a]) * voxel[a] / voxel[b]
            drift_c = d_g[:, c] / torch.abs(d_g[:, a]) * voxel[a] / voxel[c]
            vol = _canonical_sweep(g.contiguous(), drift_b, drift_c, h,
                                   float(near_offset))          # (S, Lg, R1, R2)
            if sgn < 0:
                vol = vol.flip(0)
            inv = np.argsort([a, b, c])
            vols.append(vol.permute(*[int(x) for x in np.array([0, 2, 3])[inv]], 1))
            id_chunks.append(ids)
    order = to_device(np.argsort(np.concatenate(id_chunks)), dev)
    return torch.cat(vols, dim=-1)[..., order].contiguous()


def query_ratio_volume(vol: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                       pts: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup of the ratio volume: (P, 3) -> (P, L)."""
    Rx, Ry, Rz = vol.shape[:3]
    L = vol.shape[-1]
    flat = vol.reshape(Rx * Ry * Rz, L)
    res = to_device([Rx, Ry, Rz], pts.device, pts.dtype)
    f = (pts - lo) / (hi - lo) * (res - 1)
    f = torch.minimum(torch.clamp(f, min=0.0), res - 1 - 1e-4)
    b = torch.floor(f)
    t = f - b
    b = b.to(torch.int64)
    ix, iy, iz = b[:, 0], b[:, 1], b[:, 2]
    tx, ty, tz = t[:, 0:1], t[:, 1:2], t[:, 2:3]

    def at(dx, dy, dz):
        return flat[((ix + dx) * Ry + (iy + dy)) * Rz + (iz + dz)]   # (P, L)

    c00 = at(0, 0, 0) * (1 - tx) + at(1, 0, 0) * tx
    c10 = at(0, 1, 0) * (1 - tx) + at(1, 1, 0) * tx
    c01 = at(0, 0, 1) * (1 - tx) + at(1, 0, 1) * tx
    c11 = at(0, 1, 1) * (1 - tx) + at(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz
