"""Sphere tracing over the HDQ world SDF (``relightableavatar_tpu/renderer/tracing.py``;
reference ``lib/networks/renderer/sphere_tracing_renderer.py:107-262``).

The fixed-iteration signed tracer with relax + offset stepping, sign-flip
surface refinement, closest-distance tracking, Claybook banding removal and
the DFSS cone occlusion ``d / (2 t tan)``; a Python loop over iterations.
Also the camera trace's conservative pre-march (``premarch_sdf_fn``) and
exact miss skip (:func:`sphere_trace_miss_skip`), which both march on a
conservative SDF lower bound.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from relightableavatar_tpu_torch.utils.profiling import host_sync


class STConfig(NamedTuple):
    """Sphere-tracing knobs (reference cfg.sphere_tracing / cfg.obj_lvis)."""
    iter: int = 16
    tan_i: float = 1000.0
    relax: float = 0.0
    offset: float = 0.02
    eps: float = 1e-8
    near_offset: float = 0.01
    shadow_skip_iter: int = 1
    tan_i_multiplier: float = 1.0
    clay_book: bool = True
    dist_th: float | None = None     # HDQ band override for shadow queries

    @classmethod
    def from_cfg(cls, node, clay_book: bool = True) -> "STConfig":
        return cls(iter=int(node.get('iter', 16)),
                   tan_i=float(node.get('tan_i', 1000.0)),
                   relax=float(node.get('relax', 0.0)),
                   offset=float(node.get('offset', 0.02)),
                   eps=float(node.get('eps', 1e-8)),
                   near_offset=float(node.get('near_offset', 0.01)),
                   shadow_skip_iter=int(node.get('shadow_skip_iter', 1)),
                   tan_i_multiplier=float(node.get('tan_i_multiplier', 1.0)),
                   clay_book=clay_book,
                   dist_th=node.get('dist_th', None))


@torch.no_grad()
def sphere_trace(sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                 ray_o: torch.Tensor, ray_d: torch.Tensor,
                 near: torch.Tensor, far: torch.Tensor, st: STConfig,
                 tan_i: torch.Tensor | float | None = None,
                 soft_shadow: bool = False,
                 premarch_sdf_fn: Callable | None = None,
                 premarch_iter: int = 0):
    """Trace P rays against a world-space SDF.

    ray_o/ray_d (P, 3); near/far (P,) or (P, 1); tan_i per-ray sharpness for
    soft shadows.  Returns (surf, edge, occ, st_t, ot_t): (P, 3) x2, (P, 1) x3.

    ``premarch_sdf_fn``/``premarch_iter`` (``tpu.surf_grid_iters``): first
    advance ``t`` by ``premarch_iter`` steps of ``max(lb, 0)`` on a
    conservative lower bound ``lb`` of the SDF (``grid_sdf_lower_bound``),
    which never crosses a true surface, clamped to [near, far]; the trace
    then starts there with a fresh state
    (``relightableavatar_tpu/renderer/tracing.py:95-105``).
    """
    P = ray_o.shape[0]
    ones = torch.ones((P, 1), dtype=ray_o.dtype, device=ray_o.device)
    near = near.reshape(P, 1) * ones
    far = far.reshape(P, 1) * ones

    if not soft_shadow:
        tan_i_val = ones * st.tan_i
    else:
        ti = tan_i if tan_i is not None else st.tan_i
        ti = ti.reshape(P, 1) if isinstance(ti, torch.Tensor) else ones * ti
        tan_i_val = st.tan_i_multiplier * ti

    tan = ones / tan_i_val
    eps = st.eps

    t = near
    if premarch_sdf_fn is not None:
        for _ in range(premarch_iter):
            d = premarch_sdf_fn(ray_o + t * ray_d)
            t = torch.minimum(torch.maximum(t + torch.clamp(d, min=0.0), near), far)
    d0 = ones * 1e9
    occ = ones
    st_t = far
    ot = far
    cd = ones * 1e9
    dt = ones * 1e9
    off = ones * st.offset
    rlx = ones * st.relax

    for i in range(st.iter):
        d1 = sdf_fn(ray_o + t * ray_d)                       # (P, 1)
        counts = i >= st.shadow_skip_iter

        if soft_shadow and st.clay_book:
            # Claybook banding removal (reference :157-172)
            dx0 = d0 + rlx * d0 + off
            dx1 = d1 + rlx * d1 + off
            dy = (dx1 ** 2) / (2 * dx0)
            dx = (torch.sqrt(torch.clamp(dx1 ** 2 - dy ** 2, min=0.0)) - off) / (1 + rlx)
            cls = (torch.clamp(dx, min=0.0)
                   / torch.clamp(torch.maximum(t - dy, near), min=eps) / (tan * 2))
            msk = ((cls < occ) & counts & (dy < t) & (dx1 > 0) & (dx0 > 0)
                   & (dx > 0) & (dy > 0) & (dy < dx0) & torch.isfinite(cls))
            ot = torch.where(msk, t - dy, ot)
            occ = torch.where(msk, cls, occ)

        # DFSS cone occlusion (reference :175-179)
        cls = torch.clamp(d1, min=0.0) / torch.clamp(torch.maximum(t, near), min=eps) / (tan * 2)
        msk = (cls < occ) & counts
        ot = torch.where(msk, t, ot)
        occ = torch.where(msk, cls, occ)

        if not soft_shadow:
            d1_udf = torch.abs(d1)
            d0_udf = torch.abs(d0)
            # sign-flip linear-interp surface refinement (reference :187-191)
            msk = torch.sign(d0) != torch.sign(d1)
            interp = t - dt * torch.clamp(d1_udf / (d0_udf + d1_udf + eps), 0.0, 1.0)
            st_t = torch.where(msk, interp, st_t)
            off = torch.where(msk, torch.zeros_like(off), off)
            rlx = torch.where(msk, torch.zeros_like(rlx), rlx)
            # closest-distance tracking (reference :194-197)
            msk = d1_udf < cd
            cd = torch.where(msk, d1_udf, cd)
            st_t = torch.where(msk, t, st_t)

        # relax + offset stepping (reference :200-207)
        dt = d1 + rlx * d1 + off
        t = torch.maximum(torch.minimum(t + dt, far), near)
        d0 = d1

    surf = ray_o + st_t * ray_d
    edge = ray_o + ot * ray_d
    return surf, edge, occ, st_t, ot


@torch.no_grad()
def safe_miss_march(lb_fn, ray_o, ray_d, near, far, tan_i: float,
                    margin: float = 0.01, iters: int = 32) -> torch.Tensor:
    """March every ray on a conservative SDF lower bound with step
    ``max(d_lb - m(t), 0)``, ``m(t) = margin + 2 t / tan_i``; (P,) bool
    marking the rays proven to be clean misses: they covered [near, far]
    with the margin intact, so the exact tracer's DFSS ``cls`` stays >= 1
    along them (the proof is in :func:`sphere_trace_miss_skip`)."""
    P = ray_o.shape[0]
    near = near.reshape(P, 1)
    far = far.reshape(P, 1)
    m_slope = 2.0 / tan_i
    t = near
    for _ in range(iters):
        d = lb_fn(ray_o + t * ray_d)
        m = margin + t * m_slope
        t = torch.minimum(t + torch.clamp(d - m, min=0.0), far)
    return t[:, 0] >= far[:, 0] - 1e-6


@torch.no_grad()
def sphere_trace_miss_skip(sdf_fn, lb_fn, ray_o, ray_d, near, far, st: STConfig,
                           skip_iter: int = 32, margin: float = 0.01):
    """Camera-ray trace that skips the rays a lower-bound march proves to
    miss (``relightableavatar_tpu/renderer/tracing.py:197-285``).

    ``lb_fn`` <= the true SDF (``grid_sdf_lower_bound``), so every stepped
    segment [t, t + d_lb - m] has d_true >= m(t) along it (1-Lipschitz).  A
    ray that covers [near, far] that way keeps ``cls = d tan_i / (2 t) >= 1``
    wherever the exact tracer could sample, so its exact result is occ = 1:
    every map of it is zero after the renderer's hit and acc masking.  Those
    rays report the clean-miss state (st = ot = far, occ = 1); the others
    are compacted and traced from their original ``near`` with the full
    ``st`` budget.  Each ray's trace is independent of the others, so this
    equals the JAX package's sorted sub-block skip up to float
    reassociation in the batched MLPs.  Returns the tuple of
    :func:`sphere_trace`."""
    P = ray_o.shape[0]
    near = near.reshape(P, 1)
    far = far.reshape(P, 1)
    miss = safe_miss_march(lb_fn, ray_o, ray_d, near, far, st.tan_i, margin, skip_iter)
    end = ray_o + far * ray_d
    surf, edge = end.clone(), end.clone()
    occ = torch.ones_like(far)
    st_t, ot_t = far.clone(), far.clone()
    host_sync("miss_skip_nonzero")
    sel = torch.nonzero(~miss).squeeze(1)
    if sel.numel():
        res = sphere_trace(sdf_fn, ray_o[sel], ray_d[sel], near[sel], far[sel], st,
                           soft_shadow=False)
        for dst, src in zip((surf, edge, occ, st_t, ot_t), res):
            dst[sel] = src
    return surf, edge, occ, st_t, ot_t


@torch.no_grad()
def softer_shadow(sdf_fn, ray_o, ray_d, near, far, st: STConfig, tan_i=None):
    """Inverse-sqrt-stepping DFSS tracer (reference :219-262)."""
    P = ray_o.shape[0]
    ones = torch.ones((P, 1), dtype=ray_o.dtype, device=ray_o.device)
    near = near.reshape(P, 1) * ones
    far = far.reshape(P, 1) * ones
    ti = tan_i if tan_i is not None else st.tan_i
    ti = ti.reshape(P, 1) if isinstance(ti, torch.Tensor) else ones * ti
    tan = ones / ti
    eps = st.eps

    t, occ = near, ones
    for _ in range(st.iter):
        h = sdf_fn(ray_o + t * ray_d) + t * tan
        occ = torch.minimum(occ, torch.clamp(h, min=eps) / torch.clamp(t, min=eps) / (2 * tan))
        t = t + h * torch.rsqrt(t + 1)
        t = torch.minimum(torch.maximum(t, near), far)
    edge = ray_o + t * ray_d
    return edge, edge, occ, t, t
