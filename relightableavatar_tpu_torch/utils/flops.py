"""Analytic FLOP counts and utilizations (``relightableavatar_tpu/utils/flops.py``).

The JAX package also reads XLA's cost model of a compiled step
(``compiled_cost``), which has no counterpart for eager torch: here it is a
logged no-op.  The achieved rate a log line prints is the analytic count
over the measured time; its ``mfu`` is that rate over the card's dense
bf16 peak where :data:`DEVICE_PEAKS` knows the card, and is left out
elsewhere (the CPU, another card): no TPU constant stands in.
"""
from __future__ import annotations

import torch

from relightableavatar_tpu_torch.ops.embedder import embed_dim
from relightableavatar_tpu_torch.utils.log import log

# peaks by ``torch.cuda.get_device_name``: NVIDIA's H100 datasheet for the
# SXM part at its 700 W limit, the dense bf16 tensor-core rate (no
# sparsity), FP32 outside the tensor cores and the HBM3 bandwidth.
# Datasheet figures, not measurements; a card set below 700 W runs below
# them.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16=989e12, fp32=67e12, hbm=3.35e12),
}


def device_peaks(device) -> dict | None:
    """The datasheet peaks of ``device``'s card (:data:`DEVICE_PEAKS`), or
    None for the CPU and for a card not in the table."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return DEVICE_PEAKS.get(torch.cuda.get_device_name(device))


def hbm_util(nbytes: float | None, seconds: float, bw: float | None) -> float | None:
    """HBM bandwidth utilization in percent (memory roofline); None without
    bytes, time or bandwidth."""
    if not nbytes or seconds <= 0 or not bw:
        return None
    return 100.0 * nbytes / seconds / bw


def mfu(flops: float | None, seconds: float, peak: float | None) -> float | None:
    """Model FLOP utilization in percent; None without FLOPs, time or peak."""
    if not flops or seconds <= 0 or not peak:
        return None
    return 100.0 * flops / seconds / peak


def rate_text(flops: float, seconds: float, peaks: dict | None, cards: int = 1) -> str:
    """A step's analytic TFLOP, its TFLOP/s and, with ``peaks``, its MFU
    against the dense bf16 peak of ``cards`` cards (the ranks that shared
    the step's FLOPs), as the trainer's log line prints them."""
    tf = flops / 1e12
    m = mfu(flops, seconds, peaks["bf16"] * cards) if peaks else None
    return (f"{tf:.3f} TFLOP/step (analytic) {tf / seconds:.2f} TFLOP/s"
            + (f" mfu {m:.1f}%" if m is not None else ""))


def compiled_cost(*args, **kwargs) -> dict:
    """XLA's cost model of a compiled function in the JAX package; nothing
    to read in torch: zeros, logged."""
    log("compiled_cost: no compiled cost model in torch; use the analytic counts", "yellow")
    return {'flops': 0.0, 'bytes': 0.0}


def mlp_flops(dims) -> int:
    """2 * sum of matmul sizes of an MLP with layer widths [d0, d1, ...]."""
    return int(sum(2 * a * b for a, b in zip(dims, dims[1:])))


def anisdf_hdq_flops(mcfg, n_points: int, n_verts: int) -> int:
    """FLOPs of n_points HDQ world-SDF queries: brute-force KNN distances
    (8 a vertex) + residual MLP (8x256) + SDF MLP (8x256) per query;
    encoding trig and gathers are not counted."""
    knn = 8 * n_verts
    resd = mlp_flops([embed_dim(3, mcfg.xyz_res) + mcfg.cond_dim] + [256] * 8 + [3])
    sdf = mlp_flops([embed_dim(3, mcfg.sdf_res)] + [256] * 8 + [1 + mcfg.feat_dim])
    return n_points * (knn + resd + sdf)


def render_net_flops(mcfg) -> int:
    """Matmul FLOPs of the render MLP a point (base_network.py:132-171)."""
    in0 = 3 + mcfg.feat_dim + embed_dim(3, mcfg.view_res)
    return 2 * (in0 * 256 + 2 * 256 * 256 + (256 + mcfg.cond_dim) * 256 + 256 * 3)


def train_step_flops(mcfg, n_points: int, n_verts: int) -> int:
    """Analytic FLOPs of one stage-1 train step over n_points samples: the
    KNN once; the residual and SDF MLPs 6 times (forward, the spatial
    gradient's backward, and the reverse pass over both at twice a
    forward each); the render MLP 3 times (forward and its reverse pass)."""
    hdq = anisdf_hdq_flops(mcfg, 1, n_verts) - 8 * n_verts
    return n_points * (8 * n_verts + 6 * hdq + 3 * render_net_flops(mcfg))


def relight_heads_flops(mcfg) -> int:
    """Matmul FLOPs of the albedo and roughness heads a point
    (relight_network.py:45-77)."""
    hidden = [mcfg.relight_width] * mcfg.relight_depth
    return mlp_flops([mcfg.feat_dim] + hidden + [3]) + mlp_flops([mcfg.feat_dim] + hidden + [1])


# operations of the shading a (ray, light texel) pair: the GGX microfacet
# BRDF (normalisations, the half vector, four dot products, Schlick's
# Fresnel, the GGX distribution and geometry terms, the Lambert term; ~90),
# the bilinear envmap lookup of the texel's direction (~40) and the shade
# and its sum over texels (~20)
SHADE_FLOPS = 150


def relight_step_flops(mcfg, n_rays: int, n_samples: int, n_lights: int, n_verts: int,
                       trace_iters: int, shadow_iters: int, shadow_rays: int) -> int:
    """Analytic FLOPs of one stage-2 train step over ``n_rays`` camera rays
    (all frames) that traced ``shadow_rays`` shadow rays.  HDQ queries
    count the KNN (8 a vertex) and the residual and SDF MLPs, on every
    query (the band holds a traced ray's queries but those of the first
    steps): the camera trace's ``trace_iters`` and the shadow trace's
    ``shadow_iters`` a ray, forward only; the edge and closest re-query, 2
    a ray, forward and reverse (3x the MLPs); the band forward of
    ``n_samples`` a ray as in the stage-1 step (the MLPs 6x) with the heads
    3x, and the jittered pair, the SDF MLP and the heads forward and
    reverse (3x); the shading of every (ray, texel) pair forward and
    reverse (3x :data:`SHADE_FLOPS`)."""
    knn = 8 * n_verts
    hdq = anisdf_hdq_flops(mcfg, 1, n_verts) - knn
    sdf = mlp_flops([embed_dim(3, mcfg.sdf_res)] + [256] * 8 + [1 + mcfg.feat_dim])
    heads = relight_heads_flops(mcfg)
    trace = (n_rays * trace_iters + shadow_rays * shadow_iters) * (knn + hdq)
    requery = 2 * n_rays * (knn + 3 * hdq)
    band = n_rays * n_samples * (knn + 6 * hdq + 3 * heads + 3 * (sdf + heads))
    return trace + requery + band + 3 * SHADE_FLOPS * n_rays * n_lights
