"""Analytic FLOP counts (``relightableavatar_tpu/utils/flops.py``).

The JAX package also reads XLA's cost model of a compiled step
(``compiled_cost``), which has no counterpart for eager torch: here it is a
logged no-op.  The achieved rate a log line prints is the analytic count
over the measured time; no peak of any device is assumed here.
"""
from __future__ import annotations

from relightableavatar_tpu_torch.ops.embedder import embed_dim
from relightableavatar_tpu_torch.utils.log import log


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
