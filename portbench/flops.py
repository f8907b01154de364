"""The benchmark's yardstick arithmetic: the cards' datasheet peaks, the
analytic FLOPs of a stage-1 train step and the roofline bound of a top-3
KNN launch.  Frozen copies of the port's ``utils/flops.py``
(``train_step_flops`` and what it calls) and of ``chip_smoke.py``'s
``knn_bound_ms``, so that a later change to the program cannot move the
yardstick."""
from __future__ import annotations

# NVIDIA's H100 SXM datasheet at its 700 W limit: the dense bf16 tensor-core
# rate (no sparsity), float32 outside the tensor cores, HBM3 bandwidth
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16=989e12, fp32=67e12, hbm=3.35e12),
}
KNN_OPS_PER_PAIR = 7    # a (point, vertex) pair: 3 differences, 3 products (2 fused), compare


def embed_dim(d: int, multires: int) -> int:
    return d + d * 2 * multires


def mlp_flops(dims) -> int:
    """2 x the matmul sizes of an MLP with layer widths [d0, d1, ...]."""
    return int(sum(2 * a * b for a, b in zip(dims, dims[1:])))


def train_step_flops(xyz_res: int, sdf_res: int, view_res: int, cond_dim: int,
                     feat_dim: int, n_points: int, n_verts: int) -> int:
    """FLOPs of one stage-1 train step over ``n_points`` samples: the KNN
    distances once (8 a vertex); the residual and SDF MLPs 6 times (the
    forward, the spatial gradient's backward, and the reverse pass over
    both at twice a forward each); the render MLP 3 times (forward and its
    reverse pass).  The encodings' trig and the gathers are not counted."""
    resd = mlp_flops([embed_dim(3, xyz_res) + cond_dim] + [256] * 8 + [3])
    sdf = mlp_flops([embed_dim(3, sdf_res)] + [256] * 8 + [1 + feat_dim])
    in0 = 3 + feat_dim + embed_dim(3, view_res)
    render = 2 * (in0 * 256 + 2 * 256 * 256 + (256 + cond_dim) * 256 + 256 * 3)
    return n_points * (8 * n_verts + 6 * (resd + sdf) + 3 * render)


def knn_bound_s(P: int, N: int, peaks: dict) -> float:
    """The least time a top-3 KNN launch of P points against N vertices
    can take: 7 float32 operations a pair at the float32 peak, against 12
    bytes a point and 12 a vertex in and 24 a point out at the HBM
    bandwidth; the larger of the two."""
    ops = KNN_OPS_PER_PAIR * P * N
    nbytes = 12 * P + 12 * N + 24 * P
    return max(ops / peaks["fp32"], nbytes / peaks["hbm"])


def union_s(spans) -> float:
    """Length of the union of (start, end) intervals (any unit)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def linear_flops(shapes) -> int:
    """2 x in x out summed over a network's linear layers, from their (in,
    out) weight shapes: the FLOPs of one row through it."""
    return int(sum(2 * i * o for i, o in shapes))
