"""The port's plain top-3 KNN against the JAX package's Pallas kernel (run
in interpret mode on the CPU) and against an f64 brute force, plus the
argument checks of the CUDA wrapper.

Inputs: fixture frame 0's posed vertices (6890) and 20k points made of
vertices plus N(0, 3 cm) noise.  Tolerance: d2 within 1e-6 absolute; idx
identical except at near ties (|d2_k - d2_k+1| <= 1e-6 * max(d2, 1e-6)),
which may differ on at most 0.01% of the points.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightableavatar_tpu.ops.pallas_knn import knn_pallas
from relightableavatar_tpu_torch.eval.golden import load_fixture
from relightableavatar_tpu_torch.ops.knn import knn_top3, knn_top3_reference
from relightableavatar_tpu_torch.ops.knn_cuda import knn_top3_cuda

D2_ATOL = 1e-6
NEAR_TIE = 1e-6
MAX_TIE_SHARE = 1e-4


@pytest.fixture(scope="module")
def cloud():
    ctx, _, _ = load_fixture(device="cpu")
    verts = ctx["pverts"].numpy()
    rng = np.random.default_rng(0)
    pts = (verts[rng.integers(0, len(verts), 20000)]
           + rng.normal(0, 0.03, (20000, 3))).astype(np.float32)
    return pts, verts


def _check(d2, idx, ref_d2, ref_idx):
    d2, idx = np.asarray(d2), np.asarray(idx)
    ref_d2, ref_idx = np.asarray(ref_d2), np.asarray(ref_idx)
    np.testing.assert_allclose(d2, ref_d2, atol=D2_ATOL, rtol=0)
    bad = (idx != ref_idx).any(axis=1)
    gaps = np.abs(np.diff(ref_d2, axis=1))
    tie = (gaps <= NEAR_TIE * np.maximum(ref_d2[:, 1:], 1e-6)).any(axis=1)
    assert not (bad & ~tie).any(), f"{int((bad & ~tie).sum())} points differ outside near ties"
    assert (bad & tie).mean() <= MAX_TIE_SHARE
    return float(bad.mean())


def test_plain_matches_pallas_interpret(cloud):
    pts, verts = cloud
    d2, idx = knn_top3_reference(torch.as_tensor(pts), torch.as_tensor(verts))
    pd2, pidx = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), interpret=True)
    _check(d2, idx, pd2, pidx)
    # same arithmetic and tie rule: the two should agree bit for bit
    assert (idx.numpy() == np.asarray(pidx)).all()


def test_plain_matches_f64_bruteforce(cloud):
    pts, verts = cloud
    d2, idx = knn_top3_reference(torch.as_tensor(pts), torch.as_tensor(verts))
    p64 = torch.as_tensor(pts, dtype=torch.float64)
    v64 = torch.as_tensor(verts, dtype=torch.float64)
    ref_d2, ref_idx = [], []
    for s in range(0, len(p64), 4096):
        D = ((p64[s:s + 4096, None, :] - v64[None]) ** 2).sum(-1)
        d, i = torch.topk(D, 3, dim=1, largest=False, sorted=True)
        ref_idx.append(i.numpy())
        ref_d2.append(d.numpy())
    share = _check(d2, idx, np.concatenate(ref_d2), np.concatenate(ref_idx))
    print(f"near-tie idx differences vs f64: {share:.4%} of points")


@pytest.mark.parametrize("P", [1, 511, 513])
def test_ragged_point_counts(cloud, P):
    pts, verts = cloud
    d2, idx = knn_top3_reference(torch.as_tensor(pts[:P]), torch.as_tensor(verts))
    assert d2.shape == (P, 3) and idx.shape == (P, 3)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    pd2, pidx = knn_pallas(jnp.asarray(pts[:P]), jnp.asarray(verts), interpret=True)
    _check(d2, idx, pd2, pidx)


def test_exact_ties_go_to_lowest_index(cloud):
    pts, verts = cloud
    vdup = np.concatenate([verts, verts])
    d2, idx = knn_top3_reference(torch.as_tensor(pts[:2048]), torch.as_tensor(vdup))
    N = len(verts)
    assert (idx[:, 0] < N).all() and (idx[:, 1] == idx[:, 0] + N).all()
    assert (d2[:, 0] == d2[:, 1]).all()
    pd2, pidx = knn_pallas(jnp.asarray(pts[:2048]), jnp.asarray(vdup), interpret=True)
    assert (idx.numpy() == np.asarray(pidx)).all()


def test_dispatch_takes_plain_version_on_cpu(cloud):
    pts, verts = cloud
    a = knn_top3(torch.as_tensor(pts[:300]), torch.as_tensor(verts))
    b = knn_top3_reference(torch.as_tensor(pts[:300]), torch.as_tensor(verts))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "device", "too_few"])
def test_cuda_wrapper_rejects_bad_arguments(case):
    pts = torch.zeros((16, 3))
    verts = torch.zeros((8, 3))
    if case == "dtype":
        pts, err, match = pts.double(), TypeError, "float32"
    elif case == "shape":
        pts, err, match = torch.zeros((16, 2)), ValueError, "shape"
    elif case == "contiguity":
        pts, err, match = torch.zeros((3, 16)).T, ValueError, "contiguous"
    elif case == "device":
        err, match = ValueError, "CUDA"
    else:
        verts, err, match = torch.zeros((2, 3)), ValueError, "CUDA|3 vertices"
    with pytest.raises(err, match=match):
        knn_top3_cuda(pts, verts)
