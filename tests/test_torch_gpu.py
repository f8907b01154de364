"""Tests that need a CUDA device: the Hopper top-3 KNN kernel against its
plain version on the card, and the relight render on the card.  They skip
with a reason where torch finds no CUDA device; on the card run them with
``python -m pytest -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.eval.knn_cases import KNN_CASE_NAMES, knn_cases
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.ops.knn import knn_top3_reference
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch finds none")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    cfg = golden.fixture_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device=cuda)
    return cfg, ctx, params, mcfg


@pytest.fixture(scope="module")
def cases(scene):
    _, ctx, _, _ = scene
    return {name: (p, v) for name, p, v in knn_cases(ctx["pverts"], np.random.default_rng(1))}


@pytest.mark.parametrize("case", KNN_CASE_NAMES)
def test_kernel_equals_plain_version(cases, case):
    pts, verts = cases[case]
    n0 = knn_cuda.KNN_TOP3.launches
    d2, idx = knn_cuda.knn_top3_cuda(pts, verts)
    torch.cuda.synchronize()
    assert knn_cuda.KNN_TOP3.launches == n0 + 1
    rd2, ridx = knn_top3_reference(pts, verts)
    # same arithmetic, no FMA contraction, same tie rule: bit-identical
    assert torch.equal(d2, rd2) and torch.equal(idx, ridx)


def test_kernel_ragged_vertex_count_and_ties(scene):
    _, ctx, _, _ = scene
    verts = ctx["pverts"]
    vdup = torch.cat([verts[:2049], verts[:2049]]).contiguous()   # exact ties, resident
    pts = verts[::7].contiguous()
    d2, idx = knn_cuda.knn_top3_cuda(pts, vdup)
    rd2, ridx = knn_top3_reference(pts, vdup)
    assert torch.equal(d2, rd2) and torch.equal(idx, ridx)


def test_golden_bundle_on_the_card(scene):
    _, ctx, params, mcfg = scene
    out = golden.render_golden_bundle(ctx, params, mcfg, device=ctx["pverts"].device)
    assert golden.psnr(out.rgb_map.cpu().numpy(), np.load(golden.GOLDEN_RELIGHT_24)) >= 50.0


def test_frame_on_the_card_goes_through_the_kernel(scene):
    cfg, ctx, params, mcfg = scene
    renderer = SphereTracingRenderer(cfg, params, mcfg, device=ctx["pverts"].device)
    batch, mab = golden.frame_batch(ctx, 64, 64)
    n0 = knn_cuda.KNN_TOP3.launches
    out = renderer.render(batch)
    torch.cuda.synchronize()
    assert knn_cuda.KNN_TOP3.launches > n0
    assert out.rgb_map.shape == (int(mab.sum()), 3)
    assert torch.isfinite(out.rgb_map).all()
    assert bool(((out.acc_map >= 0) & (out.acc_map <= 1)).all())
    # the same frame with the plain KNN on the card gives the same pixels
    dispatch = anisdf.knn_top3
    anisdf.knn_top3 = knn_top3_reference
    try:
        plain = renderer.render(batch)
    finally:
        anisdf.knn_top3 = dispatch
    assert torch.equal(out.rgb_map, plain.rgb_map)
