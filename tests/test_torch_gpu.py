"""Tests that need a CUDA device: the Hopper top-3 KNN kernel against its
plain version on the card, the relight render on the card, the slice sweep
and the bfloat16 MLP route on the card against the CPU, the bench-stack
golden, and the novel-light sweep, the ground frame and the volume frame
on the card against the CPU.  They skip with a reason where torch finds no CUDA device; on the
card run them with ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.eval.knn_cases import KNN_CASE_NAMES, knn_cases
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.ops import mlp
from relightableavatar_tpu_torch.ops.knn import knn_top3_reference
from relightableavatar_tpu_torch.data.datasets import load_lighting
from relightableavatar_tpu_torch.renderer.orchestrate import (NovelLightRenderer,
                                                             SphereTracingRenderer)

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


def test_sweep_on_the_card_equals_the_cpu(scene):
    """The bench-stack frame's sweep volume (48-node grid, 8x16 directions)
    on the card against the same sweep of the same grid on the CPU: no
    matmul runs in it, so no TF32 or reduced-precision path can enter
    (bar 1e-6 relative)."""
    _, ctx, params, mcfg = scene
    cfg = golden.benchstack_cfg()
    renderer = SphereTracingRenderer(cfg, params, mcfg, device=ctx["pverts"].device)
    gbox = renderer.grid_box(ctx)
    grid = renderer.bake_grid(ctx, gbox, packed=False)
    vol = renderer.sweep_volume(grid, gbox)
    ref = renderer.sweep_volume(grid.cpu(), gbox.cpu())
    assert vol.shape == grid.shape + (128,)
    torch.testing.assert_close(vol.cpu(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("keep_bf16", [False, True], ids=["f32_out", "bf16_out"])
def test_bf16_route_on_the_card(cuda, keep_bf16):
    """``torch.mm(out_dtype=float32)`` on bfloat16 operands against the CPU
    route (operands rounded, multiplied in float32): the products are exact
    on both and only the order of the float32 sums differs, so each output
    lies within 1e-5 of the sum of its products' magnitudes; a bfloat16
    output may round one step (at most 2^-7 relative) apart.  The input gradient
    through the autograd function against the CPU autograd graph, held the
    same way."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(4099, 83)).astype(np.float32))
    # plain (in, out) weights: a weight-norm fold on each device can differ
    # by an ulp, which bfloat16 rounding would turn into a 2^-8 step
    p = {"w": torch.as_tensor(rng.normal(size=(83, 256)).astype(np.float32) / 9),
         "b": torch.as_tensor(rng.normal(size=256).astype(np.float32))}
    outs, grads = [], []
    for dev in ("cpu", cuda):
        xd = x.to(dev).requires_grad_(True)
        y = mlp.linear_apply({k: v.to(dev) for k, v in p.items()}, xd, bf16=True,
                             keep_bf16=keep_bf16)
        (g,) = torch.autograd.grad(y.float().square().sum(), xd)
        outs.append(y.detach().float().cpu())
        grads.append(g.cpu())
    w = p["w"].to(torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    # outputs: the sum order (1e-5 of the products' magnitudes), plus one
    # bfloat16 ulp (at most 2^-7 relative) where the output is rounded
    step = 2.0 ** -7 if keep_bf16 else 0.0
    bound_y = 1e-5 * (xb.abs() @ w.abs() + p["b"].abs()) + step * outs[0].abs()
    # gradients: the cotangent 2y carries twice the output's difference
    # through |w|, plus the sum order, plus the rounding to the input's bfloat16
    bound_g = ((2 * bound_y) @ w.abs().T + 1e-5 * ((2 * outs[0]).abs() @ w.abs().T)
               + 2.0 ** -7 * grads[0].abs())
    for got, ref, bound in ((outs[1], outs[0], bound_y), (grads[1], grads[0], bound_g)):
        err = (got - ref).abs()
        assert (err <= bound).all(), float((err / bound).max())


def test_benchstack_golden_on_the_card(cuda):
    img, n = golden.render_benchstack_64(device=cuda)
    ok, p = golden.check_golden(img)
    assert ok and p >= 45.0
    skip, n2 = golden.render_benchstack_64(device=cuda, cfg_overrides={'surf_miss_skip': True})
    assert n2 == n
    np.testing.assert_allclose(skip, img, atol=1e-5, rtol=0)


# the small frames on the card against the CPU: float32 both, TF32 off; the
# MLP sums run in another order, which a trace can turn into a changed
# silhouette pixel (chip_smoke.py's CARD_CPU_MIN_PSNR)
CARD_CPU_MIN_PSNR = 50.0


def _held(card: dict, cpu: dict, skip=("spec_map",)):
    assert set(card) == set(cpu)
    for k in cpu:
        assert card[k].shape == cpu[k].shape, k
        if k not in skip:
            assert golden.psnr(card[k], cpu[k]) >= CARD_CPU_MIN_PSNR, k


def test_sweep_on_the_card_equals_the_cpu(cuda):
    """The 32x32 bench-stack frame (48-node grid) with the 8 sweep lights
    through NovelLightRenderer on the card and on the CPU."""
    maps = []
    for dev in (cuda, "cpu"):
        cfg = golden.benchstack_cfg()
        cfg.vis_novel_light = True
        cfg.test_light = list(golden.SWEEP_LIGHTS)
        ctx, params, mcfg = golden.load_fixture(cfg, device=dev)
        batch, _ = golden.frame_batch(ctx, golden.CHECK_SIZE, golden.CHECK_SIZE)
        batch.novel_lights = load_lighting(cfg)
        out = NovelLightRenderer(cfg, params, mcfg, device=dev).render(batch)
        maps.append({f"{n} {k}": f[k].cpu().numpy() for n, f in out.novel_light.items()
                     for k in ('rgb_map', 'shade_map')})
    assert len(maps[1]) == 16
    _held(*maps)


def test_ground_frame_on_the_card_equals_the_cpu(cuda):
    card = golden.render_check_frame(golden.ground_check_cfg(), device=cuda)
    cpu = golden.render_check_frame(golden.ground_check_cfg(), device="cpu")
    assert card['rgb_map'].shape == (golden.CHECK_SIZE ** 2, 3) and (card['acc_map'] == 1).all()
    _held(card, cpu)


@pytest.mark.parametrize("cull", [0, 32])
def test_volume_frame_on_the_card_equals_the_cpu(cuda, cull):
    card = golden.render_check_frame(golden.volume_check_cfg(cull), device=cuda)
    cpu = golden.render_check_frame(golden.volume_check_cfg(cull), device="cpu")
    assert card['acc_map'].max() > 0.5
    _held(card, cpu, skip=())
