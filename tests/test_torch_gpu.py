"""Tests that need a CUDA device: the Hopper top-3 KNN kernel against its
plain version on the card, the relight render on the card, the slice sweep
and the bfloat16 MLP route on the card against the CPU, the bench-stack
golden, the bfloat16 weight gradient, K1 on the shadow rays' vertex
subsample, the grouped and bfloat16 KNN routes, the hash encoding, the
stage-1 train step, the
stage-2 bf16 step's gradients, the novel-light sweep, the ground frame, the volume frame,
``run -t evaluate`` and the mesh extraction on the card against the CPU, and
the kernel on a chunk of the 5 mm mesh grid.  They skip with a reason where torch finds no CUDA device; on the
card run them with ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from relightableavatar_tpu_torch.config import setup
from relightableavatar_tpu_torch.data import make_synthetic
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.eval.evaluator import Evaluator
from relightableavatar_tpu_torch.run import run_evaluate
from relightableavatar_tpu_torch.eval.knn_cases import KNN_CASE_NAMES, knn_cases, synthetic_points
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.data.datasets import make_dataset
from relightableavatar_tpu_torch.eval import mesh_check
from relightableavatar_tpu_torch.ops import knn as knn_mod
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


def test_kernel_on_the_subsample_cloud(scene):
    """K1 against the 2,048-vertex subsample of ``tpu.shadow_verts_sub`` at a
    shadow block's 32,768 points, bit for bit the plain version."""
    _, ctx, _, _ = scene
    sub = ctx["pverts"][ctx["knn_sub_ids"].long()].contiguous()
    assert sub.shape == (2048, 3)
    pts = synthetic_points(sub, 32768, np.random.default_rng(3))
    d2, idx = knn_cuda.knn_top3_cuda(pts, sub)
    rd2, ridx = knn_top3_reference(pts, sub)
    assert torch.equal(d2, rd2) and torch.equal(idx, ridx)


def test_grouped_and_select_on_the_card_equal_the_cpu(scene):
    """``knn_grouped`` and ``knn_select`` on the card against the CPU on
    8,192 points around the posed vertices: the same indices (the bfloat16
    matrix rounds after each op on both, and the sort is stable); the
    grouped d2, a sum of three squares that the HDQ does not read, within
    1e-6 relative (the card sums in another order)."""
    _, ctx, _, _ = scene
    pts = synthetic_points(ctx["pverts"], 8192, np.random.default_rng(4))
    keys = ("knn_gverts", "knn_gcent", "knn_gradius", "knn_gvid")
    d2, idx = knn_mod.knn_grouped(pts, *[ctx[k] for k in keys])
    cd2, cidx = knn_mod.knn_grouped(pts.cpu(), *[ctx[k].cpu() for k in keys])
    assert torch.equal(idx.cpu(), cidx)
    torch.testing.assert_close(d2.cpu(), cd2, rtol=1e-6, atol=0)
    sel = knn_mod.knn_select(pts, ctx["pverts"])
    assert torch.equal(sel.cpu(), knn_mod.knn_select(pts.cpu(), ctx["pverts"].cpu()))


def test_hash_encode_on_the_card_equals_the_cpu(cuda):
    """``hash_encode`` of the model's grid (``AniSDFConfig.hash_cfg``) on the
    card against the CPU: the forward within 1e-6; the table's gradient, a
    scatter-add with atomics whose float32 order varies, within 1e-5 of its
    largest entry."""
    from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
    from relightableavatar_tpu_torch.ops.hashgrid import hash_encode, hash_encoding_init
    hcfg = AniSDFConfig(e_type='hash').hash_cfg()
    table = hash_encoding_init(torch.Generator().manual_seed(0), hcfg)
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((65536, 3), generator=gen) * 4.4 - 2.2
    w = torch.randn((65536, hcfg.out_dim), generator=gen)
    outs, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        t = table.to(dev).requires_grad_(True)
        out = hash_encode(t, hcfg, x.to(dev))
        (out * w.to(dev)).sum().backward()
        outs.append(out.detach().cpu())
        grads.append(t.grad.cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)
    scale = float(grads[1].abs().max())
    assert scale > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-5 * scale)


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


def test_bf16_weight_gradient_on_the_card(cuda):
    """The bfloat16 linear layer's weight gradient on the card (the autograd
    function's ``xb^T g`` in float32, rounded to bfloat16) against the CPU
    route's: nonzero, each entry within one bfloat16 step (2^-7 relative)
    plus 1e-5 of the sum of its products' magnitudes; and through a double
    backward (the eikonal path: the input gradient's square differentiated
    with respect to the weight), cosine >= 0.999 to the CPU's."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(4099, 83)).astype(np.float32))
    w0 = torch.as_tensor(rng.normal(size=(83, 256)).astype(np.float32) / 9)
    b0 = torch.as_tensor(rng.normal(size=256).astype(np.float32))
    first, second = [], []
    for dev in ("cpu", cuda):
        w = w0.to(dev).requires_grad_(True)
        xd = x.to(dev).requires_grad_(True)
        y = mlp.linear_apply({"w": w, "b": b0.to(dev)}, xd, bf16=True)
        (gw,) = torch.autograd.grad(torch.tanh(y).sum(), w, retain_graph=True)
        first.append(gw.cpu())
        (gx,) = torch.autograd.grad(torch.tanh(y).sum(), xd, create_graph=True)
        (gw2,) = torch.autograd.grad(gx.square().sum(), w)
        second.append(gw2.cpu())
    gy = 1 - torch.tanh(mlp.linear_apply({"w": w0, "b": b0}, x, bf16=True)) ** 2
    bound = 2.0 ** -7 * first[0].abs() + 1e-5 * (x.to(torch.bfloat16).float().abs().T @ gy.abs())
    assert (first[1] != 0).all() and ((first[1] - first[0]).abs() <= bound).all()
    cos = torch.nn.functional.cosine_similarity(second[1].flatten(), second[0].flatten(), dim=0)
    assert (second[1] != 0).any() and float(cos) >= 0.999, float(cos)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_train_step_on_the_card_equals_the_cpu(cuda, bf16, tmp_path):
    """One stage-1 step (``eval/train_check.py``'s small step) on the card
    and on the CPU: float32, the loss within 1e-5 and each gradient within
    1e-4 of its largest entry; bf16 with the residual MLP's last weight
    re-drawn, every weight's gradient nonzero and its cosine >= 0.999 to
    the CPU's.  The card's step launches the KNN kernel once a frame."""
    from relightableavatar_tpu_torch.eval import train_check
    res = {}
    for dev in ("cpu", cuda):
        cfg = train_check.step_cfg(train_check.CHECK_B, train_check.CHECK_S, bf16=bf16,
                                   perturb=False, record_dir=str(tmp_path / str(dev)))
        trainer, batch = train_check.make_step(cfg, dev, train_check.CHECK_R)
        if bf16:
            train_check.live_residual(trainer)
        n0 = knn_cuda.KNN_TOP3.launches
        res[str(dev)] = train_check.step_result(trainer, batch)
        if dev != "cpu":
            assert knn_cuda.KNN_TOP3.launches - n0 == train_check.CHECK_B
    cmp = train_check.compare_grads(res["cuda"], res["cpu"])
    if bf16:
        for k, (rel, cos, top) in cmp.items():
            if not k.endswith(("/b", "beta")):
                assert top > 0 and cos >= 0.999, (k, cos)
    else:
        assert abs(res["cuda"]["loss"] - res["cpu"]["loss"]) <= 1e-5 * abs(res["cpu"]["loss"])
        assert max(v[0] for v in cmp.values()) <= 1e-4, {k: v[0] for k, v in cmp.items()}


def test_relight_bf16_step_gradients_on_the_card(cuda, tmp_path):
    """The small stage-2 step (``eval/train_check.py``'s relight check, bf16,
    the residual MLP's last weight re-drawn) on the card and on the CPU with
    the same jitter: every weight's gradient nonzero, the albedo and
    roughness heads' and the envmap's included (the stage-1 render MLP
    rides in the checkpoint unused), each with cosine >= 0.9 to the CPU's
    and each sub-network's gradient, all its tensors together, >= 0.995:
    the bf16 gradients move with the float32 summation order (chip_smoke.py's
    RELIGHT_BF16_COS).  The card's step launches the KNN kernel."""
    from relightableavatar_tpu_torch.eval import train_check
    res = {}
    for dev in ("cpu", cuda):
        cfg = train_check.relight_step_cfg(bf16=True, record_dir=str(tmp_path / str(dev)))
        trainer, batch, jitter = train_check.make_relight_check(cfg, dev)
        train_check.live_residual(trainer)
        n0 = knn_cuda.KNN_TOP3.launches
        res[str(dev)] = train_check.step_result(trainer, batch, jitter)
        if dev != "cpu":
            assert knn_cuda.KNN_TOP3.launches > n0
    cmp = train_check.compare_grads(res["cuda"], res["cpu"])
    assert all(cmp[k][2] > 0 for k in ('albedo/layers/0/w', 'roughness/layers/0/w', 'env'))
    for k, (rel, cos, top) in cmp.items():
        if not k.endswith(("/b", "beta")) and not k.startswith("rgb/"):
            assert top > 0 and cos >= 0.9, (k, cos)
    nets = train_check.compare_nets(res["cuda"], res["cpu"])
    assert "rgb" not in nets and min(nets.values()) >= 0.995, nets


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


# run -t evaluate on the card against the CPU: float32, TF32 off, the same
# tree and checkpoint; every map within 1e-5 of the CPU's, relative to the
# map's largest magnitude (at least 1), but spec_map: it divides by
# |ldot| + 1e-8 (ROADMAP, "spec_map parity"; 2.8e-4 apart on the card),
# held to test_torch_frame.py's spec_map bar
EVAL_RTOL = 1e-5
EVAL_SPEC_MIN_PSNR = 45.0


def test_run_evaluate_on_the_card_equals_the_cpu(cuda, tmp_path, monkeypatch):
    monkeypatch.chdir(golden.REPO)
    root = str(tmp_path / "tubeman")
    gcfg = make_synthetic.generator_cfg(52)
    gcfg.sphere_tracing.iter = 6
    gcfg.obj_lvis.iter = 2
    gcfg.tpu.ray_block = 256
    with torch.no_grad():
        make_synthetic.make_dataset_tree(root, frames=1, views=1, size=16, device="cpu",
                                         cfg=gcfg)
    ckpt = tmp_path / "trained_model" / "relight" / "tubeman_relight"
    ckpt.mkdir(parents=True)
    with np.load(make_synthetic.FIXTURE_PARAMS) as f:
        np.savez(ckpt / "latest.npz", **{"net:" + k: f[k] for k in f.files})
    maps = {}
    evaluate = Evaluator.evaluate

    def recording(self, output, batch):
        maps.setdefault(self.cfg.result_dir, []).append(
            {k: v.cpu().numpy() for k, v in output.items() if isinstance(v, torch.Tensor)})
        return evaluate(self, output, batch)
    monkeypatch.setattr(Evaluator, "evaluate", recording)
    results = {}
    for device in ("cuda", "cpu"):
        cfg, _ = setup(['-t', 'evaluate', '-c', 'configs/synthetic/tubeman.yaml', 'relighting',
                        'True', 'test_dataset.data_root', root, 'train_dataset.data_root', root,
                        'trained_model_dir', str(tmp_path / "trained_model"),
                        'result_dir', str(tmp_path / device), 'vis_ext', '.png',
                        'store_video_output', 'False', 'num_eval_frame', '1',
                        'tpu.bf16_mlp', 'False', 'tpu.knn_impl', 'pallas', 'mask_bkgd', 'False',
                        'sphere_tracing.iter', '6', 'obj_lvis.iter', '2', 'tpu.ray_block', '256'])
        n0 = knn_cuda.KNN_TOP3.launches
        results[device] = (run_evaluate(cfg, device=device), cfg.result_dir)
        if device == "cuda":
            assert knn_cuda.KNN_TOP3.launches > n0
    (card, card_dir), (cpu, cpu_dir) = results["cuda"], results["cpu"]
    assert len(maps[card_dir]) == len(maps[cpu_dir]) == 1
    for (a, b) in zip(maps[card_dir], maps[cpu_dir]):
        assert set(a) == set(b)
        rel = {k: float(np.abs(a[k] - b[k]).max()) / max(float(np.abs(b[k]).max()), 1.0)
               for k in a if k != "spec_map"}
        assert all(r <= EVAL_RTOL for r in rel.values()), rel
        assert golden.psnr(a["spec_map"], b["spec_map"]) >= EVAL_SPEC_MIN_PSNR
    assert abs(card["psnr"] - cpu["psnr"]) <= 0.01


@pytest.fixture(scope="module")
def mesh_tree(cuda, tmp_path_factory):
    """(data root, checkpoint folder): a 1-frame 8x8 generated tree (the
    mesh dataset reads its cameras, motion and body model) and the fixture
    as the stage-1 and the relight checkpoint."""
    tmp = tmp_path_factory.mktemp("mesh")
    root = str(tmp / "tubeman")
    gcfg = make_synthetic.generator_cfg(52)
    gcfg.sphere_tracing.iter = 2
    gcfg.obj_lvis.iter = 1
    with torch.no_grad():
        make_synthetic.make_dataset_tree(root, frames=1, views=1, size=8, device="cpu",
                                         cfg=gcfg)
    with np.load(make_synthetic.FIXTURE_PARAMS) as f:
        flat = {"net:" + k: f[k] for k in f.files}
    for sub in ("deform/tubeman", "relight/tubeman_relight"):
        (tmp / "trained_model" / sub).mkdir(parents=True)
        np.savez(tmp / "trained_model" / sub / "latest.npz", **flat)
    return root, str(tmp / "trained_model")


@pytest.mark.parametrize("mode,item,opts", [("vis_can_mesh", -1, ()),
                                            ("vis_posed_mesh", 0, ("relighting", "True"))])
def test_mesh_on_the_card_equals_the_cpu(mesh_tree, monkeypatch, mode, item, opts):
    """The coarse-voxel extraction (``eval/mesh_check.py``) on the card
    against the CPU: the canonical mesh from the stage-1 checkpoint, the
    posed frame-0 mesh (HDQ, albedo and roughness) from the relight one."""
    monkeypatch.chdir(golden.REPO)
    root, model_dir = mesh_tree
    cfg = mesh_check.mesh_cfg(root, model_dir, mode, opts=opts)
    n0 = knn_cuda.KNN_TOP3.launches
    card, stats, cloud = mesh_check.extract(cfg, item, "cuda")
    assert knn_cuda.KNN_TOP3.launches > n0
    cpu, _, _ = mesh_check.extract(cfg, item, "cpu")
    diff = mesh_check.compare(card, cpu, cloud)
    assert mesh_check.agrees(diff), diff
    assert stats.faces > 1000 and ("albedo" in card) == (mode == "vis_posed_mesh")


def test_kernel_on_a_mesh_grid_chunk(mesh_tree, monkeypatch):
    """The mesh filter's input: 1,048,576 points of the 5 mm canonical grid
    against the bigpose vertices, bit for bit; ``knn`` chunks it so."""
    monkeypatch.chdir(golden.REPO)
    root, model_dir = mesh_tree
    cfg = mesh_check.mesh_cfg(root, model_dir, voxel=0.005)
    batch = make_dataset(cfg, is_train=False, device="cuda")[-1]
    pts = torch.as_tensor(batch.pts.reshape(-1, 3), device="cuda")
    assert pts.shape[0] > 4 * knn_mod.CHUNK
    chunk = pts[knn_mod.CHUNK:2 * knn_mod.CHUNK]
    verts = batch.ctx["tverts"]
    n0 = knn_cuda.KNN_TOP3.launches
    d2, idx = knn_cuda.knn_top3_cuda(chunk, verts)
    d2r, idxr = knn_top3_reference(chunk, verts)
    assert torch.equal(d2, d2r) and torch.equal(idx, idxr)
    d1, i1 = knn_mod.knn(pts[:3 * knn_mod.CHUNK + 5], verts, K=1)
    assert knn_cuda.KNN_TOP3.launches == n0 + 1 + 4
    assert torch.equal(d1[knn_mod.CHUNK:2 * knn_mod.CHUNK, 0], d2[:, 0])
    assert torch.equal(i1[knn_mod.CHUNK:2 * knn_mod.CHUNK, 0], idx[:, 0])
