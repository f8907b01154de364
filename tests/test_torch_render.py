"""The port's relight render against the JAX package's and the stored golden.

The golden bundle of ``tests/test_golden.py:_render`` (256 rays, 6 surface /
2 shadow iterations, 2x4 lights, numpy rng 7) goes through the port's
``render_human_block`` and must reach >= 50 dB against both the live JAX
render with the exact KNN (``knn_impl='pallas'``) and
``tests/golden_relight_24px.npy``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads  # noqa: F401 (fixture)
from relightableavatar_tpu.config import default_cfg as j_default_cfg
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu.ops.envmap import gen_light_xyz as j_gen_light_xyz
from relightableavatar_tpu.renderer.sphere_tracing import (
    RelightRenderConfig as JRelightRenderConfig, render_human_block as j_render_human_block)
from relightableavatar_tpu.renderer.tracing import STConfig as JSTConfig
from relightableavatar_tpu.smpl.body_model import BodyModel
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
from relightableavatar_tpu_torch.renderer.sphere_tracing import render_human_block
from relightableavatar_tpu_torch.renderer.volume import VolumeRenderer
from relightableavatar_tpu_torch.weights import load_params

MIN_PSNR = 50.0


def _jax_golden_bundle():
    """tests/test_golden.py:_render with the exact (Pallas-path) KNN."""
    root = golden.REPO
    model = BodyModel(os.path.join(root, 'fixtures/synthetic_body.npz'))
    motion = dict(np.load(os.path.join(root, 'fixtures/synthetic_motion.npz')))
    sh = motion['shapes'][0]
    tv, tj, bA, _ = make_bigpose(model, sh)
    ctx = make_frame_context(model, tv, tj, bA, motion['poses'][0],
                             motion['Rh'][0], motion['Th'][0], sh)
    cfg = j_default_cfg()
    cfg.n_bones = model.n_bones
    cfg.cond_dim = model.n_bones * 3
    cfg.relighting = True
    cfg.n_samples = 3
    cfg.dist_th = 0.125
    cfg.obj_lvis.dist_th = 0.125
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.tpu.bf16_mlp = False
    cfg.tpu.knn_impl = 'pallas'
    mcfg = j_anisdf.AniSDFConfig.from_cfg(cfg)._replace(sdf_res=8)
    # the fixture's arrays as a JAX pytree (the loaders agree:
    # test_torch_context_weights.py)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          load_params(os.path.join(root, 'fixtures/synthetic_avatar_params.npz'),
                                      device="cpu"))
    tctx = {k: torch.as_tensor(np.array(v)) for k, v in ctx.items()}
    ray_o, ray_d = golden.golden_bundle_rays(tctx)
    P = len(ray_o)
    lx, la = j_gen_light_xyz(2, 4, 10.0)
    st_surf = JSTConfig.from_cfg(cfg.sphere_tracing)
    st_obj = JSTConfig.from_cfg({**dict(cfg.sphere_tracing), **dict(cfg.obj_lvis)})
    rcfg = JRelightRenderConfig(shadow_block=1024, distant_envmap=True)
    with jax.default_matmul_precision('highest'):
        out = j_render_human_block(
            params, mcfg, ctx, jnp.asarray(ray_o), jnp.asarray(ray_d),
            jnp.full(P, 0.8), jnp.full(P, 4.0), jnp.full((2, 4, 3), 0.6),
            lx, la, 1.0 / jnp.sqrt(la / np.pi), st_surf, st_obj, rcfg, False)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def fixture_scene():
    cfg = golden.fixture_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    return cfg, ctx, params, mcfg


@pytest.fixture(scope="module")
def bundles(fixture_scene):
    _, ctx, params, mcfg = fixture_scene
    port = golden.render_golden_bundle(ctx, params, mcfg, device="cpu")
    return {k: v.numpy() for k, v in port.items()}, _jax_golden_bundle()


def test_golden_bundle_vs_live_jax(bundles):
    port, ref = bundles
    assert set(port) == set(ref)
    psnr = golden.psnr(port['rgb_map'], ref['rgb_map'])
    print(f"port vs live JAX (exact KNN): {psnr:.2f} dB")
    assert psnr >= MIN_PSNR
    for key in ('acc_map', 'albedo_map', 'norm_map', 'shade_map', 'spec_map'):
        assert golden.psnr(port[key], ref[key]) >= MIN_PSNR, key


def test_golden_bundle_vs_stored_golden(bundles):
    port, _ = bundles
    img = port['rgb_map']
    ref = np.load(golden.GOLDEN_RELIGHT_24)
    assert img.shape == ref.shape and np.isfinite(img).all()
    psnr = golden.psnr(img, ref)
    print(f"port vs tests/golden_relight_24px.npy: {psnr:.2f} dB")
    assert psnr >= MIN_PSNR


def test_renderer_blocks_equal_one_block(fixture_scene):
    """Padding and ray blocking in SphereTracingRenderer.render are
    output-identical to one render_human_block over the same rays."""
    cfg, ctx, params, mcfg = fixture_scene
    cfg = cfg.clone()
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.tpu.lvis_downscale = 8
    cfg.tpu.ray_block = 16
    batch, mab = golden.frame_batch(ctx, 16, 16)
    n = int(mab.sum())
    assert n > 16 and n % 16      # several blocks, the last one padded
    renderer = SphereTracingRenderer(cfg, params, mcfg, device="cpu")
    out = renderer.render(batch)
    near = np.clip(batch.near, cfg.clip_near, None)
    far = np.clip(batch.far, None, cfg.clip_far)
    t = torch.as_tensor
    one = render_human_block(params, mcfg, ctx, t(batch.ray_o), t(batch.ray_d), t(near),
                             t(far), renderer.select_envmap(batch).probe,
                             renderer.light_xyz, renderer.light_area,
                             renderer.light_sharp, renderer.st_surf,
                             renderer.st_obj, renderer.rcfg)
    assert (out.acc_map > 0).any()
    for key, v in one.items():
        assert out[key].shape == v.shape, key
        np.testing.assert_allclose(out[key].numpy(), v.numpy(), atol=1e-6, rtol=0,
                                   err_msg=key)


def test_check_bound_sdf_early_exit(fixture_scene):
    """check_bound_sdf returns only rgb/acc (reference :577-587)."""
    _, ctx, params, mcfg = fixture_scene
    out = golden.render_golden_bundle(ctx, params, mcfg, device="cpu",
                                      rcfg_extra={'check_bound_sdf': True})
    assert set(out.keys()) == {'acc_map', 'rgb_map'}
    img = out.rgb_map.numpy()
    assert img.shape == (256, 3) and np.isfinite(img).all()
    assert (img >= 0).all() and (img <= 1).all()
    assert out.acc_map.min().item() == 1.0


def test_check_termination_sdf_stats(fixture_scene):
    _, ctx, params, mcfg = fixture_scene
    out = golden.render_golden_bundle(ctx, params, mcfg, device="cpu",
                                      rcfg_extra={'check_termination_sdf': True})
    s, n = float(out.term_sdf_sum[0]), float(out.term_sdf_cnt[0])
    assert np.isfinite(s) and s >= 0 and 0 < n <= 256 and s / n < 0.5


def test_check_termination_sdf_reads_the_network_under_smpl_distance(fixture_scene):
    """With ``smpl_distance`` the trace marches the canonical SMPL mesh's
    SDF, but the termination statistic is the network's own |sdf| at the
    hit points, as the JAX package's (``mcfg._replace(smpl_distance=False)``,
    ``renderer/sphere_tracing.py:396-399``)."""
    _, ctx, params, mcfg = fixture_scene
    out = golden.render_golden_bundle(ctx, params, mcfg._replace(smpl_distance=True),
                                      device="cpu", rcfg_extra={'check_termination_sdf': True})
    hit = out.acc_map > 0
    with torch.no_grad():
        net = anisdf.hdq_sdf(params, mcfg, ctx, out.surf_map[hit], smooth_transition=True)
    assert int(hit.sum()) == int(out.term_sdf_cnt[0]) > 0
    np.testing.assert_allclose(float(out.term_sdf_sum[0]), float(net.abs().sum()), rtol=1e-5)


# tpu.frame_fuse renders through the per-block loop; held to the JAX
# package's fused frame (one executable: the bake, the sweep and a lax.scan
# over the blocks) on tests/test_frame_fuse.py's setup, at that file's
# fused-vs-loop bar (measured: max |diff| 2.1e-6, norm_map; spec_map 1.6e-7)
FUSE_TOL = 2e-5
# the setup's 2 trace iterations hit nothing from 2 m away (every map of
# tests/test_frame_fuse.py's frames is zero); 16 reach the body
FUSE_TRACE_ITERS = 16
FUSE_CASES = [(150, True), (150, False), (40, True)]


@pytest.mark.parametrize("P,lvis_sweep", FUSE_CASES,
                         ids=["P150_sweep", "P150_traced", "P40_one_block"])
def test_frame_fuse_matches_jax_fused_frame(P, lvis_sweep):
    """``tpu.frame_fuse True`` on ``tests/test_frame_fuse.py``'s setup
    (P = 150 in blocks of 64: 3 blocks, which JAX buckets to 4; P = 40: one
    block; the 16-node grid, 2 x 4 lights, ``init_anisdf`` weights), both
    sides with the exact KNN: the port's frame equals the JAX package's
    fused frame (its renderer on one device, ``mesh = None``, so that the
    fused executable runs) within FUSE_TOL, on a frame where some rays hit
    and some miss."""
    from test_frame_fuse import _setup
    from relightableavatar_tpu.renderer.orchestrate import SphereTracingRenderer as JRenderer
    from relightableavatar_tpu.train.checkpoints import _flatten
    from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
    from relightableavatar_tpu_torch.config import default_cfg
    from relightableavatar_tpu_torch.train.checkpoints import params_from_flat
    from relightableavatar_tpu_torch.utils.dotdict import dotdict

    jcfg, jparams, jmcfg, jbatch = _setup(P=P, lvis_sweep=lvis_sweep, frame_fuse=True)
    jcfg.sphere_tracing.iter = FUSE_TRACE_ITERS
    jr = JRenderer(jcfg, jparams, jmcfg._replace(knn_exact=True))
    jr.mesh = None
    with jax.default_matmul_precision('highest'):
        ref = jr.render(jdotdict(jbatch))

    cfg = default_cfg()
    for k in ('n_bones', 'cond_dim', 'relighting', 'n_samples', 'env_h', 'env_w'):
        cfg[k] = jcfg[k]
    cfg.sphere_tracing.iter = jcfg.sphere_tracing.iter
    cfg.obj_lvis.iter = jcfg.obj_lvis.iter
    for k in ('ray_block', 'bf16_mlp', 'shadow_grid', 'lvis_sweep', 'lvis_downscale',
              'lvis_query_offset', 'distant_envmap', 'frame_fuse'):
        cfg.tpu[k] = jcfg.tpu[k]
    cfg.tpu.knn_impl = 'pallas'
    assert cfg.tpu.frame_fuse
    mcfg = AniSDFConfig.from_cfg(cfg)._replace(sdf_res=jmcfg.sdf_res)
    params = params_from_flat({k: np.asarray(v) for k, v in _flatten(jparams).items()},
                              device="cpu", mcfg=mcfg)
    ctx = {k: torch.as_tensor(np.asarray(v)) for k, v in jbatch.ctx.items()}
    renderer = SphereTracingRenderer(cfg, params, mcfg, device="cpu")
    out = renderer.render(dotdict(jbatch, ctx=ctx))
    assert renderer.last_frame.blocks == -(-P // 64)
    assert set(out) == set(ref)
    acc = np.asarray(ref['acc_map'])
    assert (acc > 0).any() and (acc == 0).any()
    for k in ref:
        if k != 'envmap':
            a, b = out[k].numpy(), np.asarray(ref[k])
            assert a.shape == b.shape, k
            np.testing.assert_allclose(a, b, rtol=FUSE_TOL, atol=FUSE_TOL, err_msg=k)


# options that raised before they were ported; each now builds a renderer
# and renders a frame to finite maps (their parity with the JAX package:
# test_torch_accel.py, test_torch_bf16.py, test_torch_frame.py,
# test_torch_volume.py, test_torch_ground.py, test_torch_novel_light.py,
# test_torch_options.py, test_torch_hashgrid.py).
# tpu.volume_cull is the volume renderer's: it renders the stage-1 network
# through VolumeRenderer (SphereTracingRenderer ignores it, as the JAX
# package's does); vis_ground_shading renders the whole 16x16 frame;
# e_type hash renders golden.hash_params' network; the ablations
# 'can' and 'curve' carry these camera rays 2 m away to a zero transform
# and hit nothing, as the JAX package's do (test_torch_options.py holds
# them on rays near the body)
PORTED = [('tpu', 'shadow_grid', 17), ('tpu', 'lvis_sweep', True),
          ('tpu', 'surf_miss_skip', True), ('tpu', 'bf16_mlp', True),
          ('tpu', 'bf16_act', True), ('tpu', 'volume_cull', 32),
          (None, 'vis_ground_shading', True),
          ('tpu', 'surf_grid_iters', 8), ('tpu', 'shadow_compact', 0.5),
          ('tpu', 'shadow_skip_resd', True), ('tpu', 'shadow_verts_sub', 4),
          ('tpu', 'knn_impl', 'grouped'), ('tpu', 'knn_impl', 'xla'),
          (None, 'e_type', 'hash'), (None, 'ablate_hdq_mode', 'world'),
          ('tpu', 'frame_fuse', True)]


@pytest.mark.parametrize("node,key,value", PORTED, ids=[f"{k}={v}" for _, k, v in PORTED])
def test_ported_options_render(fixture_scene, node, key, value):
    cfg, ctx, params, _ = fixture_scene
    cfg = cfg.clone()
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.env_lvis.iter = 2
    cfg.tpu.lvis_downscale = 8
    cfg.tpu.ray_block = 64
    (cfg[node] if node else cfg)[key] = value
    if key in ('lvis_sweep', 'surf_miss_skip', 'surf_grid_iters'):
        cfg.tpu.shadow_grid = 17            # the grid these options read
    batch, mab = golden.frame_batch(ctx, 16, 16)
    n = 16 * 16 if key == 'vis_ground_shading' else int(mab.sum())
    if key == 'volume_cull':
        cfg.relighting = False
        cfg.n_samples = 64
        cfg.tpu.volume_grid = 17
        _, params, mcfg = golden.load_fixture(cfg, device="cpu")   # the stage-1 network
        renderer = VolumeRenderer(cfg, params, mcfg, device="cpu")
    else:
        mcfg = AniSDFConfig.from_cfg(cfg)._replace(sdf_res=8)
        if key == 'e_type':
            params = golden.hash_params(mcfg, device="cpu")
        renderer = SphereTracingRenderer(cfg, params, mcfg, device="cpu")
    out = renderer.render(batch)
    assert out.rgb_map.shape == (n, 3)
    assert (out.acc_map > 0).any()
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            assert torch.isfinite(v).all(), k
