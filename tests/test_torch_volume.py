"""The port's stage-1 volume renderer (``renderer/volume.py``) against the
JAX package's ``relightableavatar_tpu/renderer/volume.py``, both in float32
with the exact KNN on the fixture avatar (stage-1 network: ``relighting``
off), and the port's sample culling (``tpu.volume_cull``) against its own
exact render.

Rays: the layout of ``tests/test_anisdf.py:124`` (200 rays from 2.5 m in
front of the body toward N(0, 0.3 m) targets, numpy rng 2, near 1 m, far
4 m), 16 samples a ray, ``ray_block`` 128 (two blocks, the second padded).
The culled renders follow ``tests/test_golden.py:201`` (128 rays, rng 3,
32 samples, 12 kept, a 48-node grid).  Last, the stage-1 network through
the sphere-traced block (``bench.py``'s ``sphere_tracing_512`` path, the
``render_rgb`` branch of ``render_human_block``) on the golden bundle.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import (few_torch_threads, jax_cfg, jax_golden_bundle,  # noqa: F401
                               jax_scene)
from relightableavatar_tpu.renderer.volume import (VolumeRenderer as JVolumeRenderer,
                                                   _render_block as j_render_block)
from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.renderer.volume import (VolumeRenderer, _render_block,
                                                         sample_fractions)
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.weights import param_shapes, params_from_flat

# measured: every map at 111.97 dB (depth_map, 32 samples) to 120 dB
# against JAX, so 100 dB
MIN_PSNR = 100.0
CULL_MIN_PSNR = 45.0        # culled against exact (tests/test_golden.py:201); measured 95.86 dB
CULL_ACC_ATOL = 0.02
STAGE1_ST_MIN_PSNR = 90.0   # the sphere-traced block's alpha and colour (see the test)
TRAIN_ATOL = 1e-4           # float32 training maps (tests/test_torch_train.py's bar)
TRAIN_POINT_REL = 1e-3      # float32 per-point gradients of a training render


def _cfg(cfg, n_samples, block, cull=0):
    cfg.relighting = False
    cfg.n_samples = n_samples
    cfg.tpu.ray_block = block
    cfg.tpu.bf16_mlp = False
    cfg.tpu.volume_grid = 48
    cfg.tpu.volume_cull = cull
    return cfg


def _rays(th, P, seed, dist, sigma, lift, near, far):
    rng = np.random.default_rng(seed)
    center = th.reshape(3) + [0, 0, lift]
    ray_o = np.tile(center + [dist, 0, 0], (P, 1)).astype(np.float32)
    tgt = center + rng.normal(0, sigma, (P, 3))
    ray_d = (tgt - ray_o).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    return dict(ray_o=ray_o, ray_d=ray_d, near=np.full(P, near, np.float32),
                far=np.full(P, far, np.float32))


def _render_both(cfg_fn):
    """(port maps, JAX maps) of VolumeRenderer.render on the same rays."""
    cfg = cfg_fn(golden.fixture_cfg())
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    rays = (_rays(ctx['Th'].numpy(), 200, 2, 2.5, 0.3, 0.0, 1.0, 4.0) if cfg.n_samples == 16
            else _rays(ctx['Th'].numpy(), 128, 3, 2.2, 0.35, 1.0, 1.2, 3.2))
    port = VolumeRenderer(cfg, params, mcfg, device="cpu").render(dotdict(ctx=ctx, **rays))

    jcfg = cfg_fn(jax_cfg())
    jparams, jmcfg, jctx = jax_scene(jcfg)
    jr = JVolumeRenderer(jcfg, jparams, jmcfg._replace(knn_exact=True))
    with jax.default_matmul_precision('highest'):
        ref = jr.render(jdotdict(ctx=jctx, **rays))
    return ({k: v.numpy() for k, v in port.items()},
            {k: np.asarray(v) for k, v in ref.items()})


@pytest.fixture(scope="module")
def exact16():
    return _render_both(lambda c: _cfg(c, 16, 128))


@pytest.fixture(scope="module")
def culled():
    exact = _render_both(lambda c: _cfg(c, 32, 256))
    cull = _render_both(lambda c: _cfg(c, 32, 256, cull=12))
    return exact, cull


@pytest.mark.parametrize("n", [2, 3, 16, 32, 64, 128])
def test_sample_fractions_equal_jax_linspace(n):
    np.testing.assert_array_equal(sample_fractions(n).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_volume_render_matches_jax(exact16):
    port, ref = exact16
    assert set(port) == set(ref) == {'rgb_map', 'acc_map', 'depth_map', 'norm_map',
                                     'cpts_map', 'bpts_map', 'resd_map'}
    assert port['rgb_map'].shape == (200, 3) and port['acc_map'].max() > 0.5
    for key in sorted(ref):
        p = golden.psnr(port[key], ref[key])
        print(f"{key}: {p:.2f} dB")
        assert p >= MIN_PSNR, (key, p)


def test_render_block_matches_jax():
    """One ``_render_block`` call on the first 64 rays, 16 samples."""
    cfg = _cfg(golden.fixture_cfg(), 16, 64)
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    rays = _rays(ctx['Th'].numpy(), 64, 2, 2.5, 0.3, 0.0, 1.0, 4.0)
    t = {k: torch.as_tensor(v) for k, v in rays.items()}
    port = _render_block(params, mcfg, ctx, t['ray_o'], t['ray_d'], t['near'], t['far'],
                         16, 0.0)
    jparams, jmcfg, jctx = jax_scene(_cfg(jax_cfg(), 16, 64))
    with jax.default_matmul_precision('highest'):
        ref = j_render_block(jparams, jmcfg._replace(knn_exact=True), jctx,
                             *(jnp.asarray(rays[k]) for k in ('ray_o', 'ray_d', 'near', 'far')),
                             jax.random.PRNGKey(0), 16, False, 0.0, False)
    assert set(port) == set(ref)
    for key in sorted(ref):
        p = golden.psnr(port[key].numpy(), np.asarray(ref[key]))
        print(f"{key}: {p:.2f} dB")
        assert p >= MIN_PSNR, (key, p)


@pytest.mark.parametrize("which", ["exact", "culled"])
def test_volume_32_samples_match_jax(culled, which):
    port, ref = culled[0] if which == "exact" else culled[1]
    for key in sorted(ref):
        p = golden.psnr(port[key], ref[key])
        print(f"{which} {key}: {p:.2f} dB")
        assert p >= MIN_PSNR, (key, p)


def test_volume_cull_matches_exact(culled):
    (exact, _), (cull, _) = culled
    p = golden.psnr(cull['rgb_map'], exact['rgb_map'])
    print(f"culled vs exact rgb_map: {p:.2f} dB, acc max |diff| "
          f"{np.abs(cull['acc_map'] - exact['acc_map']).max():.3e}")
    assert p >= CULL_MIN_PSNR
    np.testing.assert_allclose(cull['acc_map'], exact['acc_map'], atol=CULL_ACC_ATOL)


def test_training_render_raises():
    """``VolumeRenderer.render(training=True)`` with the relight network
    against the JAX package's, which renders this case (8 rays of 16
    samples from 2.2 m to 2.8 m toward the body's centre, in one 64-ray
    block, ``perturb`` 0): the training forward draws no jittered pair
    there, and the channel split hands the 7 composited
    channels [albedo, rough, norm] on as a 3-channel "norm" (dropped in
    training) and a 4-channel ``rgb_map``, which the port matches.  The maps,
    weights and z_vals within TRAIN_ATOL, the per-point terms of the first 8
    points (the JAX renderer cuts every key to the ray count) within
    TRAIN_POINT_REL of their largest entry."""
    cfg = _cfg(golden.fixture_cfg(), 16, 64)
    cfg.relighting = True
    cfg.perturb = 0
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    assert mcfg.relight
    rays = _rays(ctx['Th'].numpy(), 8, 2, 2.5, 0.05, 1.0, 2.2, 2.8)
    ours = VolumeRenderer(cfg, params, mcfg, device="cpu").render(dotdict(ctx=ctx, **rays),
                                                                  training=True)
    jcfg = _cfg(jax_cfg(), 16, 64)
    jcfg.relighting = True
    jcfg.perturb = 0
    jparams, jmcfg, jctx = jax_scene(jcfg)
    with jax.default_matmul_precision('highest'):
        ref = JVolumeRenderer(jcfg, jparams, jmcfg._replace(knn_exact=True)).render(
            jdotdict(ctx=jctx, **rays), training=True)
    assert set(ours) == set(ref) and ours.rgb_map.shape == (8, 4) and ours.rgb_map.requires_grad
    for k, v in ref.items():
        v = np.asarray(v)
        got = ours[k].detach().numpy()[:len(v)]
        if k in ('residuals', 'gradients', 'observed_gradients'):
            # the fixture's residual MLP has a zero last layer: zero residuals
            err = np.abs(got - v).max() / (np.abs(v).max() or 1.0)
            print(f"{k}: max |diff| / max |JAX| {err:.3e}")
            assert err <= TRAIN_POINT_REL, k
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=TRAIN_ATOL, err_msg=k)
    assert np.asarray(ref['acc_map']).max() > 0.5


def test_stage1_sphere_traced_bundle_matches_jax():
    """The 256-ray golden bundle (6 surface iterations) through the port's
    ``render_human_block`` with the stage-1 network and ``relighting`` off
    against the JAX package's.  Measured: 114.6 to 120 dB on every map but
    acc_map (100.65 dB) and rgb_map (106.47 dB): 10 of the 256 rays differ
    by more than 1e-6 in acc, the most a silhouette ray of partial alpha
    0.713 by 9.8e-5, where the soft camera trace turns the SDF's float
    differences into alpha.  Bar 100 dB, 90 dB on those two maps."""
    cfg = golden.fixture_cfg()
    cfg.relighting = False
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    assert 'albedo' not in params and not mcfg.relight
    port = golden.render_golden_bundle(ctx, params, mcfg, device="cpu",
                                       rcfg_extra={'relighting': False})
    jcfg = jax_cfg()
    jcfg.relighting = False
    jparams, jmcfg, jctx = jax_scene(jcfg)
    ref = jax_golden_bundle((jparams, jmcfg._replace(knn_exact=True), jctx),
                            {'relighting': False})
    assert set(port) == set(ref) and 'albedo_map' not in port
    assert (port.acc_map > 0).any() and port.rgb_map.max() > 0
    for key in sorted(ref):
        p = golden.psnr(port[key].numpy(), ref[key])
        print(f"stage-1 sphere-traced {key}: {p:.2f} dB")
        assert p >= (STAGE1_ST_MIN_PSNR if key in ('acc_map', 'rgb_map') else MIN_PSNR), (key, p)


def test_stage1_load_leaves_out_only_the_relight_heads():
    """A stage-1 config takes the stage-2 fixture checkpoint without its
    relight heads (as the JAX package's template load does) and still
    refuses a key that belongs to no network."""
    cfg = golden.fixture_cfg()
    cfg.relighting = False
    mcfg = AniSDFConfig.from_cfg(cfg)._replace(sdf_res=8)
    with np.load(os.path.join(golden.REPO, 'fixtures/synthetic_avatar_params.npz')) as f:
        flat = {k: f[k] for k in f.files}
    params = params_from_flat(flat, device="cpu", mcfg=mcfg)
    assert set(params) == {'resd', 'sdf', 'rgb', 'beta'}
    assert set(param_shapes(mcfg)) == {k for k in flat
                                       if k.split('/')[0] not in ('albedo', 'roughness', 'env')}
    with pytest.raises(KeyError):
        params_from_flat({**flat, 'sdf/layers/9/g': np.zeros(3, np.float32)}, device="cpu",
                         mcfg=mcfg)
