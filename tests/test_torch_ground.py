"""The port's ground pass (``renderer/ground.py``) against the JAX package's
``relightableavatar_tpu/renderer/ground.py``: the Moller-Trumbore plane hit,
the ground triangle, and ``render_ground_block`` on the setup of
``tests/test_ground.py:42`` (fixture frame 0, 64 rays from above the body
aimed down past it, numpy rng 3, a 2x4 light grid, a constant 0.5 probe,
2 ``env_lvis`` iterations), float32 with the exact KNN on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from relightableavatar_tpu.ops.envmap import gen_light_xyz as j_gen_light_xyz
from relightableavatar_tpu.renderer.ground import (
    compute_ground_tris as j_compute_ground_tris, moller_trumbore as j_moller_trumbore,
    render_ground_block as j_render_ground_block)
from relightableavatar_tpu.renderer.sphere_tracing import \
    RelightRenderConfig as JRelightRenderConfig
from relightableavatar_tpu.renderer.tracing import STConfig as JSTConfig
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.ops.envmap import gen_light_xyz
from relightableavatar_tpu_torch.renderer.ground import (compute_ground_tris, moller_trumbore,
                                                         render_ground_block)
from relightableavatar_tpu_torch.renderer.sphere_tracing import RelightRenderConfig
from relightableavatar_tpu_torch.renderer.tracing import STConfig

ATOL = 1e-5
# measured: every map at >= 119.99 dB against JAX, so 100 dB
MIN_PSNR = 100.0


def test_moller_trumbore_matches_jax():
    rng = np.random.default_rng(0)
    ro = rng.normal(size=(37, 3)).astype(np.float32)
    rd = rng.normal(size=(37, 3)).astype(np.float32)
    tris = rng.normal(size=(5, 3, 3)).astype(np.float32)
    ours = moller_trumbore(torch.as_tensor(ro), torch.as_tensor(rd), torch.as_tensor(tris))
    ref = j_moller_trumbore(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tris))
    for a, b in zip(ours, ref):
        assert a.shape == (37, 5)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=ATOL)


def test_ground_tris_match_jax():
    orig = np.asarray([0.1, -0.2, 0.05], np.float32)
    norm = np.asarray([0, 0, 1], np.float32)
    ours = compute_ground_tris(torch.as_tensor(orig), torch.as_tensor(norm))
    ref = j_compute_ground_tris(jnp.asarray(orig), jnp.asarray(norm))
    # one float32 ulp at |x| ~ 1 (the normalise and cross products round apart)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2.5e-7, rtol=0)
    # the three corners span the plane: every hit of a downward ray lies on it
    rd = torch.tensor([[0.3, -0.1, -1.0]])
    _, _, t = moller_trumbore(torch.tensor([[0.0, 0.0, 2.0]]), rd, ours[None])
    hit = torch.tensor([0.0, 0.0, 2.0]) + t[0, 0] * rd[0]
    assert abs(float(hit[2]) - 0.05) < 1e-6


@pytest.fixture(scope="module")
def ground_setup():
    cfg = golden.fixture_cfg()
    cfg.env_lvis.iter = 2
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    P = 64
    rng = np.random.default_rng(3)
    center = ctx['Th'].numpy().reshape(3)
    ray_o = np.tile(center + [2.0, 0, 1.5], (P, 1)).astype(np.float32)
    tgt = center + rng.normal(0, 0.5, (P, 3)) * [1, 1, 0.2]
    ray_d = (tgt - ray_o).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    jcfg = jax_cfg()
    jcfg.env_lvis.iter = 2
    jparams, jmcfg, jctx = jax_scene(jcfg)
    return cfg, ctx, params, mcfg, jcfg, jctx, jparams, jmcfg._replace(knn_exact=True), ray_o, ray_d


@pytest.mark.parametrize("attach", [True, False])
def test_render_ground_block_matches_jax(ground_setup, attach):
    cfg, ctx, params, mcfg, jcfg, jctx, jparams, jmcfg, ray_o, ray_d = ground_setup
    P = len(ray_o)
    vec = lambda name: np.asarray(cfg[name], np.float32)
    knobs = dict(shadow_block=512, distant_envmap=True, lvis_downscale=1)

    lx, la = gen_light_xyz(2, 4, 10.0)
    probe = torch.full((2, 4, 3), 0.5)
    st_env = STConfig.from_cfg({**dict(cfg.sphere_tracing), **dict(cfg.env_lvis)})
    stats = {}
    out = render_ground_block(
        params, mcfg, ctx, torch.as_tensor(ray_o), torch.as_tensor(ray_d), torch.ones(P),
        probe, probe, lx, la, 1.0 / torch.sqrt(la / np.pi),
        *(torch.as_tensor(vec(k)) for k in ('ground_normal', 'ground_origin', 'ground_albedo')),
        st_env, RelightRenderConfig(**knobs), attach, stats=stats)

    jlx, jla = j_gen_light_xyz(2, 4, 10.0)
    jprobe = jnp.full((2, 4, 3), 0.5)
    jst_env = JSTConfig.from_cfg({**dict(jcfg.sphere_tracing), **dict(jcfg.env_lvis)})
    with jax.default_matmul_precision('highest'):
        ref = j_render_ground_block(
            jparams, jmcfg, jctx, jnp.asarray(ray_o), jnp.asarray(ray_d), jnp.ones(P),
            jprobe, jprobe, jlx, jla, 1.0 / jnp.sqrt(jla / np.pi),
            *(jnp.asarray(vec(k)) for k in ('ground_normal', 'ground_origin', 'ground_albedo')),
            jst_env, JRelightRenderConfig(**knobs), attach)

    assert set(out) == set(ref)
    img = out.rgb_map.numpy()
    assert img.shape == (P, 3) and np.isfinite(img).all() and img.max() > 0
    assert 0 < stats['shadow_rays'] <= P * 8
    for key in sorted(ref):
        p = golden.psnr(out[key].numpy(), np.asarray(ref[key]))
        print(f"attach={attach} {key}: {p:.2f} dB")
        assert p >= MIN_PSNR, (key, p)
