"""The port's novel-light sweep against the JAX package's: the re-shade
functions, probe rotation, the light loader and ``NovelLightRenderer.render``.

Re-shade: the cases of ``tests/test_tracing.py:400-460`` (P = 53 points,
L = 8 texels, numpy rng 11 and 7), distant x cancel-cosine x lobe, at
5e-6.  Renderer: the setup of ``tests/test_golden.py:260`` (fixture frame
0, camera 0, 6 surface / 2 shadow iterations, 48-node grid, slice sweep,
2x-coarser visibility, distant envmap, ``ray_block`` 1024, float32, exact
KNN) at 32x32: two lights, the same with the ground pass, and one light
rotated 32 times.
"""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from relightableavatar_tpu.data.datasets import load_lighting as j_load_lighting
from relightableavatar_tpu.ops.envmap import (gen_light_xyz as j_gen_light_xyz,
                                              reflect as j_reflect,
                                              rotate_envmap_dict as j_rotate_envmap_dict,
                                              shift_image as j_shift_image)
from relightableavatar_tpu.renderer import orchestrate as jorc
from relightableavatar_tpu.renderer.sphere_tracing import \
    RelightRenderConfig as JRelightRenderConfig
from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
from relightableavatar_tpu_torch.data import datasets
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.ops.envmap import (gen_light_xyz, reflect,
                                                    rotate_envmap_dict, shift_image)
from relightableavatar_tpu_torch.renderer import orchestrate as orc
from relightableavatar_tpu_torch.renderer.sphere_tracing import RelightRenderConfig

RESHADE_ATOL = 5e-6         # tests/test_tracing.py:400-460
ROTATE_ATOL = 1e-6
# measured (32x32 frame, 168 rays): every per-light map at >= 114.78 dB
# (acc_map; rgb_map 117.4 to 117.6, the procedural probes changing with the
# process), the frame's maps at >= 105.12 dB (the ground case's depth_map),
# so 100 dB.  spec_map
# divides by |ldot| + 1e-8 (ROADMAP, "spec_map parity"): 47.1 dB, bar 45 dB.
# lvis_map and ldot_map are compared on the rays that hit (acc > 0), the
# only ones the re-shade reads: a missed ray's normal normalises a
# near-zero-occupancy composite, and its ldot differs by up to 4.2e-4
# (93.3 dB) where a hit's differs by 6.6e-6 (lvis_map and ldot_map on the
# hits: >= 111.08 dB)
MIN_PSNR = 100.0
HIT_ONLY = ('lvis_map', 'ldot_map')
# the ground-merged surf_map holds plane hits up to 66 m away, where
# t = (A0 . N) / -(d . N) divides by a grazing ray's small d . N: measured
# 97.46 dB, max |diff| 7.2e-4 m (1.3e-4 relative) at a far hit; the depth
# map clamps t to env_r and is at 105.1 dB, the blended rgb_map at 118.6 dB
MIN_PSNR_GROUND_SURF = 90.0
MIN_PSNR_SPEC = 45.0
LIGHTS = ['olat0000-0000', 'gym_entrance']


def _reshade_inputs(seed, P, K=None):
    rng = np.random.default_rng(seed)
    probe = rng.random((K, 2, 4, 3) if K else (2, 4, 3)).astype(np.float32)
    surf = rng.normal(size=(P, 3)).astype(np.float32)
    norm = rng.normal(size=(P, 3)).astype(np.float32)
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    albedo = rng.random((P, 3)).astype(np.float32)
    rough = rng.uniform(0.2, 0.9, (P, 1)).astype(np.float32)
    lvis = rng.random((P, 8)).astype(np.float32)
    ldot = rng.uniform(-1, 1, (P, 8)).astype(np.float32)
    acc = rng.random(P).astype(np.float32)
    ray_o = (rng.normal(size=(P, 3)) * 3).astype(np.float32)
    return (surf, norm, albedo, rough, lvis, ldot, acc, ray_o, probe)


def _both(arrays, **knobs):
    """(port args, JAX args) of the re-shade functions: the arrays and the
    2x4 light grid at radius 10, with ``knobs`` of RelightRenderConfig."""
    xyz, area = gen_light_xyz(2, 4, 10.0)
    jxyz, jarea = j_gen_light_xyz(2, 4, 10.0)
    port = tuple(torch.as_tensor(a) for a in arrays) + (xyz, area, RelightRenderConfig(**knobs))
    ref = tuple(jnp.asarray(a) for a in arrays) + (jxyz, jarea, JRelightRenderConfig(**knobs))
    return port, ref


def _knobs(distant, cancel, lobe):
    return dict(tonemapping=True, distant_envmap=distant, cancel_cosine=cancel,
                lambert_only=lobe == "lambert", glossy_only=lobe == "glossy")


@pytest.mark.parametrize("distant", [True, False])
@pytest.mark.parametrize("cancel", [True, False])
@pytest.mark.parametrize("lobe", ["full", "lambert", "glossy"])
def test_reshade_matches_jax_and_dense(distant, cancel, lobe):
    port, ref = _both(_reshade_inputs(11, 53), **_knobs(distant, cancel, lobe))
    out = orc.reshade_block(*port)
    dense = orc.reshade_dense(*port)
    with jax.default_matmul_precision('highest'):
        jout = jorc.reshade_block(*ref)
        jdense = jorc.reshade_dense(*ref)
    for key in ('rgb_map', 'shade_map'):
        assert out[key].shape == (53, 3)
        for got, want in ((out[key], jout[key]), (dense[key], jdense[key]),
                          (out[key], dense[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RESHADE_ATOL,
                                       rtol=0, err_msg=key)


@pytest.mark.parametrize("distant", [True, False])
@pytest.mark.parametrize("lobe", ["full", "lambert", "glossy"])
def test_reshade_sweep_matches_per_light_and_jax(distant, lobe):
    K = 3
    port, ref = _both(_reshade_inputs(7, 41, K), **_knobs(distant, True, lobe))
    sweep = orc.reshade_sweep_block(*port)
    with jax.default_matmul_precision('highest'):
        jsweep = jorc.reshade_sweep_block(*ref)
    for k in range(K):
        one = orc.reshade_block(*port[:8], port[8][k], *port[9:])
        for key in ('rgb_map', 'shade_map'):
            assert sweep[key].shape == (K, 41, 3)
            np.testing.assert_allclose(sweep[key][k].numpy(), one[key].numpy(),
                                       atol=RESHADE_ATOL, rtol=0, err_msg=key)
            np.testing.assert_allclose(sweep[key][k].numpy(), np.asarray(jsweep[key][k]),
                                       atol=RESHADE_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("shift", [0.0, 0.25, 1.0, 7.5, -3.3])
def test_shift_image_matches_jax(shift):
    img = np.random.default_rng(5).random((2, 3, 16, 32, 3)).astype(np.float32)
    for a in (img[0, 0], img[0]):               # one image and a batch
        np.testing.assert_allclose(shift_image(torch.as_tensor(a), shift).numpy(),
                                   np.asarray(j_shift_image(jnp.asarray(a), shift)),
                                   atol=ROTATE_ATOL, rtol=0)


def test_rotate_envmap_dict_matches_jax():
    rng = np.random.default_rng(6)
    lights = {n: dict(probe=rng.random((16, 32, 3)).astype(np.float32),
                      image=rng.random((8, 64, 3)).astype(np.float32)) for n in ('a', 'b')}
    for idx in (0, 1, 5, 127, 128, 200, 255):
        name, env = rotate_envmap_dict(lights, idx, 4, 32)
        jname, jenv = j_rotate_envmap_dict(lights, idx, 4, 32)
        assert name == jname
        for k in ('probe', 'image'):
            np.testing.assert_allclose(env[k].numpy(), np.asarray(jenv[k]),
                                       atol=ROTATE_ATOL, rtol=0)
    # one texel column per rotate_ratio steps: the probe rolled by one column
    _, env = rotate_envmap_dict(lights, 4, 4, 32)
    np.testing.assert_allclose(env['probe'].numpy(), np.roll(lights['a']['probe'], -1, axis=1),
                               atol=ROTATE_ATOL, rtol=0)
    assert rotate_envmap_dict(lights, 1, 0, 32) == ('b', lights['b'])


def test_reflect_matches_jax():
    rng = np.random.default_rng(8)
    d, n = rng.normal(size=(2, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(reflect(torch.as_tensor(d), torch.as_tensor(n)).numpy(),
                               np.asarray(j_reflect(jnp.asarray(d), jnp.asarray(n))),
                               atol=1e-6, rtol=0)


def test_load_lighting_matches_jax():
    """Exactly equal in one process (the procedural probes are seeded by
    ``hash(name)``, which Python randomises per process)."""
    cfg, jcfg = golden.sweep_frame_cfg(), jax_cfg()
    jcfg.test_light = list(golden.SWEEP_LIGHTS)
    ours, ref = datasets.load_lighting(cfg), j_load_lighting(jcfg)
    assert list(ours) == list(ref) and len(ours) == 8
    for name in ref:
        for k in ('probe', 'image'):
            assert ours[name][k].dtype == np.float32
            np.testing.assert_array_equal(ours[name][k], np.asarray(ref[name][k]))


def test_opencv_is_imported_only_inside_read_hdr():
    path = datasets.__file__
    tree = ast.parse(open(path).read(), path)
    owners = []
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if isinstance(node, ast.Import) and any(a.name == 'cv2' for a in node.names):
                    owners.append(fn.name)
    top = [a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names]
    assert owners == ['read_hdr'] and 'cv2' not in top


def _sweep_cfg(cfg, ground=False, rotate=False):
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.env_lvis.iter = 2
    cfg.tpu.ray_block = 1024
    cfg.tpu.bf16_mlp = False
    cfg.tpu.lvis_downscale = 2
    cfg.tpu.shadow_grid = 48
    cfg.tpu.lvis_sweep = True
    cfg.tpu.lvis_query_offset = 0.0
    cfg.tpu.distant_envmap = True
    cfg.vis_novel_light = True
    cfg.vis_ground_shading = ground
    cfg.vis_rotate_light = rotate
    cfg.rotate_ratio = 1
    # one light under the ground pass (each light runs one) or rotated
    cfg.test_light = LIGHTS[1:] if rotate else LIGHTS[:1] if ground else list(LIGHTS)
    return cfg


def _frame_keys(batch):
    return {k: batch[k] for k in ('ray_o', 'ray_d', 'near', 'far', 'H', 'W', 'cam_K',
                                  'cam_R', 'cam_T', 'mask_at_box')}


@pytest.fixture(scope="module", params=["lights", "ground", "rotate32"])
def sweeps(request):
    knobs = dict(ground=request.param == "ground", rotate=request.param == "rotate32")
    cfg = _sweep_cfg(golden.fixture_cfg(), **knobs)
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    batch, _ = golden.frame_batch(ctx, 32, 32)
    batch.novel_lights = datasets.load_lighting(cfg)
    port = orc.NovelLightRenderer(cfg, params, mcfg, device="cpu").render(batch)

    jcfg = _sweep_cfg(jax_cfg(), **knobs)
    jparams, jmcfg, jctx = jax_scene(jcfg)
    jbatch = jdotdict(ctx=jctx, **_frame_keys(golden.frame_batch(ctx, 32, 32)[0]))
    jbatch.novel_lights = j_load_lighting(jcfg)
    jr = jorc.NovelLightRenderer(jcfg, jparams, jmcfg._replace(knn_exact=True))
    jr.mesh = None          # the one-device path (ROADMAP, "Tests")
    with jax.default_matmul_precision('highest'):
        ref = jr.render(jbatch)
    return request.param, port, ref, batch


def _check(name, port, ref, hit, ground=False):
    for key in sorted(k for k in ref if k.endswith('_map')):
        a, b = port[key].numpy(), np.asarray(ref[key])
        if key in HIT_ONLY:
            a, b = a[hit], b[hit]
        p = golden.psnr(a, b)
        print(f"{name} {key}: {p:.2f} dB")
        bar = MIN_PSNR_SPEC if key == 'spec_map' else \
            MIN_PSNR_GROUND_SURF if ground and key == 'surf_map' else MIN_PSNR
        assert p >= bar, (name, key, p)


def test_novel_light_render_matches_jax(sweeps):
    kind, port, ref, batch = sweeps
    assert list(port.novel_light) == list(ref.novel_light)
    assert len(port.novel_light) == {"lights": 2, "ground": 1, "rotate32": 32}[kind]
    n = 32 * 32 if kind == "ground" else int(golden.frame_batch(
        batch.ctx, 32, 32)[1].sum())
    hit = port.base.acc_map.numpy() > 0
    for name, frame in port.novel_light.items():
        assert frame.rgb_map.shape == (n, 3) and torch.isfinite(frame.rgb_map).all()
        _check(name, frame, ref.novel_light[name], hit)
    _check("frame", port, ref, hit, ground=kind == "ground")
    if kind == "ground":
        assert port.acc_map.shape == (n,) and bool((port.acc_map == 1).all())
        assert batch.mask_at_box.all()
        assert not torch.equal(port.novel_light[LIGHTS[0]].rgb_map, port.rgb_map)
    else:
        rgbs = [f.rgb_map for f in port.novel_light.values()]
        assert not torch.equal(rgbs[0], rgbs[1])


def test_replace_light_selects_the_probe_on_the_device():
    cfg = golden.fixture_cfg()
    cfg.replace_light = 'olat0000-0000'
    cfg.test_light = []
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    lights = datasets.load_lighting(cfg)
    r = orc.SphereTracingRenderer(cfg, params, mcfg, device="cpu")
    env = r.select_envmap(golden.frame_batch(ctx, 8, 8)[0].__class__(novel_lights=lights))
    assert env.probe.dtype == torch.float32 and env.probe.shape == (16, 32, 3)
    np.testing.assert_array_equal(env.probe.numpy(), lights['olat0000-0000'].probe)
