"""The port's ``SphereTracingRenderer.render`` against the JAX package's on a
whole frame, and the port's 64px bench-stack frame against the stored
golden.

Frame: fixture frame 0, camera 0 of ``make_cameras(4, 32, 32)`` (168 rays
in the body's bounds), exact path, 6 surface / 2 shadow iterations, the
learned 16x32 env map sampled per direction, ``ray_block`` 64 (three
blocks, the last padded), exact KNN on both sides, JAX matmuls at
'highest' precision.
"""
import jax
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from relightableavatar_tpu.renderer.orchestrate import SphereTracingRenderer as JRenderer
from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer

# measured on this frame: every map but spec_map at 114.8 dB (acc_map) to
# 120 dB, so 100 dB.  spec_map divides by |ldot| + 1e-8
# (sphere_tracing.py:580-581, in both packages): at a texel 9e-5 rad from
# grazing a 6e-6 difference of the normal moves that weight by 5 %
# (ROADMAP, "spec_map parity"); measured 47.14 dB, max |diff| 0.058.
MIN_PSNR = 100.0
MIN_PSNR_SPEC = 45.0
GOLDEN_MIN_PSNR = 45.0      # check_golden's bar
SKIP_ATOL = 1e-5            # tests/test_golden.py:194, miss skip on vs off
SPEC_SKIP_ATOL = 1e-3


def _frame_cfg(cfg):
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.tpu.ray_block = 64
    return cfg


@pytest.fixture(scope="module")
def frames():
    cfg = _frame_cfg(golden.fixture_cfg())
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    batch, mab = golden.frame_batch(ctx, 32, 32)
    port = SphereTracingRenderer(cfg, params, mcfg, device="cpu").render(batch)

    jcfg = _frame_cfg(jax_cfg())
    jparams, jmcfg, jctx = jax_scene(jcfg)
    jbatch = jdotdict(ray_o=batch.ray_o, ray_d=batch.ray_d, near=batch.near,
                      far=batch.far, ctx=jctx)
    jrenderer = JRenderer(jcfg, jparams, jmcfg._replace(knn_exact=True))
    # the reference's one-device path: the tests' 8 virtual CPU devices
    # would otherwise shard the rays over a mesh, whose eager multi-device
    # ops are where XLA's CPU client aborts now and then (ROADMAP, "Tests")
    jrenderer.mesh = None
    with jax.default_matmul_precision('highest'):
        ref = jrenderer.render(jbatch)
        ref = {k: np.asarray(v) for k, v in ref.items() if k != 'envmap'}
    port = {k: v.numpy() for k, v in port.items() if k != 'envmap'}
    return port, ref, int(mab.sum())


def test_frame_render_matches_jax(frames):
    port, ref, n = frames
    assert set(port) == set(ref)
    assert port['rgb_map'].shape == (n, 3) and (port['acc_map'] > 0).any()
    for key in sorted(ref):
        p = golden.psnr(port[key], ref[key])
        print(f"{key}: {p:.2f} dB")
        assert p >= (MIN_PSNR_SPEC if key == 'spec_map' else MIN_PSNR), (key, p)


@pytest.fixture(scope="module")
def benchstack():
    return golden.render_benchstack_64(device="cpu")


def test_benchstack_64_vs_stored_golden(benchstack):
    """The bench stack (48-node grid, slice sweep, 2x-coarser visibility,
    distant envmap) through the port's renderer against
    ``tests/golden_benchstack_64px.npy``, made by the JAX package with its
    default KNN selection; measured 53.54 dB."""
    img, n = benchstack
    assert img.shape == (n, 3) and np.isfinite(img).all()
    ok, p = golden.check_golden(img)
    print(f"bench stack vs golden: {p:.2f} dB")
    assert ok and p >= GOLDEN_MIN_PSNR


def test_benchstack_64_miss_skip_keeps_pixels(benchstack):
    """The frame-global miss skip is exact: the same pixels within float
    reassociation of the batched MLPs (measured max |diff| 3.6e-6)."""
    img, n = benchstack
    skip, n2 = golden.render_benchstack_64(device="cpu",
                                           cfg_overrides={'surf_miss_skip': True})
    assert n2 == n
    np.testing.assert_allclose(skip, img, atol=SKIP_ATOL, rtol=0)


def test_frame_miss_skip_skips_blocks_and_keeps_pixels():
    """On a frame whose blocks are small enough that whole blocks hold
    only proven misses, those blocks are not rendered and their maps come
    back zero, every map equal to the unskipped frame's.  Other block
    contents reassociate the batched MLP sums: measured max |diff| 5.4e-6,
    and 6.3e-5 on spec_map, whose 1 / |ldot| weight amplifies a 3e-6 normal
    difference at grazing texels (bar 1e-3 there)."""
    cfg = golden.benchstack_cfg({'ray_block': 32, 'shadow_grid': 17})
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    batch, _ = golden.frame_batch(ctx, 32, 32)
    base = SphereTracingRenderer(cfg, params, mcfg, device="cpu")
    out = base.render(batch)
    cfg.tpu.surf_miss_skip = True
    skip_r = SphereTracingRenderer(cfg, params, mcfg, device="cpu")
    skip = skip_r.render(batch)
    assert skip_r.last_frame.blocks_rendered < skip_r.last_frame.blocks
    assert base.last_frame.blocks_rendered == base.last_frame.blocks
    assert set(skip) == set(out)
    for key in out:
        if key != 'envmap':
            atol = SPEC_SKIP_ATOL if key == 'spec_map' else SKIP_ATOL
            torch.testing.assert_close(skip[key], out[key], atol=atol, rtol=0, msg=key)
