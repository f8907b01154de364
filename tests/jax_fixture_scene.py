"""The fixture avatar on the JAX package's side, for the port's parity tests:
frame 0's context, the avatar's parameters (read by the port's loader and
turned into a JAX pytree; the two loaders agree, see
``test_torch_context_weights.py``) and the config of ``golden.fixture_cfg``
(float32, exact KNN).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightableavatar_tpu.config import default_cfg
from relightableavatar_tpu.models import anisdf
from relightableavatar_tpu.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu.ops.envmap import gen_light_xyz
from relightableavatar_tpu.renderer.sphere_tracing import (RelightRenderConfig,
                                                           render_human_block)
from relightableavatar_tpu.renderer.tracing import STConfig
from relightableavatar_tpu.smpl.body_model import BodyModel
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.weights import load_params


TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads while a module that imports this runs: the tests
    run in several worker processes, and torch's default of one thread a
    core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def jax_cfg():
    """The JAX config of ``golden.fixture_cfg()``."""
    cfg = default_cfg()
    cfg.n_bones = 52
    cfg.cond_dim = 52 * 3
    cfg.relighting = True
    cfg.n_samples = 3
    cfg.dist_th = 0.125
    cfg.obj_lvis.dist_th = 0.125
    cfg.tpu.bf16_mlp = False
    cfg.tpu.knn_impl = 'pallas'
    return cfg


def jax_scene(cfg=None):
    """(params, mcfg, ctx) of fixture frame 0 for the JAX package."""
    cfg = cfg if cfg is not None else jax_cfg()
    root = golden.REPO
    model = BodyModel(os.path.join(root, 'fixtures/synthetic_body.npz'))
    motion = dict(np.load(os.path.join(root, 'fixtures/synthetic_motion.npz')))
    sh = motion['shapes'][0]
    tv, tj, bA, _ = make_bigpose(model, sh)
    ctx = make_frame_context(model, tv, tj, bA, motion['poses'][0],
                             motion['Rh'][0], motion['Th'][0], sh)
    mcfg = anisdf.AniSDFConfig.from_cfg(cfg)._replace(sdf_res=8)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          load_params(os.path.join(root, 'fixtures/synthetic_avatar_params.npz'),
                                      device="cpu"))
    return params, mcfg, ctx


def jax_golden_bundle(jscene, rcfg_extra, grid=None, volume=None):
    """The 256-ray golden bundle (``golden.render_golden_bundle``) through the
    JAX package's ``render_human_block``, with ``rcfg_extra`` render knobs
    and the grid and volume passed as they are."""
    params, mcfg, ctx = jscene
    cfg = jax_cfg()
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    tctx = {"Th": torch.as_tensor(np.array(ctx["Th"]))}
    ray_o, ray_d = golden.golden_bundle_rays(tctx)
    P = len(ray_o)
    lx, la = gen_light_xyz(2, 4, 10.0)
    st_surf = STConfig.from_cfg(cfg.sphere_tracing)
    st_obj = STConfig.from_cfg({**dict(cfg.sphere_tracing), **dict(cfg.obj_lvis)})
    rcfg = RelightRenderConfig(shadow_block=1024, distant_envmap=True, **rcfg_extra)
    with jax.default_matmul_precision('highest'):
        out = render_human_block(
            params, mcfg, ctx, jnp.asarray(ray_o), jnp.asarray(ray_d),
            jnp.full(P, 0.8), jnp.full(P, 4.0), jnp.full((2, 4, 3), 0.6),
            lx, la, 1.0 / jnp.sqrt(la / np.pi), st_surf, st_obj, rcfg, False,
            shadow_sdf_grid=grid, lvis_volume=volume)
    return {k: np.asarray(v) for k, v in out.items()}
