"""The port's hash-grid encoding (``ops/hashgrid.py``) and its ``e_type='hash'``
wiring against the JAX package's on the CPU.

- ``hash_encode`` and the gradient of the table within 1e-6 of
  ``relightableavatar_tpu/ops/hashgrid.py`` on 600 seeded points (inside,
  on and outside the box), for the model's grid (16 levels, 2 features,
  2^19 rows: 6 dense and 10 hashed levels) and two small grids (2^8 rows:
  2 dense and 2 hashed levels, 2 and 3 features; measured: 3e-8 and 0).
- The network: ``AniSDFConfig.from_cfg`` takes ``e_type``; the JAX
  package's ``init_anisdf`` keys and shapes are the port's and load
  through ``params_from_flat``; on ``golden.hash_params``' network the
  residual and SDF MLPs and the HDQ agree with JAX's within 1e-5, and
  ``render_human_block`` of the golden bundle agrees as
  ``test_torch_options.py`` holds the other options.
- Training: a twin of ``tests/test_hashgrid_wiring.py:44`` (six steps of
  the stage-1 trainer at ``test_torch_train.py``'s sizes descend and move
  the tables) and the training entry with ``e_type hash`` on the generated
  tree: it trains, saves the tables under the JAX keys and resumes.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from test_torch_datasets import tree  # noqa: F401 (fixture)
from test_torch_options import _hold, _render_pair
from test_torch_train import _cfg, _items, _port_batch
from test_torch_train_data import _cfgs
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu.ops import hashgrid as jh
from relightableavatar_tpu.smpl import synthetic
from relightableavatar_tpu.train.checkpoints import _flatten
from relightableavatar_tpu_torch.config import default_cfg
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops import hashgrid as th
from relightableavatar_tpu_torch.train.cli import train as port_train
from relightableavatar_tpu_torch.train.trainer import Trainer
from relightableavatar_tpu_torch.weights import param_shapes, params_from_flat

ATOL = 1e-6
NET_ATOL = 1e-5

GRIDS = {
    "model": dict(n_levels=16, n_features=2, log2_hashmap_size=19, base_resolution=16),
    "small": dict(n_levels=4, n_features=2, log2_hashmap_size=8, base_resolution=4),
    "small_f3": dict(n_levels=4, n_features=3, log2_hashmap_size=8, base_resolution=4),
}


def _points(n=600, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.3, 2.3, (n, 3)).astype(np.float32)
    x[:5] = [[2, 2, 2], [-2, -2, -2], [0, 0, 0], [2.5, 0, 0], [1.99999, 1.9999, -1.99999]]
    return x


@pytest.mark.parametrize("grid", list(GRIDS))
def test_hash_encode_and_gradient_match_jax(grid):
    # JAX's other fields keep their defaults, the model's aggregation
    jc, tc = jh.HashGridConfig(**GRIDS[grid]), th.HashGridConfig(**GRIDS[grid])
    assert tc.out_dim == jc.out_dim and tc.level_resolutions == jc.level_resolutions
    rng = np.random.default_rng(1)
    table = rng.normal(0, 0.1, (jc.n_levels, jc.table_size * jc.n_features)).astype(np.float32)
    x = _points()
    w = rng.normal(size=(len(x), jc.out_dim)).astype(np.float32)

    def weighted(t):
        out = jh.hash_encode(t, jc, jnp.asarray(x))
        return jnp.sum(out * w), out

    (_, ref), gref = jax.jit(jax.value_and_grad(weighted, has_aux=True))(jnp.asarray(table))
    ref, gref = np.asarray(ref), np.asarray(gref)
    tt = torch.tensor(table, requires_grad=True)
    got = th.hash_encode(tt, tc, torch.as_tensor(x))
    assert got.shape == ref.shape == (len(x), jc.out_dim)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL, rtol=0)
    (got * torch.as_tensor(w)).sum().backward()
    assert np.abs(gref).max() > 0
    np.testing.assert_allclose(tt.grad.numpy(), gref, atol=ATOL, rtol=0)


def test_hash_init_and_cfg():
    cfg = default_cfg()
    cfg.e_type = 'hash'
    cfg.n_bones, cfg.cond_dim = 22, 66
    mcfg = AniSDFConfig.from_cfg(cfg)
    assert mcfg.e_type == 'hash'
    assert mcfg.hash_cfg() == th.HashGridConfig()
    jh_cfg = j_anisdf.AniSDFConfig(e_type='hash').hash_cfg()
    assert tuple(mcfg.hash_cfg()) == (jh_cfg.n_levels, jh_cfg.n_features,
                                      jh_cfg.log2_hashmap_size, jh_cfg.base_resolution)
    assert mcfg.hash_cfg().out_dim == jh_cfg.out_dim
    params = anisdf.init_anisdf(torch.Generator().manual_seed(0), mcfg)
    hcfg = mcfg.hash_cfg()
    shape = (hcfg.n_levels, hcfg.table_size * hcfg.n_features)
    assert params['sdf_hash'].shape == params['resd_hash'].shape == shape
    assert abs(float(params['sdf_hash'].std()) / np.sqrt(2.0 / hcfg.table_size) - 1) < 0.01
    assert params['resd']['layers'][0]['w'].shape[0] == hcfg.out_dim + 66
    flat = param_shapes(mcfg)
    assert flat['sdf_hash'] == shape and flat['sdf/layers/0/v'][0] == hcfg.out_dim
    cfg.e_type = 'ngp'
    with pytest.raises(ValueError):
        AniSDFConfig.from_cfg(cfg)


def test_jax_hash_checkpoint_keys_load():
    """The JAX package's ``init_anisdf`` keys and shapes (its flat
    checkpoint layout, ``resd_hash`` and ``sdf_hash`` among them) are the
    port's, and such a checkpoint loads through ``params_from_flat``."""
    jm = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, relight=True, e_type='hash')
    pm = AniSDFConfig(n_bones=52, cond_dim=156, relight=True, e_type='hash')
    shapes = jax.eval_shape(lambda: j_anisdf.init_anisdf(jax.random.PRNGKey(0), jm))
    empty = jax.tree.map(lambda v: np.empty(v.shape, np.float32), shapes)
    flat = {k: tuple(v.shape) for k, v in _flatten(empty).items()}
    assert {'resd_hash', 'sdf_hash'} <= set(flat)
    assert flat == {k: tuple(v) for k, v in param_shapes(pm).items()}
    params = params_from_flat({k: np.zeros(v, np.float32) for k, v in flat.items()},
                              device="cpu", mcfg=pm)
    assert params['sdf_hash'].shape == flat['sdf_hash']


@pytest.fixture(scope="module")
def hash_net():
    """A hash network (relight heads on) from ``golden.hash_params`` (a
    seeded port init with the SDF output's bias lowered by 0.6 m: at init
    the zero set lies outside the HDQ band and no ray of the golden bundle
    hits) on both sides, and both configs."""
    jm = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, relight=True, e_type='hash',
                               dist_th=0.125, knn_exact=True)
    pm = AniSDFConfig(n_bones=52, cond_dim=156, relight=True, e_type='hash', dist_th=0.125)
    pp = golden.hash_params(pm, device="cpu")
    return jm, pm, jax.tree.map(lambda t: jnp.asarray(t.numpy()), pp), pp


def test_hash_network_matches_jax(hash_net):
    jm, pm, jp, pp = hash_net
    ctx, _, _ = golden.load_fixture(device="cpu")
    _, _, jctx = jax_scene(jax_cfg())
    rng = np.random.default_rng(2)
    pv = ctx["pverts"].numpy()
    x = ((pv[rng.integers(0, len(pv), 1024)] + rng.normal(0, 0.05, (1024, 3)))
         @ ctx["R"].numpy().T + ctx["Th"].numpy()).astype(np.float32)
    c = rng.uniform(-1, 1, (1024, 3)).astype(np.float32)
    cond = rng.normal(0, 0.2, (1024, 156)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jsdf, jfeat = j_anisdf.sdf_feat(jp, jm, jnp.asarray(c))
        jres = j_anisdf.residuals(jp, jm, jnp.asarray(c), jnp.asarray(cond))
        jhdq = jax.jit(lambda p, cx, xx: j_anisdf.hdq_sdf(p, jm, cx, xx))(jp, jctx, jnp.asarray(x))
    with torch.no_grad():
        sdf, feat = anisdf.sdf_feat(pp, pm, torch.as_tensor(c))
        res = anisdf.residuals(pp, pm, torch.as_tensor(c), torch.as_tensor(cond))
        hdq = anisdf.hdq_sdf(pp, pm, ctx, torch.as_tensor(x))
    for got, ref in ((sdf, jsdf), (feat, jfeat), (res, jres), (hdq, jhdq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=NET_ATOL, rtol=0)


def test_hash_render_matches_jax(hash_net):
    jm, pm, jp, pp = hash_net
    ctx, _, _ = golden.load_fixture(device="cpu")
    jparams, _, jctx = jax_scene(jax_cfg())
    scene = dict(ctx=ctx, params=pp, mcfg=pm, jparams=jp, jmcfg=jm, jctx=jctx)
    port, ref = _render_pair(scene, {})
    _hold("e_type=hash", port, ref)


def test_hash_train_step_descends(tmp_path):
    """Twin of ``tests/test_hashgrid_wiring.py:44`` on the port's trainer."""
    c = _cfg(default_cfg(), str(tmp_path))
    c.e_type = 'hash'
    mcfg = AniSDFConfig.from_cfg(c)
    params = anisdf.init_anisdf(torch.Generator().manual_seed(0), mcfg)
    model = synthetic.make_body_model(n_bones=52, target_verts=800, seed=0)
    motion = synthetic.make_motion(4, n_bones=52)
    tv, tj, bA, _ = make_bigpose(model, motion['shapes'][0])
    jctxs = [make_frame_context(model, tv, tj, bA, motion['poses'][i], motion['Rh'][i],
                                motion['Th'][i], motion['shapes'][0]) for i in range(2)]
    trainer = Trainer(c, params, mcfg, device="cpu")
    batch = _port_batch(trainer, _items(jctxs))
    hash0 = trainer.params['sdf_hash'].detach().clone()
    losses = [float(trainer.step(batch, i).loss) for i in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert float((trainer.params['sdf_hash'].detach() - hash0).abs().max()) > 0


def test_hash_train_entry_saves_and_resumes(tree, tmp_path):
    """``train e_type hash`` on the CPU (tubeman's config, 1 epoch of 2
    steps of 2 frames x 32 rays x 4 samples), then ``resume True`` for a
    second epoch: the checkpoint carries the tables under the JAX keys."""
    common = ['e_type', 'hash', 'exp_name', 'tubeman_verify',
              'trained_model_dir', str(tmp_path / 'trained'), 'record_dir', str(tmp_path / 'rec'),
              'n_rays', '32', 'n_samples', '4', 'train.batch_size', '2', 'ep_iter', '2',
              'train.num_workers', '2', 'eval_ep', '100', 'save_ep', '100',
              'tpu.bf16_mlp', 'False', 'record_tb', 'False']
    cfg, _ = _cfgs(tree, [*common, 'resume', 'False', 'train.epoch', '1'])
    trainer = port_train(cfg, device="cpu")
    assert trainer.mcfg.e_type == 'hash'
    path = os.path.join(cfg.trained_model_dir, 'latest.npz')
    with np.load(path) as f:
        first = f['net:sdf_hash']
        assert first.shape == tuple(param_shapes(trainer.mcfg)['sdf_hash'])
    cfg, _ = _cfgs(tree, [*common, 'resume', 'True', 'train.epoch', '2'])
    trainer = port_train(cfg, device="cpu")
    assert trainer.optimizer.count == 4
    with np.load(path) as f:
        assert int(f['epoch']) == 2 and json.loads(str(f['aux']))['recorder']['step'] == 4
        assert not np.array_equal(f['net:sdf_hash'], first)
