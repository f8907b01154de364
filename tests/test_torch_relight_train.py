"""The port's stage-2 (relight) training against the JAX package's on the
CPU: the relight network's training forward (``models/anisdf.py``), the
training branch of ``render_human_block`` (``renderer/sphere_tracing.py``),
one whole train step (``train/trainer.py``), the profiler's schedule
(``utils/profiling.py``) and the step's analytic FLOP count
(``utils/flops.py``).

Scene: the fixture avatar (full width, its relight heads; frame 0, the
context of ``tests/jax_fixture_scene.py``) with the residual MLP's zero
last weight re-drawn (seeded), so that every layer has a gradient, and its
32 x 64 envmap averaged down to 4 x 8 (``env_h`` 2, ``env_w`` 4: 2 x 4
light texels, as ``tests/test_training.py``'s relight step has); 4
surface-trace and 2 shadow iterations, ``network_chunk_size`` 1024 (the
shadow block), 3 samples a ray, 2 frames of 16 rays (``eval/train_check.py``'s
layout: from 2 m in front of the body toward N(0, 0.3 m) around its
centre, near 1.5 m, far 3 m; about half hit) and the lr table of
``configs/base.yaml``'s relighting_cfg.  Both sides take the exact top 3
(``tpu.knn_impl`` pallas: the port's plain version by coordinate
difference, the JAX package's ``knn_unchunked(exact=True)`` by the float64
matmul identity, which picks the same neighbours but on ties below
float64's rounding), bf16 off; the smoothness pair's jitter is JAX's own
draw, fed to the port.  Everything runs in float64 (the JAX package under
``jax.enable_x64``).  The step is also held to JAX's on a mesh geometry
prior (``use_geometry True geometry_mesh can_mesh.npz``, the stage-2 step
of the two-stage pipeline): the frame context of a ``can_mesh.npz`` written
as ``tests/test_torch_datasets.py:_prior`` writes one, here from the
fixture body with its vertices in a seeded order other than SMPL's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from relightableavatar_tpu.config import default_cfg as j_default_cfg
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.models.context import make_bigpose as j_make_bigpose
from relightableavatar_tpu.models.context import make_frame_context_mesh as j_mesh_ctx
from relightableavatar_tpu.ops.envmap import gen_light_xyz as j_gen_light_xyz
from relightableavatar_tpu.renderer.sphere_tracing import render_human_block as j_render_block
from relightableavatar_tpu.smpl.body_model import BodyModel as JBodyModel
from relightableavatar_tpu.train import loss as j_loss
from relightableavatar_tpu.train.checkpoints import _flatten
from relightableavatar_tpu.train.trainer import Trainer as JTrainer
from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
from relightableavatar_tpu.utils.profiling import Profiler as JProfiler
from relightableavatar_tpu_torch.config import default_cfg
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.envmap import gen_light_xyz
from relightableavatar_tpu_torch.renderer.sphere_tracing import render_human_block
from relightableavatar_tpu_torch.train import checkpoints
from relightableavatar_tpu_torch.train.trainer import Trainer
from relightableavatar_tpu_torch.utils import flops
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.profiling import Profiler

STEP_REL = 1e-6     # float64: max |diff| / max |JAX| of each tensor (loss, grads, params)
FWD_REL = 1e-8      # float64: the forward's and the block's outputs
R, S, B = 16, 3, 2
RAY_KEYS = ('ray_o', 'ray_d', 'near', 'far', 'rgb', 'msk')
BLOCK_KEYS = ('rgb_map', 'acc_map', 'edge_sdf', 'closest_sdf', 'reg_mask', 'residuals',
              'observed_gradients', 'gradients', 'albedo', 'roughness', 'albedo_jitter',
              'roughness_jitter', 'volume_albedo')


def _cfg(c, tmp):
    c.env_h, c.env_w = 2, 4
    c.n_samples = S
    c.train.batch_size = B
    c.ep_iter = 4
    c.network_chunk_size = 1024
    c.train.lr = 5e-3
    c.train.lr_table = type(c.train.lr_table)({'residual_deformation_network': 5e-6,
                                               'signed_distance_network': 5e-6,
                                               'roughness_network': 5e-5})
    c.sphere_tracing.iter = 4
    c.obj_lvis.iter = 2
    c.record_dir = os.path.join(tmp, 'record')
    c.trained_model_dir = os.path.join(tmp, 'model')
    return c


def _items(ctx, seed=0):
    """B frames of fixture frame 0's context, R rays each in
    ``eval/train_check.py``'s layout, near 1.5 m and far 3 m; random colours
    and the mask of the rays the port's inference trace hits."""
    rng = np.random.default_rng(seed)
    center = np.asarray(ctx['Th']).reshape(3) + [0, 0, 1.0]
    items = []
    for _ in range(B):
        ray_o = np.tile(center + [2.0, 0, 0], (R, 1)).astype(np.float32)
        ray_d = (center + rng.normal(0, 0.3, (R, 3)) - ray_o).astype(np.float32)
        ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
        items.append(dict(ctx=ctx, ray_o=ray_o, ray_d=ray_d, near=np.full(R, 1.5, np.float32),
                          far=np.full(R, 3.0, np.float32),
                          rgb=(rng.random((R, 3)) * 0.5).astype(np.float32),
                          msk=(rng.random(R) < 0.5).astype(np.float32)))
    return items


def _cast_tree(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a).astype(dtype))
        if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(np.asarray(a)), tree)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("relight_train"))
    jc, pc = _cfg(jax_cfg(), tmp), _cfg(golden.fixture_cfg(), tmp)
    jp, jm, jctx = jax_scene(jc)
    pm = AniSDFConfig.from_cfg(pc)._replace(sdf_res=8)
    assert jm.relight and pm.relight and jm.knn_exact
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    w = flat['resd/layers/8/w']
    flat['resd/layers/8/w'] = ((np.random.default_rng(0).random(w.shape) * 2 - 1)
                               / w.shape[0] ** 0.5).astype(np.float32)
    flat['env'] = flat['env'].reshape(4, 8, 8, 8, 3).mean(axis=(1, 3))
    jp = _unflat(flat)
    return dict(pc=pc, jc=jc, pm=pm, jm=jm, jp=jp, flat=flat, items=_items(jctx))


@pytest.fixture(scope="module")
def prior_items(tmp_path_factory):
    """``_items`` of frame 0 with the context of a mesh geometry prior: the
    fixture body's bigpose vertices, skinning weights, faces, joints and
    parents written to ``can_mesh.npz`` (``tests/test_torch_datasets.py:_prior``)
    with the vertices permuted (seeded), read back and posed by the JAX
    package's ``make_frame_context_mesh``, as its dataset does under
    ``use_geometry``."""
    path = str(tmp_path_factory.mktemp("prior") / 'can_mesh.npz')
    model = JBodyModel(os.path.join(golden.REPO, 'fixtures/synthetic_body.npz'))
    motion = dict(np.load(os.path.join(golden.REPO, 'fixtures/synthetic_motion.npz')))
    tverts, tjoints, _, _ = j_make_bigpose(model, motion['shapes'][0])
    perm = np.random.default_rng(1).permutation(len(tverts))
    np.savez(path, verts=np.asarray(tverts)[perm], faces=np.argsort(perm)[model.faces],
             weights=np.asarray(model.weights)[perm], tjoints=tjoints, parents=model.parents)
    prior = dict(np.load(path))
    ctx = j_mesh_ctx(prior, motion['poses'][0], motion['Rh'][0], motion['Th'][0])
    return _items(ctx)


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split('/')
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    for net in tree.values():
        if isinstance(net, dict) and 'layers' in net:
            net['layers'] = [net['layers'][str(i)] for i in range(len(net['layers']))]
    return tree


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _port_params(scene, dtype=torch.float64):
    params = checkpoints.params_from_flat(scene['flat'], device="cpu", mcfg=scene['pm'])
    return jax.tree_util.tree_map(lambda t: t.to(dtype), params)


def _port_ctx(it, dtype=torch.float64):
    return {k: torch.tensor(np.array(v)).to(dtype) if np.asarray(v).dtype.kind == 'f'
            else torch.tensor(np.array(v)) for k, v in it['ctx'].items()}


def _jax_noise(key, dtype=np.float64):
    """The jitter of each frame, as the JAX step draws it: the step key split
    into one key a frame, N(0, 1) of shape (R * S, 3) times 0.02."""
    return np.stack([np.asarray(jax.random.normal(k, (R * S, 3)) * 0.02, dtype)
                     for k in jax.random.split(key, B)])


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------- forward
def test_relight_forward_training_matches_jax(scene, x64):
    """``forward(training=True)`` of the relight network at posed vertices
    + N(0, 10 cm) of frame 0, with JAX's jitter: raw = [albedo, rough, norm,
    occ] (C = 8) masked to the band, albedo, roughness, the jittered pair
    and the geometry terms within FWD_REL of JAX's largest entry; no
    jittered pair without a noise."""
    it = scene['items'][0]
    ctx = it['ctx']
    rng = np.random.default_rng(3)
    pv = np.asarray(ctx['pverts']) @ np.asarray(ctx['R']).T + np.asarray(ctx['Th']).reshape(3)
    x = pv[rng.integers(0, len(pv), R * S)] + rng.normal(0, 0.1, (R * S, 3))
    v = rng.normal(size=(R * S, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (R * S, 3)) * 0.02)
    jp = _cast_tree(scene['jp'], np.float64)
    ref = jax.jit(lambda p, c, x, v: j_anisdf.forward(p, scene['jm'], c, x, v, training=True,
                                                      jitter_key=key))(
        jp, _cast_tree(it['ctx'], np.float64), jnp.asarray(x), jnp.asarray(v))
    params = _port_params(scene)
    ours = anisdf.forward(params, scene['pm'], _port_ctx(it), torch.tensor(x), torch.tensor(v),
                          training=True, jitter_noise=torch.tensor(noise))
    assert set(ours) == set(ref) and ours.raw.shape == (R * S, 8) and ours.raw.requires_grad
    assert 0 < int(np.asarray(ref.reg_mask).sum()) < R * S
    for k in ref:
        err = _rel(ours[k].detach().numpy(), np.asarray(ref[k]))
        assert err <= FWD_REL, (k, err)
    plain = anisdf.forward(params, scene['pm'], _port_ctx(it), torch.tensor(x), torch.tensor(v),
                           training=True)
    assert 'albedo_jitter' not in plain and torch.equal(plain.raw, ours.raw)


# ---------------------------------------------------------------- block
def _block_args(scene):
    trainer = JTrainer(scene['jc'], scene['jp'], scene['jm'])
    return trainer.rcfg, trainer.st_surf, trainer.st_obj


def test_render_block_training_matches_jax(scene, x64):
    """``render_human_block(training=True)`` of frame 0's rays: the same
    output keys as JAX's (no inference-only maps), every output within
    FWD_REL, and the gradient of a fixed random functional of all of them
    with respect to every parameter within STEP_REL of JAX's."""
    it = scene['items'][0]
    rcfg, st_surf, st_obj = _block_args(scene)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (R * S, 3)) * 0.02)
    rng = np.random.default_rng(11)
    per_ray = ('rgb_map', 'acc_map', 'edge_sdf', 'closest_sdf', 'volume_albedo')
    weights = {k: rng.normal(size=(R if k in per_ray else R * S,)) for k in BLOCK_KEYS}
    jm = scene['jm']
    jlx, jla = j_gen_light_xyz(jm.env_h, jm.env_w, jm.env_r)
    jls = 1.0 / jnp.sqrt(jla / np.pi)
    jctx = _cast_tree(it['ctx'], np.float64)
    rays = [jnp.asarray(it[k].astype(np.float64)) for k in RAY_KEYS[:4]]

    def jfn(p):
        out = j_render_block(p, scene['jm'], jctx, *rays, j_anisdf.global_env_map(p, scene['jm']),
                             jlx, jla, jls, st_surf, st_obj, rcfg, True, key)
        return _functional(out, weights, jnp), out

    (_, ref), jgrads = jax.value_and_grad(jfn, has_aux=True)(_cast_tree(scene['jp'], np.float64))
    params = _port_params(scene)
    named = checkpoints.named_params(params)
    for _, t in named:
        t.requires_grad_(True)
    lx, la = gen_light_xyz(jm.env_h, jm.env_w, jm.env_r)
    stats = {}
    out = render_human_block(params, scene['pm'], _port_ctx(it),
                             *[torch.tensor(it[k]).double() for k in RAY_KEYS[:4]],
                             anisdf.global_env_map(params, scene['pm']), lx, la,
                             1.0 / torch.sqrt(la / np.pi), st_surf, st_obj, rcfg,
                             training=True, jitter_noise=torch.tensor(noise), stats=stats)
    assert set(out) == set(ref) == set(BLOCK_KEYS)
    acc = np.asarray(ref['acc_map'])
    assert (acc > 0.5).sum() >= R // 4 and (acc < 0.5).sum() >= R // 4 and stats['shadow_rays'] > 0
    for k in ref:
        err = _rel(out[k].detach().numpy(), np.asarray(ref[k]))
        assert err <= FWD_REL, (k, err)
    grads = torch.autograd.grad(_functional(out, weights, torch), [t for _, t in named],
                                allow_unused=True)
    jg = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    for (k, _), g in zip(named, grads):
        g = np.zeros_like(jg[k]) if g is None else g.numpy()
        assert _rel(g, jg[k]) <= STEP_REL, (k, _rel(g, jg[k]))
    assert np.abs(jg['albedo/layers/0/w']).max() > 0 and np.abs(jg['env']).max() > 0


def _functional(out, weights, xp):
    total = 0.0
    for k, w in weights.items():
        v = out[k].astype(xp.float64) if xp is jnp else out[k].double()
        w = xp.asarray(w) if xp is jnp else torch.tensor(w)
        total = total + xp.sum(v.reshape(v.shape[0], -1) * w.reshape(-1, 1))
    return total


# ---------------------------------------------------------------- step
def _jax_relight_step(scene, key, items=None):
    """(loss, flat grads, flat params after the step, stats) of one float64
    stage-2 step of the JAX package on ``items`` (default ``scene['items']``,
    the SMPL context's): the loss of ``Trainer._build_step``
    (``frame_loss`` vmapped over the frames with the step key split into one
    key a frame: ``render_human_block(training=True)`` and
    ``anisdf_losses``, their mean) by ``jax.value_and_grad``, and the
    update of the JAX trainer's optimiser (``make_optimizer``: clipping,
    the lr table, Adam) on those gradients."""
    jc, jm = scene['jc'], scene['jm']
    jp = _cast_tree(scene['jp'], np.float64)
    items = scene['items'] if items is None else items
    w = j_loss.loss_weights_from_cfg(jc)
    trainer = JTrainer(jc, jp, jm)
    lx, la = j_gen_light_xyz(jm.env_h, jm.env_w, jm.env_r)
    ls = 1.0 / jnp.sqrt(la / np.pi)
    ctx = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                 *[_cast_tree(it['ctx'], np.float64) for it in items])
    col = lambda n: jnp.asarray(np.stack([it[n] for it in items]).astype(np.float64))

    def loss_fn(params):
        def frame_loss(c, ray_o, ray_d, near, far, rgb, msk, k):
            out = j_render_block(params, jm, c, ray_o, ray_d, near, far,
                                 j_anisdf.global_env_map(params, jm), lx, la, ls,
                                 trainer.st_surf, trainer.st_obj, trainer.rcfg, True, k)
            return j_loss.anisdf_losses(w, jdotdict(out),
                                        jdotdict(rgb=rgb, msk=msk, ray_d=ray_d), 0)
        losses, stats = jax.vmap(frame_loss)(ctx, *[col(n) for n in RAY_KEYS],
                                             jax.random.split(key, B))
        return jnp.mean(losses), jax.tree_util.tree_map(jnp.mean, stats)

    (lval, stats), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    updates, _ = trainer.tx.update(g, trainer.opt_state, jp)
    p2 = jax.tree_util.tree_map(lambda a, u: a + u, jp, updates)
    flat = lambda t: {k: np.asarray(v) for k, v in _flatten(t).items()}
    return dict(loss=float(lval), grads=flat(g), params=flat(p2),
                stats={k: float(v) for k, v in stats.items()})


def _port_batch(trainer, items, dtype=torch.float64):
    pitems = [dotdict(it, ctx=_port_ctx(it, dtype)) for it in items]
    batch = trainer.collate(pitems)
    for k in RAY_KEYS:
        batch[k] = batch[k].to(dtype)
    return batch


def _assert_step_matches_jax(scene, items):
    """One stage-2 step of ``items`` in float64: the loss and every stat,
    every parameter's gradient and every parameter after the clipped Adam
    step within STEP_REL of the largest entry of JAX's tensor."""
    key = jax.random.PRNGKey(3)
    ref = _jax_relight_step(scene, key, items)
    noise = torch.tensor(_jax_noise(key)).reshape(B, R, S, 3)
    trainer = Trainer(scene['pc'], _port_params(scene), scene['pm'], device="cpu")
    stats = trainer.step(_port_batch(trainer, items), 0, jitter_noise=noise)
    assert set(stats) == set(ref['stats'])
    for k, v in ref['stats'].items():
        assert abs(float(stats[k]) - v) <= STEP_REL * max(abs(v), 1e-12), (k, float(stats[k]), v)
    assert abs(float(stats.loss) - ref['loss']) <= STEP_REL * abs(ref['loss'])
    assert {k for k, _ in trainer.named} == set(ref['grads'])
    worst_g = worst_p = 0.0
    for k, t in trainer.named:
        # the stage-1 render MLP rides in the checkpoint, unused by stage 2
        unused = k.startswith('rgb/')
        assert (np.abs(ref['grads'][k]).max() > 0) != unused or k.endswith('/b'), k
        if unused:
            assert not t.grad.any() and np.array_equal(ref['params'][k], scene['flat'][k]), k
            continue
        worst_g = max(worst_g, _rel(t.grad.numpy(), ref['grads'][k]))
        worst_p = max(worst_p, _rel(t.detach().numpy(), ref['params'][k]))
    print(f"stage-2 float64: worst grad {worst_g:.3e}, worst param after the step {worst_p:.3e}")
    assert worst_g <= STEP_REL and worst_p <= STEP_REL
    assert trainer.shadow_rays > 0


def test_relight_step_matches_jax_float64(scene, x64):
    """One stage-2 step in float64 on the SMPL context, held to JAX's
    (``_assert_step_matches_jax``)."""
    _assert_step_matches_jax(scene, scene['items'])


def test_relight_step_on_mesh_prior_matches_jax_float64(scene, prior_items, x64):
    """The stage-2 step of the two-stage pipeline, on a mesh geometry
    prior's context (``prior_items``), held to JAX's at the same bars as on
    SMPL's; the prior's vertex order is not SMPL's, so the KNN's neighbour
    indices differ from the SMPL context's.  About 56 s under ``-n 6``."""
    smpl, prior = scene['items'][0]['ctx'], prior_items[0]['ctx']
    assert not np.array_equal(np.asarray(prior['pverts']), np.asarray(smpl['pverts']))
    np.testing.assert_allclose(np.sort(np.asarray(prior['pverts']), axis=0),
                               np.sort(np.asarray(smpl['pverts']), axis=0), atol=1e-4)
    _assert_step_matches_jax(scene, prior_items)


def test_train_step_relight_runs(scene):
    """The port's twin of ``tests/test_training.py::test_train_step_relight_runs``,
    in float32 with the port's own jitter: a finite loss, and the lr table
    (``signed_distance_network`` 5e-6 against the base 5e-3) keeps the SDF
    MLP nearly frozen while the envmap moves."""
    items = scene['items']
    trainer = Trainer(scene['pc'], _port_params(scene, torch.float32), scene['pm'], device="cpu")
    sdf0 = [t.detach().clone() for k, t in trainer.named if k.startswith('sdf/')]
    env0 = trainer.params['env'].detach().clone()
    stats = trainer.step(_port_batch(trainer, items, torch.float32), 0)
    assert np.isfinite(float(stats.loss))
    d_sdf = max(float((t.detach() - t0).abs().max())
                for (k, t), t0 in zip([kt for kt in trainer.named if kt[0].startswith('sdf/')],
                                      sdf0))
    d_env = float((trainer.params['env'].detach() - env0).abs().max())
    assert d_env > d_sdf * 10, (d_env, d_sdf)


# ---------------------------------------------------------------- profiler, flops
@pytest.mark.parametrize("sched", [(10, 5, 5, 10, 5), (3, 1, 0, 2, 0)],
                         ids=["defaults", "no_warmup_repeat_forever"])
def test_profiler_phase_matches_jax(sched, tmp_path):
    cfgs = []
    for c in (default_cfg(), j_default_cfg()):
        c.record_dir = str(tmp_path)
        for k, v in zip(('skip_first', 'wait', 'warmup', 'active', 'repeat'), sched):
            c.profiling[k] = v
        cfgs.append(c)
    ours, ref = Profiler(cfgs[0]), JProfiler(cfgs[1])
    assert ours.record_dir == ref.record_dir == os.path.join(str(tmp_path), 'profile')
    assert [ours._phase(i) for i in range(201)] == [ref._phase(i) for i in range(201)]


def test_profiler_writes_a_trace_per_active_window(tmp_path):
    c = default_cfg()
    c.record_dir = str(tmp_path)
    c.profiling.enabled = True
    for k, v in dict(skip_first=1, wait=1, warmup=0, active=2, repeat=2).items():
        c.profiling[k] = v
    prof = Profiler(c)
    for _ in range(9):
        torch.ones(8).sum()
        prof.step()
    prof.close()
    assert sorted(os.listdir(tmp_path / 'profile')) == ['trace_0.json', 'trace_1.json']


def test_relight_step_flops_by_hand():
    """``relight_step_flops`` at AniSDFConfig's widths, counted out: the
    KNN 8 x 6890 a query; the residual MLP 2 x (63 + 156) x 256 + 7 x 2 x
    256^2 + 2 x 256 x 3 and the SDF MLP 2 x 51 x 256 + 7 x 2 x 256^2 + 2 x
    256 x 257 a query (xyz_res 10, sdf_res 8); the heads 2 x (256 x 128 +
    128^2 + 128 x 3) and 2 x (256 x 128 + 128^2 + 128) a point."""
    m = AniSDFConfig(sdf_res=8)
    knn = 8 * 6890
    resd = 2 * (63 + 156) * 256 + 7 * 2 * 256 ** 2 + 2 * 256 * 3
    sdf = 2 * 51 * 256 + 7 * 2 * 256 ** 2 + 2 * 256 * 257
    heads = 2 * (256 * 128 + 128 ** 2 + 128 * 3) + 2 * (256 * 128 + 128 ** 2 + 128)
    assert flops.relight_heads_flops(m) == heads
    rays, n_s, lights, it_c, it_s, shadow = 2048, 3, 512, 16, 4, 300000
    hand = (rays * it_c + shadow * it_s) * (knn + resd + sdf) \
        + 2 * rays * (knn + 3 * (resd + sdf)) \
        + rays * n_s * (knn + 6 * (resd + sdf) + 3 * heads + 3 * (sdf + heads)) \
        + 3 * 150 * rays * lights
    assert flops.relight_step_flops(m, rays, n_s, lights, 6890, it_c, it_s, shadow) == hand
