"""The port's stage-1 training (``train/``, the training forward of
``models/anisdf.py`` and ``renderer/volume.py``, ``ops/grads.py``, the
initialisers of ``ops/mlp.py``) against the JAX package's on the CPU.

Scene: the sizes of ``tests/test_training.py:16-58`` (a 52-bone, 800-vertex
synthetic body, ``sdf_res`` 6, 4 samples a ray, 2 frames of 32 rays), the
JAX package's ``init_anisdf(PRNGKey(0))`` parameters on both sides, and rays
aimed at posed vertices with near and far 0.1 m either side of the target,
so that the samples fall in the HDQ band (rays of ``_fake_items`` there miss
the band of this thin body, which leaves the geometry's gradients zero).
Both sides take the exact top 3 by coordinate difference (the JAX package's
``knn_unchunked`` is swapped for it, as ``tests/test_torch_mesh.py`` does),
bf16 off, ``perturb`` 0.

One step: in float64 on both sides (the JAX package under
``jax.enable_x64``) the loss, every gradient and every parameter after the
clipped Adam step agree within 1e-4 relative (max |diff| / max |JAX| per
tensor; measured 2e-13 and 6e-12).  In float32 the loss and the stats agree
within 1e-4, and each gradient tensor within F32_GRAD_REL of the largest
gradient entry of its sub-network (``resd``, ``sdf``, ``rgb``, ``beta``):
the residual MLP's early layers, whose gradients are three to five orders
below that MLP's largest, differ by up to 2.9e-4 of it (measured against
the float64 step: the float32 rounding of the warped bigpose points, 1e-7,
goes through the 2^9 positional encoding; with the warp in float64 the
port comes within 1.1e-5; ``sdf`` and ``rgb`` agree within 1e-5).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from test_torch_mesh import exact_knn
from relightableavatar_tpu.config import default_cfg as j_default_cfg
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu.ops.mlp import linear_apply as j_linear_apply
from relightableavatar_tpu.renderer.volume import VolumeRenderer as JVolumeRenderer
from relightableavatar_tpu.smpl import synthetic
from relightableavatar_tpu.train import loss as j_loss
from relightableavatar_tpu.train import optimizer as j_opt
from relightableavatar_tpu.train.checkpoints import _flatten
from relightableavatar_tpu.train.trainer import Trainer as JTrainer
from relightableavatar_tpu.train.trainer import _volume_forward as j_volume_forward
from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
from relightableavatar_tpu.utils.flops import anisdf_hdq_flops as j_hdq_flops
from relightableavatar_tpu_torch.config import default_cfg
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops import grads, mlp
from relightableavatar_tpu_torch.renderer.volume import VolumeRenderer
from relightableavatar_tpu_torch.train import checkpoints, loss, optimizer
from relightableavatar_tpu_torch.train.trainer import Recorder, Trainer, ray_chunks
from relightableavatar_tpu_torch.utils import flops
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.tb_events import read_events

REL = 1e-4                  # the bar of the step's parity (max |diff| / max |ref|)
POINT_REL = 1e-3            # float32 per-point gradients of a training render
F32_GRAD_REL = 1e-3         # float32 gradients, over their sub-network's largest entry
R, S, B = 32, 4, 2
RAY_KEYS = ('ray_o', 'ray_d', 'near', 'far', 'rgb', 'msk')


def _cfg(c, tmp):
    c.n_bones = 52
    c.cond_dim = 156
    c.sdf_res = 6
    c.n_samples = S
    c.train.batch_size = B
    c.ep_iter = 4
    c.relighting = False
    c.record_dir = os.path.join(tmp, 'record')
    c.trained_model_dir = os.path.join(tmp, 'model')
    c.tpu.bf16_mlp = False
    c.tpu.knn_impl = 'pallas'
    c.perturb = 0
    return c


def _items(jctxs, seed=0):
    """Per frame: R rays from 2 m in front of the body toward posed vertices
    + N(0, 2 cm), near and far 0.1 m either side of the target."""
    rng = np.random.default_rng(seed)
    items = []
    for ctx in jctxs:
        center = np.asarray(ctx['Th']).reshape(3) + [0, 0, 1.0]
        ray_o = np.tile(center + [2.0, 0, 0], (R, 1)).astype(np.float32)
        pv = np.asarray(ctx['pverts']) @ np.asarray(ctx['R']).T + np.asarray(ctx['Th']).reshape(3)
        tgt = pv[rng.integers(0, len(pv), R)] + rng.normal(0, 0.02, (R, 3))
        dist = np.linalg.norm(tgt - ray_o, axis=-1)
        ray_d = (tgt - ray_o).astype(np.float32)
        ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
        items.append(dict(ctx=ctx, ray_o=ray_o, ray_d=ray_d,
                          near=(dist - 0.1).astype(np.float32), far=(dist + 0.1).astype(np.float32),
                          rgb=(rng.random((R, 3)) * 0.5).astype(np.float32),
                          msk=np.ones(R, np.float32)))
    return items


def _cast_tree(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a).astype(dtype))
        if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(np.asarray(a)), tree)


def _jax_step(jc, jm, jp, items, dtype, with_grads=True):
    """(loss, flat grads, flat params after JAX's step, stats) of one step of
    the JAX package in ``dtype``: the step of ``Trainer._build_step``, and
    the gradient of its loss (the mean of the frames' ``anisdf_losses`` of
    ``_volume_forward``) by ``jax.value_and_grad``."""
    w = j_loss.loss_weights_from_cfg(jc)
    jp = _cast_tree(jp, dtype)
    items = [dict(it, ctx=_cast_tree(it['ctx'], dtype)) for it in items]

    def loss_fn(params):
        losses = []
        for it in items:
            rays = jdotdict({k: jnp.asarray(it[k].astype(dtype)) for k in RAY_KEYS[:4]})
            out = j_volume_forward(params, jm, it['ctx'], rays, None, S, 0.0, False)
            gt = jdotdict(rgb=jnp.asarray(it['rgb'].astype(dtype)),
                          msk=jnp.asarray(it['msk'].astype(dtype)), ray_d=rays.ray_d)
            losses.append(j_loss.anisdf_losses(w, out, gt, 0)[0])
        return jnp.mean(jnp.stack(losses))

    lval, g = jax.jit(jax.value_and_grad(loss_fn))(jp) if with_grads else (np.nan, {})
    trainer = JTrainer(jc, jp, jm)
    batch = trainer.collate([jdotdict(it) for it in items])
    for k in RAY_KEYS:
        batch[k] = batch[k].astype(dtype)
    p2, _, stats = trainer._build_step()(trainer.params, trainer.opt_state, batch,
                                         jax.random.PRNGKey(3), jnp.asarray(0))
    flat = lambda t: {k: np.asarray(v) for k, v in _flatten(t).items()}
    return dict(loss=float(lval), grads=flat(g), params=flat(p2),
                stats={k: float(v) for k, v in stats.items()})


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("train"))
    jc, pc = _cfg(j_default_cfg(), tmp), _cfg(default_cfg(), tmp)
    jm, pm = j_anisdf.AniSDFConfig.from_cfg(jc), AniSDFConfig.from_cfg(pc)
    jp = j_anisdf.init_anisdf(jax.random.PRNGKey(0), jm)
    model = synthetic.make_body_model(n_bones=52, target_verts=800, seed=0)
    motion = synthetic.make_motion(4, n_bones=52)
    tv, tj, bA, _ = make_bigpose(model, motion['shapes'][0])
    jctxs = [make_frame_context(model, tv, tj, bA, motion['poses'][i], motion['Rh'][i],
                                motion['Th'][i], motion['shapes'][0]) for i in range(B)]
    items = _items(jctxs)
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    return dict(pc=pc, pm=pm, jc=jc, jm=jm, jp=jp, flat=flat, items=items)


def _reference(scene, dtype):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_anisdf, "knn_unchunked",
                   lambda p, v, K=3, exact=False, fast=False: exact_knn(p, v, K))
        with jax.enable_x64(dtype == np.float64):
            return _jax_step(scene['jc'], scene['jm'], scene['jp'], scene['items'], dtype)


@pytest.fixture(scope="module")
def ref32(scene):
    return _reference(scene, np.float32)


@pytest.fixture(scope="module")
def ref64(scene):
    return _reference(scene, np.float64)


def _port_trainer(scene, dtype=torch.float32, cfg=None):
    params = checkpoints.params_from_flat(scene['flat'], device="cpu", mcfg=scene['pm'])
    params = jax.tree_util.tree_map(lambda t: t.to(dtype), params)
    return Trainer(cfg or scene['pc'], params, scene['pm'], device="cpu")


def _port_batch(trainer, items, dtype=torch.float32):
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    pitems = [dotdict(it, ctx={k: cast(torch.as_tensor(np.asarray(v))) for k, v in it['ctx'].items()})
              for it in items]
    batch = trainer.collate(pitems)
    for k in RAY_KEYS:
        batch[k] = batch[k].to(dtype)
    return batch


def _rel(a, ref):
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_step_matches_jax_float64(scene, ref64):
    trainer = _port_trainer(scene, torch.float64)
    stats = trainer.step(_port_batch(trainer, scene['items'], torch.float64), 0)
    ref = ref64
    assert abs(float(stats.loss) - ref['loss']) <= REL * abs(ref['loss'])
    assert abs(float(stats.loss) - ref['stats']['loss']) <= REL * abs(ref['loss'])
    assert {k for k, _ in trainer.named} == set(ref['grads'])
    worst_g = worst_p = 0.0
    for k, t in trainer.named:
        assert np.abs(ref['grads'][k]).max() > 0 or k.endswith('/b'), f"{k}: no gradient"
        worst_g = max(worst_g, _rel(t.grad.numpy(), ref['grads'][k]))
        worst_p = max(worst_p, _rel(t.detach().numpy(), ref['params'][k]))
    print(f"float64: worst grad {worst_g:.3e}, worst param after the step {worst_p:.3e}")
    assert worst_g <= REL and worst_p <= REL


def test_step_matches_jax_float32(scene, ref32):
    trainer = _port_trainer(scene)
    stats = trainer.step(_port_batch(trainer, scene['items']), 0)
    ref = ref32
    assert set(stats) == set(ref['stats'])
    for k, v in ref['stats'].items():
        assert abs(float(stats[k]) - v) <= REL * max(abs(v), 1e-6), (k, float(stats[k]), v)
    scale = {}
    for k, g in ref['grads'].items():
        net = k.split('/')[0]
        scale[net] = max(scale.get(net, 0.0), float(np.abs(g).max()))
    worst = {}
    for k, t in trainer.named:
        net = k.split('/')[0]
        err = float(np.abs(t.grad.numpy() - ref['grads'][k]).max()) / scale[net]
        worst[net] = max(worst.get(net, 0.0), err)
    print("float32: worst grad error over its sub-network's largest entry", worst)
    assert max(worst.values()) <= F32_GRAD_REL and worst['sdf'] <= REL and worst['rgb'] <= REL, worst


@pytest.mark.parametrize("budget", [10**9, B * 8 * S], ids=["unchunked", "4_chunks"])
def test_chunked_step_matches_jax(scene, budget, tmp_path):
    """The JAX step's chunk rule at both budgets, in float64 against the
    JAX package's step (its chunks fold the key; perturb is 0)."""
    cfg = scene['pc'].clone()
    cfg.tpu.grad_sample_budget = budget
    assert ray_chunks(B, R, S, budget) == ((R, 1) if budget > B * R * S else (8, 4))
    jc = _cfg(j_default_cfg(), str(tmp_path))
    jc.tpu.grad_sample_budget = budget
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(j_anisdf, "knn_unchunked",
                   lambda p, v, K=3, exact=False, fast=False: exact_knn(p, v, K))
        jp = jax.tree_util.tree_map(jnp.asarray, _unflat_jax(scene['flat']))
        ref = _jax_step(jc, j_anisdf.AniSDFConfig.from_cfg(jc), jp, scene['items'], np.float64,
                        with_grads=False)
    trainer = _port_trainer(scene, torch.float64, cfg)
    stats = trainer.step(_port_batch(trainer, scene['items'], torch.float64), 0)
    assert abs(float(stats.loss) - ref['stats']['loss']) <= REL * abs(ref['stats']['loss'])
    for k, t in trainer.named:
        assert _rel(t.detach().numpy(), ref['params'][k]) <= REL, k


def _unflat_jax(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split('/')
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    for net in tree.values():
        if isinstance(net, dict) and 'layers' in net:
            net['layers'] = [net['layers'][str(i)] for i in range(len(net['layers']))]
    return tree


def test_chunked_grads_equal_unchunked(scene):
    """Four chunks against one, in float64, with stratified sampling on:
    with the rgb loss alone (a mean over rays, so the mean of equal chunks'
    means) the loss and every gradient agree within 1e-9 relative, as the
    chunks accumulate gradients with weight 1 / (B NC) and slice the one
    (B, R, S) draw of the step.  The masked means (eikonal, residual) and
    the soft IoU are taken per chunk, as in the JAX step; with them the
    loss still agrees within 1e-4 (tests/test_training.py's bar)."""
    for weights_on in (False, True):
        out = {}
        for budget in (10**9, B * 8 * S):
            cfg = scene['pc'].clone()
            cfg.tpu.grad_sample_budget = budget
            cfg.perturb = 1.0
            if not weights_on:
                for k in ('eikonal_loss_weight', 'observed_eikonal_loss_weight',
                          'resd_loss_weight', 'msk_loss_weight'):
                    cfg[k] = 0.0
            trainer = _port_trainer(scene, torch.float64, cfg)
            st = trainer.step(_port_batch(trainer, scene['items'], torch.float64), 0)
            out[budget] = (float(st.loss), {k: t.grad.numpy().copy() for k, t in trainer.named})
        (l_full, g_full), (l_chunk, g_chunk) = out.values()
        assert abs(l_full - l_chunk) < (1e-4 if weights_on else 1e-12 * abs(l_full))
        if not weights_on:
            for k in g_full:
                assert _rel(g_chunk[k], g_full[k]) <= 1e-9, k


class _RayItems:
    """Items keyed by (index, draw), as the dataset's are."""

    def __init__(self, scene, n=4):
        self.ctxs = [{k: torch.as_tensor(np.asarray(v)) for k, v in it['ctx'].items()}
                     for it in scene['items']]
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index, draw=None):
        it = _items([{k: v.numpy() for k, v in self.ctxs[index % 2].items()}],
                    seed=(7, int(index), int(draw or 0)))[0]
        return dotdict(it, ctx=self.ctxs[index % 2])


def test_midepoch_resume_is_bit_exact(scene, tmp_path):
    """Two epochs straight through against one and a half, a checkpoint
    with its aux state, and a fresh trainer resumed from it: parameters
    equal bit for bit, with stratified sampling on (the generator's state
    rides in aux) and the loader skipping the done items."""
    from relightableavatar_tpu_torch.data.datasets import DataLoader
    cfg = scene['pc'].clone()
    cfg.perturb = 1.0
    cfg.record_dir = str(tmp_path / 'rec')
    ds = _RayItems(scene)

    def fresh():
        return _port_trainer(scene, cfg=cfg), DataLoader(ds, infinite=True, seed=0, batch_size=B)

    ta, la = fresh()
    for ep in range(2):
        la.set_epoch(ep)
        ta.train_epoch(la, ep, cfg.ep_iter)
    tb, lb = fresh()
    lb.set_epoch(0)
    tb.train_epoch(lb, 0, cfg.ep_iter)
    lb.set_epoch(1)
    tb.train_epoch(lb, 1, 2)
    d = str(tmp_path / 'mid')
    checkpoints.save_model(d, tb.params, tb.optimizer, epoch=1, aux=tb.aux_state(2))
    tc, lc = fresh()
    found, epoch, aux = checkpoints.load_model(d, tc.params, tc.optimizer)
    start = tc.load_aux(aux)
    assert found and epoch == 1 and start == 2 and tc.recorder.step == tb.recorder.step
    assert tc.optimizer.count == tb.optimizer.count == 6
    lc.set_epoch(1)
    tc.train_epoch(lc, 1, cfg.ep_iter, start_it=start)
    for (k, a), (_, c) in zip(ta.named, tc.named):
        assert torch.equal(a, c), k
    assert tc.recorder.step == ta.recorder.step and sorted(tc.recorder.stats) == sorted(tb.recorder.stats)


# ---------------------------------------------------------------- losses
def _loss_case(case, rng):
    n, p = 48, 96
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    u = lambda *s: rng.random(s).astype(np.float32)
    rd = f(n, 3)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    if case == 'volume':
        mask = u(p) > 0.3
        mask[:5] = True
        out = dict(reg_mask=mask, residuals=f(p, 3) * 0.01 * mask[:, None],
                   gradients=f(p, 3) * mask[:, None], observed_gradients=f(p, 3) * mask[:, None],
                   acc_map=u(n), rgb_map=u(n, 3), norm_map=f(n, 3), sem_map=f(n, 20))
        batch = dict(msk=(u(n) > 0.5).astype(np.float32), rgb=u(n, 3), norm=f(n, 3), ray_d=rd,
                     sem=np.eye(20, dtype=np.float32)[rng.integers(0, 20, n)])
        return out, batch, {}
    if case in ('hinge', 'bce'):
        d = (f(n) * 0.01).astype(np.float32)
        key = 'closest_sdf' if case == 'hinge' else 'edge_sdf'
        return {key: d, 'acc_map': u(n)}, dict(msk=(u(n) > 0.5).astype(np.float32)), \
            dict(silh_loss_weight=0.1, silh_mode=case)
    # relight priors
    return dict(albedo=u(p, 3), albedo_jitter=u(p, 3), roughness=u(p, 1),
                roughness_jitter=u(p, 1), volume_albedo=u(p, 3)), {}, {}


@pytest.mark.parametrize("case", ["volume", "hinge", "bce", "relight"])
def test_losses_match_jax(case):
    """Every term and stat of ``anisdf_losses`` and its gradient with
    respect to each output, against the JAX package's, at a step where the
    residual weight's anneal has moved (gamma 0.5, milestone 3, step 7)."""
    out, batch, extra = _loss_case(case, np.random.default_rng(["volume", "hinge", "bce",
                                                                 "relight"].index(case)))
    cfgs = []
    for c in (default_cfg(), j_default_cfg()):
        c.resd_loss_weight_gamma = 0.5
        c.resd_loss_weight_milestone = 3
        for k, v in extra.items():
            c[k] = v
        cfgs.append(c)
    wt, wj = loss.loss_weights_from_cfg(cfgs[0]), j_loss.loss_weights_from_cfg(cfgs[1])
    assert wt == wj
    grad_keys = [k for k, v in out.items() if v.dtype == np.float32]

    tout = dotdict({k: torch.tensor(v, requires_grad=k in grad_keys) for k, v in out.items()})
    tl, tst = loss.anisdf_losses(wt, tout, dotdict({k: torch.tensor(v) for k, v in batch.items()}), 7)
    tgrads = torch.autograd.grad(tl, [tout[k] for k in grad_keys])

    def jfn(vals):
        o = jdotdict({**{k: jnp.asarray(v) for k, v in out.items()}, **vals})
        return j_loss.anisdf_losses(wj, o, jdotdict({k: jnp.asarray(v) for k, v in batch.items()}),
                                    jnp.asarray(7))
    (jl, jst), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(out[k]) for k in grad_keys})
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k, g in zip(grad_keys, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_safe_norm_has_a_finite_gradient_at_zero():
    x = torch.zeros(4, 3, requires_grad=True)
    (g,) = torch.autograd.grad(loss.eikonal(x, torch.tensor([1, 0, 1, 0])), x)
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------- optimiser
SCHEDULES = {
    'exponential': {'type': 'exponential', 'gamma': 0.1, 'decay_epochs': 7},
    'multi_step': {'type': 'multi_step', 'milestones': [2, 5], 'gamma': 0.5},
    'warmup_exponential': {'type': 'warmup_exponential', 'gamma': 0.1, 'decay_epochs': 9,
                           'warmup_factor': 0.25, 'warmup_epochs': 2, 'warmup_method': 'linear'},
    'warmup_exponential_constant': {'type': 'warmup_exponential', 'gamma': 0.3,
                                    'decay_epochs': 9, 'warmup_factor': 0.25,
                                    'warmup_epochs': 2, 'warmup_method': 'constant'},
    'warmup_multi_step': {'type': 'warmup_multi_step', 'milestones': [3, 6], 'gamma': 0.5,
                          'warmup_factor': 0.1, 'warmup_epochs': 1},
    'none': {'type': 'cosine'},
}


def _sched_cfgs(name):
    out = []
    for c in (default_cfg(), j_default_cfg()):
        c.ep_iter = 3
        c.train.epoch = 10
        c.train.scheduler = type(c.train.scheduler)(SCHEDULES[name])
        out.append(c)
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_matches_optax(name):
    pc, jc = _sched_cfgs(name)
    base = float(pc.train.lr)
    ours = optimizer.make_lr_schedule(pc, base)
    ref = j_opt.make_lr_schedule(jc, base)
    for step in range(40):
        r = float(ref(jnp.asarray(step))) if callable(ref) else float(ref)
        np.testing.assert_allclose(ours(step), r, rtol=2e-6, err_msg=f"step {step}")
    # the optimiser's groups follow it through LambdaLR
    p = {'sdf': {'w': torch.zeros(3, requires_grad=True)}}
    opt = optimizer.TrainOptimizer(pc, checkpoints.named_params(p))
    for step in range(6):
        assert opt.lr() == pytest.approx(ours(step), rel=1e-12)
        p['sdf']['w'].grad = torch.ones(3)
        opt.step()


def _small_params(rng):
    f = lambda *s: rng.normal(size=s)
    return {'resd': {'layers': [{'w': f(4, 5), 'b': f(5)}]}, 'sdf': {'layers': [{'v': f(5, 3),
            'g': f(3), 'b': f(3)}]}, 'rgb': {'l0': {'v': f(3, 2), 'g': f(2), 'b': f(2)}},
            'beta': np.float64(0.1)}


@pytest.mark.parametrize("optim,wd", [("adam", 0.0), ("adam", 0.01), ("radam", 0.0),
                                      ("radam", 0.01), ("sgd", 0.01)])
def test_optimizer_matches_optax(optim, wd):
    """Twelve steps of random gradients, some past the global-norm clip and
    the value clip, an lr table naming two modules and an unknown one, in
    float64 on both sides (optax under ``jax.enable_x64``; in float32 optax
    takes RAdam's 1 - b2^t in float32): parameters within 1e-9 relative of
    optax's, RAdam past its rectification threshold (rho_t reaches 5 at
    step 6)."""
    rng = np.random.default_rng(0)
    pc, jc = default_cfg(), j_default_cfg()
    for c in (pc, jc):
        c.train.optim = optim
        c.train.weight_decay = wd
        c.ep_iter = 2
        c.train.epoch = 10
        c.train.lr = 1e-2
        c.clip_grad_norm = 4.0
        c.clip_grad_value = 0.5
        c.train.lr_table = type(c.train.lr_table)({'signed_distance_network': 3e-3,
                                                  'render_network': 5e-2, 'unknown_net': 1.0})
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                _small_params(np.random.default_rng(0)))
    opt = optimizer.TrainOptimizer(pc, checkpoints.named_params(tp))
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(jnp.asarray, _small_params(rng))
        tx = j_opt.make_optimizer(jc, jp)
        state = tx.init(jp)
        for step in range(12):
            scale = 3.0 if step % 3 == 0 else 0.2
            g = jax.tree_util.tree_map(lambda a: rng.normal(size=np.shape(a)) * scale,
                                       _small_params(rng))
            upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, upd)
            for (k, t), (_, gv) in zip(opt.named, checkpoints.named_params(g)):
                t.grad = torch.tensor(np.asarray(gv))
            opt.step()
            ref = {k: np.asarray(v) for k, v in _flatten(jp).items()}
            for k, t in opt.named:
                np.testing.assert_allclose(t.numpy(), ref[k], rtol=1e-9, atol=1e-12,
                                           err_msg=f"step {step} {k}")


def test_lr_table_labels_match_optax():
    """The group of each top-level key: the rate of one Adam step of unit
    gradients under optax's multi_transform, against the port's groups."""
    pc, jc = default_cfg(), j_default_cfg()
    for c in (pc, jc):
        c.train.lr_table = type(c.train.lr_table)({'signed_distance_network': 1e-6,
                                                  'global_env_map_': 3e-3, 'unknown': 1.0})
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                _small_params(np.random.default_rng(1)))
    jp['env'] = jnp.zeros((2, 2, 3))
    tx = j_opt.make_optimizer(jc, jp)
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.ones_like, jp), tx.init(jp), jp)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), jp)
    opt = optimizer.TrainOptimizer(pc, checkpoints.named_params(tp))
    table = optimizer.lr_table(pc)
    for k, u in _flatten(upd).items():
        label = optimizer.group_label(k, table)
        # optax's float32 moments put its unit step 7e-6 off the rate
        np.testing.assert_allclose(opt.lr(label), -float(np.asarray(u).ravel()[0]), rtol=1e-4,
                                   err_msg=k)
    assert sorted(opt.labels) == ['__default__', 'env', 'sdf']


def test_unknown_optimizer_fails_loudly():
    c = default_cfg()
    c.train.optim = 'lion'
    with pytest.raises(ValueError, match='lion'):
        optimizer.TrainOptimizer(c, [('sdf/w', torch.zeros(2, requires_grad=True))])


# ---------------------------------------------------------------- forward pieces
def test_training_render_matches_jax():
    """``VolumeRenderer.render(training=True)`` of the fixture's stage-1
    network (float32, 64 rays of 16 samples in blocks of 48) against the
    JAX package's: the maps, weights and z_vals within 1e-4, the per-point
    terms of the first 64 points (the JAX renderer cuts every key to the ray
    count) within POINT_REL of their largest entry (measured 3.1e-4 on the
    canonical gradients: softplus(100 x)'s second derivative in float32)."""
    cfg = golden.fixture_cfg()
    cfg.relighting = False
    cfg.n_samples = 16
    cfg.tpu.ray_block = 48
    cfg.perturb = 0
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    rng = np.random.default_rng(5)
    pv = ctx['pverts'].numpy() @ ctx['R'].numpy().T + ctx['Th'].numpy().reshape(3)
    o = pv.mean(0) + [2.5, 0, 0]
    tgt = pv[rng.integers(0, len(pv), 64)]
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    rays = dict(ray_o=np.tile(o, (64, 1)).astype(np.float32), ray_d=d.astype(np.float32),
                near=np.full(64, 1.5, np.float32), far=np.full(64, 3.5, np.float32))
    ours = VolumeRenderer(cfg, params, mcfg, device="cpu").render(dotdict(ctx=ctx, **rays),
                                                                  training=True)
    jcfg = jax_cfg()
    jcfg.relighting = False
    jcfg.n_samples = 16
    jcfg.tpu.ray_block = 48
    jcfg.perturb = 0
    jparams, jmcfg, jctx = jax_scene(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_anisdf, "knn_unchunked",
                   lambda p, v, K=3, exact=False, fast=False: exact_knn(p, v, K))
        ref = JVolumeRenderer(jcfg, jparams, jmcfg).render(jdotdict(ctx=jctx, **rays),
                                                           training=True)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        got = ours[k].detach().numpy()[:len(v)]
        if k in ('residuals', 'gradients', 'observed_gradients'):
            err = np.abs(got - v).max() / (np.abs(v).max() or 1.0)
            print(f"{k}: max |diff| / max |JAX| {err:.3e}")
            assert err <= POINT_REL, k
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-4, err_msg=k)
    assert ours.rgb_map.requires_grad and ours.residuals.shape == (2 * 48 * 16, 3)


def test_training_render_raises_for_the_relight_network():
    cfg = golden.fixture_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="10b"):
        anisdf.forward(params, mcfg, ctx, torch.zeros(4, 3), torch.ones(4, 3), training=True)


def test_spatial_gradients_agree_and_stay_differentiable():
    w = torch.randn(3, 2, dtype=torch.float64, requires_grad=True)
    f = lambda x: torch.sin(x @ w)
    x = torch.randn(7, 3, dtype=torch.float64)
    val, g = grads.spatial_gradient_fwd(f, x)
    np.testing.assert_allclose(g.detach().numpy(), (torch.cos(x @ w)[:, :1] * w[:, 0]).detach()
                               .numpy(), rtol=1e-12)
    np.testing.assert_allclose(grads.spatial_gradient_fd(f, x, 1e-6).detach().numpy(),
                               g.detach().numpy(), atol=1e-5)
    (gw,) = torch.autograd.grad(g.sum(), w)       # through the normals' backward
    assert torch.isfinite(gw).all() and gw.abs().sum() > 0
    assert torch.equal(val, f(x))


def test_bf16_linear_weight_gradient_matches_jax_transpose():
    """The bfloat16 linear layer's weight and input cotangents on the CPU
    route against the JAX package's ``dot_general`` transpose (bfloat16
    operands, float32 product)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    gy = rng.normal(size=(64, 8)).astype(np.float32)
    jgx, jgw = jax.grad(lambda xx, ww: jnp.sum(j_linear_apply({'w': ww, 'b': jnp.asarray(b)}, xx,
                                                              bf16=True) * gy),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    y = mlp.linear_apply({'w': tw, 'b': torch.tensor(b)}, tx, bf16=True)
    gx, gw = torch.autograd.grad((y * torch.tensor(gy)).sum(), [tx, tw])
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=2 ** -8)
    assert np.abs(gw.numpy()).min() > 0


# ---------------------------------------------------------------- init
def _jax_init(mcfg):
    return {k: np.asarray(v) for k, v in _flatten(j_anisdf.init_anisdf(jax.random.PRNGKey(0),
                                                                      mcfg)).items()}


@pytest.mark.parametrize("relight", [False, True])
def test_init_anisdf_layout_matches_jax(relight):
    jm = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6, relight=relight,
                               env_h=2, env_w=4)
    pm = AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6, relight=relight, env_h=2, env_w=4)
    ref = _jax_init(jm)
    ours = dict(checkpoints.named_params(anisdf.init_anisdf(torch.Generator().manual_seed(0), pm)))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in ours.values())
    # structural zeros and constants of both initialisations
    for side in (ours, ref):
        a = {k: np.asarray(v) for k, v in side.items()}
        assert not a['resd/layers/8/b'].any()
        assert not a['sdf/layers/0/v'][3:].any() and not a['sdf/layers/0/b'].any()
        assert not a['sdf/layers/4/v'][-(a['sdf/layers/0/v'].shape[0] - 3):].any()
        np.testing.assert_array_equal(a['sdf/layers/8/b'], -0.5)
        assert float(a['beta']) == pytest.approx(0.1)
        for k in a:
            if k.endswith('/g'):
                np.testing.assert_allclose(a[k], np.linalg.norm(a[k[:-1] + 'v'], axis=0),
                                           rtol=1e-6)


SPHERE_SLOPE = (0.7, 1.3)       # d sdf / d|x| of the fitted line
SPHERE_RADIUS = (0.2, 0.45)     # where the fitted line crosses zero
SPHERE_CORR = 0.9


def test_geometric_init_is_a_sphere():
    """IDR's geometric initialisation starts the SDF as a sphere: on 2000
    points with 0.1 < |x| < 1 the initial SDF of both packages grows with
    |x| along a line of slope within SPHERE_SLOPE (correlation >= 0.9) that
    crosses zero at a radius within SPHERE_RADIUS (measured: JAX slope 1.01,
    radius 0.32; the port 1.05, 0.30; the softplus hidden units shift the
    nominal 0.5 inward)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(2000, 3))
    x = (d / np.linalg.norm(d, axis=-1, keepdims=True)
         * rng.uniform(0.1, 1.0, (2000, 1))).astype(np.float32)
    r = np.linalg.norm(x, axis=-1)
    pm = AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6)
    jm = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6)
    ours = anisdf.init_anisdf(torch.Generator().manual_seed(0), pm)
    with torch.no_grad():
        s_t = anisdf.sdf_feat(ours, pm, torch.tensor(x))[0].numpy()[:, 0]
    s_j = np.asarray(j_anisdf.sdf_feat(j_anisdf.init_anisdf(jax.random.PRNGKey(0), jm), jm,
                                       jnp.asarray(x))[0])[:, 0]
    for name, s in (("port", s_t), ("JAX", s_j)):
        slope, icept = np.polyfit(r, s, 1)
        corr = np.corrcoef(r, s)[0, 1]
        print(f"{name}: slope {slope:.3f}, zero at {-icept / slope:.3f}, corr {corr:.3f}")
        assert SPHERE_SLOPE[0] < slope < SPHERE_SLOPE[1] and corr >= SPHERE_CORR
        assert SPHERE_RADIUS[0] < -icept / slope < SPHERE_RADIUS[1]


# ---------------------------------------------------------------- recorder, flops
def test_recorder_jsonl_events_and_images(tmp_path):
    c = default_cfg()
    c.record_dir = str(tmp_path)
    c.record_tb = True
    r = Recorder(c)
    r.update(dict(loss=1.0, psnr=20.0))
    r.step = 7
    r.record()
    r.update(dict(loss=0.5, psnr=22.0))
    r.step = 8
    r.record()
    r.epoch = 3
    r.record_images({'val_pred_gt': np.full((8, 16, 3), 0.5, np.float32)})
    r.close()
    rows = [json.loads(line) for line in open(tmp_path / 'scalars.jsonl')]
    assert rows[-1]['loss'] == pytest.approx(0.75) and rows[-1]['step'] == 8
    (ev,) = [p for p in os.listdir(tmp_path) if p.startswith('events.out.tfevents')]
    events = read_events(str(tmp_path / ev))
    assert [e[1] for e in events[1:]] == [7, 8] and events[2][2]['psnr'] == pytest.approx(21.0)
    from relightableavatar_tpu_torch.data.image_io import read_rgb
    img = read_rgb(str(tmp_path / 'images' / 'ep0003_val_pred_gt.png'))
    assert img.shape == (8, 16, 3) and int(img[0, 0, 0]) == 127
    state = r.state_dict()
    r2 = Recorder(c)
    r2.load_state_dict(json.loads(json.dumps(state)))
    assert r2.step == 8 and r2.stats['loss'].avg == pytest.approx(0.75)
    r2.close()


def test_flops_match_jax():
    pm = AniSDFConfig(sdf_res=8)
    jm = j_anisdf.AniSDFConfig(sdf_res=8)
    assert flops.anisdf_hdq_flops(pm, 100, 6890) == j_hdq_flops(jm, 100, 6890)
    per_point = flops.train_step_flops(pm, 1, 6890)
    mlps = flops.anisdf_hdq_flops(pm, 1, 6890) - 8 * 6890
    assert per_point == 8 * 6890 + 6 * mlps + 3 * flops.render_net_flops(pm)
    assert flops.compiled_cost(None) == {'flops': 0.0, 'bytes': 0.0}


def test_trainer_refuses_what_is_not_ported(scene):
    for key, val in (('relighting', True), ('profiling.enabled', True)):
        cfg = scene['pc'].clone()
        node, leaf = (cfg.profiling, 'enabled') if '.' in key else (cfg, key)
        node[leaf] = val
        with pytest.raises(NotImplementedError, match="10b"):
            _port_trainer(scene, cfg=cfg)
