"""The port's geometry distillation (``train/distill.py``) against the JAX
package's ``relightableavatar_tpu/train/distill.py`` on the CPU, on the
canonical vertices and normals of a 52-bone, 800-vertex synthetic body
(``tests/test_training.py``'s) and ``init_anisdf(PRNGKey(0))`` parameters
with ``sdf_res`` 6.

``target_sdf``: the JAX package takes the 4 neighbours with its plain XLA
``knn_unchunked`` (a bfloat16 superset re-measured in float32), the port an
exact top 4; the two agree wherever their top-4 sets agree.  One Adam step
of ``distill_geometry`` on the points JAX's first step samples, in float64
on both sides (the JAX package under ``jax.enable_x64``, its KNN swapped
for an exact jnp top 4).  A short run of the port's own descends.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads  # noqa: F401 (fixture)
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu.ops.knn import knn_unchunked as j_knn_unchunked
from relightableavatar_tpu.smpl import synthetic
from relightableavatar_tpu.train import distill as j_distill
from relightableavatar_tpu.train.checkpoints import _flatten
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.train import checkpoints, distill

TARGET_ATOL = 1e-6          # float32 distances where the top-4 sets agree
STEP_REL = 1e-6             # float64: max |diff| / max |JAX| of the step's update
BATCH = 256


@pytest.fixture(scope="module")
def body():
    model = synthetic.make_body_model(n_bones=52, target_verts=800, seed=0)
    motion = synthetic.make_motion(4, n_bones=52)
    tv, tj, bA, _ = make_bigpose(model, motion['shapes'][0])
    ctx = make_frame_context(model, tv, tj, bA, motion['poses'][0], motion['Rh'][0],
                             motion['Th'][0], motion['shapes'][0])
    jm = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6)
    pm = AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6)
    jp = j_anisdf.init_anisdf(jax.random.PRNGKey(0), jm)
    return dict(tverts=np.asarray(ctx['tverts']), tnorm=np.asarray(ctx['tnorm']), jm=jm, pm=pm,
                jp=jp, flat={k: np.asarray(v) for k, v in _flatten(jp).items()})


def _exact_topk(pts, verts, K=4):
    d2 = jnp.sum((pts[:, None, :] - verts[None]) ** 2, axis=-1)
    nd, idx = jax.lax.top_k(-d2, K)
    return -nd, idx


def test_target_sdf_matches_jax_where_the_neighbours_agree(body):
    rng = np.random.default_rng(0)
    tv, tn = body['tverts'], body['tnorm']
    pts = (tv[rng.integers(0, len(tv), 2000)] + rng.normal(0, 0.05, (2000, 3))).astype(np.float32)
    ref = np.asarray(j_distill.target_sdf(jnp.asarray(pts), jnp.asarray(tv), jnp.asarray(tn)))
    _, jnn = j_knn_unchunked(jnp.asarray(pts), jnp.asarray(tv), K=4)
    ours = distill.target_sdf(torch.tensor(pts), torch.tensor(tv), torch.tensor(tn)).numpy()
    d2 = ((pts[:, None] - tv[None]) ** 2).sum(-1)
    same = np.all(np.sort(np.asarray(jnn), 1) == np.sort(np.argsort(d2, 1)[:, :4], 1), axis=1)
    print(f"top-4 sets agree on {same.mean():.2%} of the points")
    assert same.mean() >= 0.95 and ours.shape == (2000, 1)
    np.testing.assert_allclose(ours[same], ref[same], rtol=0, atol=TARGET_ATOL)


def _jax_first_batch(tverts, seed=0):
    """The points the JAX package's ``distill_geometry`` samples in its first
    step (its ``sample_batch``)."""
    tv = jnp.asarray(tverts)
    lo, hi = tv.min(0) - 0.3, tv.max(0) + 0.3
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    k1, k2, k3, k4 = jax.random.split(sub, 4)
    V = tv.shape[0]
    near = tv[jax.random.randint(k1, (BATCH // 2,), 0, V)] \
        + jax.random.normal(k2, (BATCH // 2, 3)) * 0.02
    mid = tv[jax.random.randint(k3, (BATCH // 4,), 0, V)] \
        + jax.random.normal(k4, (BATCH // 4, 3)) * 0.08
    unif = lo + (hi - lo) * jax.random.uniform(k1, (BATCH // 4, 3))
    return np.asarray(jnp.concatenate([near, mid, unif], axis=0))


def test_one_distill_step_matches_jax(body, monkeypatch):
    """One step on JAX's first batch: the loss, each SDF parameter's update
    within STEP_REL, beta set to beta_final, the residual MLP's last layer
    zeroed and every other parameter untouched."""
    tv, tn = body['tverts'].astype(np.float64), body['tnorm'].astype(np.float64)
    monkeypatch.setattr(j_distill, "knn_unchunked", lambda p, v, K=3: _exact_topk(p, v, K))
    with jax.enable_x64(True):
        pts = _jax_first_batch(tv)
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), body['jp'])
        jout, jloss = j_distill.distill_geometry(jp, body['jm'], tv, tn, steps=1, batch=BATCH)
        ref = {k: np.asarray(v) for k, v in _flatten(jout).items()}
    monkeypatch.setattr(distill, "sample_points", lambda *a, **k: torch.tensor(pts))
    params = checkpoints.params_from_flat(body['flat'], device="cpu", mcfg=body['pm'])
    params = jax.tree_util.tree_map(lambda t: t.double(), params)
    out, loss = distill.distill_geometry(params, body['pm'], tv, tn, steps=1, batch=BATCH)
    assert abs(loss - jloss) <= 1e-9 * abs(jloss)
    ours = {k: t.numpy() for k, t in checkpoints.named_params(out)}
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if k.startswith('sdf/'):
            upd = v - body['flat'][k]
            err = float(np.abs(ours[k] - v).max() / np.abs(upd).max())
            assert np.abs(upd).max() > 0 and err <= STEP_REL, (k, err)
        else:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert float(ours['beta']) == pytest.approx(0.01) and not ours['resd/layers/8/w'].any()


def test_distill_descends(body):
    """Twenty steps of 512 points from the initial sphere: the loss on a
    fixed batch falls by half or more."""
    tv, tn = body['tverts'], body['tnorm']
    params = checkpoints.params_from_flat(body['flat'], device="cpu", mcfg=body['pm'])
    tvt, tnt = torch.tensor(tv), torch.tensor(tn)
    pts = distill.sample_points(tvt, tvt.min(0).values - 0.3, tvt.max(0).values + 0.3, 1024,
                                torch.Generator().manual_seed(1))
    before = float(distill.distill_loss(params['sdf'], body['pm'], pts, tvt, tnt).detach())
    out, _ = distill.distill_geometry(params, body['pm'], tv, tn, steps=20, batch=512, lr=2e-3)
    after = float(distill.distill_loss(out['sdf'], body['pm'], pts, tvt, tnt).detach())
    print(f"distill loss on a fixed batch: {before:.4f} -> {after:.4f}")
    assert after <= 0.5 * before
