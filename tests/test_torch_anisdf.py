"""The port's HDQ SDF and network forward against the JAX package's exact-KNN
path (``knn_exact=True``) on 4096 world points around fixture frame 0.

Where the two top-3 sets agree: |dSDF| <= 1e-4, raw outputs within 1e-4 and
normal cosine >= 0.9999.  The two KNNs differ at near ties only (JAX's exact
path on the CPU uses the HIGHEST-precision matmul identity, the port the
coordinate difference), on at most 0.5% of the points.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu.ops.knn import knn_unchunked
from relightableavatar_tpu.smpl.body_model import BodyModel
from relightableavatar_tpu_torch.eval.golden import REPO, fixture_cfg, load_fixture
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops.knn import knn_top3

P = 4096
MAX_SET_DIFF = 0.005


@pytest.fixture(scope="module")
def scene():
    cfg = fixture_cfg()
    tctx, tparams, tmcfg = load_fixture(cfg, device="cpu")
    model = BodyModel(os.path.join(REPO, 'fixtures/synthetic_body.npz'))
    motion = dict(np.load(os.path.join(REPO, 'fixtures/synthetic_motion.npz')))
    sh = motion['shapes'][0]
    tv, tj, bA, _ = make_bigpose(model, sh)
    jctx = make_frame_context(model, tv, tj, bA, motion['poses'][0],
                              motion['Rh'][0], motion['Th'][0], sh)
    jmcfg = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=8, dist_th=0.125,
                                  relight=True, knn_exact=True)
    # the same arrays as a JAX pytree (the loaders agree: test_torch_context_weights)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    rng = np.random.default_rng(1)
    pv = tctx["pverts"].numpy()
    R, Th = tctx["R"].numpy(), tctx["Th"].numpy()
    x = ((pv[rng.integers(0, len(pv), P)] + rng.normal(0, 0.05, (P, 3))) @ R.T
         + Th).astype(np.float32)
    v = rng.normal(size=(P, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)

    # rows whose top-3 sets agree between the two exact KNNs
    ppts = (x - Th) @ R
    _, jnn = knn_unchunked(jnp.asarray(ppts), jctx["pverts"], K=3, exact=True)
    _, tnn = knn_top3(torch.as_tensor(ppts), tctx["pverts"])
    same = (np.sort(np.asarray(jnn), 1) == np.sort(tnn.numpy(), 1)).all(1)
    return dict(tctx=tctx, tparams=tparams, tmcfg=tmcfg, jctx=jctx,
                jparams=jparams, jmcfg=jmcfg, x=x, v=v, same=same)


def test_knn_sets_agree_except_near_ties(scene):
    share = 1 - scene["same"].mean()
    print(f"top-3 sets differ on {share:.4%} of {P} points")
    assert share <= MAX_SET_DIFF


def test_hdq_sdf_matches_jax(scene):
    s = scene
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(j_anisdf.hdq_sdf, static_argnums=1)(
            s["jparams"], s["jmcfg"], s["jctx"], jnp.asarray(s["x"])))
    got = anisdf.hdq_sdf(s["tparams"], s["tmcfg"], s["tctx"], torch.as_tensor(s["x"])).numpy()
    assert got.shape == ref.shape == (P, 1)
    same = s["same"]
    err = np.abs(got - ref)[same]
    print(f"max |dSDF| {err.max():.2e} on {same.sum()} points")
    assert err.max() <= 1e-4


def test_forward_raw_and_normals_match_jax(scene):
    s = scene
    fwd = jax.jit(lambda p, c, x, v: j_anisdf.forward(p, s["jmcfg"], c, x, v).raw)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(fwd(s["jparams"], s["jctx"], jnp.asarray(s["x"]), jnp.asarray(s["v"])))
    ret = anisdf.forward(s["tparams"], s["tmcfg"], s["tctx"], torch.as_tensor(s["x"]),
                         torch.as_tensor(s["v"]))
    got = ret.raw.numpy()
    # [cpts bpts resd | albedo rough | norm | occ]
    assert got.shape == ref.shape == (P, 17)
    mask = ret.mask.numpy()
    rows = s["same"] & mask
    assert rows.sum() > P // 2
    np.testing.assert_allclose(got[rows][:, :13], ref[rows][:, :13], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[rows][:, 16], ref[rows][:, 16], atol=1e-4, rtol=0)
    cos = (got[rows][:, 13:16] * ref[rows][:, 13:16]).sum(-1)
    print(f"min normal cosine {cos.min():.7f}")
    assert cos.min() >= 0.9999
    assert (got[~mask] == 0).all()


def test_world_to_bigpose_transform_matches_jax(scene):
    s = scene
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(j_anisdf.world_to_bigpose_transform(
            s["jmcfg"], s["jctx"], jnp.asarray(s["x"][:512])))
    got = anisdf.world_to_bigpose_transform(s["tmcfg"], s["tctx"],
                                            torch.as_tensor(s["x"][:512])).numpy()
    rows = s["same"][:512]
    np.testing.assert_allclose(got[rows], ref[rows], atol=1e-4, rtol=0)
