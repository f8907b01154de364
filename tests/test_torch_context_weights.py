"""The port's frame context, parameter loader and config against the JAX
package's, for fixture frame 0: integer tensors exactly, floats to 1e-6."""
import os

import jax
import numpy as np
import pytest
import torch

from relightableavatar_tpu.config import default_cfg as j_default_cfg
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.models.context import (make_bigpose as j_make_bigpose,
                                                  make_frame_context as j_make_frame_context)
from relightableavatar_tpu.ops.mlp import fold_weight_norm as j_fold
from relightableavatar_tpu.smpl.body_model import BodyModel as JBodyModel
from relightableavatar_tpu.train.checkpoints import load_params as j_load_params
from relightableavatar_tpu_torch.config import default_cfg, make_cfg
from relightableavatar_tpu_torch.eval.golden import REPO, fixture_cfg, load_fixture
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.mlp import fold_weight_norm
from relightableavatar_tpu_torch.weights import load_params, param_shapes, params_from_flat

PARAMS = os.path.join(REPO, 'fixtures/synthetic_avatar_params.npz')


@pytest.fixture(scope="module")
def contexts():
    model = JBodyModel(os.path.join(REPO, 'fixtures/synthetic_body.npz'))
    motion = dict(np.load(os.path.join(REPO, 'fixtures/synthetic_motion.npz')))
    sh = motion['shapes'][0]
    tv, tj, bA, _ = j_make_bigpose(model, sh)
    jctx = j_make_frame_context(model, tv, tj, bA, motion['poses'][0],
                                motion['Rh'][0], motion['Th'][0], sh)
    tctx, _, _ = load_fixture(device="cpu")
    return jctx, tctx


@pytest.fixture(scope="module")
def flat():
    with np.load(PARAMS) as f:
        return {k: f[k] for k in f.files}


CTX_KEYS = ["knn_table", "R", "Th", "poses", "A", "big_A", "weights", "pverts",
            "pnorm", "tverts", "tnorm", "faces", "wbounds", "tbounds", "pbounds",
            "knn_gvid", "knn_gverts", "knn_gcent", "knn_gradius", "knn_sub_ids"]


@pytest.mark.parametrize("key", CTX_KEYS)
def test_context_tensor_matches_jax(contexts, key):
    jctx, tctx = contexts
    ref = np.asarray(jctx[key])
    got = tctx[key].numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if np.issubdtype(ref.dtype, np.integer):
        assert (got == ref).all()
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_context_knn_table_layout(contexts):
    _, tctx = contexts
    assert tuple(tctx["knn_table"].shape) == (6890, 9 + 52)
    tbl = tctx["knn_table"]
    assert torch.equal(tbl[:, 0:3], tctx["pverts"])
    assert torch.equal(tbl[:, 6:9], tctx["tverts"])
    assert torch.equal(tbl[:, 9:], tctx["weights"])


def test_params_load_all_fixture_keys(flat):
    mcfg = AniSDFConfig(relight=True)
    assert len(flat) == 74 and set(param_shapes(mcfg)) == set(flat)
    params = params_from_flat(flat, device="cpu")
    assert len(params["sdf"]["layers"]) == 9 and len(params["resd"]["layers"]) == 9
    assert set(params["rgb"]) == {f"l{i}" for i in range(5)}
    assert params["env"].shape == (32, 64, 3) and params["beta"].shape == ()
    for key, arr in flat.items():
        node = params
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        assert node.dtype == torch.float32 and np.array_equal(node.numpy(), arr)


def test_weight_norm_folds_like_jax(flat):
    mcfg_j = j_anisdf.AniSDFConfig(relight=True, sdf_res=8)
    jparams = j_load_params(j_anisdf.init_anisdf(jax.random.PRNGKey(0), mcfg_j), PARAMS)
    tparams = load_params(PARAMS, device="cpu")
    pairs = [(jparams["sdf"]["layers"][i], tparams["sdf"]["layers"][i]) for i in range(9)]
    pairs += [(jparams["rgb"][f"l{i}"], tparams["rgb"][f"l{i}"]) for i in range(5)]
    for jl, tl in pairs:
        np.testing.assert_allclose(fold_weight_norm(tl).numpy(),
                                   np.asarray(j_fold(jl)["w"]), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fault", ["missing", "unknown", "shape"])
def test_params_reject_bad_checkpoints(flat, fault):
    bad = dict(flat)
    if fault == "missing":
        del bad["sdf/layers/3/g"]
        err = KeyError
    elif fault == "unknown":
        bad["sdf/layers/9/g"] = np.zeros(3, np.float32)
        err = KeyError
    else:
        bad["rgb/l2/v"] = np.zeros((256, 255), np.float32)
        err = ValueError
    with pytest.raises(err):
        params_from_flat(bad, device="cpu")


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return list(node) if isinstance(node, tuple) else node


def test_default_config_matches_jax():
    assert _plain(default_cfg()) == _plain(j_default_cfg())


def test_make_cfg_merges_cli_pairs_and_overlays():
    cfg = make_cfg(opts=["relighting", "True", "sphere_tracing.iter", "8",
                         "relighting_cfg", "{'n_samples': 3}"])
    assert cfg.relighting is True and cfg.sphere_tracing.iter == 8
    assert cfg.n_samples == 3 and cfg.cond_dim == cfg.n_bones * 3
    assert fixture_cfg().tpu.bf16_mlp is False
