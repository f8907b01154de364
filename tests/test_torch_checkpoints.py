"""The port's training checkpoints (``train/checkpoints.py``) and the
``.pth`` import: round trips of the network and each optimiser's state,
epoch files and their garbage collection, the JAX package reading the
port's network and the port reading the JAX package's, the refusal of the
JAX package's optimiser block, the reference ``.pth`` import against the
JAX package's importer on synthetic checkpoints, and ``make_network``'s cold
start."""
import os

import jax
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads  # noqa: F401 (fixture)
from test_checkpoints import MCFG as J_MCFG, _fake_reference_state_dict
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.train import checkpoints as j_ckpt
from relightableavatar_tpu.train.optimizer import make_optimizer as j_make_optimizer
from relightableavatar_tpu_torch.config import default_cfg
from relightableavatar_tpu_torch.data import make_synthetic
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.models.factory import make_network
from relightableavatar_tpu_torch.train import checkpoints
from relightableavatar_tpu_torch.train.optimizer import TrainOptimizer

MCFG = AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6)


def reference_state_dict(flat: dict) -> dict:
    """The reference module's state dict of flat JAX-layout parameters (the
    inverse of the ``.pth`` import's mapping)."""
    sd = {}
    t = lambda a: torch.tensor(np.ascontiguousarray(a))
    for key, v in flat.items():
        parts = key.split('/')
        if parts[0] == 'beta':
            sd['signed_distance_network._beta'] = t(v)
            continue
        if parts[0] == 'env':
            sd['global_env_map_'] = t(v)
            continue
        if parts[0] == 'rgb':
            pre, leaf = f'render_network.{parts[1]}', parts[2]
        elif parts[0] == 'sdf':
            pre, leaf = f'signed_distance_network.mlp.lin{parts[2]}', parts[3]
        else:
            name = {'resd': 'residual_deformation_network'}.get(parts[0], f'{parts[0]}_network')
            pre, leaf = f'{name}.mlp.linears.{parts[2]}', parts[3]
        if leaf == 'w':
            sd[f'{pre}.weight'] = t(v.T)
        elif leaf == 'v':
            sd[f'{pre}.weight_v'] = t(v.T)
        elif leaf == 'g':
            sd[f'{pre}.weight_g'] = t(v.reshape(-1, 1))
        else:
            sd[f'{pre}.bias'] = t(v)
    return sd


def _params(seed=0):
    return anisdf.init_anisdf(torch.Generator().manual_seed(seed), MCFG)


def _optimizer(params, optim, lr_table=None):
    cfg = default_cfg()
    cfg.train.optim = optim
    if lr_table:
        cfg.train.lr_table = type(cfg.train.lr_table)(lr_table)
    named = checkpoints.named_params(params)
    for _, t in named:
        t.requires_grad_(True)
    return TrainOptimizer(cfg, named)


def _steps(opt, n, seed=1):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        for _, t in opt.named:
            t.grad = torch.randn(t.shape, generator=g)
        opt.step()


@pytest.mark.parametrize("optim", ["adam", "radam", "sgd"])
def test_model_round_trip_resumes_the_optimiser(tmp_path, optim):
    """Save after 3 steps, load into a fresh network and optimiser, step on:
    bit for bit the run that never stopped."""
    table = {'signed_distance_network': 1e-5}
    pa = _params()
    oa = _optimizer(pa, optim, table)
    _steps(oa, 3)
    d = str(tmp_path / 'ckpt')
    checkpoints.save_model(d, pa, oa, epoch=2, aux={'it': 1})
    pb = _params(seed=5)
    ob = _optimizer(pb, optim, table)
    found, epoch, aux = checkpoints.load_model(d, pb, ob)
    assert found and epoch == 2 and aux == {'it': 1} and ob.count == 3
    assert ob.lr('sdf') == oa.lr('sdf') and ob.lr() == oa.lr()
    _steps(oa, 2, seed=9)
    _steps(ob, 2, seed=9)
    for (k, a), (_, b) in zip(oa.named, ob.named):
        assert torch.equal(a, b), k
    assert sorted(os.listdir(d)) == ['2.npz', 'latest.npz']


def test_epoch_files_and_their_collection(tmp_path):
    p = _params()
    d = str(tmp_path / 'm')
    for e in range(1, 6):
        checkpoints.save_model(d, p, None, epoch=e, keep=3)
    checkpoints.save_model(d, p, None, epoch=9, latest=False)
    assert sorted(os.listdir(d)) == ['3.npz', '4.npz', '5.npz', '9.npz', 'latest.npz']
    assert checkpoints.checkpoint_path(d) == os.path.join(d, 'latest.npz')
    assert checkpoints.checkpoint_path(d, epoch=4) == os.path.join(d, '4.npz')
    assert checkpoints.load_model(str(tmp_path / 'none'), p) == (False, 0, {})


def test_the_jax_package_reads_the_ports_network(tmp_path):
    params = _params()
    opt = _optimizer(params, 'adam')
    _steps(opt, 1)
    d = str(tmp_path / 'port')
    checkpoints.save_model(d, params, opt, epoch=4)
    jm = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6)
    template = j_anisdf.init_anisdf(jax.random.PRNGKey(0), jm)
    state, epoch, _ = j_ckpt.load_model(d, dict(net=template))
    assert epoch == 4
    ref = {k: np.asarray(v) for k, v in j_ckpt._flatten(state['net']).items()}
    for k, t in checkpoints.named_params(params):
        np.testing.assert_array_equal(ref[k], t.detach().numpy(), err_msg=k)


def test_the_ports_load_reads_the_jax_network_and_refuses_its_optimiser(tmp_path):
    jm = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6)
    jp = j_anisdf.init_anisdf(jax.random.PRNGKey(3), jm)
    cfg = default_cfg()
    tx = j_make_optimizer(cfg, jp)
    d = str(tmp_path / 'jax')
    j_ckpt.save_model(d, dict(net=jp, opt=tx.init(jp)), epoch=7, aux={'it': 0})
    params = _params()
    found, epoch, aux = checkpoints.load_model(d, params)
    assert found and epoch == 7 and aux == {'it': 0}
    for k, v in j_ckpt._flatten(jp).items():
        np.testing.assert_array_equal(dict(checkpoints.named_params(params))[k].numpy(),
                                      np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="opt: block is not the port's"):
        checkpoints.load_model(d, params, _optimizer(params, 'adam'))


def test_load_refuses_a_misshapen_network(tmp_path):
    d = str(tmp_path / 'm')
    checkpoints.save_model(d, _params(), None, epoch=1)
    other = anisdf.init_anisdf(torch.Generator().manual_seed(0), MCFG._replace(sdf_res=8))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoints.load_model(d, other)


def test_pth_import_matches_the_jax_importer(tmp_path):
    """The reference ``.pth`` of tests/test_checkpoints.py (weight-normed
    and plain linears, beta, the environment map) through both importers:
    every parameter equal."""
    torch.manual_seed(0)
    sd = _fake_reference_state_dict(J_MCFG)
    path = str(tmp_path / 'latest.pth')
    torch.save(dict(net=sd), path)
    ref = j_ckpt.load_torch_pth(j_anisdf.init_anisdf(jax.random.PRNGKey(1), J_MCFG), path)
    mcfg = AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=6, relight=True,
                        env_h=J_MCFG.env_h, env_w=J_MCFG.env_w)
    ours = checkpoints.load_torch_pth(path, mcfg, device="cpu")
    flat = dict(checkpoints.named_params(ours))
    ref = {k: np.asarray(v) for k, v in j_ckpt._flatten(ref).items()}
    assert set(flat) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)


def test_make_network_reads_a_pth_and_cold_starts(tmp_path):
    """``make_network`` imports a reference ``latest.pth`` of the fixture
    avatar; with ``cold_start`` and an empty folder it starts from
    ``init_anisdf``, without it it refuses."""
    cfg = default_cfg()
    cfg.n_bones, cfg.cond_dim, cfg.sdf_res = 52, 156, 8
    cfg.relighting = True
    cfg.trained_model_dir = str(tmp_path / 'pth')
    os.makedirs(cfg.trained_model_dir)
    with np.load(make_synthetic.FIXTURE_PARAMS) as f:
        flat = {k: f[k] for k in f.files}
    torch.save(dict(net=reference_state_dict(flat)),
               os.path.join(cfg.trained_model_dir, 'latest.pth'))
    params, mcfg = make_network(cfg, device="cpu")
    for k, t in checkpoints.named_params(params):
        np.testing.assert_array_equal(t.numpy(), flat[k].astype(np.float32), err_msg=k)

    cfg.relighting = False
    cfg.trained_model_dir = str(tmp_path / 'empty')
    with pytest.raises(FileNotFoundError):
        make_network(cfg, device="cpu")
    params, mcfg = make_network(cfg, device="cpu", cold_start=True)
    init = dict(checkpoints.named_params(anisdf.init_anisdf(torch.Generator().manual_seed(0),
                                                            mcfg)))
    got = dict(checkpoints.named_params(params))
    assert set(got) == set(init)
    for k, t in got.items():
        assert torch.equal(t, init[k]), k
