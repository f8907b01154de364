"""The port's train split and training loader (``data/datasets.py``) against
the JAX package's on the generated tree of ``tests/test_torch_datasets.py``
(4 frames, 3 views, 48 x 48 PNGs, one image missing): the draw-invariant ray
pools and ``__getitem__``'s train items equal bit for bit for every index at
several draw numbers (with edge and face sampling, at ratio 0.5, with normal
and semantic maps, under image-size batching), the ``TrainSampler`` order,
the threaded training loader's items; then the training entry on the CPU:
train, save, resume, and ``run -t network`` from the trained checkpoint."""
import json
import os

import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads  # noqa: F401 (fixture)
from test_torch_datasets import FRAMES, REPO, TUBEMAN, VIEWS, tree  # noqa: F401 (fixture)
import relightableavatar_tpu.config as jconfig
from relightableavatar_tpu.data import datasets as jdata
from relightableavatar_tpu_torch import config as pconfig
from relightableavatar_tpu_torch.data import datasets as pdata
from relightableavatar_tpu_torch.run import run_network
from relightableavatar_tpu_torch.train.cli import train as port_train

DRAWS = (0, 1, 7)


def _cfgs(root, opts, extra=()):
    argv = [*extra, '-c', TUBEMAN, 'train_dataset.data_root', root, 'test_dataset.data_root',
            root, 'n_rays', '64', *opts]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        pcfg, _ = pconfig.setup(argv)
        jcfg = jconfig.default_cfg()
        jconfig.update_cfg(jcfg, jconfig.make_parser().parse_args(argv))
    finally:
        os.chdir(cwd)
    return pcfg, jcfg


def _assert_equal(ours, ref, where="item", pixels_atol=0.0):
    """Every field but the frame context equal bit for bit (the context is
    held to the JAX package's in tests/test_torch_datasets.py); with
    ``pixels_atol`` the image and its sampled colours within it (a resized
    image: the port's INTER_AREA against OpenCV's, 1e-6 there)."""
    if isinstance(ours, dict):
        keys = set(ours) - {'ctx', 'novel_lights', 'train_motion'}
        assert keys == set(ref) - {'ctx', 'novel_lights', 'train_motion'}, where
        for k in keys:
            _assert_equal(ours[k], ref[k], f"{where}.{k}", pixels_atol)
        return
    if isinstance(ours, torch.Tensor):
        ours = ours.numpy()
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, where
    if pixels_atol and where.rsplit('.', 1)[-1] in ('img', 'rgb'):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=pixels_atol, err_msg=where)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=where)


@pytest.mark.parametrize("opts", [
    [], ['edge_sample_ratio', '0.25', 'face_sample_ratio', '0.1'], ['ratio', '0.5'],
    ['load_normal', 'True', 'load_semantics', 'True'], ['mask_bkgd', 'False'],
], ids=["default", "edge_face", "ratio0.5", "normal_semantics", "no_mask_bkgd"])
def test_train_items_equal_jax(tree, opts):
    atol = 1e-6 if 'ratio' in opts else 0.0
    pcfg, jcfg = _cfgs(tree, opts)
    ours = pdata.make_dataset(pcfg, is_train=True, device="cpu")
    ref = jdata.make_dataset(jcfg, is_train=True)
    assert len(ours) == len(ref) == FRAMES * VIEWS
    for i in range(len(ref)):
        g_ours = ours._train_ray_geometry(i, ours.get_gt(i))
        g_ref = ref._train_ray_geometry(i, ref.get_gt(i))
        _assert_equal(dict(g_ours), dict(g_ref), f"geometry {i}")
        for draw in DRAWS:
            _assert_equal(ours.__getitem__(i, draw), ref.__getitem__(i, draw), f"item {i}/{draw}",
                          atol)


def test_train_items_equal_jax_under_image_size_batching(tree):
    pcfg, jcfg = _cfgs(tree, [])
    ours = pdata.make_dataset(pcfg, is_train=True, device="cpu")
    ref = jdata.make_dataset(jcfg, is_train=True)
    for hw in ((64, 32), (32, 96)):
        ours.forced_hw = ref.forced_hw = hw
        for i in (0, 5, len(ref) - 1):
            item = ours.__getitem__(i, 3)
            _assert_equal(item, ref.__getitem__(i, 3), f"item {i} at {hw}")
            assert (item.H, item.W) == hw


def test_train_sampler_order_equals_jax():
    for shuffle in (True, False):
        ours = pdata.TrainSampler(10, shuffle=shuffle, seed=3)
        ref = jdata.TrainSampler(10, shuffle=shuffle, seed=3, rank=0, world=1)
        for epoch in (0, 2):
            ours.epoch = ref.epoch = epoch
            a, b = iter(ours), iter(ref)
            assert [next(a) for _ in range(35)] == [next(b) for _ in range(35)]
    # rank 1 of world 4 (a node of a multi-node launch) as the JAX process's
    a, b = iter(pdata.TrainSampler(10, rank=1, world=4)), iter(jdata.TrainSampler(10, rank=1,
                                                                                  world=4))
    assert [next(a) for _ in range(12)] == [next(b) for _ in range(12)]


def test_training_loader_items_equal_jax(tree):
    """The training loaders with 2 prefetch threads, on the same epoch:
    the first 9 items of each bit for bit; the port's serial loader (no
    threads) and a loader that skips 4 items give the same stream."""
    pcfg, jcfg = _cfgs(tree, ['train.num_workers', '2'])
    ours = pdata.make_data_loader(pcfg, is_train=True, device="cpu")
    ref = jdata.make_data_loader(jcfg, is_train=True)
    ours.set_epoch(1)
    ref.set_epoch(1)

    def first(loader, n):
        out = []
        for item in loader:
            out.append(item)
            if len(out) == n:
                return out
    got, want = first(ours, 9), first(ref, 9)
    for k, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a, b, f"item {k}")
    serial = pdata.DataLoader(ours.dataset, infinite=True, shuffle=True, batch_size=2)
    serial.set_epoch(1)
    for k, (a, b) in enumerate(zip(first(serial, 9), got)):
        _assert_equal(a, b, f"serial item {k}")
    ours.skip_next = 4
    for k, (a, b) in enumerate(zip(first(ours, 5), got[4:])):
        _assert_equal(a, b, f"skipped item {k}")


def test_train_entry_trains_saves_resumes_and_renders(tree, tmp_path):
    """``train`` on the CPU (tubeman's config, 2 epochs of 2 steps of 2
    frames x 32 rays x 4 samples, bf16 off), then ``resume True`` for a
    third epoch, then ``run -t network`` from the trained checkpoint."""
    common = ['exp_name', 'tubeman_verify', 'trained_model_dir', str(tmp_path / 'trained'),
              'record_dir', str(tmp_path / 'record'), 'result_dir', str(tmp_path / 'result'),
              'n_samples', '4', 'train.batch_size', '2', 'ep_iter', '2', 'train.num_workers', '2',
              'eval_ep', '100', 'save_ep', '100', 'tpu.bf16_mlp', 'False', 'record_tb', 'False']
    cfg, _ = _cfgs(tree, ['n_rays', '32', 'resume', 'False', 'train.epoch', '2', *common])
    assert cfg.trained_model_dir.endswith(os.path.join('deform', 'tubeman_verify'))
    trainer = port_train(cfg, device="cpu")
    assert sorted(os.listdir(cfg.trained_model_dir)) == ['1.npz', '2.npz', 'latest.npz']
    rows = [json.loads(line) for line in open(os.path.join(cfg.record_dir, 'scalars.jsonl'))]
    assert len(rows) == 4 and all(np.isfinite(r['loss']) for r in rows)
    assert trainer.recorder.step == 4 and trainer.optimizer.count == 4

    cfg, _ = _cfgs(tree, ['n_rays', '32', 'resume', 'True', 'train.epoch', '3', *common])
    trainer = port_train(cfg, device="cpu")
    assert trainer.recorder.step == 6 and trainer.optimizer.count == 6
    with np.load(os.path.join(cfg.trained_model_dir, 'latest.npz')) as f:
        assert int(f['epoch']) == 3 and json.loads(str(f['aux']))['recorder']['step'] == 6

    cfg, _ = _cfgs(tree, ['n_rays', '32', 'resume', 'True', 'dry_run', 'True', *common])
    assert port_train(cfg, device="cpu").recorder.step == 6

    run_cfg, _ = _cfgs(tree, [*common, 'test_view', '[0]', 'test.frame_sampler_interval', '4',
                              'n_samples', '8'], extra=['-t', 'network'])
    assert run_cfg.trained_model_dir == cfg.trained_model_dir
    run_network(run_cfg, device="cpu")


def test_relight_train_entry_bootstraps_trains_resumes_and_renders(tree, tmp_path):
    """Stage 2 through ``train`` on the CPU: a one-step stage-1 run, then
    ``relighting True`` with ``geometry_pretrain`` at its checkpoint (the
    network starts from its geometry, the relight heads and envmap from
    ``init_anisdf``; a 4 x 8 light grid, 4 surface and 1 shadow
    iterations, 2 frames x 32 rays x 3 samples), 2 epochs of 2 steps under
    ``relight/tubeman_verify`` with the validation render after the second
    (the sphere-traced renderer, its pred | gt image written), ``resume
    True`` for a third epoch, and ``run -t network relighting True`` from
    the stage-2 checkpoint."""
    from relightableavatar_tpu_torch.models.factory import make_network
    from relightableavatar_tpu_torch.weights import read_checkpoint
    fast = ['n_rays', '32', 'train.batch_size', '2', 'train.num_workers', '2', 'eval_ep', '100',
            'save_ep', '100', 'tpu.bf16_mlp', 'False', 'record_tb', 'False',
            'record_dir', str(tmp_path / 'record'), 'result_dir', str(tmp_path / 'result')]
    geo, _ = _cfgs(tree, ['exp_name', 'tubeman_verify', 'trained_model_dir', str(tmp_path / 'm'),
                          'n_samples', '4', 'ep_iter', '1', 'train.epoch', '1', 'resume', 'False',
                          *fast])
    port_train(geo, device="cpu")
    common = ['relighting', 'True', 'geometry_pretrain', geo.trained_model_dir,
              'exp_name', 'tubeman_verify', 'trained_model_dir', str(tmp_path / 'm'),
              'env_h', '4', 'env_w', '8', 'sphere_tracing.iter', '4', 'obj_lvis.iter', '1',
              'network_chunk_size', '4096', 'ep_iter', '2', *fast]
    cfg, _ = _cfgs(tree, [*common, 'resume', 'False', 'train.epoch', '2', 'eval_ep', '2',
                          'test_view', '[0]', 'test.frame_sampler_interval', '4'])
    assert 'sphere_tracing' in cfg.renderer_module
    assert cfg.trained_model_dir.endswith(os.path.join('relight', 'tubeman_verify'))
    start, _ = make_network(cfg, device="cpu", cold_start=True)
    stage1, _, _ = read_checkpoint(geo.trained_model_dir)
    assert torch.equal(start['sdf']['layers'][0]['v'], torch.tensor(stage1['sdf/layers/0/v']))
    assert {'albedo', 'roughness', 'env'} <= set(start) and start['env'].shape[:2] == (8, 16)
    trainer = port_train(cfg, device="cpu")
    assert sorted(os.listdir(cfg.trained_model_dir)) == ['1.npz', '2.npz', 'latest.npz']
    rows = [json.loads(line) for line in open(os.path.join(cfg.record_dir, 'scalars.jsonl'))]
    assert len(rows) == 4 and all(np.isfinite(r['loss']) for r in rows)
    assert {'albedo_smooth', 'roughness_smooth', 'volume_entropy'} <= set(rows[-1])
    assert trainer.recorder.step == 4 and trainer.shadow_rays > 0
    assert os.path.exists(os.path.join(cfg.record_dir, 'images', 'ep0001_val_pred_gt.png'))

    cfg, _ = _cfgs(tree, [*common, 'resume', 'True', 'train.epoch', '3'])
    trainer = port_train(cfg, device="cpu")
    assert trainer.recorder.step == 6 and trainer.optimizer.count == 6
    with np.load(os.path.join(cfg.trained_model_dir, 'latest.npz')) as f:
        assert int(f['epoch']) == 3

    run_cfg, _ = _cfgs(tree, [*common, 'test_view', '[0]', 'test.frame_sampler_interval', '4'],
                       extra=['-t', 'network'])
    assert run_cfg.trained_model_dir == cfg.trained_model_dir
    run_network(run_cfg, device="cpu")
