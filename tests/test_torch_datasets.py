"""The port's host data layer (``data/datasets.py``, ``data/rays.py``,
``models/context.py:make_frame_context_mesh``) against the JAX package's on
the same files: a ``smpl.synthetic.write_synthetic_dataset`` tree with
seeded PNG images and masks (one image left out: the zero-image fallback).
``__getitem__`` of the test split of BaseDataset (ratio 1.0 and 0.5, with
and without ``mask_bkgd``, and with a mesh geometry prior), PoseDataset and
DemoDataset: integer and boolean fields equal, float fields within 1e-6,
the frame context's common keys too.  Also the FrameSampler's order, the
train-time ray sampler, and the JAX dataset reading a tree that the port's
generator wrote.  GT normal maps and SCHP label maps (``load_normal``,
``load_semantics``) on two frames."""
import os

import cv2
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads  # noqa: F401 (fixture)
import relightableavatar_tpu.config as jconfig
from relightableavatar_tpu.data import datasets as jdata
from relightableavatar_tpu.data import rays as jrays
from relightableavatar_tpu.models.context import make_bigpose as j_make_bigpose
from relightableavatar_tpu.models.context import make_frame_context_mesh as j_mesh_ctx
from relightableavatar_tpu.smpl import synthetic as jsynthetic
from relightableavatar_tpu.smpl.body_model import BodyModel as JBodyModel
from relightableavatar_tpu.utils.semantics import schp_palette
from relightableavatar_tpu_torch import config as pconfig
from relightableavatar_tpu_torch.data import datasets as pdata
from relightableavatar_tpu_torch.data import rays as prays
from relightableavatar_tpu_torch.data.make_synthetic import generator_cfg, make_dataset_tree
from relightableavatar_tpu_torch.models.context import make_frame_context_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUBEMAN = os.path.join(REPO, 'configs/synthetic/tubeman.yaml')
ATOL = 1e-6
FRAMES, VIEWS, SIZE = 4, 3, 48
MISSING = (3, 2)            # (frame, view) without an image on disk


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "tubeman")
    jsynthetic.write_synthetic_dataset(root, n_frames=FRAMES, n_views=VIEWS, n_bones=52,
                                       H=SIZE, W=SIZE)
    annots = np.load(os.path.join(root, 'annots.npy'), allow_pickle=True).item()
    annots['ims'] = [dict(ims=[p.replace('.jpg', '.png') for p in f['ims']])
                     for f in annots['ims']]
    np.save(os.path.join(root, 'annots.npy'), annots, allow_pickle=True)
    rng = np.random.default_rng(0)
    for f in range(FRAMES):
        for v in range(VIEWS):
            if (f, v) == MISSING:
                continue
            for sub in ('images', 'mask'):
                os.makedirs(os.path.join(root, sub, f'{v:02d}'), exist_ok=True)
            img = (rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8)
            msk = np.where(rng.random((SIZE, SIZE)) > 0.4, 255, 0).astype(np.uint8)
            cv2.imwrite(os.path.join(root, 'images', f'{v:02d}', f'{f:06d}.png'), img)
            cv2.imwrite(os.path.join(root, 'mask', f'{v:02d}', f'{f:06d}.png'), msk)
            if f < 2:       # GT normals and SCHP labels for two frames
                nrm = (rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8)
                lab = schp_palette()[rng.integers(0, 20, (SIZE, SIZE))][..., ::-1]
                for sub, arr in (('normal', nrm), ('schp', lab)):
                    os.makedirs(os.path.join(root, sub, f'{v:02d}'), exist_ok=True)
                    cv2.imwrite(os.path.join(root, sub, f'{v:02d}', f'{f:06d}.png'), arr)
    return root


def _argv(root, opts):
    return ['-c', TUBEMAN, '-t', 'evaluate', 'train_dataset.data_root', root,
            'test_dataset.data_root', root, 'num_eval_frame', str(FRAMES),
            'test.frame_sampler_interval', '1', *opts]


def _datasets(root, opts):
    argv = _argv(root, opts)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        pcfg, _ = pconfig.setup(argv)
        jcfg = jconfig.default_cfg()
        jconfig.update_cfg(jcfg, jconfig.make_parser().parse_args(argv))
        return (pdata.make_dataset(pcfg, is_train=False, device="cpu"),
                jdata.make_dataset(jcfg, is_train=False), pcfg, jcfg)
    finally:
        os.chdir(cwd)


def _assert_same(ours, ref, where="batch"):
    if isinstance(ours, dict):
        assert isinstance(ref, dict), where
        keys = set(ours) & set(ref) if where.endswith("ctx") else set(ours)
        if not where.endswith("ctx"):
            assert set(ours) == set(ref), f"{where}: {set(ours) ^ set(ref)}"
        for k in keys:
            _assert_same(ours[k], ref[k], f"{where}.{k}")
        return
    if isinstance(ours, tuple):
        assert isinstance(ref, tuple) and len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same(a, b, f"{where}[{i}]")
        return
    if isinstance(ours, torch.Tensor):
        ours = ours.numpy()
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, f"{where}: {ours.shape} vs {ref.shape}"
    if ours.dtype.kind in "fc" or ref.dtype.kind in "fc":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL, err_msg=where)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=where)


@pytest.mark.parametrize("opts", [
    [], ['ratio', '0.5'], ['mask_bkgd', 'False'], ['ratio', '0.5', 'mask_bkgd', 'False'],
    ['relighting', 'True', 'test_view', '[2, 0]'],
    ['load_normal', 'True', 'load_semantics', 'True'],
    ['load_normal', 'True', 'load_semantics', 'True', 'ratio', '0.5'],
], ids=["ratio1", "ratio0.5", "no_mask_bkgd", "ratio0.5_no_mask_bkgd", "relight_views",
        "normal_semantics", "normal_semantics_ratio0.5"])
def test_base_dataset_matches_jax(tree, opts):
    ours, ref, _, _ = _datasets(tree, opts)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        _assert_same(ours[i], ref[i])


@pytest.mark.parametrize("module,opts", [
    ('lib.datasets.pose_dataset', ['test_view', '[0, 2]']),
    ('lib.datasets.pose_dataset', ['ratio', '0.5']),
    ('lib.datasets.demo_dataset', ['num_render_view', '5']),
    ('lib.datasets.demo_dataset', ['num_render_view', '4', 'perform', 'True', 'H', '24',
                                   'W', '24']),
], ids=["pose", "pose_ratio0.5", "demo", "demo_perform_HW"])
def test_pose_and_demo_datasets_match_jax(tree, module, opts):
    ours, ref, _, _ = _datasets(tree, ['test_dataset_module', module, *opts])
    assert type(ours).__name__ == type(ref).__name__
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        _assert_same(ours[i], ref[i])


@pytest.mark.parametrize("intervals", [(1, 1), (2, 1), (1, 2), (3, 2)])
def test_frame_sampler_order_matches_jax(tree, intervals):
    ours, ref, _, _ = _datasets(tree, ['test_view', '[]'])
    np.testing.assert_array_equal(list(pdata.FrameSampler(ours, *intervals)),
                                  list(jdata.FrameSampler(ref, *intervals)))


def _prior(root, path):
    model = JBodyModel(os.path.join(root, 'body_model.npz'))
    motion = dict(np.load(os.path.join(root, 'motion.npz')))
    tverts, tjoints, _, _ = j_make_bigpose(model, motion['shapes'][0])
    np.savez(path, verts=tverts, faces=model.faces, weights=model.weights,
             tjoints=tjoints, parents=model.parents)
    return dict(np.load(path)), motion


def test_frame_context_mesh_matches_jax(tree, tmp_path):
    prior, motion = _prior(tree, str(tmp_path / 'can_mesh.npz'))
    for f in (0, 2):
        ours = make_frame_context_mesh(prior, motion['poses'][f], motion['Rh'][f],
                                       motion['Th'][f], device="cpu")
        ref = j_mesh_ctx(prior, motion['poses'][f], motion['Rh'][f], motion['Th'][f])
        _assert_same(ours, ref, "ctx")


def test_geometry_prior_dataset_matches_jax(tree, tmp_path):
    path = str(tmp_path / 'can_mesh.npz')
    _prior(tree, path)
    ours, ref, _, _ = _datasets(tree, ['use_geometry', 'True', 'geometry_mesh', path])
    assert ours.geometry is not None and ref.geometry is not None
    for i in (0, len(ref) - 1):
        _assert_same(ours[i], ref[i])


def test_loader_matches_jax_and_train_split_raises(tree):
    _, _, pcfg, jcfg = _datasets(tree, ['test.frame_sampler_interval', '2'])
    ours = pdata.make_data_loader(pcfg, is_train=False, device="cpu")
    ref = jdata.make_data_loader(jcfg, is_train=False)
    # tubeman's test_view [3] names no camera of 3: every view is taken
    assert len(ours) == len(ref) == FRAMES // 2 * VIEWS
    assert ([(b.frame_index, b.view_index) for b in ours]
            == [(b.frame_index, b.view_index) for b in ref])
    # the train split and its loader are ported (tests/test_torch_train_data.py),
    # and so is the sampler's sharding over nodes (tests/test_torch_parallel.py):
    # rank 1 of 2 takes the JAX sampler's items of process 1 of 2
    train = pdata.make_data_loader(pcfg, is_train=True, device="cpu")
    assert train.infinite and isinstance(train.sampler, pdata.TrainSampler)
    n = len(train.dataset)
    a = iter(pdata.TrainSampler(n, rank=1, world=2))
    b = iter(jdata.TrainSampler(n, rank=1, world=2))
    assert [next(a) for _ in range(n)] == [next(b) for _ in range(n)]


@pytest.mark.parametrize("split,edge", [("train", 0.0), ("train", 0.25), ("test", 0.0)])
def test_sample_ray_matches_jax(split, edge):
    rng = np.random.default_rng(7)
    img = rng.random((40, 36, 3)).astype(np.float32)
    msk = (rng.random((40, 36)) > 0.5).astype(np.uint8)
    K = np.array([[40., 0, 18], [0, 40., 20], [0, 0, 1]], np.float32)
    R = np.eye(3, dtype=np.float32)
    T = np.array([[0.], [0.], [3.]], np.float32)
    bounds = np.array([[-0.5, -0.6, -0.4], [0.5, 0.6, 0.4]], np.float32)
    args = (img, msk, K, R, T, bounds, 256, split, False, 0.5, 0.1)
    ours = prays.sample_ray(*args, rng=np.random.default_rng(3), edge_ratio=edge)
    ref = jrays.sample_ray(*args, rng=np.random.default_rng(3), edge_ratio=edge)
    _assert_same(ours, ref)
    _assert_same(prays.get_rays_within_bounds(40, 36, K, R, T, bounds),
                 jrays.get_rays_within_bounds(40, 36, K, R, T, bounds))


def test_jax_dataset_reads_the_ports_generated_tree(tmp_path):
    """A 16x16, 1-frame, 1-view tree from the port's generator (2 surface,
    1 shadow iteration): the JAX dataset reads its PNGs as the port's does."""
    root = str(tmp_path / "gen")
    cfg = generator_cfg(52)
    cfg.sphere_tracing.iter = 2
    cfg.obj_lvis.iter = 1
    cfg.tpu.ray_block = 64
    with torch.no_grad():
        make_dataset_tree(root, frames=1, views=1, size=16, device="cpu", cfg=cfg)
    ours, ref, _, _ = _datasets(root, ['num_eval_frame', '1'])
    assert len(ref) == len(ours) == 1
    rb, ob = ref[0], ours[0]
    png = cv2.imread(os.path.join(root, 'images', '00', '000000.png'))[..., ::-1]
    msk = cv2.imread(os.path.join(root, 'mask', '00', '000000.png'), cv2.IMREAD_GRAYSCALE)
    assert int(msk.max()) == 255 and int((msk > 128).sum()) > 0
    np.testing.assert_array_equal(rb.img, png.astype(np.float32) / 255 * (msk > 128)[..., None])
    _assert_same(ob, rb)
