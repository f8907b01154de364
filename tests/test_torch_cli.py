"""The slice as a whole on the CPU: the port's dataset generator against the
JAX script's render loop, and the port's ``run -t evaluate|visualize``
against the JAX package's ``run.py`` on the same generated tree and
checkpoint; the factory's refusal to render without a checkpoint.

Tree: the fixture avatar through the port's generator at 32x32, 2 frames,
1 view (tubeman's test_view [3] falls back to it), 6 surface and 2 shadow
iterations, the learned 16x32 env map, float32 MLPs and the exact KNN on
both sides, JAX matmuls at 'highest' precision.  The JAX renderer runs
without its device mesh (ROADMAP, "Tests").
"""
import glob
import os

import jax
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads  # noqa: F401 (fixture)
import relightableavatar_tpu.config as jconfig
import run as jrun
from relightableavatar_tpu.config import default_cfg as j_default_cfg
from relightableavatar_tpu.data.rays import get_full_near_far as j_near_far
from relightableavatar_tpu.data.rays import get_rays as j_get_rays
from relightableavatar_tpu.models import anisdf as janisdf
from relightableavatar_tpu.models.context import make_bigpose as j_make_bigpose
from relightableavatar_tpu.models.context import make_frame_context as j_frame_context
from relightableavatar_tpu.renderer.orchestrate import SphereTracingRenderer as JRenderer
from relightableavatar_tpu.smpl.body_model import BodyModel as JBodyModel
from relightableavatar_tpu.train.checkpoints import load_params as j_load_params
from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
from relightableavatar_tpu_torch import config as pconfig
from relightableavatar_tpu_torch import run as prun
from relightableavatar_tpu_torch.data import make_synthetic
from relightableavatar_tpu_torch.data.image_io import read_png
from relightableavatar_tpu_torch.eval.golden import psnr
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.models.factory import make_network
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
from relightableavatar_tpu_torch.smpl.body_model import BodyModel
from relightableavatar_tpu_torch.smpl.synthetic import make_cameras
from relightableavatar_tpu_torch.weights import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUBEMAN = 'configs/synthetic/tubeman.yaml'
SIZE, FRAMES = 32, 2
SMALL = ['sphere_tracing.iter', '6', 'obj_lvis.iter', '2', 'tpu.ray_block', '256']
# the generator's settings; mask_bkgd off, so that the dataset's GT keeps the
# silhouette pixels whose acc is at most 0.5 (with it, 41-54 dB measured
# here: those pixels are zeroed in the GT and not in the render)
EXACT = ['tpu.bf16_mlp', 'False', 'tpu.knn_impl', 'pallas', 'mask_bkgd', 'False']
# the generator's images, port against JAX: measured 118.60-119.83 dB on
# the rgb images and acc maps, so 100 dB
GEN_MIN_PSNR = 100.0
# run -t evaluate, port against JAX on the same tree: PSNR, SSIM and
# lpips_rand measured 9.8e-4 dB, 1.2e-8 and 5.2e-10 apart
PSNR_ATOL = 0.01
SSIM_ATOL = 1e-4
LPIPS_ATOL = 1e-4
GT_MIN_PSNR = 60.0          # against the generator's own 8-bit images: measured 67.4-67.6 dB
PNG_LEVELS = 1              # every written 8-bit PNG within one level of JAX's (measured 0) ...
# ... but the specular maps: spec_map divides by |ldot| + 1e-8 in both
# packages (ROADMAP, "spec_map parity"), and the visualizer scales the map by
# its 99.5th percentile; measured 59.43 and 49.84 dB (5 and 31 levels at a
# few pixels), held to test_torch_frame.py's spec_map bar
SPEC_MIN_PSNR = 45.0
# the Output types the sphere-traced relight renderer has maps for
TYPES = ('surface', 'residual', 'depth', 'alpha', 'normal', 'specular', 'albedo',
         'roughness', 'shading', 'rendering', 'envmap')


def _small(cfg):
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.tpu.ray_block = 256
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(tmp dir, data root, checkpoint dir) of a generated 2-frame tree and
    the fixture's parameters written as a ``save_model`` checkpoint."""
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "tubeman")
    with torch.no_grad():
        make_synthetic.make_dataset_tree(root, frames=FRAMES, views=1, size=SIZE, device="cpu",
                                         cfg=_small(make_synthetic.generator_cfg(52)))
    ckpt = tmp / "trained_model" / "relight" / "tubeman_relight"
    os.makedirs(ckpt)
    with np.load(make_synthetic.FIXTURE_PARAMS) as f:
        np.savez(ckpt / "latest.npz", epoch=np.asarray(7), **{"net:" + k: f[k] for k in f.files})
    return tmp, root


def _argv(task, tmp, root, result, opts=()):
    return ['-t', task, '-c', TUBEMAN, 'relighting', 'True', 'test_dataset.data_root', root,
            'train_dataset.data_root', root, 'trained_model_dir', str(tmp / 'trained_model'),
            'result_dir', str(tmp / result), 'vis_ext', '.png', 'store_video_output', 'False',
            'num_eval_frame', str(FRAMES), 'test.frame_sampler_interval', '1',
            *EXACT, *SMALL, *opts]


@pytest.fixture()
def in_repo(monkeypatch):
    """The configs name their parents relative to the repo's root."""
    monkeypatch.chdir(REPO)


@pytest.fixture()
def jax_renderer_without_mesh(monkeypatch):
    init = JRenderer.__init__

    def no_mesh(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.mesh = None
    monkeypatch.setattr(JRenderer, "__init__", no_mesh)


def _run_both(task, tmp, root, opts=()):
    """The port's and the JAX package's ``run_<task>`` on the tree; returns
    the two result folders."""
    cfg, _ = pconfig.setup(_argv(task, tmp, root, 'port', opts))
    getattr(prun, f'run_{task}')(cfg, device="cpu")
    jcfg = jconfig.default_cfg()
    jconfig.update_cfg(jcfg, jconfig.make_parser().parse_args(_argv(task, tmp, root, 'jax', opts)))
    with jax.default_matmul_precision('highest'):
        getattr(jrun, f'run_{task}')(jcfg)
    return cfg.result_dir, jcfg.result_dir


def _assert_pngs_agree(ours_dir, ref_dir, expect):
    ours = sorted(os.path.relpath(p, ours_dir) for p in glob.glob(f'{ours_dir}/**/*.png',
                                                                    recursive=True))
    ref = sorted(os.path.relpath(p, ref_dir) for p in glob.glob(f'{ref_dir}/**/*.png',
                                                                  recursive=True))
    assert ours == ref and len(ours) == expect, (ours, ref)
    for rel in ours:
        a = read_png(os.path.join(ours_dir, rel)).astype(np.int16)
        b = read_png(os.path.join(ref_dir, rel)).astype(np.int16)
        assert a.shape == b.shape, rel
        if rel.split(os.sep)[0] == 'specular':
            assert psnr(a / 255.0, b / 255.0) >= SPEC_MIN_PSNR, rel
        else:
            assert int(np.abs(a - b).max()) <= PNG_LEVELS, rel


def test_generator_loop_matches_the_jax_script():
    """``make_synthetic.render_images`` against the loop of
    ``scripts/make_synthetic_data.py:86-117`` re-run with the JAX renderer:
    1 frame, 2 views, 32x32."""
    views = 2
    model = BodyModel(make_synthetic.FIXTURE_BODY)
    motion = dict(np.load(make_synthetic.FIXTURE_MOTION))
    cams = make_cameras(views, H=SIZE, W=SIZE)
    cfg = _small(make_synthetic.generator_cfg(model.n_bones))
    mcfg = AniSDFConfig.from_cfg(cfg)._replace(sdf_res=8)
    renderer = SphereTracingRenderer(cfg, load_params(make_synthetic.FIXTURE_PARAMS, "cpu",
                                                      mcfg), mcfg, device="cpu")
    with torch.no_grad():
        ours = list(make_synthetic.render_images(renderer, model, motion, cams, 1, views,
                                                 SIZE, SIZE, device="cpu"))

    # the script's loop, with the same settings
    jcfg = _small(j_default_cfg())
    jcfg.n_bones = model.n_bones
    jcfg.cond_dim = model.n_bones * 3
    jcfg.relighting = True
    jcfg.n_samples = 3
    jcfg.dist_th = 0.125
    jcfg.obj_lvis.dist_th = 0.125
    jcfg.tpu.bf16_mlp = False
    jcfg.tpu.knn_impl = 'pallas'
    jmcfg = janisdf.AniSDFConfig.from_cfg(jcfg)._replace(sdf_res=8)
    jparams = j_load_params(janisdf.init_anisdf(jax.random.PRNGKey(0), jmcfg),
                            make_synthetic.FIXTURE_PARAMS)
    jmodel = JBodyModel(make_synthetic.FIXTURE_BODY)
    shapes = motion['shapes'][0]
    tverts, tjoints, big_A, _ = j_make_bigpose(jmodel, shapes)
    jrenderer = JRenderer(jcfg, jparams, jmcfg)
    jrenderer.mesh = None
    ctx = j_frame_context(jmodel, tverts, tjoints, big_A, motion['poses'][0],
                          motion['Rh'][0], motion['Th'][0], shapes)
    wb = np.asarray(ctx['wbounds'])
    for (f, v, img, acc) in ours:
        ray_o, ray_d = j_get_rays(SIZE, SIZE, cams['K'][v], cams['R'][v], cams['T'][v] / 1000.0)
        near, far, sel = j_near_far(wb, ray_o.reshape(-1, 3), ray_d.reshape(-1, 3))
        batch = jdotdict(ray_o=ray_o.reshape(-1, 3)[sel], ray_d=ray_d.reshape(-1, 3)[sel],
                         near=near[sel], far=far[sel], ctx=ctx)
        with jax.default_matmul_precision('highest'):
            out = jrenderer.render(batch)
        ref_img = np.zeros((SIZE * SIZE, 3), np.float32)
        ref_img[sel] = np.asarray(out.rgb_map)
        ref_acc = np.zeros(SIZE * SIZE, np.float32)
        ref_acc[sel] = np.asarray(out.acc_map)
        assert float(ref_acc.max()) > 0.5, f"view {v} sees no body"
        assert psnr(img, ref_img.reshape(SIZE, SIZE, 3)) >= GEN_MIN_PSNR, (f, v)
        assert psnr(acc, ref_acc.reshape(SIZE, SIZE)) >= GEN_MIN_PSNR, (f, v)


def test_run_evaluate_matches_jax(tree, in_repo, jax_renderer_without_mesh):
    tmp, root = tree
    ours_dir, ref_dir = _run_both('evaluate', tmp, root)
    ours = np.load(os.path.join(ours_dir, 'metrics.npy'), allow_pickle=True).item()
    ref = np.load(os.path.join(ref_dir, 'metrics.npy'), allow_pickle=True).item()
    assert ours['frames'] == ref['frames'] == list(range(FRAMES))
    assert min(ours['psnr']) >= GT_MIN_PSNR
    np.testing.assert_allclose(ours['psnr'], ref['psnr'], rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(ours['ssim'], ref['ssim'], rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(ours['lpips'], ref['lpips'], rtol=0, atol=LPIPS_ATOL)
    _assert_pngs_agree(ours_dir, ref_dir, FRAMES)


def test_run_visualize_matches_jax(tree, in_repo, jax_renderer_without_mesh):
    tmp, root = tree
    opts = [w for t in TYPES for w in (f'vis_{t}_map', 'True')]
    ours_dir, ref_dir = _run_both('visualize', tmp, root, opts)
    _assert_pngs_agree(ours_dir, ref_dir, FRAMES * len(TYPES))


def test_run_dataset_and_network(tree, in_repo, capsys):
    tmp, root = tree
    cfg, _ = pconfig.setup(_argv('dataset', tmp, root, 'port'))
    prun.run_dataset(cfg, device="cpu")
    assert capsys.readouterr().err.count('[dataset] frame') == FRAMES


def test_make_network_refuses_to_render_without_a_checkpoint(tree, in_repo, tmp_path):
    tmp, root = tree
    cfg, _ = pconfig.setup(_argv('evaluate', tmp, root, 'port',
                                 ['trained_model_dir', str(tmp_path / 'none'),
                                  'geometry_pretrain', str(tmp_path / 'geo')]))
    with pytest.raises(FileNotFoundError) as e:
        make_network(cfg, device="cpu")
    assert str(tmp_path / 'none') in str(e.value) and str(tmp_path / 'geo') in str(e.value)

    # stage-1 geometry alone leaves the relight heads without parameters
    os.makedirs(tmp_path / 'geo')
    with np.load(make_synthetic.FIXTURE_PARAMS) as f:
        np.savez(tmp_path / 'geo' / 'latest.npz',
                 **{"net:" + k: f[k] for k in f.files if k.split('/')[0] in
                    ('resd', 'sdf', 'beta', 'rgb')})
    with pytest.raises(FileNotFoundError, match="albedo"):
        make_network(cfg, device="cpu")

    # a reference .pth is imported now; one of the stage-1 geometry alone
    # still leaves the relight heads without parameters
    os.makedirs(cfg.trained_model_dir)
    from test_torch_checkpoints import reference_state_dict
    with np.load(make_synthetic.FIXTURE_PARAMS) as f:
        sd = reference_state_dict({k: f[k] for k in f.files
                                   if k.split('/')[0] in ('resd', 'sdf', 'beta', 'rgb')})
    torch.save(dict(net=sd), os.path.join(cfg.trained_model_dir, 'latest.pth'))
    with pytest.raises(FileNotFoundError, match="albedo"):
        make_network(cfg, device="cpu")


def test_load_model_reads_the_jax_packages_checkpoints(tmp_path):
    """``weights.load_model`` on folders written by the JAX package's
    ``save_model``: the newest epoch or ``latest.npz``, its epoch and aux,
    the parameters equal to the fixture's."""
    from relightableavatar_tpu.train.checkpoints import save_model
    from relightableavatar_tpu_torch.weights import load_model
    mcfg = AniSDFConfig(relight=True)
    with np.load(make_synthetic.FIXTURE_PARAMS) as f:
        flat = {k: f[k] for k in f.files}
    tree = {}
    for key, v in flat.items():                     # nested, as the JAX pytree is
        node = tree
        *path, leaf = key.split('/')
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    for net in tree.values():
        if isinstance(net, dict) and 'layers' in net:
            net['layers'] = [net['layers'][str(i)] for i in range(len(net['layers']))]
    save_model(str(tmp_path), {'net': tree, 'optim': {'step': np.asarray(3)}}, epoch=4,
               latest=False, aux={'iter': 12})
    save_model(str(tmp_path), {'net': tree}, epoch=9, aux={'iter': 5})
    params, epoch, aux = load_model(str(tmp_path), mcfg, device="cpu")
    assert (epoch, aux) == (9, {'iter': 5})
    params, epoch, aux = load_model(str(tmp_path), mcfg, device="cpu", epoch=4)
    assert (epoch, aux) == (4, {'iter': 12})
    np.testing.assert_array_equal(params['sdf']['layers'][3]['v'].numpy(),
                                  flat['sdf/layers/3/v'])
    assert load_model(str(tmp_path / 'none'), mcfg, device="cpu") == (None, 0, {})
