"""The mesh slice on the CPU against the JAX package: ``ops/knn.py:knn``,
``MeshDataset`` / ``MeshFrameSampler``, ``MeshRenderer.render`` in its three
SDF modes, ``run -t visualize vis_can_mesh True`` (the ``.npz`` and ``.ply``
files) and ``MeshEvaluator``.

Inputs: tubeman's config on the tracked ``data/synthetic/tubeman`` tree
(cameras, motion, body model; the mesh dataset reads no images), the fixture
avatar as the stage-1 and the relight checkpoint, a 3 cm voxel (45,472 grid
points), float32 MLPs, JAX matmuls at 'highest' precision.

The KNN: JAX's ``knn`` selects a bfloat16 2K + 2 superset with
``approx_min_k`` and takes about 107 s a 65,536-point block on the CPU (the
mesh renderer's block), so the renderer comparisons swap it, and the HDQ's
CPU ``knn_exact`` path (a matmul identity), for the exact top-K by
coordinate difference in jnp: the contract of the Pallas kernel that
``knn_exact`` runs on the TPU and of the port's kernel.  JAX's own ``knn``
is held against the port's on a grid chunk: equal but at near ties.

Bars (measured at 3 cm): faces equal; the cube within 2e-6 near the level
(measured 4.8e-7) and equal elsewhere but at band-edge voxels, which are
free space on both sides; vertices within 1e-4 m (measured 2.0e-5: a
vertex is an edge interpolation, and an edge the surface crosses nearly
tangentially turns a 5e-7 cube difference into 1e-5 m); albedo and
roughness within 2e-5 (measured 6.4e-6); skinning weights within 2e-5
(measured 7.7e-6) on the vertices whose 3 nearest reference vertices are
the same in both meshes, at most 1 % not (``eval/mesh_check.py``: a near-
tied 3rd neighbour swaps under a 1e-6 m shift).
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads  # noqa: F401 (fixture)
import relightableavatar_tpu.config as jconfig
import relightableavatar_tpu.models.anisdf as j_anisdf
import relightableavatar_tpu.renderer.mesh as jmesh
import run as jrun
from relightableavatar_tpu.data import datasets as jdata
from relightableavatar_tpu.eval.evaluator import MeshEvaluator as JMeshEvaluator
from relightableavatar_tpu.models.factory import make_network as j_make_network
from relightableavatar_tpu.models.factory import make_renderer as j_make_renderer
from relightableavatar_tpu.ops.knn import knn as j_knn
from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
from relightableavatar_tpu.vis.visualizer import write_ply as j_write_ply
from relightableavatar_tpu_torch import config as pconfig
from relightableavatar_tpu_torch import run as prun
from relightableavatar_tpu_torch.data import datasets as pdata
from relightableavatar_tpu_torch.data.make_synthetic import FIXTURE_PARAMS
from relightableavatar_tpu_torch.eval import mesh_check
from relightableavatar_tpu_torch.eval.evaluator import MeshEvaluator
from relightableavatar_tpu_torch.models.factory import make_network, make_renderer
from relightableavatar_tpu_torch.ops import knn as pknn
from relightableavatar_tpu_torch.renderer import mesh as pmesh
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.vis.visualizer import write_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, 'data', 'synthetic', 'tubeman')
VOXEL = 0.03
LEVEL_BAND = 0.05       # cube values this close to the level are held to CUBE_ATOL
CUBE_ATOL = 2e-6
VERT_ATOL = mesh_check.VERT_ATOL
TIE_SHARE = 0.01        # points on which JAX's bf16-selected knn may differ (near ties)


# ------------------------------------------------------------ the JAX side
@partial(jax.jit, static_argnames=("K",))
def _exact_block(p, v, K):
    d2 = jnp.sum((p[:, None, :] - v[None]) ** 2, -1)
    nd, idx = jax.lax.top_k(-d2, K)
    return -nd, idx


def exact_knn(pts, verts, K=3, block=4096):
    """Exact top-K by coordinate difference in jnp, ties to the lower index;
    ``block`` points at a time (the caller's block is ignored: it only
    tiles)."""
    block = 4096
    outs = []
    for s in range(0, pts.shape[0], block):
        p = pts[s:s + block]
        n = p.shape[0]
        p = jnp.concatenate([p, jnp.zeros((block - n, 3), p.dtype)]) if n < block else p
        d2, idx = _exact_block(p, verts, K)
        outs.append((d2[:n], idx[:n]))
    return (jnp.concatenate([o[0] for o in outs]),
            jnp.concatenate([o[1] for o in outs]).astype(jnp.int32))


@pytest.fixture()
def jax_exact_knn(monkeypatch):
    monkeypatch.setattr(jmesh, "knn", exact_knn)
    monkeypatch.setattr(j_anisdf, "knn_unchunked",
                        lambda p, v, K=3, exact=False, fast=False: exact_knn(p, v, K))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory with the repo's configs (their parents are named
    relative to it) and the fixture written as the stage-1 and the relight
    checkpoint."""
    tmp = tmp_path_factory.mktemp("mesh")
    os.symlink(os.path.join(REPO, 'configs'), tmp / 'configs')
    with np.load(FIXTURE_PARAMS) as f:
        flat = {"net:" + k: f[k] for k in f.files}
    for sub in ('deform/tubeman', 'relight/tubeman_relight'):
        os.makedirs(tmp / 'trained_model' / sub)
        np.savez(tmp / 'trained_model' / sub / 'latest.npz', **flat)
    return tmp


def _argv(task, mode, opts=()):
    return ['-t', task, '-c', 'configs/synthetic/tubeman.yaml', mode, 'True',
            'test_dataset.data_root', DATA, 'train_dataset.data_root', DATA,
            'trained_model_dir', 'trained_model', 'voxel_size', f'[{VOXEL},{VOXEL},{VOXEL}]',
            'tpu.bf16_mlp', 'False', 'tpu.knn_impl', 'pallas', *opts]


def _cfgs(argv):
    pcfg, _ = pconfig.setup(argv)
    jcfg = jconfig.default_cfg()
    jconfig.update_cfg(jcfg, jconfig.make_parser().parse_args(argv))
    return pcfg, jcfg


@pytest.fixture()
def in_workdir(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    return workdir


def _recording(monkeypatch, module, store, key):
    """Record the (field, level) that ``module``'s renderer marches."""
    march = module.marching_tets

    def recorded(field, level, *args, **kwargs):
        store[key] = (np.array(field), level)
        return march(field, level, *args, **kwargs)
    monkeypatch.setattr(module, "marching_tets", recorded)


def _assert_cubes_agree(ours, ref):
    (a, la), (b, lb) = ours, ref
    assert la == lb and a.shape == b.shape
    near = (np.abs(a - la) < LEVEL_BAND) | (np.abs(b - lb) < LEVEL_BAND)
    assert near.sum() > 1000
    print(f"cube: max |diff| near the level {float(np.abs(a - b)[near].max()):.3e}")
    assert float(np.abs(a - b)[near].max()) <= CUBE_ATOL
    # elsewhere equal, but at the band's edge (a point within dist_th of a
    # vertex in one KNN's rounding only): free space on both sides
    off = ~np.isclose(a, b, rtol=0, atol=CUBE_ATOL)
    assert off.sum() <= 10
    assert ((a[off] > la + LEVEL_BAND) & (b[off] > lb + LEVEL_BAND)).all()


def _assert_meshes_agree(ours, ref, materials: bool, cloud):
    """``eval/mesh_check.py``'s bars: equal faces, vertices within 1e-4 m,
    materials within 2e-5, the skinning weights within 2e-5 where the two
    meshes' vertices have the same 3 nearest ``cloud`` vertices (a vertex
    shift can swap a near-tied 3rd neighbour), at most 1 % not."""
    ref = dotdict({k: np.asarray(v) for k, v in ref.items() if v is not None})
    assert ours.faces.dtype == np.int32 and len(ours.faces) > 1000
    diff = mesh_check.compare(ours, ref, cloud)
    print(f"mesh: {diff}")
    assert mesh_check.agrees(diff), diff
    assert materials == ('albedo' in ours) == ('albedo' in ref) == ('albedo' in diff)
    np.testing.assert_array_equal(ours.tjoints, ref.tjoints)
    np.testing.assert_array_equal(ours.parents, ref.parents)


# ------------------------------------------------------------ KNN
def test_knn_equals_jax_but_near_ties(in_workdir):
    """``knn`` against JAX's own (bf16 superset, exact f32 values) on the
    first 4096 points of the 3 cm canonical grid, K = 1 and 3."""
    pcfg, _ = _cfgs(_argv('visualize', 'vis_can_mesh'))
    ds = pdata.make_dataset(pcfg, is_train=False, device="cpu")
    b = ds[-1]
    pts = b.pts.reshape(-1, 3)[20000:24096]
    verts = b.ctx['tverts']
    for K in (1, 3):
        d2, idx = pknn.knn(torch.as_tensor(pts), verts, K=K)
        jd2, jidx = j_knn(jnp.asarray(pts), jnp.asarray(verts.numpy()), K=K, block=4096)
        assert d2.shape == idx.shape == (4096, K) and idx.dtype == torch.int32
        np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=0, atol=1e-6)
        differ = (idx.numpy() != np.asarray(jidx)).any(1)
        assert differ.mean() <= TIE_SHARE, differ.mean()
        # where the indices differ, the two neighbours are as far: a near tie
        vv = verts.numpy()
        for i in np.flatnonzero(differ):
            a = ((pts[i] - vv[idx[i].numpy()]) ** 2).sum(-1)
            bb = ((pts[i] - vv[np.asarray(jidx[i])]) ** 2).sum(-1)
            np.testing.assert_allclose(np.sort(a), np.sort(bb), rtol=1e-5, atol=1e-9)


def test_knn_chunks_and_refuses_more_than_three(monkeypatch):
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.random((1000, 3), np.float32))
    verts = torch.as_tensor(rng.random((50, 3), np.float32))
    whole = pknn.knn(pts, verts, K=3)
    monkeypatch.setattr(pknn, "CHUNK", 128)
    chunked = pknn.knn(pts, verts, K=2)
    assert torch.equal(chunked[0], whole[0][:, :2]) and torch.equal(chunked[1], whole[1][:, :2])
    assert pknn.knn(pts[:0], verts, K=1)[0].shape == (0, 1)
    # K > 3 (sample_vert_cnt) is the exact plain top K, chunked the same way;
    # fewer than one neighbour is refused
    four = pknn.knn(pts, verts, K=4)
    monkeypatch.setattr(pknn, "CHUNK", 1 << 20)
    assert torch.equal(four[1], pknn.knn(pts, verts, K=4)[1])
    assert torch.equal(four[1][:, :3], whole[1]) and torch.equal(four[0][:, :3], whole[0])
    with pytest.raises(ValueError, match="at least one"):
        pknn.knn(pts, verts, K=0)


# ------------------------------------------------------------ dataset
@pytest.mark.parametrize("mesh_type", ["tpose", "posed"])
def test_mesh_dataset_and_sampler_match_jax(in_workdir, mesh_type):
    from test_torch_datasets import _assert_same
    pcfg, jcfg = _cfgs(_argv('visualize', 'vis_posed_mesh',
                             ['mesh.type', mesh_type, 'test.frame_sampler_interval', '10']))
    ours = pdata.make_data_loader(pcfg, is_train=False, device="cpu")
    ref = jdata.make_data_loader(jcfg, is_train=False)
    assert isinstance(ours.sampler, pdata.MeshFrameSampler)
    assert list(ours.sampler) == list(ref.sampler) == [-1, 0, 10, 20]
    for i in (-1, 10):
        ob, rb = ours.dataset[i], ref.dataset[i]
        assert ob.pts.dtype == np.float32 and ob.pts.ndim == 4
        _assert_same(ob, rb)
    assert ours.dataset[-1].meta.frame_index == -1


# ------------------------------------------------------------ renderer
@pytest.mark.parametrize("mode,item", [("vis_can_mesh", -1), ("vis_posed_mesh", 0),
                                       ("vis_tpose_mesh", 0)])
def test_mesh_renderer_matches_jax(in_workdir, jax_exact_knn, monkeypatch, mode, item):
    """The canonical SDF, the HDQ world SDF of frame 0 and the T-pose SDF
    with frame 0's pose residuals, from the relight checkpoint (materials)."""
    pcfg, jcfg = _cfgs(_argv('visualize', mode, ['relighting', 'True']))
    cubes = {}
    _recording(monkeypatch, pmesh, cubes, 'port')
    _recording(monkeypatch, jmesh, cubes, 'jax')
    params, mcfg = make_network(pcfg, device="cpu")
    renderer = make_renderer(pcfg, params, mcfg, device="cpu")
    assert isinstance(renderer, pmesh.MeshRenderer)
    batch = pdata.make_dataset(pcfg, is_train=False, device="cpu")[item]
    ours = renderer.render(batch)
    jparams, jmcfg = j_make_network(jcfg)
    with jax.default_matmul_precision('highest'):
        ref = j_make_renderer(jcfg, jparams, jmcfg).render(
            jdata.make_dataset(jcfg, is_train=False)[item])
    stats = renderer.last_mesh
    assert stats.grid_points == 45472 and 0 < stats.band_points < stats.grid_points
    assert (stats.verts, stats.faces) == (len(ours.verts), len(ours.faces))
    _assert_cubes_agree(cubes['port'], cubes['jax'])
    _assert_meshes_agree(ours, ref, True, pmesh.reference_cloud(batch.ctx, mode != 'vis_posed_mesh'))


# ------------------------------------------------------------ CLI
def _run_visualize_both(workdir, monkeypatch, opts):
    """``run_visualize`` of each package in a working directory of its own;
    returns the two mesh folders."""
    dirs = []
    for name in ('port', 'jax'):
        wd = workdir / f'cli_{name}_{"_".join(opts) or "plain"}'
        os.makedirs(wd)
        os.symlink(workdir / 'configs', wd / 'configs')
        os.symlink(workdir / 'trained_model', wd / 'trained_model')
        monkeypatch.chdir(wd)
        pcfg, jcfg = _cfgs(_argv('visualize', 'vis_can_mesh', opts))
        if name == 'port':
            prun.run_visualize(pcfg, device="cpu")
        else:
            with jax.default_matmul_precision('highest'):
                jrun.run_visualize(jcfg)
        dirs.append(wd / 'data' / 'animation' / pcfg.task / pcfg.exp_name)
    return dirs


def test_run_visualize_can_mesh_matches_jax(workdir, jax_exact_knn, monkeypatch):
    """``run -t visualize vis_can_mesh True`` from the stage-1 checkpoint:
    can_mesh.npz and frame0000.npz within the bars, the .ply files equal in
    size, header and faces, their vertices within the bar, and the port's
    .ply bytes equal to the JAX writer's on the port's arrays."""
    ours_dir, ref_dir = _run_visualize_both(workdir, monkeypatch, [])
    assert sorted(os.listdir(ours_dir)) == sorted(os.listdir(ref_dir)) == [
        'can_mesh.npz', 'can_mesh.ply', 'frame0000.npz', 'frame0000.ply']
    monkeypatch.chdir(workdir)
    pcfg, _ = _cfgs(_argv('visualize', 'vis_can_mesh'))
    ds = pdata.make_dataset(pcfg, is_train=False, device="cpu")
    for name, item in (('can_mesh', -1), ('frame0000', 0)):
        ours = dotdict(np.load(ours_dir / f'{name}.npz'))
        ref = jdotdict(np.load(ref_dir / f'{name}.npz'))
        assert sorted(ours) == sorted(ref) == ['faces', 'parents', 'tjoints', 'verts',
                                               'weights']
        _assert_meshes_agree(ours, ref, False, pmesh.reference_cloud(ds[item].ctx, True))
        data = (ours_dir / f'{name}.ply').read_bytes()
        ref_data = (ref_dir / f'{name}.ply').read_bytes()
        head = data.index(b'end_header\n') + len(b'end_header\n')
        nv = len(ours.verts) * 12
        assert len(data) == len(ref_data) and data[:head] == ref_data[:head]
        assert data[head + nv:] == ref_data[head + nv:]                 # faces
        np.testing.assert_allclose(np.frombuffer(data[head:head + nv], '<f4'),
                                   np.frombuffer(ref_data[head:head + nv], '<f4'),
                                   rtol=0, atol=VERT_ATOL)
        j_write_ply(str(workdir / 'jax_writer.ply'), ours.verts, ours.faces)
        assert data == (workdir / 'jax_writer.ply').read_bytes()
    # the stage-2 geometry prior reads it back: outward windings
    from relightableavatar_tpu_torch.data.datasets import make_dataset
    can = np.load(ours_dir / 'can_mesh.npz')
    tri = can['verts'].astype(np.float64)[can['faces']]
    tri -= can['verts'].mean(0)
    assert np.einsum('fi,fi->f', tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() > 0
    pcfg, _ = pconfig.setup(['-t', 'evaluate', '-c', 'configs/synthetic/tubeman.yaml',
                             'relighting', 'True', 'test_dataset.data_root', DATA,
                             'use_geometry', 'True', 'geometry_mesh', str(ours_dir / 'can_mesh.npz')])
    ds = make_dataset(pcfg, is_train=False, device="cpu")
    assert ds.geometry is not None and len(ds.tverts) == len(can['verts'])


def test_run_visualize_with_decimation(workdir, jax_exact_knn, monkeypatch):
    """``mesh_simp_face``: both packages' meshes meet the target, and the
    port's equals the JAX package's decimation of the port's own marched
    mesh.  (The two packages' decimated meshes are not compared: QEM's
    collapse order follows costs that a 1e-5 m vertex shift can reorder.)"""
    target = 6000
    seen = []
    decimate = pmesh.decimate

    def recorded(verts, faces, n):
        out = decimate(verts, faces, n)
        seen.append((verts.copy(), faces.copy(), n, out))
        return out
    monkeypatch.setattr(pmesh, "decimate", recorded)
    ours_dir, ref_dir = _run_visualize_both(workdir, monkeypatch, ['mesh_simp_face', str(target)])
    assert len(seen) == 2
    from relightableavatar_tpu.ops.meshtools import decimate as j_decimate
    for (verts, faces, n, (v, f)), name in zip(seen, ('can_mesh', 'frame0000')):
        assert n == target and len(faces) > target
        jv, jf = j_decimate(verts, faces, n)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
        ours, ref = np.load(ours_dir / f'{name}.npz'), np.load(ref_dir / f'{name}.npz')
        np.testing.assert_array_equal(ours['verts'], v)
        np.testing.assert_array_equal(ours['faces'], f.astype(np.int32))
        assert target * 0.9 <= len(ours['faces']) <= target
        assert target * 0.9 <= len(ref['faces']) <= target


# ------------------------------------------------------------ evaluator
def test_mesh_evaluator_matches_jax(in_workdir):
    pcfg, jcfg = _cfgs(_argv('evaluate', 'vis_can_mesh'))
    ours, ref = MeshEvaluator(pcfg), JMeshEvaluator(jcfg)
    rng = np.random.default_rng(2)
    gt = rng.normal(size=(3000, 3)).astype(np.float32)
    for shift in (0.0, 0.01):
        pred = (gt[:2500] + shift).astype(np.float32)
        ours.evaluate(dotdict(verts=torch.as_tensor(pred)), dotdict(gt_verts=gt))
        ref.evaluate(jdotdict(verts=pred), jdotdict(gt_verts=gt))
    ours.evaluate(dotdict(verts=pred), dotdict())           # no gt_verts: not scored
    a, b = ours.summarize(), ref.summarize()
    assert set(a) == set(b) == {'chamfer', 'p2s'}
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-6, abs=0)
    assert ours.summarize() == {}


def test_run_evaluate_selects_the_mesh_evaluator(in_workdir, monkeypatch):
    pcfg, _ = pconfig.setup(_argv('evaluate', 'vis_can_mesh', ['test.frame_sampler_interval',
                                                                '100', 'voxel_size',
                                                                '[0.08,0.08,0.08]']))
    assert pcfg.evaluator_module == 'lib.evaluators.mesh_evaluator'
    scored = []
    monkeypatch.setattr(MeshEvaluator, "evaluate",
                        lambda self, out, batch: scored.append(len(out.faces)))
    assert prun.run_evaluate(pcfg, device="cpu") == {}
    assert len(scored) == 2 and min(scored) > 0
