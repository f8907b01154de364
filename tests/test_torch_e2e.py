"""The two-stage pipeline of the port (``train/e2e.py``, the counterpart of
``scripts/train_e2e.py``) on the CPU, with the pieces that come with it:
the golden 512² check's config (``eval/check_golden_512.py``) and its
golden reader (``eval/golden.py:read_golden``),
16-bit PNG reading (``data/image_io.py:read_png``) and the learned
environment map's comparison with probes (``eval/evaluate_lighting.py``).

- The stages' argument lists against the JAX script's at the same flags:
  the JAX ``main`` runs with its ``run`` recording instead of running.
- The pipeline in this process on the CPU: a ``make_synthetic`` tree of 2
  frames x 4 views at 32² (6 surface and 2 shadow iterations, a 4x coarser
  visibility grid, so that it renders in seconds), the stage-1 checkpoint
  seeded with the fixture's geometry (``seed_stage1``; a few steps from
  ``init_anisdf`` leave no surface to mesh), then every stage in order at
  1 epoch of 2 iterations (``STAGE_SMALL``: 2 frames x 32 rays, the mesh at
  5 cm voxels, the evaluations at ratio 0.5), then ``--resume``, the
  ``--skip-*`` flags and the gate.
- Seconds under ``-n 6`` with the tier-1 command's options: the pipeline
  test 25 s, the other 13 tests 2 s together; with the mesh-prior step of
  ``tests/test_torch_relight_train.py`` (56 s) this slice's tests take
  about 85 s.
"""
import importlib.util
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads  # noqa: F401 (fixture)
from relightableavatar_tpu_torch.data import image_io
from relightableavatar_tpu_torch.data.make_synthetic import (FIXTURE_PARAMS, generator_cfg,
                                                              make_dataset_tree)
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.eval.evaluate_lighting import evaluate_lighting
from relightableavatar_tpu_torch.train import e2e
from relightableavatar_tpu_torch.utils import log as plog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = 'tubeman_e2e'
FAST = ['n_rays', '32', 'train.batch_size', '2', 'train.num_workers', '2', 'ep_iter', '2',
        'tpu.bf16_mlp', 'False', 'record_tb', 'False']
LIGHT = ['env_h', '4', 'env_w', '8', 'sphere_tracing.iter', '4', 'obj_lvis.iter', '1']
# key value overrides that size each stage for the CPU
STAGE_SMALL = {
    'train1': FAST + ['n_samples', '4'],
    'eval1': ['n_samples', '8', 'ratio', '0.5', 'tpu.bf16_mlp', 'False', 'tpu.ray_block', '256'],
    'mesh': ['voxel_size', '[0.05,0.05,0.05]'],
    'train2': FAST + LIGHT + ['network_chunk_size', '4096'],
    'eval2': LIGHT + ['ratio', '0.5', 'tpu.bf16_mlp', 'False', 'tpu.ray_block', '256'],
}
ORDER = ['train1', 'eval1', 'mesh', 'train2', 'eval2']
# the JAX script's summary keys, and the metrics that its evaluations store
JAX_KEYS = {'exp', 'epochs1', 'epochs2', 'n_samples_stage1', 'stages', 'eval_stage1',
            'eval_stage2', 'gate'}
METRIC_KEYS = {'psnr', 'ssim', 'lpips', 'skipped_black_gt', 'provenance'}


# ---------------------------------------------------------------- the plan
def _jax_stages(monkeypatch, tmp_path, flags):
    """[(log name, arguments after the script)] that ``scripts/train_e2e.py``
    runs with ``flags``, its stages recorded instead of run."""
    spec = importlib.util.spec_from_file_location('jax_train_e2e',
                                                  os.path.join(REPO, 'scripts', 'train_e2e.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import relightableavatar_tpu.utils.preempt as jpreempt
    calls = []

    def run(args_list, log_name, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        calls.append((log_name, args_list))
        return 0.0

    monkeypatch.setattr(mod, 'REPO', str(tmp_path))
    monkeypatch.setattr(mod, 'run', run)
    monkeypatch.setattr(mod, 'start_snapshot_daemon', lambda *a: None)
    monkeypatch.setattr(mod, 'snapshot_evidence', lambda *a: None)
    monkeypatch.setattr(jpreempt, 'register_training_group', lambda: None)
    monkeypatch.setattr(sys, 'path', list(sys.path))
    monkeypatch.setattr(sys, 'argv', ['train_e2e.py', *flags])
    exp = flags[flags.index('--exp') + 1] if '--exp' in flags else EXP
    mesh = tmp_path / f'data/animation/deform/{exp}/can_mesh.npz'
    mesh.parent.mkdir(parents=True, exist_ok=True)
    mesh.write_bytes(b'')
    with pytest.raises(SystemExit, match='quality gate FAILED'):
        mod.main()
    return calls


@pytest.mark.parametrize('flags', [
    [],
    ['--exp', 'ava', '--epochs1', '3', '--epochs2', '2', '--n-samples', '16', '--ratio', '0.5',
     '--resume', '--fresh-stage2', '--extra', 'tpu.bf16_act', 'True', 'edge_sample_ratio', '0.3'],
    ['--resume', '--skip-stage1', '--skip-eval1', '--skip-mesh', '--skip-stage2'],
], ids=['defaults', 'resume_extra', 'skips'])
def test_stages_take_the_jax_scripts_arguments(flags, monkeypatch, tmp_path):
    """Each stage of the plan has the JAX script's log name and arguments,
    letter for letter, through the port's module instead of the script;
    the evaluations append ``EVAL_OPTS`` (PNG frames, no video)."""
    ref = _jax_stages(monkeypatch, tmp_path, flags)
    ours = e2e.plan(e2e.parse_args(flags))
    assert [s.name for s in ours] == [name for name, _ in ref]
    script = {'train.py': e2e.TRAIN_MOD, 'run.py': e2e.RUN_MOD}
    for stage, (_, args) in zip(ours, ref):
        assert stage.module == script[args[0]]
        want = args[1:] + (e2e.EVAL_OPTS if stage.name.startswith('eval') else [])
        assert list(stage.argv) == want, stage.name


def test_plan_generates_the_tree_only_without_images(tmp_path):
    a = e2e.parse_args([])
    first = e2e.plan(a, str(tmp_path))[0]
    assert first.name == 'data' and first.module == e2e.DATA_MOD
    assert list(first.argv) == ['--root', e2e.DATA_ROOT, '--frames', '24', '--views', '4',
                                '--size', '512']
    img = tmp_path / e2e.DATA_ROOT / 'images' / '00' / '000000.png'
    img.parent.mkdir(parents=True)
    img.write_bytes(b'')
    assert [s.name for s in e2e.plan(a, str(tmp_path))] == ORDER


# ---------------------------------------------------------------- the pipeline
def _tree(root):
    """The make_synthetic tree of the pipeline test under ``root``."""
    cfg = generator_cfg(52)
    cfg.sphere_tracing.iter, cfg.obj_lvis.iter = 6, 2
    cfg.tpu.lvis_downscale, cfg.tpu.ray_block = 4, 256
    with torch.no_grad():
        make_dataset_tree(os.path.join(root, e2e.DATA_ROOT), 2, 4, 32, device='cpu', cfg=cfg)


def _run(root, flags):
    return e2e.run_pipeline(e2e.parse_args(['--root', str(root), *flags]), device='cpu')


def _summary(root):
    with open(os.path.join(root, 'data/record', EXP, 'e2e_summary.json')) as f:
        return json.load(f)


def _epoch(root, rel):
    with np.load(os.path.join(root, 'data/trained_model', rel, 'latest.npz')) as f:
        return int(f['epoch'])


def _log(root, name):
    with open(os.path.join(root, 'data/record', EXP, name + '.log')) as f:
        return f.read()


def test_pipeline_in_process_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(plog, '_QUIET', False)          # the stage logs are read below
    plan = e2e.plan
    monkeypatch.setattr(e2e, 'plan', lambda a, root=None: [
        e2e.Stage(st.name, st.module, st.argv + tuple(STAGE_SMALL.get(st.name, ())))
        for st in plan(a, root)])
    root = tmp_path / 'work'
    _tree(str(root))
    e2e.seed_stage1(str(root), EXP)

    # every stage, in order; the 28 dB gate fails after the summary is written
    with pytest.raises(SystemExit, match='quality gate FAILED'):
        _run(root, ['--epochs1', '1', '--epochs2', '1', '--resume'])
    s = _summary(root)
    assert JAX_KEYS <= set(s) and {'train_psnr', 'lighting'} <= set(s)
    assert list(s['stages']) == [f'{n}_s' for n in ORDER]
    assert all(v > 0 for v in s['stages'].values())
    for key in ('eval_stage1', 'eval_stage2'):
        assert set(s[key]) == METRIC_KEYS
        assert all(np.isfinite(s[key][k]) for k in ('psnr', 'ssim', 'lpips'))
    assert s['eval_stage1']['provenance'] == {
        'checkpoint': f'data/trained_model/deform/{EXP}/latest.npz', 'checkpoint_epoch': 1,
        'epochs1': 1, 'n_samples_stage1': 64}
    assert s['eval_stage2']['provenance'] == {
        'checkpoint': f'data/trained_model/relight/{EXP}_relight/latest.npz',
        'checkpoint_epoch': 1, 'epochs2': 1,
        'geometry_mesh': f'data/animation/deform/{EXP}/can_mesh.npz',
        'geometry_pretrain_epoch': 1}
    assert s['gate']['pass'] is False and s['gate']['psnr'] == s['eval_stage2']['psnr']
    assert s['lighting']['probes'] is None and s['lighting']['max'] >= s['lighting']['mean'] > 0
    assert 'loaded geometry pretrain' in _log(root, 'train2')
    with np.load(os.path.join(root, e2e.mesh_path(e2e.parse_args([])))) as f:
        assert len(f['faces']) > 0 and len(f['verts']) == len(f['weights'])

    # --resume continues both stages at the saved epoch; --skip-eval1 and
    # --skip-mesh reuse the metrics and the mesh on disk; a 0 dB gate passes
    s2 = _run(root, ['--epochs1', '2', '--epochs2', '2', '--resume', '--skip-eval1',
                     '--skip-mesh', '--gate-psnr', '0'])
    assert list(s2['stages']) == ['train1_s', 'train2_s', 'eval2_s'] and s2['gate']['pass']
    assert _epoch(root, f'deform/{EXP}') == 2 and _epoch(root, f'relight/{EXP}_relight') == 2
    steps = [json.loads(r)['step'] for r in
             open(os.path.join(root, 'data/record/deform', EXP, 'scalars.jsonl'))]
    assert steps == [1, 2, 3, 4]
    assert s2['eval_stage1']['psnr'] == s['eval_stage1']['psnr']
    assert s2['eval_stage2']['provenance']['checkpoint_epoch'] == 2

    # --skip-stage1 (and the rest) reuse the stage-1 checkpoint on disk
    stamp = os.path.getmtime(os.path.join(root, 'data/trained_model/deform', EXP, 'latest.npz'))
    s3 = _run(root, ['--skip-stage1', '--skip-eval1', '--skip-mesh', '--skip-stage2',
                     '--gate-psnr', '0'])
    assert list(s3['stages']) == ['eval2_s']
    assert os.path.getmtime(os.path.join(root, 'data/trained_model/deform', EXP,
                                         'latest.npz')) == stamp
    assert s3['eval_stage2']['provenance']['geometry_pretrain_epoch'] == 2

    # --skip-mesh without a mesh raises before any stage runs
    bare = tmp_path / 'bare'
    with pytest.raises(SystemExit, match='no geometry prior'):
        _run(bare, ['--skip-stage1', '--skip-eval1', '--skip-mesh'])
    assert not (bare / 'data' / 'record').exists()


def test_psnr_curve_is_the_mean_of_the_window(tmp_path):
    path = tmp_path / 'scalars.jsonl'
    rows = [dict(step=i, epoch=0, psnr=float(i % 7)) for i in range(1, 251)]
    rows += [dict(step=i, epoch=1, psnr=100.0) for i in (201, 202)]   # a resumed run's rows win
    path.write_text(''.join(json.dumps(r) + '\n' for r in rows))
    vals = {r['step']: r['psnr'] for r in rows}
    curve = e2e.psnr_curve(str(path), steps=(100, 250, 1000), window=100)
    assert set(curve) == {'100', '250'}
    assert curve['100'] == pytest.approx(np.mean([vals[t] for t in range(1, 101)]))
    assert curve['250'] == pytest.approx(np.mean([vals[t] for t in range(151, 251)]))


# ---------------------------------------------------------------- 16-bit PNG
def _png_bytes(img: np.ndarray, ctype: int, filters) -> bytes:
    """A 16-bit PNG of ``img`` (uint16, (H, W, C)) written with numpy: each
    row big-endian, filtered by the row's entry of ``filters`` (0-4, as the
    PNG specification defines them on bytes)."""
    H, W, C = img.shape
    bpp = 2 * C
    rows = img.astype('>u2').reshape(H, W * C).view(np.uint8).reshape(H, W * bpp).astype(np.int64)
    out, prior = [], np.zeros(W * bpp, np.int64)
    for y in range(H):
        cur, f = rows[y], filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur
    chunk = lambda k, b: (struct.pack('>I', len(b)) + k + b
                          + struct.pack('>I', zlib.crc32(k + b) & 0xFFFFFFFF))
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack('>IIBBBBB', W, H, 16, ctype,
                                                                0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(out))) + chunk(b'IEND', b''))


@pytest.mark.parametrize('channels,ctype', [(3, 2), (1, 0), (4, 6), (2, 4)],
                         ids=['rgb', 'gray', 'rgba', 'gray_alpha'])
def test_read_png_16bit_from_numpy_bytes(channels, ctype, tmp_path):
    img = np.random.default_rng(channels).integers(0, 65536, (9, 7, channels), dtype=np.uint16)
    img[3:6] = 65535 - img[3:6] // 3                        # runs the filters see
    path = tmp_path / 'x.png'
    path.write_bytes(_png_bytes(img, ctype, filters=[0, 1, 2, 3, 4]))
    got = image_io.read_png(str(path))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, img[..., 0] if channels == 1 else img)


def test_read_png_reads_the_stored_golden_as_opencv_does():
    got = image_io.read_png(golden.GOLDEN_RELIGHT_512)
    ref = cv2.cvtColor(cv2.imread(golden.GOLDEN_RELIGHT_512, cv2.IMREAD_UNCHANGED),
                       cv2.COLOR_BGR2RGB)
    assert got.dtype == np.uint16 and got.shape == (512, 512, 3)
    np.testing.assert_array_equal(got, ref)
    ok, p = golden.check_golden(got.astype(np.float32) / 65535.0, golden.GOLDEN_RELIGHT_512)
    assert ok and p == 120.0


def test_jax_cpu_golden_is_the_stale_pngs_frame():
    """``tests/golden_relight_512_jaxcpu.npy`` (``tests/make_golden_512_jaxcpu.py``:
    the JAX package's CPU render of the frame at HEAD) is a 512 x 512 uint16
    RGB frame 41.75 dB from the stored PNG: the same frame, but not within
    the 45 dB that the JAX script holds renders to, so the PNG is stale and
    the port's check holds it to the CPU render."""
    raw = np.load(golden.GOLDEN_RELIGHT_512_JAXCPU)
    assert raw.dtype == np.uint16 and raw.shape == (512, 512, 3)
    img = golden.read_golden(golden.GOLDEN_RELIGHT_512_JAXCPU)
    np.testing.assert_array_equal(img, raw.astype(np.float32) / 65535.0)
    ok, p = golden.check_golden(img, golden.GOLDEN_RELIGHT_512)
    assert not ok and p == pytest.approx(41.75, abs=0.01)
    png = golden.read_golden(golden.GOLDEN_RELIGHT_512)
    assert ((img.max(-1) > 0) == (png.max(-1) > 0)).mean() > 0.998   # the same silhouette


# ---------------------------------------------------------------- golden 512 config
def _flat(node, prefix=''):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = list(v) if isinstance(v, (list, tuple)) else v
    return out


def test_golden512_cfg_is_the_benchs_headline_frame(monkeypatch):
    """``golden512_cfg()`` is ``scripts/check_golden_512.py``'s config
    (``bench._setup``'s ``make_cfg(relight=True)``, ``n_samples`` 3,
    ``_accel_knobs(on=True)``) on every key the two trees share, and the
    frame's rays are ``bench._rays``' mask."""
    monkeypatch.chdir(REPO)
    monkeypatch.syspath_prepend(REPO)
    import bench
    _, jctx, make_cfg, _ = bench._setup()
    jcfg = make_cfg(relight=True)
    jcfg.n_samples = 3
    bench._accel_knobs(jcfg, on=True)
    ours, ref = _flat(golden.golden512_cfg()), _flat(jcfg)
    common = set(ours) & set(ref)
    assert len(common) > 200 and 'tpu.shadow_grid' in common and 'tpu.surf_miss_skip' in common
    assert {k: ours[k] for k in common} == {k: ref[k] for k in common}
    assert ours['tpu.bf16_mlp'] is True and ours['tpu.surf_miss_skip'] is False
    jbatch, n = bench._rays(jctx, 512, 512)
    ctx, _, _ = golden.load_fixture(golden.golden512_cfg(), device='cpu')
    _, mab = golden.frame_batch(ctx, 512, 512)
    assert int(mab.sum()) == n > 40000
    np.testing.assert_array_equal(mab, np.asarray(jbatch.mask_at_box))


# ---------------------------------------------------------------- evaluate_lighting
def test_evaluate_lighting_matches_numpy(tmp_path, monkeypatch):
    """The learned map (softplus of the fixture's env, 32 x 64 -> 16 x 32 by
    INTER_AREA) against two ``.hdr`` probes, scale-aligned, as a direct
    numpy computation with OpenCV's reader and resize gives it; without
    OpenCV an ``.hdr`` probe raises ``NeedsOpenCV``; without a probe folder,
    the learned map's mean and max."""
    monkeypatch.chdir(REPO)
    model_dir = tmp_path / 'trained_model' / 'relight' / 'tubeman_relight'
    model_dir.mkdir(parents=True)
    with np.load(FIXTURE_PARAMS) as f:
        np.savez(model_dir / 'latest.npz', epoch=np.asarray(0),
                 **{'net:' + k: f[k] for k in f.files})
        env = f['env'].astype(np.float64)
    probes = tmp_path / 'probes'
    probes.mkdir()
    rng = np.random.default_rng(5)
    for name in ('a.hdr', 'b.hdr'):
        image_io.write_hdr(str(probes / name), rng.random((32, 64, 3)).astype(np.float32) * 4)
    argv = ['-c', 'configs/synthetic/tubeman.yaml', 'relighting', 'True',
            'trained_model_dir', str(tmp_path / 'trained_model')]
    rep = evaluate_lighting(argv, str(probes), device='cpu')

    learned = np.log1p(np.exp(env)) * np.ones(3)
    learned = cv2.resize(learned.astype(np.float32), (32, 16), interpolation=cv2.INTER_AREA)
    assert set(rep['probes']) == {'a.hdr', 'b.hdr'}
    for name, got in rep['probes'].items():
        gt = cv2.cvtColor(cv2.imread(str(probes / name), cv2.IMREAD_UNCHANGED),
                          cv2.COLOR_BGR2RGB).astype(np.float32)
        gt = cv2.resize(gt, (32, 16), interpolation=cv2.INTER_AREA).astype(np.float64)
        s = (learned * gt).sum() / max((learned ** 2).sum(), 1e-8)
        mse = ((s * learned - gt) ** 2).mean()
        assert got['scale'] == pytest.approx(s, rel=1e-5)
        assert got['mse'] == pytest.approx(mse, rel=1e-4)
        assert got['psnr'] == pytest.approx(-10 * np.log10(mse / gt.max() ** 2 + 1e-12),
                                            abs=1e-3)
    monkeypatch.setitem(sys.modules, 'cv2', None)        # the card's machine: no OpenCV
    with pytest.raises(image_io.NeedsOpenCV, match='a.hdr'):
        evaluate_lighting(argv, str(probes), device='cpu')
    bare = evaluate_lighting(argv, str(tmp_path / 'none'), device='cpu')
    assert bare['probes'] is None
    assert bare['mean'] == pytest.approx(learned.mean(), rel=1e-5)
    assert bare['max'] == pytest.approx(learned.max(), rel=1e-5)
