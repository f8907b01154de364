"""The two-stage pipeline trained from images, end to end, on the port
(counterpart of ``scripts/train_e2e.py``):

    python -m relightableavatar_tpu_torch.train.e2e [--root DIR] [--epochs1 60] [--epochs2 40]
        [--n-samples 64] [--ratio 1.0] [--gate-psnr 28] [--exp tubeman_e2e] [--resume] ...

  data     the synthetic tube-man tree of the JAX README (24 frames x 4 views
           at 512²), only when it has no images
           (``python -m relightableavatar_tpu_torch.data.make_synthetic``)
  train1   stage 1 from the multi-view images (``python -m relightableavatar_tpu_torch.train``)
  eval1    volume-rendered PSNR / SSIM on the test split (``run -t evaluate``)
  mesh     the canonical mesh (``run -t visualize vis_can_mesh True mesh_simp_face 16384``)
  train2   stage 2 with that mesh as the geometry prior (``relighting True
           use_geometry True geometry_mesh ... geometry_pretrain ...``)
  eval2    the relight evaluation at the exact stack, with the PSNR gate

Each stage is a subprocess of the port's own CLI, whose working directory is
``--root``: every ``data/...`` path of the config (the tree, trained models,
records, results and the mesh visualizer's ``data/animation``) lies under it,
and ``configs`` there is a link to the repo's when it is absent.  The stages
take the JAX script's overrides letter for letter, and the evaluations add
``EVAL_OPTS`` (PNG frames, no video: JPEG and mp4 need OpenCV, which the card's
machine lacks).  The summary ``<root>/data/record/<exp>/e2e_summary.json`` has
the JAX script's keys (stage seconds, each evaluation's metrics with its
provenance, the gate) and the port's ``train_psnr`` (the mean of each
stage's logged train PSNR over the 100 steps up to each of ``CURVE_STEPS``) and
``lighting`` (the learned environment map's statistics,
``eval/evaluate_lighting.py``).  A failed gate raises ``SystemExit`` after the
summary is written.  ``--evidence DIR`` copies the summary, both stages'
scalars and two evaluation frames of each stage there.

Not ported: the JAX script's snapshot daemon (it git-committed checkpoints
into ``results/`` from inside training, against TPU machines lost
mid-run), ``--resume-from-live`` (which read that mirror) and the training
group's registration (a logged no-op in the port, ``utils/preempt.py``).

:func:`plan` gives the stages as data; :func:`run_pipeline` runs them as
subprocesses on the card, or in this process on ``device`` (the CPU tests).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from os.path import exists, join

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG = 'configs/synthetic/tubeman.yaml'
DATA_ROOT = 'data/synthetic/tubeman'        # tubeman.yaml's train and test data_root
# the tree the JAX README's command generates: frames, views, image size
DATA_FRAMES, DATA_VIEWS, DATA_SIZE = 24, 4, 512
EVAL_OPTS = ['vis_ext', '.png', 'store_video_output', 'False']
CURVE_STEPS = (100, 1000, 2000, 4000, 6000)
CURVE_WINDOW = 100
TRAIN_MOD = 'relightableavatar_tpu_torch.train'
RUN_MOD = 'relightableavatar_tpu_torch.run'
DATA_MOD = 'relightableavatar_tpu_torch.data.make_synthetic'


@dataclass(frozen=True)
class Stage:
    name: str           # the log's name: data, train1, eval1, mesh, train2, eval2
    module: str         # the port's entry point, run as ``python -m module``
    argv: tuple         # its arguments


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default='.',
                    help='work directory: every data/... path of the run lies under it')
    ap.add_argument('--exp', default='tubeman_e2e')
    ap.add_argument('--epochs1', type=int, default=60)
    ap.add_argument('--epochs2', type=int, default=40)
    ap.add_argument('--n-samples', type=int, default=64,
                    help='z-samples per ray for stage-1 training (128 is the reference '
                         'protocol)')
    ap.add_argument('--gate-psnr', type=float, default=28.0,
                    help='stage-2 eval PSNR the run must reach to pass')
    ap.add_argument('--ratio', default='1.0',
                    help='training supervision resolution ratio (512px base)')
    ap.add_argument('--skip-stage1', action='store_true')
    ap.add_argument('--fresh-stage2', action='store_true',
                    help='cold-start stage 2 from geometry_pretrain even under --resume')
    ap.add_argument('--skip-stage2', action='store_true')
    ap.add_argument('--skip-eval1', action='store_true',
                    help="reuse the stage-1 metrics.npy on disk")
    ap.add_argument('--skip-mesh', action='store_true',
                    help='reuse the can_mesh.npz on disk')
    ap.add_argument('--resume', action='store_true',
                    help='continue training from the checkpoints under the work directory')
    ap.add_argument('--extra', nargs='*', default=[],
                    help='key value overrides for both training stages only')
    ap.add_argument('--evidence', default=None,
                    help='copy the summary, scalars and two eval frames a stage here')
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    a = make_parser().parse_args(argv)
    if len(a.extra) % 2:
        raise SystemExit('--extra takes key value pairs')
    return a


def exp_names(a) -> tuple[str, str]:
    return a.exp, a.exp + '_relight'


def mesh_path(a) -> str:
    return f'data/animation/deform/{a.exp}/can_mesh.npz'


def has_images(root: str) -> bool:
    img_dir = join(root, DATA_ROOT, 'images')
    return exists(img_dir) and any(files for _, _, files in os.walk(img_dir))


def plan(a, root: str | None = None) -> list[Stage]:
    """The stages that the flags ``a`` ask for, in order, with the JAX
    script's overrides (``scripts/train_e2e.py:153-208``); ``data`` first
    when ``root`` is given and its tree has no images."""
    exp1, exp2 = exp_names(a)
    resume = 'True' if a.resume else 'False'
    extra = list(a.extra)
    stages = []
    if root is not None and not has_images(root):
        stages.append(Stage('data', DATA_MOD, (
            '--root', DATA_ROOT, '--frames', str(DATA_FRAMES), '--views', str(DATA_VIEWS),
            '--size', str(DATA_SIZE))))
    if not a.skip_stage1:
        stages.append(Stage('train1', TRAIN_MOD, (
            '-c', CFG, 'exp_name', exp1, 'resume', resume,
            'train.epoch', str(a.epochs1), 'train.scheduler.decay_epochs', str(a.epochs1),
            'n_samples', str(a.n_samples), 'ratio', a.ratio,
            'eval_ep', '999', 'save_ep', '20', *extra)))
    if not a.skip_eval1:
        stages.append(Stage('eval1', RUN_MOD, (
            '-t', 'evaluate', '-c', CFG, 'exp_name', exp1, *EVAL_OPTS)))
    if not a.skip_mesh:
        stages.append(Stage('mesh', RUN_MOD, (
            '-t', 'visualize', '-c', CFG, 'exp_name', exp1,
            'vis_can_mesh', 'True', 'mesh_simp_face', '16384')))
    geo = ('use_geometry', 'True', 'geometry_mesh', mesh_path(a),
           'geometry_pretrain', f'data/trained_model/deform/{exp1}')
    if not a.skip_stage2:
        stages.append(Stage('train2', TRAIN_MOD, (
            '-c', CFG, 'relighting', 'True', 'exp_name', exp2,
            'resume', 'False' if a.fresh_stage2 else resume,
            'train.epoch', str(a.epochs2), 'train.scheduler.decay_epochs', str(a.epochs2),
            'ratio', a.ratio, 'eval_ep', '999', 'save_ep', '20', *geo, *extra)))
    stages.append(Stage('eval2', RUN_MOD, (
        '-t', 'evaluate', '-c', CFG, 'relighting', 'True', 'exp_name', exp2, *geo,
        *EVAL_OPTS)))
    return stages


# ------------------------------------------------------------------ running
@contextlib.contextmanager
def working_dir(path: str):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def prepare_root(root: str) -> str:
    """``root`` made absolute, created, with ``configs`` linked to the
    repo's when absent (the configs name their parents relative to the
    working directory)."""
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    link = join(root, 'configs')
    if not exists(link):
        os.symlink(join(REPO, 'configs'), link)
    return root


def run_subprocess(stage: Stage, root: str, log_path: str) -> int:
    """``python -m stage.module *stage.argv`` in ``root`` with the repo on
    PYTHONPATH, its output to ``log_path``; returns the exit code."""
    path = os.pathsep.join(p for p in (REPO, os.environ.get('PYTHONPATH', '')) if p)
    env = {**os.environ, 'PYTHONPATH': path, 'RA_TPU_NO_PDB': '1'}
    with open(log_path, 'w') as f:
        return subprocess.run([sys.executable, '-m', stage.module, *stage.argv], cwd=root,
                              env=env, stdout=f, stderr=subprocess.STDOUT).returncode


def entry_point(module: str):
    """The ``main(argv, device)`` that ``python -m module`` calls."""
    mod = importlib.import_module(module)
    if hasattr(mod, '__path__'):                    # a package runs its __main__
        mod = importlib.import_module(module + '.__main__')
    return mod.main


def run_in_process(stage: Stage, root: str, log_path: str, device) -> int:
    """The stage's entry point called in this process on ``device`` with
    ``root`` as the working directory and its output to ``log_path``;
    returns 0, or 1 after writing the traceback to the log."""
    import traceback
    main = entry_point(stage.module)
    with open(log_path, 'w') as f, working_dir(root), \
            contextlib.redirect_stdout(f), contextlib.redirect_stderr(f):
        try:
            main(list(stage.argv), device=device)
        except Exception:
            traceback.print_exc()
            return 1
    return 0


def run_stage(stage: Stage, root: str, out_dir: str, device=None) -> float:
    """Run ``stage`` (a subprocess when ``device`` is None, else in this
    process on ``device``); returns its seconds, or raises ``SystemExit``
    with the end of its log when it fails (``scripts/train_e2e.py:35-50``)."""
    os.makedirs(out_dir, exist_ok=True)
    log_path = join(out_dir, stage.name + '.log')
    print(f'[e2e] {stage.module} {" ".join(stage.argv)}\n      -> {log_path}', flush=True)
    t0 = time.perf_counter()
    rc = (run_subprocess(stage, root, log_path) if device is None
          else run_in_process(stage, root, log_path, device))
    dt = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as f:
            print(f.read()[-4000:])
        raise SystemExit(f'[e2e] stage {stage.name} FAILED ({dt:.0f}s)')
    print(f'[e2e] {stage.name} done in {dt:.1f} s', flush=True)
    return dt


# ------------------------------------------------------------------ results
def checkpoint_epoch(root: str, rel_model_dir: str):
    """Epoch stored in ``<root>/data/trained_model/<rel_model_dir>/latest.npz``."""
    p = join(root, 'data/trained_model', rel_model_dir, 'latest.npz')
    if not exists(p):
        return None
    with np.load(p, allow_pickle=True) as z:
        return int(z['epoch']) if 'epoch' in z.files else None


def read_metrics(root: str, result_dir: str):
    path = join(root, result_dir, 'metrics.npy')
    if not exists(path):
        return None
    m = np.load(path, allow_pickle=True).item()
    return {k: (float(np.mean(v)) if np.ndim(v) else float(v))
            for k, v in m.items() if k != 'frames'}


def psnr_curve(scalars_path: str, steps=CURVE_STEPS, window: int = CURVE_WINDOW) -> dict:
    """{step: mean of the logged train ``psnr`` of the ``window`` steps up to
    it} for each of ``steps`` that the run reached."""
    if not exists(scalars_path):
        return {}
    rows = {}
    with open(scalars_path) as f:
        for line in f:
            r = json.loads(line)
            if 'psnr' in r:
                rows[int(r['step'])] = float(r['psnr'])      # a resumed run's rows win
    return {str(s): float(np.mean([rows[t] for t in range(s - window + 1, s + 1) if t in rows]))
            for s in steps if s in rows}


def lighting_stats(root: str, stage: Stage) -> dict | None:
    """The stage-2 environment map's statistics (``eval/evaluate_lighting.py``)
    from the checkpoint that ``stage`` (eval2) evaluates, computed on the
    CPU: the map is a few hundred texels."""
    from relightableavatar_tpu_torch.eval.evaluate_lighting import evaluate_lighting
    with working_dir(root):
        return evaluate_lighting(list(stage.argv[2:]), device='cpu')


def seed_stage1(root: str, exp: str) -> str:
    """Write the fixture avatar's geometry (``resd``, ``sdf``, ``beta``,
    ``rgb``) as the stage-1 checkpoint of ``exp`` at epoch 0, so that a short
    run with ``--resume`` trains on from a surface that the mesh stage can
    extract (a few steps from ``init_anisdf`` have none).  Returns its path."""
    from relightableavatar_tpu_torch.data.make_synthetic import FIXTURE_PARAMS
    from relightableavatar_tpu_torch.models.factory import GEOMETRY_KEYS
    model_dir = join(root, 'data/trained_model/deform', exp)
    os.makedirs(model_dir, exist_ok=True)
    with np.load(FIXTURE_PARAMS) as f:
        net = {'net:' + k: f[k] for k in f.files if k.split('/')[0] in GEOMETRY_KEYS}
    path = join(model_dir, 'latest.npz')
    np.savez(path, epoch=np.asarray(0), **net)
    return path


def gate(e2: dict | None, gate_psnr: float) -> dict:
    e2 = e2 or {}
    return {
        'stated_tolerance': f'stage-2 eval PSNR >= {gate_psnr} dB '
                            '(distilled fixture checkpoint: 42.8 dB on the same protocol '
                            'in the JAX package)',
        'psnr': e2.get('psnr'),
        'pass': bool(e2.get('psnr', 0) >= gate_psnr),
    }


def copy_evidence(root: str, a, summary: dict, dst: str) -> None:
    """The summary, both stages' scalars and the first two evaluation frames
    of each stage, copied to ``dst`` (never the tracked ``results/``)."""
    exp1, exp2 = exp_names(a)
    os.makedirs(dst, exist_ok=True)
    with open(join(dst, 'e2e_summary.json'), 'w') as f:
        json.dump(summary, f, indent=2)
    for stage, rel in (('stage1', f'data/record/deform/{exp1}/scalars.jsonl'),
                       ('stage2', f'data/record/relight/{exp2}/scalars.jsonl')):
        if exists(join(root, rel)):
            shutil.copy(join(root, rel), join(dst, f'{stage}_scalars.jsonl'))
    for stage, rdir in (('stage1', f'data/result/deform/{exp1}'),
                        ('stage2', f'data/result/relight/{exp2}')):
        imgs = sorted(join(dp, f) for dp, _, fs in os.walk(join(root, rdir))
                      for f in fs if f.endswith(('.jpg', '.png')))
        for p in imgs[:2]:
            shutil.copy(p, join(dst, f'{stage}_{os.path.basename(p)}'))
    print(f'[e2e] evidence -> {dst}')


def run_pipeline(a, device=None) -> dict:
    """Run the stages of :func:`plan` under ``a.root`` and write the
    summary; returns it, or raises ``SystemExit`` when a stage or the gate
    fails.  ``device`` None runs each stage as a subprocess (on the card);
    a device runs them in this process there."""
    root = prepare_root(a.root)
    exp1, exp2 = exp_names(a)
    out_dir = join(root, 'data/record', exp1)
    summary = {'exp': exp1, 'epochs1': a.epochs1, 'epochs2': a.epochs2,
               'n_samples_stage1': a.n_samples, 'stages': {}}
    stages = plan(a, root)
    if a.skip_mesh and not exists(join(root, mesh_path(a))):
        # before any stage runs (the JAX script asserts it after eval1)
        raise SystemExit(f'[e2e] --skip-mesh: no geometry prior at {join(root, mesh_path(a))}')
    for st in stages:
        summary['stages'][f'{st.name}_s'] = run_stage(st, root, out_dir, device)
        if st.name == 'mesh' and not exists(join(root, mesh_path(a))):
            raise SystemExit(f'[e2e] the mesh stage wrote no {join(root, mesh_path(a))}')
    # metrics of both evaluations, read from disk as the JAX script does
    summary['eval_stage1'] = read_metrics(root, f'data/result/deform/{exp1}')
    if summary['eval_stage1'] is not None:
        summary['eval_stage1']['provenance'] = {
            'checkpoint': f'data/trained_model/deform/{exp1}/latest.npz',
            'checkpoint_epoch': checkpoint_epoch(root, f'deform/{exp1}'),
            'epochs1': a.epochs1, 'n_samples_stage1': a.n_samples}
    summary['eval_stage2'] = read_metrics(root, f'data/result/relight/{exp2}')
    if summary['eval_stage2'] is not None:
        summary['eval_stage2']['provenance'] = {
            'checkpoint': f'data/trained_model/relight/{exp2}/latest.npz',
            'checkpoint_epoch': checkpoint_epoch(root, f'relight/{exp2}'),
            'epochs2': a.epochs2, 'geometry_mesh': mesh_path(a),
            'geometry_pretrain_epoch': checkpoint_epoch(root, f'deform/{exp1}')}
    summary['train_psnr'] = {
        'stage1': psnr_curve(join(root, f'data/record/deform/{exp1}/scalars.jsonl')),
        'stage2': psnr_curve(join(root, f'data/record/relight/{exp2}/scalars.jsonl'))}
    summary['lighting'] = lighting_stats(root, stages[-1])
    summary['gate'] = gate(summary['eval_stage2'], a.gate_psnr)
    path = join(out_dir, 'e2e_summary.json')
    os.makedirs(out_dir, exist_ok=True)
    with open(path, 'w') as f:
        json.dump(summary, f, indent=2)
    print(f'[e2e] summary -> {path}\n{json.dumps(summary, indent=2)}', flush=True)
    if a.evidence:
        copy_evidence(root, a, summary, os.path.abspath(a.evidence))
    if not summary['gate']['pass']:
        raise SystemExit('[e2e] quality gate FAILED')
    return summary


def main(argv=None):
    run_pipeline(parse_args(argv))


if __name__ == '__main__':
    main()
