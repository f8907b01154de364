"""Compare a learned environment map with ground-truth probes (counterpart
of ``scripts/tools/evaluate_lighting.py``):

    python -m relightableavatar_tpu_torch.eval.evaluate_lighting \\
        -c configs/synthetic/tubeman.yaml relighting True [--gt-dir data/lighting/16x32] [k v ...]

The relight checkpoint's map (``anisdf.global_env_map``), resized to
``env_h`` x ``env_w`` with INTER_AREA (``data/image_io.resize``), is held to
each ``.hdr`` probe of ``--gt-dir`` (default ``<lighting_dir>/<env_h>x<env_w>``)
after aligning the global scale (relighting cannot tell light from albedo
apart by a scale): per-probe scale, MSE and PSNR normalised by the probe's
maximum.  Without a probe folder it prints the learned map's mean and max.
Reading an ``.hdr`` probe needs OpenCV (``data/datasets.py:read_hdr``), and
raises ``NeedsOpenCV`` without it.  Runs on the card unless ``device`` says
otherwise.
"""
from __future__ import annotations

import os
import sys
from os.path import isdir, join

import numpy as np


def learned_env(params: dict, mcfg, env_h: int, env_w: int) -> np.ndarray:
    """(env_h, env_w, 3) float32: ``global_env_map`` resized with INTER_AREA."""
    from relightableavatar_tpu_torch.data.image_io import INTER_AREA, resize
    from relightableavatar_tpu_torch.models import anisdf
    env = anisdf.global_env_map(params, mcfg).detach().float().cpu().numpy()
    return resize(env, (env_w, env_h), interpolation=INTER_AREA)


def compare_probe(learned: np.ndarray, gt: np.ndarray) -> dict:
    """Scale-aligned comparison of the learned map with one probe of the
    same shape (``scripts/tools/evaluate_lighting.py:58-63``)."""
    s = float((learned * gt).sum() / np.clip((learned ** 2).sum(), 1e-8, None))
    mse = float(((s * learned - gt) ** 2).mean())
    psnr = float(-10 * np.log10(mse / max(float(gt.max()), 1e-8) ** 2 + 1e-12))
    return dict(scale=s, mse=mse, psnr=psnr)


def compare_probes(learned: np.ndarray, gt_dir: str) -> dict:
    """{probe file: :func:`compare_probe`} for every ``.hdr`` in ``gt_dir``,
    each resized to the learned map's size with INTER_AREA."""
    from relightableavatar_tpu_torch.data.datasets import read_hdr
    from relightableavatar_tpu_torch.data.image_io import INTER_AREA, resize
    env_h, env_w = learned.shape[:2]
    out = {}
    for f in sorted(os.listdir(gt_dir)):
        if f.endswith('.hdr'):
            gt = resize(read_hdr(join(gt_dir, f)), (env_w, env_h), interpolation=INTER_AREA)
            out[f] = compare_probe(learned, gt)
    return out


def evaluate_lighting(argv, gt_dir: str | None = None, device="cuda") -> dict | None:
    """The report for the config of ``argv`` (``-c cfg.yaml k v ...``):
    ``{'gt_dir', 'mean', 'max', 'probes': {file: {scale, mse, psnr}}}``
    (``probes`` None without a probe folder), printed as the JAX tool
    prints it; None when the network has no learned map."""
    from relightableavatar_tpu_torch.config import setup
    from relightableavatar_tpu_torch.models.factory import make_network
    cfg, _ = setup(list(argv))
    gt_dir = gt_dir or join(cfg.lighting_dir, f'{cfg.env_h}x{cfg.env_w}')
    params, mcfg = make_network(cfg, device=device)
    if 'env' not in params:
        print('no learned env map in this checkpoint (not a relight model)')
        return None
    learned = learned_env(params, mcfg, cfg.env_h, cfg.env_w)
    report = dict(gt_dir=gt_dir, mean=float(learned.mean()), max=float(learned.max()),
                  probes=None)
    if not isdir(gt_dir):
        print(f'no GT probes at {gt_dir}; learned env stats: '
              f'mean {report["mean"]:.4f} max {report["max"]:.4f}')
        return report
    report['probes'] = compare_probes(learned, gt_dir)
    for f, r in report['probes'].items():
        print(f"{f}: scale {r['scale']:.3f} mse {r['mse']:.5f} psnr(norm) {r['psnr']:.2f}")
    return report


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    gt_dir = None
    if '--gt-dir' in argv:
        i = argv.index('--gt-dir')
        gt_dir = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    evaluate_lighting(argv, gt_dir)


if __name__ == '__main__':
    main()
