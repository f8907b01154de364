"""Evaluator: PSNR/SSIM/LPIPS image metrics; a copy of
``relightableavatar_tpu/eval/evaluator.py:1-127`` for the port (reference
``lib/evaluators/base_evaluator.py:71-129``): whole-image or bbox-cropped
metrics per frame, a metrics.npy dump, the mean summary.  It is a
Visualizer (as the reference's is, ``:12``), so evaluation also writes
images.  ``MeshEvaluator`` scores a mesh's vertices against ``gt_verts``.
"""
from __future__ import annotations

import os
from os.path import join

import numpy as np

from relightableavatar_tpu_torch.eval import metrics
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.log import log
from relightableavatar_tpu_torch.utils.registry import register
from relightableavatar_tpu_torch.vis.visualizer import Visualizer, as_numpy


def fill_image(img: np.ndarray, batch: dotdict, bg: float = 0.0) -> np.ndarray:
    """Paste a bbox-cropped render back into the original frame
    (reference base_visualizer.py:232-238)."""
    bbox = np.asarray(batch.crop_bbox).reshape(2, 2).astype(np.int64)
    orig_H = int(batch.get('orig_H', batch.H))
    orig_W = int(batch.get('orig_W', batch.W))
    full = np.full((orig_H, orig_W, 3), bg, img.dtype)
    h = bbox[1, 1] - bbox[0, 1]
    w = bbox[1, 0] - bbox[0, 0]
    full[bbox[0, 1]:bbox[1, 1], bbox[0, 0]:bbox[1, 0]] = img[:h, :w]
    return full


@register('evaluator', 'lib.evaluators.base_evaluator', 'base_evaluator')
class Evaluator(Visualizer):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.psnrs = []
        self.ssims = []
        self.lpips_vals = []
        self.frames = []
        self.skipped_black_gt = 0

    def evaluate(self, output: dotdict, batch: dotdict) -> None:
        cfg = self.cfg
        if 'rgb' not in batch or 'rgb_map' not in output:
            return
        H, W = int(batch.H), int(batch.W)
        mab = np.asarray(batch.mask_at_box).reshape(H, W)
        img_pred = np.zeros((H, W, 3), np.float32)
        img_pred[mab] = as_numpy(output.rgb_map)[..., :3]
        img_gt = np.zeros((H, W, 3), np.float32)
        img_gt[mab] = np.asarray(batch.rgb)[..., :3]

        if float(img_gt.max()) <= 0.0:
            # the dataset substitutes a zero image when no GT is on disk:
            # scoring against it inverts the metric (an all-miss render
            # would score PSNR 120 / SSIM 1), so the frame is not scored
            self.skipped_black_gt += 1
            if self.skipped_black_gt == 1:
                log('evaluator', 'GT image is all-black (missing on disk?): '
                    'skipping metrics for this frame; generate the images with '
                    'python -m relightableavatar_tpu_torch.data.make_synthetic',
                    color='red')
            self.visualize(output, batch)
            return

        if 'crop_bbox' in batch:
            # datasets that pre-crop to a bbox: paste back into the original
            # frame before the metrics (reference base_evaluator.py:41-47)
            img_pred = fill_image(img_pred, batch, cfg.bg_brightness)
            img_gt = fill_image(img_gt, batch, cfg.bg_brightness)
        elif not cfg.eval_whole_img:
            ys, xs = np.nonzero(mab)
            y0, y1 = ys.min(), ys.max() + 1
            x0, x1 = xs.min(), xs.max() + 1
            img_pred = img_pred[y0:y1, x0:x1]
            img_gt = img_gt[y0:y1, x0:x1]

        self.psnrs.append(metrics.psnr(img_pred, img_gt))
        self.ssims.append(metrics.ssim(img_pred, img_gt))
        self.lpips_vals.append(metrics.lpips(img_pred, img_gt))
        self.frames.append(int(batch.meta.get('frame_index', len(self.frames))))

        # evaluation also saves images (reference base_evaluator.py:106)
        self.visualize(output, batch)

    def summarize(self) -> dotdict:
        ret = dotdict()
        if self.psnrs:
            ret.psnr = float(np.mean(self.psnrs))
            ret.ssim = float(np.mean(self.ssims))
            key = 'lpips' if metrics.lpips_is_exact() else 'lpips_rand'
            ret[key] = float(np.mean(self.lpips_vals))
            if self.skipped_black_gt:
                ret.skipped_black_gt = self.skipped_black_gt
                log(f'eval: {self.skipped_black_gt} frame(s) had all-black GT '
                    f'and were EXCLUDED: metrics cover only '
                    f'{len(self.psnrs)} frame(s)', 'red')
            os.makedirs(self.cfg.result_dir, exist_ok=True)
            np.save(join(self.cfg.result_dir, 'metrics.npy'),
                    dict(psnr=self.psnrs, ssim=self.ssims,
                         lpips=self.lpips_vals, frames=self.frames,
                         skipped_black_gt=self.skipped_black_gt))
            log(f'eval: {dict(ret)}', 'green')
        elif self.skipped_black_gt:
            raise RuntimeError(
                f'evaluate produced no metrics: all {self.skipped_black_gt} '
                'frames had all-black GT (images missing from the dataset '
                'root). Generate them with python -m '
                'relightableavatar_tpu_torch.data.make_synthetic.')
        self.psnrs, self.ssims, self.lpips_vals, self.frames = [], [], [], []
        self.skipped_black_gt = 0
        super().summarize()
        return ret


@register('evaluator', 'lib.evaluators.mesh_evaluator', 'mesh_evaluator')
class MeshEvaluator(Visualizer):
    """Chamfer + point-to-surface distances between predicted and GT vertex
    sets (reference mesh_evaluator.py:36-98, sampling-based).  A batch
    without ``gt_verts`` (the mesh dataset's) is not scored."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.chamfer = []
        self.p2s = []

    @staticmethod
    def _nn_dist(a: np.ndarray, b: np.ndarray, block: int = 2048) -> np.ndarray:
        out = np.empty(len(a), np.float32)
        for i in range(0, len(a), block):
            d2 = ((a[i:i + block, None] - b[None]) ** 2).sum(-1)
            out[i:i + block] = np.sqrt(d2.min(1))
        return out

    def evaluate(self, output: dotdict, batch: dotdict) -> None:
        if 'verts' not in output or 'gt_verts' not in batch:
            return
        pred = as_numpy(output.verts).astype(np.float32)
        gt = as_numpy(batch.gt_verts).astype(np.float32)
        rng = np.random.default_rng(0)
        pred_s = pred[rng.integers(len(pred), size=min(10000, len(pred)))]
        gt_s = gt[rng.integers(len(gt), size=min(10000, len(gt)))]
        d_pg = self._nn_dist(pred_s, gt_s)
        d_gp = self._nn_dist(gt_s, pred_s)
        self.p2s.append(float(d_pg.mean()))
        self.chamfer.append(float((d_pg.mean() + d_gp.mean()) / 2))

    def summarize(self) -> dotdict:
        ret = dotdict()
        if self.chamfer:
            ret.chamfer = float(np.mean(self.chamfer))
            ret.p2s = float(np.mean(self.p2s))
            log(f'mesh eval: {dict(ret)}', 'green')
        self.chamfer, self.p2s = [], []
        return ret
