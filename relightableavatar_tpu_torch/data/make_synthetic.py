"""Generate the synthetic tube-man capture for the port: cameras, motion,
body model, and GT images rendered with the distilled fixture avatar.

    python -m relightableavatar_tpu_torch.data.make_synthetic [--root data/synthetic/tubeman]
        [--frames 30] [--views 4] [--size 512] [--fixture-params fixtures/synthetic_avatar_params.npz]

The counterpart of ``scripts/make_synthetic_data.py`` on the port's
``SphereTracingRenderer``, with the script's settings (3 band samples, HDQ
band 0.125 m, 8192-ray blocks, ``sdf_res`` 8) in float32 with the exact
KNN (``tpu.bf16_mlp False``, ``tpu.knn_impl pallas``).  Writes under
``--root``: ``body_model.npz`` and ``motion.npz`` (the first ``--frames``
frames) copied from ``fixtures/``, ``annots.npy`` (a ring of ``--views``
cameras), ``images/VV/FFFFFF.png`` (8-bit RGB) and ``mask/VV/FFFFFF.png``
(acc > 0.5).  PNG, not the script's JPEG: the port writes no JPEG without
OpenCV; ``annots.npy`` names the PNG files, which the JAX package's dataset
reads as well.  Runs on the card.
"""
from __future__ import annotations

import argparse
import os
import shutil
from os.path import join

import numpy as np
import torch

from relightableavatar_tpu_torch.config import default_cfg
from relightableavatar_tpu_torch.data.image_io import write_png
from relightableavatar_tpu_torch.data.rays import get_full_near_far, get_rays
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
from relightableavatar_tpu_torch.smpl.body_model import BodyModel
from relightableavatar_tpu_torch.smpl.synthetic import make_cameras
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.weights import load_params

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE_BODY = join(REPO, 'fixtures', 'synthetic_body.npz')
FIXTURE_MOTION = join(REPO, 'fixtures', 'synthetic_motion.npz')
FIXTURE_PARAMS = join(REPO, 'fixtures', 'synthetic_avatar_params.npz')


def generator_cfg(n_bones: int):
    """The render settings of ``scripts/make_synthetic_data.py:76-86``, in
    float32 with the exact KNN."""
    cfg = default_cfg()
    cfg.n_bones = n_bones
    cfg.cond_dim = n_bones * 3
    cfg.relighting = True
    cfg.n_samples = 3
    cfg.dist_th = 0.125
    cfg.obj_lvis.dist_th = 0.125
    cfg.tpu.ray_block = 8192
    cfg.tpu.bf16_mlp = False
    cfg.tpu.knn_impl = 'pallas'
    return cfg


def render_images(renderer, model: BodyModel, motion: dict, cams: dict, frames: int,
                  views: int, H: int, W: int, device="cuda"):
    """The script's render loop (``make_synthetic_data.py:103-117``): for
    each frame and view, (frame, view, rgb (H, W, 3) float32, acc (H, W)
    float32) of every pixel, zero outside the body's bounds."""
    shapes = motion['shapes'][0]
    tverts, tjoints, big_A, _ = make_bigpose(model, shapes)
    for f in range(frames):
        ctx = make_frame_context(model, tverts, tjoints, big_A, motion['poses'][f],
                                 motion['Rh'][f], motion['Th'][f], shapes, device=device)
        wb = ctx['wbounds'].cpu().numpy()
        for v in range(views):
            ray_o, ray_d = get_rays(H, W, cams['K'][v], cams['R'][v], cams['T'][v] / 1000.0)
            near, far, sel = get_full_near_far(wb, ray_o.reshape(-1, 3), ray_d.reshape(-1, 3))
            batch = dotdict(ray_o=ray_o.reshape(-1, 3)[sel], ray_d=ray_d.reshape(-1, 3)[sel],
                            near=near[sel], far=far[sel], ctx=ctx)
            out = renderer.render(batch)
            img = np.zeros((H * W, 3), np.float32)
            img[sel] = out.rgb_map.cpu().numpy()
            acc = np.zeros(H * W, np.float32)
            acc[sel] = out.acc_map.cpu().numpy()
            yield f, v, img.reshape(H, W, 3), acc.reshape(H, W)


def make_dataset_tree(root: str, frames: int = 30, views: int = 4, size: int = 512,
                      fixture_params: str = FIXTURE_PARAMS, device="cuda", cfg=None) -> None:
    """Write the dataset tree under ``root`` (see the module docstring),
    rendered with ``cfg`` (default :func:`generator_cfg`)."""
    H = W = size
    os.makedirs(root, exist_ok=True)
    model = BodyModel(FIXTURE_BODY)
    shutil.copy(FIXTURE_BODY, join(root, 'body_model.npz'))
    motion = dict(np.load(FIXTURE_MOTION))
    if len(motion['poses']) < frames:
        raise ValueError(f"{FIXTURE_MOTION} has {len(motion['poses'])} frames, "
                         f"{frames} were asked for")
    motion = {k: v[:frames] for k, v in motion.items()}
    np.savez(join(root, 'motion.npz'), **motion)
    cams = make_cameras(views, H=H, W=W)
    annots = dict(cams=cams, ims=[
        dict(ims=[f'images/{v:02d}/{f:06d}.png' for v in range(views)])
        for f in range(frames)])
    np.save(join(root, 'annots.npy'), annots, allow_pickle=True)

    cfg = cfg if cfg is not None else generator_cfg(model.n_bones)
    mcfg = AniSDFConfig.from_cfg(cfg)._replace(sdf_res=8)
    params = load_params(fixture_params, device=device, mcfg=mcfg)
    renderer = SphereTracingRenderer(cfg, params, mcfg, device=device)
    for f, v, img, acc in render_images(renderer, model, motion, cams, frames, views,
                                        H, W, device=device):
        for sub, arr in (('images', (np.clip(img, 0, 1) * 255).astype(np.uint8)),
                         ('mask', (acc > 0.5).astype(np.uint8) * 255)):
            os.makedirs(join(root, sub, f'{v:02d}'), exist_ok=True)
            write_png(join(root, sub, f'{v:02d}', f'{f:06d}.png'), arr)
        if v == views - 1:
            print(f'frame {f + 1}/{frames} done', flush=True)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default='data/synthetic/tubeman')
    ap.add_argument('--frames', type=int, default=30)
    ap.add_argument('--views', type=int, default=4)
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--fixture-params', default=FIXTURE_PARAMS)
    args = ap.parse_args(argv)
    with torch.no_grad():
        make_dataset_tree(args.root, args.frames, args.views, args.size,
                          args.fixture_params, device=device)


if __name__ == '__main__':
    main()
