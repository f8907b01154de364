"""Light probes for the novel-light sweep: the lighting part of
``relightableavatar_tpu/data/datasets.py:32-103`` (reference
``base_dataset.py:130-185``), copied for the port.

Probes are float32 numpy arrays (eH, eW, 3), as the JAX package's loader
returns them; the renderers take them to the device.  Real HDRI probes are
read from ``cfg.lighting_dir/16x32/*.hdr`` when that folder exists (OpenCV
is imported only then); otherwise each named HDRI gets the procedural
:func:`synth_probe`.
"""
from __future__ import annotations

import os
from os.path import basename, exists, join, splitext
import warnings

import numpy as np

from relightableavatar_tpu_torch.utils.dotdict import dotdict


def area_hot_img(h, w, c, i, j):
    one_hot = np.zeros((h, w, c), dtype=np.float32)
    one_hot[i, j, :] = 1
    return one_hot


def read_hdr(path):
    import cv2
    with open(path, 'rb') as h:
        buffer_ = np.frombuffer(h.read(), np.uint8)
    bgr = cv2.imdecode(buffer_, cv2.IMREAD_UNCHANGED)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    return rgb.astype(np.float32)


def synth_probe(name: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Procedural HDRI probe (sky gradient + sun) used when no lighting
    folder exists.  Seeded by ``hash(name)`` as the reference is: Python
    randomises ``str`` hashes per process, so two processes agree only under
    the same ``PYTHONHASHSEED``."""
    rng = np.random.default_rng(abs(hash(name)) % (2 ** 31))
    lat = np.linspace(1, -1, h)[:, None]
    sky = np.stack([0.35 + 0.3 * lat, 0.45 + 0.35 * lat, 0.7 + 0.3 * lat], -1)
    sky = np.clip(np.broadcast_to(sky, (h, w, 3)), 0.02, None).copy()
    si, sj = int(rng.integers(1, h // 2)), int(rng.integers(0, w))
    sky[si, sj] += rng.uniform(20, 60)
    sky[max(si - 1, 0):si + 2, max(sj - 1, 0):sj + 2] += 5.0
    ground = 0.15 + 0.1 * rng.random(3)
    sky[h // 2:] = ground
    return sky.astype(np.float32)


def load_lighting(cfg) -> dotdict:
    """OLAT + HDRI probes by name: each a dotdict of ``probe`` and ``image``
    (the ground pass's attached image; the probe itself unless an 8k
    image is on disk)."""
    H, W = cfg.env_h, cfg.env_w
    novel = dotdict()

    # (1) OLAT probes
    for idx in cfg.olats:
        i, j = idx // W, idx % W
        name = f'olat{i:04d}-{j:04d}'
        if cfg.test_light and name not in cfg.test_light and name != cfg.replace_light:
            continue
        probe = cfg.olat_inten * area_hot_img(H, W, 3, i, j) + cfg.ambient_inten
        novel[name] = dotdict(probe=probe, image=probe)

    # (2) HDRI light probes from disk, or procedural fallbacks
    probe_dir = join(cfg.lighting_dir, '16x32')
    names = []
    if exists(probe_dir):
        names = [splitext(basename(p))[0] for p in sorted(os.listdir(probe_dir))]
    for name in (names or [n for n in cfg.test_light if not n.startswith('olat')]):
        if cfg.test_light and name not in cfg.test_light and name != cfg.replace_light:
            continue
        if exists(join(probe_dir, name + '.hdr')):
            probe = read_hdr(join(probe_dir, name + '.hdr'))
            image = probe
            img_path = join(cfg.lighting_dir, '8k', name + '.hdr')
            if cfg.vis_ground_shading and cfg.ground_attach_envmap and exists(img_path):
                image = read_hdr(img_path)
        else:
            probe = synth_probe(name, H, W)
            image = probe
        novel[name] = dotdict(probe=probe, image=image)

    missing = [n for n in cfg.test_light if n not in novel]
    if missing:
        warnings.warn(f'test_light entries not available and skipped: {missing} '
                      '(OLAT names must match cfg.olats indices)', stacklevel=2)

    for v in novel.values():
        v.probe = v.probe * cfg.light_multiplier
        v.image = v.image * cfg.light_multiplier
    return novel
