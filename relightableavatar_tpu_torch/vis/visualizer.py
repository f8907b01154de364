"""Visualizers: every Output map type to image files and videos; a copy of
``relightableavatar_tpu/vis/visualizer.py`` for the port (reference
``lib/visualizers/base_visualizer.py``: map generation :58-226, path
templates :45-52, video :279-312; the pose/demo/light variants).

Maps may be tensors on the device or numpy arrays.  Images go through the
port's :mod:`~relightableavatar_tpu_torch.data.image_io`: PNG and Radiance
HDR are written here; JPEG (``vis_ext .jpg``, the default) and the mp4
videos (``store_video_output``) need OpenCV and raise without it, naming the
file and the setting to change.  ``MeshVisualizer`` writes the mesh
renderer's output as ``.npz`` and ``.ply``.
"""
from __future__ import annotations

import os
from os.path import dirname, join, splitext

import numpy as np

from relightableavatar_tpu_torch.config.defaults import Output
from relightableavatar_tpu_torch.data import image_io
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.log import log
from relightableavatar_tpu_torch.utils.registry import register


def as_numpy(x):
    """A map as numpy: tensors are copied from their device."""
    if hasattr(x, 'detach'):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _normalize(v):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-13)


def _percentile_norm(x, percentile=0.005):
    flat = np.sort(x.ravel())
    n = max(int(percentile * flat.size), 1)
    vmax = flat[-n]
    return x / (vmax + 1e-12)


def linear2srgbas_numpy(linear):
    linear = np.clip(linear, 0.0, 1.0)
    lin = linear * 12.92
    nonlin = 1.055 * np.power(linear + 1e-7, 1 / 2.4) - 0.055
    return np.where(linear <= 0.0031308, lin, nonlin)


def add_light_probeas_numpy(img, probe, cfg):
    """Upper-left equirect light-probe inset (relight_utils.py:38-52),
    rendered by direct downscale of the probe image."""
    H, W = img.shape[:2]
    eH, eW = probe.shape[:2]
    uW = int(W * cfg.probe_size_ratio)
    uH = max(int(uW * eH / eW), 1)
    inset = image_io.resize(np.clip(probe, 0, 1).astype(np.float32), (uW, uH),
                            image_io.INTER_AREA)
    img = img.copy()
    img[:uH, :uW, :3] = inset
    return img


def generate_image(cfg, output: dotdict, batch: dotdict,
                   type: Output = Output.Rendering):
    """One Output map -> (img_pred, img_gt or None, img_loss or None)."""
    H, W = int(batch.H), int(batch.W)
    rgb_gt = None

    if type == Output.Normal:
        norm = _normalize(as_numpy(output.norm_map))
        norm = norm @ as_numpy(batch.cam_R).T
        norm[..., 1] *= -1
        norm[..., 2] *= -1
        norm = norm * 0.5 + 0.5
        rgb_map = norm * as_numpy(output.acc_map)[..., None]
    elif type == Output.Alpha:
        acc = as_numpy(output.acc_map)
        rgb_map = np.repeat(acc[..., None], 3, -1)
        if 'msk' in batch:
            rgb_gt = np.repeat(as_numpy(batch.msk)[..., None], 3, -1).astype(np.float32)
    elif type == Output.Depth:
        depth = as_numpy(output.depth_map)
        acc = as_numpy(output.acc_map) > 0.5
        vals = depth[acc] if acc.any() else depth.ravel()
        vals = np.sort(vals.ravel())
        n = max(int(0.01 * vals.size), 1)
        dmin = min(vals[n - 1], cfg.min_clip)
        dmax = vals[-n]
        depth = np.clip((depth - dmin) / (dmax - dmin + 1e-12), 0, 1)
        rgb_map = np.repeat(depth[..., None], 3, -1)
    elif type == Output.Shading:
        rgb_map = as_numpy(output.shade_map)
        if cfg.normalize_shading:
            rgb_map = _percentile_norm(rgb_map)
    elif type == Output.Specular:
        rgb_map = as_numpy(output.spec_map)
        if cfg.normalize_specular:
            rgb_map = _percentile_norm(rgb_map)
    elif type == Output.Albedo:
        a = as_numpy(output.albedo_map)
        rgb_map = linear2srgbas_numpy(a) if cfg.tonemapping_albedo else a
    elif type == Output.Roughness:
        rgb_map = np.repeat(as_numpy(output.roughness_map)[..., None], 3, -1)
    elif type == Output.Surface:
        p = as_numpy(output.cpts_map) if 'cpts_map' in output else as_numpy(output.surf_map)
        tb = as_numpy(batch.tbounds)
        rgb_map = (p - tb[0:1]) / (tb[1:2] - tb[0:1])
        rgb_map = rgb_map * as_numpy(output.acc_map)[..., None]
    elif type == Output.Residual:
        d = as_numpy(output.resd_map) if 'resd_map' in output else (
            as_numpy(output.cpts_map) - as_numpy(output.bpts_map))
        rgb_map = _percentile_norm(d) * as_numpy(output.acc_map)[..., None]
    elif type == Output.Rendering:
        rgb_map = as_numpy(output.rgb_map)
        if 'rgb' in batch:
            rgb_gt = as_numpy(batch.rgb)
    elif type == Output.Envmap:
        probe = as_numpy(output.envmap.probe)
        rgb_map = probe[0] if probe.ndim == 4 else probe
    else:
        raise NotImplementedError(f'output type: {type}')

    # scatter (P, C) rays into the H x W canvas via mask_at_box
    if rgb_map.ndim == 2:
        mab = as_numpy(batch.mask_at_box).reshape(H, W)
        img_pred = np.full((H, W, rgb_map.shape[-1]), cfg.bg_brightness, np.float32)
        img_pred[mab] = rgb_map
    else:
        img_pred = rgb_map

    if (cfg.probe_size_ratio > 0 and 'envmap' in output
            and output.envmap is not None and type != Output.Envmap):
        probe = as_numpy(output.envmap.probe)
        probe = probe[0] if probe.ndim == 4 else probe
        img_pred = add_light_probeas_numpy(img_pred, probe, cfg)

    if cfg.store_alpha_channel and type != Output.Envmap and rgb_map.ndim == 2:
        mab = as_numpy(batch.mask_at_box).reshape(H, W)
        alpha = np.zeros((H, W, 1), np.float32)
        alpha[mab] = as_numpy(output.acc_map)[..., None]
        img_pred = np.concatenate([img_pred, alpha], axis=-1)

    img_gt = None
    img_loss = None
    if rgb_gt is not None and cfg.store_ground_truth:
        if rgb_gt.ndim == 2:
            mab = as_numpy(batch.mask_at_box).reshape(H, W)
            img_gt = np.full((H, W, rgb_gt.shape[-1]), cfg.bg_brightness, np.float32)
            img_gt[mab] = rgb_gt
        else:
            img_gt = rgb_gt
        if cfg.store_image_error:
            a = img_pred[..., :3]
            b = img_gt[..., :3]
            img_loss = np.clip(((a - b) ** 2).sum(-1), 0, 1)[..., None].repeat(3, -1)
    return img_pred, img_gt, img_loss


def save_image(path: str, img: np.ndarray) -> None:
    """A float image in [0, 1] (RGB or RGBA) as 8-bit by the extension, or
    float RGB as Radiance ``.hdr`` for ``.hdr`` and ``.exr`` paths."""
    os.makedirs(dirname(path), exist_ok=True)
    img = np.asarray(img)
    if path.endswith('.hdr') or path.endswith('.exr'):
        image_io.write_hdr(splitext(path)[0] + '.hdr', img[..., :3])
        return
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if path.endswith('.jpg') and u8.shape[-1] == 4:
        path = splitext(path)[0] + '.png'
    image_io.write_image(path, u8)


def generate_video(img_dir: str, out_path: str, fps: int = 30) -> bool:
    """mp4 of the frames in img_dir, through OpenCV's VideoWriter."""
    frames = sorted(f for f in os.listdir(img_dir)
                    if f.endswith(('.jpg', '.png')) and '_gt' not in f and '_loss' not in f)
    if not frames:
        return False
    cv2 = image_io.import_cv2(out_path, "writing an mp4 video",
                              "set store_video_output False")
    first = cv2.imread(join(img_dir, frames[0]))
    H, W = first.shape[:2]
    os.makedirs(dirname(out_path) or '.', exist_ok=True)
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*'mp4v'), fps, (W, H))
    try:
        for f in frames:
            img = cv2.imread(join(img_dir, f))
            if img.shape[:2] != (H, W):
                img = cv2.resize(img, (W, H))
            vw.write(img)
    finally:
        vw.release()
    return True


@register('visualizer', 'lib.visualizers.base_visualizer', 'base_visualizer')
class Visualizer:
    """Writes every enabled Output type per frame/view + a summary video."""

    img_path_tmpl = '{result_dir}/{type}/frame{frame:04d}_view{view:04d}{ext}'

    def __init__(self, cfg):
        self.cfg = cfg
        self.types = [k for k in Output if cfg[f'vis_{k.name.lower()}_map']]
        self.types = self.types or [Output.Rendering]
        self.result_dir = cfg.result_dir
        log(f'output: {self.result_dir}', 'blue')
        log(f'types: {[t.name.lower() for t in self.types]}', 'blue')

    def image_path(self, type_name, frame, view, suffix=''):
        base = self.img_path_tmpl.format(result_dir=self.result_dir,
                                         type=type_name, frame=frame,
                                         view=view, ext=self.cfg.vis_ext)
        if suffix:
            base = splitext(base)[0] + suffix + splitext(base)[1]
        return base

    def visualize(self, output: dotdict, batch: dotdict) -> None:
        frame = int(batch.meta.get('frame_index', 0))
        view = int(batch.meta.get('view_index', 0))
        for t in self.types:
            try:
                pred, gt, loss = generate_image(self.cfg, output, batch, t)
            except (KeyError, AttributeError) as e:
                log(f'skip {t.name}: missing map ({e})', 'yellow')
                continue
            save_image(self.image_path(t.name.lower(), frame, view), pred)
            if gt is not None:
                save_image(self.image_path(t.name.lower(), frame, view, '_gt'), gt)
            if loss is not None:
                save_image(self.image_path(t.name.lower(), frame, view, '_loss'), loss)

    def summarize(self):
        if not self.cfg.store_video_output:
            return
        for t in self.types:
            d = join(self.result_dir, t.name.lower())
            if os.path.isdir(d):
                ok = generate_video(d, join(self.result_dir, f'{t.name.lower()}.mp4'),
                                    self.cfg.fps)
                if ok:
                    log(f'video: {join(self.result_dir, t.name.lower())}.mp4', 'green')


@register('visualizer', 'lib.visualizers.pose_visualizer', 'pose_visualizer')
class PoseVisualizer(Visualizer):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.result_dir = join('data/pose_sequence', cfg.task, cfg.exp_name)


@register('visualizer', 'lib.visualizers.demo_visualizer', 'demo_visualizer')
class DemoVisualizer(Visualizer):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.result_dir = join('data/novel_view', cfg.task, cfg.exp_name)


@register('visualizer', 'lib.visualizers.light_visualizer', 'light_visualizer')
class LightVisualizer(Visualizer):
    """Per-light output tree data/novel_light/<exp>/<light>/<type>/...
    (reference light_visualizer.py)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.result_dir = join('data/novel_light', cfg.task, cfg.exp_name)

    def visualize(self, output: dotdict, batch: dotdict) -> None:
        frame = int(batch.meta.get('frame_index', 0))
        view = int(batch.meta.get('view_index', 0))
        novel = output.get('novel_light', {})
        jobs = []
        for light_name, maps in novel.items():
            for t in self.types:
                try:
                    pred, _, _ = generate_image(self.cfg, dotdict(maps), batch, t)
                except (KeyError, AttributeError):
                    continue
                path = join(self.result_dir, light_name, t.name.lower(),
                            f'frame{frame:04d}_view{view:04d}{self.cfg.vis_ext}')
                jobs.append((path, pred))
        # thread-pool saving (reference light_visualizer.py:39-51): a sweep
        # writes lights x types images per frame
        from multiprocessing.pool import ThreadPool
        with ThreadPool(min(8, max(len(jobs), 1))) as pool:
            pool.starmap(save_image, jobs)

    def summarize(self):
        if not os.path.isdir(self.result_dir) or not self.cfg.store_video_output:
            return
        for light_name in sorted(os.listdir(self.result_dir)):
            ldir = join(self.result_dir, light_name)
            if not os.path.isdir(ldir):
                continue
            for t in sorted(os.listdir(ldir)):
                d = join(ldir, t)
                if os.path.isdir(d):
                    generate_video(d, join(ldir, f'{t}.mp4'), self.cfg.fps)


@register('visualizer', 'lib.visualizers.mesh_visualizer', 'mesh_visualizer')
class MeshVisualizer(Visualizer):
    """Exports can_mesh.npz (the canonical item) or frameNNNN.npz, and a
    binary .ply beside it, under ``data/animation/<task>/<exp_name>/`` of the
    working directory (reference mesh_visualizer.py)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.result_dir = join('data/animation', cfg.task, cfg.exp_name)

    def visualize(self, output: dotdict, batch: dotdict) -> None:
        frame = int(batch.meta.get('frame_index', 0))
        os.makedirs(self.result_dir, exist_ok=True)
        name = 'can_mesh' if frame < 0 else f'frame{frame:04d}'
        extras = {k: as_numpy(output[k])
                  for k in ('weights', 'albedo', 'roughness', 'tjoints', 'parents')
                  if output.get(k) is not None}
        np.savez(join(self.result_dir, name + '.npz'),
                 verts=as_numpy(output.verts), faces=as_numpy(output.faces), **extras)
        write_ply(join(self.result_dir, name + '.ply'),
                  as_numpy(output.verts), as_numpy(output.faces))
        log(f'mesh: {join(self.result_dir, name)}.npz/.ply', 'green')

    def summarize(self):
        pass


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY: float32 x, y, z; uchar-counted int32 faces."""
    with open(path, 'wb') as f:
        header = (b'ply\nformat binary_little_endian 1.0\n'
                  + f'element vertex {len(verts)}\n'.encode()
                  + b'property float x\nproperty float y\nproperty float z\n'
                  + f'element face {len(faces)}\n'.encode()
                  + b'property list uchar int vertex_indices\nend_header\n')
        f.write(header)
        f.write(verts.astype('<f4').tobytes())
        fa = np.empty((len(faces), 13), np.uint8)
        fa[:, 0] = 3
        fa[:, 1:] = faces.astype('<i4').view(np.uint8).reshape(len(faces), 12)
        f.write(fa.tobytes())
