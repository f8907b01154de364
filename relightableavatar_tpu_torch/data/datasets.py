"""Datasets and loaders of the port's host layer: a copy of
``relightableavatar_tpu/data/datasets.py`` (reference ``lib/datasets/``):
the same file formats (``annots.npy`` cameras with mm translations,
``motion.npz``, ``body_model.npz``, the HDRI probes folder), the same
view/frame selection (``base_dataset.py:69-125``), the same batch keys.

Each frame carries its context (``models/context.py``) as tensors on the
device the dataset was made for.  Images and masks are read with the port's
own PNG reader (:mod:`~relightableavatar_tpu_torch.data.image_io`); JPEG,
undistortion and the 8k ground images need OpenCV, imported only then.
Light probes: OLATs, real HDRIs read from ``cfg.lighting_dir/16x32/*.hdr``
when that folder exists, else each named HDRI gets the procedural
:func:`synth_probe`.

The train split samples its rays over cached per-(index, H, W) pools with
a numpy stream keyed by (seed, index, draw), as the JAX package does, so an
item equals the JAX item bit for bit; the training loader cycles a
``TrainSampler`` (strided by node under a multi-GPU launch) with a
threaded prefetch.
"""
from __future__ import annotations

import itertools
import os
import threading
from os.path import basename, exists, join, splitext
import warnings

import numpy as np

from relightableavatar_tpu_torch.data import image_io
from relightableavatar_tpu_torch.data import rays as ray_utils
from relightableavatar_tpu_torch.models.context import (bigpose_A, make_bigpose,
                                                        make_frame_context,
                                                        make_frame_context_mesh)
from relightableavatar_tpu_torch.parallel.mesh import node_rank_world
from relightableavatar_tpu_torch.smpl.body_model import BodyModel, get_bounds
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.log import log
from relightableavatar_tpu_torch.utils.registry import register, resolve


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-13)


# ------------------------------------------------------------------ lighting
def area_hot_img(h, w, c, i, j):
    one_hot = np.zeros((h, w, c), dtype=np.float32)
    one_hot[i, j, :] = 1
    return one_hot


def read_hdr(path):
    try:
        import cv2
    except ImportError:
        raise image_io.NeedsOpenCV(
            f"{path}: reading a Radiance HDR probe needs OpenCV (cv2), which cannot be "
            "imported here; point lighting_dir at a folder without 16x32/ to use the "
            "procedural probes") from None
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


# ------------------------------------------------------------------ camera path
def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def gen_path(RT, center=(), z_off=-1, num_render_view=300,
             interpolate=False, smoothing_term=10.0) -> np.ndarray:
    """Spiral novel-view w2c path (reference render_utils.py:119-171)."""
    lower_row = np.array([[0., 0., 0., 1.]])
    RT = np.array(RT, np.float32).copy()
    RT[:] = np.linalg.inv(RT[:])
    RT = np.concatenate([RT[:, :, 1:2], RT[:, :, 0:1], -RT[:, :, 2:3], RT[:, :, 3:4]], 2)

    up = _normalize(RT[:, :3, 0].sum(0))
    z = _normalize(RT[0, :3, 2])
    vec1 = _normalize(np.cross(z, up))
    vec2 = _normalize(np.cross(up, vec1))

    if z_off < 0:
        z_off = 1.3 if not len(center) else 0.0
    if not len(center):
        center = RT[:, :3, 3].mean(0)
    else:
        center = np.array(center)

    c2w = np.stack([up, vec1, vec2, center], 1)

    tt = (RT[:, :3, 3] - c2w[:, 3]) @ c2w[:3, :3]
    rads = np.percentile(np.abs(tt.T), 80, -1) * 1.3
    rads = np.array(list(rads) + [1.])

    render_w2c = []
    for theta in np.linspace(0., 2 * np.pi, num_render_view + 1)[:-1]:
        cam_pos = np.array([0, np.sin(theta), np.cos(theta), 1] * rads)
        cam_pos_world = np.dot(c2w[:3, :4], cam_pos)
        z = _normalize(cam_pos_world - np.dot(c2w[:3, :4], np.array([z_off, 0, 0, 1.])))
        mat = _viewmatrix(z, up, cam_pos_world)
        mat = np.concatenate([mat[:, 1:2], mat[:, 0:1], -mat[:, 2:3], mat[:, 3:4]], 1)
        mat = np.concatenate([mat, lower_row], 0)
        render_w2c.append(np.linalg.inv(mat))
    return np.array(render_w2c).astype(np.float32)


# ------------------------------------------------------------------ base
@register('dataset', 'lib.datasets.base_dataset', 'base_dataset')
class BaseDataset:
    """Training and eval dataset with GT images (reference
    base_dataset.Dataset).  Frame contexts are built on ``device``.  Images
    and the train split's ray pools are cached on the host up to
    ``tpu.host_cache_gb``; the caches and the contexts are safe under the
    loader's prefetch threads."""

    def __init__(self, cfg, data_root, human, ann_file, split, device="cuda"):
        self.cfg = cfg
        self.data_root = data_root
        self.human = human
        self.split = split
        self.device = device
        self.nrays = cfg.n_rays
        self.forced_hw = None        # per-batch (H, W) of image-size batching

        self.annots = np.load(join(data_root, ann_file), allow_pickle=True).item()
        self.cams = self.annots['cams']

        self.load_view()
        self.load_ims_inds()
        self.load_ims_data()
        self.load_smpl()
        self.load_bigpose()
        self.novel_lights = load_lighting(cfg)
        self.load_image_size()
        self._ctx_cache = {}
        self._ctx_lock = threading.Lock()
        self._draw_counter = itertools.count()
        self._img_cache = {}
        self._ray_cache = {}
        self._cache_lock = threading.Lock()
        self._cache_bytes = 0
        self._cache_budget = int(float(cfg.tpu.get('host_cache_gb', 8.0)) * 2**30)

    def _cache_admit(self, nbytes: int) -> bool:
        """Reserve nbytes of the host-cache budget (the caller holds
        ``_cache_lock``)."""
        if self._cache_bytes + nbytes > self._cache_budget:
            return False
        self._cache_bytes += nbytes
        return True

    # ---------------------------------------------------------- selection
    def load_view(self):
        cfg = self.cfg
        num_cams = len(self.cams['K'])
        training_view = cfg.training_view if len(cfg.training_view) else list(range(num_cams))
        test_view = cfg.test_view if len(cfg.test_view) else list(range(num_cams))
        view = training_view if 'train' in self.split else test_view
        self.view = [v for v in view if v < num_cams] or list(range(num_cams))
        self.num_cams = len(self.view)

    def load_ims_inds(self):
        cfg = self.cfg
        i = cfg.begin_ith_frame
        i_intv = cfg.frame_interval
        ni = cfg.num_train_frame if 'train' in self.split else cfg.num_eval_frame
        if ni < 0:
            ni = cfg.num_train_frame
        if cfg.test_novel_pose:
            i = cfg.begin_ith_frame + cfg.num_train_frame * i_intv
            ni = cfg.num_eval_frame
        self.i, self.ni, self.i_intv = i, ni, i_intv

    def load_ims_data(self):
        i, ni, i_intv = self.i, self.ni, self.i_intv
        frames = self.annots['ims'][i:i + ni * i_intv][::i_intv]
        self.ims = np.array([
            np.array(ims_data['ims'])[self.view]
            for idx, ims_data in enumerate(frames)
            if idx * i_intv + i not in self.cfg.skip]).ravel()
        self.cam_inds = np.array([
            np.arange(len(ims_data['ims']))[self.view]
            for idx, ims_data in enumerate(frames)
            if idx * i_intv + i not in self.cfg.skip]).ravel()

    def load_image_size(self):
        if self.cfg.H > 0 and self.cfg.W > 0:
            self.H, self.W = self.cfg.H, self.cfg.W
            return
        img = self._read_image_raw(0) if len(self.ims) else None
        if img is not None:
            self.H, self.W = img.shape[:2]
        else:
            self.H, self.W = 512, 512

    # ---------------------------------------------------------- smpl
    def load_smpl(self):
        cfg = self.cfg
        self.train_motion = dotdict(np.load(join(self.data_root, cfg.train_motion)))
        self.test_motion = dotdict(np.load(join(self.data_root, cfg.test_motion)))
        self.motion = self.train_motion if self.split == 'train' else self.test_motion
        self.shapes = self.train_motion.shapes[0]
        if cfg.use_geometry and cfg.geometry_mesh:
            # canonical-mesh geometry prior: the extracted can_mesh.npz
            # replaces the SMPL vertex cloud (reference base_dataset.py:196-204)
            self.geometry = dict(np.load(cfg.geometry_mesh))
            self.body_model = None
            missing = [k for k in ('verts', 'faces', 'weights', 'tjoints',
                                   'parents') if k not in self.geometry]
            if missing:
                raise KeyError(
                    f'geometry prior {cfg.geometry_mesh} is missing '
                    f'{missing}: it was extracted by an older mesh '
                    'renderer; re-extract it with tjoints/parents saved beside '
                    'verts/faces/weights.')
            self.parents = self.geometry['parents'].astype(np.int64)
            self.weights = self.geometry['weights'].astype(np.float32)
            self.faces = self.geometry['faces'].astype(np.int64)
            # HDQ derives its sign from this mesh's vertex normals, so the
            # windings must be outward: positive signed volume
            gv = self.geometry['verts'].astype(np.float64)
            gv = gv - gv.mean(0)
            tri = gv[self.faces]
            vol = float(np.einsum('fi,fi->f', tri[:, 0],
                                  np.cross(tri[:, 1], tri[:, 2])).sum() / 6.0)
            if vol <= 0:
                log(f'geometry prior {cfg.geometry_mesh} has non-positive '
                    f'signed volume ({vol:.4g}): face windings look inward '
                    'or inconsistent; HDQ signs will be wrong.', color='red')
        else:
            self.geometry = None
            self.body_model = BodyModel(join(self.data_root, cfg.body_model))
            self.parents = self.body_model.parents
            self.weights = self.body_model.weights
            self.faces = self.body_model.faces

    def load_bigpose(self):
        if self.geometry is not None:
            # mesh verts are already in bigpose canonical space
            self.tverts = self.geometry['verts'].astype(np.float32)
            self.tjoints = self.geometry['tjoints'].astype(np.float32)
            self.big_A, self.big_joints = bigpose_A(self.tjoints, self.parents)
        else:
            tverts, tjoints, big_A, big_joints = make_bigpose(self.body_model, self.shapes)
            self.tverts = tverts
            self.tjoints = tjoints
            self.big_A = big_A
            self.big_joints = big_joints
        self.tbounds = get_bounds(self.tverts)

    def frame_ctx(self, frame_index: int):
        """(context on the device, world bounds in numpy) of one motion
        frame, cached for the frame's other views (64 frames at most)."""
        with self._ctx_lock:
            return self._frame_ctx_locked(frame_index)

    def _frame_ctx_locked(self, frame_index: int):
        if frame_index not in self._ctx_cache:
            m = self.motion
            fi = min(frame_index, len(m.poses) - 1)
            if self.geometry is not None:
                ctx = make_frame_context_mesh(self.geometry, m.poses[fi], m.Rh[fi],
                                              m.Th[fi], device=self.device)
            else:
                ctx = make_frame_context(
                    self.body_model, self.tverts, self.tjoints, self.big_A,
                    m.poses[fi], m.Rh[fi], m.Th[fi], self.shapes, device=self.device)
            self._ctx_cache[frame_index] = (ctx, ctx['wbounds'].cpu().numpy())
            if len(self._ctx_cache) > 64:
                self._ctx_cache.pop(next(iter(self._ctx_cache)))
        return self._ctx_cache[frame_index]

    def get_blend(self, frame_index: int) -> dotdict:
        ctx, wbounds = self.frame_ctx(frame_index)
        ret = dotdict()
        ret.meta = dotdict()
        ret.ctx = ctx
        ret.wbounds = wbounds
        ret.tbounds = self.tbounds
        m = self.motion
        fi = min(frame_index, len(m.poses) - 1)
        ret.poses = m.poses[fi].reshape(-1, 3)
        ret.Rh = m.Rh[fi]
        ret.Th = m.Th[fi]
        ret.novel_lights = self.novel_lights
        ret.train_motion = self.train_motion
        return ret

    # ---------------------------------------------------------- images
    def _read_image_raw(self, index):
        path = join(self.data_root, self.ims[index])
        if not exists(path):
            return None
        return image_io.read_rgb(path).astype(np.float32) / 255.0

    def get_image_and_mask(self, index):
        img, msk, _ = self._get_image_mask_scale(index)
        return img, msk

    def _get_image_mask_scale(self, index):
        """(img, msk, K_scale) at the batch's forced size or ``cfg.ratio``,
        the background zeroed under ``mask_bkgd``; cached by (index, forced
        size, ratio, mask_bkgd)."""
        cfg = self.cfg
        ckey = (index, self.forced_hw, float(cfg.ratio), bool(cfg.mask_bkgd))
        hit = self._img_cache.get(ckey)
        if hit is not None:
            return hit
        img, msk, k_scale = self._get_image_and_mask_uncached(index)
        with self._cache_lock:
            if ckey not in self._img_cache and self._cache_admit(img.nbytes + msk.nbytes):
                self._img_cache[ckey] = (img, msk, k_scale)
        return img, msk, k_scale

    def _get_image_and_mask_uncached(self, index):
        cfg = self.cfg
        img = self._read_image_raw(index)
        msk = None
        if img is not None:
            mask_path = join(self.data_root, self.ims[index].replace(
                'images', cfg.mask))
            mask_path = splitext(mask_path)[0] + '.png'
            if exists(mask_path):
                msk = (image_io.read_gray(mask_path) > 128).astype(np.uint8)
            img = self._maybe_undistort(img, index)
            if msk is not None:
                msk = self._maybe_undistort(msk, index)
        if img is None:
            # no image on disk: zero image + full-box mask (dataset mode)
            img = np.zeros((self.H, self.W, 3), np.float32)
            msk = np.ones((self.H, self.W), np.uint8)
        if msk is None:
            msk = (img.sum(-1) > 0.02).astype(np.uint8)
        if self.forced_hw is not None:
            # image-size batching: the batch's size; the rays a step samples
            # are n_rays all the same (samplers.py:11-46)
            H0, W0 = img.shape[:2]
            H, W = self.forced_hw
            img = image_io.resize(img, (W, H), image_io.INTER_AREA)
            msk = image_io.resize(msk, (W, H), image_io.INTER_NEAREST)
            k_scale = (W / W0, H / H0)
        elif cfg.ratio != 1.0:
            H, W = int(img.shape[0] * cfg.ratio), int(img.shape[1] * cfg.ratio)
            img = image_io.resize(img, (W, H), image_io.INTER_AREA)
            msk = image_io.resize(msk, (W, H), image_io.INTER_NEAREST)
            k_scale = (cfg.ratio, cfg.ratio)
        else:
            k_scale = (1.0, 1.0)
        if cfg.mask_bkgd:
            img = img.copy()
            img[msk == 0] = 0
        return img, msk, k_scale

    def _distortion(self, index):
        """(K, D) of the image's camera when its distortion is nonzero, else
        None."""
        cam_idx = self.get_indices(index)[3]
        D = np.asarray(self.cams.get('D', [[0.0] * 5] * (cam_idx + 1))
                       )[cam_idx].astype(np.float32).reshape(-1)
        if np.abs(D).sum() > 0:
            return np.asarray(self.cams['K'][cam_idx], np.float32), D
        return None

    def _maybe_undistort(self, img, index):
        """``cv2.undistort`` when this camera has nonzero distortion."""
        kd = self._distortion(index)
        if kd is None:
            return img
        cv2 = image_io.import_cv2(join(self.data_root, self.ims[index]),
                                  "undistorting a camera with nonzero D",
                                  "undistort the images beforehand and zero D in annots.npy")
        return cv2.undistort(img, *kd)

    def get_normal(self, index):
        """GT world-space normal map in [-1, 1], or None (reference
        base_dataset.py:243-250: a 'normal' folder mirrors 'images')."""
        base = join(self.data_root, self.ims[index].replace('images', 'normal'))
        for ext in ('.png', '.jpg'):
            path = splitext(base)[0] + ext
            if exists(path):
                img = self._maybe_undistort(image_io.read_rgb(path), index)
                img = img.astype(np.float32) / 255.0
                if self.forced_hw is not None:
                    H, W = self.forced_hw
                    img = image_io.resize(img, (W, H), image_io.INTER_LINEAR)
                elif self.cfg.ratio != 1.0:
                    H = int(img.shape[0] * self.cfg.ratio)
                    W = int(img.shape[1] * self.cfg.ratio)
                    img = image_io.resize(img, (W, H), image_io.INTER_LINEAR)
                return 2.0 * (img - 0.5)
        return None

    def get_semantic(self, index):
        """SCHP color-coded map -> one-hot (H, W, C); None when absent
        (reference base_dataset.py:252-260)."""
        from relightableavatar_tpu_torch.utils import semantics as sem
        base = join(self.data_root, self.ims[index].replace('images', 'schp'))
        for ext in ('.png', '.jpg'):
            path = splitext(base)[0] + ext
            if exists(path):
                img = image_io.read_rgb(path)
                kd = self._distortion(index)
                if kd is not None:
                    # nearest-neighbour undistort keeps labels palette-exact
                    cv2 = image_io.import_cv2(path, "undistorting a camera with nonzero D",
                                              "undistort the maps beforehand and zero D "
                                              "in annots.npy")
                    H0, W0 = img.shape[:2]
                    m1, m2 = cv2.initUndistortRectifyMap(kd[0], kd[1], None, kd[0], (W0, H0),
                                                         cv2.CV_32FC1)
                    img = cv2.remap(img, m1, m2, cv2.INTER_NEAREST)
                if self.forced_hw is not None:
                    H, W = self.forced_hw
                    img = image_io.resize(img, (W, H), image_io.INTER_NEAREST)
                elif self.cfg.ratio != 1.0:
                    H = int(img.shape[0] * self.cfg.ratio)
                    W = int(img.shape[1] * self.cfg.ratio)
                    img = image_io.resize(img, (W, H), image_io.INTER_NEAREST)
                return sem.color_to_onehot(img)
        return None

    def get_indices(self, index):
        latent_index = index // len(self.view)
        frame_index = self.i + latent_index * self.i_intv
        view_index = self.cam_inds[index] if len(self.cam_inds) else 0
        return latent_index, frame_index, view_index, view_index

    def get_gt(self, index) -> dotdict:
        img, msk, k_scale = self._get_image_mask_scale(index)
        latent_index, frame_index, view_index, cam_index = self.get_indices(index)

        K = np.array(self.cams['K'][cam_index], dtype=np.float32).copy()
        R = np.array(self.cams['R'][cam_index], dtype=np.float32)
        T = np.array(self.cams['T'][cam_index], dtype=np.float32) / 1000.
        H, W = img.shape[:2]
        K[0] = K[0] * k_scale[0]
        K[1] = K[1] * k_scale[1]

        ret = self.get_blend(frame_index)
        ret.img = img
        ret.msk = msk
        meta = dict(cam_K=K, cam_R=R, cam_T=T,
                    cam_RT=np.concatenate([R, T.reshape(3, 1)], axis=1), H=H, W=W)
        ret.update(meta)
        ret.meta.update(meta)
        meta = dict(latent_index=latent_index, frame_index=frame_index,
                    view_index=view_index)
        ret.update(meta)
        ret.meta.update(meta)
        return ret

    def _train_ray_geometry(self, index, ret):
        """The train sampler's draw-invariant ray geometry of an item: the
        full image's ray directions, box near/far and the body, face, edge
        and box coordinate pools (what ``rays.sample_ray`` derives over all
        H x W pixels in every draw), cached by (index, H, W) within the host
        budget (an entry past it is used once).  Valid without
        ``subpixel_sample`` (fixed pixel centres)."""
        H, W = ret.img.shape[:2]
        key = (index, H, W)
        ent = self._ray_cache.get(key)
        if ent is not None:
            return ent
        # computed outside the lock: other prefetch threads keep going
        ray_o, ray_d = ray_utils.get_rays(H, W, ret.cam_K, ret.cam_R, ret.cam_T)
        near, far, mab = ray_utils.get_full_near_far(ret.wbounds, ray_o, ray_d)
        near = near.astype(np.float32)
        far = far.astype(np.float32)
        ray_d = np.ascontiguousarray(ray_d, np.float32)
        msk = ret.msk * mab
        coord_body = np.argwhere(msk == 1)
        coord_face = np.argwhere(msk == 13)
        coord_rand = np.argwhere(mab == 1)
        if len(coord_body) == 0:
            coord_body = coord_rand
        if len(coord_face) == 0:
            coord_face = coord_body
        coord_edge = np.zeros((0, 2), np.int64)
        if float(self.cfg.get('edge_sample_ratio', 0.0)) > 0:
            coord_edge = ray_utils.edge_band_coords(msk, mab, int(self.cfg.get('edge_band_px', 5)))
            if len(coord_edge) == 0:
                coord_edge = coord_rand
        nbytes = (ray_d.nbytes + near.nbytes + far.nbytes + mab.nbytes + coord_body.nbytes
                  + coord_face.nbytes + coord_edge.nbytes + coord_rand.nbytes)
        ent = dotdict(ray_o0=np.ascontiguousarray(ray_o[0, 0], np.float32), ray_d=ray_d,
                      near=near, far=far, mask_at_box=mab, coord_body=coord_body,
                      coord_face=coord_face, coord_edge=coord_edge, coord_rand=coord_rand)
        with self._cache_lock:
            prior = self._ray_cache.get(key)
            if prior is not None:
                return prior
            if self._cache_admit(nbytes):
                self._ray_cache[key] = ent
        return ent

    @staticmethod
    def _sample_ray_cached(g, img, nrays, body_ratio, face_ratio, rng, edge_ratio=0.0):
        """The train split's body / face / edge / random ray draw over the
        cached pools: the generator calls of ``rays.sample_ray``
        (data_utils.py:892-922) in its order, in O(n_rays)."""
        n_body = int(nrays * body_ratio)
        n_face = int(nrays * face_ratio)
        n_edge = int(nrays * edge_ratio)
        n_rand = nrays - n_body - n_face - n_edge
        cb = g.coord_body[rng.integers(len(g.coord_body), size=n_body)]
        cf = g.coord_face[rng.integers(len(g.coord_face), size=n_face)]
        if n_edge > 0:
            ce = g.coord_edge[rng.integers(len(g.coord_edge), size=n_edge)]
        else:
            ce = np.zeros((0, 2), np.int64)
        cr = g.coord_rand[rng.integers(len(g.coord_rand), size=n_rand)]
        coord = np.concatenate([cb, cf, ce, cr], axis=0)
        yy, xx = coord[:, 0], coord[:, 1]
        ray_d = g.ray_d[yy, xx]
        ray_o = np.broadcast_to(g.ray_o0, ray_d.shape).astype(np.float32)
        return (img[yy, xx].astype(np.float32), ray_o, ray_d, g.near[yy, xx], g.far[yy, xx],
                coord, g.mask_at_box[yy, xx])

    def __getitem__(self, index, draw: int | None = None) -> dotdict:
        cfg = self.cfg
        ret = self.get_gt(index)
        # per-call generator stream (seed, index, draw#), as the JAX
        # package's: the loader passes its sequence number as ``draw``, so
        # the stream does not depend on which prefetch thread ran first
        if draw is None:
            draw = next(self._draw_counter)
        rng = np.random.default_rng((int(cfg.get('seed', 0)), index, draw))
        if 'train' in self.split and not cfg.subpixel_sample:
            geom = self._train_ray_geometry(index, ret)
            rgb, ray_o, ray_d, near, far, coord, mask_at_box = self._sample_ray_cached(
                geom, ret.img, cfg.n_rays, cfg.body_sample_ratio, cfg.face_sample_ratio, rng,
                float(cfg.get('edge_sample_ratio', 0.0)))
        else:
            rgb, ray_o, ray_d, near, far, coord, mask_at_box = ray_utils.sample_ray(
                ret.img, ret.msk, ret.cam_K, ret.cam_R, ret.cam_T, ret.wbounds,
                cfg.n_rays, self.split, cfg.subpixel_sample,
                cfg.body_sample_ratio, cfg.face_sample_ratio, rng=rng,
                edge_ratio=float(cfg.get('edge_sample_ratio', 0.0)),
                edge_band_px=int(cfg.get('edge_band_px', 5)))
        msk = ret.msk[coord[:, 0], coord[:, 1]].astype(np.float32)
        ret.update(dict(rgb=rgb, ray_o=ray_o, ray_d=ray_d, near=near, far=far,
                        coord=coord, msk=msk, mask_at_box=mask_at_box))
        if cfg.load_semantics:
            sem = self.get_semantic(index)
            if sem is not None:
                ret.sem = sem[coord[:, 0], coord[:, 1]]
        if cfg.load_normal:
            norm = self.get_normal(index)
            if norm is not None:
                ret.norm = norm[coord[:, 0], coord[:, 1]]
        return ret

    def __len__(self):
        return len(self.ims)


# ------------------------------------------------------------------ pose
@register('dataset', 'lib.datasets.pose_dataset', 'pose_dataset')
class PoseDataset(BaseDataset):
    """Novel-pose driving, fixed camera grid (reference pose_dataset)."""

    def __init__(self, cfg, data_root, human, ann_file, split, device="cuda"):
        super().__init__(cfg, data_root, human, ann_file, split, device=device)
        self.load_camera()

    def load_ims_data(self):
        self.ims = np.array([])
        self.cam_inds = np.array([])

    def load_camera(self):
        cfg = self.cfg
        self.Ks = np.array(self.cams['K'])[self.view].astype(np.float32).copy()
        self.Rs = np.array(self.cams['R'])[self.view].astype(np.float32)
        self.Ts = np.array(self.cams['T'])[self.view].astype(np.float32) / 1000.0
        self.Ks[:, :2] = self.Ks[:, :2] * cfg.ratio
        lower = np.tile(np.array([[[0., 0., 0., 1.]]], np.float32), (len(self.Ks), 1, 1))
        self.RT = np.concatenate([
            np.concatenate([self.Rs, self.Ts.reshape(-1, 3, 1)], axis=-1), lower], axis=-2)

    def get_camera(self, view_index):
        cfg = self.cfg
        if cfg.H <= 0 or cfg.W <= 0:
            H, W = int(self.H * cfg.ratio), int(self.W * cfg.ratio)
            K = self.Ks[view_index]
        else:
            H, W = cfg.H, cfg.W
            K = np.zeros((3, 3), dtype=np.float32)
            K[2, 2] = 1
            K[0, 0] = H * cfg.novel_view_ixt_ratio
            K[1, 1] = H * cfg.novel_view_ixt_ratio
            K[0, 2] = H / 2
            K[1, 2] = H / 2
        RT = self.RT[view_index]
        return H, W, K, RT[:3, :3], RT[:3, 3:]

    def get_indices(self, index):
        view_index = index % len(self.view)
        latent_index = index // len(self.view)
        frame_index = self.i + latent_index * self.i_intv
        return latent_index, frame_index, view_index, view_index

    def __getitem__(self, index, draw: int | None = None) -> dotdict:
        latent_index, frame_index, view_index, _ = self.get_indices(index)
        H, W, K, R, T = self.get_camera(view_index)
        ret = self.get_blend(frame_index)
        ray_o, ray_d, near, far, mask_at_box = ray_utils.get_rays_within_bounds(
            H, W, K, R, T, ret.wbounds)
        meta = dict(cam_K=K, cam_R=R, cam_T=T,
                    cam_RT=np.concatenate([R, T.reshape(3, 1)], axis=1), H=H, W=W)
        ret.update(meta)
        ret.meta.update(meta)
        ret.update(dict(ray_o=ray_o, ray_d=ray_d, near=near, far=far,
                        mask_at_box=mask_at_box))
        meta = dict(latent_index=latent_index, frame_index=frame_index,
                    view_index=self.view[view_index])
        ret.update(meta)
        ret.meta.update(meta)
        return ret

    def __len__(self):
        return self.ni * self.num_cams


# ------------------------------------------------------------------ demo
@register('dataset', 'lib.datasets.demo_dataset', 'demo_dataset')
class DemoDataset(PoseDataset):
    """Novel rotating view on a spiral path (reference demo_dataset)."""

    def __init__(self, cfg, data_root, human, ann_file, split, device="cuda"):
        super().__init__(cfg, data_root, human, ann_file, split, device=device)
        self.load_render()

    def load_render(self):
        cfg = self.cfg
        self.render_w2c = gen_path(self.RT, cfg.novel_view_center,
                                   cfg.novel_view_z_off,
                                   num_render_view=cfg.num_render_view,
                                   interpolate=cfg.interpolate_path,
                                   smoothing_term=cfg.smoothing_term)
        self.num_cams = len(self.render_w2c)
        self.K = self.Ks[0].copy()
        self.K[0, 0] *= cfg.novel_view_ixt_ratio
        self.K[1, 1] *= cfg.novel_view_ixt_ratio

    def get_indices(self, index):
        latent_index = index if self.cfg.perform else 0
        frame_index = self.i + latent_index * self.i_intv
        return latent_index, frame_index, index, index

    def __getitem__(self, index, draw: int | None = None) -> dotdict:
        cfg = self.cfg
        latent_index, frame_index, view_index, _ = self.get_indices(index)
        ret = self.get_blend(frame_index)
        if cfg.H <= 0 or cfg.W <= 0:
            H, W = int(self.H * cfg.ratio), int(self.W * cfg.ratio)
            K = self.K
        else:
            H, W = cfg.H, cfg.W
            K = np.zeros((3, 3), dtype=np.float32)
            K[2, 2] = 1
            K[0, 0] = H * cfg.novel_view_ixt_ratio
            K[1, 1] = H * cfg.novel_view_ixt_ratio
            K[0, 2] = H / 2
            K[1, 2] = H / 2
        RT = self.render_w2c[view_index]
        R, T = RT[:3, :3], RT[:3, 3:]
        ray_o, ray_d, near, far, mask_at_box = ray_utils.get_rays_within_bounds(
            H, W, K, R, T, ret.wbounds)
        meta = dict(cam_K=K, cam_R=R, cam_T=T,
                    cam_RT=np.concatenate([R, T], axis=1), H=H, W=W)
        ret.update(meta)
        ret.meta.update(meta)
        ret.update(dict(ray_o=ray_o, ray_d=ray_d, near=near, far=far,
                        mask_at_box=mask_at_box))
        meta = dict(latent_index=latent_index, frame_index=frame_index,
                    view_index=view_index)
        ret.update(meta)
        ret.meta.update(meta)
        return ret

    def __len__(self):
        return len(self.render_w2c)


# ------------------------------------------------------------------ mesh
@register('dataset', 'lib.datasets.mesh_dataset', 'mesh_dataset')
class MeshDataset(PoseDataset):
    """Voxel-grid query points for marching tetrahedra (reference
    mesh_dataset).  ``pts`` stays a numpy (X, Y, Z, 3) grid, as in the JAX
    package; the mesh renderer moves it to its device."""

    def get_indices(self, index):
        if index < 0:  # canonical frame marker from MeshFrameSampler
            return -1, -1, 0, 0
        return super().get_indices(index)

    def __getitem__(self, index, draw: int | None = None) -> dotdict:
        cfg = self.cfg
        latent_index, frame_index, view_index, _ = self.get_indices(index)
        if frame_index < 0:  # canonical frame
            ret = dotdict(meta=dotdict())
            ret.tbounds = self.tbounds
            bounds = self.tbounds
            ret.ctx = self.frame_ctx(0)[0]
        else:
            ret = self.get_blend(frame_index)
            bounds = ret.tbounds if cfg.mesh.get('type', 'tpose') == 'tpose' else ret.wbounds
        # the geometry-prior consumer (use_geometry) needs the skeleton to
        # re-pose the extracted mesh (reference mesh_renderer.py:143-151)
        ret.tjoints = self.tjoints
        ret.parents = self.parents.astype(np.int32)
        vs = cfg.voxel_size
        x = np.arange(bounds[0, 0], bounds[1, 0] + vs[0], vs[0], dtype=np.float32)
        y = np.arange(bounds[0, 1], bounds[1, 1] + vs[1], vs[1], dtype=np.float32)
        z = np.arange(bounds[0, 2], bounds[1, 2] + vs[2], vs[2], dtype=np.float32)
        pts = np.stack(np.meshgrid(x, y, z, indexing='ij'), axis=-1)
        ret.voxel_size = np.array(vs, np.float32)
        ret.pts = pts
        ret.bounds = bounds
        meta = dict(latent_index=latent_index, frame_index=frame_index,
                    view_index=view_index)
        ret.update(meta)
        ret.meta.update(meta)
        return ret


# ------------------------------------------------------------------ loader
class FrameSampler:
    """Test-time frame/view strided sampler (reference samplers.py:133-147)."""

    def __init__(self, dataset, frame_sampler_interval: int, view_sampler_interval: int = 1):
        n_views = max(dataset.num_cams, 1)
        inds = np.arange(len(dataset))
        if len(inds) == 0:
            self.inds = inds
            return
        ni = max(len(inds) // n_views, 1)
        inds = inds[:ni * n_views].reshape(ni, n_views)
        inds = inds[::max(frame_sampler_interval, 1)]
        inds = inds[:, ::max(view_sampler_interval, 1)]
        self.inds = inds.ravel()

    def __iter__(self):
        return iter(self.inds)

    def __len__(self):
        return len(self.inds)


class MeshFrameSampler(FrameSampler):
    """FrameSampler + a leading canonical (-1) item (samplers.py:150-159)."""

    def __init__(self, dataset, frame_sampler_interval, view_sampler_interval=1):
        super().__init__(dataset, frame_sampler_interval, view_sampler_interval)
        self.inds = np.concatenate([[-1], self.inds])


class TrainSampler:
    """Epoch-seeded shuffling sampler, strided by node, cycling the dataset
    without end within an epoch (reference ``samplers.py``: DistributedSampler
    :74-130, IterationBasedBatchSampler :49-71, RandomSampler).  Each pass
    reshuffles with its own (seed, epoch, pass) stream.

    ``rank`` and ``world`` default to the node and the node count
    (``parallel.mesh.node_rank_world``: torchrun's ``GROUP_RANK`` and
    ``WORLD_SIZE // LOCAL_WORLD_SIZE``), the JAX package's process index and
    count, a JAX process being a host with all its chips.  So every GPU rank
    of a node draws the same items and keeps its slice of their rays (the
    trainer's ray mesh), as the chips of a JAX host do; a sampler strided by
    GPU rank would be DDP's semantics, not the JAX package's."""

    def __init__(self, n: int, shuffle: bool = True, seed: int = 0, rank: int | None = None,
                 world: int | None = None):
        node, nodes = node_rank_world()
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.rank = node if rank is None else rank
        self.world = nodes if world is None else world
        self.epoch = 0

    def __len__(self):  # items a rank takes in a pass
        return (self.n + self.world - 1) // self.world

    def __iter__(self):
        for pass_i in range(1 << 30):
            rng = np.random.default_rng((self.seed, self.epoch, pass_i) if self.shuffle else (0,))
            inds = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
            yield from inds[self.rank::self.world].tolist()


class DataLoader:
    """The items of a dataset in the sampler's order, or in its own
    (shuffled under ``shuffle``).

    Training (``infinite``) cycles a :class:`TrainSampler`; the trainer
    stops at ``ep_iter`` (IterationBasedBatchSampler semantics).  Every item
    takes its sequence number as its draw number.  ``workers`` > 0 prepares
    upcoming items in a thread pool (the host's image decode and ray
    sampling overlap the device's step), except under image-size batching
    (``hw_meta``), whose per-batch size is shared state.  ``skip_next``
    skips that many items on the next pass without preparing them (a
    mid-epoch resume)."""

    def __init__(self, dataset, sampler=None, shuffle=False, seed: int = 0,
                 infinite: bool = False, hw_meta=None, batch_size: int = 1, workers: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.shuffle = shuffle
        self.infinite = infinite
        self.hw_meta = hw_meta         # (min_hw, max_hw) for image-size batching
        self.batch_size = batch_size
        self.workers = int(workers)
        self.rng = np.random.default_rng(seed)
        self.skip_next = 0
        if infinite and sampler is None:
            self.sampler = TrainSampler(len(dataset), shuffle=shuffle, seed=seed)

    def _draw_hw(self):
        """A random (H, W) a batch, rounded up to a multiple of 32
        (ImageSizeBatchSampler.generate_height_width, samplers.py:21-28)."""
        (hmin, wmin), (hmax, wmax) = self.hw_meta
        h = int(self.rng.integers(hmin, hmax + 1))
        w = int(self.rng.integers(wmin, wmax + 1))
        return (h | 31) + 1, (w | 31) + 1

    def set_epoch(self, e):
        if isinstance(self.sampler, TrainSampler):
            self.sampler.epoch = e

    def _iter_indices(self):
        skip, self.skip_next = self.skip_next, 0
        for k, i in enumerate(self.sampler):
            if k >= skip:
                yield k, i

    def _prefetched(self):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        depth = self.workers + 2 * self.batch_size
        it = self._iter_indices()
        with ThreadPoolExecutor(self.workers) as pool:
            pending = deque()

            def submit():
                try:
                    k, i = next(it)
                except StopIteration:
                    return
                pending.append(pool.submit(self.dataset.__getitem__, i, k))

            for _ in range(depth):
                submit()
            try:
                while pending:
                    yield pending.popleft().result()
                    submit()
            finally:
                for f in pending:
                    f.cancel()

    def __iter__(self):
        if self.infinite:
            if self.workers > 0 and self.hw_meta is None:
                yield from self._prefetched()
                return
            for k, i in self._iter_indices():
                if self.hw_meta is not None and k % self.batch_size == 0:
                    self.dataset.forced_hw = self._draw_hw()
                yield self.dataset.__getitem__(i, k)
            return
        if self.sampler is not None:
            inds = list(self.sampler)
        else:
            inds = list(range(len(self.dataset)))
            if self.shuffle:
                self.rng.shuffle(inds)
        for i in inds:
            yield self.dataset[i]

    def __len__(self):
        return len(self.sampler) if self.sampler is not None else len(self.dataset)


def make_dataset(cfg, is_train: bool, device="cuda"):
    node = cfg.train_dataset if is_train else cfg.test_dataset
    module = cfg.train_dataset_module if is_train else cfg.test_dataset_module
    ctor = resolve('dataset', module)
    return ctor(cfg, node.data_root, node.human, node.ann_file, node.split, device=device)


def make_data_loader(cfg, is_train: bool, device="cuda"):
    """The training loader (infinite, ``cfg.train`` shuffle, workers and
    batch sampler) or the test loader (``cfg.test.sampler`` FrameSampler,
    MeshFrameSampler or none)."""
    dataset = make_dataset(cfg, is_train, device=device)
    if is_train:
        hw_meta = None
        if cfg.train.batch_sampler == 'image_size' and \
                cfg.train.sampler_meta.strategy != 'origin':
            hw_meta = (tuple(cfg.train.sampler_meta.min_hw),
                       tuple(cfg.train.sampler_meta.max_hw))
        return DataLoader(dataset, shuffle=cfg.train.shuffle, infinite=True, hw_meta=hw_meta,
                          batch_size=int(cfg.train.batch_size),
                          workers=int(cfg.train.num_workers))
    sampler_name = cfg.test.get('sampler', 'FrameSampler')
    if sampler_name == 'MeshFrameSampler':
        sampler = MeshFrameSampler(dataset, cfg.test.frame_sampler_interval,
                                   cfg.test.get('view_sampler_interval', 1))
    elif sampler_name == 'FrameSampler':
        sampler = FrameSampler(dataset, cfg.test.frame_sampler_interval,
                               cfg.test.get('view_sampler_interval', 1))
    else:
        sampler = None
    return DataLoader(dataset, sampler=sampler)
