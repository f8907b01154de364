"""The fixture avatar, its golden renders and the frames the port is run
at, for the port's tests, ``chip_smoke.py`` and ``eval/profile_frame.py``
(counterpart of ``relightableavatar_tpu/eval/golden.py`` and of
``tests/test_golden.py:_render``).

Everything is read from tracked files under ``fixtures/`` and ``tests/``:
the distilled avatar's parameters, the SMPL-H-style body model and motion,
the stored 256-ray golden ``tests/golden_relight_24px.npy``, the 64px
bench-stack golden ``tests/golden_benchstack_64px.npy``, the 512x512
16-bit PNG of bench.py's headline frame ``fixtures/golden_relight_512.png``
and the JAX package's CPU render of that frame
``tests/golden_relight_512_jaxcpu.npy``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from relightableavatar_tpu_torch.config import default_cfg
from relightableavatar_tpu_torch.data.rays import get_full_near_far, get_rays
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu_torch.ops.envmap import gen_light_xyz
from relightableavatar_tpu_torch.renderer.sphere_tracing import (
    RelightRenderConfig, render_human_block)
from relightableavatar_tpu_torch.renderer.tracing import STConfig
from relightableavatar_tpu_torch.smpl.body_model import BodyModel
from relightableavatar_tpu_torch.smpl.synthetic import make_cameras
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.weights import load_params

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_RELIGHT_24 = os.path.join(REPO, 'tests', 'golden_relight_24px.npy')
GOLDEN_BENCHSTACK_64 = os.path.join(REPO, 'tests', 'golden_benchstack_64px.npy')
GOLDEN_RELIGHT_512 = os.path.join(REPO, 'fixtures', 'golden_relight_512.png')
# the JAX package's CPU render of the same frame at HEAD (tests/make_golden_512_jaxcpu.py):
# the stored PNG is 41.75 dB from it, so the port is held to this one
GOLDEN_RELIGHT_512_JAXCPU = os.path.join(REPO, 'tests', 'golden_relight_512_jaxcpu.npy')
FRAME_SIZE = 512    # width and height of the frames of the *_frame_cfg() configs
CHECK_SIZE = 32     # width and height of the frames that hold the card to the CPU
# bench.py's relight_sweep_8light lights: four HDRIs (procedural without
# data/lighting) and four OLATs (indices 0, 27, 91, 200 of cfg.olats)
SWEEP_LIGHTS = ['gym_entrance', 'city_sky', 'sunset_road', 'studio', 'olat0000-0000',
                'olat0000-0027', 'olat0002-0027', 'olat0006-0008']


def fixture_cfg():
    """Config of the fixture avatar on the exact stack, float32: the
    settings of ``relightableavatar_tpu/eval/golden.py`` without its
    acceleration options (52 bones, 3 band samples, HDQ band 0.125 m)."""
    cfg = default_cfg()
    cfg.n_bones = 52
    cfg.cond_dim = 52 * 3
    cfg.relighting = True
    cfg.n_samples = 3
    cfg.dist_th = 0.125
    cfg.obj_lvis.dist_th = 0.125
    cfg.tpu.bf16_mlp = False
    cfg.tpu.knn_impl = 'pallas'
    return cfg


def frame_cfg():
    """Config of the exact relight frame that ``chip_smoke.py`` and
    ``eval/profile_frame.py`` render: the fixture avatar with 16 surface and
    4 shadow iterations and 16x32 light texels."""
    cfg = fixture_cfg()
    cfg.sphere_tracing.iter = 16
    cfg.obj_lvis.iter = 4
    cfg.env_h, cfg.env_w = 16, 32
    return cfg


def bench_stack(cfg, shadow_grid: int):
    """Turn on the JAX bench's shading acceleration stack
    (``bench.py:178-188``, ``_accel_knobs(on=True)``): visibility on the
    2x-coarser light grid from a slice sweep of a ``shadow_grid`` SDF grid,
    looked up at the surface, and the distant-light envmap shortcut.  The
    camera trace stays exact."""
    cfg.tpu.lvis_downscale = 2
    cfg.tpu.shadow_grid = shadow_grid
    cfg.tpu.lvis_sweep = True
    cfg.tpu.lvis_query_offset = 0.0
    cfg.tpu.distant_envmap = True
    cfg.tpu.surf_grid_iters = 0
    cfg.tpu.surf_exact_iters = 0
    return cfg


def accel_frame_cfg():
    """Config of ``bench.py``'s ``relight_512_accel_skip`` frame on the
    fixture avatar: :func:`frame_cfg` with the acceleration stack at a
    96-node grid, the frame-global miss skip and bfloat16 MLPs
    (``bench.py:107,401``), ``ray_block`` 8192."""
    cfg = bench_stack(frame_cfg(), 96)
    cfg.tpu.surf_miss_skip = True
    cfg.tpu.bf16_mlp = True
    cfg.tpu.ray_block = 8192
    return cfg


def golden512_cfg():
    """Config of ``fixtures/golden_relight_512.png``: bench.py's headline
    frame as ``scripts/check_golden_512.py`` renders it, ``bench._setup``'s
    ``make_cfg(relight=True)`` (the default config with the fixture's 52
    bones, HDQ band 0.125 m, ``ray_block`` 8192), ``n_samples`` 3 and
    ``_accel_knobs(cfg, on=True)`` (``bench.py:96-104,176-186``); the MLPs
    in bfloat16 as ``make_params`` sets them (the default here), the KNN
    route the default's.  Not :func:`accel_frame_cfg`, which adds the miss
    skip."""
    cfg = default_cfg()
    cfg.n_bones = 52
    cfg.cond_dim = 52 * 3
    cfg.relighting = True
    cfg.dist_th = 0.125
    cfg.obj_lvis.dist_th = 0.125
    cfg.tpu.ray_block = 8192
    cfg.n_samples = 3
    return bench_stack(cfg, 96)


def sweep_frame_cfg():
    """Config of ``bench.py``'s ``relight_sweep_8light`` frame on the
    fixture avatar (``bench.py:524-569``): :func:`frame_cfg` with the
    acceleration stack at a 96-node grid, bfloat16 MLPs, ``ray_block`` 8192,
    3 band samples, the novel-light maps kept and the 8 lights of
    ``SWEEP_LIGHTS``."""
    cfg = bench_stack(frame_cfg(), 96)
    cfg.tpu.bf16_mlp = True
    cfg.tpu.ray_block = 8192
    cfg.n_samples = 3
    cfg.vis_novel_light = True
    cfg.test_light = list(SWEEP_LIGHTS)
    return cfg


def options_frame_cfg():
    """:func:`frame_cfg` with the shadow HDQ's options: the block's quarter
    of closest points through the network (``tpu.shadow_compact 0.25``), no
    residual MLP (``tpu.shadow_skip_resd``) and ``tpu.shadow_verts_sub 4``,
    which under ``shadow_compact`` leaves the shadow KNN on the full cloud,
    as the JAX package's does.  With no shadow grid, every shadow ray
    queries that HDQ."""
    cfg = frame_cfg()
    cfg.tpu.shadow_compact = 0.25
    cfg.tpu.shadow_skip_resd = True
    cfg.tpu.shadow_verts_sub = 4
    return cfg


def premarch_frame_cfg():
    """:func:`accel_frame_cfg` with the camera trace's pre-march instead of
    the miss skip: 20 steps on the grid's lower bound, then 4 exact
    iterations (``scripts/profile_phases.py:91-92``), the grid baked
    against the vertex subsample (``tpu.shadow_verts_sub 4``)."""
    cfg = accel_frame_cfg()
    cfg.tpu.surf_miss_skip = False
    cfg.tpu.surf_grid_iters = 20
    cfg.tpu.surf_exact_iters = 4
    cfg.tpu.shadow_verts_sub = 4
    return cfg


def ground_frame_cfg():
    """:func:`accel_frame_cfg` with the full-frame ground pass: every pixel
    of the frame shades the ground plane under the learned envmap, with
    soft shadows of the body traced on the exact HDQ SDF toward all 512
    texels (``env_lvis``: 16 iterations, band 0.005 m)."""
    cfg = accel_frame_cfg()
    cfg.vis_ground_shading = True
    return cfg


def volume_frame_cfg(cull: int = 0):
    """Config of ``bench.py``'s ``novel_view_512`` frame on the fixture
    avatar (``bench.py:302-329``): the stage-1 network (``relighting``
    off) volume-rendered with 128 samples a ray, bfloat16 MLPs,
    ``ray_block`` 8192; ``cull`` = 32 is ``novel_view_512_cull32``
    (``tpu.volume_cull``, 128-node grid)."""
    cfg = fixture_cfg()
    cfg.relighting = False
    cfg.n_samples = 128
    cfg.tpu.bf16_mlp = True
    cfg.tpu.ray_block = 8192
    cfg.tpu.volume_cull = cull
    return cfg


def ground_check_cfg():
    """The small ground frame (``CHECK_SIZE`` squared) that holds the card
    to the CPU: the fixture avatar in float32, 6 surface / 2 shadow
    iterations, the ground pass's shadow rays toward all 16x32 texels at 4
    ``env_lvis`` iterations (16 take about a minute on the CPU, nearly all
    of it the plain KNN), ``ray_block`` 256."""
    cfg = fixture_cfg()
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.env_lvis.iter = 4
    cfg.tpu.ray_block = 256
    cfg.vis_ground_shading = True
    return cfg


def volume_check_cfg(cull: int = 0):
    """The small volume frame (``CHECK_SIZE`` squared) that holds the card
    to the CPU: :func:`volume_frame_cfg` in float32, ``ray_block`` 256, a
    48-node cull grid."""
    cfg = volume_frame_cfg(cull)
    cfg.tpu.bf16_mlp = False
    cfg.tpu.ray_block = 256
    cfg.tpu.volume_grid = 48
    return cfg


# the HDQ, shadow-ray and camera-trace options, each on the small check frame:
# (name, {cfg key: value}); keys with a dot are cfg.tpu's
OPTION_CHECKS = [
    ("shadow_compact", {'tpu.shadow_compact': 0.25}),
    ("shadow_skip_resd", {'tpu.shadow_skip_resd': True}),
    ("shadow_verts_sub", {'tpu.shadow_verts_sub': 4}),
    ("knn_xla", {'tpu.knn_impl': 'xla'}),
    ("knn_grouped", {'tpu.knn_impl': 'grouped'}),
    ("sample_vert_cnt_4", {'sample_vert_cnt': 4}),
    ("premarch", {'tpu.shadow_grid': 48, 'tpu.surf_grid_iters': 20, 'tpu.surf_exact_iters': 4,
                  'tpu.shadow_verts_sub': 4}),
    ("e_type_hash", {'e_type': 'hash'}),
]


def option_check_cfg(opts: dict):
    """The small option frame (``CHECK_SIZE`` squared) that holds the card to
    the CPU: the fixture avatar in float32, 6 surface / 2 shadow
    iterations, 16x32 texels, ``ray_block`` 256, with ``opts`` (an entry of
    :data:`OPTION_CHECKS`)."""
    cfg = fixture_cfg()
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.tpu.ray_block = 256
    for key, value in opts.items():
        node, _, leaf = key.rpartition('.')
        (cfg[node] if node else cfg)[leaf] = value
    return cfg


def hash_params(mcfg, device="cuda", seed: int = 0) -> dict:
    """A freshly initialised ``e_type='hash'`` network (``init_anisdf`` from
    a seeded CPU generator, so every device gets the same draw) with the
    SDF output's bias lowered by 0.6 m: at init its zero set lies outside
    the HDQ band and no ray hits."""
    from relightableavatar_tpu_torch.models.anisdf import init_anisdf
    params = init_anisdf(torch.Generator().manual_seed(seed), mcfg, device=device)
    params['sdf']['layers'][-1]['b'][0] -= 0.6
    return params


def load_check_network(cfg, device="cuda", root: str = REPO):
    """(ctx, params, mcfg) of a check frame: the fixture's (frame 0), with
    a hash network (:func:`hash_params`) in place of its weights under
    ``e_type='hash'``."""
    if cfg.get('e_type', 'pe') != 'hash':
        return load_fixture(cfg, device=device, root=root)
    ctx, _, _ = load_fixture(fixture_cfg(), device=device, root=root)
    mcfg = AniSDFConfig.from_cfg(cfg)
    return ctx, hash_params(mcfg, device=device), mcfg


def render_check_frame(cfg, device="cuda", root: str = REPO) -> dict:
    """The ``CHECK_SIZE`` squared frame of ``cfg`` (fixture frame 0, camera
    0; :func:`load_check_network`): the volume renderer when
    ``cfg.relighting`` is off, else ``SphereTracingRenderer``.  Returns its
    maps as float32 numpy."""
    from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
    from relightableavatar_tpu_torch.renderer.volume import VolumeRenderer
    ctx, params, mcfg = load_check_network(cfg, device=device, root=root)
    batch, _ = frame_batch(ctx, CHECK_SIZE, CHECK_SIZE)
    cls = SphereTracingRenderer if cfg.relighting else VolumeRenderer
    out = cls(cfg, params, mcfg, device=device).render(batch)
    return {k: v.cpu().numpy().astype(np.float32) for k, v in out.items()
            if isinstance(v, torch.Tensor)}


def benchstack_cfg(cfg_overrides: dict | None = None):
    """Config of the 64px bench-stack golden
    (``relightableavatar_tpu/eval/golden.py:45-65``): the fixture avatar in
    float32 with 6 surface / 2 shadow iterations, ``ray_block`` 1024 and the
    acceleration stack at a 48-node grid; ``cfg_overrides`` are further
    ``cfg.tpu`` keys."""
    cfg = bench_stack(fixture_cfg(), 48)
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.tpu.ray_block = 1024
    for k, v in (cfg_overrides or {}).items():
        cfg.tpu[k] = v
    return cfg


def render_benchstack_64(device="cuda", cfg_overrides: dict | None = None,
                         root: str = REPO):
    """(img (N, 3) float32 numpy, n_fg_rays): the 64x64 bench-stack frame
    (fixture frame 0, camera 0) through ``SphereTracingRenderer.render``.
    The KNN is the exact top 3 (``knn_impl='pallas'``); the stored golden
    was made with the JAX package's default KNN selection, so it is held
    by PSNR (:func:`check_golden`)."""
    from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
    cfg = benchstack_cfg(cfg_overrides)
    ctx, params, mcfg = load_fixture(cfg, device=device, root=root)
    batch, mab = frame_batch(ctx, 64, 64)
    out = SphereTracingRenderer(cfg, params, mcfg, device=device).render(batch)
    return out.rgb_map.cpu().numpy().astype(np.float32), int(mab.sum())


def read_golden(path: str) -> np.ndarray:
    """A stored golden as float32: a float ``.npy`` as it is, a uint16
    ``.npy`` or a 16-bit PNG (RGB) scaled to [0, 1]."""
    if path.endswith('.png'):
        from relightableavatar_tpu_torch.data.image_io import read_png
        raw = read_png(path)
    else:
        raw = np.load(path)
    return raw.astype(np.float32) / 65535.0 if raw.dtype == np.uint16 else raw


def check_golden(img: np.ndarray, golden_path: str = GOLDEN_BENCHSTACK_64,
                 min_psnr: float = 45.0):
    """(ok, psnr vs the stored golden, or None when the file is absent)
    (``relightableavatar_tpu/eval/golden.py:89-99``); the golden is read by
    :func:`read_golden`."""
    if not os.path.exists(golden_path):
        return False, None
    ref = read_golden(golden_path)
    if img.shape != ref.shape:
        return False, 0.0
    p = psnr(img, ref)
    return bool(p > min_psnr), p


def load_fixture(cfg=None, frame: int = 0, device="cuda", root: str = REPO):
    """(ctx, params, mcfg) of fixture motion frame ``frame`` on ``device``.
    ``sdf_res`` is 8: the avatar's ``sdf/layers/0/v`` takes 51 = 3 + 3*2*8."""
    cfg = cfg if cfg is not None else fixture_cfg()
    model = BodyModel(os.path.join(root, 'fixtures/synthetic_body.npz'))
    motion = dict(np.load(os.path.join(root, 'fixtures/synthetic_motion.npz')))
    sh = motion['shapes'][frame]
    tv, tj, bA, _ = make_bigpose(model, sh)
    ctx = make_frame_context(model, tv, tj, bA, motion['poses'][frame],
                             motion['Rh'][frame], motion['Th'][frame], sh,
                             device=device)
    mcfg = AniSDFConfig.from_cfg(cfg)._replace(sdf_res=8)
    params = load_params(os.path.join(root, 'fixtures/synthetic_avatar_params.npz'),
                         device=device, mcfg=mcfg)
    return ctx, params, mcfg


def golden_bundle_rays(ctx, P: int = 256):
    """The golden's fixed ray bundle (numpy rng 7): P rays from 2.2 m in
    front of the body toward N(0, 0.3 m) targets around its centre."""
    rng = np.random.default_rng(7)
    center = ctx['Th'].cpu().numpy().reshape(3) + [0, 0, 0.9]
    ray_o = np.tile(center + [2.2, 0, 0], (P, 1)).astype(np.float32)
    tgt = center + rng.normal(0, 0.3, (P, 3))
    ray_d = (tgt - ray_o).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    return ray_o, ray_d


NEAR_BUNDLE_NEAR, NEAR_BUNDLE_FAR = 0.05, 1.2


def near_bundle_rays(ctx, P: int = 256):
    """P rays (numpy rng 7) from 0.45 m beside the body's box centre toward
    N(0, (0.15, 0.15, 0.4) m) targets around it, traced over
    [NEAR_BUNDLE_NEAR, NEAR_BUNDLE_FAR]: the origins are close enough to
    the body that the 'can' / 'curve' ablations' world -> bigpose transform
    of an origin (its skinning weights' Gaussian of the nearest vertex
    distances) does not underflow to zero, as it does for a camera 2 m
    away."""
    rng = np.random.default_rng(7)
    center = ctx['wbounds'].cpu().numpy().mean(0)
    ray_o = np.tile(center + [0, -0.45, 0], (P, 1)).astype(np.float32)
    tgt = center + rng.normal(0, [0.15, 0.15, 0.4], (P, 3))
    ray_d = (tgt - ray_o).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    return ray_o, ray_d


def render_golden_bundle(ctx, params, mcfg, device="cuda", rcfg_extra=None,
                         shadow_sdf_grid=None, lvis_volume=None, near_bundle: bool = False):
    """The 256-ray bundle of ``tests/test_golden.py:_render`` through the
    port's ``render_human_block``: 6 surface / 2 shadow iterations, a 2x4
    light grid, a constant 0.6 probe sampled at texel centres.  The grid
    and volume go to ``render_human_block`` as they are.  ``near_bundle``
    takes :func:`near_bundle_rays` over their near and far instead, with 16
    surface iterations."""
    cfg = fixture_cfg()
    cfg.sphere_tracing.iter = 16 if near_bundle else 6
    cfg.obj_lvis.iter = 2
    if near_bundle:
        ray_o, ray_d = near_bundle_rays(ctx)
        near, far = NEAR_BUNDLE_NEAR, NEAR_BUNDLE_FAR
    else:
        ray_o, ray_d = golden_bundle_rays(ctx)
        near, far = 0.8, 4.0
    P = len(ray_o)
    t = lambda a: torch.as_tensor(a, device=device)
    lx, la = gen_light_xyz(2, 4, 10.0, device=device)
    ls = 1.0 / torch.sqrt(la / np.pi)
    st_surf = STConfig.from_cfg(cfg.sphere_tracing)
    st_obj = STConfig.from_cfg({**dict(cfg.sphere_tracing), **dict(cfg.obj_lvis)})
    rcfg = RelightRenderConfig(shadow_block=1024, distant_envmap=True,
                               **(rcfg_extra or {}))
    return render_human_block(
        params, mcfg, ctx, t(ray_o), t(ray_d),
        torch.full((P,), near, device=device), torch.full((P,), far, device=device),
        torch.full((2, 4, 3), 0.6, device=device), lx, la, ls, st_surf, st_obj, rcfg,
        shadow_sdf_grid=shadow_sdf_grid, lvis_volume=lvis_volume)


def frame_batch(ctx, H: int, W: int, cam: int = 0):
    """Rays of camera ``cam`` of ``make_cameras(4, H, W)`` that meet the
    body's world bounds: (batch dotdict, mask_at_box (H*W,) bool).  The
    batch also carries the frame's ``H``, ``W``, camera ``cam_K``,
    ``cam_R``, ``cam_T`` (m) and ``mask_at_box`` for the ground pass, as
    ``bench.py:_rays`` does."""
    cams = make_cameras(4, H=H, W=W)
    K, R, T = cams['K'][cam], cams['R'][cam], cams['T'][cam] / 1000.0
    ray_o, ray_d = get_rays(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3)
    ray_d = ray_d.reshape(-1, 3)
    near, far, mab = get_full_near_far(ctx['wbounds'].cpu().numpy(), ray_o, ray_d)
    batch = dotdict(ray_o=ray_o[mab], ray_d=ray_d[mab], near=near[mab],
                    far=far[mab], ctx=ctx, H=H, W=W, cam_K=K, cam_R=R, cam_T=T,
                    mask_at_box=mab)
    return batch, mab


def psnr(img: np.ndarray, ref: np.ndarray) -> float:
    mse = float(((np.asarray(img, np.float64) - np.asarray(ref, np.float64)) ** 2).mean())
    return float(-10 * np.log10(mse + 1e-12))
