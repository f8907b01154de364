"""Stage-1 volume renderer of AniSDF
(``relightableavatar_tpu/renderer/volume.py``; reference
``lib/networks/renderer/base_renderer.py``): uniform depth samples along
each ray (stratified in training), the network on all P x S points of a ray
block, transmittance compositing and the channel split of the raw outputs.
``render(training=True)`` and :func:`train_block` keep the graph to the
parameters for the training step.

``tpu.volume_cull`` = K evaluates the network on only the K samples of each
ray with the largest proxy compositing weight, computed from a per-frame
bake of the HDQ SDF on a grid (``tpu.volume_grid`` nodes on the longest
axis); the other samples keep the proxy's occupancy.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from relightableavatar_tpu_torch.device import resolve_device
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.aabb import pad_box
from relightableavatar_tpu_torch.ops.sdf import render_weights, sdf_to_occ, volume_rendering
from relightableavatar_tpu_torch.ops.sdf_grid import axis_resolutions, build_hdq_grid, grid_sdf
from relightableavatar_tpu_torch.renderer.orchestrate import pad_rays
from relightableavatar_tpu_torch.utils.dotdict import dotdict

CULL_DILATE = 2     # samples each side of a proxy weight that share its score


def sample_fractions(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as XLA evaluates it: ``i * (1 / (n - 1))``
    with the reciprocal rounded to ``dtype`` (a product, not a division, so
    some interior values differ by one ulp from ``i / (n - 1)``), the last 1."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    return torch.arange(n, dtype=dtype, device=device) * torch.tensor(
        1.0 / (n - 1), dtype=dtype, device=device)


def stratified(z_vals: torch.Tensor, t_rand: torch.Tensor) -> torch.Tensor:
    """Jitter each sample within its interval (base_renderer.py:15-31):
    ``t_rand`` (P, S) uniform in [0, 1), drawn by the caller."""
    mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
    upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
    lower = torch.cat([z_vals[:, :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def train_block(params, mcfg: AniSDFConfig, ctx, ray_o, ray_d, near, far,
                n_samples: int, bg_brightness: float, t_rand=None) -> dotdict:
    """The training render of a ray block (JAX ``_render_block`` with
    ``training``, ``train/trainer.py:_volume_forward``): the network's
    training forward on all P x S points, composited.  Returns weights and
    z_vals (P, S), the composited raw channels ``raw_map`` (P, 6) =
    [norm, rgb], ``acc_map`` and the forward's training terms, all with
    the graph to the parameters.  ``t_rand`` (P, S) stratifies the samples;
    None keeps them uniform.  No sample culling in training."""
    P = ray_o.shape[0]
    S = n_samples
    t_vals = sample_fractions(S, ray_o.dtype, ray_o.device)
    z_vals = near[:, None] * (1.0 - t_vals) + far[:, None] * t_vals
    if t_rand is not None:
        z_vals = stratified(z_vals, t_rand)
    pts = ray_o[:, None, :] + ray_d[:, None, :] * z_vals[..., None]
    ret = anisdf.forward(params, mcfg, ctx, pts.reshape(P * S, 3),
                         ray_d[:, None, :].expand(P, S, 3).reshape(P * S, 3), training=True)
    raw = ret.raw.reshape(P, S, -1)
    weights, raw_map, acc_map = volume_rendering(raw[..., :-1], raw[..., -1],
                                                 bg_brightness=bg_brightness)
    return dotdict(weights=weights, z_vals=z_vals, raw_map=raw_map, acc_map=acc_map,
                   reg_mask=ret.reg_mask, residuals=ret.residuals,
                   gradients=ret.gradients, observed_gradients=ret.observed_gradients)


@torch.no_grad()
def _render_block(params, mcfg: AniSDFConfig, ctx, ray_o, ray_d, near, far,
                  n_samples: int, bg_brightness: float, cull_k: int = 0,
                  grid=None, glo=None, ghi=None) -> dotdict:
    """ray_o/ray_d (P, 3), near/far (P,) -> maps, each (P, ...).

    ``cull_k`` > 0: the network runs on the ``cull_k`` samples of each ray
    with the largest proxy compositing weight T_i alpha_i, from the trilinear
    lookup of the baked ``grid`` over [``glo``, ``ghi``], dilated by
    ``CULL_DILATE`` samples to tolerate the grid's surface offset; the
    results are scattered back by index, so ``torch.topk``'s order among
    equal scores does not matter (only which sample wins a tie at the K-th
    score could, and the 1e-7 tie-break toward the band makes that rare).
    The other samples get occ = sdf_to_occ(proxy) inside the band and 0
    outside, as the forward masks them."""
    P = ray_o.shape[0]
    S = n_samples
    t_vals = sample_fractions(S, ray_o.dtype, ray_o.device)
    z_vals = near[:, None] * (1.0 - t_vals) + far[:, None] * t_vals        # (P, S)
    pts = ray_o[:, None, :] + ray_d[:, None, :] * z_vals[..., None]       # (P, S, 3)

    if cull_k and cull_k < S:
        proxy = grid_sdf(grid, glo, ghi, pts.reshape(-1, 3)).reshape(P, S)
        occ_bg = sdf_to_occ(proxy, anisdf.beta_of(params))
        occ_bg = torch.where(torch.abs(proxy) <= mcfg.dist_th, occ_bg, torch.zeros_like(occ_bg))
        wp = torch.nn.functional.pad(render_weights(occ_bg), (CULL_DILATE, CULL_DILATE))
        score = torch.amax(torch.stack([wp[:, i:i + S] for i in range(2 * CULL_DILATE + 1)]),
                           dim=0)
        # tie-break dead-zero scores toward the band (miss rays, halo edges)
        score = score + 1e-7 * mcfg.dist_th / (mcfg.dist_th + torch.abs(proxy))
        idx = torch.topk(score, cull_k, dim=1).indices                    # (P, K)
        pts_sel = torch.gather(pts, 1, idx[..., None].expand(P, cull_k, 3))
        ret = anisdf.forward(params, mcfg, ctx, pts_sel.reshape(P * cull_k, 3),
                             ray_d[:, None, :].expand(P, cull_k, 3).reshape(P * cull_k, 3))
        raw_sel = ret.raw.reshape(P, cull_k, -1)
        raw = raw_sel.new_zeros((P, S, raw_sel.shape[-1]))
        raw[..., -1] = occ_bg
        raw.scatter_(1, idx[..., None].expand_as(raw_sel), raw_sel)
    else:
        ret = anisdf.forward(params, mcfg, ctx, pts.reshape(P * S, 3),
                             ray_d[:, None, :].expand(P, S, 3).reshape(P * S, 3))
        raw = ret.raw.reshape(P, S, -1)

    weights, raw_map, acc_map = volume_rendering(raw[..., :-1], raw[..., -1],
                                                 bg_brightness=bg_brightness)
    out = dotdict(depth_map=torch.sum(weights * z_vals, dim=-1))
    # channel split (base_renderer.py:96-108): stage-1 raw is
    # [cpts, bpts, resd, norm, rgb]
    raw_c = raw_map
    if raw_c.shape[-1] >= 9:
        out.cpts_map, out.bpts_map, out.resd_map = raw_c[..., :3], raw_c[..., 3:6], \
            raw_c[..., 6:9]
        raw_c = raw_c[..., 9:]
    if raw_c.shape[-1] >= 6:
        out.norm_map = raw_c[..., :3]
        raw_c = raw_c[..., 3:]
    out.rgb_map = raw_c
    out.acc_map = acc_map
    return out


class VolumeRenderer:
    """Pads the rays to whole ``tpu.ray_block`` blocks and renders them
    block by block.  ``params`` and the batch's ``ctx`` hold tensors on
    ``device``; ray arrays may be numpy.  With ``time_stages`` set,
    ``render`` synchronises after the cull grid's bake and after the blocks
    and records their seconds in ``last_frame``."""

    def __init__(self, cfg, params, mcfg: AniSDFConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.mcfg = mcfg
        self._grid_res = None
        self.time_stages = False
        self.last_frame = dotdict()

    def _sync(self):
        if self.time_stages and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bake_cull_grid(self, ctx):
        """The frame's packed HDQ SDF grid for sample culling over the body
        box padded by ``tpu.grid_margin``, and its box corners; the lattice
        is fixed on the first frame."""
        gbox = pad_box(ctx["wbounds"], float(self.cfg.tpu.grid_margin))
        if self._grid_res is None:
            ext = (gbox[1] - gbox[0]).cpu().numpy()
            self._grid_res = axis_resolutions(ext, int(self.cfg.tpu.volume_grid))
        grid = build_hdq_grid(self.params, self.mcfg, ctx, gbox[0], gbox[1],
                              self._grid_res, packed=True)
        return grid, gbox[0], gbox[1]

    def render(self, batch, training: bool = False,
               generator: torch.Generator | None = None) -> dotdict:
        """batch: ray_o, ray_d (..., 3), near, far (...), ctx -> maps (P, ...)
        on the device: rgb, acc, depth, norm, cpts, bpts, resd.

        ``training``: the maps rgb and acc, the compositing weights and
        z_vals, and the forward's residuals, observed and canonical
        gradients, with the graph to the parameters; ``tpu.volume_cull`` is
        ignored, and under ``perturb`` the samples are stratified by draws
        from ``generator`` (on the device), one (block, S) draw a block."""
        if training:
            return self._render_train(batch, generator)
        with torch.no_grad():
            return self._render(batch)

    def _rays(self, batch):
        cfg = self.cfg
        ray_o = np.asarray(batch.ray_o, np.float32).reshape(-1, 3)
        ray_d = np.asarray(batch.ray_d, np.float32).reshape(-1, 3)
        near = np.clip(np.asarray(batch.near, np.float32).reshape(-1), cfg.clip_near, None)
        far = np.clip(np.asarray(batch.far, np.float32).reshape(-1), None, cfg.clip_far)
        return pad_rays(ray_o, ray_d, near, far, int(cfg.tpu.ray_block), far_pad=0.2)

    def _render_train(self, batch, generator) -> dotdict:
        cfg = self.cfg
        dev = self.device
        ray_o, ray_d, near, far, P = self._rays(batch)
        if P == 0:
            return dotdict(rgb_map=torch.zeros((0, 3), device=dev),
                           acc_map=torch.zeros((0,), device=dev))
        block = int(cfg.tpu.ray_block)
        S = int(cfg.n_samples)
        put = lambda a: torch.as_tensor(a, device=dev)
        outs = []
        for i in range(0, len(ray_o), block):
            s = slice(i, i + block)
            t_rand = None
            if cfg.perturb > 0:
                t_rand = torch.rand((len(ray_o[s]), S), generator=generator, device=dev)
            o = train_block(self.params, self.mcfg, batch.ctx, put(ray_o[s]), put(ray_d[s]),
                            put(near[s]), put(far[s]), S, float(cfg.bg_brightness), t_rand)
            outs.append(dotdict(residuals=o.residuals, observed_gradients=o.observed_gradients,
                                gradients=o.gradients, weights=o.weights, z_vals=o.z_vals,
                                rgb_map=o.raw_map[..., 3:], acc_map=o.acc_map))
        # per-point terms keep every block's points; per-ray maps drop the padding
        return dotdict({k: torch.cat([o[k] for o in outs], dim=0)
                        if k in ('residuals', 'observed_gradients', 'gradients')
                        else torch.cat([o[k] for o in outs], dim=0)[:P] for k in outs[0]})

    def _render(self, batch) -> dotdict:
        cfg = self.cfg
        dev = self.device
        self.last_frame = dotdict()
        block = int(cfg.tpu.ray_block)
        ray_o, ray_d, near, far, P = self._rays(batch)
        if P == 0:
            return dotdict(rgb_map=torch.zeros((0, 3), device=dev),
                           acc_map=torch.zeros((0,), device=dev))

        self._sync()
        t0 = time.perf_counter()
        cull_k = int(cfg.tpu.volume_cull)
        grid = glo = ghi = None
        if cull_k and cull_k < int(cfg.n_samples):
            grid, glo, ghi = self.bake_cull_grid(batch.ctx)
            self._sync()
            self.last_frame.bake_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        else:
            cull_k = 0

        put = lambda a: torch.as_tensor(a, device=dev)
        outs = []
        for i in range(0, len(ray_o), block):
            s = slice(i, i + block)
            outs.append(_render_block(
                self.params, self.mcfg, batch.ctx, put(ray_o[s]), put(ray_d[s]),
                put(near[s]), put(far[s]), int(cfg.n_samples), float(cfg.bg_brightness),
                cull_k=cull_k, grid=grid, glo=glo, ghi=ghi))
        merged = dotdict({k: torch.cat([o[k] for o in outs], dim=0)[:P] for k in outs[0]})
        self._sync()
        self.last_frame.blocks_s = time.perf_counter() - t0
        self.last_frame.blocks = len(outs)
        return merged
