"""AniSDF (``relightableavatar_tpu/models/anisdf.py``): the parameter
initialisation, inverse-LBS warp with KNN skinning, the hierarchical distance
query (HDQ) world SDF, and the network forward with autodiff normals, for
inference and for the stage-1 training step.

The KNN is always the exact top 3 (``ops/knn.py``); MLPs run in float32 or,
under ``tpu.bf16_mlp`` / ``tpu.bf16_act``, with bfloat16 matmuls
(``ops/mlp.py``).  The options not ported raise in
:meth:`AniSDFConfig.from_cfg` instead of being ignored.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from relightableavatar_tpu_torch.ops import lbs
from relightableavatar_tpu_torch.ops.embedder import embed_dim, positional_encoding
from relightableavatar_tpu_torch.ops.knn import knn_top3
from relightableavatar_tpu_torch.ops.mlp import (linear_apply, linear_init, mlp_apply, mlp_init,
                                                 ssdf_apply, ssdf_init)
from relightableavatar_tpu_torch.ops.point_mesh import signed_mesh_distance
from relightableavatar_tpu_torch.ops.sdf import sdf_to_occ
from relightableavatar_tpu_torch.utils.dotdict import dotdict


class AniSDFConfig(NamedTuple):
    """Architecture knobs (the JAX ``AniSDFConfig`` minus the options this
    slice does not port)."""
    n_bones: int = 52
    cond_dim: int = 156
    feat_dim: int = 256
    xyz_res: int = 10
    sdf_res: int = 8
    view_res: int = 4
    resd_limit: float = 0.05
    dist_th: float = 0.1
    blend_radius: float = 0.075
    sample_vert_cnt: int = 3
    use_geodesic_filter: bool = True
    relight: bool = False
    relight_width: int = 128
    relight_depth: int = 2
    albedo_slope: float = 1.0
    albedo_bias: float = 0.0
    roughness_slope: float = 0.90
    roughness_bias: float = 0.09
    env_h: int = 16
    env_w: int = 32
    env_r: float = 10.0
    envmap_upscale: int = 2
    achro_light: bool = False
    bf16: bool = False          # bfloat16 matmuls, float32 accumulation
    bf16_act: bool = False      # with bf16: bfloat16 hidden activations
    smpl_distance: bool = False  # HDQ's band SDF from the canonical SMPL mesh

    @classmethod
    def from_cfg(cls, cfg) -> "AniSDFConfig":
        if cfg.tpu.knn_impl not in ('auto', 'pallas'):
            raise NotImplementedError(
                f"tpu.knn_impl={cfg.tpu.knn_impl!r}: the port has the exact "
                "top-3 KNN only ('auto' or 'pallas')")
        if cfg.get('e_type', 'pe') != 'pe':
            raise NotImplementedError(f"e_type={cfg.e_type!r}: only 'pe' is ported")
        if cfg.sample_vert_cnt != 3:
            raise NotImplementedError(
                f"sample_vert_cnt={cfg.sample_vert_cnt}: the KNN is top-3 only")
        return cls(
            n_bones=cfg.n_bones,
            cond_dim=cfg.cond_dim if cfg.cond_dim > 0 else cfg.n_bones * 3,
            feat_dim=cfg.feat_dim,
            xyz_res=cfg.xyz_res,
            sdf_res=cfg.sdf_res,
            view_res=cfg.view_res,
            resd_limit=cfg.resd_limit,
            dist_th=cfg.dist_th,
            blend_radius=cfg.blend_radius,
            sample_vert_cnt=cfg.sample_vert_cnt,
            use_geodesic_filter=cfg.use_geodesic_filter,
            relight=cfg.relighting,
            relight_width=cfg.relight_network_width,
            relight_depth=cfg.relight_network_depth,
            albedo_slope=cfg.albedo_slope,
            albedo_bias=cfg.albedo_bias,
            roughness_slope=cfg.roughness_slope,
            roughness_bias=cfg.roughness_bias,
            env_h=cfg.env_h,
            env_w=cfg.env_w,
            env_r=cfg.env_r,
            envmap_upscale=cfg.envmap_upscale,
            achro_light=cfg.achro_light,
            bf16=bool(cfg.tpu.bf16_mlp),
            bf16_act=bool(cfg.tpu.bf16_act),
            smpl_distance=bool(cfg.smpl_distance),
        )


# ---------------------------------------------------------------- params init
def init_anisdf(generator: torch.Generator, mcfg: AniSDFConfig, device="cpu") -> dict:
    """Parameters of the network ``mcfg`` names, in the layout of the JAX
    package's ``init_anisdf`` (the reference module structure, so checkpoint
    keys map), drawn from ``generator`` (a CPU generator) and moved to
    ``device``.  Each sub-network draws in the JAX package's order: residual
    MLP, SDF MLP, render MLP, relight heads."""
    resd_in = embed_dim(3, mcfg.xyz_res)
    sdf_in = embed_dim(3, mcfg.sdf_res)
    params = {
        # ResidualDeformation (base_network.py:14-42)
        "resd": mlp_init(generator, input_ch=resd_in + mcfg.cond_dim, W=256, D=8,
                         out_ch=3, zero_out_bias=True),
        # SignedDistanceNetwork (base_network.py:45-129)
        "sdf": ssdf_init(generator, d_in=sdf_in, d_hidden=256, n_layers=8,
                         d_out=1 + mcfg.feat_dim),
        "beta": torch.tensor(0.1),
        # RenderNetwork (base_network.py:132-171): 5 weight-normed linears
        "rgb": _render_net_init(generator, mcfg),
    }
    if mcfg.relight:
        params.update(init_relight_heads(generator, mcfg))
    return _to_device(params, torch.device(device))


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device=device, dtype=torch.float32).contiguous()


def _render_net_init(generator: torch.Generator, mcfg: AniSDFConfig) -> dict:
    W = 256
    in0 = 3 + mcfg.feat_dim + embed_dim(3, mcfg.view_res)
    dims = [(in0, W), (W, W), (W, W), (W + mcfg.cond_dim, W), (W, 3)]
    return {f"l{i}": linear_init(generator, d_in, d_out, weight_norm=True)
            for i, (d_in, d_out) in enumerate(dims)}


def init_relight_heads(generator: torch.Generator, mcfg: AniSDFConfig) -> dict:
    """Albedo and roughness MLP heads and the learnable environment map
    (reference relight_network.py:45-77)."""
    env_c = 1 if mcfg.achro_light else 3
    return {
        "albedo": mlp_init(generator, input_ch=mcfg.feat_dim, W=mcfg.relight_width,
                           D=mcfg.relight_depth, out_ch=3, w_init="kaiming_normal"),
        "roughness": mlp_init(generator, input_ch=mcfg.feat_dim, W=mcfg.relight_width,
                              D=mcfg.relight_depth, out_ch=1, w_init="kaiming_normal"),
        "env": torch.rand((mcfg.env_h * mcfg.envmap_upscale,
                           mcfg.env_w * mcfg.envmap_upscale, env_c), generator=generator) * 0.2,
    }


def global_env_map(params: dict, mcfg: AniSDFConfig) -> torch.Tensor:
    """softplus + achromatic expansion (relight_network.py:86-89)."""
    env = params["env"]
    env = env.expand(*env.shape[:2], 3)
    return F.softplus(env)


def beta_of(params: dict) -> torch.Tensor:
    return torch.clamp(params["beta"], 1e-9, 1e6)


# ---------------------------------------------------------------- sub-networks
def residuals(params, mcfg: AniSDFConfig, bpts, cond):
    emb = positional_encoding(bpts, mcfg.xyz_res)
    net = mlp_apply(params["resd"], torch.cat([emb, cond], dim=-1),
                    bf16=mcfg.bf16, bf16_act=mcfg.bf16_act)
    return torch.tanh(net) * mcfg.resd_limit


def sdf_feat(params, mcfg: AniSDFConfig, cpts):
    out = ssdf_apply(params["sdf"], positional_encoding(cpts, mcfg.sdf_res),
                     bf16=mcfg.bf16, bf16_act=mcfg.bf16_act)
    return out[..., :1], out[..., 1:]


def render_rgb(params, mcfg: AniSDFConfig, view, grad, feat, cond):
    """RenderNetwork forward (base_network.py:152-171)."""
    emb = positional_encoding(view, mcfg.view_res)
    x = torch.cat([emb, grad, feat], dim=-1)
    p = params["rgb"]
    bf16 = mcfg.bf16
    x = torch.relu(linear_apply(p["l0"], x, bf16=bf16))
    x = torch.relu(linear_apply(p["l1"], x, bf16=bf16))
    x = torch.relu(linear_apply(p["l2"], x, bf16=bf16))
    x = torch.cat([x, cond], dim=-1)
    x = torch.relu(linear_apply(p["l3"], x, bf16=bf16))
    return torch.sigmoid(linear_apply(p["l4"], x, bf16=bf16))


def albedo_head(params, mcfg: AniSDFConfig, feat):
    out = mlp_apply(params["albedo"], feat, actvn="softplus100", skips=(),
                    bf16=mcfg.bf16)
    return mcfg.albedo_slope * torch.sigmoid(out) + mcfg.albedo_bias


def roughness_head(params, mcfg: AniSDFConfig, feat):
    out = mlp_apply(params["roughness"], feat, actvn="softplus100", skips=(),
                    bf16=mcfg.bf16)
    return mcfg.roughness_slope * torch.sigmoid(out) + mcfg.roughness_bias


def condition_vector(ctx: dict) -> torch.Tensor:
    return ctx["poses"].reshape(-1)


# ---------------------------------------------------------------- LBS warping
def _hdq_knn_stage(mcfg: AniSDFConfig, ctx: dict, ppts: torch.Tensor, th: float):
    """Exact top-3 KNN + signed point-cloud distance + geodesic filter.

    Returns d2 (P, K), nn (P, K) int64, sdf_k (P, K), mask (P,),
    smpl_sdf (P, 1), bw_k (P, K, J)."""
    _, nn = knn_top3(ppts, ctx["pverts"])
    nn = nn.long()

    tbl = ctx["knn_table"][nn]                      # (P, K, 9 + J)
    nverts = tbl[..., 0:3]
    nnorm = tbl[..., 3:6]
    tv = tbl[..., 6:9]
    bw_k = tbl[..., 9:]

    # exact distances + signed distance to each neighbour (sample_utils.py:118-127)
    diff = ppts[:, None, :] - nverts
    d2 = torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0)
    dist = torch.sqrt(d2)
    dot = torch.sum(diff * nnorm, dim=-1)
    sdf_k = dist * torch.sign(dot)

    if mcfg.use_geodesic_filter:
        # neighbours whose canonical positions stray > th from the closest
        # one are replaced by it (sample_utils.py:148-161)
        tv_to_cls = torch.sum((tv - tv[:, :1]) ** 2, dim=-1)
        geo_ok = tv_to_cls < th ** 2
        d2 = torch.where(geo_ok, d2, d2[:, :1])
        nn = torch.where(geo_ok, nn, nn[:, :1])
        sdf_k = torch.where(geo_ok, sdf_k, sdf_k[:, :1])
        bw_k = torch.where(geo_ok[..., None], bw_k, bw_k[:, :1])

    mask = d2[:, 0] < th ** 2

    # SMPL fallback: majority-sign * mean |sdf_k| (base_network.py:374-375)
    sgn = torch.sign(torch.sum(torch.sign(sdf_k), dim=-1, keepdim=True) + 0.5)
    smpl_sdf = sgn * torch.mean(torch.abs(sdf_k), dim=-1, keepdim=True)
    smpl_sdf = torch.where(smpl_sdf < -th, smpl_sdf, torch.abs(smpl_sdf))
    return d2, nn, sdf_k, mask, smpl_sdf, bw_k


def _hdq_warp_stage(mcfg: AniSDFConfig, ctx: dict, ppts, d2, bw_k):
    """Gaussian-blended LBS warp pose -> t-pose -> bigpose
    (base_network.py:287-290)."""
    w = torch.exp(-d2 / (2 * mcfg.blend_radius ** 2))
    w = w / (torch.sum(w, dim=-1, keepdim=True) + torch.finfo(w.dtype).eps)
    bw = torch.sum(w[..., None] * bw_k, dim=-2)     # (P, J)

    big_A_bw = lbs.blend_transform(bw, ctx["big_A"])
    big_R_inv = lbs.inverse_3x3(big_A_bw[..., :3, :3])
    A_bw = lbs.blend_transform(bw, ctx["A"])
    R_inv = lbs.inverse_3x3(A_bw[..., :3, :3])

    tpts = lbs.pose_points_to_tpose_points(ppts, A_bw=A_bw, R_inv=R_inv)
    bpts = lbs.tpose_points_to_pose_points(tpts, A_bw=big_A_bw)
    return tpts, bpts, A_bw, R_inv, big_A_bw, big_R_inv


def world_to_bigpose(mcfg: AniSDFConfig, ctx: dict, x: torch.Tensor,
                     v: torch.Tensor | None = None, dist_th: float | None = None,
                     filtering: bool = True) -> dotdict:
    """x (P, 3) world points -> bigpose points, blended transforms, the band
    ``mask`` (d2min < dist_th^2) and the SMPL fallback sdf, for all P."""
    th = dist_th if dist_th is not None else mcfg.dist_th
    if not filtering:
        th = 1e9
    ppts = lbs.world_points_to_pose_points(x, ctx["R"], ctx["Th"])
    d2, nn, sdf_k, mask, smpl_sdf, bw_k = _hdq_knn_stage(mcfg, ctx, ppts, th)
    tpts, bpts, A_bw, R_inv, big_A_bw, big_R_inv = _hdq_warp_stage(
        mcfg, ctx, ppts, d2, bw_k)

    ret = dotdict(tpts=tpts, bpts=bpts, mask=mask, smpl_sdf=smpl_sdf,
                  d2=d2, nn=nn, A_bw=A_bw, R_inv=R_inv,
                  big_A_bw=big_A_bw, big_R_inv=big_R_inv)
    if v is not None:
        pvds = lbs.world_dirs_to_pose_dirs(v, ctx["R"])
        tvds = lbs.pose_dirs_to_tpose_dirs(pvds, A_bw=A_bw)
        bvds = lbs.tpose_dirs_to_pose_dirs(tvds, A_bw=big_A_bw, R_inv=big_R_inv)
        ret.wvds = v
        ret.pvds = pvds
        ret.tvds = tvds
        ret.bvds = bvds
    return ret


def world_to_bigpose_transform(mcfg: AniSDFConfig, ctx: dict,
                               x: torch.Tensor) -> torch.Tensor:
    """Composed per-point world -> bigpose 4x4 (base_network.py:338-358),
    forward direction (x in world space)."""
    out = world_to_bigpose(mcfg, ctx, x, filtering=False)
    P = out.A_bw.shape[0]
    p2w = torch.eye(4, dtype=x.dtype, device=x.device)
    p2w[:3, :3] = ctx["R"]
    p2w[:3, 3] = ctx["Th"].reshape(3)
    w2p = lbs.affine_inverse(p2w).expand(P, 4, 4)
    p2t = lbs.affine_inverse(out.A_bw)
    return out.big_A_bw @ p2t @ w2p


# ---------------------------------------------------------------- HDQ SDF
def hdq_sdf(params, mcfg: AniSDFConfig, ctx: dict, x: torch.Tensor,
            smooth_transition: bool = True,
            dist_th: float | None = None) -> torch.Tensor:
    """World-space hierarchical distance query (base_network.py:365-387):
    (P, 1) signed distance, the network SDF inside the SMPL band blended
    toward the SMPL point-cloud distance, which is used outside it.

    Only the points inside the band go through the warp and the MLPs, as
    the reference's ``batch_aware_indexing`` does; the JAX package computes
    every point and discards the rest with a mask, so the outputs agree."""
    th = dist_th if dist_th is not None else mcfg.dist_th
    ppts = lbs.world_points_to_pose_points(x, ctx["R"], ctx["Th"])
    d2, _, _, mask, smpl_sdf, bw_k = _hdq_knn_stage(mcfg, ctx, ppts, th)
    sel = torch.nonzero(mask).squeeze(1)
    _, bpts, *_ = _hdq_warp_stage(mcfg, ctx, ppts[sel], d2[sel], bw_k[sel])
    cond = condition_vector(ctx)[None, :].expand(bpts.shape[0], mcfg.cond_dim)
    resd = residuals(params, mcfg, bpts, cond)
    if mcfg.smpl_distance:
        # the exact canonical-SMPL mesh SDF instead of the network's
        # (base_network.py:417-427; the BVH becomes a blocked closest-point
        # scan, ops/point_mesh.py)
        net_sdf = signed_mesh_distance(bpts + resd, ctx["tverts"], ctx["faces"])[:, None]
    else:
        net_sdf, _ = sdf_feat(params, mcfg, bpts + resd)
    smpl_in = smpl_sdf[sel]
    if smooth_transition:
        r = torch.clamp(torch.abs(net_sdf) / th, 0.0, 1.0)
        net_sdf = smpl_in * r + net_sdf * (1 - r)
    return smpl_sdf.index_copy(0, sel, net_sdf)


# ---------------------------------------------------------------- full forward
def _normals(ograd, out, ctx):
    """The observed gradient's direction warped bigpose -> tpose -> pose ->
    world."""
    norm = lbs.normalize(ograd)
    norm = lbs.pose_dirs_to_tpose_dirs(norm, A_bw=out.big_A_bw)
    norm = lbs.tpose_dirs_to_pose_dirs(norm, A_bw=out.A_bw, R_inv=out.R_inv)
    norm = lbs.pose_dirs_to_world_dirs(norm, ctx["R"])
    return lbs.normalize(norm)


def forward_geometry(params, mcfg: AniSDFConfig, ctx: dict, x: torch.Tensor,
                     v: torch.Tensor | None, training: bool = False):
    """base_network.py:456-494: warp, residual + SDF, the observed gradient
    d sdf / d bpts by autograd, normals warped bigpose -> tpose -> pose ->
    world.  Returns (ret, out): ``out`` the per-point geometry, ``ret`` the
    training terms (empty in inference).

    The warp depends on no parameter and runs without a graph.  Inference
    detaches everything.  ``training`` keeps the graph to the parameters:
    one ``autograd.grad(sdf.sum(), [bpts, cpts], create_graph=True)`` gives
    the observed gradient (JAX's ``cgrad + J_resd^T cgrad``, the chain rule
    through the residual) and the canonical one, and ``ret`` holds
    ``reg_mask``, ``residuals``, ``observed_gradients`` and ``gradients``,
    masked to the band."""
    with torch.no_grad():
        out = world_to_bigpose(mcfg, ctx, x, v=v)
    cond = condition_vector(ctx)[None, :].expand(x.shape[0], mcfg.cond_dim)
    with torch.enable_grad():
        bpts = out.bpts.detach().requires_grad_(True)
        resd = residuals(params, mcfg, bpts, cond)
        cpts = bpts + resd
        sdf, feat = sdf_feat(params, mcfg, cpts)
        if training:
            ograd, cgrad = torch.autograd.grad(sdf.sum(), [bpts, cpts], create_graph=True)
        else:
            (ograd,) = torch.autograd.grad(sdf.sum(), bpts)
    ret = dotdict()
    if training:
        occ = sdf_to_occ(sdf, beta_of(params))
        norm = _normals(ograd, out, ctx)
        m = out.mask[:, None].to(resd.dtype)
        ret.reg_mask = out.mask
        ret.residuals = resd * m
        ret.observed_gradients = ograd * m
        ret.gradients = cgrad * m
    else:
        sdf, feat, resd, cpts = sdf.detach(), feat.detach(), resd.detach(), cpts.detach()
        with torch.no_grad():
            occ = sdf_to_occ(sdf, beta_of(params))
            norm = _normals(ograd, out, ctx)

    out.bpts = out.bpts.detach()
    out.cpts = cpts
    out.resd = resd
    out.norm = norm
    out.feat = feat
    out.cond = cond
    out.occ = occ
    out.sdf = sdf
    return ret, out


def forward(params, mcfg: AniSDFConfig, ctx: dict, x: torch.Tensor,
            v: torch.Tensor, training: bool = False) -> dotdict:
    """Network forward (base_network.py:496-515 / relight_network.py:91-120).
    Inference (under no_grad): ret.raw (P, C) = [cpts, bpts, resd, albedo,
    rough, norm, occ] (relight) or [cpts, bpts, resd, norm, rgb, occ], zero
    outside the band.  ``training`` (stage 1): ret.raw = [norm, rgb, occ]
    with the graph to the parameters, beside :func:`forward_geometry`'s
    training terms; the relight training outputs are ROADMAP item 10b."""
    if training:
        if mcfg.relight:
            raise NotImplementedError(
                "the relight network's training outputs (albedo, roughness and their "
                "jittered pair) are not ported yet (ROADMAP item 10b)")
        ret, out = forward_geometry(params, mcfg, ctx, x, v, training=True)
        rgb = render_rgb(params, mcfg, out.bvds, out.norm, out.feat, out.cond)
        raw = torch.cat([out.norm, rgb, out.occ], dim=-1)
        ret.raw = raw * out.mask[:, None]
        ret.mask = out.mask
        return ret
    with torch.no_grad():
        _, out = forward_geometry(params, mcfg, ctx, x, v)
        if mcfg.relight:
            albedo = albedo_head(params, mcfg, out.feat)
            rough = roughness_head(params, mcfg, out.feat)
            raw = torch.cat([albedo, rough, out.norm, out.occ], dim=-1)
        else:
            rgb = render_rgb(params, mcfg, out.bvds, out.norm, out.feat, out.cond)
            raw = torch.cat([out.norm, rgb, out.occ], dim=-1)
        raw = torch.cat([out.cpts, out.bpts, out.resd, raw], dim=-1)
        return dotdict(raw=raw * out.mask[:, None], mask=out.mask)
