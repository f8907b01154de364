"""Plain PyTorch reference of the avatar network: the body's frame context,
the positional encoding, the MLPs, linear blend skinning, the exact top-3
nearest vertices, the hierarchical distance query (HDQ) and the network
forward with autodiff normals.

A frozen copy of the exact float32 paths of the port's ``smpl/body_model``,
``models/context``, ``ops/{embedder,mlp,lbs,knn,sdf}`` and
``models/anisdf``, without their options (no bfloat16 route, no grouped or
bfloat16 KNN, no hash grid, no shadow-ray shortcuts).  It imports nothing
of the port: the benchmark holds the port to it.

``Net.precision`` sets how every linear layer multiplies: 'float32' (the
caller keeps TF32 off), or one of the controls: 'tf32' (the matmul's
operands rounded to TF32's 10-bit mantissa) and 'fp8' (each operand scaled
per tensor into float8 e4m3's range and rounded to it, the product summed
in float32; the gradient passes straight through the rounding).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32", "fp8")
FP8_MAX = 448.0


class FlopCount:
    """The FLOPs of what the reference computes while the count is on
    (``with COUNT:``): 2 x in x out a row of each linear layer, 8 a (point,
    vertex) pair of the KNN (``flops.train_step_flops``' convention), and
    the normals' input-gradient pass through the residual and SDF MLPs at
    their forward's FLOPs (one matmul a layer).  Encodings, skinning and
    elementwise work are not counted."""

    def __init__(self):
        self.on, self.flops = False, 0

    def __enter__(self):
        self.on, self.flops = True, 0
        return self

    def __exit__(self, *exc):
        self.on = False
        return False

    def add(self, n: int) -> None:
        if self.on:
            self.flops += int(n)


COUNT = FlopCount()


# ------------------------------------------------------------------ params
def load_params(path: str, device, relight: bool) -> dict:
    """The avatar's npz (flat ``a/b/c`` keys, linear weights (in, out)) as a
    nested dict of float32 leaves; the relight heads only when ``relight``."""
    params: dict = {}
    with np.load(path) as f:
        for key in sorted(f.files):
            if not relight and key.split("/")[0] in ("albedo", "roughness", "env"):
                continue
            *path_, leaf = key.split("/")
            node = params
            for part in path_:
                node = node.setdefault(part, {})
            node[leaf] = torch.as_tensor(f[key].astype(np.float32), device=device)
    for net in params.values():
        if isinstance(net, dict) and "layers" in net:
            net["layers"] = [net["layers"][str(i)] for i in range(len(net["layers"]))]
    return params


def named(params: dict, prefix: str = "") -> list:
    """(``a/b/c`` key, leaf) of every parameter."""
    out = []
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.extend(named(v, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", v))
    return out


# ------------------------------------------------------------------ body
def rodrigues(poses: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(poses + 1e-8, axis=1, keepdims=True)
    rx, ry, rz = np.split(poses / angle, 3, axis=1)
    cos, sin = np.cos(angle)[:, None], np.sin(angle)[:, None]
    z = np.zeros([poses.shape[0], 1])
    K = np.concatenate([z, -rz, ry, rz, z, -rx, -ry, rx, z], axis=1).reshape([-1, 3, 3])
    return (np.eye(3)[None] + sin * K + (1 - cos) * np.matmul(K, K)).astype(np.float32)


def rigid_transforms(poses: np.ndarray, joints: np.ndarray, parents: np.ndarray):
    """(A (J, 4, 4), posed joints (J, 3)) of the kinematic chain."""
    n = len(joints)
    rel = joints.copy()
    rel[1:] -= joints[parents[1:]]
    mats = np.concatenate([rodrigues(poses.reshape(-1, 3)), rel[..., None]], axis=2)
    pad = np.zeros([n, 1, 4])
    pad[..., 3] = 1
    mats = np.concatenate([mats, pad], axis=1)
    chain = [mats[0]]
    for i in range(1, n):
        chain.append(chain[parents[i]] @ mats[i])
    tr = np.stack(chain)
    rot_j = np.einsum('jab,jb->ja', tr, np.concatenate([joints, np.zeros([n, 1])], axis=1))
    tr = tr.copy()
    tr[..., 3] = tr[..., 3] - rot_j
    posed = tr[:, :3, 3] + np.einsum('jab,jb->ja', tr[:, :3, :3], joints)
    return tr.astype(np.float32), posed.astype(np.float32)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return (vn / np.clip(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12, None)
            ).astype(np.float32)


class Body:
    """The SMPL-H-style body: shaped, pose-corrected, skinned vertices."""

    def __init__(self, path: str):
        d = dict(np.load(path))
        self.v_template = d['v_template'].astype(np.float32)
        self.J_regressor = d['J_regressor'].astype(np.float32)
        self.weights = d['weights'].astype(np.float32)
        self.parents = d['parents'].astype(np.int64)
        self.faces = d['faces'].astype(np.int64)
        self.shapedirs = d['shapedirs'].astype(np.float32) if 'shapedirs' in d else None
        self.posedirs = d['posedirs'].astype(np.float32) if 'posedirs' in d else None

    def shaped(self, shapes):
        v = self.v_template
        if shapes is not None and self.shapedirs is not None and shapes.size:
            S = min(shapes.shape[-1], self.shapedirs.shape[-1])
            v = v + np.einsum('vds,s->vd', self.shapedirs[..., :S], shapes.reshape(-1)[:S])
        return v

    def verts(self, poses, shapes, Rh=None, Th=None):
        poses = np.asarray(poses, np.float32).reshape(-1, 3)
        v = self.shaped(shapes)
        J = self.J_regressor @ v
        if self.posedirs is not None:
            feat = (rodrigues(poses[1:]) - np.eye(3)[None]).reshape(-1)
            D = min(feat.shape[0], self.posedirs.shape[-1])
            v = v + np.einsum('vdp,p->vd', self.posedirs[..., :D], feat[:D])
        A, _ = rigid_transforms(poses, J, self.parents)
        A_bw = np.einsum('vj,jab->vab', self.weights, A)
        out = np.einsum('vab,vb->va', A_bw[:, :3, :3], v) + A_bw[:, :3, 3]
        if Rh is not None:
            out = out @ rodrigues(np.asarray(Rh, np.float32).reshape(1, 3))[0].T
        if Th is not None:
            out = out + np.asarray(Th, np.float32).reshape(1, 3)
        return out.astype(np.float32)


def bounds(xyz: np.ndarray, padding: float = 0.05) -> np.ndarray:
    return np.stack([xyz.min(0) - padding, xyz.max(0) + padding]).astype(np.float32)


def frame_context(body: Body, poses, Rh, Th, shapes, device) -> dict:
    """The frame's posed cloud, skinning table and bone transforms (bigpose:
    a 30 degree leg spread)."""
    n = body.weights.shape[1]
    tjoints = (body.J_regressor @ body.shaped(shapes)).astype(np.float32)
    big = np.zeros(n * 3, np.float32)
    big[5], big[8] = np.deg2rad(30), np.deg2rad(-30)
    big_A, _ = rigid_transforms(big.reshape(-1, 3), tjoints, body.parents)
    tverts = body.verts(big, shapes)
    poses = np.asarray(poses, np.float32).reshape(-1, 3)
    A, _ = rigid_transforms(poses, tjoints, body.parents)
    R = rodrigues(np.asarray(Rh, np.float32).reshape(1, 3))[0]
    Th = np.asarray(Th, np.float32).reshape(1, 3)
    wverts = body.verts(poses, shapes, Rh=Rh, Th=Th)
    pverts = ((wverts - Th) @ R).astype(np.float32)
    table = np.concatenate([pverts, vertex_normals(pverts, body.faces), tverts,
                            body.weights], axis=-1)
    arrays = dict(knn_table=table, pverts=pverts, R=R, Th=Th, poses=poses, A=A, big_A=big_A,
                  wbounds=bounds(wverts))
    return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32, device=device)
            for k, v in arrays.items()}


# ------------------------------------------------------------------ layers
def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], multires * 6)], dim=-1)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32's 10-bit mantissa (nearest, ties away), straight-through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Scale per tensor into e4m3's range, round, scale back; straight-through."""
    s = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    r = (x.detach() * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return x + (r - x).detach()


def linear(p: dict, x: torch.Tensor, prec: str = "float32") -> torch.Tensor:
    if "v" in p:
        w = p["v"] * (p["g"] / (torch.linalg.vector_norm(p["v"], dim=0) + 1e-12))
    else:
        w = p["w"]
    if prec == "tf32":
        x, w = _tf32(x), _tf32(w)
    elif prec == "fp8":
        x, w = _fp8(x), _fp8(w)
    COUNT.add(2 * (x.numel() // x.shape[-1]) * w.shape[0] * w.shape[1])
    return x @ w + p["b"]


def softplus100(x):
    return F.softplus(x, beta=100.0, threshold=20.0)


def mlp(p: dict, x, prec: str, act=torch.relu, skips=(4,)):
    inp = x
    n = len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        if i in skips:
            x = torch.cat([x, inp], dim=-1)
        x = linear(layer, x, prec)
        if i < n - 1:
            x = act(x)
    return x


def sdf_mlp(p: dict, x, prec: str, skips=(4,)):
    inp = x
    n = len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        if i in skips:
            x = torch.cat([x, inp], dim=-1) * (1.0 / math.sqrt(2.0))
        x = linear(layer, x, prec)
        if i < n - 1:
            x = softplus100(x)
    return x


# ------------------------------------------------------------------ LBS
def inverse_3x3(R, eps=1e-8):
    r = [[R[..., i, j] for j in range(3)] for i in range(3)]
    m00 = r[1][1] * r[2][2] - r[2][1] * r[1][2]
    m10 = -r[1][0] * r[2][2] + r[2][0] * r[1][2]
    m20 = r[1][0] * r[2][1] - r[2][0] * r[1][1]
    m01 = -r[0][1] * r[2][2] + r[2][1] * r[0][2]
    m11 = r[0][0] * r[2][2] - r[2][0] * r[0][2]
    m21 = -r[0][0] * r[2][1] + r[2][0] * r[0][1]
    m02 = r[0][1] * r[1][2] - r[1][1] * r[0][2]
    m12 = -r[0][0] * r[1][2] + r[1][0] * r[0][2]
    m22 = r[0][0] * r[1][1] - r[1][0] * r[0][1]
    D = r[0][0] * m00 + r[0][1] * m10 + r[0][2] * m20
    M = torch.stack([torch.stack([m00, m01, m02], -1), torch.stack([m10, m11, m12], -1),
                     torch.stack([m20, m21, m22], -1)], -2)
    return M / (D[..., None, None] + eps)


def normalize(v, eps=1e-8):
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps)


def _apply(M, v):
    return torch.einsum('pab,pb->pa', M, v)


def _apply_t(M, v):
    return torch.einsum('pba,pb->pa', M, v)


# ------------------------------------------------------------------ KNN
def knn_top3(pts: torch.Tensor, verts: torch.Tensor, block: int = 4096):
    """(P, 3) int64 ids of the 3 nearest vertices: squared distances by
    coordinate differences, ascending, ties to the lowest index."""
    COUNT.add(8 * pts.shape[0] * verts.shape[0])
    ids = []
    for s in range(0, pts.shape[0], block):
        p = pts[s:s + block]
        d2 = ((p[:, 0:1] - verts[None, :, 0]) ** 2 + (p[:, 1:2] - verts[None, :, 1]) ** 2
              + (p[:, 2:3] - verts[None, :, 2]) ** 2)
        js = []
        for _ in range(3):
            j = torch.argmin(d2, dim=1, keepdim=True)
            js.append(j)
            d2.scatter_(1, j, float("inf"))
        ids.append(torch.cat(js, dim=1))
    if not ids:
        return torch.zeros((0, 3), dtype=torch.int64, device=pts.device)
    return torch.cat(ids)


# ------------------------------------------------------------------ HDQ
class Net:
    """The network's sizes, the HDQ band (``dist_th``) and the matmuls'
    precision (one of :data:`PRECISIONS`)."""

    def __init__(self, xyz_res=10, sdf_res=8, view_res=4, resd_limit=0.05, dist_th=0.1,
                 blend_radius=0.075, albedo_slope=1.0, albedo_bias=0.0, roughness_slope=0.9,
                 roughness_bias=0.09, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.precision = precision
        self.xyz_res, self.sdf_res, self.view_res = xyz_res, sdf_res, view_res
        self.resd_limit, self.dist_th, self.blend_radius = resd_limit, dist_th, blend_radius
        self.albedo_slope, self.albedo_bias = albedo_slope, albedo_bias
        self.roughness_slope, self.roughness_bias = roughness_slope, roughness_bias

    @classmethod
    def from_cfg(cls, cfg, precision: str = "float32") -> "Net":
        return cls(cfg.xyz_res, cfg.sdf_res, cfg.view_res, cfg.resd_limit, cfg.dist_th,
                   cfg.blend_radius, cfg.albedo_slope, cfg.albedo_bias, cfg.roughness_slope,
                   cfg.roughness_bias, precision)


def knn_stage(ctx, ppts, th):
    """Neighbours, signed distances, geodesic filter, band mask and the SMPL
    fallback SDF of pose-space points."""
    nn = knn_top3(ppts, ctx["pverts"])
    tbl = ctx["knn_table"][nn]
    nverts, nnorm, tv, bw_k = tbl[..., 0:3], tbl[..., 3:6], tbl[..., 6:9], tbl[..., 9:]
    diff = ppts[:, None, :] - nverts
    d2 = torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0)
    sdf_k = torch.sqrt(d2) * torch.sign(torch.sum(diff * nnorm, dim=-1))
    geo_ok = torch.sum((tv - tv[:, :1]) ** 2, dim=-1) < th ** 2
    d2 = torch.where(geo_ok, d2, d2[:, :1])
    sdf_k = torch.where(geo_ok, sdf_k, sdf_k[:, :1])
    bw_k = torch.where(geo_ok[..., None], bw_k, bw_k[:, :1])
    mask = d2[:, 0] < th ** 2
    sgn = torch.sign(torch.sum(torch.sign(sdf_k), dim=-1, keepdim=True) + 0.5)
    smpl = sgn * torch.mean(torch.abs(sdf_k), dim=-1, keepdim=True)
    smpl = torch.where(smpl < -th, smpl, torch.abs(smpl))
    return d2, mask, smpl, bw_k


def warp(net: Net, ctx, ppts, d2, bw_k):
    """Pose -> t-pose -> bigpose by the Gaussian-blended skinning."""
    w = torch.exp(-d2 / (2 * net.blend_radius ** 2))
    w = w / (torch.sum(w, dim=-1, keepdim=True) + torch.finfo(w.dtype).eps)
    bw = torch.sum(w[..., None] * bw_k, dim=-2)
    big = torch.einsum('pj,jab->pab', bw, ctx["big_A"])
    A = torch.einsum('pj,jab->pab', bw, ctx["A"])
    R_inv = inverse_3x3(A[..., :3, :3])
    tpts = _apply(R_inv, ppts - A[..., :3, 3])
    bpts = _apply(big[..., :3, :3], tpts) + big[..., :3, 3]
    return bpts, A, R_inv, big


def to_pose(ctx, x):
    return (x - ctx["Th"]) @ ctx["R"]


def cond_of(ctx, n):
    c = ctx["poses"].reshape(-1)
    return c[None, :].expand(n, c.shape[0])


def residuals(params, net: Net, bpts, cond):
    x = torch.cat([positional_encoding(bpts, net.xyz_res), cond], dim=-1)
    return torch.tanh(mlp(params["resd"], x, net.precision)) * net.resd_limit


def sdf_feat(params, net: Net, cpts):
    out = sdf_mlp(params["sdf"], positional_encoding(cpts, net.sdf_res), net.precision)
    return out[..., :1], out[..., 1:]


def hdq_sdf(params, net: Net, ctx, x, dist_th=None):
    """(P, 1) world SDF: the network inside the band, blended by |sdf| / th
    toward the point-cloud fallback, which holds outside it."""
    th = net.dist_th if dist_th is None else dist_th
    ppts = to_pose(ctx, x)
    d2, mask, smpl, bw_k = knn_stage(ctx, ppts, th)
    sel = torch.nonzero(mask).squeeze(1)
    bpts, *_ = warp(net, ctx, ppts[sel], d2[sel], bw_k[sel])
    cpts = bpts + residuals(params, net, bpts, cond_of(ctx, bpts.shape[0]))
    s = sdf_feat(params, net, cpts)[0]
    r = torch.clamp(torch.abs(s) / th, 0.0, 1.0)
    s = smpl[sel] * r + s * (1 - r)
    return smpl.index_copy(0, sel, s)


def sdf_to_occ(sdf, beta, dists=0.005):
    x = -sdf
    ind0 = x <= 0
    zero = torch.zeros_like(x)
    sigma = (1 / beta * (0.5 * torch.exp(torch.where(ind0, x, zero) / beta)) * ind0
             + 1 / beta * (1 - 0.5 * torch.exp(-torch.where(~ind0, x, zero) / beta)) * ~ind0)
    return 1.0 - torch.exp(-torch.relu(sigma) * dists)


def forward(params, net: Net, ctx, x, v, training: bool, relight: bool):
    """The network at world points ``x`` seen along ``v``: returns (raw, terms).
    raw = [albedo, rough, norm, occ] (relight) or [norm, rgb, occ], zero
    outside the band; ``terms`` the training regularisers (masked)."""
    with torch.no_grad():
        ppts = to_pose(ctx, x)
        d2, mask, _, bw_k = knn_stage(ctx, ppts, net.dist_th)
        bpts0, A, R_inv, big = warp(net, ctx, ppts, d2, bw_k)
    cond = cond_of(ctx, x.shape[0])
    with torch.enable_grad():
        bpts = bpts0.detach().requires_grad_(True)
        counted = COUNT.flops
        resd = residuals(params, net, bpts, cond)
        cpts = bpts + resd
        sdf, feat = sdf_feat(params, net, cpts)
        if training:
            ograd, cgrad = torch.autograd.grad(sdf.sum(), [bpts, cpts], create_graph=True)
        else:
            (ograd,) = torch.autograd.grad(sdf.sum(), bpts)
            COUNT.add(COUNT.flops - counted)        # the normals' input-gradient pass
    if not training:
        sdf, feat = sdf.detach(), feat.detach()
    beta = torch.clamp(params["beta"], 1e-9, 1e6)
    occ = sdf_to_occ(sdf, beta)
    # the observed gradient's direction, bigpose -> t-pose -> pose -> world
    norm = _apply_t(big[..., :3, :3], normalize(ograd))
    norm = _apply_t(R_inv, norm)
    norm = normalize(norm @ ctx["R"].T)
    m = mask[:, None].to(sdf.dtype)
    terms = {}
    if training:
        terms = dict(reg_mask=mask, residuals=resd * m, observed_gradients=ograd * m,
                     gradients=cgrad * m)
    if relight:
        albedo = net.albedo_slope * torch.sigmoid(
            mlp(params["albedo"], feat, net.precision, softplus100, ())) + net.albedo_bias
        rough = net.roughness_slope * torch.sigmoid(
            mlp(params["roughness"], feat, net.precision, softplus100, ())) + net.roughness_bias
        raw = torch.cat([albedo, rough, norm, occ], dim=-1)
    else:
        p = params["rgb"]
        # the view direction, world -> pose -> t-pose -> bigpose
        vb = _apply_t(inverse_3x3(big[..., :3, :3]), _apply_t(A[..., :3, :3], v @ ctx["R"]))
        h = torch.cat([positional_encoding(vb, net.view_res), norm, feat], dim=-1)
        pr = net.precision
        h = torch.relu(linear(p["l0"], h, pr))
        h = torch.relu(linear(p["l1"], h, pr))
        h = torch.relu(linear(p["l2"], h, pr))
        h = torch.relu(linear(p["l3"], torch.cat([h, cond], dim=-1), pr))
        raw = torch.cat([norm, torch.sigmoid(linear(p["l4"], h, pr)), occ], dim=-1)
    return raw * m, terms
