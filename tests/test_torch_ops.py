"""The port's ops against the JAX package's, on the same numpy inputs.

One case per function, grouped by op family; float32 on both sides, JAX
matmuls at 'highest' precision.  Tolerance atol = rtol = 1e-5: the two
frameworks round sums and transcendental functions differently in the
last bits, nothing more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightableavatar_tpu.ops import aabb as j_aabb
from relightableavatar_tpu.ops import brdf as j_brdf
from relightableavatar_tpu.ops import embedder as j_emb
from relightableavatar_tpu.ops import envmap as j_env
from relightableavatar_tpu.ops import lbs as j_lbs
from relightableavatar_tpu.ops import mlp as j_mlp
from relightableavatar_tpu.ops import sdf as j_sdf
from relightableavatar_tpu.renderer import tracing as j_tr
from relightableavatar_tpu_torch.ops import aabb as t_aabb
from relightableavatar_tpu_torch.ops import brdf as t_brdf
from relightableavatar_tpu_torch.ops import embedder as t_emb
from relightableavatar_tpu_torch.ops import envmap as t_env
from relightableavatar_tpu_torch.ops import lbs as t_lbs
from relightableavatar_tpu_torch.ops import mlp as t_mlp
from relightableavatar_tpu_torch.ops import sdf as t_sdf
from relightableavatar_tpu_torch.renderer import tracing as t_tr

ATOL = RTOL = 1e-5


def _r(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _rot(seed, n):
    """n well-conditioned 4x4 transforms: rotation-ish 3x3 + translation."""
    a = np.eye(3, dtype=np.float32) + _r(seed, n, 3, 3, scale=0.2)
    A = np.zeros((n, 4, 4), np.float32)
    A[:, :3, :3] = a
    A[:, :3, 3] = _r(seed + 1, n, 3)
    A[:, 3, 3] = 1
    return A


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(x)


def _mlp_params(seed, d_in, W, D, out, skips=(4,), wn=False):
    layers_j, layers_t = [], []
    for i in range(D + 1):
        I = d_in if i == 0 else W
        if i in skips:
            I = d_in + W
        O = out if i == D else W
        w = _r(seed + i, I, O, scale=1 / np.sqrt(I))
        b = _r(seed + 100 + i, O, scale=0.1)
        if wn:
            g = np.abs(_r(seed + 200 + i, O)) + 0.5
            p = {"v": w, "g": g, "b": b}
        else:
            p = {"w": w, "b": b}
        layers_j.append({k: _j(v) for k, v in p.items()})
        layers_t.append({k: _t(v) for k, v in p.items()})
    return {"layers": layers_j}, {"layers": layers_t}


# ---------------------------------------------------------------- families
def _embedder(name):
    x = _r(0, 64, 3)
    res = int(name.split("_")[-1])
    return j_emb.positional_encoding(_j(x), res), t_emb.positional_encoding(_t(x), res)


def _mlp(name):
    x = _r(1, 128, 19)
    if name == "linear_apply_weight_norm":
        pj, pt = _mlp_params(2, 19, 32, 0, 32, wn=True)
        return j_mlp.linear_apply(pj["layers"][0], _j(x)), t_mlp.linear_apply(pt["layers"][0], _t(x))
    if name == "fold_weight_norm":
        pj, pt = _mlp_params(3, 19, 32, 0, 32, wn=True)
        return j_mlp.fold_weight_norm(pj["layers"][0])["w"], t_mlp.fold_weight_norm(pt["layers"][0])
    if name == "softplus100":
        z = _r(4, 4096, scale=0.3)
        return j_mlp.softplus100(_j(z)), t_mlp.softplus100(_t(z))
    if name == "mlp_apply_skip":
        pj, pt = _mlp_params(5, 19, 32, 8, 3)
        return j_mlp.mlp_apply(pj, _j(x)), t_mlp.mlp_apply(pt, _t(x))
    if name == "mlp_apply_softplus_head":
        pj, pt = _mlp_params(6, 19, 32, 2, 3, skips=())
        return (j_mlp.mlp_apply(pj, _j(x), actvn="softplus100", skips=()),
                t_mlp.mlp_apply(pt, _t(x), actvn="softplus100", skips=()))
    if name == "ssdf_apply":
        # the SSDF layer before the skip emits W - d_in
        lj, lt = [], []
        dims = [19] + [32] * 8 + [5]
        for i in range(9):
            O = dims[i + 1] - dims[0] if i + 1 == 4 else dims[i + 1]
            p = {"v": _r(7 + i, dims[i], O, scale=1 / np.sqrt(dims[i])),
                 "g": np.abs(_r(30 + i, O)) + 0.5, "b": _r(60 + i, O, scale=0.1)}
            lj.append({k: _j(v) for k, v in p.items()})
            lt.append({k: _t(v) for k, v in p.items()})
        return j_mlp.ssdf_apply({"layers": lj}, _j(x)), t_mlp.ssdf_apply({"layers": lt}, _t(x))
    raise KeyError(name)


def _lbs(name):
    n, J = 64, 5
    A = _rot(10, n)
    R3 = A[:, :3, :3]
    pts = _r(11, n, 3)
    bw = np.abs(_r(12, n, J))
    bw /= bw.sum(-1, keepdims=True)
    AJ = _rot(13, J)
    R = _rot(14, 1)[0, :3, :3]
    Th = _r(15, 1, 3)
    if name == "affine_inverse":
        return j_lbs.affine_inverse(_j(A)), t_lbs.affine_inverse(_t(A))
    if name == "inverse_3x3":
        return j_lbs.inverse_3x3(_j(R3)), t_lbs.inverse_3x3(_t(R3))
    if name == "blend_transform":
        return j_lbs.blend_transform(_j(bw), _j(AJ)), t_lbs.blend_transform(_t(bw), _t(AJ))
    if name in ("world_points_to_pose_points", "pose_points_to_world_points"):
        return (getattr(j_lbs, name)(_j(pts), _j(R), _j(Th)),
                getattr(t_lbs, name)(_t(pts), _t(R), _t(Th)))
    if name in ("world_dirs_to_pose_dirs", "pose_dirs_to_world_dirs"):
        return getattr(j_lbs, name)(_j(pts), _j(R)), getattr(t_lbs, name)(_t(pts), _t(R))
    if name in ("pose_points_to_tpose_points", "tpose_points_to_pose_points",
                "pose_dirs_to_tpose_dirs", "tpose_dirs_to_pose_dirs"):
        return getattr(j_lbs, name)(_j(pts), _j(A)), getattr(t_lbs, name)(_t(pts), _t(A))
    if name == "normalize":
        v = pts.copy()
        v[0] = 0.0
        return j_lbs.normalize(_j(v)), t_lbs.normalize(_t(v))
    raise KeyError(name)


def _sdf(name):
    sdf = _r(20, 256, 1, scale=0.02)
    beta = np.float32(0.01)
    if name == "sdf_to_occ":
        return j_sdf.sdf_to_occ(_j(sdf), _j(beta)), t_sdf.sdf_to_occ(_t(sdf), _t(beta))
    if name == "volume_rendering":
        rgb = _r(21, 64, 3, 4)
        alpha = np.clip(np.abs(_r(22, 64, 3)), 0, 0.99)
        return (jnp.concatenate([a.reshape(64, -1) for a in j_sdf.volume_rendering(
                    _j(rgb), _j(alpha), bg_brightness=0.5)], -1),
                torch.cat([a.reshape(64, -1) for a in t_sdf.volume_rendering(
                    _t(rgb), _t(alpha), bg_brightness=0.5)], -1))
    raise KeyError(name)


def _aabb(name):
    bounds = np.array([[-0.5, -0.4, 0.0], [0.5, 0.4, 1.8]], np.float32)
    ro = _r(30, 128, 3) * 2 + np.array([0, 0, 0.9], np.float32)
    rd = _r(31, 128, 3)
    rd[:8, 0] = 0.0       # axis-parallel rays take the reference's eps clamps
    rd[8:16, 1] = -0.0
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    nj, fj, hj = j_aabb.get_near_far_aabb(_j(bounds), _j(ro), _j(rd))
    nt, ft, ht = t_aabb.get_near_far_aabb(_t(bounds), _t(ro), _t(rd))
    assert (np.asarray(hj) == ht.numpy()).all()
    hit = np.array(hj)
    return (jnp.stack([nj, fj], -1)[hit], torch.stack([nt, ft], -1)[torch.as_tensor(hit)])


def _brdf(name):
    P, L = 32, 8
    pts2l = _r(40, P, L, 3)
    pts2c = _r(41, P, 3)
    normal = _r(42, P, 3)
    albedo = np.abs(_r(43, P, 3)) * 0.5
    rough = np.abs(_r(44, P, 1)) * 0.5 + 0.1
    args = [pts2l, pts2c, normal, albedo, rough]
    if name == "safe_divide":
        a = _r(45, 256, scale=1e-7)
        b = _r(46, 256, scale=1e-7)
        b[:4] = 0.0
        return j_brdf.safe_divide(_j(a), _j(b)), t_brdf.safe_divide(_t(a), _t(b))
    if name == "evaluate_shade":
        lvis, ldot, area, light = _r(47, P, L), _r(48, P, L), np.abs(_r(49, L)), _r(50, P, L, 3)
        return (j_brdf.evaluate_shade(*map(_j, (lvis, ldot, area, light))),
                t_brdf.evaluate_shade(*map(_t, (lvis, ldot, area, light))))
    kw = {"microfacet_brdf": {}, "microfacet_brdf_no_cancel": {"cancel_cosine": False},
          "microfacet_brdf_lambert": {"lambert_only": True},
          "microfacet_brdf_glossy": {"glossy_only": True, "f0": 0.02}}[name]
    return (j_brdf.microfacet_brdf(*map(_j, args), **kw),
            t_brdf.microfacet_brdf(*map(_t, args), **kw))


def _envmap(name):
    img = np.abs(_r(60, 16, 32, 3))
    if name == "gen_light_xyz":
        xj, aj = j_env.gen_light_xyz(16, 32, 10.0)
        xt, at = t_env.gen_light_xyz(16, 32, 10.0)
        return jnp.concatenate([xj.reshape(-1), aj.reshape(-1)]), torch.cat([xt.reshape(-1), at.reshape(-1)])
    if name == "sample_envmap_image":
        d = _r(61, 512, 3)
        d[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 1e-9, 0]]
        return j_env.sample_envmap_image(_j(img), _j(d)), t_env.sample_envmap_image(_t(img), _t(d))
    if name == "probe_at_texels":
        xj, _ = j_env.gen_light_xyz(4, 8, 10.0)
        xt, _ = t_env.gen_light_xyz(4, 8, 10.0)
        return j_env.probe_at_texels(_j(img), xj), t_env.probe_at_texels(_t(img), xt)
    if name == "lvis_upsample_matrix":
        return _j(j_env.lvis_upsample_matrix(2, 4, 16, 32)), _t(t_env.lvis_upsample_matrix(2, 4, 16, 32))
    x = np.linspace(-0.1, 1.2, 1000, dtype=np.float32)
    return getattr(j_env, name)(_j(x)), getattr(t_env, name)(_t(x))


def _tracing(name):
    """Traces against an analytic sphere (radius 0.5 at the origin): hard
    surface trace, soft DFSS trace with Claybook, and the softer tracer."""
    P = 256
    ro = _r(70, P, 3)
    ro = ro / np.linalg.norm(ro, axis=-1, keepdims=True) * 2.0
    tgt = _r(71, P, 3, scale=0.4)
    rd = tgt - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full(P, 0.5, np.float32)
    far = np.full(P, 3.5, np.float32)
    tan_i = np.abs(_r(72, P, 1)) * 20 + 2
    sd_j = lambda x: jnp.linalg.norm(x, axis=-1, keepdims=True) - 0.5
    sd_t = lambda x: torch.linalg.vector_norm(x, dim=-1, keepdim=True) - 0.5
    st = {"sphere_trace_hard": dict(iter=16),
          "sphere_trace_soft": dict(iter=8, offset=0.01, relax=0.1),
          "softer_shadow": dict(iter=8)}[name]
    jst, tst = j_tr.STConfig(**st), t_tr.STConfig(**st)
    if name == "softer_shadow":
        oj = j_tr.softer_shadow(sd_j, _j(ro), _j(rd), _j(near), _j(far), jst, tan_i=_j(tan_i))
        ot = t_tr.softer_shadow(sd_t, _t(ro), _t(rd), _t(near), _t(far), tst, tan_i=_t(tan_i))
    else:
        soft = name == "sphere_trace_soft"
        oj = j_tr.sphere_trace(sd_j, _j(ro), _j(rd), _j(near), _j(far), jst,
                               tan_i=_j(tan_i), soft_shadow=soft)
        ot = t_tr.sphere_trace(sd_t, _t(ro), _t(rd), _t(near), _t(far), tst,
                               tan_i=_t(tan_i), soft_shadow=soft)
    return jnp.concatenate(oj, -1), torch.cat(ot, -1)


FAMILIES = {
    "embedder": (_embedder, ["positional_encoding_0", "positional_encoding_4",
                             "positional_encoding_10"]),
    "mlp": (_mlp, ["linear_apply_weight_norm", "fold_weight_norm", "softplus100",
                   "mlp_apply_skip", "mlp_apply_softplus_head", "ssdf_apply"]),
    "lbs": (_lbs, ["affine_inverse", "inverse_3x3", "blend_transform",
                   "world_points_to_pose_points", "pose_points_to_world_points",
                   "world_dirs_to_pose_dirs", "pose_dirs_to_world_dirs",
                   "pose_points_to_tpose_points", "tpose_points_to_pose_points",
                   "pose_dirs_to_tpose_dirs", "tpose_dirs_to_pose_dirs",
                   "normalize"]),
    "sdf": (_sdf, ["sdf_to_occ", "volume_rendering"]),
    "aabb": (_aabb, ["get_near_far_aabb"]),
    "brdf": (_brdf, ["safe_divide", "evaluate_shade", "microfacet_brdf",
                     "microfacet_brdf_no_cancel", "microfacet_brdf_lambert",
                     "microfacet_brdf_glossy"]),
    "envmap": (_envmap, ["gen_light_xyz", "sample_envmap_image", "probe_at_texels",
                         "lvis_upsample_matrix", "linear2srgb", "srgb2linear"]),
    "tracing": (_tracing, ["sphere_trace_hard", "sphere_trace_soft", "softer_shadow"]),
}
CASES = [(fam, name) for fam, (_, names) in FAMILIES.items() for name in names]


@pytest.mark.parametrize("family,name", CASES, ids=[f"{f}-{n}" for f, n in CASES])
def test_op_matches_jax(family, name):
    with jax.default_matmul_precision("highest"):
        ref, got = FAMILIES[family][0](name)
        ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
