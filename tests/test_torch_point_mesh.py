"""The port's point-to-mesh distance (``ops/point_mesh.py``) and the
``smpl_distance`` branch of ``hdq_sdf`` against the JAX package's, on the
fixture's canonical SMPL mesh and seeded points around it.

Closest points and squared distances within 1e-6 (closest points 1e-5); the
winning face equal but where two faces give the same distance to within
float32 rounding (a shared vertex or edge reached from several faces: 3.2 %
of these points); the signed distance within 1e-6 where the faces agree.
``hdq_sdf`` with ``smpl_distance`` within 1e-5 on the points whose top-3
sets agree (``tests/test_torch_anisdf.py``: the JAX exact KNN on the CPU
differs at near ties) and whose sign is well defined: the reference's sign
is the closest face's normal, and where faces of opposite signs tie for the
closest (12.4 % of these points, mostly at a shared vertex) either package
may take either.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.models.context import make_bigpose, make_frame_context
from relightableavatar_tpu.ops import point_mesh as jpm
from relightableavatar_tpu.ops.knn import knn_unchunked
from relightableavatar_tpu.smpl.body_model import BodyModel
from relightableavatar_tpu_torch.eval.golden import REPO, fixture_cfg, load_fixture
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops import point_mesh as ppm
from relightableavatar_tpu_torch.ops.knn import knn_top3

P = 2048
ATOL = 1e-6
TIE_D2 = 1e-6           # two faces this close in d2 are a tie in float32
MIN_SAME_FACE = 0.95    # share of points whose winning face is JAX's (measured 96.8 %)
HDQ_ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    """(tverts, faces, points): the fixture's bigpose SMPL mesh; P points,
    half near its vertices (N(0, 2 cm)), half in its padded box."""
    ctx, _, _ = load_fixture(fixture_cfg(), device="cpu")
    tv = ctx["tverts"].numpy()
    faces = ctx["faces"].numpy()
    rng = np.random.default_rng(3)
    near = tv[rng.integers(0, len(tv), P // 2)] + rng.normal(0, 0.02, (P // 2, 3))
    box = rng.uniform(tv.min(0) - 0.1, tv.max(0) + 0.1, (P // 2, 3))
    return tv, faces, np.concatenate([near, box]).astype(np.float32)


def _sign_ambiguous(q, verts, faces, chunk=64):
    """(P,) bool: points whose faces within TIE_D2 of the closest disagree
    on the sign of dot(q - closest, face normal)."""
    tris = verts[faces.long()]
    n = ppm.face_normals(verts, faces)
    out = []
    for s in range(0, q.shape[0], chunk):
        p = q[s:s + chunk]
        cp = ppm.closest_point_on_triangles(p[:, None], tris[None])     # (B, F, 3)
        d2 = ((p[:, None] - cp) ** 2).sum(-1)
        near = d2 <= d2.min(1, keepdim=True).values + TIE_D2
        sgn = torch.sign(((p[:, None] - cp) * n[None]).sum(-1))
        out.append(((near & (sgn > 0)).any(1) & (near & (sgn < 0)).any(1)).numpy())
    return np.concatenate(out)


def test_closest_point_on_triangles_matches_jax():
    rng = np.random.default_rng(0)
    tri = rng.normal(size=(4096, 3, 3)).astype(np.float32)
    p = rng.normal(size=(4096, 3)).astype(np.float32) * 2
    tri[:8, 2] = tri[:8, 1]                         # degenerate triangles
    got = ppm.closest_point_on_triangles(torch.as_tensor(p), torch.as_tensor(tri)).numpy()
    ref = np.asarray(jpm.closest_point_on_triangles(jnp.asarray(p), jnp.asarray(tri)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("block", [1024, 700])
def test_point_mesh_distance_matches_jax(mesh, block):
    tv, faces, pts = mesh
    d2, cp, fid = ppm.point_mesh_distance(torch.as_tensor(pts), torch.as_tensor(tv),
                                          torch.as_tensor(faces), block=block)
    jd2, jcp, jfid = (np.asarray(a) for a in jpm.point_mesh_distance(
        jnp.asarray(pts), jnp.asarray(tv), jnp.asarray(faces), block=block))
    assert fid.dtype == torch.int32 and d2.shape == (P,) and cp.shape == (P, 3)
    np.testing.assert_allclose(d2.numpy(), jd2, atol=ATOL, rtol=0)
    np.testing.assert_allclose(cp.numpy(), jcp, atol=ATOL * 10, rtol=0)
    same = fid.numpy() == jfid
    print(f"winning face equal to JAX's on {same.mean():.4%} of {P} points")
    assert same.mean() >= MIN_SAME_FACE, same.mean()
    # where the faces differ, the port's face is as close to the point as
    # JAX's, measured by JAX: a tie
    diff = np.flatnonzero(~same)
    for i in diff:
        other = np.asarray(jpm.point_mesh_distance(
            jnp.asarray(pts[i:i + 1]), jnp.asarray(tv),
            jnp.asarray(faces[fid.numpy()[i]][None]), block=1)[0])[0]
        assert abs(other - jd2[i]) <= TIE_D2, (i, other, jd2[i])


def test_point_mesh_distance_ties_go_to_the_first_face():
    """A face repeated in a later block and inside the same block: the
    first copy wins, as JAX's argmin and strict ``<`` decide."""
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    verts = np.concatenate([tri, tri + [5, 5, 5]])
    faces = np.array([[3, 4, 5], [0, 1, 2], [0, 1, 2], [3, 4, 5], [0, 2, 1]], np.int64)
    pts = np.array([[0.2, 0.2, 0.5], [0.2, 0.2, -0.5], [5.1, 5.1, 6]], np.float32)
    for block in (1, 2, 5):
        _, _, fid = ppm.point_mesh_distance(torch.as_tensor(pts), torch.as_tensor(verts),
                                            torch.as_tensor(faces), block=block)
        _, _, jfid = jpm.point_mesh_distance(jnp.asarray(pts), jnp.asarray(verts),
                                             jnp.asarray(faces), block=block)
        assert fid.tolist() == np.asarray(jfid).tolist() == [1, 1, 0]


def test_signed_mesh_distance_and_face_normals_match_jax(mesh):
    tv, faces, pts = mesh
    tvt, ft = torch.as_tensor(tv), torch.as_tensor(faces)
    np.testing.assert_allclose(ppm.face_normals(tvt, ft).numpy(),
                               np.asarray(jpm.face_normals(jnp.asarray(tv), jnp.asarray(faces))),
                               atol=ATOL, rtol=0)
    got = ppm.signed_mesh_distance(torch.as_tensor(pts), tvt, ft).numpy()
    ref = np.asarray(jpm.signed_mesh_distance(jnp.asarray(pts), jnp.asarray(tv),
                                              jnp.asarray(faces)))
    _, _, fid = ppm.point_mesh_distance(torch.as_tensor(pts), tvt, ft)
    _, _, jfid = jpm.point_mesh_distance(jnp.asarray(pts), jnp.asarray(tv), jnp.asarray(faces))
    same = fid.numpy() == np.asarray(jfid)
    np.testing.assert_allclose(got[same], ref[same], atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.abs(got), np.abs(ref), atol=ATOL, rtol=0)
    assert (got < 0).sum() > 50 and (got > 0).sum() > 50     # both sides of the surface


def test_hdq_sdf_with_smpl_distance_matches_jax():
    cfg = fixture_cfg()
    cfg.smpl_distance = True
    tctx, tparams, tmcfg = load_fixture(cfg, device="cpu")
    assert tmcfg.smpl_distance
    model = BodyModel(os.path.join(REPO, 'fixtures/synthetic_body.npz'))
    motion = dict(np.load(os.path.join(REPO, 'fixtures/synthetic_motion.npz')))
    sh = motion['shapes'][0]
    tv, tj, bA, _ = make_bigpose(model, sh)
    jctx = make_frame_context(model, tv, tj, bA, motion['poses'][0],
                              motion['Rh'][0], motion['Th'][0], sh)
    jmcfg = j_anisdf.AniSDFConfig(n_bones=52, cond_dim=156, sdf_res=8, dist_th=0.125,
                                  relight=True, knn_exact=True, smpl_distance=True)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    rng = np.random.default_rng(5)
    pv = tctx["pverts"].numpy()
    R, Th = tctx["R"].numpy(), tctx["Th"].numpy()
    x = ((pv[rng.integers(0, len(pv), 1024)] + rng.normal(0, 0.05, (1024, 3))) @ R.T
         + Th).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(j_anisdf.hdq_sdf, static_argnums=1)(
            jparams, jmcfg, jctx, jnp.asarray(x)))
    got = anisdf.hdq_sdf(tparams, tmcfg, tctx, torch.as_tensor(x)).numpy()
    net = anisdf.hdq_sdf(tparams, tmcfg._replace(smpl_distance=False), tctx,
                         torch.as_tensor(x)).numpy()
    ppts = (x - Th) @ R
    _, jnn = knn_unchunked(jnp.asarray(ppts), jctx["pverts"], K=3, exact=True)
    _, tnn = knn_top3(torch.as_tensor(ppts), tctx["pverts"])
    same = (np.sort(np.asarray(jnn), 1) == np.sort(tnn.numpy(), 1)).all(1)
    assert same.mean() >= 0.99
    # the points the branch measures: bigpose points plus residuals; where
    # faces of opposite signs tie for the closest, the sign is ill-defined
    # (a face normal at a shared vertex or edge) and may differ
    with torch.no_grad():
        out = anisdf.world_to_bigpose(tmcfg, tctx, torch.as_tensor(x))
        cond = anisdf.condition_vector(tctx)[None].expand(len(x), tmcfg.cond_dim)
        q = out.bpts + anisdf.residuals(tparams, tmcfg, out.bpts, cond)
    ambiguous = _sign_ambiguous(q, tctx["tverts"], tctx["faces"])
    rows = same & ~ambiguous
    print(f"sign-ambiguous points {ambiguous.mean():.4%}, compared {rows.mean():.4%}")
    assert rows.mean() >= 0.8 and out.mask.numpy().mean() > 0.5     # measured 87.6 %
    np.testing.assert_allclose(got[rows], ref[rows], atol=HDQ_ATOL, rtol=0)
    assert np.abs(got - net).max() > 1e-3     # the branch replaced the network's SDF
