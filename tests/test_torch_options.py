"""The HDQ, shadow-ray and camera-trace options of the port against the JAX
package's on the CPU: the KNN routes of ``tpu.knn_impl`` ('xla', 'grouped')
and ``sample_vert_cnt`` > 3, the vertex groups and subsample, the HDQ with
``skip_resd``, ``compact`` and ``verts_sub``, the tracer's pre-march, and
``render_human_block`` under each option and ablation.

Scene: fixture frame 0 (``golden.load_fixture``), 4096 world points around
the posed vertices (N(0, 5 cm)) for the KNN and HDQ, the 256-ray golden
bundle (6 surface / 2 shadow iterations, 2x4 lights, shadow blocks of 1024
rays) for the renders, and for the ablations a 256-ray bundle from 0.45 m
beside the body (``golden.near_bundle_rays``: the 'can' ablation's
transform of a camera ray 2 m away underflows to zero in both packages).

Selection, where the two packages' own rules differ by construction:
- JAX's ``knn_select`` takes the K smallest of its bfloat16 matrix with
  ``approx_min_k``, on the CPU a full sort that is not stable; the port's
  matrix is the same to the bit and its sort stable.  Rows may differ
  where bfloat16 values tie (:data:`MAX_TIE_SHARE`).
- JAX's exact route on the CPU for K != 3 (and K = 3 with ``knn_exact``)
  is the ``|p|^2 - 2 p.v + |v|^2`` matmul identity, which may pick another
  member of a near tie than the port's coordinate differences.
So the renders give the JAX side the port's selection rule where the
subsample or 'xla' route asks for it: the exact top K by coordinate
difference (``test_torch_mesh.exact_knn``) where the port takes K1 on the
subsample, the bfloat16 matrix with ties to the lower index where the port
takes 'xla'.  The KNN and HDQ tests, and the render at sample_vert_cnt 4,
hold the port against JAX's own routes.

Bars: every map >= 100 dB against JAX's but two.  ``spec_map`` divides by
|ldot| + 1e-8 at grazing texels (ROADMAP, "spec_map parity"): it is held
to SPEC_REL of each pixel's value (measured 1.1 % on the 'can' bundle, a
6e-5 normal difference at a texel 1e-3 from grazing, where it reaches
137).  ``acc_map`` is 1 - occ, the camera trace's cone occlusion
d tan_i / 2t: >= 100 dB on the rays that are not partly covered on either
side (measured: equal), and the partly covered (silhouette) rays held by
the distance they stand for, |d acc| 2 far / tan_i <= TRACE_ATOL, as the
pre-march trace holds occ (measured <= 9.7e-7 m; the whole map 97.52 to
103.24 dB, since tan_i / 2t is several hundred).  HDQ values within 1e-4
where the neighbour sets agree; the pre-march trace within 1e-5 m, its
occlusion as the distance it stands for (occ * 2t / tan_i).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from test_torch_mesh import exact_knn
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.ops import knn as j_knn
from relightableavatar_tpu.ops import sdf_grid as j_grid
from relightableavatar_tpu.ops.envmap import gen_light_xyz as j_gen_light_xyz
from relightableavatar_tpu.renderer import tracing as j_tracing
from relightableavatar_tpu.renderer.sphere_tracing import (RelightRenderConfig as JRcfg,
                                                           render_human_block as j_render)
from relightableavatar_tpu.renderer.tracing import STConfig as JSTConfig
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops import knn
from relightableavatar_tpu_torch.ops.sdf_grid import (axis_resolutions, build_hdq_grid,
                                                      grid_sdf, grid_sdf_lower_bound)
from relightableavatar_tpu_torch.renderer import tracing
from relightableavatar_tpu_torch.renderer.sphere_tracing import (RelightRenderConfig,
                                                                 render_human_block)
from relightableavatar_tpu_torch.renderer.tracing import STConfig

P = 4096
SELECT_P = 2048             # points of the knn_select comparison
MAX_TIE_SHARE = 0.08        # rows of knn_select whose bf16 K values tie (measured 4.54 %)
MAX_SET_DIFF = 0.01         # points whose exact top-K sets differ between the routes
HDQ_ATOL = 1e-4
TRACE_ATOL = 1e-5
MIN_PSNR = 100.0
TAN_I = STConfig.from_cfg(jax_cfg().sphere_tracing).tan_i   # the camera trace's cone
SPEC_REL = 0.02             # spec_map: max |diff| / max(|JAX|, 1) a pixel
GRID = 48


@pytest.fixture(scope="module")
def scene():
    ctx, params, mcfg = golden.load_fixture(device="cpu")
    rng = np.random.default_rng(1)
    pv = ctx["pverts"].numpy()
    ppts = (pv[rng.integers(0, len(pv), P)] + rng.normal(0, 0.05, (P, 3))).astype(np.float32)
    R, Th = ctx["R"].numpy(), ctx["Th"].numpy()
    x = (ppts @ R.T + Th).astype(np.float32)
    jparams, jmcfg, jctx = jax_scene(jax_cfg())
    return dict(ctx=ctx, params=params, mcfg=mcfg, ppts=ppts, x=x,
                jparams=jparams, jmcfg=jmcfg, jctx=jctx)


# ------------------------------------------------------------- JAX selections
def _bf16_matrix(pts, verts):
    return ((pts[:, 0:1] - verts[None, :, 0]).astype(jnp.bfloat16) ** 2
            + (pts[:, 1:2] - verts[None, :, 1]).astype(jnp.bfloat16) ** 2
            + (pts[:, 2:3] - verts[None, :, 2]).astype(jnp.bfloat16) ** 2)


def _select_bf16_stable(pts, verts, K=3):
    # lax.top_k puts the lower index first among equal values
    return jax.lax.top_k(-_bf16_matrix(pts, verts), K)[1].astype(jnp.int32)


def _select_exact(pts, verts, K=3):
    return exact_knn(pts, verts, K)[1]


@contextlib.contextmanager
def jax_selection(select=None):
    """The JAX package with ``knn_select`` replaced by ``select`` (none: as
    it is); the jit caches of the functions that reach it are cleared
    around a replacement, so that no trace of the other rule is reused."""
    if select is None:
        yield
        return
    jitted = (j_render, j_grid.build_hdq_grid)
    for f in jitted:
        f.clear_cache()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_knn, "knn_select", select)
        yield
    for f in jitted:
        f.clear_cache()


# ------------------------------------------------------------- KNN routes
def test_knn_select_differs_from_jax_only_on_bf16_ties(scene):
    verts = scene["ctx"]["pverts"]
    ppts = scene["ppts"][:SELECT_P]
    pts = torch.as_tensor(ppts)
    got = knn.knn_select(pts, verts, 3).numpy()
    ref = np.asarray(j_knn.knn_select(jnp.asarray(ppts), jnp.asarray(verts.numpy()), K=3))
    d = [(pts[:, i:i + 1] - verts[None, :, i]).to(torch.bfloat16) for i in range(3)]
    d2 = ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]).float().numpy()
    np.testing.assert_array_equal(d2, np.asarray(_bf16_matrix(jnp.asarray(ppts),
                                                              jnp.asarray(verts.numpy())),
                                                 np.float32))
    rows = ~(got == ref).all(1)
    # every differing row holds the same K bf16 values in the same order
    np.testing.assert_array_equal(np.take_along_axis(d2, got, 1)[rows],
                                  np.take_along_axis(d2, ref.astype(np.int64), 1)[rows])
    print(f"knn_select rows differing on bf16 ties: {rows.mean():.4%} of {SELECT_P}")
    assert rows.mean() <= MAX_TIE_SHARE


def test_vertex_groups_and_subsample_equal_jax(scene):
    pv = scene["ctx"]["pverts"].numpy()
    gvid, gmask = knn.build_vertex_groups(pv)
    jgvid, jgmask = j_knn.build_vertex_groups(pv)
    np.testing.assert_array_equal(gvid, jgvid)
    np.testing.assert_array_equal(gmask, jgmask)
    for a, b in zip(knn.group_frame_arrays(pv, gvid, gmask),
                    j_knn.group_frame_arrays(pv, jgvid, jgmask)):
        np.testing.assert_array_equal(a, b)
    sub = knn.subsample_verts(gvid, gmask, 4)
    np.testing.assert_array_equal(sub, j_knn.subsample_verts(jgvid, jgmask, 4))
    assert sub.shape == (2048,) and len(np.unique(sub)) == 2048
    for k in ("knn_gvid", "knn_gverts", "knn_gcent", "knn_gradius", "knn_sub_ids"):
        np.testing.assert_array_equal(scene["ctx"][k].numpy(), np.asarray(scene["jctx"][k]))


@pytest.mark.parametrize("K", [3, 4])
def test_knn_grouped_equals_jax(scene, K):
    ctx = scene["ctx"]
    args = [ctx[k] for k in ("knn_gverts", "knn_gcent", "knn_gradius", "knn_gvid")]
    d2, idx = knn.knn_grouped(torch.as_tensor(scene["ppts"]), *args, K=K)
    with jax.default_matmul_precision("highest"):
        jd2, jidx = j_knn.knn_grouped(jnp.asarray(scene["ppts"]),
                                      *[jnp.asarray(a.numpy()) for a in args], K=K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))


def test_knn_topk_is_exact(scene):
    pts = torch.as_tensor(scene["ppts"][:512])
    verts = scene["ctx"]["pverts"]
    d2, idx = knn.knn(pts, verts, K=5)
    full = ((pts[:, None, :].double() - verts[None].double()) ** 2).sum(-1)
    assert idx.shape == (512, 5) and idx.dtype == torch.int32
    np.testing.assert_allclose(d2.numpy(), torch.gather(full, 1, idx.long()).numpy(),
                               rtol=1e-5, atol=1e-9)
    ref = full.sort(1).values[:, :5]
    np.testing.assert_allclose(d2.numpy(), ref.numpy(), rtol=1e-5, atol=1e-9)
    d3, i3 = knn.knn(pts, verts, K=3)
    assert torch.equal(i3, idx[:, :3]) and torch.equal(d3, d2[:, :3])


# ------------------------------------------------------------- HDQ options
def _set_agree(scene, K, j_ids):
    _, t = knn.knn(torch.as_tensor(scene["ppts"]), scene["ctx"]["pverts"], K=K)
    return (np.sort(np.asarray(j_ids), 1) == np.sort(t.numpy(), 1)).all(1)


def _jax_hdq(scene, mcfg, **kw):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(lambda p, c, x: j_anisdf.hdq_sdf(p, mcfg, c, x, **kw))(
            scene["jparams"], scene["jctx"], jnp.asarray(scene["x"])))


def test_hdq_k4_matches_jax(scene):
    """sample_vert_cnt 4 against JAX's exact route (the matmul identity)
    where the top-4 sets agree."""
    jm = scene["jmcfg"]._replace(sample_vert_cnt=4)
    ref = _jax_hdq(scene, jm)
    got = anisdf.hdq_sdf(scene["params"], scene["mcfg"]._replace(sample_vert_cnt=4),
                         scene["ctx"], torch.as_tensor(scene["x"])).numpy()
    _, jnn = j_knn.knn_unchunked(jnp.asarray(scene["ppts"]), scene["jctx"]["pverts"],
                                 K=4, exact=True)
    same = _set_agree(scene, 4, jnn)
    print(f"top-4 sets differ on {1 - same.mean():.4%}; max |dSDF| "
          f"{np.abs(got - ref)[same].max():.2e}")
    assert 1 - same.mean() <= MAX_SET_DIFF
    assert np.abs(got - ref)[same].max() <= HDQ_ATOL


HDQ_CASES = {
    "skip_resd": dict(skip_resd=True),
    "compact": dict(compact=1024),
    "compact_skip_resd": dict(compact=1024, skip_resd=True),
    "verts_sub": dict(verts_sub=True),
    "world": dict(hierarchical=False),
}


@pytest.mark.parametrize("case", list(HDQ_CASES))
def test_hdq_options_match_jax(scene, case):
    """hdq_sdf with each option against JAX's with ``knn_exact=True``, where
    the exact top-3 sets agree; ``verts_sub`` with JAX's subsample selection
    made the exact one (the port's K1 on the subsample)."""
    kw = HDQ_CASES[case]
    select = _select_exact if case == "verts_sub" else None
    with jax_selection(select):
        ref = _jax_hdq(scene, scene["jmcfg"], smooth_transition=True, **kw)
    got = anisdf.hdq_sdf(scene["params"], scene["mcfg"], scene["ctx"],
                         torch.as_tensor(scene["x"]), smooth_transition=True, **kw).numpy()
    _, jnn = j_knn.knn_unchunked(jnp.asarray(scene["ppts"]), scene["jctx"]["pverts"],
                                 K=3, exact=True)
    same = _set_agree(scene, 3, jnn)
    err = np.abs(got - ref)[same]
    print(f"{case}: max |dSDF| {err.max():.2e} on {same.sum()} points")
    assert got.shape == ref.shape == (P, 1) and np.isfinite(got).all()
    assert err.max() <= HDQ_ATOL
    if case.startswith("compact"):
        # the budget binds: band points left out keep the SMPL fallback
        full = anisdf.hdq_sdf(scene["params"], scene["mcfg"], scene["ctx"],
                              torch.as_tensor(scene["x"]), smooth_transition=True,
                              skip_resd=kw.get("skip_resd", False)).numpy()
        assert (got != full).any() and (got == full).any()


def test_compact_budget_keeps_the_closest_points(scene):
    """compact = M < P sends the band points among the M of smallest nearest
    distance (a stable sort) through the network, with the values of the
    plain query; every other point keeps the SMPL point-cloud fallback."""
    M = 1024
    mcfg, ctx = scene["mcfg"], scene["ctx"]
    x = torch.as_tensor(scene["x"])
    got = anisdf.hdq_sdf(scene["params"], mcfg, ctx, x, smooth_transition=False, compact=M)
    full = anisdf.hdq_sdf(scene["params"], mcfg, ctx, x, smooth_transition=False)
    d2, _, _, mask, smpl_sdf, _ = anisdf._hdq_knn_stage(mcfg, ctx, torch.as_tensor(scene["ppts"]),
                                                        mcfg.dist_th)
    chosen = torch.zeros(P, dtype=torch.bool)
    chosen[torch.argsort(d2[:, 0], stable=True)[:M]] = True
    net = chosen & mask
    assert net.sum() > 0 and (mask & ~chosen).sum() > 0      # the budget binds
    np.testing.assert_allclose(got[net].numpy(), full[net].numpy(), atol=1e-6, rtol=0)
    assert not torch.equal(got[net], smpl_sdf[net])
    assert torch.equal(got[~net], smpl_sdf[~net])


# ------------------------------------------------------------- pre-march
def test_sphere_trace_premarch_matches_jax(scene):
    ctx = scene["ctx"]
    gbox = ctx["wbounds"].clone()
    gbox[0] -= 0.05
    gbox[1] += 0.05
    res = axis_resolutions((gbox[1] - gbox[0]).numpy(), 24)
    grid = build_hdq_grid(scene["params"], scene["mcfg"], ctx, gbox[0], gbox[1], res, 0.125,
                          packed=True)
    ray_o, ray_d = golden.golden_bundle_rays(ctx)
    st = STConfig(iter=4)
    lo, hi = gbox[0], gbox[1]
    got = tracing.sphere_trace(lambda x: grid_sdf(grid, lo, hi, x), torch.as_tensor(ray_o),
                               torch.as_tensor(ray_d), torch.full((256,), 0.8),
                               torch.full((256,), 4.0), st,
                               premarch_sdf_fn=lambda x: grid_sdf_lower_bound(grid, lo, hi, x),
                               premarch_iter=20)
    jg, jlo, jhi = jnp.asarray(grid.numpy()), jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())
    ref = j_tracing.sphere_trace(lambda x: j_grid.grid_sdf(jg, jlo, jhi, x), jnp.asarray(ray_o),
                                 jnp.asarray(ray_d), jnp.full((256,), 0.8),
                                 jnp.full((256,), 4.0), JSTConfig(iter=4),
                                 premarch_sdf_fn=lambda x: j_grid.grid_sdf_lower_bound(
                                     jg, jlo, jhi, x),
                                 premarch_iter=20)
    plain = tracing.sphere_trace(lambda x: grid_sdf(grid, lo, hi, x), torch.as_tensor(ray_o),
                                 torch.as_tensor(ray_d), torch.full((256,), 0.8),
                                 torch.full((256,), 4.0), st)
    assert not torch.equal(got[3], plain[3])        # the pre-march moved the rays
    surf, edge, occ, st_t, ot_t = got
    for g, r in zip((surf, edge, st_t, ot_t), (ref[0], ref[1], ref[3], ref[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TRACE_ATOL, rtol=0)
    # hard-shadow occlusion d tan_i / 2t: the distance it stands for
    dist = lambda o, t: o * 2 * t / st.tan_i
    np.testing.assert_allclose(dist(occ.numpy(), ot_t.numpy()),
                               dist(np.asarray(ref[2]), ot_t.numpy()), atol=TRACE_ATOL, rtol=0)


# ------------------------------------------------------------- renders
def _render_pair(scene, extra, port_mcfg=None, jax_mcfg=None, rays=None, iters=(6, 2),
                 grid=None):
    """(port maps, JAX maps) of ``render_human_block`` on ``rays`` (the
    golden bundle by default, near 0.8 m, far 4 m) with the render knobs
    ``extra``."""
    ctx = scene["ctx"]
    if rays is None:
        ray_o, ray_d = golden.golden_bundle_rays(ctx)
        near, far = 0.8, 4.0
    else:
        ray_o, ray_d, near, far = rays
    n = len(ray_o)
    cfg = jax_cfg()
    cfg.sphere_tracing.iter, cfg.obj_lvis.iter = iters
    st_surf = STConfig.from_cfg(cfg.sphere_tracing)
    st_obj = STConfig.from_cfg({**dict(cfg.sphere_tracing), **dict(cfg.obj_lvis)})
    t = torch.as_tensor
    lx, la = j_gen_light_xyz(2, 4, 10.0)
    port = render_human_block(
        scene["params"], port_mcfg or scene["mcfg"], ctx, t(ray_o), t(ray_d),
        torch.full((n,), near), torch.full((n,), far), torch.full((2, 4, 3), 0.6),
        t(np.asarray(lx)), t(np.asarray(la)), 1.0 / torch.sqrt(t(np.asarray(la)) / np.pi),
        st_surf, st_obj, RelightRenderConfig(shadow_block=1024, distant_envmap=True, **extra),
        shadow_sdf_grid=grid)
    jst = JSTConfig.from_cfg(cfg.sphere_tracing)
    jso = JSTConfig.from_cfg({**dict(cfg.sphere_tracing), **dict(cfg.obj_lvis)})
    with jax.default_matmul_precision("highest"):
        ref = j_render(scene["jparams"], jax_mcfg or scene["jmcfg"], scene["jctx"],
                       jnp.asarray(ray_o), jnp.asarray(ray_d), jnp.full(n, near),
                       jnp.full(n, far), jnp.full((2, 4, 3), 0.6), lx, la,
                       1.0 / jnp.sqrt(la / np.pi), jst, jso,
                       JRcfg(shadow_block=1024, distant_envmap=True, **extra), False,
                       shadow_sdf_grid=None if grid is None else jnp.asarray(grid.numpy()))
    return {k: v.numpy() for k, v in port.items()}, {k: np.asarray(v) for k, v in ref.items()}


def _hold(case, port, ref, far=4.0):
    """Every map of ``port`` against ``ref``; ``far`` the rays' far bound."""
    assert set(port) == set(ref)
    assert (port["acc_map"] > 0).any(), "the bundle hit nothing"
    for key in sorted(ref):
        p = golden.psnr(port[key], ref[key])
        if key == "spec_map":
            rel = float((np.abs(port[key] - ref[key]) / np.maximum(np.abs(ref[key]), 1)).max())
            print(f"{case} {key}: {p:.2f} dB, max relative {rel:.3e}")
            assert rel <= SPEC_REL, (key, rel)
        elif key == "acc_map":
            a, b = port[key], ref[key]
            sil = ((a > 0) & (a < 1)) | ((b > 0) & (b < 1))
            p_in = golden.psnr(a[~sil], b[~sil])
            # 1 - acc is the cone occlusion d tan_i / 2t, t <= far
            dist = float(np.abs(a - b)[sil].max(initial=0.0)) * 2 * far / TAN_I
            print(f"{case} {key}: {p:.2f} dB; {p_in:.2f} dB on {(~sil).sum()} rays, "
                  f"{sil.sum()} partly covered within {dist:.2e} m")
            assert p_in >= MIN_PSNR and dist <= TRACE_ATOL, (key, p_in, dist)
        else:
            print(f"{case} {key}: {p:.2f} dB")
            assert p >= MIN_PSNR, (key, p)


RENDER_CASES = {
    "shadow_compact": dict(extra={'shadow_compact': 0.25}),
    "shadow_skip_resd": dict(extra={'shadow_skip_resd': True}),
    "shadow_verts_sub": dict(extra={'shadow_verts_sub': True}, select=_select_exact),
    "all_three": dict(extra={'shadow_compact': 0.25, 'shadow_skip_resd': True,
                             'shadow_verts_sub': True}, select=_select_exact),
    # the camera trace and the band on the full cloud, the shadow rays on
    # the subsample, both by the bf16 selection
    "knn_xla_verts_sub": dict(extra={'shadow_verts_sub': True}, impl='xla',
                              select=_select_bf16_stable),
    "knn_grouped": dict(extra={}, impl='grouped'),
    "sample_vert_cnt_4": dict(extra={}, K=4),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_option_matches_jax(scene, case):
    spec = RENDER_CASES[case]
    pm, jm = scene["mcfg"], scene["jmcfg"]
    if spec.get("impl") == 'xla':
        pm, jm = pm._replace(knn_xla=True), jm._replace(knn_exact=False)
    if spec.get("impl") == 'grouped':
        pm, jm = pm._replace(knn_grouped=True), jm._replace(knn_exact=False, knn_grouped=True)
    if "K" in spec:
        pm, jm = pm._replace(sample_vert_cnt=spec["K"]), jm._replace(sample_vert_cnt=spec["K"])
    with jax_selection(spec.get("select")):
        port, ref = _render_pair(scene, spec["extra"], pm, jm)
    _hold(case, port, ref)


def test_render_premarch_matches_jax(scene):
    """surf_grid_iters 20 and surf_exact_iters 4 on a 48-node grid of the
    frame, passed to both (the bake is held in ``test_torch_grid.py``)."""
    ctx = scene["ctx"]
    gbox = ctx["wbounds"].clone()
    gbox[0] -= 0.05
    gbox[1] += 0.05
    res = axis_resolutions((gbox[1] - gbox[0]).numpy(), GRID)
    grid = build_hdq_grid(scene["params"], scene["mcfg"], ctx, gbox[0], gbox[1], res, 0.125,
                          packed=True)
    extra = {'shadow_grid': GRID, 'surf_grid_iters': 20, 'surf_exact_iters': 4}
    port, ref = _render_pair(scene, extra, grid=grid)
    _hold("premarch", port, ref)
    plain = golden.render_golden_bundle(ctx, scene["params"], scene["mcfg"], device="cpu",
                                        rcfg_extra={'shadow_grid': GRID}, shadow_sdf_grid=grid)
    assert not np.array_equal(plain.depth_map.numpy(), port["depth_map"])


@pytest.mark.parametrize("mode", ["world", "can", "curve"])
def test_render_ablation_matches_jax(scene, mode):
    ray_o, ray_d = golden.near_bundle_rays(scene["ctx"])
    port, ref = _render_pair(scene, {'ablate_mode': mode},
                             rays=(ray_o, ray_d, golden.NEAR_BUNDLE_NEAR,
                                   golden.NEAR_BUNDLE_FAR), iters=(16, 2))
    _hold(mode, port, ref, far=golden.NEAR_BUNDLE_FAR)
