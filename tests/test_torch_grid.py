"""The port's acceleration ops against the JAX package's, on the same numpy
inputs: the SDF grid (``ops/sdf_grid.py``), the slice-sweep visibility
volume (``ops/lvis_sweep.py``) and the camera trace's miss skip
(``renderer/tracing.py``).  Float32 on both sides, JAX matmuls at
'highest' precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from test_torch_mesh import exact_knn
from test_torch_options import jax_selection
from relightableavatar_tpu.ops import lvis_sweep as j_sweep
from relightableavatar_tpu.ops import sdf_grid as j_grid
from relightableavatar_tpu.ops.envmap import gen_light_xyz as j_gen_light_xyz
from relightableavatar_tpu.renderer import tracing as j_tr
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.ops import lvis_sweep as t_sweep
from relightableavatar_tpu_torch.ops import sdf_grid as t_grid
from relightableavatar_tpu_torch.renderer import tracing as t_tr

# sums of a handful of float32 terms in another order: a few ulp
ATOL = RTOL = 1e-6
NEAR = 0.02


def _r(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _box():
    return np.array([-0.7, -0.4, -0.1], np.float32), np.array([0.8, 0.5, 1.9], np.float32)


def _queries(lo, hi, n=2000, seed=3):
    """Points over the box grown by 30 % on every side: a quarter or so
    fall outside it, where the lookups clamp."""
    rng = np.random.default_rng(seed)
    pad = 0.3 * (hi - lo)
    return rng.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)


# ---------------------------------------------------------------- grid lookups
@pytest.mark.parametrize("res", [(7, 5, 6), (2, 3, 2), (17, 9, 13)])
def test_grid_lookups_match_jax(res):
    lo, hi = _box()
    grid = _r(sum(res), *res)
    x = _queries(lo, hi)
    packed_j = np.array(j_grid.pack_grid_corners(jnp.asarray(grid)))
    packed_t = t_grid.pack_grid_corners(torch.as_tensor(grid)).numpy()
    assert packed_t.shape == tuple(r - 1 for r in res) + (8,)
    np.testing.assert_array_equal(packed_t, packed_j)
    tri, lb = {}, {}
    for name, g in (("raw", grid), ("packed", packed_j)):
        tri_j = np.asarray(j_grid.grid_sdf(jnp.asarray(g), lo, hi, jnp.asarray(x)))
        lb_j = np.asarray(j_grid.grid_sdf_lower_bound(jnp.asarray(g), lo, hi, jnp.asarray(x)))
        tri[name] = t_grid.grid_sdf(torch.as_tensor(g), torch.as_tensor(lo),
                                    torch.as_tensor(hi), torch.as_tensor(x)).numpy()
        lb[name] = t_grid.grid_sdf_lower_bound(torch.as_tensor(g), torch.as_tensor(lo),
                                               torch.as_tensor(hi), torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(tri[name], tri_j, atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(lb[name], lb_j, atol=ATOL, rtol=RTOL, err_msg=name)
    np.testing.assert_array_equal(tri["raw"], tri["packed"])
    np.testing.assert_array_equal(lb["raw"], lb["packed"])
    # the bound is below the trilerp everywhere, in and out of the box
    assert (lb["raw"] <= tri["raw"]).all()


def test_lattice_sizes_and_bake_calls_match_jax():
    """The per-axis lattice of the fixture's grid box and the bake's call
    sizes, which set the KNN's input sizes: (89, 42, 96) baked in 2 calls of
    180,224 points at 96, (45, 21, 48) in 1 call at 48."""
    ctx, _, _ = golden.load_fixture(device="cpu")
    wb = ctx["wbounds"].numpy()
    ext = (wb[1] + 0.05) - (wb[0] - 0.05)
    expect = {96: ((89, 42, 96), 180224, 2), 48: ((45, 21, 48), 46080, 1)}
    for n, (res, chunk, calls) in expect.items():
        assert t_grid.axis_resolutions(ext, n) == j_grid.axis_resolutions(ext, n) == res
        shapes = []
        j_grid.build_sdf_grid(lambda p: (shapes.append(p.shape), p[:, :1])[1],
                              jnp.asarray(wb[0]), jnp.asarray(wb[1]), res)
        sizes = []
        t_grid.build_sdf_grid(lambda p: (sizes.append(p.shape[0]), p[:, :1])[1],
                              torch.as_tensor(wb[0]), torch.as_tensor(wb[1]), res)
        assert shapes[0] == (chunk, 3) and t_grid.bake_chunk(int(np.prod(res))) == chunk
        assert sizes == [chunk] * calls
    assert t_grid.resolve_res(5) == j_grid.resolve_res(5) == (5, 5, 5)
    assert t_grid.resolve_res([3, 4, 5]) == (3, 4, 5)


def test_lattice_nodes_match_jax_linspace():
    """The lattice nodes agree with ``jnp.linspace`` to 2 float32 ulp."""
    for lo, hi, n in ((-0.61, 0.71, 89), (0.1, 1.9, 96), (-1.0, 1.0, 17), (0.3, 0.3, 1)):
        ref = np.asarray(jnp.linspace(jnp.float32(lo), jnp.float32(hi), n))
        got = t_grid._linspace(torch.tensor(lo), torch.tensor(hi), n).numpy()
        assert got[0] == ref[0] and got[-1] == ref[-1]
        np.testing.assert_allclose(got, ref, atol=2.5e-7, rtol=0)


@pytest.fixture(scope="module")
def fixture_pair():
    """(JAX params, mcfg, ctx) and the port's (params, mcfg, ctx) of fixture
    frame 0, exact KNN on both sides."""
    ctx, params, mcfg = golden.load_fixture(device="cpu")
    return jax_scene(jax_cfg()), (params, mcfg, ctx)


@pytest.mark.parametrize("res", [(9, 6, 5), (5, 4, 9)])
def test_build_hdq_grid_matches_jax(fixture_pair, res):
    """The HDQ bake over the fixture's grid box on a small lattice: the
    HDQ SDF agrees to 5.1e-7 where the two exact KNNs agree
    (``test_torch_anisdf.py``), and the lattices to 1e-7 m, so 1e-5."""
    (jparams, jmcfg, jctx), (params, mcfg, ctx) = fixture_pair
    wb = ctx["wbounds"]
    lo, hi = wb[0] - 0.05, wb[1] + 0.05
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(j_grid.build_hdq_grid(jparams, jmcfg, jctx, jnp.asarray(lo.numpy()),
                                               jnp.asarray(hi.numpy()), res, 0.125))
    got = t_grid.build_hdq_grid(params, mcfg, ctx, lo, hi, res, 0.125)
    assert got.shape == res and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    packed = t_grid.build_hdq_grid(params, mcfg, ctx, lo, hi, res, 0.125, packed=True)
    assert torch.equal(packed, t_grid.pack_grid_corners(got))


@pytest.mark.parametrize("res", [(9, 6, 5), (5, 4, 9)])
def test_build_hdq_grid_verts_sub_matches_jax(fixture_pair, res):
    """The bake against the 2,048-vertex subsample (``tpu.shadow_verts_sub``):
    JAX's subsample selection (its bfloat16 ``knn_select``) made the exact
    one, the port's K1 on the subsample (``test_torch_options.py``), 1e-5
    as the full bake."""
    (jparams, jmcfg, jctx), (params, mcfg, ctx) = fixture_pair
    wb = ctx["wbounds"]
    lo, hi = wb[0] - 0.05, wb[1] + 0.05
    with jax_selection(lambda p, v, K=3: exact_knn(p, v, K)[1]):
        with jax.default_matmul_precision('highest'):
            ref = np.asarray(j_grid.build_hdq_grid(
                jparams, jmcfg, jctx, jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()), res,
                0.125, verts_sub=True))
    got = t_grid.build_hdq_grid(params, mcfg, ctx, lo, hi, res, 0.125, verts_sub=True)
    full = t_grid.build_hdq_grid(params, mcfg, ctx, lo, hi, res, 0.125)
    assert got.shape == res and torch.isfinite(got).all() and not torch.equal(got, full)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- sweep
def _sphere(res, lo, hi, r=0.5):
    ax = [np.linspace(lo[i], hi[i], res[i]) for i in range(3)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - r).astype(np.float32)


def _coarse_dirs():
    """The 8x16 coarse light grid's directions (the bench stack's)."""
    xyz, _ = j_gen_light_xyz(8, 16, 10.0)
    d = np.array(xyz).reshape(-1, 3)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("res,lo,hi", [
    ((17, 17, 17), (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    ((17, 9, 13), (-1.0, -0.6, -0.8), (1.0, 0.6, 0.8)),
], ids=["cube17", "box17x9x13"])
def test_sweep_ratio_volume_matches_jax(res, lo, hi):
    """The sweep over a sphere SDF toward the 128 coarse directions (all
    six dominant-axis groups).  The integer shifts are exact gathers, the
    bilinear prefix sums its two taps per axis in another order than the
    JAX operator's matmul: measured max |diff| 1.9e-6 at ratios up to
    BIG = 1e6, 2e-6 relative; bar 1e-5 relative + 1e-5 absolute."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    grid = _sphere(res, lo, hi)
    dirs = _coarse_dirs()
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(j_sweep.sweep_ratio_volume(jnp.asarray(grid), lo, hi, dirs, NEAR))
    got = t_sweep.sweep_ratio_volume(torch.as_tensor(grid), torch.as_tensor(lo),
                                     torch.as_tensor(hi), dirs, NEAR).numpy()
    assert got.shape == res + (len(dirs),)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the far slice of each group is unoccluded and the pad BIG survives
    assert got.max() == t_sweep.BIG == ref.max()


def test_query_ratio_volume_matches_jax():
    lo, hi = _box()
    vol = np.abs(_r(7, 6, 5, 7, 11))
    x = _queries(lo, hi, n=500)
    ref = np.asarray(j_sweep.query_ratio_volume(jnp.asarray(vol), lo, hi, jnp.asarray(x)))
    got = t_sweep.query_ratio_volume(torch.as_tensor(vol), torch.as_tensor(lo),
                                     torch.as_tensor(hi), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- miss skip
def _sphere_rays(n=96, seed=5):
    """Rays from 3 m away toward points within 0.9 m of a 0.5 m sphere at
    the origin (about half hit), then 32 of the renderer's padding lanes
    (origin at 0, +z, near 0.1, far 0.11)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    tgt = rng.uniform(-0.9, 0.9, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.full(n, 2.0)
    far = np.full(n, 4.0)
    o = np.concatenate([o, np.zeros((32, 3))])
    d = np.concatenate([d, np.tile([[0, 0, 1.0]], (32, 1))])
    near = np.concatenate([near, np.full(32, 0.1)])
    far = np.concatenate([far, np.full(32, 0.11)])
    return [a.astype(np.float32) for a in (o, d, near, far)]


def _sdfs(mod):
    """(exact sphere SDF, lower bound 2 cm under it) in ``mod``'s arrays."""
    norm = (lambda x: jnp.linalg.norm(x, axis=-1, keepdims=True)) if mod is jnp else \
        (lambda x: torch.linalg.vector_norm(x, dim=-1, keepdim=True))
    return (lambda x: norm(x) - 0.5), (lambda x: norm(x) - 0.52)


def test_safe_miss_march_matches_jax():
    o, d, near, far = _sphere_rays()
    _, jlb = _sdfs(jnp)
    _, tlb = _sdfs(torch)
    ref = np.asarray(j_tr.safe_miss_march(jlb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
                                          jnp.asarray(far), 1000.0, 0.01, 32))
    got = t_tr.safe_miss_march(tlb, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(near),
                               torch.as_tensor(far), 1000.0, 0.01, 32).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 10 < got[:96].sum() < 86        # both classes among the real rays


def test_sphere_trace_miss_skip_matches_jax_and_plain_trace():
    """Rays not proven to miss trace exactly as in the plain tracer and as
    in the JAX skip; proven misses report the clean-miss state, and the
    plain trace of every one of them has occ = 1 (the skip is exact)."""
    o, d, near, far = _sphere_rays()
    st_j, st_t = j_tr.STConfig(iter=16), t_tr.STConfig(iter=16)
    jsdf, jlb = _sdfs(jnp)
    tsdf, tlb = _sdfs(torch)
    J = [np.asarray(a) for a in j_tr.sphere_trace_miss_skip(
        jsdf, jlb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(near), jnp.asarray(far),
        st_j, skip_iter=32, margin=0.01, sub_block=32)]
    T = [a.numpy() for a in t_tr.sphere_trace_miss_skip(
        tsdf, tlb, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(near),
        torch.as_tensor(far), st_t, skip_iter=32, margin=0.01)]
    plain = [a.numpy() for a in t_tr.sphere_trace(
        tsdf, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(near),
        torch.as_tensor(far), st_t)]
    miss = t_tr.safe_miss_march(tlb, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(near),
                                torch.as_tensor(far), 1000.0, 0.01, 32).numpy()
    live = ~miss
    for name, j, t, p in zip(("surf", "edge", "occ", "st_t", "ot_t"), J, T, plain):
        assert t.shape == j.shape == p.shape, name
        np.testing.assert_allclose(t[live], j[live], atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_array_equal(t[live], p[live], err_msg=name)
    assert (plain[2][miss] == 1.0).all() and (T[2][miss] == 1.0).all()
    np.testing.assert_array_equal(T[3][miss], far[miss, None])
    np.testing.assert_allclose(T[0][miss], o[miss] + far[miss, None] * d[miss], atol=1e-6)
    assert (T[2][:96] < 1).any()            # some rays hit
