"""The port's plain top-3 KNN against the JAX package's Pallas kernel (run
in interpret mode on the CPU) and against an f64 brute force, the argument
checks of the CUDA wrapper, and a numpy model of the CUDA kernel's
selection schedule held bit for bit against both.

Inputs: fixture frame 0's posed vertices (6890) and 20k points made of
vertices plus N(0, 3 cm) noise.  Tolerance: d2 within 1e-6 absolute; idx
identical except at near ties (|d2_k - d2_k+1| <= 1e-6 * max(d2, 1e-6)),
which may differ on at most 0.01% of the points.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightableavatar_tpu.ops.pallas_knn import knn_pallas
from relightableavatar_tpu_torch.eval.golden import load_fixture
from relightableavatar_tpu_torch.eval.knn_cases import knn_cases
from relightableavatar_tpu_torch.ops.knn import knn_top3, knn_top3_reference
from relightableavatar_tpu_torch.ops.knn_cuda import knn_top3_cuda

D2_ATOL = 1e-6
NEAR_TIE = 1e-6
MAX_TIE_SHARE = 1e-4


@pytest.fixture(scope="module")
def cloud():
    ctx, _, _ = load_fixture(device="cpu")
    verts = ctx["pverts"].numpy()
    rng = np.random.default_rng(0)
    pts = (verts[rng.integers(0, len(verts), 20000)]
           + rng.normal(0, 0.03, (20000, 3))).astype(np.float32)
    return pts, verts


def _check(d2, idx, ref_d2, ref_idx):
    d2, idx = np.asarray(d2), np.asarray(idx)
    ref_d2, ref_idx = np.asarray(ref_d2), np.asarray(ref_idx)
    np.testing.assert_allclose(d2, ref_d2, atol=D2_ATOL, rtol=0)
    bad = (idx != ref_idx).any(axis=1)
    gaps = np.abs(np.diff(ref_d2, axis=1))
    tie = (gaps <= NEAR_TIE * np.maximum(ref_d2[:, 1:], 1e-6)).any(axis=1)
    assert not (bad & ~tie).any(), f"{int((bad & ~tie).sum())} points differ outside near ties"
    assert (bad & tie).mean() <= MAX_TIE_SHARE
    return float(bad.mean())


def test_plain_matches_pallas_interpret(cloud):
    pts, verts = cloud
    d2, idx = knn_top3_reference(torch.as_tensor(pts), torch.as_tensor(verts))
    pd2, pidx = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), interpret=True)
    _check(d2, idx, pd2, pidx)
    # same arithmetic and tie rule: the two should agree bit for bit
    assert (idx.numpy() == np.asarray(pidx)).all()


def test_plain_matches_f64_bruteforce(cloud):
    pts, verts = cloud
    d2, idx = knn_top3_reference(torch.as_tensor(pts), torch.as_tensor(verts))
    p64 = torch.as_tensor(pts, dtype=torch.float64)
    v64 = torch.as_tensor(verts, dtype=torch.float64)
    ref_d2, ref_idx = [], []
    for s in range(0, len(p64), 4096):
        D = ((p64[s:s + 4096, None, :] - v64[None]) ** 2).sum(-1)
        d, i = torch.topk(D, 3, dim=1, largest=False, sorted=True)
        ref_idx.append(i.numpy())
        ref_d2.append(d.numpy())
    share = _check(d2, idx, np.concatenate(ref_d2), np.concatenate(ref_idx))
    print(f"near-tie idx differences vs f64: {share:.4%} of points")


@pytest.mark.parametrize("P", [1, 511, 513])
def test_ragged_point_counts(cloud, P):
    pts, verts = cloud
    d2, idx = knn_top3_reference(torch.as_tensor(pts[:P]), torch.as_tensor(verts))
    assert d2.shape == (P, 3) and idx.shape == (P, 3)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    pd2, pidx = knn_pallas(jnp.asarray(pts[:P]), jnp.asarray(verts), interpret=True)
    _check(d2, idx, pd2, pidx)


def test_exact_ties_go_to_lowest_index(cloud):
    pts, verts = cloud
    vdup = np.concatenate([verts, verts])
    d2, idx = knn_top3_reference(torch.as_tensor(pts[:2048]), torch.as_tensor(vdup))
    N = len(verts)
    assert (idx[:, 0] < N).all() and (idx[:, 1] == idx[:, 0] + N).all()
    assert (d2[:, 0] == d2[:, 1]).all()
    pd2, pidx = knn_pallas(jnp.asarray(pts[:2048]), jnp.asarray(vdup), interpret=True)
    assert (idx.numpy() == np.asarray(pidx)).all()


def test_dispatch_takes_plain_version_on_cpu(cloud):
    pts, verts = cloud
    a = knn_top3(torch.as_tensor(pts[:300]), torch.as_tensor(verts))
    b = knn_top3_reference(torch.as_tensor(pts[:300]), torch.as_tensor(verts))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "device", "too_few"])
def test_cuda_wrapper_rejects_bad_arguments(case):
    pts = torch.zeros((16, 3))
    verts = torch.zeros((8, 3))
    if case == "dtype":
        pts, err, match = pts.double(), TypeError, "float32"
    elif case == "shape":
        pts, err, match = torch.zeros((16, 2)), ValueError, "shape"
    elif case == "contiguity":
        pts, err, match = torch.zeros((3, 16)).T, ValueError, "contiguous"
    elif case == "device":
        err, match = ValueError, "CUDA"
    else:
        verts, err, match = torch.zeros((2, 3)), ValueError, "CUDA|3 vertices"
    with pytest.raises(err, match=match):
        knn_top3_cuda(pts, verts)


# ---------------------------------------------------------------------------
# numpy model of the Hopper kernel's selection schedule (csrc/knn_top3.cu)
#
# The kernel gives every point a seeded bound (step 1: the nearest of the
# strided seed vertices by the filter value e; step 2: the 3rd-smallest exact
# d2 in the window of consecutive vertices around it), then lets 8 warps of
# a subgroup take 32-vertex chunks of each tile in ascending order.  A warp
# filters 4 vertices at a time with e = |v|^2 - 2 p.v (three FMAs) against
# T = thr - (|p|^2 - margin), and inserts the exact d2 of the candidates by
# strict < in ascending index order; the 8 partial lists merge by (d2, idx).
# The model runs the same steps on all points at once and checks on every
# pair that the filter never rejects a vertex the exact test accepts.

K_SLICES, K_SUB, K_U, K_CHUNK = 8, 2, 4, 32
K_CAP, K_SEEDS, K_WINDOW, K_MAX_R = 10240, 192, 64, 4
MARGIN_SCALE = np.float32(2.0 ** -17)
INT_MAX = np.iinfo(np.int32).max
KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "relightableavatar_tpu_torch", "csrc", "knn_top3.cu")


def _fma(a, b, c):
    """float32 fma: the product is exact in float64, one rounding after the
    add (a double rounding in rare ties, far inside the filter's margin).
    Padding vertices give inf * 0 and inf - inf: NaN, as on the card."""
    with np.errstate(invalid="ignore"):
        return (a.astype(np.float64) * b + c).astype(np.float32)


def _sq3(x, y, z):
    return _fma(x, x, _fma(y, y, z * z))


def _dist2(px, py, pz, vx, vy, vz):
    dx, dy, dz = px - vx, py - vy, pz - vz
    return (dx * dx + dy * dy) + dz * dz


def points_per_lane(P, slots):
    """The kernel's points_per_lane: fewest waves x (4 R + 2)."""
    cost = lambda R: -(-(-(-P // (K_SUB * 32 * R))) // slots) * (4 * R + 2)
    return min(range(1, K_MAX_R + 1), key=cost)


def model_knn_top3(pts, verts, R, cap=K_CAP, seeds=K_SEEDS, window=K_WINDOW,
                   chunk_owner_seed=0):
    """(d2, idx, stats) of the kernel's schedule with R points a lane.  The
    kernel hands chunks to warps by a shared counter, so which warp walks
    which chunk varies from run to run; the model draws the owners from
    ``chunk_owner_seed`` (each warp's chunks stay ascending)."""
    pts = np.asarray(pts, np.float32)
    verts = np.asarray(verts, np.float32)
    P, N = len(pts), len(verts)
    G = -(-P // (32 * R))                     # subgroups of 32 R points
    X = np.zeros((G * 32 * R, 3), np.float32)
    X[:P] = pts
    valid = (np.arange(G * 32 * R) < P).reshape(G, R, 32)
    px, py, pz = (X[:, c].reshape(G, R, 32) for c in range(3))
    qx, qy, qz = np.float32(-2) * px, np.float32(-2) * py, np.float32(-2) * pz
    pp = _sq3(px, py, pz)
    stats = dict(groups=0, point_votes=0, filter_misses=0)

    # seed, step 1: per slice the first minimum of e over k = slice mod 8,
    # then the first slice with the smallest
    nseeds = min(seeds, N)
    stride = N // nseeds
    sv = verts[np.arange(nseeds) * stride]
    e = _fma(qx[..., None], sv[:, 0], _fma(qy[..., None], sv[:, 1],
             _fma(qz[..., None], sv[:, 2], _sq3(sv[:, 0], sv[:, 1], sv[:, 2]))))
    best_e = np.full((G, R, 32), np.inf, np.float32)
    best_k = np.zeros((G, R, 32), np.int64)
    for s in range(K_SLICES):
        ks = np.arange(s, nseeds, K_SLICES)
        if len(ks) == 0:
            continue
        es = e[..., ks]
        j = np.argmin(np.where(np.isnan(es), np.inf, es), axis=-1)
        m = np.take_along_axis(es, j[..., None], -1)[..., 0]
        better = m < best_e
        best_e = np.where(better, m, best_e)
        best_k = np.where(better, ks[j], best_k)
    # step 2: the 3 smallest exact d2 in the window around the best seed
    lo = np.maximum(0, np.minimum(best_k * stride - window // 2, N - window))
    win = lo[..., None] + np.arange(min(window, N))
    wv = verts[win]
    dw = _dist2(px[..., None], py[..., None], pz[..., None], wv[..., 0], wv[..., 1], wv[..., 2])
    a2 = np.sort(np.where(np.isnan(dw), np.inf, dw), axis=-1)[..., 2]
    thr0 = np.where(valid, np.nextafter(a2, np.float32(np.inf)), -np.inf).astype(np.float32)

    td = np.full((K_SLICES, G, R, 32, 3), np.inf, np.float32)
    ti = np.full((K_SLICES, G, R, 32, 3), INT_MAX, np.int64)
    thr = np.broadcast_to(thr0, (K_SLICES,) + thr0.shape).copy()
    rng = np.random.default_rng(chunk_owner_seed)
    for base in range(0, N, cap):
        n = min(cap, N - base)
        padded = -(-n // K_CHUNK) * K_CHUNK
        vx = np.full(padded, np.inf, np.float32)
        vy = np.zeros(padded, np.float32)
        vz = np.zeros(padded, np.float32)
        vw = np.full(padded, np.inf, np.float32)
        vx[:n], vy[:n], vz[:n] = verts[base:base + n].T
        vw[:n] = _sq3(vx[:n], vy[:n], vz[:n])
        off = pp - MARGIN_SCALE * (pp + vw[:n].max())
        T = thr - off
        owner = rng.integers(0, K_SLICES, padded // K_CHUNK)
        for c, s in enumerate(owner):
            j0 = c * K_CHUNK
            dch = _dist2(px[..., None], py[..., None], pz[..., None],
                         vx[j0:j0 + K_CHUNK], vy[j0:j0 + K_CHUNK], vz[j0:j0 + K_CHUNK])
            ech = _fma(qx[..., None], vx[j0:j0 + K_CHUNK], _fma(qy[..., None], vy[j0:j0 + K_CHUNK],
                       _fma(qz[..., None], vz[j0:j0 + K_CHUNK], vw[j0:j0 + K_CHUNK])))
            for g in range(0, K_CHUNK, K_U):
                e4, d4 = ech[..., g:g + K_U], dch[..., g:g + K_U]
                hit = np.fmin.reduce(e4, axis=-1) < T[s]
                stats["groups"] += G
                stats["point_votes"] += int(hit.any(axis=2).sum())
                if not (d4 < thr[s][..., None]).any():
                    continue
                for u in range(K_U):
                    cand = d4[..., u] < thr[s]
                    stats["filter_misses"] += int((cand & ~(e4[..., u] < T[s])).sum())
                    d, i = d4[..., u], base + j0 + g + u
                    a, b = td[s], ti[s]
                    c0, c1 = cand & (d < a[..., 0]), cand & (d < a[..., 1])
                    a[..., 2] = np.where(c1, a[..., 1], np.where(cand, d, a[..., 2]))
                    b[..., 2] = np.where(c1, b[..., 1], np.where(cand, i, b[..., 2]))
                    a[..., 1] = np.where(c0, a[..., 0], np.where(c1, d, a[..., 1]))
                    b[..., 1] = np.where(c0, b[..., 0], np.where(c1, i, b[..., 1]))
                    a[..., 0] = np.where(c0, d, a[..., 0])
                    b[..., 0] = np.where(c0, i, b[..., 0])
                    thr[s] = np.minimum(thr[s], a[..., 2])
                    T[s] = thr[s] - off

    # merge: the 8 slices' lists by (d2, idx)
    md = np.moveaxis(td, 0, -2).reshape(G, R, 32, 3 * K_SLICES)
    mi = np.moveaxis(ti, 0, -2).reshape(G, R, 32, 3 * K_SLICES)
    order = np.lexsort((mi, md), axis=-1)[..., :3]
    d2 = np.take_along_axis(md, order, -1).reshape(-1, 3)[:P]
    idx = np.take_along_axis(mi, order, -1).reshape(-1, 3)[:P].astype(np.int32)
    return d2, idx, stats


def test_model_constants_are_the_kernels():
    src = open(KERNEL_SOURCE).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert consts["kSlices"] == str(K_SLICES) and consts["kSub"] == str(K_SUB)
    assert consts["kU"] == str(K_U) and consts["kChunk"] == "8 * kU" and K_CHUNK == 8 * K_U
    assert consts["kCap"] == str(K_CAP) and consts["kSeeds"] == str(K_SEEDS)
    assert consts["kWindow"] == str(K_WINDOW) and consts["kMaxR"] == str(K_MAX_R)
    assert "kMarginScale = 0x1p-17f" in src and MARGIN_SCALE == np.float32(2.0 ** -17)


def test_points_per_lane_fills_132_sms():
    # the frame's block sizes on an H100's 132 SMs, one CTA an SM
    assert [points_per_lane(P, 132) for P in (6912, 8192, 24576, 32768, 33793)] == [1, 1, 3, 4, 3]


def _schedule_case(cloud, case):
    pts, verts = cloud
    rng = np.random.default_rng(5)
    if case == "fixture":
        return pts[:1500], verts, {}
    if case == "far":               # 1 km away: rounding makes ties common
        far = (verts + np.float32(1000.0)).astype(np.float32)
        p = (far[rng.integers(0, len(far), 700)] + rng.normal(0, 0.03, (700, 3))).astype(np.float32)
        return p, far, {}
    if case == "on_vertices":       # d2 = 0 exactly
        return verts[::9], verts, {}
    if case == "duplicates_tiled":  # every vertex twice, streamed in 3 tiles
        vdup = np.concatenate([verts[:1500], verts[:1500]])
        return pts[:600], vdup, dict(cap=1024)
    if case == "ragged":            # P and N off every boundary, window > N
        return pts[:97], verts[:37], {}
    if case == "three_vertices":
        return pts[:65], verts[:3], {}
    raise ValueError(case)


@pytest.mark.parametrize("R", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["fixture", "far", "on_vertices", "duplicates_tiled",
                                  "ragged", "three_vertices"])
def test_schedule_model_is_exact(cloud, case, R):
    p, v, kw = _schedule_case(cloud, case)
    d2, idx, stats = model_knn_top3(p, v, R, chunk_owner_seed=R, **kw)
    rd2, ridx = knn_top3_reference(torch.as_tensor(p), torch.as_tensor(v))
    assert stats["filter_misses"] == 0
    # bit for bit against the plain version, as the kernel must be
    assert np.array_equal(d2, rd2.numpy()) and np.array_equal(idx, ridx.numpy())
    pd2, pidx = knn_pallas(jnp.asarray(p), jnp.asarray(v), interpret=True)
    # the Pallas kernel's indices equal bit for bit; its d2 may differ in
    # the last bit where XLA's CPU fusion rounds otherwise
    assert np.array_equal(idx, np.asarray(pidx))
    np.testing.assert_allclose(d2, np.asarray(pd2), atol=D2_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["P=1", "P=31", "P=33", "P=63", "P=65", "P=127", "P=129"])
def test_schedule_model_is_exact_on_the_smoke_cases(cloud, name):
    """The smoke's [knn] inputs (fixture frame 0's cloud, numpy rng 0) at
    the R the kernel picks on 132 SMs, for several orders in which the
    warps take their chunks: bit for bit the plain version."""
    _, verts = cloud
    cases = {n: (p, v) for n, p, v in knn_cases(torch.as_tensor(verts), np.random.default_rng(0))}
    p, v = cases[name]
    rd2, ridx = knn_top3_reference(p, v)
    for seed in range(4):
        d2, idx, stats = model_knn_top3(p.numpy(), v.numpy(), points_per_lane(len(p), 132),
                                        chunk_owner_seed=seed)
        assert stats["filter_misses"] == 0
        assert np.array_equal(d2, rd2.numpy()) and np.array_equal(idx, ridx.numpy())


def test_schedule_model_votes_rarely_near_the_surface(cloud):
    pts, verts = cloud
    _, _, stats = model_knn_top3(pts[:2048], verts, R=4)
    # the window-seeded bound keeps a point's warp vote to about one group
    # in nine on these random-order points (0.114 when written)
    assert stats["point_votes"] / (stats["groups"] * 4) < 0.15
    print(stats)


# ---------------------------------------------------------------------------
# the SASS reader of eval/knn_bench.py, on a short fixed excerpt in the
# format of `cuobjdump -sass` (instructions taken from the kernel's R = 1
# loop, shortened): a vertex loop of 4 LDS.128 whose slow path a forward
# branch skips, inside an outer loop, and a function with no such loop

SASS_EXCERPT = """
	code for sm_90a
		Function : _Z6kernelILi1EEvPKf
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.MOV.U32 R44, RZ, RZ, RZ ;             /* 0x000000ffff2c7224 */
        /*0020*/                   LEA R46, R44, UR4, 0x2 ;                   /* 0x000000042c2e7c11 */
        /*0030*/                   LDS.128 R12, [R46+0x14000] ;               /* 0x014000002e0c7984 */
        /*0040*/                   LDS.128 R24, [R46+0x1e000] ;               /* 0x01e000002e187984 */
        /*0050*/                   LDS.128 R16, [R46+0xa000] ;                /* 0x00a000002e107984 */
        /*0060*/                   LDS.128 R20, [R46] ;                       /* 0x000000002e147984 */
        /*0070*/                   FFMA R48, R9.reuse, R13, R25 ;             /* 0x0000000d09307223 */
        /*0080*/                   FFMA R47, R8, R17, R48 ;                   /* 0x00000011082f7223 */
        /*0090*/                   FMNMX R26, R47, R48, PT ;                  /* 0x000000302f1a7209 */
        /*00a0*/                   FSETP.GEU.AND P0, PT, R26, R42, PT ;       /* 0x0000002a1a00720b */
        /*00b0*/                   VOTE.ANY P2, !P0 ;                         /* 0x0000000000ff7806 */
        /*00c0*/              @!P2 BRA 0x110 ;                                /* 0x0000000000102947 */
        /*00d0*/                   FADD R20, R33, -R20 ;                      /* 0x8000001421147221 */
        /*00e0*/                   FMUL R20, R20, R20 ;                       /* 0x0000001414147220 */
        /*00f0*/                   FSETP.GEU.AND P0, PT, R20, R42, PT ;       /* 0x0000002a1400720b */
        /*0100*/                   BSYNC B0 ;                                 /* 0x0000000000007941 */
        /*0110*/                   VIADD R44, R44, 0x4 ;                      /* 0x000000042c2c7836 */
        /*0120*/                   ISETP.GE.AND P0, PT, R44, R41, PT ;        /* 0x000000292c00720c */
        /*0130*/              @!P0 BRA 0x20 ;                                 /* 0xfffffffc00b88947 */
        /*0140*/                   IADD3 R40, R40, 0x1, RZ ;                  /* 0x0000000128287810 */
        /*0150*/                   ISETP.GE.AND P1, PT, R40, R39, PT ;        /* 0x000000272800720c */
        /*0160*/              @!P1 BRA 0x10 ;                                 /* 0xfffffffc00a89947 */
        /*0170*/                   EXIT ;                                     /* 0x000000000000794d */
        /*0180*/                   BRA 0x180;                                 /* 0xfffffffc00fc7947 */
		..........
		Function : _Z5otherv
        /*0000*/                   LDS.128 R12, [R46] ;                       /* 0x000000002e0c7984 */
        /*0010*/                   FADD R1, R2, R3 ;                          /* 0x0000000302017221 */
        /*0020*/              @P0 BRA 0x0 ;                                   /* 0xfffffffc00b80947 */
        /*0030*/                   EXIT ;                                     /* 0x000000000000794d */
"""


def test_sass_fast_path_counts_the_vertex_loop_without_its_slow_path():
    from relightableavatar_tpu_torch.eval.knn_bench import _branch_target, fast_path_counts
    assert _branch_target("@!P2 BRA 0x110") == 0x110
    assert _branch_target("@P0 BRA 0x5470") == 0x5470
    assert _branch_target("BRA 0x180") == 0x180
    assert _branch_target("FADD R20, R33, -R20") is None
    [(name, n, ops)] = fast_path_counts(SASS_EXCERPT)
    assert name == "_Z6kernelILi1EEvPKf"
    # LEA, 4 LDS.128, 2 FFMA, FMNMX, FSETP, VOTE, the skip, VIADD, ISETP, the
    # branch back; not the slow path (FADD, FMUL, its FSETP, BSYNC) and not
    # the outer loop
    assert ops == {"LEA": 1, "LDS": 4, "FFMA": 2, "FMNMX": 1, "FSETP": 1, "VOTE": 1,
                   "BRA": 2, "VIADD": 1, "ISETP": 1}
    assert n == 14
