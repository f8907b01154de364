"""The port's host mesh tools against the JAX package's: marching tetrahedra
(the C++ copy through ``ops/native.py`` and the numpy plain version),
``orient_faces``, ``largest_component``, QEM decimation, winding numbers,
Loop subdivision and the PLY writer, on the analytic spheres of
``tests/test_marching.py`` and on an SDF cube of the fixture avatar.

The C++ sources are copies compiled with the same flags, so the native
results are held equal, array for array.  The numpy marching emits the same
vertex set in another order (``tests/test_marching.py:33-42``): compared
as sets, each vertex within 1e-5 of one of the other's.  The native loader builds into the port's ``_build/`` and
raises when the compiler fails, with the compiler's output.
"""
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from relightableavatar_tpu.ops import marching as jmarching
from relightableavatar_tpu.ops import meshtools as jmeshtools
from relightableavatar_tpu.vis.visualizer import write_ply as j_write_ply
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops import marching as pmarching
from relightableavatar_tpu_torch.ops import meshtools as pmeshtools
from relightableavatar_tpu_torch.ops import native
from relightableavatar_tpu_torch.vis.visualizer import write_ply

FIXTURE_VOXEL = 0.04        # m: the fixture cube's spacing (about 17k nodes)


def _sphere_grid(n=40, r=1.0, extent=1.3):
    x = np.linspace(-extent, extent, n).astype(np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing='ij')
    sdf = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - r
    sp = float(x[1] - x[0])
    return sdf, (-extent, -extent, -extent), (sp, sp, sp)


def _two_spheres(n=48):
    x = np.linspace(-2.5, 2.5, n).astype(np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing='ij')
    s1 = np.sqrt((X + 1.3) ** 2 + Y ** 2 + Z ** 2) - 1.0
    s2 = np.sqrt((X - 1.7) ** 2 + Y ** 2 + Z ** 2) - 0.4
    sp = float(x[1] - x[0])
    return np.minimum(s1, s2), (-2.5,) * 3, (sp,) * 3


@pytest.fixture(scope="module")
def fixture_cube():
    """The fixture avatar's canonical SDF on a 4 cm grid over its bigpose
    box, padded as the mesh renderer pads it: (sdf, origin, spacing)."""
    ctx, params, mcfg = golden.load_fixture(golden.fixture_cfg(), device="cpu")
    tb = ctx["tbounds"].numpy()
    axes = [np.arange(tb[0, i], tb[1, i] + FIXTURE_VOXEL, FIXTURE_VOXEL, dtype=np.float32)
            for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing='ij'), -1)
    with torch.no_grad():
        sdf, _ = anisdf.sdf_feat(params, mcfg, torch.as_tensor(pts.reshape(-1, 3)))
    sdf = np.pad(sdf.numpy().reshape(pts.shape[:3]), 2, constant_values=1.0)
    origin = tuple(float(tb[0, i] - 2 * FIXTURE_VOXEL) for i in range(3))
    return sdf, origin, (FIXTURE_VOXEL,) * 3


def _grids(fixture_cube):
    return {"sphere": _sphere_grid(), "sphere_n32": _sphere_grid(n=32),
            "two_spheres": _two_spheres(), "fixture": fixture_cube}


GRIDS = ("sphere", "sphere_n32", "two_spheres", "fixture")


def test_native_library_builds_from_the_ports_sources():
    path, _ = native.build_library()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libra_native_") and path.endswith(".so")
    assert [os.path.relpath(s, native._PKG) for s in native.SOURCES] == [
        os.path.join("csrc", "marching.cpp"), os.path.join("csrc", "decimate.cpp")]
    assert native.GXX_FLAGS == ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
    assert native.build_library() == (path, 0.0)       # cached by hash


def test_native_build_failure_raises_with_the_compilers_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int ra_marching_tets( { this is not C++\n")
    with pytest.raises(native.NativeBuildError, match="broken.cpp") as e:
        native.build_library([str(bad)], str(tmp_path / "build"))
    assert "error" in str(e.value)
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.build_library(native.SOURCES, str(tmp_path / "build2"),
                             compiler="no-such-compiler-here")


def test_native_wrappers_refuse_malformed_arrays():
    V, F = np.zeros((4, 3), np.float32), np.array([[0, 1, 2], [1, 2, 3]])
    with pytest.raises(ValueError, match="3-d"):
        native.marching_tets_native(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="outside"):
        native.decimate_native(V, F + 1, 1)
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        native.decimate_native(V[:, :2], F, 1)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("level", [0.0, 0.05])
def test_marching_tets_equals_jax(fixture_cube, grid, level):
    sdf, o, s = _grids(fixture_cube)[grid]
    V, F = pmarching.marching_tets(sdf, level, o, s)
    Vj, Fj = jmarching.marching_tets(sdf, level, o, s)
    assert len(F) > 100
    np.testing.assert_array_equal(V, Vj)
    np.testing.assert_array_equal(F, Fj)
    assert V.dtype == np.float32 and F.dtype == np.int64


@pytest.mark.parametrize("grid", GRIDS)
def test_numpy_marching_equals_jax_and_the_native_vertex_set(fixture_cube, grid):
    sdf, o, s = _grids(fixture_cube)[grid]
    Vn, Fn = pmarching._marching_tets_numpy(sdf, 0.0, o, s)
    Vj, Fj = jmarching._marching_tets_numpy(sdf, 0.0, o, s)
    np.testing.assert_array_equal(Vn, Vj)
    np.testing.assert_array_equal(Fn, Fj)
    np.testing.assert_array_equal(pmarching.orient_faces(Vn, Fn, sdf, o, s),
                                  jmarching.orient_faces(Vn, Fn, sdf, o, s))
    V, F = pmarching.marching_tets(sdf, 0.0, o, s)
    assert len(V) == len(Vn) and len(F) == len(Fn)
    # the same vertex set in another order (tests/test_marching.py:33-42):
    # each vertex within 1e-5 of one of the other's (float32 C++ against
    # float64 numpy interpolation), both ways
    for a, b in ((V, Vn), (Vn, V)):
        assert float(cKDTree(b).query(a)[0].max()) <= 1e-5


@pytest.mark.parametrize("grid", ("two_spheres", "fixture"))
def test_largest_component_equals_jax(fixture_cube, grid):
    sdf, o, s = _grids(fixture_cube)[grid]
    V, F = pmarching.marching_tets(sdf, 0.0, o, s)
    V2, F2 = pmarching.largest_component(V, F)
    Vj, Fj = jmarching.largest_component(V, F)
    np.testing.assert_array_equal(V2, Vj)
    np.testing.assert_array_equal(F2, Fj)
    if grid == "two_spheres":
        assert len(V2) < len(V)


@pytest.mark.parametrize("grid,target", [("sphere", 800), ("fixture", 2000),
                                         ("fixture", 500)])
def test_decimate_equals_jax(fixture_cube, grid, target):
    sdf, o, s = _grids(fixture_cube)[grid]
    V, F = pmarching.largest_component(*pmarching.marching_tets(sdf, 0.0, o, s))
    assert len(F) > target
    V2, F2 = pmeshtools.decimate(V, F, target)
    Vj, Fj = jmeshtools.decimate(V, F, target)
    np.testing.assert_array_equal(V2, Vj)
    np.testing.assert_array_equal(F2, Fj)
    assert len(F2) <= target and F2.dtype == F.dtype
    assert pmeshtools.decimate(V, F, len(F) + 1)[1] is F      # no-op above the count


def test_cluster_decimate_equals_jax(fixture_cube):
    sdf, o, sp = _grids(fixture_cube)["fixture"]
    V, F = pmarching.marching_tets(sdf, 0.0, o, sp)
    for target in (200, 2000):
        for a, b in zip(pmeshtools._cluster_decimate(V, F, target),
                        jmeshtools._cluster_decimate(V, F, target)):
            np.testing.assert_array_equal(a, b)


def test_winding_number_and_loop_subdivide_equal_jax():
    sdf, o, sp = _sphere_grid(n=20)
    V, F = pmarching.marching_tets(sdf, 0.0, o, sp)
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (300, 3))
    w = pmeshtools.winding_number(pts, V, F, block=128)
    np.testing.assert_array_equal(w, jmeshtools.winding_number(pts, V, F, block=128))
    inside = np.linalg.norm(pts, axis=-1) < 0.9
    outside = np.linalg.norm(pts, axis=-1) > 1.1
    assert (pmeshtools.inside_mesh(pts, V, F)[inside]).all()
    assert not (pmeshtools.inside_mesh(pts, V, F)[outside]).any()
    for a, b in zip(pmeshtools.loop_subdivide(V, F), jmeshtools.loop_subdivide(V, F)):
        np.testing.assert_array_equal(a, b)


def test_write_ply_bytes_equal_jax(tmp_path):
    sdf, o, sp = _sphere_grid(n=24)
    V, F = pmarching.marching_tets(sdf, 0.0, o, sp)
    write_ply(str(tmp_path / "port.ply"), V, F.astype(np.int32))
    j_write_ply(str(tmp_path / "jax.ply"), V, F.astype(np.int32))
    data = (tmp_path / "port.ply").read_bytes()
    assert data == (tmp_path / "jax.ply").read_bytes()
    head = f"element vertex {len(V)}\n".encode()
    assert head in data and data.endswith(b"\x03" + F[-1].astype("<i4").tobytes())
