"""Build and ``ctypes`` binding of the host C++ mesh library:
``csrc/marching.cpp`` (marching tetrahedra) and ``csrc/decimate.cpp`` (QEM
decimation), copies of ``relightableavatar_tpu/native/*.cpp`` with the same
C interface (``relightableavatar_tpu/native/__init__.py:27-45``).

At first use the two sources are compiled with the JAX package's own flags
(``g++ -O3 -march=native -shared -fPIC -std=c++17``) into ``_build/`` (named
by a hash of the sources, the flags and the host CPU's features, so an
edited source, or another machine, gets its own build) and loaded
with ``ctypes``.  Unlike the JAX package's loader, which falls back to numpy,
a failed build raises with the compiler's output: the numpy versions
(``ops/marching.py:_marching_tets_numpy``, ``ops/meshtools.py:_cluster_decimate``)
are the plain versions for the tests, not a second path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, "csrc", "marching.cpp"),
           os.path.join(_PKG, "csrc", "decimate.cpp")]
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


class NativeBuildError(RuntimeError):
    """The host C++ library did not build."""


def _cpu_flags() -> str:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    library built on another machine is not reused."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return platform.machine()


def build_library(sources=SOURCES, build_dir: str = BUILD_DIR, compiler: str = "g++"):
    """Compile ``sources`` into one shared library in ``build_dir`` unless a
    library of the same hash (sources, flags, host CPU features) is there.
    Returns (path, seconds); seconds is 0.0 when nothing was built.  Raises
    :class:`NativeBuildError` with the compiler's output when the build
    fails."""
    h = hashlib.sha256(" ".join([compiler, *GXX_FLAGS, _cpu_flags()]).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"libra_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, 0.0
    exe = shutil.which(compiler)
    if exe is None:
        raise NativeBuildError(f"{compiler} not found on PATH: it builds "
                               f"{', '.join(map(os.path.basename, sources))}")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([exe, *GXX_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise NativeBuildError(f"{compiler} failed ({proc.returncode}) on "
                                   f"{' '.join(sources)}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)       # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0


_LIB = None


def load():
    """Build (if needed) and bind the library; idempotent."""
    global _LIB
    if _LIB is None:
        path, _ = build_library()
        lib = ctypes.CDLL(path)
        lib.ra_marching_tets.restype = ctypes.c_int
        lib.ra_marching_tets.argtypes = [
            _F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            _F32P, _F32P, ctypes.POINTER(_F32P), _I64P, ctypes.POINTER(_I64P), _I64P]
        lib.ra_free.argtypes = [ctypes.c_void_p]
        lib.ra_decimate.restype = ctypes.c_int
        lib.ra_decimate.argtypes = [
            _F32P, ctypes.c_int64, _I64P, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(_F32P), _I64P, ctypes.POINTER(_I64P), _I64P]
        _LIB = lib
    return _LIB


def _take(lib, name, rc, vp, nv, fp, nf):
    """Copy the library's out buffers into numpy and free them."""
    try:
        if rc != 0:
            raise RuntimeError(f"{name} returned {rc}")
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        V = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        F = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy()
        return V, F
    finally:
        if vp:
            lib.ra_free(vp)
        if fp:
            lib.ra_free(fp)


def marching_tets_native(sdf: np.ndarray, level: float = 0.0,
                         origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
    """sdf (X, Y, Z) -> (verts (V, 3) float32, faces (F, 3) int64), windings
    as the C++ leaves them (``ops/marching.py:marching_tets`` orients them)."""
    sdf = np.ascontiguousarray(sdf, np.float32)
    if sdf.ndim != 3:
        raise ValueError(f"sdf must be a 3-d grid, got shape {sdf.shape}")
    lib = load()
    X, Y, Z = sdf.shape
    origin = np.ascontiguousarray(origin, np.float32)
    spacing = np.ascontiguousarray(spacing, np.float32)
    vp, fp = _F32P(), _I64P()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.ra_marching_tets(
        sdf.ctypes.data_as(_F32P), X, Y, Z, ctypes.c_float(level),
        origin.ctypes.data_as(_F32P), spacing.ctypes.data_as(_F32P),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp), ctypes.byref(nf))
    return _take(lib, "ra_marching_tets", rc, vp, nv, fp, nf)


def decimate_native(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """QEM edge-collapse decimation (``csrc/decimate.cpp``)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int64)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"verts and faces must be (n, 3), got {verts.shape} and {faces.shape}")
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError(f"face indices outside [0, {len(verts)})")
    lib = load()
    vp, fp = _F32P(), _I64P()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.ra_decimate(
        verts.ctypes.data_as(_F32P), len(verts), faces.ctypes.data_as(_I64P), len(faces),
        ctypes.c_int64(int(target_faces)),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp), ctypes.byref(nf))
    return _take(lib, "ra_decimate", rc, vp, nv, fp, nf)
