"""Build, binding and launch wrapper of the Hopper top-3 KNN kernel
(``csrc/knn_top3.cu``), the port of the TPU kernel ``_knn_kernel``
(``relightableavatar_tpu/ops/pallas_knn.py:28``).

The source has a plain C interface.  At first use it is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (named by the
source's hash, so an edited source is rebuilt) and loaded with ``ctypes``.
The wrapper checks its inputs, allocates the outputs, launches on PyTorch's
current stream without synchronising, raises if the launch failed, and
counts its launches in ``KNN_TOP3.launches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "knn_top3.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def build_library(source: str = SOURCE, build_dir: str = BUILD_DIR):
    """Compile ``source`` into ``build_dir`` unless a library of the same
    source hash is there.  Returns (path, seconds, compiler log); seconds is
    0.0 and the log empty when nothing was built."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(build_dir, f"lib{name}_{digest}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)       # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


class KnnTop3Kernel:
    """The loaded kernel library and its launch count.  ``source`` may name
    another file with the same C interface (an earlier version of the
    kernel, to time beside this one); it is built into ``build_dir``."""

    def __init__(self, source: str = SOURCE, build_dir: str = BUILD_DIR):
        self.source = source
        self.build_dir = build_dir
        self.launches = 0
        self.build_seconds = 0.0
        self.build_log = ""
        self.path = None
        self._lib = None
        self._fn = None

    def load(self):
        """Build (if needed) and bind the library; idempotent."""
        if self._fn is None:
            self.path, self.build_seconds, self.build_log = build_library(
                self.source, self.build_dir)
            lib = ctypes.CDLL(self.path)
            fn = lib.knn_top3_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib = lib
            self._fn = fn
        return self

    def __call__(self, pts: torch.Tensor, verts: torch.Tensor):
        """pts (P, 3), verts (N, 3) float32 contiguous CUDA tensors on one
        device, N >= 3 -> d2 (P, 3) float32, idx (P, 3) int32."""
        for name, t in (("pts", pts), ("verts", verts)):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if t.dim() != 2 or t.shape[1] != 3:
                raise ValueError(f"{name} must have shape (n, 3), got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.device.type != "cuda":
                raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if pts.device != verts.device:
            raise ValueError("pts and verts must be on the same device")
        P, N = pts.shape[0], verts.shape[0]
        if N < 3:
            raise ValueError(f"need at least 3 vertices, got {N}")
        if P >= 2 ** 31 // 3 or N >= 2 ** 31 // 3:
            raise ValueError("too many points or vertices for int32 offsets")
        d2 = torch.empty((P, 3), dtype=torch.float32, device=pts.device)
        idx = torch.empty((P, 3), dtype=torch.int32, device=pts.device)
        if P == 0:
            return d2, idx
        self.load()
        with torch.cuda.device(pts.device):
            stream = torch.cuda.current_stream(pts.device).cuda_stream
            err = self._fn(pts.data_ptr(), verts.data_ptr(), d2.data_ptr(),
                           idx.data_ptr(), P, N, stream)
        if err != 0:
            raise RuntimeError(f"knn_top3_f32 launch failed: cudaError {err}")
        self.launches += 1
        return d2, idx


KNN_TOP3 = KnnTop3Kernel()


def knn_top3_cuda(pts: torch.Tensor, verts: torch.Tensor):
    """Launch the Hopper top-3 KNN kernel (see :class:`KnnTop3Kernel`)."""
    return KNN_TOP3(pts, verts)
