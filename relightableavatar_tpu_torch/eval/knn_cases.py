"""Inputs and timing helpers for the Hopper top-3 KNN kernel, shared by
``chip_smoke.py``, ``eval/knn_bench.py`` and ``tests/test_torch_gpu.py``.

:func:`knn_cases` gives the exactness cases at the kernel's boundaries,
:func:`record_knn_inputs` records the KNN inputs of a rendered frame, and
:func:`time_in_turns` times several functions in turns with CUDA events.
"""
from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch

from relightableavatar_tpu_torch.models import anisdf

FRAME_BLOCKS = (8192, 24576, 32768)   # ray block, band samples, shadow block
CALLS_PER_TIMING = 20                 # back-to-back calls between one event pair
REPS = 7                              # timed turns per function
SYNTHETIC_NOISE = 0.03                # m: synthetic points are vertices + N(0, 3 cm)
# boundaries of the kernel's schedule: a warp's 32 points, a task's 2 x 32 R
# points for R = 1..4, the frame's block sizes, one past the last R switch;
# clouds of 3 vertices and around the resident capacity (10240 vertices)
CASE_P = (1, 31, 33, 63, 65, 127, 129, 191, 193, 255, 257,
          8191, 8192, 8193, 24575, 24576, 32768, 32769, 33793)
CASE_N = (3, 10239, 10240, 10241)
KNN_CASE_NAMES = ([f"P={P}" for P in CASE_P] + [f"N={n}" for n in CASE_N]
                  + ["duplicated", "on_vertices", "far_1km"])


def synthetic_points(verts: torch.Tensor, P: int, rng) -> torch.Tensor:
    """P points: random vertices of ``verts`` plus N(0, 3 cm) noise, in
    random order (no two neighbours of a warp lie near each other)."""
    vnp = verts.cpu().numpy()
    pts = vnp[rng.integers(0, len(vnp), P)] + rng.normal(0, SYNTHETIC_NOISE, (P, 3))
    return torch.as_tensor(pts.astype(np.float32), device=verts.device)


def knn_cases(verts: torch.Tensor, rng) -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """Exactness cases at the kernel's boundaries, named as in
    ``KNN_CASE_NAMES``: (name, pts, verts).  Synthetic points at each of
    ``CASE_P`` against the cloud; 4099 points against clouds of ``CASE_N``
    vertices (the cloud repeated); a duplicated cloud (exact ties, streamed
    in 2 tiles); points on the vertices (d2 = 0); a cloud 1 km away, where
    rounding makes ties common."""
    def tiled(n):
        reps = -(-n // verts.shape[0])
        return verts.repeat(reps, 1)[:n].contiguous()

    cases = [(f"P={P}", synthetic_points(verts, P, rng), verts) for P in CASE_P]
    for n in CASE_N:
        v = tiled(n)
        cases.append((f"N={n}", synthetic_points(v, 4099, rng), v))
    dup = torch.cat([verts, verts]).contiguous()
    cases.append(("duplicated", synthetic_points(verts, 4096, rng), dup))
    cases.append(("on_vertices", verts.clone(), verts))
    far = (verts + 1000.0).contiguous()
    cases.append(("far_1km", synthetic_points(far, 8192, rng), far))
    return cases


@contextlib.contextmanager
def record_knn_inputs(store: dict, sizes=FRAME_BLOCKS, tail: bool = True, last: bool = False):
    """While active, the HDQ's KNN calls go through unchanged, and ``store``
    gets a copy of (pts, verts) of the first call at each of ``sizes`` and,
    with ``tail``, of the first call at any other size ("tail"); with
    ``last``, also of the last call at each of ``sizes`` (key ``(size,
    "last")``)."""
    dispatch = anisdf.knn_top3

    def recording(pts, verts):
        key = pts.shape[0] if pts.shape[0] in sizes else "tail"
        if key not in store and (tail or key != "tail"):
            store[key] = (pts.clone(), verts.clone())
        if last and key != "tail":
            store[(key, "last")] = (pts.clone(), verts.clone())
        return dispatch(pts, verts)

    anisdf.knn_top3 = recording
    try:
        yield store
    finally:
        anisdf.knn_top3 = dispatch


def frame_input_name(key, pts: torch.Tensor) -> str:
    """Name of a recorded frame input: its point count, "tail" added."""
    return f"{pts.shape[0]}" + (" tail" if key == "tail" else "")


def cuda_ms(fn, calls: int = CALLS_PER_TIMING) -> float:
    """Milliseconds per call of ``fn``: one CUDA event pair around ``calls``
    back-to-back calls, divided by ``calls``."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def time_in_turns(fns: dict, reps: int = REPS) -> dict:
    """Median ms per call of each function, timed in turns: in every rep the
    functions run in order, then in reverse order (a, b, b, a), and every
    other rep starts from the other end (b, a, a, b)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for rep in range(reps):
        order = list(fns) if rep % 2 == 0 else list(fns)[::-1]
        for name in order + order[::-1]:
            times[name].append(cuda_ms(fns[name]))
    return {name: statistics.median(t) for name, t in times.items()}
