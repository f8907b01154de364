"""The traced run's records: the K1 launches' shapes, and what a
``torch.profiler`` window of a few steps or frames holds (device time by
kernel, the union of device activity, the NCCL all-reduce kernels, the
idle gaps between device work and the host op that was running in each).
Everything is read from the profiler's events in memory; no trace file is
written."""
from __future__ import annotations

import heapq
import time

import torch

from portbench.flops import union_s

TOP = 10            # entries of each breakdown list


class KnnRecorder:
    """Puts a recorder of each launch's (points, vertices) around the
    port's K1 wrapper (``ops/knn_cuda.KNN_TOP3``), which its callers look up
    at every call; on exit, checks that it saw exactly the launches the
    wrapper's own counter counted."""

    def __init__(self):
        self.shapes = []

    def __enter__(self):
        from relightableavatar_tpu_torch.ops import knn_cuda
        self._mod = knn_cuda
        self._kernel = knn_cuda.KNN_TOP3
        self._start = self._kernel.launches
        kernel, shapes = self._kernel, self.shapes

        class Wrapped:
            def __call__(self, pts, verts):
                out = kernel(pts, verts)
                if pts.shape[0]:
                    shapes.append((int(pts.shape[0]), int(verts.shape[0])))
                return out

            def __getattr__(self, name):
                return getattr(kernel, name)

        knn_cuda.KNN_TOP3 = Wrapped()
        return self

    def __exit__(self, *exc):
        self._mod.KNN_TOP3 = self._kernel
        counted = self._kernel.launches - self._start
        if exc[0] is None and counted != len(self.shapes):
            raise RuntimeError(f"K1 recorder saw {len(self.shapes)} launches, the kernel's "
                               f"counter {counted}")
        return False


def profile_units(run_one, n: int, device) -> tuple:
    """Run ``run_one`` ``n`` times under the profiler (CPU and CUDA), each
    ending in a synchronize; returns (profile, wall seconds, K1 shapes)."""
    from torch.profiler import ProfilerActivity, profile
    with KnnRecorder() as knn:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                run_one()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    return prof, wall, knn.shapes


def read_profile(prof) -> dict:
    """Device spans and host ops of a profile, reduced: ``busy_s`` (union
    of device activity), ``device_s`` by kernel name, ``knn_s`` (K1's
    kernels), ``allreduce_s`` (NCCL all-reduce kernels), ``gaps_s`` (idle
    time between device work by the innermost host op running in the
    gap's middle)."""
    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if getattr(e, "is_user_annotation", False):
            continue        # a named region (``record_function``), not device work
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((span[0], span[1], e.name))
        elif span[1] > span[0]:
            host.append((span[0], span[1], e.name))
    device_s: dict = {}
    for s, t, name in dev:
        device_s[name] = device_s.get(name, 0.0) + (t - s) / 1e6
    low = lambda n: n.lower()
    knn_s = sum(v for k, v in device_s.items() if "knn_top3" in low(k))
    allreduce_s = sum(v for k, v in device_s.items()
                      if "nccl" in low(k) and "allreduce" in low(k))
    return dict(busy_s=union_s([(s, t) for s, t, _ in dev]) / 1e6, device_s=device_s,
                knn_s=knn_s, allreduce_s=allreduce_s, gaps_s=_gaps(dev, host),
                device_events=len(dev))


def _gaps(dev: list, host: list) -> dict:
    """Idle seconds between merged device intervals, summed by the name of
    the innermost host op running in each gap's middle: of the host ops
    that cover it, the one that started last (a sweep over both in time
    order, the started ops in a heap keyed by their start)."""
    merged = []
    for s, t, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps = sorted(((end + nxt) / 2, nxt - end) for (_, end), (nxt, _) in
                  zip(merged, merged[1:]))
    host = sorted(host)
    out: dict = {}
    heap: list = []
    i = 0
    for mid, g in gaps:
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(between host ops)"
        out[name] = out.get(name, 0.0) + g / 1e6
    return out


def top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
