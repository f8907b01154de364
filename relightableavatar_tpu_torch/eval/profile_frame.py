"""Where the time of one exact relight frame goes on the card.

    python -m relightableavatar_tpu_torch.eval.profile_frame

Renders the frame of ``chip_smoke.py``'s frame phase (fixture frame 0,
camera 0, ``golden.FRAME_SIZE`` squared, ``golden.frame_cfg()``) once to warm
up, ``REPS`` times timed, then once more under ``torch.profiler`` with CPU
and CUDA activities.  Prints the timed frames' wall times, the union of the
profiled frame's device activity (its busy time) as a share of the median
unprofiled wall time, of the profiled wall time and of the span from first
to last device activity, device time by kernel category, and the top
kernels' device time and launch counts.  The profiler's host-side tracing
slows the host, so the share of the unprofiled frame is the one to read.
Needs a CUDA device.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer

REPS = 3    # unprofiled timed frames
TOP = 15    # kernels listed by device time


def _device_events(prof):
    """(name, start_us, end_us) of every kernel and copy the card ran."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _busy_us(spans) -> float:
    """Length of the union of the (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _category(name: str) -> str:
    low = name.lower()
    if "knn_top3" in low:
        return "knn_top3 kernel"
    if "gemm" in low or "cutlass" in low or "cublas" in low:
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("index", "gather", "scatter", "nonzero", "where")):
        return "index / gather / nonzero"
    if "reduce" in low or "sum" in low:
        return "reductions"
    return "elementwise and other"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)

    cfg = golden.frame_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cuda")
    renderer = SphereTracingRenderer(cfg, params, mcfg, device="cuda")
    batch, mab = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
    renderer.render(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        renderer.render(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print("frame wall times without the profiler: "
          + ", ".join(f"{w:.3f} s" for w in walls), flush=True)

    knn_cuda.KNN_TOP3.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = knn_cuda.KNN_TOP3.launches

    events = _device_events(prof)
    if not events:
        raise SystemExit("the profiler recorded no device activity")
    first = min(s for _, s, _ in events)
    last = max(e for _, _, e in events)
    busy_s = _busy_us([(s, e) for _, s, e in events]) / 1e6
    per_name: dict[str, list] = {}
    for name, s, e in events:
        acc = per_name.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
    rows = [(name, us, count) for name, (us, count) in per_name.items()]
    device_s = sum(us for _, us, _ in rows) / 1e6
    span_s = (last - first) / 1e6
    unprof_s = statistics.median(walls)
    print(f"frame {golden.FRAME_SIZE}x{golden.FRAME_SIZE}: {int(mab.sum())} rays; "
          f"device busy {busy_s:.3f} s = {busy_s / unprof_s:.1%} of the median "
          f"unprofiled wall time {unprof_s:.3f} s, {busy_s / wall:.1%} of the "
          f"wall time under the profiler {wall:.3f} s, {busy_s / span_s:.1%} of "
          f"the first-to-last device activity {span_s:.3f} s; {len(events)} "
          f"device launches; KNN kernel launches {launches}", flush=True)
    cats: dict[str, float] = {}
    for name, us, _ in rows:
        cats[_category(name)] = cats.get(_category(name), 0.0) + us
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {us / 1e3:10.3f} ms  {us / 1e6 / device_s:6.1%} of device time")
    print(f"top {TOP} kernels by device time:")
    for name, us, count in sorted(rows, key=lambda r: -r[1])[:TOP]:
        print(f"  {us / 1e3:10.3f} ms  x{count:6d}  {name[:90]}")


if __name__ == "__main__":
    main()
