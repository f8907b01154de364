"""Where the time of the port's frames goes on the card.

    python -m relightableavatar_tpu_torch.eval.profile_frame [NAME ...]

Renders frames of fixture frame 0, camera 0, ``golden.FRAME_SIZE`` squared
(all of them, or the NAMEs given): ``exact``, the exact relight frame of
``chip_smoke.py``'s frame phase (``golden.frame_cfg()``); ``accel``,
``bench.py``'s ``relight_512_accel_skip`` (``golden.accel_frame_cfg()``:
SDF grid bake, slice sweep, miss skip, bfloat16 MLPs); ``sweep``,
``relight_sweep_8light`` (``golden.sweep_frame_cfg()``: the accel stack
without the miss skip, 8 lights re-shaded); ``volume`` and ``volume_cull32``,
``novel_view_512`` and ``novel_view_512_cull32``
(``golden.volume_frame_cfg()``: the stage-1 network, 128 samples a ray);
``train``, bench.py's reference stage-1 train step (``eval/train_check.py``:
4 frames x 1024 rays x 128 samples, bf16, the fixture's parameters), and
``train_relight``, the reference stage-2 step (``train_check.relight_step_cfg``:
2 frames x 1024 rays, 16 surface and 4 shadow iterations, 16 x 32 light
texels, bf16), one step standing for a frame.  Each is rendered once to warm up; then ``REPS`` timed frames of each in
turns (forward, then backward, ...); then one frame of each inside
``utils/profiling.collecting()``, whose program spans (the frame's bake,
sweep, miss march, ray blocks and their trace, band, visibility and shade,
assembly; the volume's cull bake and blocks; the step's forward, loss,
backward and update; each HDQ query) and counters (HDQ points and band
rows, host syncs by site) are printed, with no sync between stages; then
one frame of each under ``torch.profiler`` with CPU and CUDA activities.  Prints per frame
the timed frames' wall times, the union of the profiled frame's device
activity (its busy time) as a share of the median unprofiled wall time, of
the profiled wall time and of the span from first to last device activity,
the device launches and KNN kernel launches, device time by kernel
category, and the top kernels' device time and launch counts.  The
profiler's host-side tracing slows the host, so the share of the
unprofiled frame is the one to read.  Needs a CUDA device.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from relightableavatar_tpu_torch.data.datasets import load_lighting
from relightableavatar_tpu_torch.eval import golden, train_check
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.renderer.orchestrate import (NovelLightRenderer,
                                                             SphereTracingRenderer)
from relightableavatar_tpu_torch.renderer.volume import VolumeRenderer
from relightableavatar_tpu_torch.utils import profiling

REPS = 3    # unprofiled timed frames of each
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
    if "gemm" in low or "cutlass" in low or "cublas" in low or "xmma" in low:
        return "matmul bf16 (cuBLAS)" if "bf16" in low else "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("index", "gather", "scatter", "nonzero", "where")):
        return "index / gather / nonzero"
    if "reduce" in low or "sum" in low:
        return "reductions"
    return "elementwise and other"


def _wall(renderer, batch) -> float:
    t0 = time.perf_counter()
    renderer.render(batch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _report(name, renderer, batch, n_rays, walls) -> None:
    """Profile one frame of ``renderer`` and print its numbers."""
    knn_cuda.KNN_TOP3.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _wall(renderer, batch)
    launches = knn_cuda.KNN_TOP3.launches
    events = _device_events(prof)
    if not events:
        raise SystemExit("the profiler recorded no device activity")
    first = min(s for _, s, _ in events)
    last = max(e for _, _, e in events)
    busy_s = _busy_us([(s, e) for _, s, e in events]) / 1e6
    per_name: dict[str, list] = {}
    for ev_name, s, e in events:
        acc = per_name.setdefault(ev_name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
    rows = [(n, us, count) for n, (us, count) in per_name.items()]
    device_s = sum(us for _, us, _ in rows) / 1e6
    span_s = (last - first) / 1e6
    unprof_s = statistics.median(walls)
    what = "step" if isinstance(renderer, TrainStep) else \
        f"frame {golden.FRAME_SIZE}x{golden.FRAME_SIZE}"
    print(f"[{name}] {what}: {n_rays} rays; wall "
          "times without the profiler: " + ", ".join(f"{w:.3f} s" for w in walls), flush=True)
    print(f"[{name}] device busy {busy_s:.3f} s = {busy_s / unprof_s:.1%} of the median "
          f"unprofiled wall time {unprof_s:.3f} s, {busy_s / wall:.1%} of the wall time "
          f"under the profiler {wall:.3f} s, {busy_s / span_s:.1%} of the first-to-last "
          f"device activity {span_s:.3f} s; {len(events)} device launches; KNN kernel "
          f"launches {launches}", flush=True)
    cats: dict[str, float] = {}
    for ev_name, us, _ in rows:
        cats[_category(ev_name)] = cats.get(_category(ev_name), 0.0) + us
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[{name}]   {cat:28s} {us / 1e3:10.3f} ms  {us / 1e6 / device_s:6.1%} "
              "of device time")
    print(f"[{name}] top {TOP} kernels by device time:")
    for ev_name, us, count in sorted(rows, key=lambda r: -r[1])[:TOP]:
        print(f"[{name}]   {us / 1e3:10.3f} ms  x{count:6d}  {ev_name[:90]}")


class TrainStep:
    """A reference train step (stage 1, or stage 2 where ``cfg.relighting``)
    behind the renderers' interface: ``render(batch)`` takes one optimiser
    step on ``batch``."""

    def __init__(self, cfg, device="cuda"):
        self.R = train_check.RELIGHT_R if cfg.relighting else train_check.BENCH_R
        self.trainer, self.batch = train_check.make_step(cfg, device, self.R)
        self.last_frame = {}

    def render(self, batch):
        self.trainer.step(batch, 0)


def _train_cfg():
    return train_check.step_cfg(train_check.BENCH_B, train_check.BENCH_S, bf16=True,
                                perturb=True)


FRAMES = (("exact", golden.frame_cfg, SphereTracingRenderer),
          ("accel", golden.accel_frame_cfg, SphereTracingRenderer),
          ("sweep", golden.sweep_frame_cfg, NovelLightRenderer),
          ("volume", golden.volume_frame_cfg, VolumeRenderer),
          ("volume_cull32", lambda: golden.volume_frame_cfg(32), VolumeRenderer),
          ("train", _train_cfg, TrainStep),
          ("train_relight", lambda: train_check.relight_step_cfg(bf16=True), TrainStep))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)

    frames = {}
    for name, cfg, cls in FRAMES:
        if len(sys.argv) > 1 and name not in sys.argv[1:]:
            continue
        cfg = cfg()
        if cls is TrainStep:
            renderer = TrainStep(cfg)
            batch, n_rays = renderer.batch, int(cfg.train.batch_size) * renderer.R
        else:
            ctx, params, mcfg = golden.load_fixture(cfg, device="cuda")
            renderer = cls(cfg, params, mcfg, device="cuda")
            batch, mab = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
            n_rays = int(mab.sum())
        if cls is NovelLightRenderer:
            batch.novel_lights = load_lighting(cfg)
        _wall(renderer, batch)
        frames[name] = (renderer, batch, n_rays, [])
    order = list(frames)
    for rep in range(REPS):
        turn = order if rep % 2 == 0 else order[::-1]
        for name in turn:
            renderer, batch, _, walls = frames[name]
            walls.append(_wall(renderer, batch))
    for name, (renderer, batch, _, _) in frames.items():
        profiling.reset()
        with profiling.collecting():
            wall = _wall(renderer, batch)
        lf = renderer.last_frame
        blocks = (f"; ray blocks rendered {lf.get('blocks_rendered', lf.get('blocks'))} of "
                  f"{lf.get('blocks')}" if lf else "")
        print(f"[{name}] spans ({wall:.3f} s wall, no sync between stages): "
              f"{profiling.summary()}{blocks}", flush=True)
        profiling.reset()
    for name, (renderer, batch, n_rays, walls) in frames.items():
        _report(name, renderer, batch, n_rays, walls)


if __name__ == "__main__":
    main()
