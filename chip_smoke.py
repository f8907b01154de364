"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one flushed line with its wall seconds:
  device  card name and count, nvidia-smi name and power limit, versions;
          fails when torch finds no CUDA device
  build   nvcc of the top-3 KNN kernel into relightableavatar_tpu_torch/_build/,
          with ptxas' register and shared-memory lines
  knn     the kernel against its plain PyTorch version on the card, at the
          point counts the relight frame gives it, plus an exact-tie case;
          CUDA-event timings of runs of back-to-back calls (plain, kernel,
          kernel, plain in turns) and the torch.cdist + topk yardstick
  golden  the fixture's 256-ray golden bundle, >= 50 dB against
          tests/golden_relight_24px.npy
  frame   one exact relight frame of fixture frame 0 (camera 0, 512x512,
          ``golden.frame_cfg()``) through SphereTracingRenderer.render, with
          the kernel's launch count for that frame; then the same frame at
          64x64 with the kernel and with the plain KNN, agreeing to >= 50 dB
The last three lines are nvidia-smi's "name, power limit" line, a
{"kernels": [...]} JSON object and {"ok": true, "device": {...}}.  Any
failed check exits non-zero before them.  Imports nothing but the port, torch, numpy and the standard
library; reads only tracked files.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.ops.knn import knn_top3_reference
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer

# published H100 SXM peaks (NVIDIA H100 datasheet): FP32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
KNN_OPS_PER_PAIR = 9        # 3 sub, 3 mul, 2 add, 1 compare
KNN_P_SIZES = (8192, 24576, 32768, 8193, 1)   # ray block, band, shadow block, ragged
TIMED_P = 32768             # the shadow-ray block: most of the frame's launches
NEAR_TIE = 1e-6
REPS = 7                    # timed turns per version
CALLS_PER_TIMING = 20       # back-to-back calls between one CUDA event pair


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


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


def compare_knn(d2k, ik, d2r, ir):
    """(max |d2 diff|, share of points whose idx differ outside near ties,
    share of points whose idx differ at near ties)."""
    d2k, ik, d2r, ir = (t.cpu().numpy() for t in (d2k, ik, d2r, ir))
    err = float(np.abs(d2k - d2r).max()) if d2k.size else 0.0
    bad = (ik != ir).any(axis=1)
    gaps = np.abs(np.diff(d2r, axis=1))
    tie = (gaps <= NEAR_TIE * np.maximum(d2r[:, 1:], 1e-6)).any(axis=1)
    n = max(len(ik), 1)
    return err, float((bad & ~tie).sum() / n), float((bad & tie).sum() / n)


def knn_bound_ms(P: int, N: int) -> tuple[float, str]:
    ops = KNN_OPS_PER_PAIR * P * N
    nbytes = 12 * P + 12 * N + 12 * P + 12 * P      # pts, verts in; d2, idx out
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    # ---- device
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on a GPU only", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    clocks = nvidia_smi("clocks.max.sm,clocks.sm")
    phase("device", t0, f"{kind} x{count}; nvidia-smi: {smi}; sm clock max,now: "
          f"{clocks}; python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # ---- build
    t0 = time.perf_counter()
    kern = knn_cuda.KNN_TOP3.load()
    for line in kern.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)
    phase("build", t0, f"{kern.path} built in {kern.build_seconds:.2f} s")

    # ---- fixture
    t0 = time.perf_counter()
    cfg = golden.frame_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cuda")
    verts = ctx["pverts"]
    N = verts.shape[0]
    phase("fixture", t0, f"frame 0 context and avatar on {dev}: {N} vertices")

    # ---- knn
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    vnp = verts.cpu().numpy()
    max_err = 0.0
    for P in KNN_P_SIZES:
        pts_np = vnp[rng.integers(0, N, P)] + rng.normal(0, 0.03, (P, 3))
        pts = torch.as_tensor(pts_np.astype(np.float32), device=dev)
        d2k, ik = knn_cuda.knn_top3_cuda(pts, verts)
        d2r, ir = knn_top3_reference(pts, verts)
        torch.cuda.synchronize()
        err, miss, tie_miss = compare_knn(d2k, ik, d2r, ir)
        max_err = max(max_err, err)
        check(ik.dtype == torch.int32 and d2k.shape == (P, 3), "kernel output type/shape")
        check(err <= 1e-6, f"P={P}: d2 differs from the plain version by {err}")
        check(miss == 0.0, f"P={P}: idx differs outside near ties at {miss:.2e} of points")
        check(tie_miss <= 1e-4, f"P={P}: idx differs at near ties at {tie_miss:.2e}")
        print(f"[knn] P={P}: max |d2 - plain| {err:.3e}, idx differing "
              f"{miss:.2e} (+{tie_miss:.2e} at near ties)", flush=True)
    # exact ties: every vertex twice; the lower index must win
    vdup = torch.cat([verts, verts]).contiguous()
    pts = torch.as_tensor((vnp[rng.integers(0, N, 4096)]
                           + rng.normal(0, 0.03, (4096, 3))).astype(np.float32), device=dev)
    d2k, ik = knn_cuda.knn_top3_cuda(pts, vdup)
    d2r, ir = knn_top3_reference(pts, vdup)
    check(torch.equal(ik, ir) and torch.equal(d2k, d2r), "tie case differs from plain")
    check(bool((ik[:, 0] < N).all()) and bool((ik[:, 1] == ik[:, 0] + N).all()),
          "exact ties did not go to the lowest index")
    print("[knn] duplicated vertices: ties resolved to the lowest index, "
          "identical to the plain version", flush=True)

    pts_np = vnp[rng.integers(0, N, TIMED_P)] + rng.normal(0, 0.03, (TIMED_P, 3))
    pts = torch.as_tensor(pts_np.astype(np.float32), device=dev)
    kernel_fn = lambda: knn_cuda.knn_top3_cuda(pts, verts)
    plain_fn = lambda: knn_top3_reference(pts, verts)
    library_fn = lambda: torch.cdist(pts, verts).topk(3, dim=1, largest=False)
    for fn in (kernel_fn, plain_fn, library_fn):
        fn()
    torch.cuda.synchronize()
    plain_t, kern_t, lib_t = [], [], []
    for _ in range(REPS):
        plain_t.append(cuda_ms(plain_fn))
        kern_t += [cuda_ms(kernel_fn), cuda_ms(kernel_fn)]
        plain_t.append(cuda_ms(plain_fn))
        lib_t.append(cuda_ms(library_fn))
    kern_ms, plain_ms, lib_ms = (statistics.median(t) for t in (kern_t, plain_t, lib_t))
    _, ik = kernel_fn()
    lib_idx = library_fn().indices
    lib_agree = float((lib_idx.to(torch.int32) == ik).all(dim=1).float().mean())
    bound_ms, bound_by = knn_bound_ms(TIMED_P, N)
    phase("knn", t0, f"P={TIMED_P} N={N}, ms per call over runs of "
          f"{CALLS_PER_TIMING} calls: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+topk {lib_ms:.4f} ms (top-3 sets equal on {lib_agree:.4%} of points), "
          f"bound {bound_ms:.4f} ms by {bound_by}")

    # ---- golden
    t0 = time.perf_counter()
    out = golden.render_golden_bundle(ctx, params, mcfg, device="cuda")
    img = out.rgb_map.cpu().numpy()
    ref = np.load(golden.GOLDEN_RELIGHT_24)
    check(img.shape == ref.shape and np.isfinite(img).all(), "golden bundle shape/finite")
    g_psnr = golden.psnr(img, ref)
    check(g_psnr >= 50.0, f"golden bundle {g_psnr:.2f} dB < 50 dB")
    phase("golden", t0, f"256-ray bundle vs tests/golden_relight_24px.npy: {g_psnr:.2f} dB")

    # ---- frame (the main path)
    t0 = time.perf_counter()
    renderer = SphereTracingRenderer(cfg, params, mcfg, device="cuda")
    batch, mab = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.KNN_TOP3.launches = 0
    t1 = time.perf_counter()
    res = renderer.render(batch)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t1
    launches = knn_cuda.KNN_TOP3.launches
    check(launches > 0, "the frame did not launch the KNN kernel")
    n_fg = int(mab.sum())
    rgb, acc = res.rgb_map, res.acc_map
    check(rgb.shape == (n_fg, 3) and acc.shape == (n_fg,), "frame output shapes")
    for k, v in res.items():
        if isinstance(v, torch.Tensor):
            check(bool(torch.isfinite(v).all()), f"frame {k} not finite")
    check(bool((acc >= 0).all() and (acc <= 1).all()), "acc outside [0, 1]")
    hits = int((acc > 0).sum())
    check(hits > 0, "the frame hit nothing")
    phase("frame", t0, f"{golden.FRAME_SIZE}x{golden.FRAME_SIZE}: {n_fg} rays in the body's bounds, "
          f"{hits} hit; render {frame_s:.3f} s = {n_fg / frame_s:.0f} rays/s; "
          f"KNN kernel launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # same frame at 64x64, kernel vs plain KNN (launches here are not counted)
    t0 = time.perf_counter()
    small, _ = golden.frame_batch(ctx, 64, 64)
    img_k = renderer.render(small).rgb_map.cpu().numpy()
    dispatch = anisdf.knn_top3
    anisdf.knn_top3 = knn_top3_reference
    try:
        img_p = renderer.render(small).rgb_map.cpu().numpy()
    finally:
        anisdf.knn_top3 = dispatch
    f_psnr = golden.psnr(img_k, img_p)
    check(f_psnr >= 50.0, f"64x64 frame kernel vs plain KNN {f_psnr:.2f} dB < 50 dB")
    phase("frame", t0, f"64x64 kernel vs plain KNN: {f_psnr:.2f} dB "
          f"(max |diff| {float(np.abs(img_k - img_p).max()):.3e})")

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "knn_top3",
        "route": "cuda",
        "source": "relightableavatar_tpu_torch/csrc/knn_top3.cu",
        "replaces": "relightableavatar_tpu/ops/pallas_knn.py:28",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
