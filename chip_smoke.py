"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one flushed line with its wall seconds:
  device  card name and count, nvidia-smi name and power limit, versions;
          fails when torch finds no CUDA device
  build   nvcc of the top-3 KNN kernel into relightableavatar_tpu_torch/_build/,
          with ptxas' register and shared-memory lines
  knn     the kernel bit for bit against its plain PyTorch version on the
          card at every boundary of its schedule (``knn_cases.knn_cases``:
          point counts around a warp's and a task's points and the frame's
          block sizes, 3 vertices, clouds around the resident capacity, a
          duplicated cloud, points on the vertices, a cloud 1 km away);
          CUDA-event timings of runs of back-to-back calls (plain, kernel,
          kernel, plain in turns) and the torch.cdist + topk yardstick at
          P = 32768, and the kernel, the plain version and cdist + topk at
          each of the frame's block sizes
  golden  the fixture's 256-ray golden bundle, >= 50 dB against
          tests/golden_relight_24px.npy
  frame   one exact relight frame of fixture frame 0 (camera 0, 512x512,
          ``golden.frame_cfg()``) through SphereTracingRenderer.render, with
          the kernel's launch count for that frame, recording the KNN inputs
          of the first call at each of its block sizes and of its first
          smaller call; then the same frame at 64x64 with the kernel and with
          the plain KNN, agreeing to >= 50 dB
  benchstack  the 64x64 bench-stack frame (48-node SDF grid, slice sweep,
          2x-coarser visibility, distant envmap) >= 45 dB against
          tests/golden_benchstack_64px.npy; the same frame with the miss skip
          on, within 1e-5 of it; the sweep volume of that frame's grid on the
          card against the same sweep on the CPU, within 1e-6 relative
  accel-frame  bench.py's relight_512_accel_skip frame of the fixture
          (``golden.accel_frame_cfg()``: 96-node grid, slice sweep, miss
          skip, bfloat16 MLPs) through SphereTracingRenderer.render, with its
          launch count, recording the grid bake's first KNN input; then once
          more with a device sync after each stage for the stage times
  sweep-frame  bench.py's relight_sweep_8light frame (``golden.sweep_frame_cfg()``:
          the accel stack without the miss skip, 8 lights) through
          NovelLightRenderer.render: base pass and re-shade seconds, KNN
          launches, peak memory; the 8 rgb maps finite and pairwise
          different; the re-shade on the card against the plain (P, L, 3)
          reshade_dense on the first 4096 rays that hit, for every light; then one
          light x 128 rotations, rotation 4 equal to the probe rolled by one
          texel column
  ground  the accel frame with the full-frame ground pass
          (``golden.ground_frame_cfg()``): seconds, shadow rays traced, KNN
          launches; H x W maps, acc all ones, finite, the ground lit; then
          the 32x32 ground frame on the card against the CPU
  volume-frame  bench.py's novel_view_512 and novel_view_512_cull32 frames
          (``golden.volume_frame_cfg()``: the stage-1 network, 128 samples a
          ray, 8192-ray blocks of 1,048,576 points) through
          VolumeRenderer.render: seconds, rays/s, KNN launches, peak memory,
          culled against exact; then the 32x32 volume frame on the card
          against the CPU
  knn-frame  the kernel bit for bit against the plain version on the
          recorded frame inputs (the bake's 180,224 points and the volume's
          first and last 1,048,576-point blocks included), its time on each
          and its bound, beside the plain version's and torch.cdist + topk's
          (in chunks of 262,144 points) on the same inputs
  cli     the user's entry points as subprocesses, in a temporary directory:
          ``python -m relightableavatar_tpu_torch.data.make_synthetic``
          (2 frames x 4 views at 512x512), the fixture's parameters written
          as the checkpoint that ``make_network`` finds, then
          ``python -m relightableavatar_tpu_torch.run -t`` dataset, network
          (its mean render time), evaluate at the generator's exact settings
          with mask_bkgd off (>= 50 dB against the generated images), evaluate with the
          config's own defaults (printed, not held), visualize (one file per
          enabled Output type per frame); then the first CLI frame rendered
          in this process, its KNN launches counted, the kernel bit for bit
          against the plain version on its recorded inputs
The last three lines are nvidia-smi's "name, power limit" line, a
{"kernels": [...]} JSON object and {"ok": true, "device": {...}}.  Any
failed check exits non-zero before them.  Imports nothing but the port, torch, numpy and the standard
library; reads only tracked files.
"""
from __future__ import annotations

import ast
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from relightableavatar_tpu_torch.config import setup
from relightableavatar_tpu_torch.data.datasets import load_lighting, make_data_loader
from relightableavatar_tpu_torch.data.image_io import read_rgb, write_png
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.eval.knn_cases import (
    FRAME_BLOCKS, cuda_ms, frame_input_name, knn_cases, record_knn_inputs, synthetic_points,
    time_in_turns)
from relightableavatar_tpu_torch.ops.sdf_grid import bake_chunk
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.factory import make_network, make_renderer
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.ops.knn import knn_top3_reference
from relightableavatar_tpu_torch.renderer.orchestrate import (NovelLightRenderer,
                                                             SphereTracingRenderer,
                                                             reshade_dense)
from relightableavatar_tpu_torch.renderer.volume import VolumeRenderer

# published H100 SXM peaks (NVIDIA H100 datasheet): FP32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# the kernel's fast path a pair: the filter |v|^2 - 2 p.v as 3 FMAs (2 operations
# each, as the peak counts them) and 1 compare (an fminf of 4 vertices' values,
# or the compare of their minimum); the exact d2 of the rare candidates is left out
KNN_OPS_PER_PAIR = 7
TIMED_P = 32768             # the shadow-ray block: most of the frame's launches
REPS = 7                    # timed turns per version
SWEEP_RTOL = 1e-6           # card vs CPU sweep: gathers and elementwise ops only
SKIP_ATOL = 1e-5            # miss skip on vs off (tests/test_golden.py:194)
# re-shade of the card's sweep against the plain (P, L, 3) form: float32 sums
# over 512 texels in another order (cuBLAS products against torch.sum), then
# the sRGB curve, whose slope reaches 12.9 near black
RESHADE_ATOL = 2e-4
RESHADE_RAYS = 4096         # hit rays of the sweep frame held to the plain form
ROTATE_ATOL = 1e-6          # rotation by a whole texel column against np.roll
ROTATIONS = 4               # rotate_ratio: 32 x 4 = 128 probes a light
# the small frames on the card against the CPU: float32 both, TF32 off; the
# MLP sums run in another order, which the traces can turn into a changed
# silhouette pixel
CARD_CPU_MIN_PSNR = 50.0
VOLUME_P = 8192 * 128       # points of one volume ray block
CDIST_CHUNK = 262144        # points a torch.cdist call of the yardstick (7.2 GB at N = 6890)
REPO = os.path.dirname(os.path.abspath(__file__))
# the CLI phase: tubeman's config on a generated 2-frame, 4-view 512x512 tree
CLI_CFG = "configs/synthetic/tubeman.yaml"
CLI_FRAMES, CLI_VIEWS, CLI_VIEW = 2, 4, 3      # tubeman's test_view is [3]
CLI_MIN_PSNR = 50.0         # same program, same inputs: 8-bit PNG rounding bounds it near 59 dB
CLI_TIMEOUT = 300           # seconds a subprocess may take
# every acceleration off, float32 MLPs, the exact KNN: the generator's settings;
# mask_bkgd off, so that the GT keeps the render's silhouette pixels of acc <= 0.5
# (the dataset zeroes them under mask_bkgd, the render does not)
CLI_EXACT = ["tpu.bf16_mlp", "False", "tpu.knn_impl", "pallas", "mask_bkgd", "False",
             "tpu.shadow_grid", "0",
             "tpu.lvis_sweep", "False", "tpu.surf_miss_skip", "False",
             "tpu.distant_envmap", "False", "tpu.lvis_downscale", "1"]
# the Output types the sphere-traced relight renderer has maps for
CLI_TYPES = ("surface", "residual", "depth", "alpha", "normal", "specular", "albedo",
             "roughness", "shading", "rendering", "envmap")


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


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def knn_bound_ms(P: int, N: int) -> tuple[float, str]:
    ops = KNN_OPS_PER_PAIR * P * N
    nbytes = 12 * P + 12 * N + 12 * P + 12 * P      # pts, verts in; d2, idx out
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def yardstick_ms(p: torch.Tensor, vv: torch.Tensor) -> tuple[float, float]:
    """ms a call of the plain version and of torch.cdist + topk (in chunks
    of CDIST_CHUNK points) on (p, vv): medians of REPS CUDA-event runs of
    calls back to back, fewer calls the more points."""
    def library():
        for s in range(0, p.shape[0], CDIST_CHUNK):
            torch.cdist(p[s:s + CDIST_CHUNK], vv).topk(3, dim=1, largest=False)
    calls = max(1, min(20, 20 * TIMED_P // p.shape[0]))
    out = []
    for fn in (lambda: knn_top3_reference(p, vv), library):
        fn()
        out.append(statistics.median(cuda_ms(fn, calls) for _ in range(REPS)))
    return out[0], out[1]


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def run_cli(task_args: list, timeout: int = CLI_TIMEOUT) -> tuple[str, float]:
    """Run a port entry point as ``python -m ...`` from the repo's root;
    fails on a non-zero exit.  Returns (stdout + stderr, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *task_args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, "RA_TPU_NO_PDB": "1"})
    check(proc.returncode == 0, f"{' '.join(task_args[:3])} exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout + proc.stderr, time.perf_counter() - t0


def frame_ms(log: str, task: str) -> dict:
    """Mean ms of each timed part of the run's frames after the first, from
    its progress lines ``[task] frame i/n: data X ms, render Y ms, ...``."""
    rows = []
    for m in re.finditer(rf"\[{task}\] frame (\d+)/\d+: (.*)", log):
        if int(m.group(1)) > 1:
            rows.append({k: float(v) for k, v in re.findall(r"(\w+) ([\d.]+) ms", m.group(2))})
    check(rows, f"{task}: no progress lines after the first frame")
    return {k: statistics.mean(r[k] for r in rows) for k in rows[0]}


def eval_metrics(log: str) -> dict:
    m = re.search(r"eval: (\{.*\})", log)
    check(m is not None, "evaluate printed no metrics")
    return ast.literal_eval(m.group(1))


def cli_phase(smi: str, size: int = golden.FRAME_SIZE) -> tuple[int, float]:
    """The [cli] phase (see the module docstring) on a generated tree of
    ``size`` x ``size`` images.  Returns the first CLI frame's KNN launches
    and the largest |d2| difference of the kernel from the plain version on
    its inputs."""
    t0 = time.perf_counter()
    max_err = 0.0
    with tempfile.TemporaryDirectory(prefix="cli_smoke_") as tmp:
        data = os.path.join(tmp, "tubeman")
        _, gen_s = run_cli(["relightableavatar_tpu_torch.data.make_synthetic", "--root", data,
                            "--frames", str(CLI_FRAMES), "--views", str(CLI_VIEWS),
                            "--size", str(size)])
        png = os.path.join(data, "images", f"{CLI_VIEW:02d}", "000000.png")
        rgb = read_rgb(png)
        rgba = np.concatenate([rgb, rgb[..., :1]], axis=-1)
        decode_ms = statistics.median(host_ms(lambda: read_rgb(png)) for _ in range(REPS))
        encode_ms = statistics.median(host_ms(lambda: write_png(os.path.join(tmp, "e.png"), rgba))
                                      for _ in range(REPS))
        common = ["-c", CLI_CFG, "relighting", "True", "test_dataset.data_root", data,
                  "train_dataset.data_root", data,
                  "trained_model_dir", os.path.join(tmp, "trained_model"),
                  "result_dir", os.path.join(tmp, "result"), "vis_ext", ".png",
                  "store_video_output", "False", "num_eval_frame", str(CLI_FRAMES),
                  "test.frame_sampler_interval", "1"]
        cfg_x, _ = setup(["-t", "evaluate", *common, *CLI_EXACT])
        os.makedirs(cfg_x.trained_model_dir)
        with np.load(os.path.join(golden.REPO, "fixtures", "synthetic_avatar_params.npz")) as f:
            np.savez(os.path.join(cfg_x.trained_model_dir, "latest.npz"), epoch=np.asarray(0),
                     **{"net:" + k: f[k] for k in f.files})
        run = ["relightableavatar_tpu_torch.run", "-t"]
        log_d, data_s = run_cli(run + ["dataset", *common])
        check(len(re.findall(r"\[dataset\] frame \d+/", log_d)) == CLI_FRAMES,
              "dataset did not give every frame")
        log_n, net_s = run_cli(run + ["network", *common])
        m = re.search(r"mean render time: ([\d.]+)s, fps: ([\d.]+)", log_n)
        check(m is not None, "network printed no mean render time")
        net_mean, net_fps = float(m.group(1)), float(m.group(2))
        log_x, exact_s = run_cli(run + ["evaluate", *common, *CLI_EXACT])
        metrics_x = eval_metrics(log_x)
        check(metrics_x["psnr"] >= CLI_MIN_PSNR, f"evaluate at the generator's settings: "
              f"{metrics_x['psnr']:.2f} dB < {CLI_MIN_PSNR} dB against the generated images")
        log_e, eval_s = run_cli(run + ["evaluate", *common])
        metrics_d = eval_metrics(log_e)
        vis_dir = os.path.join(tmp, "vis")
        vis_types = [w for t in CLI_TYPES for w in (f"vis_{t}_map", "True")]
        log_v, vis_s = run_cli(run + ["visualize", *common, "result_dir", vis_dir, *vis_types])
        vis_root = os.path.join(vis_dir, cfg_x.task, cfg_x.exp_name)
        want = {os.path.join(vis_root, t, f"frame{f:04d}_view{CLI_VIEW:04d}.png")
                for t in CLI_TYPES for f in range(CLI_FRAMES)}
        got = {os.path.join(r, n) for r, _, ns in os.walk(vis_dir) for n in ns}
        check(got == want, f"visualize wrote {sorted(got - want)} beyond and lacks "
              f"{sorted(want - got)} of one file per type per frame")
        ms_n, ms_x, ms_v = frame_ms(log_n, "network"), frame_ms(log_x, "evaluate"), \
            frame_ms(log_v, "visualize")

        # the first CLI frame in this process: its KNN launches and inputs
        params_x, mcfg_x = make_network(cfg_x, device="cuda")
        renderer_x = make_renderer(cfg_x, params_x, mcfg_x, device="cuda")
        batch_x = next(iter(make_data_loader(cfg_x, is_train=False, device="cuda")))
        cli_inputs: dict = {}
        torch.cuda.synchronize()
        with record_knn_inputs(cli_inputs):
            knn_cuda.KNN_TOP3.launches = 0
            out_x = renderer_x.render(batch_x)
            torch.cuda.synchronize()
            launches_cli = knn_cuda.KNN_TOP3.launches
        check(launches_cli > 0, "the CLI frame did not launch the KNN kernel")
        check(bool(torch.isfinite(out_x.rgb_map).all())
              and out_x.rgb_map.shape == (int(np.asarray(batch_x.mask_at_box).sum()), 3),
              "the CLI frame's rgb_map is not finite or not one row a ray in the box")
        for key, (p, vv) in cli_inputs.items():
            d2k, ik = knn_cuda.knn_top3_cuda(p, vv)
            d2r, ir = knn_top3_reference(p, vv)
            max_err = max(max_err, max_abs_diff(d2k, d2r))
            check(torch.equal(d2k, d2r) and torch.equal(ik, ir),
                  f"CLI frame input P={frame_input_name(key, p)}: differs from the plain version")
    fmt = lambda d: ", ".join(f"{k} {v:.6g}" for k, v in d.items())
    phase("cli", t0, f"make_synthetic {CLI_FRAMES}x{CLI_VIEWS} at {size}x{size} {gen_s:.1f} s; "
          f"PNG decode of a {rgb.shape[1]}x{rgb.shape[0]} RGB image {decode_ms:.1f} ms, encode "
          f"of an RGBA one {encode_ms:.1f} ms (host); run -t dataset {data_s:.1f} s, network "
          f"{net_s:.1f} s (mean render time {net_mean:.4f} s, fps {net_fps:.2f}; {smi}), "
          f"evaluate exact {exact_s:.1f} s ({fmt(metrics_x)}), evaluate defaults {eval_s:.1f} s "
          f"({fmt(metrics_d)}), visualize {vis_s:.1f} s ({len(want)} files); ms a frame after "
          f"the first: network {fmt(ms_n)}; evaluate exact {fmt(ms_x)}; visualize {fmt(ms_v)}; "
          f"first CLI frame: KNN kernel launches {launches_cli}, kernel equal to the plain "
          f"version on its {len(cli_inputs)} recorded inputs ("
          + ", ".join(frame_input_name(k, p) for k, (p, _) in cli_inputs.items()) + ")")
    return launches_cli, max_err


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
    max_err = 0.0
    for name, pts, vv in knn_cases(verts, rng):
        d2k, ik = knn_cuda.knn_top3_cuda(pts, vv)
        torch.cuda.synchronize()
        d2r, ir = knn_top3_reference(pts, vv)
        check(ik.dtype == torch.int32 and d2k.shape == (pts.shape[0], 3),
              f"{name}: kernel output type/shape")
        err = max_abs_diff(d2k, d2r)
        max_err = max(max_err, err)
        check(torch.equal(d2k, d2r) and torch.equal(ik, ir),
              f"{name}: differs from the plain version (max |d2 diff| {err:.3e}, "
              f"{int((ik != ir).any(dim=1).sum())} points with other indices)")
        if name == "duplicated":
            check(bool((ik[:, 0] < N).all()) and bool((ik[:, 1] == ik[:, 0] + N).all()),
                  "exact ties did not go to the lowest index")
        print(f"[knn] {name}: {pts.shape[0]} points, {vv.shape[0]} vertices: d2 and "
              "idx equal to the plain version", flush=True)

    pts = synthetic_points(verts, TIMED_P, rng)
    kernel_fn = lambda: knn_cuda.knn_top3_cuda(pts, verts)
    plain_fn = lambda: knn_top3_reference(pts, verts)
    library_fn = lambda: torch.cdist(pts, verts).topk(3, dim=1, largest=False)
    times = time_in_turns({"plain": plain_fn, "kernel": kernel_fn}, REPS)
    kern_ms, plain_ms = times["kernel"], times["plain"]
    library_fn()
    lib_ms = statistics.median(cuda_ms(library_fn) for _ in range(REPS))
    _, ik = kernel_fn()
    lib_idx = library_fn().indices
    lib_agree = float((lib_idx.to(torch.int32) == ik).all(dim=1).float().mean())
    bound_ms, bound_by = knn_bound_ms(TIMED_P, N)
    ms_by_P, plain_ms_by_P, library_ms_by_P = {}, {}, {}
    for P in FRAME_BLOCKS:
        p = synthetic_points(verts, P, rng)
        ms_by_P[str(P)] = time_in_turns({"kernel": lambda p=p: knn_cuda.knn_top3_cuda(p, verts)},
                                        REPS)["kernel"]
        plain_ms_by_P[str(P)], library_ms_by_P[str(P)] = yardstick_ms(p, verts)
    phase("knn", t0, f"P={TIMED_P} N={N}, ms per call over runs of back-to-back "
          f"calls: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+topk {lib_ms:.4f} ms (top-3 sets equal on {lib_agree:.4%} of points), "
          f"bound {bound_ms:.4f} ms by {bound_by}; at the frame's block sizes kernel / plain / "
          "cdist+topk " + ", ".join(f"P={P} {ms:.4f} / {plain_ms_by_P[P]:.4f} / "
                                   f"{library_ms_by_P[P]:.4f} ms" for P, ms in ms_by_P.items()))

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
    frame_inputs: dict = {}
    with record_knn_inputs(frame_inputs):
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
    exact_rgb = rgb.cpu().numpy()
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

    # ---- the bench stack at 64x64
    t0 = time.perf_counter()
    img, n64 = golden.render_benchstack_64(device="cuda")
    check(img.shape == (n64, 3) and np.isfinite(img).all(), "bench-stack frame shape/finite")
    ok, b_psnr = golden.check_golden(img)
    check(ok and b_psnr >= 45.0, f"bench stack vs golden {b_psnr} dB < 45 dB")
    skip_img, _ = golden.render_benchstack_64(device="cuda",
                                              cfg_overrides={'surf_miss_skip': True})
    skip_diff = float(np.abs(skip_img - img).max())
    check(skip_diff <= SKIP_ATOL, f"miss skip on vs off: max |diff| {skip_diff:.3e}")
    bs = SphereTracingRenderer(golden.benchstack_cfg(), params, mcfg, device="cuda")
    gbox = bs.grid_box(ctx)
    grid = bs.bake_grid(ctx, gbox, packed=False)
    vol = bs.sweep_volume(grid, gbox)
    vol_cpu = bs.sweep_volume(grid.cpu(), gbox.cpu())
    sweep_err = float(((vol.cpu() - vol_cpu).abs() / vol_cpu.abs().clamp(min=1.0)).max())
    check(bool(torch.isfinite(vol).all()) and sweep_err <= SWEEP_RTOL,
          f"sweep on the card vs the CPU: max relative diff {sweep_err:.3e}")
    phase("benchstack", t0, f"64x64 bench stack vs tests/golden_benchstack_64px.npy: "
          f"{b_psnr:.2f} dB; miss skip on vs off max |diff| {skip_diff:.3e}; sweep volume "
          f"{tuple(vol.shape)} on the card vs the CPU: max relative diff {sweep_err:.3e}")

    # ---- the accelerated frame (the second main path)
    t0 = time.perf_counter()
    cfg_a = golden.accel_frame_cfg()
    _, params_a, mcfg_a = golden.load_fixture(cfg_a, device="cuda")
    renderer_a = SphereTracingRenderer(cfg_a, params_a, mcfg_a, device="cuda")
    lattice = renderer_a.grid_resolution(renderer_a.grid_box(ctx))
    bake_P = bake_chunk(int(np.prod(lattice)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with record_knn_inputs(frame_inputs, sizes=(bake_P,), tail=False):
        knn_cuda.KNN_TOP3.launches = 0
        t1 = time.perf_counter()
        res_a = renderer_a.render(batch)
        torch.cuda.synchronize()
        accel_s = time.perf_counter() - t1
        launches_accel = knn_cuda.KNN_TOP3.launches
    check(launches_accel > 0, "the accelerated frame did not launch the KNN kernel")
    check(bake_P in frame_inputs, "the grid bake made no KNN call of its chunk size")
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    rgb_a, acc_a = res_a.rgb_map, res_a.acc_map
    check(rgb_a.shape == (n_fg, 3) and acc_a.shape == (n_fg,), "accelerated frame output shapes")
    for k, v in res_a.items():
        if isinstance(v, torch.Tensor):
            check(bool(torch.isfinite(v).all()), f"accelerated frame {k} not finite")
    check(bool((acc_a >= 0).all() and (acc_a <= 1).all()), "accelerated frame acc outside [0, 1]")
    hits_a = int((acc_a > 0).sum())
    check(hits_a > 0, "the accelerated frame hit nothing")
    a_psnr = golden.psnr(rgb_a.cpu().numpy(), exact_rgb)
    renderer_a.time_stages = True
    renderer_a.render(batch)
    st = renderer_a.last_frame
    phase("accel-frame", t0, f"{golden.FRAME_SIZE}x{golden.FRAME_SIZE} relight_512_accel_skip: "
          f"{n_fg} rays, {hits_a} hit; render {accel_s:.3f} s = {n_fg / accel_s:.0f} rays/s "
          f"(first call); KNN kernel launches {launches_accel}; grid lattice {lattice}, "
          f"bake calls of {bake_P} points; with a sync after each stage: bake "
          f"{st.bake_s * 1e3:.1f} ms, sweep {st.sweep_s * 1e3:.1f} ms, miss march "
          f"{st.march_s * 1e3:.1f} ms, ray blocks {st.blocks_s * 1e3:.1f} ms, assembly "
          f"{st.assemble_s * 1e3:.1f} ms; ray blocks skipped by the miss skip "
          f"{st.blocks - st.blocks_rendered} of {st.blocks}; peak memory {peak_a:.2f} GiB; "
          f"rgb vs the exact frame {a_psnr:.2f} dB (lossy by design)")

    # ---- the novel-light sweep (the third main path)
    t0 = time.perf_counter()
    cfg_s = golden.sweep_frame_cfg()
    renderer_s = NovelLightRenderer(cfg_s, params_a, mcfg_a, device="cuda")
    batch_s, _ = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
    batch_s.novel_lights = load_lighting(cfg_s)
    check(list(batch_s.novel_lights) != [] and len(batch_s.novel_lights) == 8,
          f"load_lighting gave {list(batch_s.novel_lights)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.KNN_TOP3.launches = 0
    t1 = time.perf_counter()
    res_s = renderer_s.render(batch_s)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t1
    launches_sweep = knn_cuda.KNN_TOP3.launches
    check(launches_sweep > 0, "the sweep frame did not launch the KNN kernel")
    peak_s = torch.cuda.max_memory_allocated() / 2**30
    names = list(res_s.novel_light)
    check(names == list(batch_s.novel_lights), f"sweep lights {names}")
    rgbs = [res_s.novel_light[n].rgb_map for n in names]
    for n, rgb_l in zip(names, rgbs):
        check(rgb_l.shape == (n_fg, 3) and bool(torch.isfinite(rgb_l).all()),
              f"sweep light {n}: shape {tuple(rgb_l.shape)} or not finite")
    for i in range(len(rgbs)):
        for j in range(i + 1, len(rgbs)):
            check(not torch.equal(rgbs[i], rgbs[j]), f"lights {names[i]} and {names[j]} "
                  "gave the same rgb_map")
    base = res_s.base
    s_ = torch.nonzero(base.acc_map > 0).squeeze(1)[:RESHADE_RAYS]    # rays that hit
    check(s_.numel() == RESHADE_RAYS, f"the sweep frame hit only {s_.numel()} rays")
    ray_o_s = torch.as_tensor(batch_s.ray_o, device=dev)[s_]
    reshade_err = 0.0
    for n in names:
        dense = reshade_dense(base.surf_map[s_], base.norm_map[s_], base.albedo_map[s_],
                              base.roughness_map[s_, None], base.lvis_map[s_],
                              base.ldot_map[s_], base.acc_map[s_], ray_o_s,
                              res_s.novel_light[n].envmap.probe, renderer_s.light_xyz,
                              renderer_s.light_area, renderer_s.rcfg)
        for key in ("rgb_map", "shade_map"):
            reshade_err = max(reshade_err, max_abs_diff(res_s.novel_light[n][key][s_], dense[key]))
    check(reshade_err <= RESHADE_ATOL, f"sweep re-shade vs reshade_dense: max |diff| "
          f"{reshade_err:.3e} > {RESHADE_ATOL}")
    per_light = (sweep_s - res_s.diff) / len(names)
    phase("sweep-frame", t0, f"{golden.FRAME_SIZE}x{golden.FRAME_SIZE} relight_sweep_8light: "
          f"{n_fg} rays, {len(names)} lights; total {sweep_s:.3f} s, base pass {res_s.diff:.3f} s, "
          f"re-shade {renderer_s.last_frame.reshade_s:.3f} s ({per_light:.4f} s a light as bench.py "
          f"counts it: (total - base) / lights); KNN kernel launches {launches_sweep}; peak "
          f"memory {peak_s:.2f} GiB; re-shade vs reshade_dense on {RESHADE_RAYS} hit rays, every "
          f"light: max |diff| {reshade_err:.3e}")

    t0 = time.perf_counter()
    cfg_r = golden.sweep_frame_cfg()
    cfg_r.vis_rotate_light = True
    cfg_r.rotate_ratio = ROTATIONS
    light = names[0]
    batch_r, _ = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
    batch_r.novel_lights = {light: batch_s.novel_lights[light]}
    renderer_r = NovelLightRenderer(cfg_r, params_a, mcfg_a, device="cuda")
    t1 = time.perf_counter()
    res_r = renderer_r.render(batch_r)
    torch.cuda.synchronize()
    rot_s = time.perf_counter() - t1
    n_rot = len(res_r.novel_light)
    check(n_rot == cfg_r.env_w * ROTATIONS, f"{n_rot} rotations")
    rolled = np.roll(np.asarray(batch_s.novel_lights[light].probe), -1, axis=1)
    rot_err = float(np.abs(res_r.novel_light[f"{light}-{ROTATIONS:04d}"].envmap.probe.cpu().numpy()
                           - rolled).max())
    check(rot_err <= ROTATE_ATOL, f"rotation {ROTATIONS} vs the probe rolled by one column: "
          f"{rot_err:.3e}")
    rot0_err = max_abs_diff(res_r.novel_light[f"{light}-0000"].rgb_map, rgbs[0])
    check(rot0_err <= RESHADE_ATOL, f"rotation 0 vs the unrotated light: {rot0_err:.3e}")
    phase("sweep-frame", t0, f"{light} x {n_rot} rotations (rotate_ratio {ROTATIONS}): "
          f"{rot_s:.3f} s, base pass {res_r.diff:.3f} s, re-shade "
          f"{renderer_r.last_frame.reshade_s:.3f} s; rotation {ROTATIONS} vs the probe rolled "
          f"by one column max |diff| {rot_err:.3e}; rotation 0 vs the sweep's {light} "
          f"max |diff| {rot0_err:.3e}")
    del res_r, renderer_r

    # ---- the full-frame ground pass
    t0 = time.perf_counter()
    cfg_g = golden.ground_frame_cfg()
    renderer_g = SphereTracingRenderer(cfg_g, params_a, mcfg_a, device="cuda")
    batch_g, mab_g = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
    renderer_g.time_stages = True
    torch.cuda.synchronize()
    knn_cuda.KNN_TOP3.launches = 0
    t1 = time.perf_counter()
    res_g = renderer_g.render(batch_g)
    torch.cuda.synchronize()
    ground_frame_s = time.perf_counter() - t1
    launches_ground = knn_cuda.KNN_TOP3.launches
    check(launches_ground > 0, "the ground frame did not launch the KNN kernel")
    n_px = golden.FRAME_SIZE ** 2
    check(res_g.rgb_map.shape == (n_px, 3) and res_g.acc_map.shape == (n_px,),
          "ground frame maps are not H x W")
    check(bool((res_g.acc_map == 1).all()), "ground frame acc is not all ones")
    for k, v in res_g.items():
        if isinstance(v, torch.Tensor):
            check(bool(torch.isfinite(v).all()), f"ground frame {k} not finite")
    ground_only = torch.as_tensor(~mab_g, device=dev)
    lit = float(res_g.rgb_map[ground_only].max())
    check(lit > 0, "the ground is not lit")
    check(bool(np.asarray(batch_g.mask_at_box).all()), "mask_at_box is not the full frame")
    shadow_rays = renderer_g.last_frame.shadow_rays
    ground_s = renderer_g.last_frame.ground_s
    del res_g
    t1 = time.perf_counter()
    small_card = golden.render_check_frame(golden.ground_check_cfg(), device="cuda")
    small_cpu = golden.render_check_frame(golden.ground_check_cfg(), device="cpu")
    cpu_s = time.perf_counter() - t1
    g_psnr = {k: golden.psnr(small_card[k], small_cpu[k]) for k in small_cpu}
    # spec_map divides by |ldot| + 1e-8 at grazing texels (ROADMAP, "spec_map
    # parity"): printed, not held
    for k, p in g_psnr.items():
        check(p >= CARD_CPU_MIN_PSNR or k == "spec_map",
              f"32x32 ground frame {k}: card vs CPU {p:.2f} dB")
    phase("ground", t0, f"{golden.FRAME_SIZE}x{golden.FRAME_SIZE} ground frame: "
          f"{ground_frame_s:.3f} s, of it the ground pass {ground_s:.3f} s "
          f"({n_px} rays x {renderer_g.light_xyz.shape[0] * renderer_g.light_xyz.shape[1]} "
          f"texels, {shadow_rays} shadow rays traced); KNN kernel launches {launches_ground}; "
          f"ground rgb max {lit:.3f}; {golden.CHECK_SIZE}x{golden.CHECK_SIZE} ground frame "
          f"card vs CPU ({cpu_s:.1f} s): "
          + ", ".join(f"{k} {p:.2f} dB" for k, p in sorted(g_psnr.items())))

    # ---- the stage-1 volume renderer, exact and culled
    t0 = time.perf_counter()
    volume_inputs: dict = {}
    vol = {}
    for cull in (0, 32):
        cfg_v = golden.volume_frame_cfg(cull)
        _, params_v, mcfg_v = golden.load_fixture(cfg_v, device="cuda")
        renderer_v = VolumeRenderer(cfg_v, params_v, mcfg_v, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        store = volume_inputs if cull == 0 else {}
        with record_knn_inputs(store, sizes=(VOLUME_P,), tail=False, last=True):
            knn_cuda.KNN_TOP3.launches = 0
            t1 = time.perf_counter()
            res_v = renderer_v.render(batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            n_knn = knn_cuda.KNN_TOP3.launches
        check(n_knn > 0, f"the volume frame (cull {cull}) did not launch the KNN kernel")
        check(res_v.rgb_map.shape == (n_fg, 3) and res_v.acc_map.shape == (n_fg,),
              f"volume frame (cull {cull}) shapes")
        for k, v in res_v.items():
            check(bool(torch.isfinite(v).all()), f"volume frame (cull {cull}) {k} not finite")
        acc_v = res_v.acc_map
        check(bool((acc_v >= 0).all() and (acc_v <= 1 + 1e-5).all()),
              f"volume frame (cull {cull}) acc outside [0, 1]")
        check(float(acc_v.max()) > 0.5, f"volume frame (cull {cull}) sees no body")
        vol[cull] = dict(s=secs, launches=n_knn, peak=torch.cuda.max_memory_allocated() / 2**30,
                         rgb=res_v.rgb_map.cpu().numpy(), acc=acc_v.cpu().numpy(),
                         blocks=renderer_v.last_frame.blocks)
        del res_v
    check(VOLUME_P in volume_inputs and (VOLUME_P, "last") in volume_inputs,
          "the volume frame made no 1,048,576-point KNN call")
    launches_volume, launches_cull = vol[0]["launches"], vol[32]["launches"]
    cull_psnr = golden.psnr(vol[32]["rgb"], vol[0]["rgb"])
    cull_acc = float(np.abs(vol[32]["acc"] - vol[0]["acc"]).max())
    t1 = time.perf_counter()
    small_card = golden.render_check_frame(golden.volume_check_cfg(), device="cuda")
    small_cpu = golden.render_check_frame(golden.volume_check_cfg(), device="cpu")
    cpu_s = time.perf_counter() - t1
    v_psnr = {k: golden.psnr(small_card[k], small_cpu[k]) for k in small_cpu}
    for k, p in v_psnr.items():
        check(p >= CARD_CPU_MIN_PSNR, f"32x32 volume frame {k}: card vs CPU {p:.2f} dB")
    phase("volume-frame", t0, f"{golden.FRAME_SIZE}x{golden.FRAME_SIZE} novel_view_512: "
          + "; ".join(f"{'exact' if c == 0 else f'cull{c}'} {v['s']:.3f} s = "
                      f"{n_fg / v['s']:.0f} rays/s, {v['blocks']} blocks, KNN kernel launches "
                      f"{v['launches']}, peak memory {v['peak']:.2f} GiB" for c, v in vol.items())
          + f"; cull32 vs exact rgb {cull_psnr:.2f} dB, acc max |diff| {cull_acc:.3e}; "
          f"{golden.CHECK_SIZE}x{golden.CHECK_SIZE} volume frame card vs CPU ({cpu_s:.1f} s): "
          + ", ".join(f"{k} {p:.2f} dB" for k, p in sorted(v_psnr.items())))

    # ---- the kernel on the frame's own inputs
    t0 = time.perf_counter()
    check(set(FRAME_BLOCKS) <= set(frame_inputs), "the frame made no call at some block size")
    frame_inputs_ms, frame_inputs_plain_ms, frame_inputs_library_ms = {}, {}, {}
    for key, (p, vv) in sorted(frame_inputs.items(), key=lambda kv: str(kv[0])):
        name = frame_input_name(key, p) + (" bake" if key == bake_P else "")
        d2k, ik = knn_cuda.knn_top3_cuda(p, vv)
        d2r, ir = knn_top3_reference(p, vv)
        max_err = max(max_err, max_abs_diff(d2k, d2r))
        check(torch.equal(d2k, d2r) and torch.equal(ik, ir),
              f"frame input P={name}: differs from the plain version")
        frame_inputs_ms[name] = time_in_turns(
            {"kernel": lambda p=p, vv=vv: knn_cuda.knn_top3_cuda(p, vv)}, REPS)["kernel"]
        frame_inputs_plain_ms[name], frame_inputs_library_ms[name] = yardstick_ms(p, vv)
    volume_inputs_ms, volume_bound_ms = {}, {}
    volume_inputs_plain_ms, volume_inputs_library_ms = {}, {}
    for key, name in ((VOLUME_P, "volume block 0"), ((VOLUME_P, "last"), "volume last block")):
        p, vv = volume_inputs.pop(key)
        d2k, ik = knn_cuda.knn_top3_cuda(p, vv)
        d2r, ir = knn_top3_reference(p, vv)
        max_err = max(max_err, max_abs_diff(d2k, d2r))
        check(torch.equal(d2k, d2r) and torch.equal(ik, ir),
              f"{name} ({p.shape[0]} points): differs from the plain version")
        volume_inputs_ms[name] = time_in_turns(
            {"kernel": lambda p=p, vv=vv: knn_cuda.knn_top3_cuda(p, vv)}, REPS)["kernel"]
        volume_bound_ms[name] = knn_bound_ms(p.shape[0], vv.shape[0])[0]
        volume_inputs_plain_ms[name], volume_inputs_library_ms[name] = yardstick_ms(p, vv)
        del p, vv
    phase("knn-frame", t0, "the frame's own KNN inputs: d2 and idx equal to the plain "
          "version; kernel / plain / cdist+topk " + ", ".join(
              f"P={k} {ms:.4f} / {frame_inputs_plain_ms[k]:.4f} / {frame_inputs_library_ms[k]:.4f} ms"
              for k, ms in frame_inputs_ms.items())
          + "; " + ", ".join(f"{k} (P={VOLUME_P}) {ms:.4f} / {volume_inputs_plain_ms[k]:.4f} / "
                             f"{volume_inputs_library_ms[k]:.4f} ms, bound {volume_bound_ms[k]:.4f} ms"
                             for k, ms in volume_inputs_ms.items()))

    # ---- the CLI: the user's entry points as subprocesses (this slice's main path)
    del frame_inputs, volume_inputs
    torch.cuda.empty_cache()
    launches_cli, cli_err = cli_phase(smi)
    max_err = max(max_err, cli_err)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "knn_top3",
        "route": "cuda",
        "source": "relightableavatar_tpu_torch/csrc/knn_top3.cu",
        "replaces": "relightableavatar_tpu/ops/pallas_knn.py:28",
        "launches": launches,
        "launches_accel": launches_accel,
        "launches_sweep": launches_sweep,
        "launches_ground": launches_ground,
        "launches_volume": launches_volume,
        "launches_volume_cull32": launches_cull,
        "launches_cli": launches_cli,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
        "ms_by_P": ms_by_P,
        "plain_ms_by_P": plain_ms_by_P,
        "library_ms_by_P": library_ms_by_P,
        "frame_inputs_ms": frame_inputs_ms,
        "frame_inputs_plain_ms": frame_inputs_plain_ms,
        "frame_inputs_library_ms": frame_inputs_library_ms,
        "volume_inputs_ms": volume_inputs_ms,
        "volume_inputs_plain_ms": volume_inputs_plain_ms,
        "volume_inputs_library_ms": volume_inputs_library_ms,
        "volume_inputs_bound_ms": volume_bound_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
