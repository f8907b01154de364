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
  mesh    on the tree [cli] generated, the tasks as subprocesses whose working
          directory is in the temporary directory (the mesh visualizer
          writes data/animation/ there): ``run -t visualize vis_can_mesh
          True mesh_simp_face 16384`` at tubeman's 5 mm voxels from the
          fixture as the stage-1 checkpoint (faces within the target,
          positive signed volume, Euler characteristic, chamfer and p2s
          against the bigpose SMPL vertices); the same extraction in this
          process with its KNN launches counted, its stage times and the
          kernel bit for bit against the plain version on the filter's
          second 1,048,576-point chunk, timed beside the plain version and
          torch.cdist + topk; ``vis_posed_mesh True`` of frame 0 from the
          relight checkpoint (HDQ, albedo and roughness); ``run -t evaluate``
          at the exact settings with the canonical mesh as the geometry
          prior (``use_geometry True geometry_mesh``: its PSNR against the
          generated images, printed), the kernel timed on the prior's
          vertices; the canonical and the posed mesh at 2.5 cm on the card
          against the CPU (``eval/mesh_check.py``: equal faces, vertices
          within 1e-4 m, attributes within 2e-5)
  train   stage-1 training (``eval/train_check.py``): one step at bench.py's
          reference geometry (4 frames x 1024 rays x 128 samples, the default
          grad_sample_budget, bf16 MLPs, stratified samples) from the
          fixture's parameters, timed as the median of 6 steps after a
          warm-up on the host clock ending in a device sync, with its peak
          memory, the analytic TFLOP a step, and K1's launches a step
          (required B x NC); the kernel bit for bit against the plain version
          on the step's own input, timed beside it and torch.cdist + topk;
          a small step (2 x 64 rays x 16 samples) on the card against the
          CPU: float32 (loss within 1e-5, every gradient within 1e-4 of its
          largest entry), then bf16 with the residual MLP's zero last weight
          re-drawn (every weight's gradient nonzero, cosine >= 0.999 to the
          CPU's); then on [cli]'s tree ``python -m
          relightableavatar_tpu_torch.train`` (exp_name tubeman_verify, a
          temporary trained_model_dir, 2 epochs of 3 iterations: finite
          losses, the epoch files), ``resume True`` for a third epoch, and
          ``run -t network`` from the trained checkpoint
The last three lines are nvidia-smi's "name, power limit" line, a
{"kernels": [...]} JSON object and {"ok": true, "device": {...}}.  Any
failed check exits non-zero before them; where the kernel and its plain
version disagree, the message gives the differing rows beside a float64 top
3 and how often 20 fresh launches of each side repeat their result, after
saving the case to ``relightableavatar_tpu_torch/_build/knn_fail_<case>.npz``
(a ``[knn-fail]`` line gives its path, the cloud's sha256 and, up to 64,
the points; ``tests/test_torch_knn_replay.py`` replays such a file on the
CPU; ``eval/knn_stress.py`` repeats the [knn] phase many times).  Imports
nothing but the port, torch, numpy and the standard library; reads only
tracked files.
"""
from __future__ import annotations

import ast
import json
import math
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
from relightableavatar_tpu_torch.data.datasets import (load_lighting, make_data_loader,
                                                       make_dataset)
from relightableavatar_tpu_torch.data.image_io import read_rgb, write_png
from relightableavatar_tpu_torch.eval import golden, mesh_check, train_check
from relightableavatar_tpu_torch.eval.evaluator import MeshEvaluator
from relightableavatar_tpu_torch.eval.knn_cases import (
    FRAME_BLOCKS, cloud_sha256, cuda_ms, frame_input_name, knn_cases, record_knn_inputs,
    save_knn_failure, synthetic_points, time_in_turns)
from relightableavatar_tpu_torch.ops.sdf_grid import bake_chunk
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.models.context import make_frame_context_mesh
from relightableavatar_tpu_torch.models.factory import make_network, make_renderer
from relightableavatar_tpu_torch.ops import knn as knn_mod
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.ops.knn import knn_top3_reference
from relightableavatar_tpu_torch.renderer.orchestrate import (NovelLightRenderer,
                                                             SphereTracingRenderer,
                                                             reshade_dense)
from relightableavatar_tpu_torch.renderer.volume import VolumeRenderer
from relightableavatar_tpu_torch.train.trainer import ray_chunks
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.flops import train_step_flops

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
# the mesh phase: tubeman's config at its own 5 mm voxels (configs/base.yaml),
# decimated as scripts/train_e2e.py asks for a stage-2 prior
MESH_SIMP_FACE = 16384
MESH_TIMEOUT = 600          # seconds a mesh task may take
# the train phase: bench.py's reference step timed, a small step held card vs CPU
TRAIN_STEPS = 6             # timed steps after one warm-up
TRAIN_LOSS_REL = 1e-5       # f32 step, card vs CPU
TRAIN_GRAD_REL = 1e-4       # f32: max |card - cpu| / max |cpu| of each parameter's gradient
TRAIN_BF16_COS = 0.999      # bf16: each weight gradient's cosine to the CPU path's
TRAIN_CLI_ITERS = 3         # iterations an epoch of the CLI's training


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


def check_knn_equal(name: str, pts: torch.Tensor, verts: torch.Tensor, d2k: torch.Tensor,
                    ik: torch.Tensor, d2r: torch.Tensor, ir: torch.Tensor) -> None:
    """Fails unless the kernel's (d2k, ik) equal the plain version's (d2r, ir)
    bit for bit.  On a disagreement it first saves the case
    (``knn_cases.save_knn_failure``: points, cloud and both outputs, for a
    replay on the CPU) and prints its path, the cloud's sha256 and, for
    P <= 64, the points; the message says which side is wrong: the
    differing rows against a float64 top 3, and how many of 20 fresh
    launches of each side reproduce its first result."""
    if torch.equal(d2k, d2r) and torch.equal(ik, ir):
        return
    path = save_knn_failure(name, pts, verts, d2k, ik, d2r, ir)
    print(f"[knn-fail] {name}: saved to {path}; cloud sha256 {cloud_sha256(verts.cpu().numpy())}"
          + (f"; points {pts.cpu().tolist()}" if pts.shape[0] <= 64 else ""), flush=True)
    rows = ((ik != ir) | (d2k != d2r)).any(dim=1).nonzero().flatten()
    show = rows[:4]
    p = pts[show].double()
    truth = ((p[:, None] - verts.double()[None]) ** 2).sum(-1).topk(3, largest=False).indices
    same_k = sum(torch.equal(knn_cuda.knn_top3_cuda(pts, verts)[1], ik) for _ in range(20))
    same_r = sum(torch.equal(knn_top3_reference(pts, verts)[1], ir) for _ in range(20))
    check(False, f"{name}: differs from the plain version (max |d2 diff| "
          f"{max_abs_diff(d2k, d2r):.3e}, {len(rows)} points with other results, rows "
          f"{show.tolist()}: kernel idx {ik[show].tolist()} d2 {d2k[show].tolist()}, plain "
          f"idx {ir[show].tolist()} d2 {d2r[show].tolist()}, float64 idx {truth.tolist()}, "
          f"points {pts[show].tolist()}; of 20 fresh launches on the same input, the kernel "
          f"gave its first idx {same_k} times, the plain version {same_r} times)")


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


def run_cli(task_args: list, timeout: int = CLI_TIMEOUT, cwd: str = REPO) -> tuple[str, float]:
    """Run a port entry point as ``python -m ...`` in ``cwd`` (the repo's
    root by default; the package is found through PYTHONPATH); fails on a
    non-zero exit.  Returns (stdout + stderr, seconds)."""
    t0 = time.perf_counter()
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable, "-m", *task_args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout,
                          env={**os.environ, "RA_TPU_NO_PDB": "1", "PYTHONPATH": path})
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


def cli_phase(smi: str, tmp: str, size: int = golden.FRAME_SIZE) -> tuple[int, float]:
    """The [cli] phase (see the module docstring) on a tree of ``size`` x
    ``size`` images that it generates in ``tmp/tubeman``, with the relight
    checkpoint under ``tmp/trained_model``.  Returns the first CLI frame's
    KNN launches and the largest |d2| difference of the kernel from the plain
    version on its inputs."""
    t0 = time.perf_counter()
    max_err = 0.0
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
        check_knn_equal(f"CLI frame input P={frame_input_name(key, p)}", p, vv, d2k, ik, d2r, ir)
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


def signed_volume(verts: np.ndarray, faces: np.ndarray) -> float:
    """m^3 enclosed by outward windings (negative when they face inward)."""
    v = verts.astype(np.float64)
    tri = (v - v.mean(0))[faces]
    return float(np.einsum("fi,fi->f", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6.0)


def euler_characteristic(verts: np.ndarray, faces: np.ndarray) -> int:
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), 1)
    return len(verts) - len(np.unique(edges, axis=0)) + len(faces)


def mesh_phase(smi: str, tmp: str) -> dict:
    """The [mesh] phase (see the module docstring) on the tree and the
    relight checkpoint that [cli] left in ``tmp``.  Returns the canonical
    extraction's KNN launches, the kernel's times on its filter chunk and
    the largest |d2| difference from the plain version."""
    t0 = time.perf_counter()
    data, models = os.path.join(tmp, "tubeman"), os.path.join(tmp, "trained_model")
    cwd = os.path.join(tmp, "mesh")                 # the visualizer writes data/animation here
    os.makedirs(cwd)
    os.symlink(os.path.join(REPO, "configs"), os.path.join(cwd, "configs"))
    deform = os.path.join(models, "deform", "tubeman")
    os.makedirs(deform)
    with np.load(os.path.join(golden.REPO, "fixtures", "synthetic_avatar_params.npz")) as f:
        np.savez(os.path.join(deform, "latest.npz"), **{"net:" + k: f[k] for k in f.files})
    common = ["-c", CLI_CFG, "test_dataset.data_root", data, "train_dataset.data_root", data,
              "trained_model_dir", models, "num_eval_frame", "1"]
    can_args = [*common, "vis_can_mesh", "True", "mesh_simp_face", str(MESH_SIMP_FACE)]
    posed_args = [*common, "vis_posed_mesh", "True", "relighting", "True"]
    run = ["relightableavatar_tpu_torch.run", "-t", "visualize"]
    ret = dict(max_err=0.0)

    # the canonical 5 mm mesh from the stage-1 checkpoint: the stage-2 prior
    log_c, can_s = run_cli(run + can_args, MESH_TIMEOUT, cwd=cwd)
    ms_c = frame_ms(log_c, "visualize")             # the second item, frame 0
    cfg_c, _ = setup(["-t", "visualize", *can_args])
    out_dir = os.path.join(cwd, "data", "animation", cfg_c.task, cfg_c.exp_name)
    can_path = os.path.join(out_dir, "can_mesh.npz")
    check(sorted(os.listdir(out_dir)) == ["can_mesh.npz", "can_mesh.ply", "frame0000.npz",
                                          "frame0000.ply"], f"{out_dir}: {os.listdir(out_dir)}")
    can = dict(np.load(can_path))
    check(sorted(can) == ["faces", "parents", "tjoints", "verts", "weights"], f"can_mesh keys {sorted(can)}")
    V, F = can["verts"], can["faces"]
    check(0 < len(F) <= MESH_SIMP_FACE, f"can_mesh has {len(F)} faces, mesh_simp_face {MESH_SIMP_FACE}")
    check(all(np.isfinite(can[k]).all() for k in ("verts", "weights")), "can_mesh not finite")
    check(bool(np.allclose(can["weights"].sum(1), 1.0, atol=1e-4)), "skinning weights do not sum to 1")
    ply = os.path.getsize(os.path.join(out_dir, "can_mesh.ply"))
    check(ply > 12 * len(V) + 13 * len(F), "can_mesh.ply is shorter than its vertices and faces")
    vol, euler = signed_volume(V, F), euler_characteristic(V, F)
    check(vol > 0, f"can_mesh signed volume {vol:.4g} m^3: windings face inward")
    dataset = make_dataset(cfg_c, is_train=False, device="cuda")
    ev = MeshEvaluator(cfg_c)
    ev.evaluate(dotdict(verts=V), dotdict(gt_verts=dataset.tverts))
    chamfer = ev.summarize()

    # the same extraction in this process: launches, stage times, the
    # kernel's input of the filter's second chunk
    params_c, mcfg_c = make_network(cfg_c, device="cuda")
    renderer_c = make_renderer(cfg_c, params_c, mcfg_c, device="cuda")
    batch_c = dataset[-1]
    chunks = []                                     # the filter's first two full chunks
    dispatch = knn_mod.knn_top3

    def recording(pts, verts):
        if pts.shape[0] == knn_mod.CHUNK and len(chunks) < 2:
            chunks.append((pts.clone(), verts.clone()))
        return dispatch(pts, verts)
    knn_mod.knn_top3 = recording
    try:
        torch.cuda.synchronize()
        knn_cuda.KNN_TOP3.launches = 0
        t1 = time.perf_counter()
        out_c = renderer_c.render(batch_c)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t1
        ret["launches"] = knn_cuda.KNN_TOP3.launches
    finally:
        knn_mod.knn_top3 = dispatch
    st = renderer_c.last_mesh
    check(ret["launches"] > 0, "the mesh extraction did not launch the KNN kernel")
    check(len(chunks) == 2, f"the mesh filter made no second call of {knn_mod.CHUNK} points")
    same_as_cli = bool(np.array_equal(out_c.faces, F) and np.array_equal(out_c.verts, V))
    del renderer_c, params_c, out_c

    # the kernel on the filter's own chunk
    p, vv = chunks[1]
    d2k, ik = knn_cuda.knn_top3_cuda(p, vv)
    d2r, ir = knn_top3_reference(p, vv)
    ret["max_err"] = max_abs_diff(d2k, d2r)
    check_knn_equal(f"mesh filter chunk ({p.shape[0]} points)", p, vv, d2k, ik, d2r, ir)
    ret["ms"] = time_in_turns({"kernel": lambda: knn_cuda.knn_top3_cuda(p, vv)}, REPS)["kernel"]
    ret["plain_ms"], ret["library_ms"] = yardstick_ms(p, vv)
    ret["bound_ms"] = knn_bound_ms(p.shape[0], vv.shape[0])[0]
    del p, vv, d2k, ik, d2r, ir, chunks

    # the posed frame-0 mesh from the relight checkpoint: HDQ and materials
    _, posed_s = run_cli(run + posed_args, MESH_TIMEOUT, cwd=cwd)
    cfg_p, _ = setup(["-t", "visualize", *posed_args])
    posed = dict(np.load(os.path.join(cwd, "data", "animation", cfg_p.task, cfg_p.exp_name,
                                      "frame0000.npz")))
    nv = len(posed["verts"])
    check(nv > 0 and posed["albedo"].shape == (nv, 3) and posed["roughness"].shape == (nv, 1),
          "the posed mesh has no albedo or roughness a vertex")
    check(all(np.isfinite(posed[k]).all() for k in ("verts", "albedo", "roughness", "weights")),
          "the posed mesh is not finite")
    posed_vol = signed_volume(posed["verts"], posed["faces"])
    check(posed_vol > 0, f"posed mesh signed volume {posed_vol:.4g} m^3")

    # a relight frame with the extracted mesh as its geometry prior
    prior_args = ["-c", CLI_CFG, "relighting", "True", "test_dataset.data_root", data,
                  "train_dataset.data_root", data, "trained_model_dir", models,
                  "result_dir", os.path.join(tmp, "result_prior"), "vis_ext", ".png",
                  "store_video_output", "False", "num_eval_frame", str(CLI_FRAMES),
                  "test.frame_sampler_interval", "1", *CLI_EXACT,
                  "use_geometry", "True", "geometry_mesh", can_path]
    log_r, prior_s = run_cli(["relightableavatar_tpu_torch.run", "-t", "evaluate", *prior_args],
                             MESH_TIMEOUT)
    metrics_r = eval_metrics(log_r)
    check(all(np.isfinite(v) for v in metrics_r.values()), f"prior evaluate metrics {metrics_r}")
    ms_r = frame_ms(log_r, "evaluate")
    motion = np.load(os.path.join(data, "motion.npz"))
    ctx_r = make_frame_context_mesh(can, motion["poses"][0], motion["Rh"][0], motion["Th"][0],
                                    device="cuda")
    pts_r = synthetic_points(ctx_r["pverts"], TIMED_P, np.random.default_rng(4))
    prior_knn = time_in_turns({"plain": lambda: knn_top3_reference(pts_r, ctx_r["pverts"]),
                               "kernel": lambda: knn_cuda.knn_top3_cuda(pts_r, ctx_r["pverts"])},
                              REPS)

    # the coarse mesh on the card against the CPU
    t1 = time.perf_counter()
    coarse = {}
    for name, mode, item, opts in (("canonical", "vis_can_mesh", -1, ()),
                                   ("posed", "vis_posed_mesh", 0, ("relighting", "True"))):
        cfg_m = mesh_check.mesh_cfg(data, models, mode, opts=opts)
        card, card_st, cloud = mesh_check.extract(cfg_m, item, "cuda")
        cpu, _, _ = mesh_check.extract(cfg_m, item, "cpu")
        diff = mesh_check.compare(card, cpu, cloud)
        check(mesh_check.agrees(diff), f"{name} mesh at {mesh_check.CHECK_VOXEL} m, card vs CPU: "
              f"{diff} (bars: equal faces, verts {mesh_check.VERT_ATOL} m, attributes "
              f"{mesh_check.ATTR_ATOL}, top-3 sets differing {mesh_check.TIE_SHARE})")
        coarse[name] = (card_st.grid_points, diff)
    coarse_s = time.perf_counter() - t1

    fmt = lambda d: ", ".join(f"{k} {v:.6g}" for k, v in d.items())
    phase("mesh", t0, f"run -t visualize vis_can_mesh True mesh_simp_face {MESH_SIMP_FACE} "
          f"{can_s:.1f} s (ms of its second item: {fmt(ms_c)}); in this process ({mesh_s:.2f} s, bf16 MLPs, {smi}): grid points "
          f"{st.grid_points}, band points {st.band_points}, KNN kernel launches "
          f"{ret['launches']}, filter {st.filter_s * 1e3:.1f} ms, SDF {st.sdf_s * 1e3:.1f} ms, "
          f"cube to host {st.cube_d2h_s * 1e3:.1f} ms, marching {st.marching_s:.2f} s "
          f"({st.marched_faces} faces), largest component {st.component_s:.2f} s, decimation "
          f"{st.decimate_s:.2f} s, weights {st.weights_s * 1e3:.1f} ms; mesh equal to the "
          f"CLI's {same_as_cli}; can_mesh {len(V)} verts, {len(F)} faces, signed volume "
          f"{vol:.6g} m^3, Euler characteristic {euler}, against the bigpose SMPL vertices "
          f"{fmt(chamfer)} m; kernel on the filter's {knn_mod.CHUNK}-point chunk equal to the "
          f"plain version, {ret['ms']:.4f} / plain {ret['plain_ms']:.4f} / cdist+topk "
          f"{ret['library_ms']:.4f} ms, bound {ret['bound_ms']:.4f} ms; vis_posed_mesh "
          f"{posed_s:.1f} s: frame 0 {nv} verts, {len(posed['faces'])} faces, signed volume "
          f"{posed_vol:.6g} m^3, albedo {posed['albedo'].min():.4f}..{posed['albedo'].max():.4f}, "
          f"roughness {posed['roughness'].min():.4f}..{posed['roughness'].max():.4f}; evaluate "
          f"with the prior (exact, {CLI_FRAMES} frames) {prior_s:.1f} s: {fmt(metrics_r)}; ms a "
          f"frame after the first: {fmt(ms_r)}; the prior's {len(V)} verts as the KNN cloud: "
          f"kernel {prior_knn['kernel']:.4f} ms / plain {prior_knn['plain']:.4f} ms at "
          f"P={TIMED_P}; card vs CPU at {mesh_check.CHECK_VOXEL} m ({coarse_s:.1f} s): "
          + "; ".join(f"{k} ({n} grid points) {d}" for k, (n, d) in coarse.items()))
    return ret


def train_phase(smi: str, tmp: str) -> dict:
    """The [train] phase (see the module docstring) on the tree [cli] left
    in ``tmp``.  Returns the timed steps' KNN launches and the kernel's
    times on a step's own input, with its bound and largest |d2|
    difference from the plain version."""
    t0 = time.perf_counter()
    ret = {}
    # (a) one step at bench.py's reference geometry, bf16 MLPs, stratified
    cfg = train_check.step_cfg(train_check.BENCH_B, train_check.BENCH_S, bf16=True,
                               perturb=True, record_dir=os.path.join(tmp, "train_record"))
    trainer, batch = train_check.make_step(cfg, "cuda", train_check.BENCH_R)
    B, R, S = train_check.BENCH_B, train_check.BENCH_R, train_check.BENCH_S
    RC, NC = ray_chunks(B, R, S, int(cfg.tpu.grad_sample_budget))
    inputs: dict = {}
    with record_knn_inputs(inputs, sizes=(RC * S,), tail=True):
        trainer.step(batch, 0)                                  # warm-up
    torch.cuda.synchronize()
    check(set(inputs) == {RC * S}, f"the step's KNN calls were not all of {RC * S} points: "
          f"{sorted(map(str, inputs))}")
    torch.cuda.reset_peak_memory_stats()
    secs = []
    knn_cuda.KNN_TOP3.launches = 0
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        stats = trainer.step(batch, 0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    ret["launches"] = knn_cuda.KNN_TOP3.launches
    per_step = ret["launches"] / TRAIN_STEPS
    check(per_step == B * NC, f"K1 launches a step {per_step}, expected B x NC = {B * NC}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = float(stats.loss)
    check(math.isfinite(loss), f"the timed step's loss is {loss}")
    step_s = statistics.median(secs)
    tflop = train_step_flops(trainer.mcfg, B * R * S, int(batch.ctx[0]["pverts"].shape[0])) / 1e12
    p, vv = inputs[RC * S]
    d2k, ik = knn_cuda.knn_top3_cuda(p, vv)
    d2r, ir = knn_top3_reference(p, vv)
    ret["max_err"] = max_abs_diff(d2k, d2r)
    check_knn_equal(f"train step input P={p.shape[0]}", p, vv, d2k, ik, d2r, ir)
    ret["ms"] = time_in_turns({"kernel": lambda: knn_cuda.knn_top3_cuda(p, vv)}, REPS)["kernel"]
    ret["plain_ms"], ret["library_ms"] = yardstick_ms(p, vv)
    ret["bound_ms"] = knn_bound_ms(p.shape[0], vv.shape[0])[0]
    del trainer, batch, inputs, p, vv
    torch.cuda.empty_cache()

    # (b) a small step on the card against the CPU: float32, then bf16 with
    # the residual MLP's last layer re-drawn so every layer has a gradient
    held = {}
    for bf16 in (False, True):
        res = {}
        for dev in ("cuda", "cpu"):
            cfg_c = train_check.step_cfg(train_check.CHECK_B, train_check.CHECK_S, bf16=bf16,
                                         perturb=False, record_dir=os.path.join(tmp, "check"))
            tr, bt = train_check.make_step(cfg_c, dev, train_check.CHECK_R)
            if bf16:
                train_check.live_residual(tr)
            res[dev] = train_check.step_result(tr, bt)
        cmp = train_check.compare_grads(res["cuda"], res["cpu"])
        loss_rel = abs(res["cuda"]["loss"] - res["cpu"]["loss"]) / abs(res["cpu"]["loss"])
        worst_rel = max(v[0] for v in cmp.values())
        # weights with a gradient (the fixture's zero residual weight leaves
        # the residual MLP's others without one in the float32 step)
        worst_cos = min(v[1] for k, v in cmp.items()
                        if not k.endswith(("/b", "beta")) and (bf16 or v[2] > 0))
        if bf16:
            dead = [k for k, v in cmp.items() if v[2] == 0 and not k.endswith(("/b", "beta"))]
            check(not dead, f"bf16 step on the card: weights without a gradient: {dead}")
            check(worst_cos >= TRAIN_BF16_COS, f"bf16 step on the card: a weight's gradient has "
                  f"cosine {worst_cos:.6f} < {TRAIN_BF16_COS} to the CPU's")
        else:
            check(loss_rel <= TRAIN_LOSS_REL, f"f32 step card vs CPU loss: {loss_rel:.3e}")
            bad = {k: v[0] for k, v in cmp.items() if v[0] > TRAIN_GRAD_REL}
            check(not bad, f"f32 step card vs CPU gradients beyond {TRAIN_GRAD_REL}: {bad}")
        held["bf16" if bf16 else "f32"] = (loss_rel, worst_rel, worst_cos)
    t_check = time.perf_counter()

    # (c) the CLI: train, resume, then render from the trained checkpoint
    data = os.path.join(tmp, "tubeman")
    model_root = os.path.join(tmp, "trained_train")
    common = ["-c", CLI_CFG, "exp_name", "tubeman_verify", "trained_model_dir", model_root,
              "record_dir", os.path.join(tmp, "record"), "result_dir", os.path.join(tmp, "res"),
              "train_dataset.data_root", data, "test_dataset.data_root", data,
              "ep_iter", str(TRAIN_CLI_ITERS), "train.num_workers", "2", "eval_ep", "100",
              "save_ep", "100"]
    log_t, train_s = run_cli(["relightableavatar_tpu_torch.train", *common, "resume", "False",
                              "train.epoch", "2"], timeout=CLI_TIMEOUT)
    cfg_t, _ = setup(common)
    mdir = cfg_t.trained_model_dir
    check(sorted(os.listdir(mdir)) == ["1.npz", "2.npz", "latest.npz"],
          f"train wrote {sorted(os.listdir(mdir))}")
    rows = [json.loads(line) for line in open(os.path.join(cfg_t.record_dir, "scalars.jsonl"))]
    check(len(rows) == 2 * TRAIN_CLI_ITERS and all(math.isfinite(r["loss"]) for r in rows),
          f"train's recorded losses: {[r.get('loss') for r in rows]}")
    it_s = [float(m) for m in re.findall(r"([\d.]+)s/it", log_t)]
    log_r, resume_s = run_cli(["relightableavatar_tpu_torch.train", *common, "resume", "True",
                               "train.epoch", "3"], timeout=CLI_TIMEOUT)
    with np.load(os.path.join(mdir, "latest.npz")) as f:
        check(int(f["epoch"]) == 3, f"resume saved epoch {int(f['epoch'])}, not 3")
    log_n, net_s = run_cli(["relightableavatar_tpu_torch.run", "-t", "network", *common,
                            "num_eval_frame", str(CLI_FRAMES), "test.frame_sampler_interval", "1"])
    m = re.search(r"mean render time: ([\d.]+)s", log_n)
    check(m is not None, "run -t network from the trained checkpoint printed no render time")
    fmt = lambda t: ", ".join(f"{x:.3e}" for x in t)
    phase("train", t0, f"step at B={B} R={R} S={S} (budget {int(cfg.tpu.grad_sample_budget)}: "
          f"{NC} chunks of {RC} rays), bf16, fixture parameters ({smi}): median "
          f"{step_s * 1e3:.1f} ms of {TRAIN_STEPS} steps after one warm-up ("
          + ", ".join(f"{x * 1e3:.1f}" for x in secs) + f" ms), {tflop:.3f} TFLOP a step "
          f"(analytic) = {tflop / step_s:.2f} TFLOP/s, peak memory {peak:.2f} GiB, loss "
          f"{loss:.5f}; K1 launches a step {per_step:.0f} of P={RC * S}, on the step's input "
          f"kernel {ret['ms']:.4f} / plain {ret['plain_ms']:.4f} / cdist+topk "
          f"{ret['library_ms']:.4f} ms, bound {ret['bound_ms']:.4f} ms, equal to the plain "
          f"version; card vs CPU at B={train_check.CHECK_B} R={train_check.CHECK_R} "
          f"S={train_check.CHECK_S} ({t_check - t0:.1f} s in all): f32 loss rel, worst grad "
          f"rel, worst weight cosine {fmt(held['f32'])}; bf16 {fmt(held['bf16'])}; CLI train "
          f"2 epochs x {TRAIN_CLI_ITERS} its {train_s:.1f} s (s/it " + ", ".join(
              f"{x:.3f}" for x in it_s) + f"), resume 1 epoch {resume_s:.1f} s, run -t network "
          f"from the trained checkpoint {net_s:.1f} s (mean render time {m.group(1)} s)")
    return ret


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
        check_knn_equal(name, pts, vv, d2k, ik, d2r, ir)
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
        check_knn_equal(f"frame input P={name}", p, vv, d2k, ik, d2r, ir)
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
        check_knn_equal(f"{name} ({p.shape[0]} points)", p, vv, d2k, ik, d2r, ir)
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

    # ---- the CLI: the user's entry points as subprocesses; then the mesh
    # extraction on the tree they generated (this slice's main path)
    del frame_inputs, volume_inputs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cli_smoke_") as tmp:
        launches_cli, cli_err = cli_phase(smi, tmp)
        torch.cuda.empty_cache()
        mesh = mesh_phase(smi, tmp)
        torch.cuda.empty_cache()
        train = train_phase(smi, tmp)
    max_err = max(max_err, cli_err, mesh["max_err"], train["max_err"])

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
        "launches_mesh": mesh["launches"],
        "launches_train": train["launches"],
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
        "mesh_input_ms": mesh["ms"],
        "mesh_input_plain_ms": mesh["plain_ms"],
        "mesh_input_library_ms": mesh["library_ms"],
        "mesh_input_bound_ms": mesh["bound_ms"],
        "train_input_ms": train["ms"],
        "train_input_plain_ms": train["plain_ms"],
        "train_input_library_ms": train["library_ms"],
        "train_input_bound_ms": train["bound_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
