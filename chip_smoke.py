"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py                # every phase below, one card
    python3 chip_smoke.py --multi-gpu    # device, build, the tree, [multi-gpu] alone, every card (<= 4)

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
  golden-512  bench.py's headline frame (``golden.golden512_cfg()``: the
          acceleration stack, exact camera trace, bfloat16 MLPs) at 512x512
          through ``eval/check_golden_512.py``, its KNN launches counted,
          > 45 dB over the whole frame against the JAX package's CPU render
          tests/golden_relight_512_jaxcpu.npy; the PSNR against the stored
          fixtures/golden_relight_512.png printed (stale against the JAX
          package at HEAD: its own render is 41.75 dB from it)
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
          with mask_bkgd off (>= 50 dB against the generated images),
          visualize (one file per enabled Output type per frame; [e2e]
          evaluates at the config's own defaults); then the first CLI frame rendered
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
          vertices beside the plain version and torch.cdist + topk; the canonical and the posed mesh at 2.5 cm on the card
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
          losses, the epoch files) and ``resume True`` for a third epoch
          ([e2e]'s evaluations render from trained checkpoints of both
          stages)
  train-relight  stage-2 training (``eval/train_check.py``): the reference
          relight step (2 frames x 1024 rays, 16 surface and 4 shadow
          iterations, 16 x 32 light texels, shadow blocks of 32,768 rays,
          bf16 MLPs) from the fixture's parameters, timed as the median of 3
          steps after a warm-up on the host clock ending in a device sync,
          with K1's launches a step, its peak memory and the analytic TFLOP
          a step; the kernel bit for bit against the plain version on the
          step's first full shadow block, timed beside it and torch.cdist +
          topk; a small step (2 x 64 rays, the hits away from the
          silhouette) on the card against the CPU with the same jitter:
          float32 (loss within 1e-4, every gradient within 1e-3 of its
          largest entry; the rays whose hit differs counted), then bf16 with
          the residual MLP's zero last weight re-drawn (every weight's
          gradient nonzero, the unused stage-1 render MLP aside, its cosine
          to the CPU's >= 0.9 and each sub-network's, all its tensors
          together, >= 0.995); then on [cli]'s tree ``python -m
          relightableavatar_tpu_torch.train relighting True
          geometry_pretrain <[train]'s checkpoint>`` (2 epochs of 3
          iterations) and ``resume True`` for a third epoch
  e2e     the two-stage pipeline on [cli]'s tree, ``python -m
          relightableavatar_tpu_torch.train.e2e`` in the temporary directory
          (generation skipped: the tree has images), stage 1 seeded with the
          fixture's geometry and resumed for 1 epoch of 3 iterations, the
          volume evaluation, the 5 mm canonical mesh, stage 2 on that mesh as
          the geometry prior for 1 epoch of 3 iterations, the relight
          evaluation, with ``--gate-psnr 0`` (the 28 dB gate is not held at
          this size): the summary's stages in order, finite metrics and their
          provenance, stage 2's "loaded geometry pretrain"; then one stage-2
          step of the pipeline's config on the prior in this process, its K1
          launches counted, and the kernel bit for bit against the plain
          version on the step's first full shadow block against the prior's
          vertices, timed beside it and torch.cdist + topk, with its bound
  options the HDQ, shadow-ray and camera-trace options: the 512² frames of
          ``golden.options_frame_cfg()`` (the exact frame with
          shadow_compact 0.25, shadow_skip_resd, shadow_verts_sub 4) and
          ``golden.premarch_frame_cfg()`` (the accel stack with the
          pre-march of 20 steps on the grid's lower bound and 4 exact
          iterations instead of the miss skip, the bake on the vertex
          subsample) through SphereTracingRenderer.render: median seconds of
          3 renders after a warm-up, K1's launches a frame, peak memory,
          finite maps, hits; the kernel bit for bit against the plain
          version on the subsample route's first full shadow block (P =
          32,768, N = 2,048, from the exact frame with shadow_verts_sub 4)
          and on the options frame's first compacted shadow block, each
          timed beside the plain version and torch.cdist + topk, with its
          bound; knn_grouped on the card equal to the CPU's and knn_select
          equal apart from rows whose bfloat16 values tie, on 8,192 of that
          block's points; every entry of ``golden.OPTION_CHECKS`` as a
          32x32 frame and the ablations world, can and curve on the 256-ray
          near-body bundle (``golden.near_bundle_rays``), card against CPU:
          >= 50 dB on every map, spec_map within 20 % of each pixel
  multi-gpu  the port under ``python -m torch.distributed.run --standalone
          --nproc_per_node W`` (W = min(card count, 4), one rank a card,
          NCCL): first, when W > 1, NCCL alone, ``eval/nccl_probe.py``'s
          default setting (a barrier, all_reduces of the gradient and of one
          float, all_gathers of the frame's maps and of one map, a broadcast,
          each checked and timed, over W ranks importing nothing of the
          port; at W = 1 ``dist_check`` covers what it would); then
          ``eval/dist_check.py`` renders the exact 512² frame sharded over
          the ranks and runs the float32 reference stage-1 and stage-2 steps
          (``train_check.reference_step``) through the distributed Trainer,
          against what this process computes for W ranks: the frame in
          blocks of a rank's rays (``dist_check.reference_frame``; [frame]'s
          maps at W = 1) within 1e-6, spec_map >= 45 dB, and the steps of W
          ranks that are threads of this process on one card
          (``dist_check.reference_steps``; loss within 1e-5, every gradient
          within 1e-4 of its largest entry); over more than one card it also
          prints how far they are from one process's whole blocks and
          chunks; each rank shows the mesh path ran (a process group, the
          renderer's mesh of the world, gathers in the frame, all-reduces in
          each step, K1 launches) and times the frame's gathers and each
          step's gradient all-reduce; then on [cli]'s tree ``python -m
          torch.distributed.run ... -m relightableavatar_tpu_torch.train``
          for 1 epoch of 2 iterations (one checkpoint, finite losses, the
          trainer's mesh) and ``resume True`` for a second epoch.  A NCCL or
          rank failure fails the phase: nothing falls back.
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
from relightableavatar_tpu_torch.eval import (check_golden_512, dist_check, golden, mesh_check,
                                              train_check)
from relightableavatar_tpu_torch.eval.evaluator import MeshEvaluator
from relightableavatar_tpu_torch.eval.knn_cases import (
    FRAME_BLOCKS, cloud_sha256, cuda_ms, frame_input_name, knn_cases, record_knn_inputs,
    save_knn_failure, synthetic_points, time_in_turns)
from relightableavatar_tpu_torch.eval.nccl_probe import run_session
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
from relightableavatar_tpu_torch.train import e2e
from relightableavatar_tpu_torch.train.trainer import Trainer, ray_chunks
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.flops import DEVICE_PEAKS, device_peaks, train_step_flops

# published H100 SXM peaks (NVIDIA H100 datasheet, utils/flops.py): FP32
# outside the tensor cores and HBM3 bandwidth
PEAK_FP32_OPS = DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]["fp32"]
PEAK_BYTES = DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]["hbm"]
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
# the train-relight phase: the reference stage-2 step timed, a small step card vs CPU
RELIGHT_STEPS = 3           # timed steps after one warm-up
SHADOW_P = 32768            # rays a shadow block of the reference step
RELIGHT_LOSS_REL = 1e-4     # f32 step, card vs CPU (PERF.md, before the first chip run)
RELIGHT_GRAD_REL = 1e-3     # f32: max |card - cpu| / max |cpu| of each parameter's gradient
# bf16: the stage-2 step's bf16 gradients move with the float32 summation
# order (a one-ulp change of the sums on the CPU alone: tensors' cosines
# down to 0.979, sub-networks' to 0.9991; PERF.md §6), so the bars are
# five times those distances from 1
RELIGHT_BF16_COS = 0.9      # each weight's gradient, cosine to the CPU's
RELIGHT_BF16_NET_COS = 0.995  # each sub-network's gradient, all its tensors together
# the options phase: two 512² frames timed, the option checks card vs CPU
OPTION_RENDERS = 3          # timed renders a frame after one warm-up
SUB_N = 2048                # vertices of the shadow rays' subsample
# spec_map of a small frame, card vs CPU: max |diff| / max(|cpu|, 1) a pixel.
# Its 1 / |ldot| weight at grazing texels (ROADMAP, "spec_map parity") moves
# it on the CPU alone when the weights move by one part in 1e7
# (eval/options_cpu.py, worst of 3 draws; PERF.md §6): by 3.6 % in the
# knn_xla frame, 3.2 % premarch, 0.72-0.75 % the exact-selection frames,
# 0.08 % hash.  The bar is about five times the largest
OPTION_SPEC_REL = 0.2
SELECT_P = 8192             # points of the KNN routes' card-vs-CPU check
# the e2e phase: the two-stage pipeline on [cli]'s tree at 1 epoch a stage
E2E_EXP = "tubeman_e2e"
E2E_ITERS = 3               # iterations an epoch of each training stage
E2E_TIMEOUT = 600           # seconds the pipeline may take
MULTI_GPU_MAX = 4           # ranks of the [multi-gpu] phase: min(card count, this)
MULTI_GPU_TIMEOUT = 300     # seconds a torchrun subprocess of [multi-gpu] may take
MULTI_GPU_ITERS = 2         # iterations of the CLI's epoch under torchrun
PROBE_TIMEOUT = 90          # seconds the NCCL probe's default setting may take in all
GROUPED_D2_REL = 1e-6       # knn_grouped's d2, card vs CPU (summation order)


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


def run_cli(task_args: list, timeout: int = CLI_TIMEOUT, cwd: str = REPO,
            env: dict | None = None) -> tuple[str, float]:
    """Run a port entry point as ``python -m ...`` in ``cwd`` (the repo's
    root by default; the package is found through PYTHONPATH), with ``env``
    added to this process's environment, through ``nccl_probe.run_session``
    (a session of its own, killed whole after ``timeout`` seconds); fails on
    a non-zero exit or a kill with the end of its output.  Returns (stdout +
    stderr, seconds)."""
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    run = run_session([sys.executable, "-m", *task_args],
                      {**os.environ, **(env or {}), "RA_TPU_NO_PDB": "1", "PYTHONPATH": path},
                      timeout, cwd=cwd)
    out, err = run["out"], run["err"]
    if run["rc"] != 0:
        # the progress lines ("[name] ...", each rank's too) before the tails,
        # which a failed torchrun fills with its ranks' stacks
        marks = "\n".join([line for line in (out + err).splitlines()
                           if re.match(r"\[[\w -]+\] ", line)][-40:])
        how = f"ran past {timeout} s" if run["killed"] else f"exited {run['rc']}"
        check(False, f"{' '.join(task_args[:3])} {how}:\n{marks}\n{out[-2000:]}\n"
              f"{err[-4000:]}")
    return out + err, run["seconds"]


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


def make_tree(tmp: str, size: int = golden.FRAME_SIZE) -> tuple[str, float]:
    """[cli]'s tree, ``tmp/tubeman``: ``make_synthetic`` of CLI_FRAMES x
    CLI_VIEWS images of ``size`` x ``size``.  Returns (its path, seconds)."""
    data = os.path.join(tmp, "tubeman")
    _, gen_s = run_cli(["relightableavatar_tpu_torch.data.make_synthetic", "--root", data,
                        "--frames", str(CLI_FRAMES), "--views", str(CLI_VIEWS),
                        "--size", str(size)])
    return data, gen_s


def cli_phase(smi: str, tmp: str, size: int = golden.FRAME_SIZE) -> tuple[int, float]:
    """The [cli] phase (see the module docstring) on a tree of ``size`` x
    ``size`` images that it generates in ``tmp/tubeman``, with the relight
    checkpoint under ``tmp/trained_model``.  Returns the first CLI frame's
    KNN launches and the largest |d2| difference of the kernel from the plain
    version on its inputs."""
    t0 = time.perf_counter()
    max_err = 0.0
    data, gen_s = make_tree(tmp, size)
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
          f"evaluate exact {exact_s:.1f} s ({fmt(metrics_x)}), visualize {vis_s:.1f} s "
          f"({len(want)} files); ms a frame after the first: network {fmt(ms_n)}; evaluate exact {fmt(ms_x)}; visualize {fmt(ms_v)}; "
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
    prior_knn["library"] = yardstick_ms(pts_r, ctx_r["pverts"])[1]
    ret["prior"] = dict(ms=prior_knn["kernel"], plain_ms=prior_knn["plain"],
                        library_ms=prior_knn["library"],
                        bound_ms=knn_bound_ms(TIMED_P, ctx_r["pverts"].shape[0])[0])

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
          f"kernel {prior_knn['kernel']:.4f} ms / plain {prior_knn['plain']:.4f} ms / "
          f"cdist+topk {prior_knn['library']:.4f} ms at P={TIMED_P}, bound "
          f"{ret['prior']['bound_ms']:.4f} ms; card vs CPU at {mesh_check.CHECK_VOXEL} m ({coarse_s:.1f} s): "
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
    # the log line's MFU: printed where the card's datasheet peak is known
    mfus = [float(m) for m in re.findall(r" mfu ([\d.]+)%", log_t)]
    check(bool(mfus) == (device_peaks("cuda") is not None),
          f"the train CLI printed mfu {mfus} on a card whose peaks are {device_peaks('cuda')}")
    log_r, resume_s = run_cli(["relightableavatar_tpu_torch.train", *common, "resume", "True",
                               "train.epoch", "3"], timeout=CLI_TIMEOUT)
    with np.load(os.path.join(mdir, "latest.npz")) as f:
        check(int(f["epoch"]) == 3, f"resume saved epoch {int(f['epoch'])}, not 3")
    fmt = lambda t: ", ".join(f"{x:.3e}" for x in t)
    ret["model_dir"] = mdir
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
              f"{x:.3f}" for x in it_s) + "; mfu " + (", ".join(f"{x:.2f}%" for x in mfus)
                                                   or "not printed: no peak for this card")
          + f"), resume 1 epoch {resume_s:.1f} s")
    return ret


def train_relight_phase(smi: str, tmp: str, geometry: str) -> dict:
    """The [train-relight] phase (see the module docstring) on the tree
    [cli] left in ``tmp``, with [train]'s stage-1 checkpoint ``geometry``.
    Returns the timed steps' KNN launches and the kernel's times on the
    step's first full shadow block, with its bound and largest |d2|
    difference from the plain version."""
    t0 = time.perf_counter()
    ret = {}
    # (a) the reference stage-2 step, bf16
    cfg = train_check.relight_step_cfg(bf16=True, record_dir=os.path.join(tmp, "relight_rec"))
    trainer, batch = train_check.make_step(cfg, "cuda", train_check.RELIGHT_R)
    inputs: dict = {}
    with record_knn_inputs(inputs, sizes=(SHADOW_P,), tail=False):
        trainer.step(batch, 0)                                  # warm-up
    torch.cuda.synchronize()
    check(SHADOW_P in inputs, f"the step traced no full shadow block of {SHADOW_P} rays")
    torch.cuda.reset_peak_memory_stats()
    secs, tflops, shadow = [], [], []
    knn_cuda.KNN_TOP3.launches = 0
    for _ in range(RELIGHT_STEPS):
        t1 = time.perf_counter()
        stats = trainer.step(batch, 0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        tflops.append(trainer.step_flops(batch) / 1e12)
        shadow.append(trainer.shadow_rays)
    ret["launches"] = knn_cuda.KNN_TOP3.launches
    check(ret["launches"] > 0, "the stage-2 step did not launch the KNN kernel")
    per_step = ret["launches"] / RELIGHT_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = float(stats.loss)
    check(math.isfinite(loss), f"the timed stage-2 step's loss is {loss}")
    step_s = statistics.median(secs)
    tflop = statistics.mean(tflops)
    p, vv = inputs[SHADOW_P]
    d2k, ik = knn_cuda.knn_top3_cuda(p, vv)
    d2r, ir = knn_top3_reference(p, vv)
    ret["max_err"] = max_abs_diff(d2k, d2r)
    check_knn_equal(f"stage-2 step shadow block P={p.shape[0]}", p, vv, d2k, ik, d2r, ir)
    ret["ms"] = time_in_turns({"kernel": lambda: knn_cuda.knn_top3_cuda(p, vv)}, REPS)["kernel"]
    ret["plain_ms"], ret["library_ms"] = yardstick_ms(p, vv)
    ret["bound_ms"] = knn_bound_ms(p.shape[0], vv.shape[0])[0]
    del trainer, batch, inputs, p, vv
    torch.cuda.empty_cache()

    # (b) the small step on the card against the CPU, the same jitter:
    # float32, then bf16 with the residual MLP's last layer re-drawn
    held, flips = {}, None
    for bf16 in (False, True):
        res, hits = {}, {}
        for dev in ("cuda", "cpu"):
            cfg_c = train_check.relight_step_cfg(bf16=bf16, record_dir=os.path.join(tmp, "rcheck"))
            tr, bt, jitter = train_check.make_relight_check(cfg_c, dev)
            if bf16:
                train_check.live_residual(tr)
            else:
                hits[dev] = train_check.ray_hits(tr, bt).cpu()
            res[dev] = train_check.step_result(tr, bt, jitter)
        cmp = {k: v for k, v in train_check.compare_grads(res["cuda"], res["cpu"]).items()
               if not k.startswith("rgb/")}        # the stage-1 render MLP, unused here
        nets = train_check.compare_nets(res["cuda"], res["cpu"])
        loss_rel = abs(res["cuda"]["loss"] - res["cpu"]["loss"]) / abs(res["cpu"]["loss"])
        worst_rel = max(v[0] for v in cmp.values())
        worst_cos = min(v[1] for k, v in cmp.items() if not k.endswith(("/b", "beta"))
                        and (bf16 or v[2] > 0))
        if bf16:
            dead = [k for k, v in cmp.items() if v[2] == 0 and not k.endswith(("/b", "beta"))]
            check(not dead, f"stage-2 bf16 step on the card: weights without a gradient: {dead}")
            worst_k = min((v[1], k) for k, v in cmp.items() if not k.endswith(("/b", "beta")))
            check(worst_cos >= RELIGHT_BF16_COS and min(nets.values()) >= RELIGHT_BF16_NET_COS,
                  f"stage-2 bf16 step on the card: worst weight {worst_k}, sub-networks {nets} "
                  f"(bars {RELIGHT_BF16_COS}, {RELIGHT_BF16_NET_COS}) to the CPU's")
        else:
            flips = int((hits["cuda"] != hits["cpu"]).sum())
            n_hit = int(hits["cpu"].sum())
            check(loss_rel <= RELIGHT_LOSS_REL, f"stage-2 f32 step card vs CPU loss: "
                  f"{loss_rel:.3e} ({flips} rays' hits differ)")
            bad = {k: v[0] for k, v in cmp.items() if v[0] > RELIGHT_GRAD_REL}
            check(not bad, f"stage-2 f32 step card vs CPU gradients beyond {RELIGHT_GRAD_REL}: "
                  f"{bad} ({flips} rays' hits differ)")
        held["bf16" if bf16 else "f32"] = (loss_rel, worst_rel, worst_cos, min(nets.values()))
    t_check = time.perf_counter()

    # (c) the CLI: stage 2 from [train]'s geometry, train, resume, render
    data = os.path.join(tmp, "tubeman")
    common = ["-c", CLI_CFG, "relighting", "True", "geometry_pretrain", geometry,
              "exp_name", "tubeman_verify", "trained_model_dir",
              os.path.join(tmp, "trained_train"), "record_dir", os.path.join(tmp, "record"),
              "result_dir", os.path.join(tmp, "res"), "train_dataset.data_root", data,
              "test_dataset.data_root", data, "ep_iter", str(TRAIN_CLI_ITERS),
              "train.num_workers", "2", "eval_ep", "100", "save_ep", "100"]
    log_t, train_s = run_cli(["relightableavatar_tpu_torch.train", *common, "resume", "False",
                              "train.epoch", "2"], timeout=CLI_TIMEOUT)
    check("loaded geometry pretrain" in log_t, "stage 2 did not load the stage-1 geometry")
    cfg_t, _ = setup(common)
    mdir = cfg_t.trained_model_dir
    check(mdir.endswith(os.path.join("relight", "tubeman_verify")), f"stage 2 saved to {mdir}")
    check(sorted(os.listdir(mdir)) == ["1.npz", "2.npz", "latest.npz"],
          f"stage-2 train wrote {sorted(os.listdir(mdir))}")
    rows = [json.loads(line) for line in open(os.path.join(cfg_t.record_dir, "scalars.jsonl"))]
    check(len(rows) == 2 * TRAIN_CLI_ITERS and all(math.isfinite(r["loss"]) for r in rows),
          f"stage-2 train's recorded losses: {[r.get('loss') for r in rows]}")
    it_s = [float(m) for m in re.findall(r"([\d.]+)s/it", log_t)]
    # the log line's MFU: printed where the card's datasheet peak is known
    mfus = [float(m) for m in re.findall(r" mfu ([\d.]+)%", log_t)]
    check(bool(mfus) == (device_peaks("cuda") is not None),
          f"the train CLI printed mfu {mfus} on a card whose peaks are {device_peaks('cuda')}")
    log_r, resume_s = run_cli(["relightableavatar_tpu_torch.train", *common, "resume", "True",
                               "train.epoch", "3"], timeout=CLI_TIMEOUT)
    with np.load(os.path.join(mdir, "latest.npz")) as f:
        check(int(f["epoch"]) == 3, f"stage-2 resume saved epoch {int(f['epoch'])}, not 3")
        check("net:albedo/layers/0/w" in f.files and "net:env" in f.files,
              "the stage-2 checkpoint lacks the relight heads or the envmap")
    fmt = lambda t: ", ".join(f"{x:.3e}" for x in t)
    losses = ", ".join(f"{r['loss']:.5f}" for r in rows)
    phase("train-relight", t0, f"reference stage-2 step B={train_check.RELIGHT_B} "
          f"R={train_check.RELIGHT_R}, bf16, fixture parameters ({smi}): median "
          f"{step_s * 1e3:.1f} ms of {RELIGHT_STEPS} steps after one warm-up ("
          + ", ".join(f"{x * 1e3:.1f}" for x in secs) + f" ms), {tflop:.3f} TFLOP a step "
          f"(analytic, {statistics.mean(shadow):.0f} shadow rays) = {tflop / step_s:.2f} "
          f"TFLOP/s, peak memory {peak:.2f} GiB, loss {loss:.5f}; K1 launches a step "
          f"{per_step:.1f}; on the step's shadow block P={SHADOW_P} kernel {ret['ms']:.4f} / "
          f"plain {ret['plain_ms']:.4f} / cdist+topk {ret['library_ms']:.4f} ms, bound "
          f"{ret['bound_ms']:.4f} ms, equal to the plain version; card vs CPU at "
          f"B={train_check.RELIGHT_B} R={train_check.RELIGHT_CHECK_R} ({t_check - t0:.1f} s in "
          f"all): f32 loss rel, worst grad rel, worst weight cosine, worst sub-network "
          f"cosine {fmt(held['f32'])}, rays "
          f"whose hit differs {flips} of {2 * train_check.RELIGHT_CHECK_R} ({n_hit} hit on "
          f"the CPU); bf16 {fmt(held['bf16'])}; CLI stage-2 train 2 epochs x "
          f"{TRAIN_CLI_ITERS} its {train_s:.1f} s (s/it " + ", ".join(f"{x:.3f}" for x in it_s)
          + f"; losses {losses}), resume 1 epoch {resume_s:.1f} s")
    return ret


def golden512_phase(smi: str) -> dict:
    """The [golden-512] phase (see the module docstring).  Returns its KNN
    launches and PSNR."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    knn_cuda.KNN_TOP3.launches = 0
    img = check_golden_512.render("cuda")
    torch.cuda.synchronize()
    launches = knn_cuda.KNN_TOP3.launches
    render_s = time.perf_counter() - t0
    check(launches > 0, "the golden 512 frame did not launch the KNN kernel")
    check(img.shape == (golden.FRAME_SIZE, golden.FRAME_SIZE, 3) and np.isfinite(img).all(),
          f"the golden 512 frame is {img.shape}, or not finite")
    ok, p = golden.check_golden(img, golden.GOLDEN_RELIGHT_512_JAXCPU, check_golden_512.MIN_PSNR)
    _, p_png = golden.check_golden(img, golden.GOLDEN_RELIGHT_512)
    check(ok, f"golden 512: {p:.2f} dB <= {check_golden_512.MIN_PSNR} dB against "
              f"{os.path.relpath(golden.GOLDEN_RELIGHT_512_JAXCPU, REPO)}")
    phase("golden-512", t0, f"bench.py's headline frame (golden512_cfg, {smi}): render "
          f"{render_s:.3f} s (first call), KNN kernel launches {launches}; over the whole "
          f"frame {p:.2f} dB against the JAX package's CPU render "
          f"tests/golden_relight_512_jaxcpu.npy (bar > {check_golden_512.MIN_PSNR} dB), "
          f"{p_png:.2f} dB against the stored fixtures/golden_relight_512.png (stale: the JAX "
          f"package's own render is 41.75 dB from it; not held)")
    return dict(launches=launches, psnr=p, psnr_png=p_png)


def e2e_phase(smi: str, tmp: str) -> dict:
    """The [e2e] phase (see the module docstring) on the tree [cli] left in
    ``tmp``.  Returns K1's launches in one stage-2 step on the prior and the
    kernel's times on that step's first full shadow block."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "e2e")
    os.makedirs(os.path.join(root, os.path.dirname(e2e.DATA_ROOT)))
    os.symlink(os.path.join(tmp, "tubeman"), os.path.join(root, e2e.DATA_ROOT))
    e2e.seed_stage1(root, E2E_EXP)
    flags = ["--root", root, "--exp", E2E_EXP, "--epochs1", "1", "--epochs2", "1", "--resume",
             "--gate-psnr", "0", "--extra", "ep_iter", str(E2E_ITERS)]
    args = e2e.parse_args(flags)
    _, run_s = run_cli(["relightableavatar_tpu_torch.train.e2e", *flags], timeout=E2E_TIMEOUT)
    print(f"[e2e] the {e2e.make_parser().get_default('gate_psnr')} dB gate is not held at this "
          f"size (1 epoch of {E2E_ITERS} iterations a stage from the fixture's geometry): "
          "--gate-psnr 0", flush=True)
    rec = os.path.join(root, "data", "record", E2E_EXP)
    with open(os.path.join(rec, "e2e_summary.json")) as f:
        summary = json.load(f)
    names = ["train1", "eval1", "mesh", "train2", "eval2"]
    check(list(summary["stages"]) == [f"{n}_s" for n in names],
          f"the pipeline ran the stages {list(summary['stages'])}")
    for key in ("eval_stage1", "eval_stage2"):
        m = summary[key] or {}
        check(all(math.isfinite(m.get(k, math.nan)) for k in ("psnr", "ssim", "lpips")),
              f"{key}: {m}")
    prov1, prov2 = summary["eval_stage1"]["provenance"], summary["eval_stage2"]["provenance"]
    check(prov1["checkpoint_epoch"] == 1 and prov2["checkpoint_epoch"] == 1
          and prov2["geometry_pretrain_epoch"] == 1
          and prov2["geometry_mesh"] == e2e.mesh_path(args),
          f"provenance: {prov1}, {prov2}")
    with open(os.path.join(rec, "train2.log")) as f:
        check("loaded geometry pretrain" in f.read(), "stage 2 did not load the stage-1 geometry")
    with np.load(os.path.join(root, e2e.mesh_path(args))) as f:
        n_prior = len(f["verts"])

    # one stage-2 step of the pipeline's config on the prior, in this process
    t1 = time.perf_counter()
    train2 = next(st for st in e2e.plan(args) if st.name == "train2")
    with e2e.working_dir(root):
        cfg, _ = setup([*train2.argv, "record_dir", os.path.join(tmp, "e2e_step")])
        params, mcfg = make_network(cfg, device="cuda")
        trainer = Trainer(cfg, params, mcfg, device="cuda")
        items = iter(make_data_loader(cfg, is_train=True, device="cuda"))
        batch = trainer.collate([next(items) for _ in range(int(cfg.train.batch_size))])
    inputs: dict = {}
    with record_knn_inputs(inputs, sizes=(SHADOW_P,), tail=False):
        trainer.step(batch, 0)                                  # warm-up
    torch.cuda.synchronize()
    knn_cuda.KNN_TOP3.launches = 0
    t_step = time.perf_counter()
    stats = trainer.step(batch, 1)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t_step
    ret = {"launches": knn_cuda.KNN_TOP3.launches}
    check(ret["launches"] > 0, "the stage-2 step on the prior did not launch the KNN kernel")
    check(math.isfinite(float(stats.loss)), f"the stage-2 step's loss on the prior: {stats.loss}")
    check(SHADOW_P in inputs, f"the step on the prior traced no full shadow block of {SHADOW_P}")
    p, vv = inputs[SHADOW_P]
    check(vv.shape[0] == n_prior, f"the shadow block's KNN ran against {vv.shape[0]} vertices, "
                                  f"not the prior's {n_prior}")
    d2k, ik = knn_cuda.knn_top3_cuda(p, vv)
    d2r, ir = knn_top3_reference(p, vv)
    ret["max_err"] = max_abs_diff(d2k, d2r)
    check_knn_equal(f"stage-2 step on the prior, shadow block P={p.shape[0]}", p, vv, d2k, ik,
                    d2r, ir)
    ret["ms"] = time_in_turns({"kernel": lambda: knn_cuda.knn_top3_cuda(p, vv)}, REPS)["kernel"]
    ret["plain_ms"], ret["library_ms"] = yardstick_ms(p, vv)
    ret["bound_ms"] = knn_bound_ms(p.shape[0], vv.shape[0])[0]
    ret["N"] = int(vv.shape[0])
    del trainer, batch, inputs, p, vv, params
    torch.cuda.empty_cache()
    fmt = lambda m: ", ".join(f"{k} {v:.5g}" for k, v in m.items()
                              if k in ("psnr", "ssim", "lpips"))
    phase("e2e", t0, f"python -m relightableavatar_tpu_torch.train.e2e on [cli]'s tree ({smi}) "
          f"{run_s:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in summary["stages"].items())
          + f"; eval1 {fmt(summary['eval_stage1'])}; eval2 {fmt(summary['eval_stage2'])}; "
          f"stage-1 and stage-2 checkpoints at epoch 1, the prior {n_prior} vertices; "
          f"learned envmap mean {summary['lighting']['mean']:.4f} max "
          f"{summary['lighting']['max']:.4f}; one stage-2 step on the prior "
          f"{step_s * 1e3:.1f} ms (after one warm-up), K1 launches {ret['launches']}; on its "
          f"shadow block P={SHADOW_P} N={ret['N']} kernel {ret['ms']:.4f} / plain "
          f"{ret['plain_ms']:.4f} / cdist+topk {ret['library_ms']:.4f} ms, bound "
          f"{ret['bound_ms']:.4f} ms, equal to the plain version "
          f"({time.perf_counter() - t1:.1f} s for the step and the kernel)")
    return ret


def options_phase(smi: str, ctx: dict, batch, n_fg: int) -> dict:
    """The [options] phase (see the module docstring).  Returns the two
    frames' KNN launches a frame and the kernel's times on the recorded
    subsample shadow block and compacted shadow block, with their bounds
    and largest |d2| difference from the plain version."""
    t0 = time.perf_counter()
    ret = {"max_err": 0.0, "inputs": {}}
    compacted: dict = {}        # the options frame's first full shadow block
    frames = {}
    for name, cfg_fn in (("options", golden.options_frame_cfg),
                         ("premarch", golden.premarch_frame_cfg)):
        cfg = cfg_fn()
        _, params, mcfg = golden.load_fixture(cfg, device="cuda")
        renderer = SphereTracingRenderer(cfg, params, mcfg, device="cuda")
        with record_knn_inputs(compacted if name == "options" else {}, sizes=(SHADOW_P,),
                               tail=False):
            renderer.render(batch)                              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        knn_cuda.KNN_TOP3.launches = 0
        for _ in range(OPTION_RENDERS):
            t1 = time.perf_counter()
            res = renderer.render(batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
        launches = knn_cuda.KNN_TOP3.launches
        check(launches > 0, f"the {name} frame did not launch the KNN kernel")
        check(launches % OPTION_RENDERS == 0, f"the {name} frame's launches {launches} differ "
              "between its renders")
        check(res.rgb_map.shape == (n_fg, 3), f"{name} frame shapes")
        for k, v in res.items():
            if isinstance(v, torch.Tensor):
                check(bool(torch.isfinite(v).all()), f"{name} frame {k} not finite")
        hits = int((res.acc_map > 0).sum())
        check(hits > 0, f"the {name} frame hit nothing")
        frames[name] = dict(s=statistics.median(secs), secs=secs, hits=hits,
                            launches=launches // OPTION_RENDERS,
                            peak=torch.cuda.max_memory_allocated() / 2**30)
        del res, renderer
    ret["launches_options"] = frames["options"]["launches"]
    ret["launches_premarch"] = frames["premarch"]["launches"]
    # the subsample route's first full shadow block: the exact frame with
    # tpu.shadow_verts_sub alone (under shadow_compact the shadow HDQ takes
    # the full cloud, as the JAX package's does)
    cfg = golden.frame_cfg()
    cfg.tpu.shadow_verts_sub = 4
    _, params, mcfg = golden.load_fixture(cfg, device="cuda")
    subsample: dict = {}
    with record_knn_inputs(subsample, sizes=(SHADOW_P,), tail=False):
        t1 = time.perf_counter()
        SphereTracingRenderer(cfg, params, mcfg, device="cuda").render(batch)
        torch.cuda.synchronize()
        sub_s = time.perf_counter() - t1
    N = int(ctx["pverts"].shape[0])
    for store, n, name in ((subsample, SUB_N, "subsample shadow block"),
                           (compacted, N, "compacted shadow block")):
        check(SHADOW_P in store and store[SHADOW_P][1].shape[0] == n,
              f"{name}: no KNN call of {SHADOW_P} points against {n} vertices")
        p, vv = store[SHADOW_P]
        d2k, ik = knn_cuda.knn_top3_cuda(p, vv)
        d2r, ir = knn_top3_reference(p, vv)
        ret["max_err"] = max(ret["max_err"], max_abs_diff(d2k, d2r))
        check_knn_equal(f"{name} P={p.shape[0]} N={vv.shape[0]}", p, vv, d2k, ik, d2r, ir)
        ms = time_in_turns({"kernel": lambda p=p, vv=vv: knn_cuda.knn_top3_cuda(p, vv)},
                           REPS)["kernel"]
        plain_ms, library_ms = yardstick_ms(p, vv)
        ret["inputs"][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=knn_bound_ms(p.shape[0], vv.shape[0])[0],
                                   N=vv.shape[0])
    # the KNN routes with no hand-written kernel, card against CPU
    p = compacted[SHADOW_P][0][:SELECT_P].contiguous()
    keys = ("knn_gverts", "knn_gcent", "knn_gradius", "knn_gvid")
    d2g, ig = knn_mod.knn_grouped(p, *[ctx[k] for k in keys])
    d2gc, igc = knn_mod.knn_grouped(p.cpu(), *[ctx[k].cpu() for k in keys])
    grouped_rows = int((ig.cpu() != igc).any(dim=1).sum())
    grouped_rel = float(((d2g.cpu() - d2gc).abs() / d2gc.clamp(min=1e-12)).max())
    # the indices equal; d2 (a 3-term sum the HDQ does not read) to an ulp or two
    check(grouped_rows == 0 and grouped_rel <= GROUPED_D2_REL,
          f"knn_grouped card vs CPU: {grouped_rows} of {SELECT_P} rows differ, d2 max "
          f"relative {grouped_rel:.3e}")
    sel = knn_mod.knn_select(p, ctx["pverts"]).cpu()
    selc = knn_mod.knn_select(p.cpu(), ctx["pverts"].cpu())
    rows = (sel != selc).any(dim=1)
    bf = [(p.cpu()[rows, i:i + 1] - ctx["pverts"].cpu()[None, :, i]).to(torch.bfloat16)
          for i in range(3)]
    d2b = ((bf[0] * bf[0] + bf[1] * bf[1]) + bf[2] * bf[2]).float()
    check(torch.equal(torch.gather(d2b, 1, sel[rows]), torch.gather(d2b, 1, selc[rows])),
          "knn_select card vs CPU: rows differ beyond bf16 ties")
    select_ties = int(rows.sum())
    # every option on the small frame, the ablations on the near-body bundle
    t1 = time.perf_counter()
    held, spec, failed = {}, {}, []
    for name, opts in golden.OPTION_CHECKS:
        cfg = golden.option_check_cfg(opts)
        card = golden.render_check_frame(cfg, device="cuda")
        cpu = golden.render_check_frame(cfg, device="cpu")
        held[name], spec[name] = _card_vs_cpu(f"32x32 {name} frame", card, cpu, failed)
    _, params_c, mcfg_c = golden.load_fixture(device="cpu")
    ctx_c = {k: v.cpu() for k, v in ctx.items()}
    _, params_g, _ = golden.load_fixture(device="cuda")
    for mode in ("world", "can", "curve"):
        extra = {'ablate_mode': mode}
        card = golden.render_golden_bundle(ctx, params_g, mcfg_c, device="cuda",
                                           rcfg_extra=extra, near_bundle=True)
        cpu = golden.render_golden_bundle(ctx_c, params_c, mcfg_c, device="cpu",
                                          rcfg_extra=extra, near_bundle=True)
        card = {k: v.cpu().numpy() for k, v in card.items()}
        cpu = {k: v.numpy() for k, v in cpu.items()}
        check(bool((cpu["acc_map"] > 0).any()), f"the {mode} bundle hit nothing")
        held[mode], spec[mode] = _card_vs_cpu(f"near-body bundle {mode}", card, cpu, failed)
    check_s = time.perf_counter() - t1
    print("[options] card vs CPU, worst map dB / spec_map max relative: " + ", ".join(
        f"{k} {held[k]:.2f} / {spec[k]:.2e}" for k in held), flush=True)
    check(not failed, "; ".join(failed))
    fr = frames
    phase("options", t0, f"{golden.FRAME_SIZE}x{golden.FRAME_SIZE} frames ({smi}), median of "
          f"{OPTION_RENDERS} renders after a warm-up: options (shadow_compact 0.25, "
          f"shadow_skip_resd, shadow_verts_sub 4; {fr['options']['hits']} hit) "
          f"{fr['options']['s']:.3f} s (" + ", ".join(f"{x:.3f}" for x in fr['options']['secs'])
          + f"), K1 launches {fr['options']['launches']} a frame, peak "
          f"{fr['options']['peak']:.2f} GiB; premarch (accel stack, surf_grid_iters 20, "
          f"surf_exact_iters 4, the bake on the subsample; {fr['premarch']['hits']} hit) "
          f"{fr['premarch']['s']:.3f} s (" + ", ".join(f"{x:.3f}" for x in fr['premarch']['secs'])
          + f"), K1 launches {fr['premarch']['launches']} a frame, peak "
          f"{fr['premarch']['peak']:.2f} GiB; the exact frame with shadow_verts_sub 4 "
          f"{sub_s:.3f} s (first render); K1 equal to the plain version, kernel / plain / "
          "cdist+topk / bound " + ", ".join(
              f"{k} P={SHADOW_P} N={v['N']} {v['ms']:.4f} / {v['plain_ms']:.4f} / "
              f"{v['library_ms']:.4f} / {v['bound_ms']:.4f} ms" for k, v in ret["inputs"].items())
          + f"; knn_grouped card = CPU on {SELECT_P} points (d2 max relative "
          f"{grouped_rel:.2e}), knn_select rows on bf16 ties "
          f"{select_ties} of {SELECT_P}; card vs CPU ({check_s:.1f} s), worst map dB / "
          "spec_map max relative: " + ", ".join(
              f"{k} {held[k]:.2f} / {spec[k]:.2e}" for k in held))
    return ret


def multi_gpu_phase(smi: str, tmp: str, frame: dict | None, count: int) -> dict:
    """The [multi-gpu] phase (see the module docstring): ``frame`` holds
    [frame]'s single-process maps (numpy; rendered here when None), ``tmp``
    [cli]'s tree.  Returns the ranks' K1 launches of the sharded frame and
    their dist_check lines."""
    t0 = time.perf_counter()
    W = min(count, MULTI_GPU_MAX)
    probe_line = "NCCL probe not run at W = 1 (dist_check covers one rank)"
    if W > 1:
        # NCCL alone over the W cards first: a failure here is the machine's
        log_p, probe_s = run_cli(["relightableavatar_tpu_torch.eval.nccl_probe", "--nproc",
                                  str(W), "--settings", "default"], timeout=PROBE_TIMEOUT)
        m = re.search(r"\[nccl-probe\] (\{.*\})", log_p)
        check(m is not None, f"the NCCL probe printed no line:\n{log_p[-3000:]}")
        probe = json.loads(m.group(1))
        check(probe["ok"] and probe["world"] == W, f"the NCCL probe over {W} cards: {probe}")
        probe_line = (f"NCCL probe (default setting) {probe_s:.1f} s: median ms "
                      + ", ".join(f"{k} {v:.3f}" for k, v in probe["ms"].items())
                      + f", transports {probe['transports']}")

    # the sharded frame and steps against this process's for the same ranks
    # and, over more than one, against its whole blocks and chunks
    t_ref = time.perf_counter()
    ref = os.path.join(tmp, "dist_ref")
    rec = os.path.join(tmp, "dist_rec")
    os.makedirs(os.path.join(ref, "whole"))
    whole = frame if frame is not None else dist_check.reference_frame(1)
    refs = {"frame": whole if W == 1 else dist_check.reference_frame(W),
            **dist_check.reference_steps(W, record_dir=rec)}
    if W > 1:
        refs.update({f"whole/{k}": v for k, v in
                     dict(frame=whole, **dist_check.reference_steps(1, record_dir=rec)).items()})
    for name, arrays in refs.items():
        np.savez(os.path.join(ref, f"{name}.npz"), **arrays)
    del refs, whole
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_ref
    run = ["torch.distributed.run", "--standalone", "--nproc_per_node", str(W)]
    log_d, check_s = run_cli([*run, "-m", "relightableavatar_tpu_torch.eval.dist_check",
                              "--ref", ref], timeout=MULTI_GPU_TIMEOUT)
    lines = sorted((json.loads(m) for m in re.findall(r"\[dist-check\] (\{.*\})", log_d)),
                   key=lambda d: d["rank"])
    check([d["rank"] for d in lines] == list(range(W)),
          f"dist_check printed the lines of ranks {[d['rank'] for d in lines]}, not 0..{W - 1}")
    for d in lines:
        check(d["world"] == W and d["backend"] == "nccl", f"rank {d['rank']}: world "
              f"{d['world']}, backend {d['backend']}")
        check(d["frame_launches"] > 0 and d["frame_collectives"]["gather"] > 0
              and all(d[f"{st}_launches"] > 0 and d[f"{st}_all_reduces"] > 0
                      for st in dist_check.STAGES),
              f"rank {d['rank']}: the mesh path did not run: {d}")

    # the train CLI under torchrun: 1 epoch, then a resume for a second
    data = os.path.join(tmp, "tubeman")
    common = ["-c", CLI_CFG, "exp_name", "tubeman_dist", "trained_model_dir",
              os.path.join(tmp, "trained_dist"), "record_dir", os.path.join(tmp, "record_dist"),
              "result_dir", os.path.join(tmp, "res_dist"), "train_dataset.data_root", data,
              "test_dataset.data_root", data, "ep_iter", str(MULTI_GPU_ITERS),
              "train.num_workers", "2", "eval_ep", "100", "save_ep", "100"]
    train = [*run, "-m", "relightableavatar_tpu_torch.train", *common]
    log_t, train_s = run_cli([*train, "resume", "False", "train.epoch", "1"],
                             timeout=MULTI_GPU_TIMEOUT)
    check(f"training over {W}-device mesh" in log_t, "the train CLI did not shard its step")
    cfg_t, _ = setup(common)
    mdir = cfg_t.trained_model_dir
    check(sorted(os.listdir(mdir)) == ["1.npz", "latest.npz"],
          f"the train CLI under torchrun wrote {sorted(os.listdir(mdir))}")
    scalars = os.path.join(cfg_t.record_dir, "scalars.jsonl")
    rows = [json.loads(line) for line in open(scalars)]
    check(len(rows) == MULTI_GPU_ITERS and all(math.isfinite(r["loss"]) for r in rows),
          f"the train CLI under torchrun recorded {[r.get('loss') for r in rows]}")
    _, resume_s = run_cli([*train, "resume", "True", "train.epoch", "2"],
                          timeout=MULTI_GPU_TIMEOUT)
    with np.load(os.path.join(mdir, "latest.npz")) as f:
        check(int(f["epoch"]) == 2, f"the resume under torchrun saved epoch {int(f['epoch'])}")
    rows = [json.loads(line) for line in open(scalars)]
    check(len(rows) == 2 * MULTI_GPU_ITERS and all(math.isfinite(r["loss"]) for r in rows),
          f"the resumed train CLI recorded {[r.get('loss') for r in rows]}")

    r0 = lines[0]
    fmt = lambda d: ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in d.items())
    per_rank = "; ".join(
        f"rank {d['rank']} ({d['device']}, local rank {d['local_rank']}): frame "
        f"{d['frame_s']:.3f} s, K1 launches {d['frame_launches']}, collectives "
        f"{d['frame_collectives']}, gathers {d['frame_gather_ms']:.3f} ms for "
        f"{d['frame_gather_bytes']} B; " + ", ".join(
            f"{st} {d[st + '_s']:.3f} s, K1 launches {d[st + '_launches']}, all-reduces "
            f"{d[st + '_all_reduces']}, gradient all-reduce {d[st + '_all_reduce_ms']:.3f} ms "
            f"for {d[st + '_all_reduce_bytes']} B" for st in dist_check.STAGES)
        + f"; {d['seconds']:.1f} s in all" for d in lines)
    whole_text = "" if W == 1 else (
        f"; rank 0 against one process of whole blocks and chunks (no bar): frame "
        f"{fmt(r0['frame_whole_max_abs'])}; "
        + "; ".join(f"{st} {fmt(r0[st + '_whole'])}" for st in dist_check.STAGES))
    phase("multi-gpu", t0, f"torchrun --nproc_per_node {W}, NCCL {r0['nccl']} ({smi}); "
          f"{probe_line}; references in this process {ref_s:.1f} s; dist_check {check_s:.1f} s: "
          f"{per_rank}; rank 0 against one process of {W} rank(s)' blocks and chunks: frame "
          f"{fmt(r0['frame_max_abs'])}; "
          + "; ".join(f"{st} {fmt(r0[st])}" for st in dist_check.STAGES) + whole_text
          + f"; train CLI 1 epoch x {MULTI_GPU_ITERS} its {train_s:.1f} s (losses "
          + ", ".join(f"{r['loss']:.5f}" for r in rows) + f"), resume 1 epoch {resume_s:.1f} s")
    return dict(launches=[d["frame_launches"] for d in lines], lines=lines)


def _card_vs_cpu(name: str, card: dict, cpu: dict, failed: list) -> tuple[float, float]:
    """Holds every map of ``card`` to ``cpu``: >= CARD_CPU_MIN_PSNR, spec_map
    within OPTION_SPEC_REL of each pixel; a map that misses its bar is added
    to ``failed``.  Returns (worst PSNR of the other maps, spec_map's largest
    relative difference)."""
    check(set(card) == set(cpu), f"{name}: maps {sorted(card)} vs {sorted(cpu)}")
    worst, spec = 120.0, 0.0
    for k in cpu:
        check(card[k].shape == cpu[k].shape and np.isfinite(card[k]).all(),
              f"{name} {k}: shape or not finite")
        if k == "spec_map":
            spec = float((np.abs(card[k] - cpu[k]) / np.maximum(np.abs(cpu[k]), 1)).max())
            if spec > OPTION_SPEC_REL:
                failed.append(f"{name} spec_map: card vs CPU max relative {spec:.3e} > "
                              f"{OPTION_SPEC_REL}")
        else:
            p = golden.psnr(card[k], cpu[k])
            worst = min(worst, p)
            if p < CARD_CPU_MIN_PSNR:
                failed.append(f"{name} {k}: card vs CPU {p:.2f} dB")
    return worst, spec


def device_and_build() -> tuple[str, int, str]:
    """The [device] and [build] phases; exits 2 without a CUDA device.
    Returns the card's name, the card count and nvidia-smi's name and power
    limit."""
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on a GPU only", file=sys.stderr)
        sys.exit(2)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    clocks = nvidia_smi("clocks.max.sm,clocks.sm")
    phase("device", t0, f"{kind} x{count}; nvidia-smi: {smi}; sm clock max,now: "
          f"{clocks}; python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kern = knn_cuda.KNN_TOP3.load()
    for line in kern.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)
    phase("build", t0, f"{kern.path} built in {kern.build_seconds:.2f} s")
    return kind, count, smi


def multi_gpu_main() -> None:
    """``python3 chip_smoke.py --multi-gpu``: [device], [build], [cli]'s
    tree, then [multi-gpu] over min(card count, MULTI_GPU_MAX) cards; the
    last two lines as the whole run's, without the kernels line."""
    kind, count, smi = device_and_build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cli_smoke_") as tmp:
        _, gen_s = make_tree(tmp)
        phase("cli", t0, f"make_synthetic {CLI_FRAMES}x{CLI_VIEWS} {gen_s:.1f} s")
        multi_gpu_phase(smi, tmp, None, count)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


def main() -> None:
    kind, count, smi = device_and_build()
    dev = torch.device("cuda")

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
    frame_ref = dist_check.frame_maps(res)
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

    # ---- bench.py's headline frame against the JAX package's 512² golden
    del renderer_a
    torch.cuda.empty_cache()
    gold = golden512_phase(smi)

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
        torch.cuda.empty_cache()
        relight = train_relight_phase(smi, tmp, train["model_dir"])
        torch.cuda.empty_cache()
        # ---- the two-stage pipeline from [cli]'s images
        pipe = e2e_phase(smi, tmp)
        torch.cuda.empty_cache()
        # ---- the options of the HDQ, the shadow rays and the camera trace
        opts = options_phase(smi, ctx, batch, n_fg)
        torch.cuda.empty_cache()
        # ---- the port over the cards under torchrun
        multi = multi_gpu_phase(smi, tmp, frame_ref, count)
    max_err = max(max_err, cli_err, mesh["max_err"], train["max_err"], relight["max_err"],
                  pipe["max_err"], opts["max_err"])

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
        "launches_train_relight": relight["launches"],
        "launches_e2e_prior_step": pipe["launches"],
        "launches_golden_512": gold["launches"],
        "launches_options": opts["launches_options"],
        "launches_premarch": opts["launches_premarch"],
        "launches_multi_gpu": multi["launches"],
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
        "mesh_prior_input_ms": mesh["prior"]["ms"],
        "mesh_prior_input_plain_ms": mesh["prior"]["plain_ms"],
        "mesh_prior_input_library_ms": mesh["prior"]["library_ms"],
        "mesh_prior_input_bound_ms": mesh["prior"]["bound_ms"],
        "train_input_ms": train["ms"],
        "train_input_plain_ms": train["plain_ms"],
        "train_input_library_ms": train["library_ms"],
        "train_input_bound_ms": train["bound_ms"],
        "train_relight_input_ms": relight["ms"],
        "train_relight_input_plain_ms": relight["plain_ms"],
        "train_relight_input_library_ms": relight["library_ms"],
        "train_relight_input_bound_ms": relight["bound_ms"],
        "e2e_prior_input_ms": pipe["ms"],
        "e2e_prior_input_plain_ms": pipe["plain_ms"],
        "e2e_prior_input_library_ms": pipe["library_ms"],
        "e2e_prior_input_bound_ms": pipe["bound_ms"],
        "e2e_prior_input_N": pipe["N"],
        "options_inputs": opts["inputs"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--multi-gpu"]:
        multi_gpu_main()
    elif sys.argv[1:]:
        sys.exit("usage: python3 chip_smoke.py [--multi-gpu]")
    else:
        main()
