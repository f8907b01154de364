"""The port's multi-GPU path on the cards, for ``chip_smoke.py``'s
``[multi-gpu]`` phase (in the manner of ``eval/train_check.py``):

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m relightableavatar_tpu_torch.eval.dist_check --ref DIR

Each rank joins the NCCL group (``config.maybe_init_distributed``; no
fallback to gloo, to the CPU or to one process), builds the fixture on its
card and

- renders the exact 512² frame (``golden.frame_cfg()``, fixture frame 0,
  camera 0) through the sharded ``SphereTracingRenderer``;
- runs the float32 reference stage-1 and stage-2 steps
  (``train_check.reference_step``) through the distributed ``Trainer``.

Rank 0 holds them to what one process on one card computes for the same
ranks (``DIR/frame.npz``, ``DIR/stage1.npz``, ``DIR/stage2.npz``): the
frame's maps to :func:`reference_frame` within FRAME_ATOL, ``spec_map`` at
the frame tests' PSNR bar (it divides by |ldot| + 1e-8: ROADMAP, "spec_map
parity"), each step's loss to :func:`reference_steps` within LOSS_REL and
every gradient within GRAD_REL of its largest entry.  Rank r of W renders
and trains on slice r of every ray block and chunk, so its float32
products have a W-th of the rows of one process's whole blocks, and
round otherwise where cuBLAS picks its kernels by shape: the references
are made with those shapes.  Where ``DIR/whole/`` holds the frame and
steps of whole blocks and chunks in one process, rank 0 also prints how
far the ranks are from them (``*_whole``), without a bar.  Every rank
fails unless the mesh path ran: a process group, the renderer's mesh of
the whole world, at least one gather in the frame and one gradient
all-reduce a step, K1 launched in the frame.  Each rank prints one line
``[dist-check] {json}``: world, backend, NCCL version, its card, seconds,
K1 launches and collectives of the frame and each step, and (rank 0) the
comparisons and the ones beyond their bars (``failures``): rank 0 goes on
through every collective after a failed comparison and fails at the end
with all of them.  Each rank also prints its progress to stderr, a hung
collective fails after COLLECTIVE_TIMEOUT_S, and a rank still running
after WATCHDOG_S prints every thread's stack and exits.  A rank that
raises prints its traceback and exits at once, without destroying the
process group (which could wait on ranks that wait in a collective for
this one), and torchrun ends the others.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import statistics
import sys
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from relightableavatar_tpu_torch.config import maybe_init_distributed
from relightableavatar_tpu_torch.eval import golden, train_check
from relightableavatar_tpu_torch.eval.knn_cases import cuda_ms
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.parallel.mesh import all_reduce_, gather_rays
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer

FRAME_ATOL = 1e-6
FRAME_MIN_PSNR_SPEC = 45.0      # tests/test_torch_frame.py's spec_map bar
LOSS_REL = 1e-5
GRAD_REL = 1e-4
STAGES = ("stage1", "stage2")
TIMED_REPS = 5
COLLECTIVE_TIMEOUT_S = 120
WATCHDOG_S = 240


def progress(msg: str, t0: float) -> None:
    rank = dist.get_rank() if dist.is_initialized() else "-"
    print(f"[dist-check rank {rank}] {msg} ({time.perf_counter() - t0:.1f} s)",
          file=sys.stderr, flush=True)


def median_ms(fn) -> float:
    """Median CUDA-event ms of TIMED_REPS calls of ``fn`` after one warm-up."""
    fn()
    return statistics.median(cuda_ms(fn, 1) for _ in range(TIMED_REPS))


def _fail(msg: str) -> None:
    raise RuntimeError(f"dist_check: {msg}")


def frame_maps(out) -> dict:
    """The per-ray maps of a render as numpy arrays."""
    return {k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}


def step_arrays(res: dict) -> dict:
    """A ``train_check.step_result`` as the arrays of an npz."""
    return {"loss": np.asarray(res["loss"]),
            **{f"grad/{k}": g.numpy() for k, g in res["grads"].items()}}


def compare_frame(maps: dict, ref: dict) -> tuple[dict, list]:
    """Per map: max |diff| (spec_map: its PSNR in dB), and a message for
    each map beyond its bar."""
    if set(maps) != set(ref):
        return {}, [f"frame maps {sorted(maps)} against the single-process {sorted(ref)}"]
    out, failures = {}, []
    for k, v in maps.items():
        if v.shape != ref[k].shape:
            failures.append(f"frame {k}: shape {v.shape} against {ref[k].shape}")
        elif k == "spec_map":
            out[k + "_db"] = golden.psnr(v, ref[k])
            if out[k + "_db"] < FRAME_MIN_PSNR_SPEC:
                failures.append(f"frame spec_map {out[k + '_db']:.2f} dB < "
                                f"{FRAME_MIN_PSNR_SPEC}")
        else:
            diff = np.abs(v - ref[k]).reshape(len(v), -1).max(axis=1) if v.size else v
            out[k] = float(diff.max()) if v.size else 0.0
            if out[k] > FRAME_ATOL:
                failures.append(f"frame {k}: max |diff| {out[k]:.3e} > {FRAME_ATOL} from one "
                                f"process on {int((diff > FRAME_ATOL).sum())} of {len(v)} rays")
    return out, failures


def compare_step(stage: str, got: dict, ref: dict) -> tuple[dict, list]:
    """Loss relative difference and the worst gradient's max |diff| / max
    |ref|, and a message when beyond LOSS_REL or GRAD_REL."""
    loss_rel = abs(float(got["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    grads = [k for k in ref if k.startswith("grad/")]
    if sorted(grads) != sorted(k for k in got if k.startswith("grad/")):
        return {}, [f"{stage}: other parameters than the single-process step's"]
    worst, worst_k = 0.0, None
    for k in grads:
        rel = float(np.abs(got[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
        if rel >= worst:
            worst, worst_k = rel, k[5:]
    failures = []
    if not (loss_rel <= LOSS_REL and worst <= GRAD_REL):
        failures.append(f"{stage}: loss rel {loss_rel:.3e} (bar {LOSS_REL}), worst gradient "
                        f"{worst_k} {worst:.3e} (bar {GRAD_REL}) from the single-process step")
    return dict(loss_rel=loss_rel, worst_grad_rel=worst, worst_grad=worst_k), failures


def reference_frame(world: int, device="cuda") -> dict:
    """The exact frame's maps in one process with blocks of ``ray_block /
    world`` rays: block i of these is slice i % world of the ranks' block
    i // world, rendered through the same operations on as many rows."""
    cfg = golden.frame_cfg()
    cfg.tpu.ray_block = int(cfg.tpu.ray_block) // world
    ctx, params, mcfg = golden.load_fixture(cfg, device=device)
    batch, _ = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
    return frame_maps(SphereTracingRenderer(cfg, params, mcfg, device=device).render(batch))


def emulate_ranks(world: int, fn) -> list:
    """``fn()``'s result on each of ``world`` ranks that are threads of this
    process, joined in torch's threaded process group: every rank runs the
    operations of a process of a ``world``-rank launch on the same shapes,
    and the group's collectives sum in rank order on the tensors' own
    device.  Raises the first exception a rank raised (the others leave
    their collectives)."""
    from torch.testing._internal.distributed import multi_threaded_pg as mtpg
    results, errors = [None] * world, []
    store = dist.HashStore()

    def rank(r: int) -> None:
        dist.init_process_group("threaded", rank=r, world_size=world, store=store)
        try:
            results[r] = fn()
        except BaseException as e:          # noqa: BLE001 (raised below)
            errors.append(e)
            mtpg.ProcessLocalGroup.exception_handle(e)
        finally:
            try:
                dist.destroy_process_group()
            except AttributeError:
                pass    # a threaded world without the `comms` list destroy reads

    mtpg._install_threaded_pg()
    # each thread registers its group's name in a registry of its own
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    try:
        threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        mtpg.ProcessLocalGroup.reset()
        mtpg._uninstall_threaded_pg()
    if errors:
        raise next((e for e in errors if not isinstance(e, SystemExit)), errors[0])
    return results


def reference_steps(world: int, device="cuda", record_dir: str | None = None) -> dict:
    """stage -> :func:`step_arrays` of the float32 reference step, as
    ``world`` ranks compute it: in this process alone for one, else over
    :func:`emulate_ranks` (every rank's result must be the same)."""
    def steps() -> dict:
        out = {}
        for stage in STAGES:
            trainer, batch = train_check.reference_step(stage, device, record_dir=record_dir)
            if (trainer.mesh.world if trainer.mesh is not None else 1) != world:
                _fail(f"the reference {stage} step took the mesh {trainer.mesh}")
            out[stage] = step_arrays(train_check.step_result(trainer, batch))
        return out

    if world == 1:
        return steps()
    ranks = emulate_ranks(world, steps)
    for r, res in enumerate(ranks[1:], 1):
        for stage, arrays in res.items():
            if any(not np.array_equal(v, ranks[0][stage][k]) for k, v in arrays.items()):
                _fail(f"emulated rank {r}'s {stage} step differs from rank 0's")
    return ranks[0]


def _whole(ref: str, name: str) -> dict | None:
    """``ref/whole/name``'s arrays, or None without it."""
    path = os.path.join(ref, "whole", name)
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", required=True,
                    help="folder of the single-process frame.npz, stage1.npz and stage2.npz")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        _fail("torch finds no CUDA device")
    if not maybe_init_distributed(device="cuda", timeout_s=COLLECTIVE_TIMEOUT_S):
        _fail("no torchrun environment: launch with python -m torch.distributed.run")
    progress("joined the group", t0)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        if dist.get_backend() != "nccl":
            _fail(f"backend {dist.get_backend()}, not nccl")
        knn_cuda.KNN_TOP3.load()
        dist.barrier()
        progress("K1 loaded, first barrier passed", t0)
        line = dict(rank=rank, world=world, backend=dist.get_backend(),
                    nccl=".".join(map(str, torch.cuda.nccl.version())),
                    device=torch.cuda.get_device_name(), local_rank=int(os.environ["LOCAL_RANK"]))

        cfg = golden.frame_cfg()
        ctx, params, mcfg = golden.load_fixture(cfg, device="cuda")
        batch, _ = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
        renderer = SphereTracingRenderer(cfg, params, mcfg, device="cuda")
        if renderer.mesh is None or renderer.mesh.world != world:
            _fail(f"the renderer's mesh is {renderer.mesh}, not the {world}-rank world")
        torch.cuda.synchronize()
        knn_cuda.KNN_TOP3.launches = 0
        t1 = time.perf_counter()
        out = renderer.render(batch)
        torch.cuda.synchronize()
        line["frame_s"] = time.perf_counter() - t1
        progress("frame rendered and gathered", t0)
        line["frame_launches"] = knn_cuda.KNN_TOP3.launches
        line["frame_collectives"] = dict(renderer.mesh.counts)
        if line["frame_launches"] == 0 or renderer.mesh.counts["gather"] == 0:
            _fail(f"the frame launched K1 {line['frame_launches']} times and gathered "
                  f"{renderer.mesh.counts['gather']} times")
        maps = frame_maps(out)
        # the gathers again, on buffers of one rank's share of each map
        blocks = -(-maps["acc_map"].shape[0] // renderer.block)
        share = [torch.empty((blocks * renderer.block // world,) + v.shape[1:],
                             dtype=torch.float32, device="cuda") for v in maps.values()]
        line["frame_gather_ms"] = median_ms(lambda: [gather_rays(renderer.mesh, t)
                                                     for t in share])
        line["frame_gather_bytes"] = sum(t.numel() * 4 for t in share) * world
        del share
        progress(f"frame gathers timed, {len(renderer.mesh.issued)} collectives", t0)
        failures = []          # rank 0's comparisons, failed at the end
        if rank == 0:
            with np.load(os.path.join(args.ref, "frame.npz")) as f:
                line["frame_max_abs"], bad = compare_frame(maps, {k: f[k] for k in f.files})
            failures += bad
            whole = _whole(args.ref, "frame.npz")
            if whole is not None:
                line["frame_whole_max_abs"] = compare_frame(maps, whole)[0]
            progress("frame compared", t0)
        del out, maps, renderer, params, ctx
        torch.cuda.empty_cache()

        for stage in STAGES:
            trainer, tbatch = train_check.reference_step(stage, "cuda")
            torch.cuda.synchronize()
            progress(f"{stage} trainer built, {len(trainer.mesh.issued)} collectives", t0)
            knn_cuda.KNN_TOP3.launches = 0
            reduces = trainer.mesh.counts["all_reduce"]
            t1 = time.perf_counter()
            res = train_check.step_result(trainer, tbatch)
            torch.cuda.synchronize()
            line[f"{stage}_s"] = time.perf_counter() - t1
            progress(f"{stage} stepped, {len(trainer.mesh.issued)} collectives", t0)
            line[f"{stage}_launches"] = knn_cuda.KNN_TOP3.launches
            line[f"{stage}_all_reduces"] = trainer.mesh.counts["all_reduce"] - reduces
            if line[f"{stage}_launches"] == 0 or line[f"{stage}_all_reduces"] == 0:
                _fail(f"{stage}: K1 launched {line[f'{stage}_launches']} times, "
                      f"{line[f'{stage}_all_reduces']} all-reduces")
            grads = [t.grad.clone() for _, t in trainer.named]
            line[f"{stage}_all_reduce_ms"] = median_ms(lambda: all_reduce_(trainer.mesh, grads))
            line[f"{stage}_all_reduce_bytes"] = sum(g.numel() * g.element_size() for g in grads)
            del grads
            progress(f"{stage} gradient all-reduce timed", t0)
            if rank == 0:
                with np.load(os.path.join(args.ref, f"{stage}.npz")) as f:
                    line[stage], bad = compare_step(stage, step_arrays(res),
                                                    {k: f[k] for k in f.files})
                failures += bad
                whole = _whole(args.ref, f"{stage}.npz")
                if whole is not None:
                    line[f"{stage}_whole"] = compare_step(stage, step_arrays(res), whole)[0]
            del trainer, tbatch, res
            torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        line["failures"] = failures
        print("[dist-check] " + json.dumps(line), flush=True)
        dist.barrier()
    except BaseException:
        # leave at once: destroy_process_group could wait on the ranks that
        # wait in a collective for this one (torchrun ends them)
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    if failures:
        _fail("; ".join(failures))


if __name__ == "__main__":
    main()
