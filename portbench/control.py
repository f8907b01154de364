"""The readings that a cell's limits are set from, on the chip at the
cell's own size: the compared numbers of sound runs of the program, of the
control (the plain reference in the program's place, one precision below
the configuration's) and of the faults, seed by seed.

    python3 -m portbench.control --workload <cell> --seeds <n> ... --what program control ...

``--what`` takes:
- ``program``: the program as the timed path runs it (a training cell's
  three checked steps; a frame cell's set rendered once), against the
  reference;
- ``control``: the reference at ``control_precision`` (the configuration's
  ``control``: fp8 for the bf16 training steps, TF32 for the float32
  frames) against the reference in float32;
- ``half_batch`` (training): the reference with the second half of each
  batch left out, the mean taken over the rest;
- ``no_exchange`` (training over ranks): the program with the gradients'
  all-reduce left out;
- ``half_rays``, ``altered`` (frames): the program's maps with the second
  half of the rays zeroed, or with 0.05 added to the rgb of a tenth of them.
A step that returns its state unchanged reads 1 by construction (the
change's gap of a leaf that did not move) and needs no run.

Where the program runs on several cards, the readings run under
``torch.distributed.run`` with this module as each rank's program, and
rank 0 prints; the reference's readings (``control``, ``half_batch``) of
a training cell need one card.  Each reading is one line
``[reading] {json}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def no_exchange():
    """The trainer's gradient all-reduce left out."""
    from relightableavatar_tpu_torch.train import trainer
    orig = trainer.all_reduce_
    trainer.all_reduce_ = lambda mesh, tensors: None
    try:
        yield
    finally:
        trainer.all_reduce_ = orig


def corrupt(readings: list, how: str) -> list:
    """A frame cell's program maps with a fault planted."""
    out = []
    for j, maps in readings:
        m = {k: v.clone() for k, v in maps.items()}
        n = m["rgb_map"].shape[0]
        if how == "half_rays":
            for v in m.values():
                v[n // 2:] = 0
        else:
            m["rgb_map"][: n // 10] += 0.05
        out.append((j, m))
    return out


def render_sequence(entry) -> None:
    """A frame cell's program renders its sequence once (a training cell's
    checked steps ran in its set-up)."""
    if entry.unit == "frame":
        for _ in range(entry.granule):
            entry.run_one()


def readings(cell, seed: int, what: list, device, world: int, rank: int) -> list:
    """[(what, numbers, detail)] of one seed (rank 0; the others return [])."""
    import torch
    import torch.distributed as dist
    entry_mod = cell.entry()
    rows = []
    program = {}
    for kind in [w for w in what if w in ("program", "no_exchange")]:
        entry = entry_mod.Entry(cell, seed, device, ROOT, world)
        with no_exchange() if kind == "no_exchange" else contextlib.nullcontext():
            entry.setup()
            render_sequence(entry)
        program[kind] = entry
        entry.release()
    if world > 1:
        dist.barrier()
    if rank != 0:
        return rows
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = program.get("program") or program.get("no_exchange")
    if base is None:
        base = entry_mod.Entry(cell, seed, device, ROOT, world)
        if base.unit == "frame":       # the sample is of the program's frames
            base.setup()
            render_sequence(base)
            base.release()
    ref = base.reference()
    for kind in what:
        if kind in program:
            got = program[kind].program_readings()
        elif kind == "control":
            got = base.control(cell.config["control"])
        elif kind == "half_batch":
            got = base.reference(half_batch=True)
        elif kind in ("half_rays", "altered"):
            got = corrupt(base.program_readings(), kind)
        else:
            raise ValueError(f"unknown reading {kind!r}")
        detail: dict = {}
        rows.append((kind, entry_mod.compare(got, ref, detail), detail))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program", "control"])
    ap.add_argument("--ranks", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import fixed_caches
    from portbench.spec import Cell
    fixed_caches()
    cell = Cell(args.workload)
    import torch
    torch.set_num_threads(1)
    ranks = cell.chips if {"program", "no_exchange"} & set(args.what) else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < ranks:
        print(f"control: {args.workload} needs {ranks} CUDA card(s)", file=sys.stderr)
        return 2
    world, rank = 1, 0
    if ranks > 1 and not args.ranks:
        import subprocess
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(cell.chips), "-m", "portbench.control", "--ranks", "1",
               "--workload", args.workload, "--seeds", *map(str, args.seeds),
               "--what", *args.what]
        return subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1")).returncode
    if args.ranks:
        from relightableavatar_tpu_torch.config import maybe_init_distributed
        maybe_init_distributed("cuda")
        import torch.distributed as dist
        world, rank = dist.get_world_size(), dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    for seed in args.seeds:
        for kind, numbers, detail in readings(cell, seed, args.what, device, world, rank):
            print("[reading] " + json.dumps(dict(cell=args.workload, seed=seed, what=kind,
                                                 **numbers)), flush=True)
            print("[detail] " + json.dumps(detail), flush=True)
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
