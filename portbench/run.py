"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell's entry (set-up, ``setup_s``), then runs its
steps or frames back to back until the first one that ends after
``--seconds``: the rate is the window's time over the whole units in it,
each ending in a device synchronize.  With ``--trace 1`` a few more units
run under ``torch.profiler`` after the window.  Then the program's state
is freed, the plain reference (``portbench/reference``) recomputes what
the timed path produced, and each compared number is printed beside its
limit: as the last lines on standard error, and under ``checks``, the last
key of the result.  A traced run's per-layer metrics are read last, from
the profile and a unit's FLOPs (which a frame cell's reference counts).  The last line of standard output is the result, one JSON object.

A cell on more than one card starts its ranks itself through
``torch.distributed.run`` (NCCL); rank 0 writes the result, which this
process prints.  A run needs CUDA cards and fails without them; it fails
too if JAX, flax or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.time()    # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "relightableavatar_tpu")
RUN_LIMIT_S = 330       # a multi-card run's ranks are killed after this


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fixed_caches() -> None:
    """Every compile cache in fixed folders inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float = T0,
             world: int = 1, rank: int = 0) -> tuple:
    """One run of ``cell`` on ``device``: (result dict, check lines), or
    (None, []) on a rank other than 0."""
    import torch
    import torch.distributed as dist

    from portbench import flops, trace as tr

    entry_mod = cell.entry()
    entry = entry_mod.Entry(cell, seed, device, ROOT, world)
    entry.setup()
    sync(device)
    setup_s = time.time() - t0

    flag = torch.zeros(1, device=device)
    n, tw = 0, time.perf_counter()
    walls = []
    while True:
        t = time.perf_counter()
        entry.run_one()
        sync(device)
        walls.append(time.perf_counter() - t)
        n += 1
        done = time.perf_counter() - tw >= seconds and n % entry.granule == 0
        if world > 1:
            flag.fill_(float(done))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            done = bool(flag.item())
        if done:
            break
    window_s = time.perf_counter() - tw
    unit_s = window_s / n
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    leftover = forbidden_modules()

    values = {"setup_s": setup_s, cell.workload["unit_metric"]: unit_s}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": world, "memory_peak_bytes": int(peak)}
    breakdown = None
    recs = []
    rank_lines = []
    if trace:
        units = int(cell.workload["trace_units"])
        prof, win, shapes = tr.profile_units(entry.run_one, units, device)
        rec = tr.read_profile(prof)
        del prof
        rec.update(units=units, window_s=win, unit_s=unit_s, knn_shapes=shapes,
                   peaks=flops.PEAKS.get(dev_info["kind"]), peak=int(peak))
        if world > 1:
            recs = [None] * world
            dist.all_gather_object(recs, rec)
        else:
            recs = [rec]
        dev_info["busy_s"] = sum(r["busy_s"] for r in recs) / world
        dev_info["window_s"] = win
        dev_info["memory_peak_bytes"] = max(r["peak"] for r in recs)
        breakdown = {"device_ops": tr.top(rec["device_s"]), "idle_gaps": tr.top(rec["gaps_s"])}
        rank_lines.append(f"[trace] {rec['device_events']} device events in "
                          f"{rec['units']} {entry.unit}s; K1 launches {len(shapes)}")
    elif world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, int(peak))
        dev_info["memory_peak_bytes"] = max(gathered)
    if world > 1:
        dist.destroy_process_group()
    attempted = n
    entry.release()
    if rank != 0:
        return None, []
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = entry.program_readings()
    ref = entry.reference()
    detail: dict = {}
    numbers = entry_mod.compare(prog, ref, detail)
    if trace:
        per_unit = entry.unit_flops()       # a rank's; the ranks' shares are equal
        metrics = {}
        for m in cell.per_layer:
            read = cell.reader(m["name"])
            vals = [v for v in (read(dict(r, flops_per_unit=per_unit)) for r in recs)
                    if v is not None]
            if world > 1:
                rank_lines.append(f"[ranks] {m['name']}: " + ", ".join(map(repr, vals)))
            if vals:
                metrics[m["name"]] = {"value": sum(vals) / len(vals), "unit": m["unit"]}
    limits = cell.limits()
    checks = {k: {"value": v if math.isfinite(v) else repr(v), "limit": limits[k]}
              for k, v in numbers.items()}
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if leftover:
        result["forbidden_modules"] = leftover
    result["checks"] = checks
    q = statistics.quantiles(walls, n=4) if len(walls) > 1 else walls * 3
    lines = rank_lines + [
        f"[{entry.unit}s] {n} in {window_s!r} s; setup {setup_s!r} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in entry.phases.items()) + ")",
        f"[walls] median {q[1]:.4f} quartiles {q[0]:.4f} {q[2]:.4f} min {min(walls):.4f} "
        f"max {max(walls):.4f}: " + " ".join(f"{w:.3f}" for w in walls),
        "[detail] " + json.dumps(detail)]
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines


def launch_ranks(args, chips: int) -> dict:
    """Run the cell's ranks under ``torch.distributed.run`` in a session of
    their own (killed whole past :data:`RUN_LIMIT_S`); rank 0's record."""
    fd, out = tempfile.mkstemp(prefix="portbench_rank0_", suffix=".json")
    os.close(fd)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(chips), "-m", "portbench.run",
           "--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace), "--rank-out", out]
    env = dict(os.environ, PORTBENCH_T0=repr(T0))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=max(RUN_LIMIT_S - (time.time() - T0), 10))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise SystemExit(f"the ranks did not end within {RUN_LIMIT_S} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    try:
        with open(out) as f:
            record = json.load(f) if rc == 0 else None
    finally:
        os.unlink(out)
    if record is None:
        raise SystemExit(f"the ranks failed (torch.distributed.run exit {rc})")
    return record


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    fixed_caches()
    from portbench.spec import Cell
    cell = Cell(args.workload)
    import torch
    torch.set_num_threads(1)        # one launching thread, no idle pool beside it
    need = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA card(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if args.rank_out is not None:
        from relightableavatar_tpu_torch.config import maybe_init_distributed
        maybe_init_distributed("cuda")
        import torch.distributed as dist
        rank, world = dist.get_rank(), dist.get_world_size()
        device = torch.device("cuda", torch.cuda.current_device())
        t0 = float(os.environ.get("PORTBENCH_T0", T0))
        result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t0,
                                 world, rank)
        if rank == 0:
            with open(args.rank_out, "w") as f:
                json.dump({"result": result, "lines": lines}, f)
        return 0
    if need > 1:
        record = launch_ranks(args, need)
        result, lines = record["result"], record["lines"]
    else:
        result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0))
    found = sorted(set(forbidden_modules()) | set(result.pop("forbidden_modules", [])))
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
