"""NCCL alone over the cards of one machine, to tell a fault of the machine
from one of the port: this module imports torch and the standard library
and nothing else of the port.

    python -m relightableavatar_tpu_torch.eval.nccl_probe [--nproc W] [--settings NAME ...]

For each NCCL environment setting of SETTINGS (all by default) the launcher
runs one ``python -m torch.distributed.run --standalone --nproc_per_node W``
of this module's rank mode in a session of its own, with ``NCCL_DEBUG=INFO``
(subsystems INIT, P2P, SHM, NET) written to one file a process, and kills
the session whole after ``--timeout`` seconds.  It prints one line a
setting, ``[nccl-probe] {json}``: whether every rank completed every
collective and found its result right (``ok``), the exit code, whether the
run was killed, the NCCL version, the collectives every rank completed, the
slowest rank's median ms of each, the transport NCCL reported for each
(sender -> receiver) pair ("P2P/IPC", "P2P/CUMEM", "SHM", "NET/Socket",
...), its NVLS lines and its first warnings.  The exit code is 1 unless
every setting was ok.

Each rank joins the group as ``config.maybe_init_distributed`` does (the
card LOCAL_RANK, ``init_process_group`` over ``env://`` with a timeout and
``device_id``), then issues the port's collectives at the port's sizes: a
barrier, an all_reduce of the stage-1 gradient (GRAD_BYTES of float32) and
one of a single float32 (a loss's global sum), an all_gather of the frame's
maps (MAPS_BYTES / W a rank) and one of a single map (MAP_BYTES / W) and a
broadcast from rank 0, each checked once and timed as the median of REPS runs (host clock
ending in a device sync); then the same four on a new group of all ranks
with a timeout of its own, OWN_TIMEOUT_S, each waited for with that
timeout.  After each collective a rank prints its line so far,
``[nccl-probe-rank] {json}``, so that a killed run still shows how far each
rank got.  ``--backend gloo`` runs the same on the CPU.  Only the ranks
import torch: the launcher starts in a fraction of a second.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

# the NCCL environment settings the launcher tries, each in a run of its own
SETTINGS = {
    "default": {},
    # NVLink SHARP needs CUDA multicast objects
    "nvls_off": {"NCCL_NVLS_ENABLE": "0"},
    # NCCL >= 2.19 passes cuMem handles between processes as file descriptors
    "cumem_off": {"NCCL_CUMEM_ENABLE": "0"},
    "p2p_off": {"NCCL_P2P_DISABLE": "1"},
    "shm_off": {"NCCL_SHM_DISABLE": "1"},
    "sockets_only": {"NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1"},
}
GRAD_BYTES = 5_661_336      # the stage-1 reference step's flat float32 gradient
MAPS_BYTES = 5_898_240      # the exact 512² frame's maps, gathered
MAP_BYTES = 196_608         # one of them, acc_map: 49,152 padded rays of float32
# the all_reduce of one float32, a loss's global sum (all_sum): 160 of the
# stage-1 step's 161 all-reduces; NCCL picks another algorithm and protocol
# for 4 bytes than for megabytes, and may connect other peers for it
OPS = ("barrier", "all_reduce", "all_reduce_scalar", "all_gather", "all_gather_map",
       "broadcast")
REPS = 5                    # timed runs of each collective after the checked one
GROUP_TIMEOUT_S = 45        # the default group's: under the launcher's kill
OWN_TIMEOUT_S = 60          # the second group's, and each of its waits
RUN_TIMEOUT_S = 60          # seconds a setting's torchrun may take
DEBUG_SUBSYS = "INIT,P2P,SHM,NET"
MODULE = "relightableavatar_tpu_torch.eval.nccl_probe"
_TRANSPORT = re.compile(r"(\d+)\[[^\]]*\] -> (\d+)\[[^\]]*\](?: \[\w+\])? via (\S+)")
_PREFIX = re.compile(r"^\S+ \[\d+\] (?:\S+ )?NCCL (?:INFO|WARN) ")


# ---------------------------------------------------------------- rank mode
def join(backend: str) -> torch.device:
    """Join the default group of a torchrun launch as
    ``config.maybe_init_distributed`` does; the device of the collectives."""
    import torch
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", 0))
    kw = {}
    dev = torch.device("cpu")
    if backend == "nccl":
        torch.cuda.set_device(local)
        dev = kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    return dev


def collectives(group, dev: torch.device, rank: int, world: int, wait_s) -> dict:
    """name -> (issue, check, bytes a rank sends): ``issue`` runs the
    collective on ``group`` and waits for it (``wait_s`` seconds at most, or
    the group's timeout); ``check`` says whether the last result is right."""
    import torch
    import torch.distributed as dist
    grad = torch.empty(GRAD_BYTES // 4, device=dev)
    scalar = torch.empty((), device=dev)
    share = torch.empty(MAPS_BYTES // (4 * world), device=dev)
    parts = [torch.empty_like(share) for _ in range(world)]
    map_share = torch.empty(MAP_BYTES // (4 * world), device=dev)
    map_parts = [torch.empty_like(map_share) for _ in range(world)]
    flag = torch.empty(1, device=dev)

    def wait(work):
        if wait_s is None:
            work.wait()
        else:
            work.wait(timeout=timedelta(seconds=wait_s))

    def reduce():
        grad.fill_(1.0)
        wait(dist.all_reduce(grad, group=group, async_op=True))

    def reduce_scalar():
        scalar.fill_(float(rank + 1))
        wait(dist.all_reduce(scalar, group=group, async_op=True))

    def gather(out, x):
        x.fill_(float(rank))
        wait(dist.all_gather(out, x, group=group, async_op=True))

    gathered = lambda out: all(bool((p == r).all()) for r, p in enumerate(out))

    def bcast():
        flag.fill_(float(rank + 1))
        wait(dist.broadcast(flag, src=0, group=group, async_op=True))
        wait(dist.broadcast(grad, src=0, group=group, async_op=True))

    return {
        "barrier": (lambda: wait(dist.barrier(group=group, async_op=True)), lambda: True, 0),
        "all_reduce": (reduce, lambda: bool((grad == world).all()), GRAD_BYTES),
        "all_reduce_scalar": (reduce_scalar, lambda: float(scalar) == world * (world + 1) / 2,
                              4),
        "all_gather": (lambda: gather(parts, share), lambda: gathered(parts), share.numel() * 4),
        "all_gather_map": (lambda: gather(map_parts, map_share), lambda: gathered(map_parts),
                           map_share.numel() * 4),
        "broadcast": (bcast, lambda: float(flag) == 1.0, GRAD_BYTES),
    }


def rank_main(setting: str, backend: str) -> int:
    import torch
    import torch.distributed as dist
    dev = join(backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    line = dict(rank=rank, world=world, backend=backend, setting=setting,
                nccl=".".join(map(str, torch.cuda.nccl.version())) if dev.type == "cuda" else None,
                device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                done=[], wrong=[], ms={}, bytes={})
    try:
        own = dist.new_group(list(range(world)), timeout=timedelta(seconds=OWN_TIMEOUT_S))
        rounds = (("", None, None), ("own/", own, OWN_TIMEOUT_S))
        for prefix, group, wait_s in rounds:
            for op, (issue, check, nbytes) in collectives(group, dev, rank, world,
                                                          wait_s).items():
                issue()
                sync()
                if not check():
                    line["wrong"].append(prefix + op)
                times = []
                for _ in range(REPS):
                    t0 = time.perf_counter()
                    issue()
                    sync()
                    times.append((time.perf_counter() - t0) * 1e3)
                line["done"].append(prefix + op)
                line["ms"][prefix + op] = statistics.median(times)
                line["bytes"][prefix + op] = nbytes
                # one write: the ranks share the pipe
                sys.stdout.write("[nccl-probe-rank] " + json.dumps(line) + "\n")
                sys.stdout.flush()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 1 if line["wrong"] else 0


# ---------------------------------------------------------------- launcher
def descendants(pid: int) -> list:
    """Every process below ``pid``, children before their own, read from
    /proc."""
    children: dict = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):        # gone meanwhile
            continue
        children.setdefault(ppid, []).append(int(name))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def kill_session(pid: int) -> None:
    """SIGKILL the session led by ``pid`` and every process below ``pid``:
    torchrun starts each worker in a session of its own, which a kill of
    torchrun's session alone would leave running."""
    for target, kill in [(pid, os.killpg)] + [(p, os.kill) for p in descendants(pid)]:
        try:
            kill(target, signal.SIGKILL)
        except ProcessLookupError:
            pass


def run_session(cmd: list, env: dict, timeout: float, cwd: str | None = None) -> dict:
    """Run ``cmd`` (in ``cwd``) in a session of its own; after ``timeout``
    seconds kill it and every process it started (:func:`kill_session`).
    Returns its exit code (None when killed), whether it was killed, its
    seconds and its output."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, start_new_session=True)
    killed = False
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        killed = True
        kill_session(proc.pid)
        out, err = proc.communicate()
    finally:
        kill_session(proc.pid)      # whatever of the session outlived its leader
    return dict(rc=None if killed else proc.returncode, killed=killed,
                seconds=time.perf_counter() - t0, out=out, err=err)


def read_nccl_logs(paths: list) -> dict:
    """The transports of each (sender -> receiver) pair, the NVLS lines and
    the first warnings of NCCL_DEBUG files."""
    transports: dict = {}
    nvls, warnings = [], []
    for path in sorted(paths):
        with open(path, errors="replace") as f:
            for line in f:
                for src, dst, how in _TRANSPORT.findall(line):
                    transports.setdefault(f"{src}->{dst}", set()).add(how)
                msg = _PREFIX.sub("", line.strip())
                if "NVLS" in line and msg not in nvls:
                    nvls.append(msg)
                if (" WARN " in line or "abort" in line) and msg not in warnings:
                    warnings.append(msg)
    return dict(transports={k: sorted(v) for k, v in sorted(transports.items())},
                nvls=nvls[:6], warnings=warnings[:8])


def rank_lines(text: str) -> dict:
    """The last ``[nccl-probe-rank]`` line of each rank in ``text``."""
    out = {}
    for m in re.finditer(r"\[nccl-probe-rank\] (\{.*\})", text):
        d = json.loads(m.group(1))
        out[d["rank"]] = d
    return out


def probe_setting(name: str, env_add: dict, world: int, backend: str, logs: str,
                  timeout: float) -> dict:
    """One torchrun of the rank mode under ``env_add``; its summary line."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, **env_add, "NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": DEBUG_SUBSYS,
           "NCCL_DEBUG_FILE": os.path.join(logs, f"{name}.%h.%p.log"),
           "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                                         if p)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), "-m", MODULE, "--as-rank", "--setting", name, "--backend", backend]
    run = run_session(cmd, env, timeout)
    ranks = rank_lines(run["out"])
    want = [p + op for p in ("", "own/") for op in OPS]
    done = {r: ranks[r]["done"] if r in ranks else [] for r in range(world)}
    completed = [op for op in want if all(op in d for d in done.values())]
    ok = (run["rc"] == 0 and completed == want
          and not any(d["wrong"] for d in ranks.values()))
    line = dict(setting=name, env=env_add, world=world, backend=backend, ok=ok, rc=run["rc"],
                killed=run["killed"], seconds=round(run["seconds"], 3),
                nccl=next((d["nccl"] for d in ranks.values()), None), completed=completed,
                done_by_rank={str(r): len(d) for r, d in done.items()},
                wrong=sorted({w for d in ranks.values() for w in d["wrong"]}),
                ms={op: max(d["ms"][op] for d in ranks.values() if op in d["ms"])
                    for op in completed},
                bytes={op: ranks[0]["bytes"][op] for op in completed if 0 in ranks},
                **read_nccl_logs(glob.glob(os.path.join(logs, f"{name}.*.log"))))
    if not ok:
        line["stderr_tail"] = run["err"][-1500:]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--as-rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--setting", default="default", help=argparse.SUPPRESS)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks (default: every card; 2 for gloo)")
    ap.add_argument("--settings", nargs="+", choices=list(SETTINGS), default=list(SETTINGS))
    ap.add_argument("--timeout", type=float, default=RUN_TIMEOUT_S,
                    help="seconds before a setting's run is killed whole")
    ap.add_argument("--logs", default=None,
                    help="folder to keep NCCL's debug files in (default: removed)")
    args = ap.parse_args(argv)
    if args.as_rank:
        return rank_main(args.setting, args.backend)
    world = args.nproc
    if world is None and args.backend == "gloo":
        world = 2
    elif world is None:
        import torch
        world = torch.cuda.device_count()
        if world == 0:
            print("nccl_probe: torch finds no CUDA device (use --backend gloo on the CPU)",
                  file=sys.stderr)
            return 2
    logs = args.logs or tempfile.mkdtemp(prefix="nccl_probe_")
    os.makedirs(logs, exist_ok=True)
    ok = True
    try:
        for name in args.settings:
            line = probe_setting(name, SETTINGS[name], world, args.backend, logs, args.timeout)
            print("[nccl-probe] " + json.dumps(line), flush=True)
            ok &= line["ok"]
    finally:
        if args.logs is None:
            shutil.rmtree(logs, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
