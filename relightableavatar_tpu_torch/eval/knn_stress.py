"""Repeated exactness runs of the Hopper top-3 KNN kernel against its plain
version, to tell a rare wrong result from a steady one.

    python -m relightableavatar_tpu_torch.eval.knn_stress [--fresh N] [--reps R]

First ``--fresh`` processes each do what ``chip_smoke.py``'s [knn] phase
does in a new process: build, load the fixture's frame-0 cloud on the card,
and launch every case of ``knn_cases`` once against the plain version.  Then,
in this process: every case launched ``--reps`` times (a tenth as many for
cases of 10,000 points or more), 400 fresh synthetic inputs of 1 to 8192
points 5 times each, and the first 8 cases beside matrix products queued on
another stream.  Prints one JSON object: launches and disagreements of each
part, the fixture cloud's hash over 3 loads, and up to 20 disagreements with
their rows.  Exits 1 if any launch disagreed.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.eval.knn_cases import knn_cases, synthetic_points
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.ops.knn import knn_top3_reference

RANDOM_P = (1, 31, 33, 63, 65, 127, 129, 200, 257, 1000, 4099, 8192)


def fixture_cloud() -> torch.Tensor:
    ctx, _, _ = golden.load_fixture(golden.frame_cfg(), device="cuda")
    return ctx["pverts"]


def compare(name, pts, verts, reps, fails) -> int:
    """Launches the kernel ``reps`` times on one input; returns how many
    results differ from the plain version, recording the first 20."""
    d2r, ir = knn_top3_reference(pts, verts)
    bad = 0
    for rep in range(reps):
        d2k, ik = knn_cuda.knn_top3_cuda(pts, verts)
        if torch.equal(d2k, d2r) and torch.equal(ik, ir):
            continue
        bad += 1
        if len(fails) < 20:
            rows = ((ik != ir) | (d2k != d2r)).any(dim=1).nonzero().flatten()[:4]
            fails.append(dict(name=name, rep=rep, rows=rows.tolist(),
                              kernel_idx=ik[rows].tolist(), plain_idx=ir[rows].tolist(),
                              kernel_d2=d2k[rows].tolist(), plain_d2=d2r[rows].tolist()))
    return bad


def once() -> dict:
    """The smoke's [knn] phase: each case once, in this (new) process."""
    knn_cuda.KNN_TOP3.load()
    fails: list = []
    cases = knn_cases(fixture_cloud(), np.random.default_rng(0))
    bad = sum(compare(name, pts, vv, 1, fails) for name, pts, vv in cases)
    return dict(launches=len(cases), bad=bad, fails=fails)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fresh", type=int, default=10, help="new processes, each as [knn]")
    ap.add_argument("--reps", type=int, default=2000, help="launches of each case")
    ap.add_argument("--once", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on a GPU only")
    if args.once:
        print(json.dumps(once()))
        return
    t0 = time.perf_counter()
    out: dict = {"device": torch.cuda.get_device_name(0)}
    fresh = dict(processes=args.fresh, launches=0, bad=0, fails=[])
    for _ in range(args.fresh):
        proc = subprocess.run([sys.executable, "-m", __spec__.name, "--once"],
                              capture_output=True, text=True, timeout=300, env=os.environ)
        if proc.returncode != 0:
            sys.exit(f"a fresh process exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        fresh["launches"] += r["launches"]
        fresh["bad"] += r["bad"]
        fresh["fails"] += r["fails"][:20 - len(fresh["fails"])]
    out["fresh"] = fresh

    knn_cuda.KNN_TOP3.load()
    hashes = set()
    for _ in range(3):
        verts = fixture_cloud()
        hashes.add(hashlib.sha256(verts.cpu().numpy().tobytes()).hexdigest()[:16])
    out["cloud_hashes"] = sorted(hashes)
    fails: list = []
    cases = knn_cases(verts, np.random.default_rng(0))
    n = bad = 0
    for name, pts, vv in cases:
        reps = args.reps if pts.shape[0] < 10000 else max(1, args.reps // 10)
        n += reps
        bad += compare(name, pts, vv, reps, fails)
    out["cases"] = dict(launches=n, bad=bad)

    rng = np.random.default_rng(1)
    n = bad = 0
    for it in range(400):
        pts = synthetic_points(verts, int(rng.choice(RANDOM_P)), rng)
        n += 5
        bad += compare(f"random {it} P={pts.shape[0]}", pts, verts, 5, fails)
    out["random"] = dict(launches=n, bad=bad)

    side = torch.cuda.Stream()
    a = torch.randn(4096, 4096, device="cuda")
    n = bad = 0
    for _ in range(200):
        with torch.cuda.stream(side):
            for _ in range(3):
                a = (a @ a).clamp_(-1, 1)
        for name, pts, vv in cases[:8]:
            n += 1
            bad += compare(f"beside matmuls {name}", pts, vv, 1, fails)
    torch.cuda.synchronize()
    out["beside_other_work"] = dict(launches=n, bad=bad)
    out["fails"] = fails
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    total = fresh["bad"] + sum(out[k]["bad"] for k in ("cases", "random", "beside_other_work"))
    sys.exit(1 if total else 0)


if __name__ == "__main__":
    main()
