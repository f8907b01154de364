"""The Hopper top-3 KNN kernel beside other builds of it, in one process.

    python -m relightableavatar_tpu_torch.eval.knn_bench [OTHER.cu ...]

Builds ``csrc/knn_top3.cu`` and each ``OTHER.cu`` (a source with the same C
interface, e.g. an earlier commit's kernel, into ``_build/other<i>/``) and
prints, for each build, ptxas' registers and spills and, from
``cuobjdump -sass``, the instructions of each instantiation's fast path (the
vertex-group loop with its slow path left out) per (point, vertex) pair.
Then renders the 512x512 exact frame of ``golden.frame_cfg()`` once,
recording its KNN inputs (``knn_cases.record_knn_inputs``), and on those and
on synthetic points at the frame's block sizes checks every build bit for
bit against the plain version and times the builds in turns
(``knn_cases.time_in_turns``), with the host's microseconds per call of the
launch wrapper beside.  Needs a CUDA device.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.eval.knn_cases import (FRAME_BLOCKS, frame_input_name,
                                                        record_knn_inputs, synthetic_points,
                                                        time_in_turns)
from relightableavatar_tpu_torch.ops import knn_cuda
from relightableavatar_tpu_torch.ops.knn import knn_top3_reference
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer

HOST_CALLS = 200        # launches timed on the host clock, with no sync between


def equals_plain(kernel, pts, verts) -> bool:
    d2, idx = kernel(pts, verts)
    rd2, ridx = knn_top3_reference(pts, verts)
    return torch.equal(d2, rd2) and torch.equal(idx, ridx)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` back-to-back
    calls: the launch path's cost while the device queue does not fill."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def ptxas_lines(log: str) -> list[str]:
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def _opcode(text: str) -> str:
    return (text.split()[1] if text.startswith("@") else text.split()[0]).split(".")[0]


def _branch_target(text: str):
    """Target address of a plain BRA (with or without a guard), else None."""
    m = re.match(r"(?:@!?U?P\w+\s+)?BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def fast_path_counts(sass: str) -> list[tuple[str, int, dict]]:
    """(kernel, instructions, opcode counts) of each kernel's fast path in
    ``cuobjdump -sass`` text: the shortest loop around a run of 4 LDS.128
    loads (the vertex walk), walked from its head to its branch back with
    every forward branch taken (each skips an insertion or the slow path)."""
    results = []
    for block in sass.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        code = [(int(a, 16), t.strip()) for a, t in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        addr = [a for a, _ in code]
        loops = []                  # (span, head, back) around each run of 4 LDS.128
        for i, (a, t) in enumerate(code):
            if "LDS.128" in t and sum("LDS.128" in u for _, u in code[i:i + 40]) >= 4:
                back = next((k for k in range(i, len(code))
                             if (_branch_target(code[k][1]) or 1 << 62) <= a), None)
                if back is not None:
                    head = addr.index(_branch_target(code[back][1]))
                    loops.append((back - head, head, back))
        if not loops:
            continue
        _, i, back = min(loops)
        ops: dict[str, int] = {}
        while True:
            ops[_opcode(code[i][1])] = ops.get(_opcode(code[i][1]), 0) + 1
            target = _branch_target(code[i][1])
            if i == back:
                break
            i = addr.index(target) if target is not None and target > addr[i] else i + 1
        results.append((name, sum(ops.values()), ops))
    return results


def sass_fast_paths(library: str) -> list[tuple[str, int, dict]]:
    """:func:`fast_path_counts` of ``cuobjdump -sass library``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return fast_path_counts(subprocess.run([tool, "-sass", library], capture_output=True,
                                           text=True, timeout=300, check=True).stdout)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("knn_bench needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)

    builds = {"this": knn_cuda.KNN_TOP3.load()}
    for i, other in enumerate(sys.argv[1:], 1):
        builds[f"other{i}"] = knn_cuda.KnnTop3Kernel(
            other, os.path.join(knn_cuda.BUILD_DIR, f"other{i}")).load()
    for label, kern in builds.items():
        print(f"[{label}] {kern.source}: built in {kern.build_seconds:.2f} s", flush=True)
        for line in ptxas_lines(kern.build_log):
            print(f"[{label}] ptxas: {line}", flush=True)
        for name, n, ops in sass_fast_paths(kern.path):
            R = int(re.search(r"ILi(\d+)E", name).group(1)) if "ILi" in name else 1
            print(f"[{label}] SASS fast path of {name[-40:]}: {n} instructions for "
                  f"4 vertices x {R} points = {n / (4 * R):.2f} a pair; "
                  + ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])),
                  flush=True)

    cfg = golden.frame_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cuda")
    renderer = SphereTracingRenderer(cfg, params, mcfg, device="cuda")
    batch, _ = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
    frame_inputs: dict = {}
    with record_knn_inputs(frame_inputs):
        renderer.render(batch)
    torch.cuda.synchronize()

    verts = ctx["pverts"]
    rng = np.random.default_rng(0)
    inputs = {f"frame P={frame_input_name(k, p)}": (p, v)
              for k, (p, v) in sorted(frame_inputs.items(), key=lambda kv: str(kv[0]))}
    inputs.update({f"synthetic P={P}": (synthetic_points(verts, P, rng), verts)
                   for P in FRAME_BLOCKS})
    for label, kern in builds.items():
        bad = [name for name, (p, v) in inputs.items() if not equals_plain(kern, p, v)]
        if bad:
            raise SystemExit(f"[{label}] differs from the plain version on {bad}")
    print(f"every build bit-identical to the plain version on all {len(inputs)} inputs",
          flush=True)
    for name, (p, v) in inputs.items():
        fns = {label: (lambda k=kern: k(p, v)) for label, kern in builds.items()}
        ms = time_in_turns(fns)
        us = {label: host_us(fn) for label, fn in fns.items()}
        print(f"{name}: " + ", ".join(f"{label} {ms[label]:.4f} ms ({us[label]:.1f} us host)"
                                      for label in builds)
              + "".join(f"; {label} / this {ms[label] / ms['this']:.2f}x"
                        for label in builds if label != "this"), flush=True)


if __name__ == "__main__":
    main()
