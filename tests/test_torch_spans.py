"""The port's program spans and counters (``utils/profiling.py``): off they
record nothing; under ``torch.profiler`` each span is a ``record_function``
event on the profile's clock; the totals' self times, the HDQ band rows,
the nesting of a frame's and a step's spans, the collectives' spans over 2
gloo ranks, the benchmark's seven readers on the tiny traced cells, the
operator's ``spans_<n>.json``, and (``gpu``) ``host.sync`` against the
synchronising calls ``torch.cuda.set_sync_debug_mode`` reports."""
import copy
import json
import math
import os
import re
import socket
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from relightableavatar_tpu_torch.eval import golden, train_check
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops import lbs
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
from relightableavatar_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_STAGES = {"block.trace", "block.band", "block.visibility", "block.shade"}
READERS = {"trace_ms.frame": "tiny.frame", "shadow_ms.frame": "tiny.frame",
           "hdq_ms.frame": "tiny.frame", "host_syncs.frame": "tiny.frame",
           "band_rows.frame": "tiny.frame", "forward_ms.train": "tiny.train",
           "backward_ms.train": "tiny.train", "hdq_graph_pct.frame": "tiny.frame"}


@pytest.fixture(autouse=True)
def fresh_registry():
    """An empty registry, and 2 torch threads (the suite runs in parallel)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(threads)


def small_frame_cfg(device: str = "cpu"):
    """The exact frame at 6 surface and 2 shadow iterations in blocks of 256."""
    cfg = golden.frame_cfg()
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.tpu.ray_block = 256
    cfg.tpu.knn_impl = "pallas" if device == "cuda" else "auto"
    return cfg


@pytest.fixture(scope="module")
def frame_scene():
    cfg = small_frame_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    batch, _ = golden.frame_batch(ctx, 24, 24)
    return SphereTracingRenderer(cfg, params, mcfg, device="cpu"), batch


def tree(spans: list) -> set:
    """(parent name, child name) pairs of the recorded spans."""
    return {(spans[p][0] if p >= 0 else None, name) for name, _, _, p, _ in spans}


def test_off_records_nothing(monkeypatch):
    """Off (no profiler recording, no collecting()), a span is the shared
    no-op: no record_function, no sync, nothing kept; a profiler in its wait
    phase holds no span event either."""
    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert profiling.span("a") is profiling.span("b")
    assert not profiling.recording()
    with profiling.span("off.a"):
        profiling.count("off.n", 3)
        profiling.host_sync("site")
    assert profiling.totals() == {"spans": {}, "counters": {}, "units": 0}
    monkeypatch.undo()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # no warmup phase
        with profile(activities=[ProfilerActivity.CPU],
                     schedule=schedule(wait=1, warmup=0, active=1)) as prof:
            with profiling.span("off.a"):
                torch.ones(4).sum()
            prof.step()
            with profiling.span("on.b"):
                torch.ones(4).sum()
            prof.step()
    names = {e.name for e in prof.events()}
    assert "off.a" not in names and "on.b" in names
    assert set(profiling.totals()["spans"]) == {"on.b"}


def test_spans_are_profile_events_on_its_clock():
    """Each span is a record_function event of its name, and its stamps lie
    within 1 ms of the event's (``trace_start_ns`` plus its microseconds)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("train.step"):
            for _ in range(3):
                with profiling.span("step.forward"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                    time.sleep(0.002)
            with profiling.span("step.update"):
                time.sleep(0.003)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and e.device_type.name == "CPU":
            events.setdefault(e.name, []).append((t0 + e.time_range.start * 1e3,
                                                  t0 + e.time_range.end * 1e3))
    mine = profiling.spans()
    assert [s[0] for s in mine] == ["train.step"] + ["step.forward"] * 3 + ["step.update"]
    for name in ("train.step", "step.forward", "step.update"):
        got = sorted((s, e) for n, s, e, _, _ in mine if n == name)
        ref = sorted(events[name])
        assert len(got) == len(ref)
        for (s, e), (rs, re) in zip(got, ref):
            assert abs(s - rs) < 1e6 and abs(e - re) < 1e6
    assert {s[4] for s in mine} == {1} and profiling.totals()["units"] == 1


def test_self_time_is_duration_less_children():
    with profiling.collecting():
        with profiling.span("render.frame"):
            time.sleep(0.004)
            for _ in range(2):
                with profiling.span("render.block"):
                    time.sleep(0.002)
                    with profiling.span("block.trace"):
                        time.sleep(0.003)
    sp = profiling.spans()
    t = profiling.totals()["spans"]
    dur = lambda name: sum((e - s) / 1e9 for n, s, e, _, _ in sp if n == name)
    assert t["render.frame"]["self_s"] == pytest.approx(
        dur("render.frame") - dur("render.block"), abs=1e-9)
    assert t["render.block"]["self_s"] == pytest.approx(
        dur("render.block") - dur("block.trace"), abs=1e-9)
    assert t["block.trace"]["self_s"] == pytest.approx(dur("block.trace"), abs=1e-9)
    assert t["render.block"]["count"] == 2 and t["render.frame"]["total_s"] >= 0.014


def test_band_rows_count_in_band_points():
    """``hdq.band_rows`` is the number of query points whose nearest posed
    vertex lies within the band, computed here by brute force."""
    cfg = golden.fixture_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    rng = np.random.default_rng(5)
    center = ctx["Th"].numpy().reshape(3) + [0, 0, 0.9]
    x = torch.as_tensor(center + rng.normal(0, 0.25, (3000, 3)), dtype=torch.float32)
    with profiling.collecting():
        anisdf.hdq_sdf(params, mcfg, ctx, x)
    ppts = lbs.world_points_to_pose_points(x, ctx["R"], ctx["Th"]).double()
    d2 = torch.cdist(ppts, ctx["pverts"].double()).min(dim=1).values ** 2
    inside = int((d2 < mcfg.dist_th ** 2).sum())
    c = profiling.totals()["counters"]
    assert 0 < inside < 3000
    assert c["hdq.band_rows"] == inside and c["hdq.points"] == 3000
    assert c["host.sync.hdq_nonzero"] == 1


def test_frame_spans_nest(frame_scene):
    renderer, batch = frame_scene
    with profiling.collecting():
        renderer.render(batch)
    sp = profiling.spans()
    pairs = tree(sp)
    assert (None, "render.frame") in pairs and ("render.frame", "render.block") in pairs
    assert ("render.frame", "render.assemble") in pairs
    assert {c for p, c in pairs if p == "render.block"} == BLOCK_STAGES
    assert {p for p, c in pairs if c == "hdq.query"} == {"block.trace", "block.visibility"}
    assert {c for p, c in pairs if p == "hdq.query"} == {"hdq.knn", "hdq.band"}
    t = profiling.totals()
    blocks = renderer.last_frame.blocks_rendered
    assert t["units"] == 1 and t["spans"]["render.block"]["count"] == blocks
    assert all(t["spans"][s]["count"] == blocks for s in BLOCK_STAGES)
    c = t["counters"]
    assert c["host.sync"] == sum(v for k, v in c.items() if k.startswith("host.sync."))
    assert c["host.sync.hdq_nonzero"] == t["spans"]["hdq.query"]["count"]
    assert set(renderer.last_frame) == {"blocks", "blocks_rendered"}


def test_step_phases_a_chunk_and_frame():
    B, R, S = 2, 64, 8
    cfg = train_check.step_cfg(B, S, bf16=False, perturb=True)
    cfg.tpu.grad_sample_budget = B * (R // 2) * S         # two chunks
    trainer, batch = train_check.make_step(cfg, "cpu", R)
    with profiling.collecting():
        trainer.step(batch, 0)
    pairs = tree(profiling.spans())
    t = profiling.totals()["spans"]
    assert {c for p, c in pairs if p == "train.step"} == {
        "step.forward", "step.loss", "step.backward", "step.update"}
    assert all(t[s]["count"] == 2 * B for s in ("step.forward", "step.loss", "step.backward"))
    assert t["train.step"]["count"] == t["step.update"]["count"] == 1
    assert profiling.totals()["units"] == 1


def test_collective_spans_equal_mesh_counts_over_two_gloo_ranks(tmp_path):
    import torch.multiprocessing as mp
    import torch_spans_ranks as ranks
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(ranks.run_rank, args=(str(tmp_path), port, 2), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.time() + 150
    while not ctx.join(timeout=5):
        assert time.time() < deadline, "the gloo ranks did not finish"
    out = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    for rec in out:
        sp, mc = rec["spans"], rec["mesh_counts"]
        n = lambda name: sp.get(name, {}).get("count", 0)
        assert n("mesh.gather") == mc["gather"]
        assert n("mesh.all_reduce") + n("mesh.all_sum") == mc["all_reduce"]
        assert n("mesh.broadcast") == mc["broadcast"] > 0
        assert n("mesh.all_sum") > 0 and n("mesh.all_reduce") == 1
        assert n("step.grad_all_reduce") == 1
        assert rec["counters"]["mesh.bytes"] == rec["issued_bytes"] > 0
    assert out[0]["mesh_counts"] == out[1]["mesh_counts"]


def tiny_bench() -> dict:
    """BENCHMARK.json with the benchmark's throwaway tiny cells
    (``portbench/tests/data``) added, each metric of a real cell also
    listing the tiny cell of its kind."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"] += [{"name": "tiny.train", "config": "tiny-anisdf", "traffic": "tiny_b2",
                        "chips": 1, "why": "a throwaway stage-1 cell"},
                       {"name": "tiny.frame", "config": "tiny-relight", "traffic": "tiny_ring",
                        "chips": 1, "why": "a throwaway relit-frame cell"}]
    for m in b["end_to_end"] + b["per_layer"]:
        cells = m.get("workloads")
        if cells is not None:
            cells += [t for real, t in (("anisdf.train", "tiny.train"),
                                        ("relight.frame", "tiny.frame")) if real in cells]
    return b


@pytest.mark.parametrize("name", ["tiny.frame", "tiny.train"])
def test_traced_tiny_cells_read_the_seven_metrics(name):
    from portbench import run
    from portbench.spec import Cell
    cell = Cell(name, bench=copy.deepcopy(tiny_bench()),
                base=os.path.join(REPO, "portbench", "tests", "data"))
    res, lines = run.run_cell(cell, 2 ** 31 + 29, 0.01, True, torch.device("cpu"))
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    want = [k for k, c in READERS.items() if c == name]
    assert all(math.isfinite(m[k]) and m[k] >= 0 for k in want), m
    line = next(ln for ln in lines if re.match(r"\[\w+s\] \d+ in ", ln))
    n, window = re.match(r"\[\w+s\] (\d+) in ([0-9.e-]+) s", line).groups()
    unit_ms = 1e3 * float(window) / int(n)
    if name == "tiny.frame":
        assert m["trace_ms.frame"] + m["shadow_ms.frame"] <= unit_ms * (1 + 1e-9)
        assert m["hdq_ms.frame"] <= unit_ms and m["host_syncs.frame"] > 0
        assert m["band_rows.frame"] > 0
        assert m["hdq_graph_pct.frame"] == 0.0      # no band graphs on the CPU
    else:
        assert m["forward_ms.train"] + m["backward_ms.train"] <= unit_ms * (1 + 1e-9)
        assert m["forward_ms.train"] > 0 and m["backward_ms.train"] > 0


def test_readers_without_traced_units_return_none():
    from portbench.spec import Cell
    for metric in READERS:
        read = Cell("relight.frame").reader(metric)
        assert read({"unit_s": 1.0, "units": 1}) is None


def test_profiler_writes_spans_beside_its_trace(tmp_path):
    """A ``cfg.profiling`` window writes ``spans_<n>.json`` beside
    ``trace_<n>.json``: its steps' span totals, counters and idle gaps."""
    B, R, S = 1, 32, 8
    cfg = train_check.step_cfg(B, S, bf16=False, perturb=True, record_dir=str(tmp_path))
    cfg.profiling.enabled = True
    cfg.profiling.record_dir = str(tmp_path)
    cfg.profiling.skip_first, cfg.profiling.wait, cfg.profiling.warmup = 1, 0, 0
    cfg.profiling.active, cfg.profiling.repeat = 2, 1
    trainer, batch = train_check.make_step(cfg, "cpu", R)
    for _ in range(4):
        trainer.step(batch, 0)
        trainer.profiler.step()
    trainer.profiler.close()
    assert (tmp_path / "trace_0.json").exists()
    rec = json.load(open(tmp_path / "spans_0.json"))
    assert rec["units"] == 2 and rec["spans"]["train.step"]["count"] == 2
    assert rec["spans"]["step.backward"]["count"] == 2 * B
    assert rec["idle_gaps_s"] == {}         # no device events on the CPU
    assert profiling.totals()["spans"] == {}


def test_idle_gaps_go_to_the_innermost_span():
    class E:
        def __init__(self, name, s, e, dev, ann=False):
            self.name, self.is_user_annotation = name, ann
            self.time_range = type("T", (), {"start": s, "end": e})()
            self.device_type = dev
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [E("render.frame", 0, 100, CPU, True), E("block.trace", 10, 40, CPU, True),
              E("aten::mm", 12, 14, CPU), E("gpu annotation", 0, 100, CUDA, True),
              E("k1", 5, 10, CUDA), E("k2", 20, 30, CUDA), E("k3", 60, 70, CUDA),
              E("k4", 90, 95, CUDA)]
    prof = type("P", (), {"events": lambda self: events})()
    gaps = profiling.idle_gaps(prof, ["render.frame", "block.trace"])
    assert gaps == pytest.approx({"block.trace": 10e-6, "render.frame": 50e-6})


def cuda_frame():
    cfg = small_frame_cfg("cuda")
    ctx, params, mcfg = golden.load_fixture(cfg, device="cuda")
    renderer = SphereTracingRenderer(cfg, params, mcfg, device="cuda")
    batch, _ = golden.frame_batch(ctx, 32, 32)
    return lambda: renderer.render(batch)


def cuda_step():
    B, R, S = 2, 64, 8
    cfg = train_check.step_cfg(B, S, bf16=True, perturb=True)
    cfg.tpu.grad_sample_budget = B * (R // 2) * S         # two chunks
    trainer, batch = train_check.make_step(cfg, "cuda", R)
    return lambda: trainer.step(batch, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [cuda_frame, cuda_step], ids=["frame", "step"])
def test_host_syncs_equal_sync_debug_reports(make):
    """Over one small frame (and one small stage-1 step) on the card,
    ``host.sync`` equals the synchronising calls that
    ``torch.cuda.set_sync_debug_mode('warn')`` reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch finds none")
    run = make()
    run()                   # warm: K1's build, the first calls
    torch.cuda.synchronize()
    profiling.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.collecting():
                run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reported = [w for w in caught
                if str(w.message).startswith("called a synchronizing CUDA operation")]
    counted = profiling.totals()["counters"]
    sites = {}
    for w in reported:
        key = f"{os.path.basename(w.filename)}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    assert counted.get("host.sync", 0) == len(reported) > 0, (counted, sites)
