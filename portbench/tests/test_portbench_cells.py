"""The benchmark's files resolve by name, and a throwaway cell added as new
files runs on the CPU and is judged: sound runs are correct, the control
and every fault the cell can have are not.

    python -m pytest portbench/tests -q

The cells here are small copies (``tests/data``) of the real ones; their
limits were set from CPU readings of the same comparisons (the
``readings`` key of each workload file)."""
from __future__ import annotations

import copy
import json
import os
import re

import pytest
import torch

from portbench import control, run
from portbench.spec import PKG, ROOT, Cell

DATA = os.path.join(os.path.dirname(__file__), "data")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
TINY = [{"name": "tiny.train", "config": "tiny-anisdf", "traffic": "tiny_b2", "chips": 1,
         "why": "a throwaway stage-1 cell"},
        {"name": "tiny.frame", "config": "tiny-relight", "traffic": "tiny_ring", "chips": 1,
         "why": "a throwaway relit-frame cell"}]
SEED = 2 ** 31 + 17


def tiny_bench() -> dict:
    """BENCHMARK.json with the throwaway cells added as entries: each metric
    that lists its cells gets the tiny cell of its kind."""
    b = copy.deepcopy(BENCH)
    b["workloads"] += TINY
    for m in b["end_to_end"] + b["per_layer"]:
        cells = m.get("workloads")
        if cells is not None:
            if "anisdf.train" in cells:
                cells.append("tiny.train")
            if "relight.frame" in cells:
                cells.append("tiny.frame")
    return b


def tiny(name: str) -> Cell:
    return Cell(name, bench=tiny_bench(), base=DATA)


def dp4_bench() -> dict:
    """BENCHMARK.json with the four-card cell whose files ``portbench`` keeps
    for a later PR (``workloads/anisdf.train_dp4.json``, ``traffic/anisdf_b16.json``,
    ``metrics/allreduce_ms.train.py``) added as entries."""
    b = copy.deepcopy(BENCH)
    b["workloads"].append({"name": "anisdf.train_dp4", "config": "anisdf-base",
                           "traffic": "anisdf_b16", "chips": 4, "why": "four-card steps"})
    b["per_layer"].append({"name": "allreduce_ms.train", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "collectives",
                           "moves": "train_step_s", "workloads": ["anisdf.train_dp4"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "anisdf.train" in m.get("workloads", []):
            m["workloads"].append("anisdf.train_dp4")
    return b


def test_kept_four_card_cell_resolves():
    cell = Cell("anisdf.train_dp4", bench=dp4_bench())
    assert cell.chips == 4 and cell.make_cfg().tpu.grad_sample_budget == 524288
    assert {m["name"] for m in cell.per_layer} >= {"allreduce_ms.train", "train_mfu"}
    assert all(callable(cell.reader(m["name"])) for m in cell.per_layer)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(name):
    cell = Cell(name)
    cfg = cell.make_cfg()
    assert cfg.n_samples == cell.config["cfg"].get("n_samples", cfg.n_samples)
    assert hasattr(cell.entry(), "Entry") and hasattr(cell.entry(), "compare")
    assert hasattr(cell.generator(), "Traffic")
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert cell.end_to_end and cell.per_layer
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", cell.workload["unit_metric"]}
    assert cell.config["control"] in ("fp8", "tf32")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == json.load(open(os.path.join(ROOT, c["file"])))["reduced"]
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves
        for cell in m["workloads"]:
            e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert cell in e2e.get("workloads", [cell])
    assert all(p == "portbench" for p in BENCH["paths"])


def test_traffic_is_the_seed_s():
    cell = Cell("anisdf.train")
    a = cell.generator().Traffic(cell.traffic, SEED, ROOT).batch(1)
    b = cell.generator().Traffic(cell.traffic, SEED, ROOT).batch(1)
    c = cell.generator().Traffic(cell.traffic, SEED + 1, ROOT).batch(1)
    assert all((x["ray_d"] == y["ray_d"]).all() for x, y in zip(a, b))
    assert not all((x["ray_d"] == y["ray_d"]).all() for x, y in zip(a, c))
    dp = Cell("anisdf.train_dp4", bench=dp4_bench())
    big = dp.generator().Traffic(dp.traffic, SEED, ROOT).batch(0)
    small = [f for k in range(4) for f in cell.generator().Traffic(cell.traffic, SEED,
                                                                      ROOT).batch(k)]
    assert all((x["rgb"] == y["rgb"]).all() for x, y in zip(big, small))
    fr = Cell("relight.frame")
    t = fr.generator().Traffic(fr.traffic, SEED, ROOT)
    assert sorted(t.order) == list(range(len(fr.traffic["poses"])))
    assert t.poses == fr.generator().Traffic(fr.traffic, SEED + 1, ROOT).poses
    assert t.frame(0)["n_pixels"] > 10000


def run_tiny(name: str, trace: bool = False):
    return run.run_cell(tiny(name), SEED, 0.01, trace, torch.device("cpu"))[0]


@pytest.mark.parametrize("name", ["tiny.train", "tiny.frame"])
def test_sound_run_is_correct(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"setup_s", tiny(name).workload["unit_metric"]}


def test_traced_frame_reads_the_reference_s_flops(monkeypatch):
    """A traced frame run reads ``frame_mfu`` from the FLOPs the reference
    counts over the whole set, after the check; the program is not wrapped."""
    from portbench import flops
    H100 = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    monkeypatch.setitem(flops.PEAKS, "cpu", H100)
    got = {}
    entry_mod = tiny("tiny.frame").entry()
    unit_flops = entry_mod.Entry.unit_flops

    def spy(self):
        got["flops"] = unit_flops(self)
        got["counted"] = dict(self.ref_flops)
        return got["flops"]
    monkeypatch.setattr(entry_mod.Entry, "unit_flops", spy)
    cell = tiny("tiny.frame")
    monkeypatch.setattr(cell, "entry", lambda: entry_mod)
    res, lines = run.run_cell(cell, SEED, 0.01, True, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert sorted(got["counted"]) == list(range(len(cell.traffic["poses"])))
    assert all(v > 0 for v in got["counted"].values())
    assert got["flops"] == pytest.approx(sum(got["counted"].values()) / len(got["counted"]))
    line = next(ln for ln in lines if ln.startswith("[frames]"))
    n, window = re.match(r"\[frames\] (\d+) in ([0-9.e-]+) s", line).groups()
    assert res["metrics"]["frame_mfu"]["value"] == pytest.approx(
        100 * got["flops"] / (float(window) / int(n)) / H100["fp32"])
    assert "knn_roofline.frame" not in res["metrics"]       # no K1 on the CPU: left out
    assert res["device"]["busy_s"] == 0 and "breakdown" in res


def test_state_unchanged_fails(monkeypatch):
    from relightableavatar_tpu_torch.train.optimizer import TrainOptimizer
    monkeypatch.setattr(TrainOptimizer, "step", lambda self: None)
    res = run_tiny("tiny.train")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_fails(monkeypatch):
    from relightableavatar_tpu_torch.train.trainer import Trainer
    step = Trainer.step

    def half(self, batch, it, jitter_noise=None):
        B = batch.rgb.shape[0] // 2
        cut = type(batch)({k: (v[:B] if k != "ctx" else v[:B]) for k, v in batch.items()})
        return step(self, cut, it, jitter_noise)
    monkeypatch.setattr(Trainer, "step", half)
    assert not run_tiny("tiny.train")["correct"]


@pytest.mark.parametrize("how", ["half_rays", "altered"])
def test_frame_faults_fail(monkeypatch, how):
    from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
    render = SphereTracingRenderer.render

    def broken(self, batch):
        out = render(self, batch)
        maps = control.corrupt([(0, {k: out[k] for k in ("rgb_map", "acc_map")})], how)[0][1]
        out.update(maps)
        return out
    monkeypatch.setattr(SphereTracingRenderer, "render", broken)
    assert not run_tiny("tiny.frame")["correct"]


@pytest.mark.parametrize("name", ["tiny.train", "tiny.frame"])
def test_control_fails(name):
    cell = tiny(name)
    rows = {k: n for k, n, _ in control.readings(cell, SEED, ["program", "control"],
                                                  torch.device("cpu"), 1, 0)}
    limits = cell.limits()
    assert all(v <= limits[k] for k, v in rows["program"].items()), rows["program"]
    assert any(v > limits[k] for k, v in rows["control"].items()), rows["control"]


def test_new_cell_needs_only_new_files():
    """The throwaway cells are BENCHMARK.json entries plus files under
    ``tests/data``; the harness's own files hold nothing of them."""
    for name in ("tiny.train", "tiny.frame"):
        cell = tiny(name)
        assert not os.path.exists(os.path.join(PKG, "workloads", name + ".json"))
        assert cell.workload["limits"]


def _rank(rank: int, world: int, port: int, out: str, broken: bool) -> None:
    """One gloo rank of the throwaway training cell (``torch.multiprocessing``
    spawns it); rank 0 writes whether the run was correct and its metrics.
    The sound run is traced, with the CPU given the H100's peaks."""
    import contextlib
    import torch.distributed as dist
    from portbench import flops
    flops.PEAKS["cpu"] = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    dist.init_process_group("gloo", rank=rank, world_size=world)
    with control.no_exchange() if broken else contextlib.nullcontext():
        res, _ = run.run_cell(tiny("tiny.train"), SEED, 0.01, not broken, torch.device("cpu"),
                              world=world, rank=rank)
    if rank == 0:
        with open(out, "w") as f:
            json.dump([res["correct"], sorted(res["metrics"])], f)


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "no_exchange"])
def test_exchange_left_out_fails(tmp_path, broken):
    """Two CPU ranks over gloo: the data-parallel step is correct, and with
    the gradients' all-reduce left out it is not; the sound run's traced
    metrics are gathered from both ranks."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "correct.json")
    mp.spawn(_rank, args=(2, port, out, broken), nprocs=2, join=True)
    correct, metrics = json.load(open(out))
    assert correct is (not broken)
    if not broken:
        assert "train_mfu" in metrics
