"""The yardstick's arithmetic on hand-made inputs: the frozen FLOP count and
KNN bound, the union of device intervals, the metric readers, the idle
gaps' attribution, the K1 launch recorder and the check for JAX modules.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import os
import sys
import types

import pytest
import torch

from portbench import flops, run, trace
from portbench.spec import PKG, load_module

H100 = flops.PEAKS["NVIDIA H100 80GB HBM3"]


def reader(name):
    return load_module(os.path.join(PKG, "metrics", name + ".py"), "_t_" + name.replace(".", "_")).read


def test_train_step_flops_is_shape_determined():
    per_sample = flops.train_step_flops(10, 8, 4, 156, 256, 1, 6890)
    assert per_sample == pytest.approx(1.456e7, rel=2e-3)
    step = flops.train_step_flops(10, 8, 4, 156, 256, 4 * 1024 * 128, 6890)
    assert step == per_sample * 4 * 1024 * 128
    assert step == pytest.approx(7.63e12, rel=2e-3)


def test_knn_bound():
    # 7 ops a pair at 67 TFLOP/s against 36 bytes a point and 12 a vertex at 3.35 TB/s
    assert flops.knn_bound_s(32768, 6890, H100) == pytest.approx(7 * 32768 * 6890 / 67e12)
    assert flops.knn_bound_s(32768, 6890, H100) * 1e3 == pytest.approx(0.0236, abs=1e-4)
    assert flops.knn_bound_s(10 ** 6, 3, H100) == pytest.approx((36e6 + 36) / 3.35e12)


def test_union_and_linear_flops():
    assert flops.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.6)]) == 4
    assert flops.union_s([]) == 0
    assert flops.linear_flops([(3, 4), (4, 2)]) == 2 * 12 + 2 * 8


def rec(**kw):
    base = dict(unit_s=0.5, units=2, busy_s=0.6, knn_shapes=[(32768, 6890)] * 4,
                knn_s=4 * 0.0707e-3, allreduce_s=0.004, flops_per_unit=7.63e12, peaks=H100)
    base.update(kw)
    return base


def test_readers():
    assert reader("device_idle_pct.train")(rec()) == pytest.approx(40.0)
    assert reader("device_idle_pct.frame")(rec(busy_s=0.0)) is None
    assert reader("train_mfu")(rec()) == pytest.approx(100 * 7.63e12 / 0.5 / 989e12)
    assert reader("frame_mfu")(rec()) == pytest.approx(100 * 7.63e12 / 0.5 / 67e12)
    assert reader("knn_roofline.train")(rec()) == pytest.approx(
        100 * flops.knn_bound_s(32768, 6890, H100) / 0.0707e-3)
    assert reader("knn_roofline.frame")(rec(knn_shapes=[])) is None
    assert reader("allreduce_ms.train")(rec()) == pytest.approx(2.0)
    assert reader("allreduce_ms.train")(rec(allreduce_s=0.0)) is None
    assert reader("train_mfu")(rec(peaks=None)) is None


def test_reference_counts_its_flops():
    """The reference's count: 2 x in x out a row of each linear layer, 8 a
    KNN pair, and the normals' gradient pass at the forward's FLOPs."""
    from portbench.reference import net as RN
    p = {"layers": [{"w": torch.ones(5, 4), "b": torch.zeros(4)},
                    {"w": torch.ones(4, 2), "b": torch.zeros(2)}]}
    x = torch.ones(3, 5)
    before = RN.COUNT.flops
    RN.mlp(p, x, "float32")
    assert RN.COUNT.flops == before and not RN.COUNT.on     # off: nothing counted
    with RN.COUNT as c:
        RN.mlp(p, x, "float32", skips=())
        RN.knn_top3(torch.zeros(6, 3), torch.zeros(7, 3))
    assert c.flops == 3 * flops.linear_flops([(5, 4), (4, 2)]) + 8 * 6 * 7
    assert not RN.COUNT.on


def test_gaps_are_named_by_the_running_host_op():
    dev = [(0, 10, "k1"), (30, 40, "k2"), (41, 50, "k3")]
    host = [(0, 100, "step"), (12, 29, "aten::nonzero"), (35, 45, "aten::mm")]
    gaps = trace._gaps(dev, host)
    assert gaps == pytest.approx({"aten::nonzero": 20e-6, "aten::mm": 1e-6})
    assert trace._gaps(dev, [(0, 5, "early")]) == pytest.approx({"(between host ops)": 21e-6})


def test_knn_recorder_counts_as_the_kernel(monkeypatch):
    from relightableavatar_tpu_torch.ops import knn_cuda

    class Fake:
        launches = 0

        def __call__(self, pts, verts):
            if pts.shape[0]:
                self.launches += 1
            return pts[:, :3], torch.zeros(pts.shape[0], 3, dtype=torch.int32)
    fake = Fake()
    monkeypatch.setattr(knn_cuda, "KNN_TOP3", fake)
    with trace.KnnRecorder() as rec_:
        knn_cuda.knn_top3_cuda(torch.zeros(5, 3), torch.zeros(7, 3))
        knn_cuda.knn_top3_cuda(torch.zeros(0, 3), torch.zeros(7, 3))
        knn_cuda.knn_top3_cuda(torch.zeros(9, 3), torch.zeros(4, 3))
        assert knn_cuda.KNN_TOP3.launches == 2
    assert rec_.shapes == [(5, 7), (9, 4)]
    assert knn_cuda.KNN_TOP3 is fake
    with pytest.raises(RuntimeError, match="recorder saw"):
        with trace.KnnRecorder():
            fake.launches += 1          # a launch the recorder did not see


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import relightableavatar_tpu_torch  # noqa: F401  begins with the JAX package's name
    assert run.forbidden_modules() == []
    for name in ("jax.numpy", "relightableavatar_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["flax", "jax", "relightableavatar_tpu"]


def test_reference_imports_nothing_of_the_port():
    import ast
    ref = os.path.join(PKG, "reference")
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, fn)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in ("relightableavatar_tpu_torch", *run.FORBIDDEN), (fn, n)


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    """One short run of ``anisdf.train`` through the command (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import subprocess
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "anisdf.train",
                          "--seed", "7", "--seconds", "2", "--trace", "0"], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
