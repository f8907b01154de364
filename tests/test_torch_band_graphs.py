"""The HDQ band's CUDA graphs (``utils/row_graphs.py``, ``models/anisdf.py:_band``).

On the CPU: the bucket rule, the rules that send a call to the eager path,
the counters, and the gather / replay / slice path itself through a stand-in
for the card whose "graphs" run the function on the static buffers.  On the
card (``gpu``): replays against eager ``_band_sdf`` at the bucket edges,
weights updated in place and new weight tensors, no capture under the
profiler, and a relit 512² frame against the same frame run eagerly.  This
file imports no JAX; run the ``gpu`` tests on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_band_graphs.py``."""
import threading

import numpy as np
import pytest
import torch

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
from relightableavatar_tpu_torch.utils import profiling, row_graphs
from relightableavatar_tpu_torch.utils.row_graphs import CAP, STEP, RowGraphs, bucket

N_BUCKETS = CAP // STEP
EDGES = [1, 1023, 1024, 1025, 32768, 32769]
MAPS = {"rgb_map": 3e-5, "acc_map": 3e-5, "norm_map": 3e-5, "albedo_map": 1e-5,
        "roughness_map": 1e-5}     # relight.frame's limits on each map's mean gap


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


# ---------------------------------------------------------------- CPU
@pytest.mark.parametrize("n,b", [(0, 1024), (1, 1024), (1023, 1024), (1024, 1024),
                                 (1025, 2048), (32768, 32768), (32769, None)])
def test_bucket_rule(n, b):
    assert bucket(n) == b


class _FakeGraph:
    def __init__(self, fn, bufs, consts, out, b):
        self.replay = lambda: out[:b].copy_(fn([x[:b] for x in bufs], consts))


class FakeCard(RowGraphs):
    """Takes CPU tensors for the card's; its "graphs" run the function on
    the static buffers when replayed, so every step of a replay but the
    capture itself runs here.  ``fail`` makes the capture raise."""

    def __init__(self, fail: bool = False):
        super().__init__("hdq.band")
        self.fail, self.captured = fail, 0

    def _on_card(self, t):
        return True

    def _capture(self, fn, rows, consts):
        self.captured += 1
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        bufs = [r.new_zeros((self.cap, *r.shape[1:])) for r in rows]
        cbufs = {k: t.clone() for k, t in consts.items()}
        out = fn(bufs, cbufs).new_empty((self.cap, 1))
        graphs = {b: _FakeGraph(fn, bufs, cbufs, out, b) for b in range(STEP, self.cap + 1, STEP)}
        return row_graphs._Group(bufs, cbufs, out, graphs)


def row_fn(rows, c):
    """A row-wise stand-in for the band: one output column a row."""
    x, y = rows
    return (x * c["scale"] + y.sum(dim=1, keepdim=True))[:, :1]


def call(g, n, key="k", weights=(), scale=2.0, capturable=True, P=None):
    P = P or max(n, 8)
    gen = torch.Generator().manual_seed(n)
    x, y = torch.randn(P, 3, generator=gen), torch.randn(P, 2, generator=gen)
    sel = torch.randperm(P, generator=gen)[:n]
    consts = {"scale": torch.tensor(scale)}
    out = g.run(key, iter(weights), row_fn, (x, y), sel, consts, capturable=capturable)
    return out, row_fn((x[sel], y[sel]), consts)


def counters():
    return profiling.totals()["counters"]


@pytest.mark.parametrize("n", EDGES[:-1])
def test_replay_path_gathers_pads_and_slices(n):
    """At each bucket edge the (stand-in) replay equals the eager call, and
    the counters count one replay and the bucket's padding."""
    g = FakeCard()
    with torch.no_grad():
        call(g, 5)                  # captures outside the recorded window
        with profiling.collecting():
            out, ref = call(g, n)
    assert torch.equal(out, ref)
    c = counters()
    assert c["hdq.band_graph"] == 1 and c["hdq.band_pad_rows"] == bucket(n) - n
    assert "hdq.band_eager" not in c and "hdq.band_captures" not in c
    assert g.captured == 1


def test_constants_are_copied_each_call():
    g = FakeCard()
    with torch.no_grad():
        call(g, 100, scale=2.0)
        out, ref = call(g, 100, scale=-3.0)
    assert torch.equal(out, ref) and g.captured == 1


def test_eager_on_the_cpu():
    g = RowGraphs("hdq.band")
    with torch.no_grad(), profiling.collecting():
        out, _ = call(g, 100)
    assert out is None and counters() == {"hdq.band_eager": 1}
    assert g.eager_reason(None, torch.zeros(1), 100) == "not on CUDA"


@pytest.mark.parametrize("rule", ["grad", "over_cap", "recording", "thread", "not_capturable"])
def test_eager_rules(rule):
    """Each rule sends the call to the eager path before any capture."""
    g = FakeCard()
    result = {}

    def go():
        with torch.set_grad_enabled(rule == "grad"):
            result["out"] = call(g, CAP + 1 if rule == "over_cap" else 100,
                                 capturable=rule != "not_capturable")[0]

    with profiling.collecting():
        if rule == "thread":
            t = threading.Thread(target=go)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        else:
            go()
    assert result["out"] is None and g.captured == 0
    assert counters()["hdq.band_eager"] == 1


def test_recording_replays_what_was_captured():
    """No capture while spans record, but a key captured before replays."""
    g = FakeCard()
    with torch.no_grad():
        call(g, 10)
        with profiling.collecting():
            out, ref = call(g, 10)
            out2, _ = call(g, 10, key="other")
    assert torch.equal(out, ref) and out2 is None and g.captured == 1


def test_a_capture_that_raised_is_not_retried():
    g = FakeCard(fail=True)
    with torch.no_grad():
        first, _ = call(g, 10)
        with profiling.collecting():
            second, _ = call(g, 10)
        other, _ = call(g, 10, key="other")
    assert first is None and second is None and other is None
    assert g.captured == 2            # once for each key, not again
    assert counters() == {"hdq.band_eager": 1}


def test_new_weight_tensors_make_a_new_key():
    g = FakeCard()
    w1, w2 = torch.zeros(3), torch.zeros(3)
    with torch.no_grad():
        call(g, 10, weights=[w1])
        call(g, 10, weights=[w1])
        assert g.captured == 1
        call(g, 10, weights=[w2])
        assert g.captured == 2
        for k in range(row_graphs.MAX_KEYS + 1):
            call(g, 10, key=k)
    assert len(g._groups) == row_graphs.MAX_KEYS


def test_hdq_counts_its_band_calls_on_the_cpu():
    """On the CPU every HDQ query's band runs eagerly and is counted so;
    the band rows count the real rows only."""
    cfg = golden.fixture_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    rng = np.random.default_rng(5)
    center = ctx["Th"].numpy().reshape(3) + [0, 0, 0.9]
    x = torch.as_tensor(center + rng.normal(0, 0.25, (2000, 3)), dtype=torch.float32)
    with torch.no_grad(), profiling.collecting():
        a = anisdf.hdq_sdf(params, mcfg, ctx, x)
        b = anisdf.hdq_sdf(params, mcfg, ctx, x, hierarchical=False)
    c = counters()
    assert c["hdq.band_eager"] == 2 and "hdq.band_graph" not in c
    assert 2000 < c["hdq.band_rows"] < 4000     # every point of the second query
    assert a.shape == b.shape == (2000, 1)


def test_hdq_through_the_replay_path_equals_eager(monkeypatch):
    """``hdq_sdf`` through the stand-in replay equals the eager query: the
    band's rows, constants and output slice are wired right."""
    cfg = golden.fixture_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    rng = np.random.default_rng(6)
    center = ctx["Th"].numpy().reshape(3) + [0, 0, 0.9]
    x = torch.as_tensor(center + rng.normal(0, 0.25, (1500, 3)), dtype=torch.float32)
    with torch.no_grad():
        eager = anisdf.hdq_sdf(params, mcfg, ctx, x)
        fake = FakeCard()
        fake.cap = 2048
        monkeypatch.setattr(anisdf, "BAND_GRAPHS", fake)
        anisdf.hdq_sdf(params, mcfg, ctx, x[:700])         # captures
        with profiling.collecting():
            replayed = anisdf.hdq_sdf(params, mcfg, ctx, x)
    assert fake.captured == 1 and counters()["hdq.band_graph"] == 1
    assert torch.allclose(replayed, eager, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch finds none")
    cfg = golden.frame_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device="cuda")
    g = torch.Generator().manual_seed(7)
    pv = ctx["pverts"].cpu()
    P = CAP + 1
    pts = pv[torch.randint(0, pv.shape[0], (P,), generator=g)] + 0.03 * torch.randn(P, 3, generator=g)
    ppts = pts.cuda()
    d2, _, _, _, _, bw_k = anisdf._hdq_knn_stage(mcfg, ctx, ppts, mcfg.dist_th)
    return cfg, ctx, params, mcfg, (ppts, d2, bw_k)


def clone_params(params):
    return {k: clone_params(v) if isinstance(v, dict) else
            [clone_params(x) for x in v] if isinstance(v, list) else v.clone()
            for k, v in params.items()}


@pytest.mark.gpu
def test_replay_equals_eager_at_the_bucket_edges(card_scene, monkeypatch):
    _, ctx, params, mcfg, (ppts, d2, bw_k) = card_scene
    monkeypatch.setattr(anisdf, "BAND_GRAPHS", RowGraphs("hdq.band"))
    worst = {}
    with torch.no_grad():
        anisdf._band(params, mcfg, ctx, ppts, d2, bw_k, torch.arange(8, device="cuda"), False)
        for n in EDGES:
            sel = torch.randperm(ppts.shape[0], device="cuda")[:n]
            with profiling.collecting():
                got = anisdf._band(params, mcfg, ctx, ppts, d2, bw_k, sel, False).clone()
            ref = anisdf._band_sdf(params, mcfg, ctx, ppts[sel], d2[sel], bw_k[sel], False)
            worst[n] = float((got - ref).abs().max())
    c = counters()
    assert anisdf.BAND_GRAPHS.captures == N_BUCKETS
    assert c["hdq.band_graph"] == len(EDGES) - 1 and c["hdq.band_eager"] == 1    # 32769
    print("[band-graphs] worst gap replay vs eager by rows:", worst)
    assert max(worst.values()) <= 1e-6, worst


@pytest.mark.gpu
def test_weights_in_place_and_new_weights(card_scene, monkeypatch):
    _, ctx, params, mcfg, (ppts, d2, bw_k) = card_scene
    monkeypatch.setattr(anisdf, "BAND_GRAPHS", RowGraphs("hdq.band"))
    p = clone_params(params)
    sel = torch.arange(5000, device="cuda")
    with torch.no_grad():
        before = anisdf._band(p, mcfg, ctx, ppts, d2, bw_k, sel, False).clone()
        p["sdf"]["layers"][-1]["b"].add_(0.01)            # an optimiser's in-place step
        after = anisdf._band(p, mcfg, ctx, ppts, d2, bw_k, sel, False).clone()
        ref = anisdf._band_sdf(p, mcfg, ctx, ppts[sel], d2[sel], bw_k[sel], False)
        assert anisdf.BAND_GRAPHS.captures == N_BUCKETS
        assert float((after - ref).abs().max()) <= 1e-6
        assert float((after - before - 0.01).abs().max()) <= 1e-5
        q = clone_params(p)                                # a checkpoint loaded anew
        again = anisdf._band(q, mcfg, ctx, ppts, d2, bw_k, sel, False)
        assert anisdf.BAND_GRAPHS.captures == 2 * N_BUCKETS
        assert float((again - ref).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_no_capture_under_the_profiler(card_scene, monkeypatch):
    _, ctx, params, mcfg, (ppts, d2, bw_k) = card_scene
    monkeypatch.setattr(anisdf, "BAND_GRAPHS", RowGraphs("hdq.band"))
    sel = torch.arange(3000, device="cuda")
    with torch.no_grad():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            anisdf._band(params, mcfg, ctx, ppts, d2, bw_k, sel, False)
        assert anisdf.BAND_GRAPHS.captures == 0
        assert counters()["hdq.band_eager"] == 1
        anisdf._band(params, mcfg, ctx, ppts, d2, bw_k, sel, False)
        assert anisdf.BAND_GRAPHS.captures == N_BUCKETS


@pytest.mark.gpu
def test_frame_512_replayed_equals_eager(card_scene, monkeypatch):
    """The exact relit 512² frame with the band replayed against the same
    frame with every band eager (a cap of 0): each map's mean gap within
    the benchmark's limits; the second replayed frame captures nothing and
    runs no band eagerly."""
    cfg, ctx, params, mcfg, _ = card_scene
    renderer = SphereTracingRenderer(cfg, params, mcfg, device="cuda")
    batch, _ = golden.frame_batch(ctx, golden.FRAME_SIZE, golden.FRAME_SIZE)
    monkeypatch.setattr(anisdf, "BAND_GRAPHS", RowGraphs("hdq.band", cap=0))
    eager = renderer.render(batch)
    monkeypatch.setattr(anisdf, "BAND_GRAPHS", RowGraphs("hdq.band"))
    renderer.render(batch)
    captures = anisdf.BAND_GRAPHS.captures
    with profiling.collecting():
        replayed = renderer.render(batch)
    torch.cuda.synchronize()
    c = counters()
    assert captures == N_BUCKETS and anisdf.BAND_GRAPHS.captures == captures
    assert c["hdq.band_graph"] > 0 and "hdq.band_eager" not in c
    gaps = {k: float((replayed[k].float() - eager[k].float()).abs().mean()) for k in MAPS}
    print("[band-graphs] 512² frame, replayed vs eager mean gaps:", gaps)
    assert all(gaps[k] <= lim for k, lim in MAPS.items()), gaps
