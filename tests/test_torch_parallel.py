"""The port's multi-GPU paths (``parallel/mesh.py``, ``config.maybe_init_distributed``,
the node-strided ``TrainSampler``, the ray-sharded renderer and trainer,
the rank-0 checkpoints) on the CPU: in one process, then over 2 gloo ranks
against the single-process port and the JAX package's single-device
results, as ``tests/test_multichip.py`` holds the JAX package's sharded
results to its single-device ones.

The ranks are spawned processes (``torch.multiprocessing``, spawn method)
that run ``tests/torch_parallel_ranks.py`` and import no jax: the JAX
results and the single-process port's are made here, and the ranks get their
inputs and give their results as ``.npz`` files.  Each spawn joins
``127.0.0.1`` at a free port (tests in other workers do not collide), has
SPAWN_TIMEOUT_S seconds in all and a 60 s collective timeout, and runs 2
torch threads a rank.  Three spawns of 2 ranks, each a module fixture shared by its
tests: (a) the mesh helpers, the 16x16 fixture frame of 2 ray blocks and the
two-light sweep; (b) the stage-1 step in float64 (a batch, the same batch
in 2 chunks, a batch whose rank-1 shard has no masked lane); (c) the
stage-2 step in float64, a rank-0 checkpoint and its resume.  Two spawns of
4 ranks: (d) as (a), with shards that hold no hit; (e) (b) and (c) in one
spawn, with shards that hold no masked lane and no shadow ray.  Every rank
of every spawn issues the same sequence of collectives (op, element count,
dtype): a collective one rank skipped would hang the others on NCCL.  And
(f): (b) over 4 ranks that are threads of this process
(``dist_check.emulate_ranks``, the stand-in for W cards that
``chip_smoke.py``'s [multi-gpu] computes its step references with).

Bars: the sharded maps within SHARD_ATOL of the single-process port's (the
same arithmetic on fewer rows), and the JAX package's at the bars of
``tests/test_torch_frame.py`` and ``tests/test_torch_novel_light.py``; the
stage-1 step within STEP1_REL of W = 1 and (the empty shard) of JAX (loss,
every gradient, every parameter after the clipped Adam step, max |diff| /
max |ref|; ``tests/test_torch_train.py`` measured 2e-13 and 6e-12 for W = 1
against JAX); the stage-2 step within STEP2_REL
(``tests/test_torch_relight_train.py``).
"""
import os
import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_relight_train as rt
import test_torch_train as tt
import torch_parallel_ranks as ranks
from jax_fixture_scene import few_torch_threads, jax_cfg, jax_scene  # noqa: F401 (fixture)
from test_torch_mesh import exact_knn
from relightableavatar_tpu.data.datasets import TrainSampler as JTrainSampler
from relightableavatar_tpu.data.datasets import load_lighting as j_load_lighting
from relightableavatar_tpu.models import anisdf as j_anisdf
from relightableavatar_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple
from relightableavatar_tpu.renderer import orchestrate as jorc
from relightableavatar_tpu.train.checkpoints import _flatten
from relightableavatar_tpu.utils.dotdict import dotdict as jdotdict
from relightableavatar_tpu_torch.config import default_cfg, dist_env, maybe_init_distributed
from relightableavatar_tpu_torch.data import datasets
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.parallel import mesh as pm
from relightableavatar_tpu_torch.renderer.orchestrate import (NovelLightRenderer,
                                                             SphereTracingRenderer)
from relightableavatar_tpu_torch.train.trainer import Trainer, _volume_forward

SPAWN_TIMEOUT_S = 120
STEPS4_TIMEOUT_S = 240      # (e): both stages' steps in one spawn of 4 ranks
SHARD_ATOL = 1e-6
MIN_PSNR = 100.0            # test_torch_frame.py, test_torch_novel_light.py
MIN_PSNR_SPEC = 45.0
HIT_ONLY = ('lvis_map', 'ldot_map')
STEP1_REL = 1e-11
STEP2_REL = 1e-6
W = ranks.WORLD


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(case: str, folder, world: int = W, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``case`` on ``world`` gloo ranks; their result dicts, rank by
    rank.  Kills the ranks and fails after ``timeout`` seconds."""
    ctx = mp.start_processes(ranks.run_rank, args=(case, str(folder), _free_port(), world),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{case}: the ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    print(f"{case}: {world} ranks in {time.monotonic() - t0:.1f} s")
    out = []
    for r in range(world):
        with np.load(os.path.join(folder, f"{case}_rank{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


def _same_on_every_rank(results: list, key: str) -> None:
    """``key`` (a sequence of collectives) equal on every rank, and not empty."""
    assert len(results[0][key]) > 0, key
    for r, res in enumerate(results[1:], 1):
        np.testing.assert_array_equal(res[key], results[0][key], err_msg=f"rank {r}: {key}")


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------- one process
def test_mesh_helpers_without_a_group():
    """With no process group: a world-1 mesh whose helpers are identities
    and issue no collective."""
    assert not pm.distributed() and pm.process_rank() == 0 and pm.node_rank_world() == (0, 1)
    mesh = pm.get_mesh(default_cfg())
    assert (mesh.rank, mesh.world, mesh.group, mesh.device) == (0, 1, None, torch.device("cpu"))
    x = torch.arange(6.0, requires_grad=True)
    assert torch.equal(pm.shard_rays(mesh, x), x) and pm.gather_rays(mesh, x) is x
    assert pm.all_sum(mesh, x) is x
    pm.all_reduce_(mesh, [x.detach()])
    pm.replicate(mesh, [x])
    pm.barrier()
    assert mesh.counts == {"gather": 0, "all_reduce": 0, "broadcast": 0} and list(mesh.issued) == []


@pytest.mark.parametrize("shape,m,axis", [((5, 3), 4, 0), ((8, 2), 4, 0), ((3, 7), 3, 1),
                                          ((0, 2), 2, 0)])
def test_pad_to_multiple_matches_jax(shape, m, axis):
    a = np.random.default_rng(0).random(shape).astype(np.float32)
    ours, ref = pm.pad_to_multiple(a, m, axis, 2.5), j_pad_to_multiple(a, m, axis, 2.5)
    assert ours.shape[axis] % m == 0
    np.testing.assert_array_equal(ours, ref)


def test_shard_rays_refuses_a_ragged_axis():
    mesh = pm.RayMesh(group=None, rank=1, world=2, device=torch.device("cpu"))
    np.testing.assert_array_equal(pm.shard_rays(mesh, np.arange(6)), [3, 4, 5])
    with pytest.raises(ValueError, match="multiple of 2"):
        pm.shard_rays(mesh, np.arange(5))


def test_dist_env_maps_the_jax_variables():
    """RA_COORDINATOR / RA_NUM_PROCESSES / RA_PROCESS_ID become torchrun's
    variables: a JAX process is a node of one GPU."""
    env = dist_env({'RA_COORDINATOR': 'host7:1234', 'RA_NUM_PROCESSES': '4',
                    'RA_PROCESS_ID': '2'})
    assert env == dict(MASTER_ADDR='host7', MASTER_PORT='1234', WORLD_SIZE='4', RANK='2',
                       LOCAL_RANK='0', LOCAL_WORLD_SIZE='1', GROUP_RANK='2')


def test_dist_env_reads_torchrun():
    base = dict(RANK='5', WORLD_SIZE='8', MASTER_ADDR='a', MASTER_PORT='9')
    env = dist_env({**base, 'LOCAL_RANK': '1', 'LOCAL_WORLD_SIZE': '4', 'GROUP_RANK': '1'})
    assert env == {**base, 'LOCAL_RANK': '1', 'LOCAL_WORLD_SIZE': '4', 'GROUP_RANK': '1'}
    # the legacy launcher passes --local_rank instead of LOCAL_RANK
    assert dist_env(base, local_rank=3) == {**base, 'LOCAL_RANK': '3',
                                            'LOCAL_WORLD_SIZE': '1', 'GROUP_RANK': '5'}
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        dist_env({'RANK': '0', 'WORLD_SIZE': '2', 'MASTER_ADDR': 'a'})


def test_dist_env_without_a_launch(monkeypatch):
    """Nothing set: None, and maybe_init_distributed is a no-op; RA_DIST_AUTO
    and ``-l pytorch`` need torchrun's environment."""
    assert dist_env({}) is None and dist_env({'PATH': '/bin'}) is None
    for k in ('RANK', 'WORLD_SIZE', 'RA_COORDINATOR', 'RA_DIST_AUTO'):
        monkeypatch.delenv(k, raising=False)
    assert maybe_init_distributed(device="cpu") is False and not pm.distributed()
    with pytest.raises(RuntimeError, match="torchrun"):
        dist_env({'RA_DIST_AUTO': '1'})
    with pytest.raises(RuntimeError, match="torchrun"):
        dist_env({}, launcher='pytorch')
    base = dict(RANK='0', WORLD_SIZE='1', MASTER_ADDR='a', MASTER_PORT='9')
    assert dist_env({**base, 'RA_DIST_AUTO': '1'})['WORLD_SIZE'] == '1'


def test_nccl_group_is_bound_to_the_card(monkeypatch):
    """Under NCCL the process group is bound to the card LOCAL_RANK
    (``device_id``), so that its communicators are made for that card and a
    barrier need not guess it; the CPU's gloo group takes none."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.append(dict(kw, backend=backend)))
    for k in ('RA_COORDINATOR', 'RA_DIST_AUTO'):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(RANK='3', WORLD_SIZE='4', MASTER_ADDR='127.0.0.1', MASTER_PORT='9',
                     LOCAL_RANK='1', LOCAL_WORLD_SIZE='2', GROUP_RANK='1').items():
        monkeypatch.setenv(k, v)
    assert maybe_init_distributed(device="cuda") and maybe_init_distributed(device="cpu")
    assert seen[0]["backend"] == "nccl" and seen[0]["device_id"] == torch.device("cuda", 1)
    assert seen[1]["backend"] == "gloo" and "device_id" not in seen[1]


def test_dist_check_lists_every_comparison_beyond_its_bar():
    """``eval/dist_check.py``'s comparisons return every map and step beyond
    its bar (with the rays over it) instead of raising at the first: rank 0
    goes on through every collective and fails at the end, so the other
    ranks do not wait in a collective for it."""
    from relightableavatar_tpu_torch.eval import dist_check as dc
    ref = {"acc_map": np.zeros(8, np.float32), "rgb_map": np.zeros((8, 3), np.float32),
           "spec_map": np.full((8, 3), 0.5, np.float32)}
    assert dc.compare_frame(ref, ref)[1] == []
    got = {k: v.copy() for k, v in ref.items()}
    got["acc_map"][[1, 5]] = 1.0
    got["rgb_map"][2, 1] = 1e-3
    out, failures = dc.compare_frame(got, ref)
    assert out["acc_map"] == 1.0 and out["spec_map_db"] >= 100
    assert failures == [
        "frame acc_map: max |diff| 1.000e+00 > 1e-06 from one process on 2 of 8 rays",
        "frame rgb_map: max |diff| 1.000e-03 > 1e-06 from one process on 1 of 8 rays"]
    step_ref = {"loss": np.array(2.0), "grad/a": np.ones(3), "grad/b": np.ones(2)}
    assert dc.compare_step("stage1", step_ref, step_ref)[1] == []
    res, failures = dc.compare_step("stage1", dict(step_ref, loss=np.array(2.002),
                                                   **{"grad/b": np.array([1.0, 1.5])}), step_ref)
    assert res["worst_grad"] == "b" and res["worst_grad_rel"] == 0.5
    assert len(failures) == 1 and "stage1: loss rel 1.000e-03" in failures[0]


def test_get_mesh_checks_mesh_shape():
    cfg = default_cfg()
    cfg.tpu.mesh_shape = [1]
    assert pm.get_mesh(cfg).world == 1
    cfg.tpu.mesh_shape = [4]
    with pytest.raises(ValueError, match=r"4 ranks.*has 1.*--nproc_per_node 4"):
        pm.get_mesh(cfg)
    with pytest.raises(ValueError, match="n_devices"):
        pm.get_mesh(n_devices=2)


@pytest.mark.parametrize("node,nodes", [(0, 1), (1, 2), (2, 3)])
def test_sampler_strides_by_node_as_jax(monkeypatch, node, nodes):
    """The sampler's default rank and world are the node's (JAX's process
    index and count), and its items equal the JAX package's sampler's."""
    monkeypatch.setattr(datasets, "node_rank_world", lambda: (node, nodes))
    ours = datasets.TrainSampler(11, seed=5)
    ref = JTrainSampler(11, seed=5, rank=node, world=nodes)
    assert (ours.rank, ours.world, len(ours)) == (ref.rank, ref.world, len(ref))
    for s in (ours, ref):
        s.epoch = 2
    a, b = iter(ours), iter(ref)
    assert [next(a) for _ in range(25)] == [next(b) for _ in range(25)]


# ---------------------------------------------------------------- (a) render
def _jax_frame(jr_cls, jcfg, port_batch, lights=None):
    jparams, jmcfg, jctx = jax_scene(jcfg)
    jbatch = jdotdict(ctx=jctx, **{k: port_batch[k] for k in (
        'ray_o', 'ray_d', 'near', 'far', 'H', 'W', 'cam_K', 'cam_R', 'cam_T', 'mask_at_box')})
    if lights is not None:
        jbatch.novel_lights = lights
    jr = jr_cls(jcfg, jparams, jmcfg._replace(knn_exact=True))
    jr.mesh = None          # the one-device path (ROADMAP, "Tests")
    with jax.default_matmul_precision('highest'):
        return jr.render(jbatch)


def _render_case(folder, world: int = W) -> dict:
    cfg = ranks.frame_cfg(golden.fixture_cfg())
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    batch, _ = golden.frame_batch(ctx, ranks.FRAME_SIZE, ranks.FRAME_SIZE)
    one = SphereTracingRenderer(cfg, params, mcfg, device="cpu").render(batch)
    jone = _jax_frame(jorc.SphereTracingRenderer, ranks.frame_cfg(jax_cfg()), batch)

    scfg = ranks.sweep_cfg(golden.fixture_cfg())
    lights = datasets.load_lighting(scfg)
    np.savez(folder / "lights.npz", **{f"{n}/{k}": v for n, env in lights.items()
                                       for k, v in env.items()})
    sbatch, _ = golden.frame_batch(ctx, ranks.FRAME_SIZE, ranks.FRAME_SIZE)
    sbatch.novel_lights = lights
    sweep = NovelLightRenderer(scfg, params, mcfg, device="cpu").render(sbatch)
    jcfg = ranks.sweep_cfg(jax_cfg())
    jsweep = _jax_frame(jorc.NovelLightRenderer, jcfg, sbatch, j_load_lighting(jcfg))
    return dict(ranks=spawn("render", folder, world), one=one, jone=jone, sweep=sweep,
                jsweep=jsweep, n=int(batch.ray_o.shape[0]))


def _maps(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix) and k[len(prefix):].count('/') == 0}


def _check_maps(got: dict, one: dict, ref: dict, hit=None) -> None:
    """``got`` within SHARD_ATOL of the single-process ``one`` and at the
    frame tests' PSNR bars from the JAX package's ``ref``."""
    for k, v in got.items():
        sel = hit if k in HIT_ONLY else slice(None)
        print(f"{k}: max |sharded - W=1| {np.abs(v[sel] - one[k].numpy()[sel]).max():.3e}")
        np.testing.assert_allclose(v[sel], one[k].numpy()[sel], atol=SHARD_ATOL, rtol=0,
                                   err_msg=k)
        p = golden.psnr(v[sel], np.asarray(ref[k])[sel])
        assert p >= (MIN_PSNR_SPEC if k == 'spec_map' else MIN_PSNR), (k, p)


def _check_render(case: dict, world: int) -> None:
    """The checks of (a) on each of ``world`` ranks (see its test)."""
    a = np.arange(24.0).reshape(12, 2)
    ref = JTrainSampler(10, seed=3, rank=0, world=1)
    ref.epoch = 1
    it = iter(ref)
    items = [next(it) for _ in range(12)]
    one, jone, sweep, jsweep = case['one'], case['jone'], case['sweep'], case['jsweep']
    hit = sweep.base.acc_map.numpy() > 0
    for res in case['ranks']:
        np.testing.assert_array_equal(res['all_sum'], [2.0 * sum(range(1, world + 1)),
                                                       4.0 * world])
        np.testing.assert_array_equal(res['all_sum_grad'], [2.0, 2.0])
        np.testing.assert_array_equal(res['gathered'], a)
        np.testing.assert_array_equal(res['gathered_axis1'], a.T)
        np.testing.assert_array_equal(res['replicated'], np.zeros(3))
        np.testing.assert_array_equal(res['replicated_strided'], np.zeros((3, 2)))
        msg = str(res['mesh_shape_error'])
        assert (f"[{2 * world}]" in msg and f"has {world}" in msg
                and f"--nproc_per_node {2 * world}" in msg)
        assert list(res['node']) == [0, 1] and list(res['sampler']) == items

        maps = _maps(res, "frame/")
        assert int(res['frame_blocks']) == 2 and int(res['frame_gathers']) == len(maps)
        assert set(maps) == {k for k in one if k != 'envmap'}
        assert all(v.shape[0] == case['n'] for v in maps.values())
        _check_maps(maps, one, jone)

        base = _maps(res, "base/")
        assert set(base) == {k for k in sweep.base if k.endswith('_map')}
        _check_maps(base, sweep.base, jsweep.base, hit)
        for name in ranks.LIGHTS:
            _check_maps(_maps(res, f"novel/{name}/"), sweep.novel_light[name],
                        jsweep.novel_light[name], hit)
    for key in ('issued/helpers', 'issued/frame', 'issued/sweep'):
        _same_on_every_rank(case['ranks'], key)


def test_sharded_render_over_two_ranks(tmp_path):
    """(a) On each of 2 gloo ranks:

    - the collectives: all_sum gives the global value with the own part's
      gradient (not W times it), gather restores the global order along
      either axis, replicate broadcasts rank 0's (a strided tensor too), a
      mesh_shape other than the world raises naming both;
    - the sampler of two GPU ranks of one node (GROUP_RANK 0,
      LOCAL_WORLD_SIZE 2) is node 0 of 1, the JAX sampler's process 0 of 1;
    - the 16x16 frame (2 blocks, one gather a map) whole on both ranks,
      every map within SHARD_ATOL of the single-process port's and at
      test_torch_frame.py's bars from the JAX package's single-device one;
    - the two-light sweep's base pass and each light's re-shade (on each
      rank's slice, then gathered) likewise, at test_torch_novel_light.py's
      bars."""
    _check_render(_render_case(tmp_path), W)


def test_sharded_render_over_four_ranks(tmp_path):
    """(d) The checks of (a) on each of 4 gloo ranks, the same collectives
    on every rank, and at least one rank's slice of a ray block holds no
    hit (the 16x16 frame's 40 rays in the body's bounds fill 2 blocks of
    32: each rank holds 8 rays of each, and of the second block's 8 rays
    rank 0's slice holds all); and the frame equals to the bit the
    single-process frame of blocks of 8 rays, the rays a rank renders at a
    time (``dist_check.reference_frame``, [multi-gpu]'s reference on the
    card)."""
    world = 4
    case = _render_case(tmp_path, world)
    _check_render(case, world)
    block = ranks.FRAME_BLOCK
    acc = case['ranks'][0]['frame/acc_map']
    hit = np.zeros(-(-len(acc) // block) * block, bool)
    hit[:len(acc)] = acc > 0
    shard_hits = hit.reshape(-1, world, block // world).any(axis=-1)   # (block, rank)
    print(f"shards (block x rank) with a hit: {shard_hits.astype(int).tolist()}")
    assert shard_hits.any() and not shard_hits.all()
    # a rank renders the rays one process renders as blocks of block / W:
    # the sharded frame is that frame to the bit
    cfg = ranks.frame_cfg(golden.fixture_cfg())
    cfg.tpu.ray_block = block // world
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    batch, _ = golden.frame_batch(ctx, ranks.FRAME_SIZE, ranks.FRAME_SIZE)
    small = SphereTracingRenderer(cfg, params, mcfg, device="cpu").render(batch)
    for res in case['ranks']:
        for k, v in _maps(res, "frame/").items():
            np.testing.assert_array_equal(v, small[k].numpy(), err_msg=k)


# ---------------------------------------------------------------- (b) stage 1
def _inputs(flat: dict, runs: dict) -> dict:
    """The npz of a stage's rank inputs: the flat parameters and, per run,
    its budget, frames (context and rays) and jitter."""
    out = {'runs': np.array(list(runs))}
    out.update({f'param/{k}': v for k, v in flat.items()})
    for run, (budget, items, noise) in runs.items():
        out[f'{run}/budget'] = np.array(budget)
        out[f'{run}/B'] = np.array(len(items))
        if noise is not None:
            out[f'{run}/noise'] = noise
        for b, it in enumerate(items):
            out.update({f'{run}/ctx{b}/{k}': np.asarray(v) for k, v in it['ctx'].items()})
            out.update({f'{run}/ray{b}/{k}': it[k] for k in tt.RAY_KEYS})
    return out


def _port_step(cfg, params, mcfg, batch_of, noise=None) -> dict:
    trainer = Trainer(cfg, params, mcfg, device="cpu")
    stats = trainer.step(batch_of(trainer), 0, jitter_noise=noise)
    return dict(loss=float(stats.loss), grads={k: t.grad.numpy() for k, t in trainer.named},
                params={k: t.detach().numpy() for k, t in trainer.named})


def _away(items, lo: int):
    """The frames with rays ``lo:`` moved 5 m up, out of the HDQ band (no
    masked sample), and their mask 0."""
    out = []
    for it in items:
        it = dict(it)
        it['ray_o'] = it['ray_o'].copy()
        it['ray_o'][lo:] += np.float32([0, 0, 5.0])
        it['msk'] = it['msk'].copy()
        it['msk'][lo:] = 0
        out.append(it)
    return out


def spawn_with_inputs(case: str, folder, inputs: dict) -> list:
    np.savez(os.path.join(folder, f"{case}_inputs.npz"), **inputs)
    return spawn(case, folder)


def _check_step(res: dict, run: str, ref: dict, rel: float, skip=()) -> float:
    """The worst of the loss's, each gradient's and each stepped
    parameter's max |diff| / max |ref|; asserts it is within ``rel``."""
    worst = _rel(res[f'{run}/loss'], ref['loss'])
    for k, g in ref['grads'].items():
        if k in skip:
            continue
        worst = max(worst, _rel(res[f'{run}/grad/{k}'], g),
                    _rel(res[f'{run}/param/{k}'], ref['params'][k]))
    assert worst <= rel, (run, worst)
    return worst


def _stage1_scene(tmp_path, world: int) -> dict:
    """(b)'s scene, runs and rank inputs; the empty shard is every rank's
    but rank 0's."""
    tmp = str(tmp_path)
    jc, pc = tt._cfg(tt.j_default_cfg(), tmp), tt._cfg(default_cfg(), tmp)
    jm, pmc = j_anisdf.AniSDFConfig.from_cfg(jc), AniSDFConfig.from_cfg(pc)
    jp = j_anisdf.init_anisdf(jax.random.PRNGKey(0), jm)
    model = tt.synthetic.make_body_model(n_bones=52, target_verts=800, seed=0)
    motion = tt.synthetic.make_motion(4, n_bones=52)
    tv, tj, bA, _ = tt.make_bigpose(model, motion['shapes'][0])
    jctxs = [tt.make_frame_context(model, tv, tj, bA, motion['poses'][i], motion['Rh'][i],
                                   motion['Th'][i], motion['shapes'][0]) for i in range(tt.B)]
    items = tt._items(jctxs)
    empty = _away(items, tt.R // world)
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    chunked = tt.B * (tt.R // 2) * tt.S       # 2 chunks of R/2 rays
    runs = {'batch': (10**9, items), 'chunked': (chunked, items), 'empty_shard': (10**9, empty)}
    return dict(jc=jc, pc=pc, jm=jm, pmc=pmc, jp=jp, flat=flat, empty=empty, runs=runs,
                inputs=_inputs(flat, {k: (b, its, None) for k, (b, its) in runs.items()}))


def _check_stage1(sc: dict, results: list, world: int) -> None:
    """(b)'s checks of each rank's results (see its test)."""
    flat, pmc, empty = sc['flat'], sc['pmc'], sc['empty']
    # the empty shard is what it says: no masked sample on rank 1's rays
    params = tt.checkpoints.params_from_flat(flat, device="cpu", mcfg=pmc)
    own = tt.R // world
    for it in empty:
        ctx = {k: torch.as_tensor(np.asarray(v)) for k, v in it['ctx'].items()}
        rays = tt.dotdict({k: torch.as_tensor(it[k]) for k in tt.RAY_KEYS[:4]})
        with torch.no_grad():
            out = _volume_forward(params, pmc, ctx, rays, None, tt.S, 0.0)
        mask = out.reg_mask.reshape(tt.R, tt.S)
        assert not mask[own:].any() and mask[:own].any()
        assert not it['msk'][own:].any() and it['msk'][:own].all()

    r0 = results[0]
    for run, (budget, its) in sc['runs'].items():
        cfg = sc['pc'].clone()
        cfg.tpu.grad_sample_budget = budget
        params = jax.tree_util.tree_map(lambda t: t.to(torch.float64),
                                        tt.checkpoints.params_from_flat(flat, device="cpu",
                                                                        mcfg=pmc))
        one = _port_step(cfg, params, pmc, lambda tr, its=its: tt._port_batch(tr, its,
                                                                               torch.float64))
        print(f"{run}: W={world} against W=1, worst {_check_step(r0, run, one, STEP1_REL):.3e}")
        for r, res in enumerate(results[1:], 1):
            for k in r0:
                if k.startswith(f'{run}/'):
                    np.testing.assert_array_equal(res[k], r0[k], err_msg=f"rank {r}: {k}")
        assert int(r0[f'{run}/all_reduces']) >= 1
        _same_on_every_rank(results, f'{run}/issued')
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(j_anisdf, "knn_unchunked",
                    lambda p, v, K=3, exact=False, fast=False: exact_knn(p, v, K))
        with jax.enable_x64(True):
            ref = tt._jax_step(sc['jc'], sc['jm'], sc['jp'], empty, np.float64)
    print(f"empty_shard: W={world} against JAX, worst "
          f"{_check_step(r0, 'empty_shard', ref, STEP1_REL):.3e}")


def test_stage1_step_over_two_ranks(tmp_path):
    """(b) The stage-1 step of ``tests/test_torch_train.py``'s scene in
    float64 on 2 gloo ranks, for a batch, the same batch in 2 chunks (each
    rank takes its half of each chunk) and a batch whose rank-1 shard (the
    second half of each frame's rays, moved out of the HDQ band, mask 0) has
    no masked lane, so that a mean of per-rank means would differ from the
    global one: the loss, every gradient and every parameter after the step
    within STEP1_REL of the single-process port's, bit for bit equal on the
    two ranks, with the gradient all-reduced; and the empty-shard batch
    within STEP1_REL of the JAX package's step (the first batch is
    ``tests/test_torch_train.py``'s, whose single-process step
    ``test_step_matches_jax_float64`` holds to JAX's)."""
    sc = _stage1_scene(tmp_path, W)
    _check_stage1(sc, spawn_with_inputs("stage1", tmp_path, sc['inputs']), W)


# ---------------------------------------------------------------- (c) stage 2
def _stage2_scene(tmp_path) -> dict:
    """(c)'s scene, JAX's jitter and the rank inputs."""
    tmp = str(tmp_path)
    jc, pc = rt._cfg(jax_cfg(), tmp), rt._cfg(golden.fixture_cfg(), tmp)
    jp, jm, jctx = jax_scene(jc)
    pmc = AniSDFConfig.from_cfg(pc)._replace(sdf_res=8)
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    w = flat['resd/layers/8/w']
    flat['resd/layers/8/w'] = ((np.random.default_rng(0).random(w.shape) * 2 - 1)
                               / w.shape[0] ** 0.5).astype(np.float32)
    flat['env'] = flat['env'].reshape(4, 8, 8, 8, 3).mean(axis=(1, 3))
    scene = dict(pc=pc, jc=jc, pm=pmc, jm=jm, jp=rt._unflat(flat), flat=flat,
                 items=rt._items(jctx))
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        noise = rt._jax_noise(key).reshape(rt.B, rt.R, rt.S, 3)
    items = [dict(it, ctx={k: np.array(v) for k, v in it['ctx'].items()})
             for it in scene['items']]
    return dict(scene=scene, key=key, noise=noise, inputs=_inputs(
        flat, {'batch': (pc.tpu.grad_sample_budget, items, noise)}))


def _check_stage2(sc: dict, results: list, world: int) -> None:
    """(c)'s checks of each rank's results (see its test)."""
    scene, noise = sc['scene'], sc['noise']
    pc, pmc, flat = scene['pc'], scene['pm'], scene['flat']
    one = _port_step(pc, rt._port_params(scene), pmc,
                     lambda tr: rt._port_batch(tr, scene['items']), torch.as_tensor(noise))
    with jax.enable_x64(True):
        ref = rt._jax_relight_step(scene, sc['key'])
    unused = {k for k in ref['grads'] if k.startswith('rgb/')}
    for res in results:
        for name, want in (("W=1", one), ("JAX", ref)):
            worst = _check_step(res, 'batch', want, STEP2_REL, skip=unused)
            print(f"stage 2, W={world} against {name}: worst {worst:.3e}")
        assert int(res['batch/shadow_rays']) > 0
    # the summed count is every rank's own shadow rays
    assert sum(int(res['batch/own_shadow_rays'].sum()) for res in results) == \
        int(results[0]['batch/shadow_rays'])
    _same_on_every_rank(results, 'batch/issued')

    r0 = results[0]
    assert int(r0['ckpt/writes']) == 1
    assert all(int(res['ckpt/writes']) == 0 for res in results[1:])
    for res in results:
        assert int(res['ckpt/epoch']) == 1
        for k in flat:
            np.testing.assert_array_equal(res[f'ckpt/param/{k}'], r0[f'batch/param/{k}'])
        np.testing.assert_array_equal(res['ckpt/exp_avg0'], r0['ckpt/exp_avg0'])
    assert np.abs(r0['ckpt/exp_avg0']).max() > 0


def test_stage2_step_over_two_ranks(tmp_path):
    """(c) The stage-2 step of ``tests/test_torch_relight_train.py``'s scene
    in float64 (JAX's jitter) on 2 gloo ranks: the loss, every gradient and
    every parameter after the step within STEP2_REL of each tensor's
    largest entry against W = 1 and JAX (the stage-1 render MLP, unused by
    stage 2, aside), the shadow rays summed over the ranks; then a
    checkpoint of the stepped trainer is written once, by rank 0 (the latest
    and epoch files), and a fresh trainer on each rank resumes to the
    stepped parameters and Adam moments."""
    sc = _stage2_scene(tmp_path)
    _check_stage2(sc, spawn_with_inputs("stage2", tmp_path, sc['inputs']), W)


# ---------------------------------------------------------------- (e) both, 4 ranks
def test_steps_over_four_ranks(tmp_path):
    """(e) The stage-1 runs of (b) and the stage-2 step of (c) in one spawn
    of 4 gloo ranks, with (b)'s and (c)'s checks at their bars, and the
    same collectives on every rank: in the empty-shard batch ranks 1-3 hold
    no masked lane, and at least one rank's rays of a stage-2 frame trace
    no shadow ray (the sum of the ranks' own counts is the summed count)."""
    world = 4
    s1, s2 = _stage1_scene(tmp_path, world), _stage2_scene(tmp_path)
    np.savez(os.path.join(tmp_path, "stage1_inputs.npz"), **s1['inputs'])
    np.savez(os.path.join(tmp_path, "stage2_inputs.npz"), **s2['inputs'])
    results = spawn("steps", tmp_path, world, timeout=STEPS4_TIMEOUT_S)
    own = np.array([res['stage2/batch/own_shadow_rays'] for res in results])  # (rank, frame)
    print(f"stage 2: shadow rays of each rank (rows) in each frame: {own.tolist()}")
    assert own.shape == (world, rt.B) and (own == 0).any() and (own > 0).any()
    for stage, sc, check in (("stage1", s1, _check_stage1), ("stage2", s2, _check_stage2)):
        n = len(stage) + 1
        check(sc, [{k[n:]: v for k, v in res.items() if k.startswith(stage + "/")}
                   for res in results], world)


# ---------------------------------------------------------------- (f) threads
def test_threaded_ranks_equal_one_process(tmp_path):
    """(f) ``dist_check.emulate_ranks``, which [multi-gpu] holds the W cards'
    steps to: the stage-1 runs of (b) on 4 ranks that are threads of this
    process (torch's threaded process group) pass (b)'s checks at W = 4,
    against the single-process port and JAX, bit for bit equal on every
    rank with the same collectives; and a rank that raises fails the call
    instead of leaving the others in a collective."""
    import torch.distributed as dist
    from relightableavatar_tpu_torch.eval import dist_check
    world = 4
    sc = _stage1_scene(tmp_path, world)
    np.savez(os.path.join(tmp_path, "stage1_inputs.npz"), **sc['inputs'])
    results = dist_check.emulate_ranks(
        world, lambda: ranks._steps(dist.get_rank(), str(tmp_path), "stage1", world))
    assert not dist.is_initialized()
    _check_stage1(sc, results, world)

    def rank_two_raises():
        mesh = pm.get_mesh()
        if mesh.rank == 2:
            raise ValueError("rank 2 fails")
        return pm.all_sum(mesh, torch.ones(()))
    with pytest.raises(ValueError, match="rank 2 fails"):
        dist_check.emulate_ranks(world, rank_two_raises)
    assert [float(x) for x in dist_check.emulate_ranks(
        2, lambda: pm.all_sum(pm.get_mesh(), torch.ones(())))] == [2.0, 2.0]
