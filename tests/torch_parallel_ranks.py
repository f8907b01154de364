"""The rank side of ``tests/test_torch_parallel.py``: what each of W gloo
ranks (2 by default, WORLD) runs, started by ``torch.multiprocessing`` with
the spawn method.

This module imports neither jax nor the JAX package, so the ranks do not
either: the test process computes the JAX results and hands the ranks their
inputs as ``.npz`` files in a folder; each rank writes its results there as
``<case>_rank<r>.npz`` for the test process to compare.  Each rank joins the
group through ``config.maybe_init_distributed`` on the CPU (gloo) at
``127.0.0.1:<port>`` with a 60 s collective timeout, and runs 2 torch
threads.  Each case also writes the sequence of collectives every mesh it
used issued (``RayMesh.issued``), which must be the same on every rank.
"""
import os
import sys

import numpy as np
import torch

from relightableavatar_tpu_torch.config import maybe_init_distributed
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.parallel import mesh as pm
from relightableavatar_tpu_torch.utils.dotdict import dotdict

WORLD = 2                # ranks of a spawn unless it asks for another count
TIMEOUT_S = 60           # init_process_group's: a hung collective fails the rank
FRAME_SIZE = 16          # 40 rays in the body's bounds: two blocks of 32
FRAME_BLOCK = 32
LIGHTS = ['olat0000-0000', 'gym_entrance']


def frame_cfg(cfg):
    """The exact frame of ``tests/test_torch_frame.py`` in blocks of 32."""
    cfg.sphere_tracing.iter = 6
    cfg.obj_lvis.iter = 2
    cfg.tpu.ray_block = FRAME_BLOCK
    return cfg


def sweep_cfg(cfg):
    """The two-light sweep of ``tests/test_torch_novel_light.py`` in blocks
    of 32."""
    cfg = frame_cfg(cfg)
    cfg.env_lvis.iter = 2
    cfg.tpu.bf16_mlp = False
    cfg.tpu.lvis_downscale = 2
    cfg.tpu.shadow_grid = 48
    cfg.tpu.lvis_sweep = True
    cfg.tpu.lvis_query_offset = 0.0
    cfg.tpu.distant_envmap = True
    cfg.vis_novel_light = True
    cfg.test_light = list(LIGHTS)
    return cfg


def flat_arrays(out: dict, prefix: str = "") -> dict:
    """The tensors (and nested dicts of tensors) of ``out`` as numpy arrays
    under ``prefix``-ed keys."""
    res = {}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            res[prefix + k] = v.detach().cpu().numpy()
        elif isinstance(v, dict):
            res.update(flat_arrays(v, f"{prefix}{k}/"))
    return res


def read_group(f, prefix: str) -> dict:
    """The arrays of ``f`` (an npz or a dict) under ``prefix``, keyed by the
    rest."""
    return {k[len(prefix):]: f[k] for k in f if k.startswith(prefix)}


def _tensors(d: dict, dtype=None) -> dict:
    out = {}
    for k, v in d.items():
        t = torch.as_tensor(v)
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return out


# ---------------------------------------------------------------- cases
def issued(mesh) -> np.ndarray:
    """A mesh's collectives as ``op:numel:dtype`` strings, in order."""
    return np.array([f"{op}:{n}:{dt}" for op, n, dt in mesh.issued], dtype=str)


def case_render(rank: int, folder: str, world: int) -> dict:
    """The mesh helpers, the sharded exact frame and the sharded sweep."""
    from relightableavatar_tpu_torch.data.datasets import TrainSampler
    from relightableavatar_tpu_torch.renderer.orchestrate import (NovelLightRenderer,
                                                                 SphereTracingRenderer)
    res = {}
    mesh = pm.get_mesh()
    assert (mesh.rank, mesh.world) == (rank, world)
    # all_sum: the global value on every rank, the gradient of the own part
    x = torch.tensor([1.0 + rank, 2.0], requires_grad=True)
    y = pm.all_sum(mesh, 2 * x)
    y.sum().backward()
    res['all_sum'] = y.detach().numpy()
    res['all_sum_grad'] = x.grad.numpy()
    # the slices of 12 rows, gathered back in order
    a = torch.arange(24.0).reshape(12, 2)
    res['gathered'] = pm.gather_rays(mesh, pm.shard_rays(mesh, a)).numpy()
    res['gathered_axis1'] = pm.gather_rays(mesh, pm.shard_rays(mesh, a.T, axis=1), axis=1).numpy()
    ref = torch.full((3,), float(rank))
    strided = torch.full((2, 3), float(rank)).T       # NCCL takes contiguous buffers only
    pm.replicate(mesh, [ref, strided])
    res['replicated'] = ref.numpy()
    res['replicated_strided'] = strided.numpy()
    res['issued/helpers'] = issued(mesh)
    cfg = golden.fixture_cfg()
    cfg.tpu.mesh_shape = [world]
    pm.get_mesh(cfg)
    try:
        cfg.tpu.mesh_shape = [2 * world]
        pm.get_mesh(cfg)
    except ValueError as e:
        res['mesh_shape_error'] = np.array(str(e))
    # the sampler: the node (GROUP_RANK) and the node count, not the GPU rank
    res['node'] = np.array(pm.node_rank_world())
    s = TrainSampler(10, seed=3)
    s.epoch = 1
    it = iter(s)
    res['sampler'] = np.array([next(it) for _ in range(12)])

    cfg = frame_cfg(golden.fixture_cfg())
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    batch, _ = golden.frame_batch(ctx, FRAME_SIZE, FRAME_SIZE)
    r = SphereTracingRenderer(cfg, params, mcfg, device="cpu")
    out = r.render(batch)
    res.update(flat_arrays(out, "frame/"))
    res['frame_blocks'] = np.array(r.last_frame.blocks)
    res['frame_gathers'] = np.array(r.mesh.counts['gather'])
    res['issued/frame'] = issued(r.mesh)

    cfg = sweep_cfg(golden.fixture_cfg())
    ctx, params, mcfg = golden.load_fixture(cfg, device="cpu")
    batch, _ = golden.frame_batch(ctx, FRAME_SIZE, FRAME_SIZE)
    with np.load(os.path.join(folder, "lights.npz")) as f:
        batch.novel_lights = {n: read_group(f, n + "/") for n in LIGHTS}
    r = NovelLightRenderer(cfg, params, mcfg, device="cpu")
    out = r.render(batch)
    res['issued/sweep'] = issued(r.mesh)
    res.update(flat_arrays(out.base, "base/"))
    for name, frame in out.novel_light.items():
        res.update(flat_arrays(frame, f"novel/{name}/"))
    return res


def _steps(rank: int, folder: str, stage: str, world: int) -> dict:
    """The train steps of the npz ``<stage>_inputs.npz``: each named batch
    from the same flat parameters, float64, through a fresh Trainer.  For
    stage 2 also the shadow rays this rank traced in each frame, before the
    sum over the ranks."""
    from relightableavatar_tpu_torch.config import default_cfg
    from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
    from relightableavatar_tpu_torch.train import checkpoints
    from relightableavatar_tpu_torch.train.trainer import Trainer
    res = {}
    with np.load(os.path.join(folder, f"{stage}_inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    cfg_of = step_cfg if stage == "stage1" else relight_cfg
    runs = [str(n) for n in inputs['runs']]
    for run in runs:
        budget = int(inputs[f'{run}/budget'])
        cfg = cfg_of(default_cfg() if stage == "stage1" else golden.fixture_cfg(),
                     os.path.join(folder, f"{stage}_{run}_rank{rank}"))
        cfg.tpu.grad_sample_budget = budget
        mcfg = AniSDFConfig.from_cfg(cfg)
        if stage == "stage2":
            mcfg = mcfg._replace(sdf_res=8)
        flat = read_group(inputs, "param/")
        params = _cast(checkpoints.params_from_flat(flat, device="cpu", mcfg=mcfg),
                       torch.float64)
        trainer = Trainer(cfg, params, mcfg, device="cpu")
        assert trainer.mesh is not None and trainer.mesh.world == world
        batch = _batch(trainer, inputs, run)
        own_shadow = []
        if trainer.relight:
            forward = trainer._frame_forward

            def counted(*a, forward=forward, trainer=trainer):
                before = trainer.shadow_rays
                out = forward(*a)
                own_shadow.append(trainer.shadow_rays - before)
                return out
            trainer._frame_forward = counted
        noise = inputs.get(f'{run}/noise')
        stats = trainer.step(batch, 0, jitter_noise=None if noise is None
                             else torch.as_tensor(noise))
        res[f'{run}/loss'] = np.array(float(stats.loss))
        for k, t in trainer.named:
            res[f'{run}/grad/{k}'] = t.grad.numpy()
            res[f'{run}/param/{k}'] = t.detach().numpy()
        res[f'{run}/all_reduces'] = np.array(trainer.mesh.counts['all_reduce'])
        res[f'{run}/issued'] = issued(trainer.mesh)
        if trainer.relight:
            res[f'{run}/shadow_rays'] = np.array(trainer.shadow_rays)
            res[f'{run}/own_shadow_rays'] = np.array(own_shadow)
        if stage == "stage2" and run == runs[0]:
            res.update(_checkpoint_round(trainer, cfg, mcfg, flat, folder))
    return res


def _checkpoint_round(trainer, cfg, mcfg, flat, folder) -> dict:
    """Save the stepped trainer (counting this rank's writes), then resume a
    fresh trainer of the initial parameters from it."""
    from relightableavatar_tpu_torch.train import checkpoints
    from relightableavatar_tpu_torch.train.trainer import Trainer
    writes = []
    write = checkpoints._write_model
    checkpoints._write_model = lambda *a: (writes.append(a[0]), write(*a))
    try:
        model_dir = os.path.join(folder, "model")
        checkpoints.save_model(model_dir, trainer.params, trainer.optimizer, 1)
    finally:
        checkpoints._write_model = write
    assert sorted(os.listdir(model_dir)) == ["1.npz", "latest.npz"], os.listdir(model_dir)
    fresh = Trainer(cfg, _cast(checkpoints.params_from_flat(flat, device="cpu", mcfg=mcfg),
                               torch.float64), mcfg, device="cpu")
    found, epoch, _ = checkpoints.load_model(model_dir, fresh.params, fresh.optimizer)
    res = {'ckpt/writes': np.array(len(writes)), 'ckpt/epoch': np.array(epoch if found else -1)}
    for k, t in fresh.named:
        res[f'ckpt/param/{k}'] = t.detach().numpy()
    state = fresh.optimizer.opt.state[fresh.named[0][1]]
    res['ckpt/exp_avg0'] = state['exp_avg'].numpy()
    return res


def _cast(params, dtype):
    if isinstance(params, dict):
        return {k: _cast(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast(v, dtype) for v in params]
    return params.to(dtype)


def _batch(trainer, inputs: dict, run: str) -> dotdict:
    """The collated batch of the run's frames, in float64."""
    B = int(inputs[f'{run}/B'])
    items = []
    for b in range(B):
        ctx = _tensors(read_group(inputs, f'{run}/ctx{b}/'), torch.float64)
        items.append(dotdict(ctx=ctx, **read_group(inputs, f'{run}/ray{b}/')))
    batch = trainer.collate(items)
    for k in ('ray_o', 'ray_d', 'near', 'far', 'rgb', 'msk'):
        batch[k] = batch[k].to(torch.float64)
    return batch


def step_cfg(c, record_dir: str):
    """``tests/test_torch_train.py``'s stage-1 config (S = 4, B = 2)."""
    c.n_bones = 52
    c.cond_dim = 156
    c.sdf_res = 6
    c.n_samples = 4
    c.train.batch_size = 2
    c.ep_iter = 4
    c.relighting = False
    c.record_dir = record_dir
    c.trained_model_dir = os.path.join(record_dir, 'model')
    c.tpu.bf16_mlp = False
    c.tpu.knn_impl = 'pallas'
    c.perturb = 0
    return c


def relight_cfg(c, record_dir: str):
    """``tests/test_torch_relight_train.py``'s stage-2 config on the fixture
    config (2 x 4 light texels, S = 3, B = 2)."""
    c.env_h, c.env_w = 2, 4
    c.n_samples = 3
    c.train.batch_size = 2
    c.ep_iter = 4
    c.network_chunk_size = 1024
    c.train.lr = 5e-3
    c.train.lr_table = type(c.train.lr_table)({'residual_deformation_network': 5e-6,
                                               'signed_distance_network': 5e-6,
                                               'roughness_network': 5e-5})
    c.sphere_tracing.iter = 4
    c.obj_lvis.iter = 2
    c.record_dir = record_dir
    c.trained_model_dir = os.path.join(record_dir, 'model')
    return c


def case_steps(rank: int, folder: str, world: int) -> dict:
    """Both stages' steps in one spawn, keyed ``stage1/...`` and ``stage2/...``."""
    return {f"{stage}/{k}": v for stage in ("stage1", "stage2")
            for k, v in _steps(rank, folder, stage, world).items()}


CASES = {'render': case_render,
         'stage1': lambda rank, folder, world: _steps(rank, folder, "stage1", world),
         'stage2': lambda rank, folder, world: _steps(rank, folder, "stage2", world),
         'steps': case_steps}


def run_rank(rank: int, case: str, folder: str, port: int, world: int = WORLD) -> None:
    """Entry of one spawned rank: join the gloo group of ``world`` ranks on
    one node, run ``case`` and write its results."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), GROUP_RANK="0")
    torch.set_num_threads(2)
    assert 'jax' not in sys.modules
    assert maybe_init_distributed(device="cpu", timeout_s=TIMEOUT_S)
    try:
        res = CASES[case](rank, folder, world)
        assert 'jax' not in sys.modules
        np.savez(os.path.join(folder, f"{case}_rank{rank}.npz"), **res)
    finally:
        torch.distributed.destroy_process_group()
