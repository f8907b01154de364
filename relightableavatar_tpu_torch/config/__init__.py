"""Config assembly for the port: code defaults, a YAML chain, CLI ``k v``
pairs, the six mode overlays and the derived values, in the order of
``relightableavatar_tpu/config/__init__.py`` (reference
``lib/config/config.py:432-538``):

    python -m relightableavatar_tpu_torch.run -t visualize -c configs/exp.yaml key value ...

defaults -> parent_cfg chain -> experiment YAML -> CLI opts -> mode overlays
(relighting_cfg, pose_seq_cfg, novel_view_cfg, mesh_cfg, sphere_tracing_cfg,
novel_light_cfg) -> CLI opts again -> derived values.

No platform switch and no process-global config: :func:`setup` builds a
tree and returns it, after :func:`maybe_init_distributed` has joined the
process group of a ``torchrun`` launch (one process a GPU):

    torchrun --nproc_per_node 4 -m relightableavatar_tpu_torch.train -c cfg.yaml k v ...
"""
from __future__ import annotations

import argparse
import os
from datetime import timedelta
from os.path import join

import numpy as np

from relightableavatar_tpu_torch.config.defaults import Output, default_cfg
from relightableavatar_tpu_torch.config.node import CN
from relightableavatar_tpu_torch.utils.log import log

__all__ = ["CN", "Output", "default_cfg", "dist_env", "make_cfg", "make_parser",
           "maybe_init_distributed", "merge_cfg", "parse_cfg", "setup", "update_cfg"]

DIST_TIMEOUT_S = 300    # a rank that never reaches a collective fails the run after this


def parse_cfg(cfg: CN, args=None) -> None:
    """Derived values (reference ``config.py:432-484``): n_bones from the
    dataset's body-model npz when present, the default visualization type,
    ``cond_dim``, and the task/experiment suffix of the output folders."""
    if len(cfg.task) == 0:
        raise ValueError('task must be specified')

    if cfg.tpu.knn_impl not in ('auto', 'pallas', 'xla'):
        raise ValueError(
            f"tpu.knn_impl must be one of 'auto'|'pallas'|'xla', "
            f"got {cfg.tpu.knn_impl!r}")

    model_path = join(cfg.train_dataset.data_root, cfg.body_model)
    if os.path.exists(model_path):
        with np.load(model_path) as f:
            if 'weights' in f:
                cfg.n_bones = int(f['weights'].shape[1])

    types = [k for k in Output if cfg[f'vis_{k.name.lower()}_map']]
    if not types:
        cfg[f'vis_{Output.Rendering.name.lower()}_map'] = True
    if cfg.vis_ext in ('.exr', '.hdr'):
        cfg.tonemapping_rendering = False
        cfg.tonemapping_albedo = False

    if cfg.vis_ground_shading:
        cfg.store_alpha_channel = False

    if cfg.fixed_latent == -1:
        cfg.fixed_latent = 0 if cfg.test_novel_pose else -1

    if cfg.cond_dim < 0:
        cfg.cond_dim = cfg.n_bones * 3

    cfg.trained_model_dir = join(cfg.trained_model_dir, cfg.task, cfg.exp_name)
    cfg.record_dir = join(cfg.record_dir, cfg.task, cfg.exp_name)
    cfg.result_dir = join(cfg.result_dir, cfg.task, cfg.exp_name)

    cfg.local_rank = getattr(args, 'local_rank', 0) if args is not None else 0

    if cfg.profiling.enabled:
        cfg.train.epoch = 1
        cfg.ep_iter = cfg.profiling.skip_first + cfg.profiling.repeat * (
            cfg.profiling.wait + cfg.profiling.warmup + cfg.profiling.active)
        cfg.profiling.record_dir = cfg.record_dir


def merge_cfg(cfg: CN, cfg_file: str | None, opts) -> CN:
    """The YAML chain, the CLI pairs, the mode overlays whose switch is on,
    and the CLI pairs again (reference ``config.py:487-517``)."""
    if cfg_file:
        cfg.merge_strain(cfg_file)
    cfg.merge_from_list(opts)

    if cfg.relighting and 'relighting_cfg' in cfg:
        cfg.merge_from_other_cfg(cfg.relighting_cfg)
    if cfg.vis_pose_sequence and 'pose_seq_cfg' in cfg:
        cfg.merge_from_other_cfg(cfg.pose_seq_cfg)
    if cfg.vis_novel_view and 'novel_view_cfg' in cfg:
        cfg.merge_from_other_cfg(cfg.novel_view_cfg)
    if (cfg.vis_tpose_mesh or cfg.vis_posed_mesh or cfg.vis_can_mesh) and 'mesh_cfg' in cfg:
        cfg.merge_from_other_cfg(cfg.mesh_cfg)
    if cfg.vis_sphere_tracing and 'sphere_tracing_cfg' in cfg:
        cfg.merge_from_other_cfg(cfg.sphere_tracing_cfg)
    if cfg.vis_novel_light and 'novel_light_cfg' in cfg:
        cfg.merge_from_other_cfg(cfg.novel_light_cfg)

    cfg.merge_from_list(opts)
    return cfg


def update_cfg(cfg: CN, args) -> CN:
    """Reference ``config.py:487-519``: :func:`merge_cfg` of the parsed
    arguments, then :func:`parse_cfg`."""
    merge_cfg(cfg, args.cfg_file, args.opts)
    parse_cfg(cfg, args)
    return cfg


def make_cfg(cfg_file: str | None = None, opts: list | None = None) -> CN:
    """:func:`merge_cfg` over the defaults, with ``cond_dim`` derived; the
    folders and the task are left as they are (no :func:`parse_cfg`)."""
    cfg = merge_cfg(default_cfg(), cfg_file, opts or [])
    if cfg.cond_dim < 0:
        cfg.cond_dim = cfg.n_bones * 3
    return cfg


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('-c', "--cfg_file", default="configs/default.yaml", type=str)
    parser.add_argument('-t', "--type", type=str, default="")
    parser.add_argument('-r', '--local_rank', type=int, default=0)
    parser.add_argument('-l', '--launcher', type=str, default='none', choices=['none', 'pytorch'])
    parser.add_argument("opts", default=[], nargs=argparse.REMAINDER)
    parser.add_argument('--test', action='store_true', dest='test', default=False)
    return parser


TORCHRUN_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                 "MASTER_ADDR", "MASTER_PORT")


def dist_env(environ, local_rank: int | None = None, launcher: str = "none") -> dict | None:
    """torchrun's variables (``TORCHRUN_KEYS``) of a multi-process launch,
    or None for a single process.

    - torchrun (or ``torch.distributed.launch``) sets them; the legacy
      launcher's ``--local_rank`` argument stands in for ``LOCAL_RANK``.
    - The JAX package's ``RA_COORDINATOR=host:port RA_NUM_PROCESSES=N
      RA_PROCESS_ID=i`` map onto ``MASTER_ADDR``/``MASTER_PORT``,
      ``WORLD_SIZE``, ``RANK`` and ``GROUP_RANK``: a JAX process is a host
      with all its chips, so each such process is a node of one GPU
      (``LOCAL_RANK`` 0, ``LOCAL_WORLD_SIZE`` 1) unless those are set.
    - ``RA_DIST_AUTO`` (the TPU pod's topology discovery) means torchrun's
      environment on GPUs; without it, it raises.
    - ``launcher='pytorch'`` (``-l pytorch``) requires a launch."""
    env = None
    if environ.get("RA_COORDINATOR"):
        host, port = environ["RA_COORDINATOR"].rsplit(":", 1)
        pid = environ["RA_PROCESS_ID"]
        env = dict(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE=environ["RA_NUM_PROCESSES"],
                   RANK=pid, LOCAL_RANK=environ.get("LOCAL_RANK", "0"),
                   LOCAL_WORLD_SIZE=environ.get("LOCAL_WORLD_SIZE", "1"),
                   GROUP_RANK=environ.get("GROUP_RANK", pid))
    elif environ.get("WORLD_SIZE"):
        env = {k: environ[k] for k in TORCHRUN_KEYS if k in environ}
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(f"WORLD_SIZE is set but {', '.join(missing)} are not: launch "
                               "with torchrun")
        env.setdefault("LOCAL_RANK", str(local_rank or 0))
        env.setdefault("LOCAL_WORLD_SIZE", "1")
        env.setdefault("GROUP_RANK", str(int(env["RANK"]) // int(env["LOCAL_WORLD_SIZE"])))
    if environ.get("RA_DIST_AUTO"):
        if env is None:
            raise RuntimeError("RA_DIST_AUTO: on GPUs the topology is torchrun's environment "
                               "(RANK, WORLD_SIZE, MASTER_ADDR, ...), which is not set; "
                               "launch with torchrun")
        log("RA_DIST_AUTO: the topology is torchrun's environment", "yellow")
    if env is None and launcher == "pytorch":
        raise RuntimeError("-l pytorch: no torchrun environment (RANK, WORLD_SIZE, ...); "
                           "launch with torchrun")
    return env


def maybe_init_distributed(device="cuda", local_rank: int | None = None,
                           launcher: str = "none", timeout_s: float = DIST_TIMEOUT_S) -> bool:
    """Join the process group of a multi-process launch (:func:`dist_env`),
    the reference's ``torchrun ... distributed True``
    (``train.py:116-122``): NCCL for a CUDA ``device``, each process on the
    card ``LOCAL_RANK`` and its communicators bound to it (``device_id``),
    gloo for the CPU.  Collectives time out after
    ``timeout_s`` seconds, so a rank that never arrives fails the run
    instead of hanging it.  A no-op returning False for a single process;
    True once the group exists."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    env = dist_env(os.environ, local_rank, launcher)
    if env is None:
        return False
    os.environ.update(env)
    kw = {}
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was asked for but torch finds no CUDA "
                               "device")
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
        backend = "nccl"
        # binds the communicators to this card: a barrier need not guess it
        kw["device_id"] = torch.device("cuda", int(env["LOCAL_RANK"]))
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=int(env["WORLD_SIZE"]),
                            rank=int(env["RANK"]), timeout=timedelta(seconds=timeout_s), **kw)
    log(f"distributed: rank {env['RANK']} of {env['WORLD_SIZE']} ({backend}), node "
        f"{env['GROUP_RANK']}, local rank {env['LOCAL_RANK']} @ "
        f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", "yellow")
    return True


def setup(argv=None):
    """Join a multi-process launch's group on the cards
    (:func:`maybe_init_distributed`) and parse the command line into a new
    config tree. Returns (cfg, args)."""
    args = make_parser().parse_args(argv)
    dist_on = maybe_init_distributed(local_rank=args.local_rank, launcher=args.launcher)
    cfg = default_cfg()
    if len(args.type) > 0:
        cfg.task = "run"
    update_cfg(cfg, args)
    if dist_on:
        cfg.distributed = True
        cfg.local_rank = int(os.environ["LOCAL_RANK"])
    if cfg.fix_random:
        # the reference seeds torch/cuda/numpy/random
        # (net_utils.py:1376-1384); the host-side generators here
        import random as _random
        np.random.seed(int(cfg.get('seed', 42)))
        _random.seed(int(cfg.get('seed', 42)))
    log(cfg.exp_name, 'magenta')
    return cfg, args
