"""Config assembly for the port: code defaults, a YAML chain, CLI ``k v``
pairs, the six mode overlays and the derived values, in the order of
``relightableavatar_tpu/config/__init__.py`` (reference
``lib/config/config.py:432-538``):

    python -m relightableavatar_tpu_torch.run -t visualize -c configs/exp.yaml key value ...

defaults -> parent_cfg chain -> experiment YAML -> CLI opts -> mode overlays
(relighting_cfg, pose_seq_cfg, novel_view_cfg, mesh_cfg, sphere_tracing_cfg,
novel_light_cfg) -> CLI opts again -> derived values.

No platform switch and no process-global config: :func:`setup` builds a
tree and returns it.  Multi-process start-up (``maybe_init_distributed``)
is not ported yet.
"""
from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np

from relightableavatar_tpu_torch.config.defaults import Output, default_cfg
from relightableavatar_tpu_torch.config.node import CN
from relightableavatar_tpu_torch.utils.log import log

__all__ = ["CN", "Output", "default_cfg", "make_cfg", "make_parser", "merge_cfg",
           "parse_cfg", "setup", "update_cfg"]


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


def setup(argv=None):
    """Parse the command line into a new config tree. Returns (cfg, args)."""
    args = make_parser().parse_args(argv)
    cfg = default_cfg()
    if len(args.type) > 0:
        cfg.task = "run"
    update_cfg(cfg, args)
    if cfg.fix_random:
        # the reference seeds torch/cuda/numpy/random
        # (net_utils.py:1376-1384); the host-side generators here
        import random as _random
        np.random.seed(int(cfg.get('seed', 42)))
        _random.seed(int(cfg.get('seed', 42)))
    log(cfg.exp_name, 'magenta')
    return cfg, args
