"""Test-time dispatcher of the port, with the CLI of the JAX package's
``run.py`` (reference ``run.py:21-98``):

    python -m relightableavatar_tpu_torch.run -t {dataset,network,evaluate,visualize} -c cfg.yaml k v ...

Tasks: dataset (iterate the test loader), network (render-only timing),
evaluate (PSNR/SSIM/LPIPS against the dataset's images, writing the maps),
visualize (write every enabled Output map, and videos).  ``main`` runs on
the card; each ``run_*`` function takes ``device`` (the tests pass "cpu").
Each frame prints one progress line to stderr with its host seconds:
``data`` (the loader's ``__getitem__``), ``render`` (ending in a device
sync) and ``write`` (the evaluator's or visualizer's metrics and files).

Under ``torchrun`` (one process a GPU, NCCL) every rank loads the same
frame and renders its slice of the rays through the sharded renderer
(``renderer/orchestrate.py``); rank 0 alone scores, writes and prints:

    torchrun --standalone --nproc_per_node N -m relightableavatar_tpu_torch.run -t evaluate -c cfg.yaml k v ...
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from relightableavatar_tpu_torch.parallel.mesh import process_rank


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _frames(loader):
    """(index, batch, seconds of the loader's ``__getitem__``) per frame."""
    it = iter(loader)
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        yield i, batch, time.perf_counter() - t0
        i += 1


def _progress(task: str, i: int, n: int, **secs) -> None:
    if process_rank() != 0:
        return
    parts = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in secs.items())
    print(f"[{task}] frame {i + 1}/{n}: {parts}", file=sys.stderr, flush=True)


def _render(renderer, batch, device):
    t0 = time.perf_counter()
    out = renderer.render(batch)
    _sync(device)
    return out, time.perf_counter() - t0


def run_dataset(cfg, device="cuda"):
    from relightableavatar_tpu_torch.data.datasets import make_data_loader
    from relightableavatar_tpu_torch.utils.log import log
    loader = make_data_loader(cfg, is_train=False, device=device)
    for i, batch, data_s in _frames(loader):
        if i == 0:  # what a batch carries
            shapes = {k: tuple(v.shape) for k, v in batch.items()
                      if hasattr(v, 'shape')}
            log(f'first batch: {shapes}')
        _progress('dataset', i, len(loader), data=data_s)


def run_network(cfg, device="cuda"):
    from relightableavatar_tpu_torch.data.datasets import make_data_loader
    from relightableavatar_tpu_torch.models.factory import make_network, make_renderer
    params, mcfg = make_network(cfg, device=device)
    renderer = make_renderer(cfg, params, mcfg, device=device)
    loader = make_data_loader(cfg, is_train=False, device=device)
    net_time = []
    for i, batch, data_s in _frames(loader):
        _, render_s = _render(renderer, batch, device)
        net_time.append(render_s)
        _progress('network', i, len(loader), data=data_s, render=render_s)
    if len(net_time) > 1 and process_rank() == 0:
        diff = np.asarray(net_time[1:])  # the first frame includes set-up
        print(f'mean render time: {diff.mean():.4f}s, fps: {1.0 / diff.mean():.2f}')


def run_evaluate(cfg, device="cuda"):
    from relightableavatar_tpu_torch.data.datasets import make_data_loader
    from relightableavatar_tpu_torch.models.factory import (make_evaluator, make_network,
                                                           make_renderer)
    params, mcfg = make_network(cfg, device=device)
    renderer = make_renderer(cfg, params, mcfg, device=device)
    evaluator = make_evaluator(cfg) if process_rank() == 0 else None
    loader = make_data_loader(cfg, is_train=False, device=device)
    for i, batch, data_s in _frames(loader):
        out, render_s = _render(renderer, batch, device)
        t0 = time.perf_counter()
        if evaluator is not None:
            evaluator.evaluate(out, batch)
        _progress('evaluate', i, len(loader), data=data_s, render=render_s,
                  write=time.perf_counter() - t0)
    return evaluator.summarize() if evaluator is not None else None


def run_visualize(cfg, device="cuda"):
    from relightableavatar_tpu_torch.data.datasets import make_data_loader
    from relightableavatar_tpu_torch.models.factory import (make_network, make_renderer,
                                                           make_visualizer)
    params, mcfg = make_network(cfg, device=device)
    renderer = make_renderer(cfg, params, mcfg, device=device)
    visualizer = make_visualizer(cfg) if process_rank() == 0 else None
    loader = make_data_loader(cfg, is_train=False, device=device)
    for i, batch, data_s in _frames(loader):
        out, render_s = _render(renderer, batch, device)
        t0 = time.perf_counter()
        if visualizer is not None:
            visualizer.visualize(out, batch)
        _progress('visualize', i, len(loader), data=data_s, render=render_s,
                  write=time.perf_counter() - t0)
    if visualizer is not None:
        visualizer.summarize()


TASKS = {'dataset': run_dataset, 'network': run_network,
         'evaluate': run_evaluate, 'visualize': run_visualize}


def main(argv=None, device="cuda"):
    import torch.distributed as dist

    from relightableavatar_tpu_torch.config import setup
    from relightableavatar_tpu_torch.utils.log import post_mortem_on_crash
    cfg, args = setup(argv)
    try:
        if args.type not in TASKS:
            raise SystemExit(f"-t must be one of {', '.join(TASKS)}, got {args.type!r}")
        with post_mortem_on_crash():
            TASKS[args.type](cfg, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
