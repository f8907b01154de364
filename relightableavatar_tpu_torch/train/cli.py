"""The training entry of the port, with the CLI of the JAX package's
``train.py`` (reference ``train.py:24-85, 114-146``):

    python -m relightableavatar_tpu_torch.train -c configs/exp.yaml [--test] k v ...

The epoch loop with its save and eval cadences and the checkpoint resume.
``resume False`` deletes ``trained_model_dir`` first (a cold start from
``init_anisdf``); ``dry_run`` stops after building the network;
``detect_anomaly`` turns on ``torch.autograd.set_detect_anomaly``.
``main`` runs on the card; :func:`train` and :func:`test` take ``device``
(the tests pass "cpu").  With ``relighting True`` (stage 2) the network
takes its geometry from ``geometry_pretrain`` (a stage-1 checkpoint) and the
relight heads and the envmap from ``init_anisdf``, and the checkpoints go
under ``relight/<exp_name>/``.

Under ``torchrun`` (one process a GPU, NCCL) the step is sharded over the
ranks (``train/trainer.py``); every rank loads a resumed checkpoint onto its
card and renders the evaluation; rank 0 writes the checkpoints, the records
and the log lines, and scores the evaluation:

    torchrun --standalone --nproc_per_node N -m relightableavatar_tpu_torch.train -c cfg.yaml k v ...
"""
from __future__ import annotations

import os
import shutil


def train(cfg, device="cuda"):
    from relightableavatar_tpu_torch.data.datasets import make_data_loader
    from relightableavatar_tpu_torch.models.factory import make_evaluator, make_network
    from relightableavatar_tpu_torch.parallel.mesh import barrier, process_rank
    from relightableavatar_tpu_torch.train.checkpoints import load_model, save_model
    from relightableavatar_tpu_torch.train.trainer import Trainer
    from relightableavatar_tpu_torch.utils.log import log

    if not cfg.resume and os.path.exists(cfg.trained_model_dir) and process_rank() == 0:
        # before make_network, which would start from the folder's latest
        shutil.rmtree(cfg.trained_model_dir)
    barrier()

    params, mcfg = make_network(cfg, device=device, cold_start=True)
    trainer = Trainer(cfg, params, mcfg, device=device)

    begin_epoch, start_it, aux = 0, 0, {}
    if cfg.resume:
        found, epoch, aux = load_model(cfg.trained_model_dir, trainer.params, trainer.optimizer)
        if found:
            begin_epoch = epoch
            start_it = trainer.load_aux(aux)

    if cfg.dry_run:
        n_params = sum(t.numel() for _, t in trainer.named)
        log(f'network parameters: {n_params / 1e6:.2f}M', 'green')
        return trainer

    train_loader = make_data_loader(cfg, is_train=True, device=device)
    # without ep_iter an epoch is one pass over the dataset in batches
    ep_iter = cfg.ep_iter if cfg.ep_iter > 0 else max(
        len(train_loader) // int(cfg.train.batch_size), 1)

    # a checkpoint without aux (net and opt only): rebuild the recorder's
    # step, which drives the residual weight's anneal and the logged lr
    if begin_epoch and 'recorder' not in aux:
        assert cfg.ep_iter > 0, (
            'resuming a checkpoint without aux needs cfg.ep_iter > 0: the loader-derived '
            'ep_iter would disagree with the lr schedule')
        trainer.recorder.step = begin_epoch * ep_iter
        trainer.recorder.epoch = begin_epoch

    def _save(epoch_done: int, it_in_epoch: int = 0, latest: bool = True):
        save_model(cfg.trained_model_dir, trainer.params, trainer.optimizer, epoch_done,
                   latest=latest, aux=trainer.aux_state(it_in_epoch))

    for epoch in range(begin_epoch, cfg.train.epoch):
        train_loader.set_epoch(epoch)
        trainer.train_epoch(train_loader, epoch, ep_iter,
                            start_it=start_it if epoch == begin_epoch else 0,
                            save_cb=lambda it: _save(epoch, it))
        if (epoch + 1) % cfg.save_latest_ep == 0:
            _save(epoch + 1)
        if (epoch + 1) % cfg.save_ep == 0:
            _save(epoch + 1, latest=False)
        if (epoch + 1) % cfg.eval_ep == 0 and not cfg.skip_eval:
            try:
                test_loader = make_data_loader(cfg, is_train=False, device=device)
                trainer.val(test_loader, make_evaluator(cfg) if process_rank() == 0 else None)
            except Exception as e:  # eval must not stop training (train.py:77-82)
                log(f'eval failed: {e}', 'red')
    trainer.profiler.close()
    trainer.recorder.close()
    return trainer


def test(cfg, device="cuda"):
    from relightableavatar_tpu_torch.run import run_evaluate
    return run_evaluate(cfg, device=device)


def main(argv=None):
    import torch
    import torch.distributed as dist

    from relightableavatar_tpu_torch.config import setup
    from relightableavatar_tpu_torch.utils.log import post_mortem_on_crash
    cfg, args = setup(argv)
    if cfg.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    try:
        with post_mortem_on_crash():
            if args.test:
                test(cfg)
            else:
                train(cfg)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
