"""Stage-1 trainer (``relightableavatar_tpu/train/trainer.py``; reference
``lib/train/trainers/trainer.py``): the volume train step, the recorder
(smoothed scalars, ``scalars.jsonl``, TensorBoard events) and the epoch loop.

One step: for each ray chunk (``tpu.grad_sample_budget``, the JAX package's
halving rule) and each frame of the batch, the frame's training render and
losses, back-propagated with weight 1 / (B NC), so the summed gradients are
the mean of the per-frame losses averaged over the chunks, as the JAX step's
``vmap`` mean and ``scan`` sum over NC give; then clipping and the
optimiser's update.  Stratified sampling draws one (B, R, S) block from the
trainer's generator a step and slices it per chunk, so chunking changes no
draw.

The relight step (``cfg.relighting``) and ``cfg.profiling`` traces are
ROADMAP item 10b and raise.  ``tpu.donate`` has no meaning here (the
update is in place) and is a logged no-op.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from os.path import join

import numpy as np
import torch

from relightableavatar_tpu_torch.device import resolve_device
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.renderer.volume import train_block
from relightableavatar_tpu_torch.train.checkpoints import named_params
from relightableavatar_tpu_torch.train.loss import anisdf_losses, loss_weights_from_cfg
from relightableavatar_tpu_torch.train.optimizer import TrainOptimizer, make_lr_schedule
from relightableavatar_tpu_torch.utils.dotdict import dotdict
from relightableavatar_tpu_torch.utils.flops import train_step_flops
from relightableavatar_tpu_torch.utils.log import log

RAY_KEYS = ('ray_o', 'ray_d', 'near', 'far', 'rgb', 'msk', 'norm', 'sem')


# ------------------------------------------------------------------ recorder
class SmoothedValue:
    def __init__(self, window: int = 20):
        self.d = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v):
        self.d.append(float(v))
        self.total += float(v)
        self.count += 1

    @property
    def avg(self):
        return float(np.mean(self.d)) if self.d else 0.0


class Recorder:
    """Smoothed scalar windows, written as ``record_dir/scalars.jsonl`` rows
    and (``record_tb``) a TensorBoard event file."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.stats = {}
        self.step = 0
        self.epoch = 0
        os.makedirs(cfg.record_dir, exist_ok=True)
        self.jsonl = open(join(cfg.record_dir, 'scalars.jsonl'), 'a')
        self.tb = None
        if cfg.get('record_tb', False):
            from relightableavatar_tpu_torch.utils.tb_events import EventWriter
            self.tb = EventWriter(cfg.record_dir)

    def update(self, scalars: dict):
        for k, v in scalars.items():
            self.stats.setdefault(k, SmoothedValue()).update(v)

    def record(self):
        row = {k: v.avg for k, v in self.stats.items()}
        row['step'] = self.step
        row['epoch'] = self.epoch
        self.jsonl.write(json.dumps(row) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalars({k: v for k, v in row.items() if k not in ('step', 'epoch')},
                                self.step)

    def record_images(self, images: dict):
        """Float [0, 1] (H, W, 3) images as PNGs under ``record_dir/images/``,
        named by epoch."""
        from relightableavatar_tpu_torch.data.image_io import write_png
        img_dir = join(self.cfg.record_dir, 'images')
        os.makedirs(img_dir, exist_ok=True)
        for k, img in images.items():
            rgb = (np.clip(np.asarray(img, np.float32), 0, 1) * 255).astype(np.uint8)
            write_png(join(img_dir, f'ep{self.epoch:04d}_{k}.png'), rgb)

    def state_dict(self):
        """Step, epoch and the smoothed windows: a resumed run's logged stats
        continue mid-window (net_utils.py:1473-1479)."""
        return dict(step=self.step, epoch=self.epoch,
                    stats={k: dict(d=list(v.d), total=v.total, count=v.count)
                           for k, v in self.stats.items()})

    def load_state_dict(self, d):
        self.step = int(d.get('step', 0))
        self.epoch = int(d.get('epoch', 0))
        for k, s in (d.get('stats') or {}).items():
            sv = self.stats.setdefault(k, SmoothedValue())
            sv.d = deque((float(x) for x in s['d']), maxlen=sv.d.maxlen)
            sv.total = float(s['total'])
            sv.count = int(s['count'])

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()

    def __str__(self):
        return "  ".join(f"{k}: {v.avg:.4f}" for k, v in sorted(self.stats.items()))


# ------------------------------------------------------------------ step
def _volume_forward(params, mcfg: AniSDFConfig, ctx, rays: dotdict, t_rand,
                    n_samples: int, bg_brightness: float) -> dotdict:
    """Training render of one frame's rays (JAX ``_volume_forward``): maps
    and the regularisation terms.  The composited normals lose the
    background term ``volume_rendering`` adds to every channel, so they are
    not biased toward (bg, bg, bg) on semi-transparent rays."""
    o = train_block(params, mcfg, ctx, rays.ray_o, rays.ray_d, rays.near, rays.far,
                    n_samples, bg_brightness, t_rand)
    out = dotdict(rgb_map=o.raw_map[..., 3:6], acc_map=o.acc_map, reg_mask=o.reg_mask,
                  residuals=o.residuals, gradients=o.gradients,
                  observed_gradients=o.observed_gradients)
    out.norm_map = o.raw_map[..., 0:3] - (1.0 - o.acc_map)[..., None] * bg_brightness
    return out


def ray_chunks(B: int, R: int, n_samples: int, budget: int) -> tuple:
    """(RC, NC): rays a chunk and chunks, halving RC while B * RC * S
    exceeds the budget and RC is even (JAX ``Trainer._build_step``)."""
    RC = R
    while B * RC * max(n_samples, 1) > budget and RC % 2 == 0:
        RC //= 2
    return RC, R // RC


class Trainer:
    """Parameters (tensors on ``device``, updated in place), the optimiser,
    the recorder and the loop (reference Trainer.train / val)."""

    def __init__(self, cfg, params: dict, mcfg: AniSDFConfig, device="cuda"):
        if cfg.relighting:
            raise NotImplementedError(
                "the relight (stage-2) train step is not ported yet (ROADMAP item 10b)")
        if cfg.profiling.enabled:
            raise NotImplementedError(
                "cfg.profiling traces of the train step are not ported yet (ROADMAP item 10b)")
        if cfg.tpu.donate:
            log('tpu.donate: no-op in torch (the step updates the parameters in place)')
        self.cfg = cfg
        self.mcfg = mcfg
        self.device = resolve_device(device)
        self.params = params
        self.named = named_params(params)
        for _, t in self.named:
            t.requires_grad_(True)
        self.optimizer = TrainOptimizer(cfg, self.named)
        self._lr_sched = make_lr_schedule(cfg, float(cfg.train.lr))
        self.recorder = Recorder(cfg)
        self.weights = loss_weights_from_cfg(cfg)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(cfg.get('seed', 42)))
        self._step_flops = None
        self._warned_sem = False

    # ------------------------------------------------------- the step
    def step(self, batch: dotdict, iter_step: int) -> dotdict:
        """One optimiser step on a collated batch; returns the step's stats
        (scalar tensors on the device: the mean over frames, averaged over
        chunks)."""
        cfg = self.cfg
        S = int(cfg.n_samples)
        bg = float(cfg.bg_brightness)
        B, R = batch.rgb.shape[:2]
        RC, NC = ray_chunks(B, R, S, int(cfg.tpu.grad_sample_budget))
        t_rand = None
        if cfg.perturb > 0:
            t_rand = torch.rand((B, R, S), generator=self.generator, device=self.device)
        for _, t in self.named:
            t.grad = None
        keys = [k for k in RAY_KEYS if k in batch]
        stats = dotdict()
        for c in range(NC):
            sl = slice(c * RC, (c + 1) * RC)
            for b in range(B):
                rays = dotdict({k: batch[k][b, sl] for k in keys})
                out = _volume_forward(self.params, self.mcfg, batch.ctx[b], rays,
                                      None if t_rand is None else t_rand[b, sl], S, bg)
                loss, st = anisdf_losses(self.weights, out, rays, iter_step)
                (loss / (B * NC)).backward()
                for k, v in st.items():
                    v = v.detach() / (B * NC)
                    stats[k] = stats[k] + v if k in stats else v
        self.optimizer.step()
        return stats

    # ------------------------------------------------------- full-state aux
    def aux_state(self, it_in_epoch: int = 0) -> dict:
        """JSON training state beyond the network and optimiser: the
        recorder (its step drives the residual weight's anneal), the
        generator's state and the iteration within the epoch (0 = epoch
        boundary).  With these a resume repeats the uninterrupted run bit for
        bit: the schedule's step rides in the optimiser block, and the
        loader's draws are a function of (seed, index, draw)."""
        return dict(recorder=self.recorder.state_dict(),
                    rng_state=self.generator.get_state().tolist(),
                    it=int(it_in_epoch))

    def load_aux(self, aux: dict) -> int:
        """Restore :meth:`aux_state`; returns the iteration to resume at."""
        if 'recorder' in aux:
            self.recorder.load_state_dict(aux['recorder'])
        if 'rng_state' in aux:
            self.generator.set_state(torch.tensor(aux['rng_state'], dtype=torch.uint8))
        elif 'rng_key' in aux:
            log('aux holds a JAX PRNG key: the torch generator keeps its seed', 'yellow')
        return int(aux.get('it', 0))

    # ------------------------------------------------------- collate
    def collate(self, items) -> dotdict:
        """Per-frame items -> a batch: the ray arrays as (B, R, C) tensors on
        the device, packed on the host into one float32 buffer and copied in
        one transfer, and ``ctx`` the list of the frames' contexts."""
        batch = dotdict(ctx=[it.ctx for it in items])
        keys = ['ray_o', 'ray_d', 'near', 'far', 'rgb', 'msk']
        keys += [k for k in ('norm', 'sem') if all(k in it for it in items)]
        cols, widths = [], []
        for k in keys:
            a = np.stack([np.asarray(it[k], np.float32) for it in items])
            if a.ndim == 2:
                a = a[..., None]
            widths.append(a.shape[-1])
            cols.append(a)
        packed = torch.from_numpy(np.concatenate(cols, axis=-1)).to(self.device)
        off = 0
        for k, w in zip(keys, widths):
            col = packed[..., off:off + w]
            batch[k] = col[..., 0] if k in ('near', 'far', 'msk') else col
            off += w
        return batch

    # ------------------------------------------------------- loop
    def train_epoch(self, loader, epoch: int, ep_iter: int, start_it: int = 0, save_cb=None):
        """One epoch of ``ep_iter`` steps.  ``start_it`` resumes mid-epoch
        (the loader skips the first batches without preparing them; item
        streams are keyed by draw number, so the rest match the
        uninterrupted run); ``save_cb(it)`` runs every
        ``cfg.save_latest_iter`` steps when that is set."""
        cfg = self.cfg
        save_iter = int(cfg.get('save_latest_iter', 0))
        bs = int(cfg.train.batch_size)
        self.recorder.epoch = epoch
        items = []
        it = start_it
        if start_it:
            loader.skip_next = start_it * bs
        t_iter = time.perf_counter()
        for item in loader:
            items.append(item)
            if len(items) < bs:
                continue
            batch = self.collate(items)
            items = []
            if 'sem' in batch and not self._warned_sem:
                log('batch carries `sem` but the network produces no sem_map: '
                    'semantic loss is inactive', 'yellow')
                self._warned_sem = True
            if self._step_flops is None:
                B, R = batch.rgb.shape[:2]
                self._step_flops = train_step_flops(self.mcfg, B * R * int(cfg.n_samples),
                                                    int(batch.ctx[0]['pverts'].shape[0]))
            stats = self.step(batch, self.recorder.step)
            it += 1
            self.recorder.step += 1
            if it % cfg.log_interval == 0:
                # one device -> host copy for all the stats
                vals = torch.stack(list(stats.values())).cpu().numpy()
                dt = (time.perf_counter() - t_iter) / cfg.log_interval
                t_iter = time.perf_counter()
                self.recorder.update(dict(zip(stats.keys(), (float(v) for v in vals))))
                tf = self._step_flops / 1e12
                log(f"ep {epoch} it {it}/{ep_iter} lr {self._lr_sched(self.recorder.step):.3e} "
                    f"{self.recorder} {dt:.3f}s/it {tf:.3f} TFLOP/step (analytic) "
                    f"{tf / dt:.2f} TFLOP/s eta {dt * (ep_iter - it):.0f}s", 'cyan')
            if it % cfg.record_interval == 0:
                self.recorder.record()
            if save_cb is not None and save_iter > 0 and it % save_iter == 0 and it < ep_iter:
                save_cb(it)
            if ep_iter > 0 and it >= ep_iter:
                break

    def val(self, loader, evaluator=None):
        from relightableavatar_tpu_torch.models.factory import make_renderer
        renderer = make_renderer(self.cfg, self.params, self.mcfg, device=self.device)
        dumped = False
        for batch in loader:
            out = renderer.render(batch)
            if evaluator is not None:
                evaluator.evaluate(out, batch)
            if not dumped:
                self._record_val_images(out, batch)
                dumped = True
        if evaluator is not None:
            return evaluator.summarize()

    def _record_val_images(self, out, batch):
        """pred | gt side by side of the first val frame, as a PNG."""
        try:
            if 'rgb_map' not in out or 'rgb' not in batch:
                return
            H, W = int(batch.H), int(batch.W)
            mab = np.asarray(batch.mask_at_box).reshape(H, W)
            pred = np.zeros((H, W, 3), np.float32)
            pred[mab] = out.rgb_map.detach().cpu().numpy()[..., :3]
            gt = np.zeros((H, W, 3), np.float32)
            gt[mab] = np.asarray(batch.rgb)[..., :3]
            self.recorder.record_images({'val_pred_gt': np.concatenate([pred, gt], axis=1)})
        except Exception as e:  # observability must never stop training
            log(f'val image dump failed: {e}', 'yellow')
