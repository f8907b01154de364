"""Optimiser and learning-rate schedule (``relightableavatar_tpu/train/optimizer.py``;
reference ``lib/train/optimizer.py:22-45``, ``lib/train/scheduler.py``).

Parameters are grouped by their top-level key; ``cfg.train.lr_table`` names
reference modules, mapped onto those keys by ``_NAME_MAP``, so the YAML
tables work unchanged (stage 2 nearly freezes geometry at 5e-6 that way,
``configs/base.yaml:164-168``).  Every group follows the same schedule
shape from its own base rate: a ``LambdaLR`` of the multiplier.  Gradients
are clipped as optax clips them, the global norm first, then by value.
Adam and SGD are torch's; RAdam is written out, because
``torch.optim.RAdam`` rectifies only where the SMA length exceeds 5 (optax:
at or above 5) and adds eps to sqrt(nu) before the bias correction (optax:
after it).
"""
from __future__ import annotations

import math

import torch

# reference module name -> the port's parameter key
_NAME_MAP = {
    'residual_deformation_network': 'resd',
    'signed_distance_network': 'sdf',
    'render_network': 'rgb',
    'albedo_network': 'albedo',
    'roughness_network': 'roughness',
    'global_env_map_': 'env',
}
DEFAULT_GROUP = '__default__'
OPTIMS = ('adam', 'radam', 'sgd')


def lr_multiplier(cfg):
    """step -> factor on a group's base rate: exponential, multi-step, their
    warm-up forms (the ramp multiplies the base schedule at the global step,
    reference WarmupExponentialLR / WarmupMultiStepLR), or constant 1.
    Formulas of optax's ``exponential_decay`` (rate^(step / steps)) and
    ``piecewise_constant_schedule`` (x gamma from each boundary on)."""
    node = cfg.train.scheduler
    ep_iter = max(int(cfg.ep_iter), 1)
    kind = node.get('type')
    if kind is None or kind not in ('exponential', 'multi_step', 'warmup_exponential',
                                    'warmup_multi_step'):
        return lambda step: 1.0
    base = kind.replace('warmup_', '')
    if base == 'exponential':
        gamma = float(node.get('gamma', 0.1))
        steps = int(node.get('decay_epochs', cfg.train.epoch)) * ep_iter
        after = lambda step: gamma ** (step / steps)
    else:
        milestones = [int(m) * ep_iter for m in node.get('milestones', [])]
        gamma = float(node.get('gamma', 0.5))
        after = lambda step: gamma ** sum(step >= m for m in milestones)
    if not kind.startswith('warmup_'):
        return after
    factor = float(node.get('warmup_factor', 1.0 / 3))
    warm = int(node.get('warmup_epochs', 5)) * ep_iter
    if str(node.get('warmup_method', 'linear')) == 'linear':
        def ramp(step):
            alpha = min(max(step / max(warm, 1), 0.0), 1.0)
            return factor * (1 - alpha) + alpha
    else:
        ramp = lambda step: factor if step < warm else 1.0
    return lambda step: after(step) * ramp(step)


def make_lr_schedule(cfg, base_lr: float):
    """step -> learning rate of a group whose base rate is ``base_lr``."""
    mult = lr_multiplier(cfg)
    return lambda step: base_lr * mult(step)


def lr_table(cfg) -> dict:
    """Parameter key -> base rate, from ``cfg.train.lr_table``."""
    return {_NAME_MAP.get(k, k): float(v) for k, v in dict(cfg.train.lr_table).items()}


def group_label(key: str, table: dict) -> str:
    """The group of the parameter ``key`` (``a/b/c``): its top-level key
    when the table names it, else the default group."""
    top = key.split('/')[0]
    return top if top in table else DEFAULT_GROUP


class RAdam(torch.optim.Optimizer):
    """optax's ``radam`` (``scale_by_radam``, threshold 5): moments, bias
    corrections, the rectified step where the SMA length rho_t >= 5, else
    the bias-corrected momentum; coupled weight decay.  The step's scalars
    (b^t, rho_t, the rectification) are computed in float64; optax takes
    them in the parameters' dtype, where 1 - b2^t loses digits."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                if group['weight_decay']:
                    g = g + group['weight_decay'] * p
                st = self.state[p]
                if not st:
                    st['step'] = 0
                    st['mu'] = torch.zeros_like(p)
                    st['nu'] = torch.zeros_like(p)
                st['mu'].mul_(b1).add_((1 - b1) * g)
                st['nu'].mul_(b2).add_((1 - b2) * g * g)
                st['step'] += 1
                t = st['step']
                b2t = b2 ** t
                ro = ro_inf - 2 * t * b2t / (1 - b2t)
                mu_hat = st['mu'] / (1 - b1 ** t)
                if ro >= group['threshold']:
                    nu_hat = st['nu'] / (1 - b2t)
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    upd = r * mu_hat / (torch.sqrt(nu_hat) + group['eps'])
                else:
                    upd = mu_hat
                p.sub_(group['lr'] * upd)


class TrainOptimizer:
    """The torch optimiser over named parameter groups, its ``LambdaLR`` and
    the clipping of ``cfg.clip_grad_norm`` and ``cfg.clip_grad_value``.
    ``named`` is the flat (key, tensor) list of the parameters."""

    def __init__(self, cfg, named: list):
        self.optim = str(cfg.train.get('optim', 'adam'))
        if self.optim not in OPTIMS:
            raise ValueError(
                f"cfg.train.optim={self.optim!r} is not supported; choose one of "
                "'adam', 'radam', 'sgd' (reference lib/train/optimizer.py:9-13)")
        base_lr = float(cfg.train.lr)
        eps = float(cfg.train.eps)
        wd = float(cfg.train.weight_decay)
        table = lr_table(cfg)
        groups: dict = {}
        for key, t in named:
            groups.setdefault(group_label(key, table), []).append(t)
        self.labels = list(groups)
        pgroups = [dict(params=groups[lb], lr=table.get(lb, base_lr), label=lb)
                   for lb in self.labels]
        if self.optim == 'sgd':     # the JAX package applies no weight decay to SGD
            self.opt = torch.optim.SGD(pgroups, lr=base_lr, momentum=0.9)
        elif self.optim == 'adam':
            self.opt = torch.optim.Adam(pgroups, lr=base_lr, eps=eps, weight_decay=wd,
                                        foreach=False)
        else:
            self.opt = RAdam(pgroups, lr=base_lr, eps=eps, weight_decay=wd)
        mult = lr_multiplier(cfg)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.opt, [mult] * len(pgroups))
        self.clip_norm = float(cfg.clip_grad_norm)
        self.clip_value = float(cfg.clip_grad_value)
        self.named = list(named)

    def clip_(self) -> torch.Tensor:
        """Clip the gradients in place as ``optax.chain(clip_by_global_norm,
        clip)`` does: where ||g|| >= c, g / ||g|| * c (no epsilon), then into
        [-v, v]; no host sync.  Returns the global norm before clipping."""
        grads = [t.grad for _, t in self.named if t.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
            g.clamp_(-self.clip_value, self.clip_value)
        return norm

    def step(self) -> None:
        self.clip_()
        self.opt.step()
        self.sched.step()

    @property
    def count(self) -> int:
        """Updates applied so far (the schedule's step)."""
        return int(self.sched.last_epoch)

    def lr(self, label: str = DEFAULT_GROUP) -> float:
        for g in self.opt.param_groups:
            if g['label'] == label:
                return float(g['lr'])
        return float(self.opt.param_groups[0]['lr'])
