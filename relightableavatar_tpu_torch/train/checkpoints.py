"""Checkpoints of training (``relightableavatar_tpu/train/checkpoints.py``;
reference ``lib/utils/net_utils.py:1386-1584``): epoch-numbered files and
``latest``, garbage collection of old epochs, atomic writes, an ``aux`` JSON
of the training state, and the import of reference PyTorch ``.pth``
checkpoints.

Format: one flat npz.  ``epoch`` is a scalar, ``aux`` a JSON string,
``net:<key>`` the parameters under the JAX package's keys (``sdf/layers/3/v``,
linear weights (in, out)), so either package reads the other's network.
The ``opt:`` block is the port's own: ``opt:__optim__`` names the torch
optimiser, ``opt:__count__`` the updates applied (the schedule's step), and
``opt:<key>/<state>`` each parameter's optimiser state.  The JAX package's
``opt:`` block (optax's state) cannot become a torch optimiser's: resuming
from one raises instead of restarting Adam's moments unnoticed.
"""
from __future__ import annotations

import json
import os
import re
from os.path import join

import numpy as np
import torch

from relightableavatar_tpu_torch.utils.log import log
from relightableavatar_tpu_torch.weights import checkpoint_path, params_from_flat


def named_params(params: dict, prefix: str = "") -> list:
    """(key, tensor) of every parameter, keyed as the JAX package's flat
    checkpoints are (dict keys and list positions joined by ``/``)."""
    out = []
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.extend(named_params(v, key + "/"))
        else:
            out.append((key, v))
    return out


def _atomic_savez(path: str, flat: dict) -> None:
    """Write to a temporary file, then ``os.replace``: a reader never sees a
    half-written npz, and a crash mid-save leaves the previous file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_params(params: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _atomic_savez(path, {k: _np(v) for k, v in named_params(params)})


def optimizer_flat(opt) -> dict:
    """The ``opt:`` block (without the prefix) of a :class:`TrainOptimizer`."""
    flat = {"__optim__": np.asarray(opt.optim), "__count__": np.asarray(opt.count)}
    keys = {id(t): k for k, t in opt.named}
    for group in opt.opt.param_groups:
        for p in group["params"]:
            for name, val in opt.opt.state.get(p, {}).items():
                flat[f"{keys[id(p)]}/{name}"] = _np(val) if torch.is_tensor(val) \
                    else np.asarray(val)
    return flat


def load_optimizer_flat(opt, flat: dict) -> None:
    """Restore :func:`optimizer_flat`'s block into ``opt`` (same parameter
    keys and optimiser); raises on a block that is not the port's."""
    if "__optim__" not in flat:
        raise ValueError(
            "the checkpoint's opt: block is not the port's (no opt:__optim__; the JAX "
            "package writes optax's state there): its optimiser state cannot be resumed. "
            "Start a new run (resume False) or load only its network (save_params)")
    if str(flat["__optim__"]) != opt.optim:
        raise ValueError(f"the checkpoint's optimiser is {str(flat['__optim__'])!r}, "
                         f"the config asks for {opt.optim!r}")
    tensors = dict(opt.named)
    state = {}
    for key, arr in flat.items():
        if key.startswith("__"):
            continue
        pkey, name = key.rsplit("/", 1)
        if pkey not in tensors:
            raise KeyError(f"optimiser state for an unknown parameter: {pkey}")
        p = tensors[pkey]
        if name == "step" and opt.optim == "adam":     # torch keeps Adam's step on the CPU
            val = torch.as_tensor(arr)
        elif arr.ndim == 0 and not np.issubdtype(arr.dtype, np.floating):
            val = int(arr)
        else:
            val = torch.as_tensor(arr, device=p.device)
        state.setdefault(p, {})[name] = val
    opt.opt.state.clear()
    opt.opt.state.update(state)
    count = int(flat["__count__"])
    opt.sched.last_epoch = count
    for group, base in zip(opt.opt.param_groups, opt.sched.base_lrs):
        group["lr"] = base * opt.sched.lr_lambdas[0](count)


def save_model(model_dir: str, params: dict, opt, epoch: int, latest: bool = True,
               keep: int = 20, aux: dict | None = None) -> None:
    """Write ``latest.npz`` and ``<epoch>.npz`` (``latest``) or only
    ``<epoch>.npz``, and keep the newest ``keep`` epoch files
    (net_utils.py:1463-1492).  ``opt`` (a TrainOptimizer) may be None."""
    os.makedirs(model_dir, exist_ok=True)
    flat = {"epoch": np.asarray(epoch)}
    if aux is not None:
        flat["aux"] = np.asarray(json.dumps(aux))
    for k, v in named_params(params):
        flat[f"net:{k}"] = _np(v)
    if opt is not None:
        for k, v in optimizer_flat(opt).items():
            flat[f"opt:{k}"] = v
    _atomic_savez(join(model_dir, "latest.npz" if latest else f"{epoch}.npz"), flat)
    if not latest:
        return
    _atomic_savez(join(model_dir, f"{epoch}.npz"), flat)
    eps = sorted(int(m.group(1)) for f in os.listdir(model_dir)
                 if (m := re.match(r"^(\d+)\.npz$", f)))
    for e in eps[:-keep]:
        os.remove(join(model_dir, f"{e}.npz"))


def load_model(model_dir: str, params: dict, opt=None, epoch: int = -1):
    """Copy the newest checkpoint of ``model_dir`` into ``params`` (in place,
    so an optimiser over them stays valid) and, when ``opt`` is given, into
    its state.  Returns (True, epoch, aux), or (False, 0, {}) when there is
    no checkpoint.  Raises on a missing, unknown or misshapen parameter and
    on an ``opt:`` block that is not the port's."""
    path = checkpoint_path(model_dir, epoch)
    if path is None:
        return False, 0, {}
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    loaded_epoch = int(flat.pop("epoch", 0))
    aux = json.loads(str(flat.pop("aux"))) if "aux" in flat else {}
    net = {k[4:]: v for k, v in flat.items() if k.startswith("net:")}
    mine = dict(named_params(params))
    if set(net) != set(mine):
        raise KeyError(f"{path}: missing {sorted(set(mine) - set(net))[:4]}, "
                       f"unknown {sorted(set(net) - set(mine))[:4]}")
    with torch.no_grad():
        for k, t in mine.items():
            if tuple(net[k].shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {k}: checkpoint {net[k].shape} vs "
                                 f"model {tuple(t.shape)}")
            t.copy_(torch.as_tensor(net[k]))
    if opt is not None:
        ob = {k[4:]: v for k, v in flat.items() if k.startswith("opt:")}
        if ob:
            load_optimizer_flat(opt, ob)
    log(f"loaded checkpoint {path} (epoch {loaded_epoch})", "green")
    return True, loaded_epoch, aux


# -------------------------------------------------------------- torch import
def pth_to_flat(path: str) -> dict:
    """A reference PyTorch ``latest.pth`` as flat JAX-layout arrays:

      residual_deformation_network.mlp.linears.{i} -> resd/layers/{i}
      signed_distance_network.mlp.lin{l} (weight norm _g/_v) -> sdf/layers/{l}
      signed_distance_network._beta -> beta
      render_network.l{i} (weight norm) -> rgb/l{i}
      albedo_network.mlp.linears.{i} -> albedo/layers/{i}
      roughness_network.mlp.linears.{i} -> roughness/layers/{i}
      global_env_map_ -> env

    torch's Linear stores (out, in), the port (in, out); weight norm's
    weight_g (O, 1) and weight_v (O, I) become g (O,) and v (I, O)."""
    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("net", ckpt)
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
    flat = {}

    def put_linear(dst, w_key, b_key, weight_norm=False):
        if weight_norm:
            flat[f"{dst}/g"] = sd[w_key + "_g"].reshape(-1)
            flat[f"{dst}/v"] = sd[w_key + "_v"].T
        else:
            flat[f"{dst}/w"] = sd[w_key].T
        flat[f"{dst}/b"] = sd[b_key]

    for k in list(sd):
        m = re.match(r"residual_deformation_network\.mlp\.linears\.(\d+)\.weight$", k)
        if m:
            pre = f"residual_deformation_network.mlp.linears.{m.group(1)}"
            put_linear(f"resd/layers/{m.group(1)}", pre + ".weight", pre + ".bias")
        m = re.match(r"signed_distance_network\.mlp\.lin(\d+)\.weight_g$", k)
        if m:
            pre = f"signed_distance_network.mlp.lin{m.group(1)}"
            put_linear(f"sdf/layers/{m.group(1)}", pre + ".weight", pre + ".bias",
                       weight_norm=True)
        m = re.match(r"render_network\.l(\d+)\.weight_g$", k)
        if m:
            pre = f"render_network.l{m.group(1)}"
            put_linear(f"rgb/l{m.group(1)}", pre + ".weight", pre + ".bias", weight_norm=True)
        for head in ("albedo", "roughness"):
            m = re.match(rf"{head}_network\.mlp\.linears\.(\d+)\.weight$", k)
            if m:
                pre = f"{head}_network.mlp.linears.{m.group(1)}"
                put_linear(f"{head}/layers/{m.group(1)}", pre + ".weight", pre + ".bias")
    if "signed_distance_network._beta" in sd:
        flat["beta"] = np.asarray(sd["signed_distance_network._beta"]).reshape(())
    if "global_env_map_" in sd:
        flat["env"] = sd["global_env_map_"]
    return flat


def load_torch_pth(path: str, mcfg, device="cuda") -> dict:
    """:func:`pth_to_flat`, then the port's parameter dict of ``mcfg``."""
    return params_from_flat(pth_to_flat(path), device=device, mcfg=mcfg)
