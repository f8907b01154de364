"""Parameters carried across from the JAX package's flat npz layout
(``relightableavatar_tpu/train/checkpoints.py:23-66``): keys are pytree paths
such as ``sdf/layers/3/v``; linear weights are stored (in, out) and
weight-normed layers keep their ``g``/``v`` form.  :func:`load_model` reads
the checkpoints that the JAX package's ``save_model`` writes
(``train/checkpoints.py:72-131``); the port's own training checkpoints
and the ``.pth`` importer are in ``train/checkpoints.py``.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from relightableavatar_tpu_torch.device import resolve_device
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops.embedder import embed_dim


def _mlp_shapes(prefix, input_ch, W, D, out_ch, skips=(4,)):
    shapes = {}
    for i in range(D + 1):
        d_in = input_ch if i == 0 else W
        if i in skips:
            d_in = input_ch + W
        d_out = out_ch if i == D else W
        shapes[f"{prefix}/layers/{i}/w"] = (d_in, d_out)
        shapes[f"{prefix}/layers/{i}/b"] = (d_out,)
    return shapes


def _wn_shapes(prefix, d_in, d_out):
    return {f"{prefix}/v": (d_in, d_out), f"{prefix}/g": (d_out,),
            f"{prefix}/b": (d_out,)}


def param_shapes(mcfg: AniSDFConfig) -> dict:
    """Flat key -> shape of every parameter of the network ``mcfg`` names
    (the layout of ``relightableavatar_tpu/models/anisdf.py:init_anisdf``;
    under ``e_type='hash'`` the encoders' flat (L, T*F) tables ``resd_hash``
    and ``sdf_hash``)."""
    if mcfg.e_type == 'hash':
        hcfg = mcfg.hash_cfg()
        resd_in = sdf_in = hcfg.out_dim
    else:
        resd_in = embed_dim(3, mcfg.xyz_res)
        sdf_in = embed_dim(3, mcfg.sdf_res)
    shapes = _mlp_shapes("resd", resd_in + mcfg.cond_dim, 256, 8, 3)
    # SphereSignedDistanceField: the layer before the skip emits W - d_in
    dims = [sdf_in] + [256] * 8 + [1 + mcfg.feat_dim]
    for i in range(len(dims) - 1):
        d_out = dims[i + 1] - dims[0] if i + 1 == 4 else dims[i + 1]
        shapes.update(_wn_shapes(f"sdf/layers/{i}", dims[i], d_out))
    shapes["beta"] = ()
    if mcfg.e_type == 'hash':
        for key in ("resd_hash", "sdf_hash"):
            shapes[key] = (hcfg.n_levels, hcfg.table_size * hcfg.n_features)
    rgb_in = 3 + mcfg.feat_dim + embed_dim(3, mcfg.view_res)
    for i, (d_in, d_out) in enumerate([(rgb_in, 256), (256, 256), (256, 256),
                                       (256 + mcfg.cond_dim, 256), (256, 3)]):
        shapes.update(_wn_shapes(f"rgb/l{i}", d_in, d_out))
    if mcfg.relight:
        shapes.update(_mlp_shapes("albedo", mcfg.feat_dim, mcfg.relight_width,
                                  mcfg.relight_depth, 3))
        shapes.update(_mlp_shapes("roughness", mcfg.feat_dim, mcfg.relight_width,
                                  mcfg.relight_depth, 1))
        shapes["env"] = (mcfg.env_h * mcfg.envmap_upscale,
                         mcfg.env_w * mcfg.envmap_upscale,
                         1 if mcfg.achro_light else 3)
    return shapes


def params_from_flat(flat: dict, device="cuda",
                     mcfg: AniSDFConfig | None = None) -> dict:
    """Flat ``"a/b/c"``-keyed arrays -> nested parameter dict of float32
    tensors on ``device`` (numeric path parts become list positions).
    ``mcfg`` defaults to the relight network of the fixture avatar.  A
    stage-1 ``mcfg`` (``relight=False``) leaves out the relight heads
    (``albedo``, ``roughness``, ``env``) of a stage-2 checkpoint, as the JAX
    package's template load does.  Raises on a missing key, an unknown key
    or a shape mismatch."""
    dev = resolve_device(device)
    if mcfg is None:
        mcfg = AniSDFConfig(relight=True)
    expected = param_shapes(mcfg)
    if not mcfg.relight:
        relight_only = set(param_shapes(mcfg._replace(relight=True))) - set(expected)
        flat = {k: v for k, v in flat.items() if k not in relight_only}
    missing = sorted(set(expected) - set(flat))
    unknown = sorted(set(flat) - set(expected))
    if missing:
        raise KeyError(f"missing parameters: {missing}")
    if unknown:
        raise KeyError(f"unknown parameters: {unknown}")
    params: dict = {}
    for key in sorted(expected):
        arr = np.asarray(flat[key])
        if arr.shape != expected[key]:
            raise ValueError(f"shape mismatch for {key}: got {arr.shape}, "
                             f"expected {expected[key]}")
        *path, leaf = key.split("/")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.as_tensor(arr.astype(np.float32), device=dev)
    # "layers" dicts keyed "0".."8" become lists
    for net in params.values():
        if isinstance(net, dict) and "layers" in net:
            net["layers"] = [net["layers"][str(i)] for i in range(len(net["layers"]))]
    return params


def load_params(path: str, device="cuda", mcfg: AniSDFConfig | None = None) -> dict:
    """:func:`params_from_flat` of an npz file."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    return params_from_flat(flat, device=device, mcfg=mcfg)


def checkpoint_path(model_dir: str, epoch: int = -1) -> str | None:
    """``latest.npz`` (epoch -1), else ``<epoch>.npz`` when there, else the
    newest epoch file; None when the folder holds none."""
    if not os.path.isdir(model_dir):
        return None
    if epoch == -1 and os.path.exists(os.path.join(model_dir, "latest.npz")):
        return os.path.join(model_dir, "latest.npz")
    eps = sorted(int(m.group(1)) for f in os.listdir(model_dir)
                 if (m := re.match(r"^(\d+)\.npz$", f)))
    if not eps:
        return None
    return os.path.join(model_dir, f"{epoch if epoch in eps else eps[-1]}.npz")


def read_checkpoint(model_dir: str, epoch: int = -1):
    """The flat parameters, epoch and aux dict of the newest npz checkpoint
    in ``model_dir`` (``latest.npz``, else the highest ``<epoch>.npz``, or
    ``<epoch>.npz`` when it is there), written by the JAX package's
    ``save_model``: parameter keys carry a ``net:`` prefix, ``epoch`` is a
    scalar and ``aux`` a JSON string (``train/checkpoints.py:101-131``).
    Returns (None, 0, {}) when there is none."""
    path = checkpoint_path(model_dir, epoch)
    if path is None:
        return None, 0, {}
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    loaded_epoch = int(flat.pop("epoch", 0))
    aux = json.loads(str(flat.pop("aux"))) if "aux" in flat else {}
    net = {k.split(":", 1)[1]: v for k, v in flat.items() if k.startswith("net:")}
    return net, loaded_epoch, aux


def load_model(model_dir: str, mcfg: AniSDFConfig, device="cuda", epoch: int = -1):
    """(params, epoch, aux) of the newest npz checkpoint in ``model_dir``
    (:func:`read_checkpoint`, then :func:`params_from_flat`), or
    (None, 0, {}) when there is none."""
    flat, loaded_epoch, aux = read_checkpoint(model_dir, epoch)
    if flat is None:
        return None, 0, {}
    return params_from_flat(flat, device=device, mcfg=mcfg), loaded_epoch, aux
