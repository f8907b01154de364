"""The port's bfloat16 MLP path (``tpu.bf16_mlp``, ``tpu.bf16_act``) against
the JAX package's.

Layers: JAX multiplies bfloat16 operands with ``preferred_element_type=f32``;
the port on the CPU rounds the operands to bfloat16 and multiplies them in
float32, where each product is exact, so on inputs that are already
bfloat16 values only the float32 summation order differs.  Renders: a
float32 difference of one ulp ahead of a matmul can round its input to
the neighbouring bfloat16 value (a 2^-8 step), and the sphere trace turns
such steps into hit/miss changes, so frames are held by measured PSNR bars.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_fixture_scene import few_torch_threads, jax_cfg, jax_golden_bundle, jax_scene  # noqa: F401 (fixture)
from relightableavatar_tpu.ops import mlp as j_mlp
from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
from relightableavatar_tpu_torch.ops import mlp as t_mlp

RTOL = ATOL = 1e-5


def _bf16_values(seed, *shape, scale=1.0):
    """float32 arrays whose values are bfloat16 numbers."""
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16).float().numpy()


def _layers(seed, dims, skips=()):
    """Weight-normed layers of widths ``dims`` (a skip layer takes the
    input beside the hidden width)."""
    lj, lt = [], []
    for i in range(len(dims) - 1):
        I = dims[i] + (dims[0] if i in skips else 0)
        O = dims[i + 1]
        p = {"v": _bf16_values(seed + i, I, O, scale=1 / np.sqrt(I)),
             "g": np.ones(O, np.float32),
             "b": _bf16_values(seed + 50 + i, O, scale=0.1)}
        lj.append({k: jnp.asarray(v) for k, v in p.items()})
        lt.append({k: torch.as_tensor(v) for k, v in p.items()})
    return {"layers": lj}, {"layers": lt}


@pytest.mark.parametrize("bf16_act", [False, True], ids=["bf16", "bf16_act"])
@pytest.mark.parametrize("net", ["mlp_apply", "ssdf_apply", "linear_apply"])
def test_bf16_layers_match_jax(net, bf16_act):
    """Inputs are bfloat16 values; the weights are folded from weight norm
    in float32 and rounded again on both sides, so float32 outputs agree to
    the summation order (bar 1e-5).  Where a layer emits bfloat16, a sum
    that lands next to a rounding boundary can round to the neighbouring
    bfloat16 value (measured: 1 of 16448 outputs of ``linear_apply``, a
    relative step of 4.1e-3), so those cases are held at 1e-2."""
    x = _bf16_values(1, 257, 27)
    if net == "linear_apply":
        pj, pt = _layers(3, [27, 64])
        ref = j_mlp.linear_apply(pj["layers"][0], jnp.asarray(x), bf16=True, keep_bf16=bf16_act)
        got = t_mlp.linear_apply(pt["layers"][0], torch.as_tensor(x), bf16=True,
                                 keep_bf16=bf16_act)
        assert got.dtype == (torch.bfloat16 if bf16_act else torch.float32)
    elif net == "mlp_apply":
        pj, pt = _layers(5, [27] + [64] * 5 + [7], skips=(4,))
        ref = j_mlp.mlp_apply(pj, jnp.asarray(x), bf16=True, bf16_act=bf16_act)
        got = t_mlp.mlp_apply(pt, torch.as_tensor(x), bf16=True, bf16_act=bf16_act)
    else:
        dims = [27, 64, 64, 64, 64 - 27, 64, 64, 64, 64, 9]
        pj, pt = _layers(7, dims, skips=(4,))
        ref = j_mlp.ssdf_apply(pj, jnp.asarray(x), bf16=True, bf16_act=bf16_act)
        got = t_mlp.ssdf_apply(pt, torch.as_tensor(x), bf16=True, bf16_act=bf16_act)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    tol = 1e-2 if bf16_act else RTOL
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_bf16_config_flags():
    cfg = golden.fixture_cfg()
    assert not AniSDFConfig.from_cfg(cfg).bf16
    cfg.tpu.bf16_mlp = True
    cfg.tpu.bf16_act = True
    m = AniSDFConfig.from_cfg(cfg)
    assert m.bf16 and m.bf16_act


@pytest.fixture(scope="module")
def scenes():
    ctx, params, mcfg = golden.load_fixture(device="cpu")
    return (ctx, params, mcfg), jax_scene(jax_cfg())


# (flags, map -> measured PSNR bar).  Measured port vs live JAX on the
# golden bundle: bf16 rgb 48.66 dB, albedo 92.5, roughness 93.4, acc 42.95;
# bf16 + bf16_act rgb 39.16, albedo 77.4, roughness 79.4, acc 32.1.  For
# scale, the JAX package's own bf16 render against its float32 one: rgb
# 41.94 dB (bf16) and 41.08 dB (bf16_act).
BF16_CASES = {
    "bf16_mlp": (dict(bf16=True), {"rgb_map": 45.0, "albedo_map": 85.0,
                                   "roughness_map": 85.0, "acc_map": 40.0}),
    "bf16_act": (dict(bf16=True, bf16_act=True), {"rgb_map": 36.0, "albedo_map": 70.0,
                                                  "roughness_map": 70.0, "acc_map": 30.0}),
}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_golden_bundle_matches_jax(scenes, case):
    flags, bars = BF16_CASES[case]
    (ctx, params, mcfg), (jp, jm, jc) = scenes
    port = golden.render_golden_bundle(ctx, params, mcfg._replace(**flags), device="cpu")
    ref = jax_golden_bundle((jp, jm._replace(**flags), jc), {})
    assert set(port) == set(ref)
    for key, v in port.items():
        assert torch.isfinite(v).all() and v.dtype == torch.float32, key
    for key, bar in bars.items():
        p = golden.psnr(port[key].numpy(), ref[key])
        print(f"{case} {key}: {p:.2f} dB")
        assert p >= bar, (key, p)
