"""The port's image metrics (``eval/metrics.py``) against the JAX
package's on seeded images, to 1e-6: PSNR, SSIM (the reference's uniform
7x7 window and the Gaussian variant), and the LPIPS formula with the
fixed-seed random features and with a weights file."""
import numpy as np
import pytest

from relightableavatar_tpu.eval import metrics as jm
from relightableavatar_tpu_torch.eval import metrics as pm

ATOL = 1e-6


def _pair(seed, shape=(40, 52, 3)):
    rng = np.random.default_rng(seed)
    gt = rng.random(shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psnr_and_ssim_match_jax(seed):
    pred, gt = _pair(seed)
    assert abs(pm.psnr(pred, gt) - jm.psnr(pred, gt)) <= ATOL
    for gw in (False, True):
        assert abs(pm.ssim(pred, gt, gaussian_weights=gw)
                   - jm.ssim(pred, gt, gaussian_weights=gw)) <= ATOL


@pytest.mark.parametrize("seed", [0, 1])
def test_lpips_rand_matches_jax(seed, monkeypatch):
    monkeypatch.delenv('RA_TPU_LPIPS_WEIGHTS', raising=False)
    pred, gt = _pair(seed, (32, 40, 3))
    assert abs(pm.lpips(pred, gt) - jm.lpips(pred, gt)) <= ATOL
    assert pm.lpips_is_exact() is jm.lpips_is_exact() is False


def test_lpips_with_a_weights_file_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "lpips.npz")
    layers = [(3, 8, True), (8, 16, False)]
    arrays = {"n_layers": np.asarray(len(layers)),
              "shift": rng.normal(0, 0.1, 3).astype(np.float32),
              "scale": (1 + rng.random(3)).astype(np.float32)}
    for i, (cin, cout, pool) in enumerate(layers):
        arrays[f"w{i}"] = rng.normal(0, 0.3, (cout, cin, 3, 3)).astype(np.float32)
        arrays[f"b{i}"] = rng.normal(0, 0.1, cout).astype(np.float32)
        arrays[f"pool{i}"] = np.asarray(pool)
        arrays[f"lin{i}"] = rng.random(cout).astype(np.float32)
    np.savez(path, **arrays)
    monkeypatch.setenv('RA_TPU_LPIPS_WEIGHTS', path)
    pred, gt = _pair(4, (24, 28, 3))
    assert pm.lpips_is_exact() and jm.lpips_is_exact()
    assert abs(pm.lpips(pred, gt) - jm.lpips(pred, gt)) <= ATOL
