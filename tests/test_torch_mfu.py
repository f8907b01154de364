"""The port's utilizations (``utils/flops.py``: ``mfu``, ``hbm_util``,
``device_peaks``, ``rate_text``) against the JAX package's
``relightableavatar_tpu/utils/flops.py`` on the same inputs, and the peaks
the trainer's log line divides by: the H100 SXM's datasheet figures by the
card's name, none for the CPU or another card."""
import pytest
import torch

from relightableavatar_tpu.utils import flops as jflops
from relightableavatar_tpu_torch.parallel.mesh import RayMesh
from relightableavatar_tpu_torch.train.trainer import Trainer
from relightableavatar_tpu_torch.utils import flops

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("amount,seconds,peak", [
    (7.632e12, 0.5721, 989e12), (1.587e12, 0.5174, 197e12), (5.66e6, 1.48e-3, 3.35e12),
    (None, 1.0, 989e12), (0.0, 1.0, 989e12), (1e12, 0.0, 989e12), (1e12, -1.0, 3.35e12)])
def test_mfu_and_hbm_util_equal_jax(amount, seconds, peak):
    assert flops.mfu(amount, seconds, peak) == jflops.mfu(amount, seconds, peak)
    assert flops.hbm_util(amount, seconds, peak) == jflops.hbm_util(amount, seconds, peak)


def test_no_peak_gives_none():
    assert flops.mfu(1e12, 1.0, None) is None and flops.hbm_util(1e9, 1.0, None) is None


def test_device_peaks_by_card_name(monkeypatch):
    """The CPU and an unknown card have no peaks; the H100 SXM has the
    datasheet's dense bf16 rate and HBM3 bandwidth."""
    assert flops.device_peaks("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    assert flops.device_peaks("cuda:0") == dict(bf16=989e12, fp32=67e12, hbm=3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert flops.device_peaks("cuda:0") is None


def test_rate_text_prints_mfu_only_with_a_peak():
    peaks = flops.DEVICE_PEAKS[H100]
    text = flops.rate_text(7.632e12, 0.5721, peaks)
    m = jflops.mfu(7.632e12, 0.5721, 989e12)
    assert text == f"7.632 TFLOP/step (analytic) 13.34 TFLOP/s mfu {m:.1f}%" and m > 1
    assert flops.rate_text(7.632e12, 0.5721, None) == \
        "7.632 TFLOP/step (analytic) 13.34 TFLOP/s"


def test_trainer_mfu_is_over_every_card_of_the_mesh():
    """The trainer's log line counts the FLOPs of every rank's rays, so its
    MFU is over the peak of every card: a 2-rank mesh halves it, the TFLOP/s
    stay."""
    trainer = Trainer.__new__(Trainer)
    trainer.peaks, trainer.mesh = flops.DEVICE_PEAKS[H100], None
    one = trainer.rate_text(7.632e12, 0.5721)
    trainer.mesh = RayMesh(group=None, rank=0, world=2, device=torch.device("cpu"))
    two = trainer.rate_text(7.632e12, 0.5721)
    m = jflops.mfu(7.632e12, 0.5721, 989e12)
    assert one == f"7.632 TFLOP/step (analytic) 13.34 TFLOP/s mfu {m:.1f}%"
    assert two == f"7.632 TFLOP/step (analytic) 13.34 TFLOP/s mfu {m / 2:.1f}%"
    assert flops.rate_text(7.632e12, 0.5721, None, cards=2) == \
        "7.632 TFLOP/step (analytic) 13.34 TFLOP/s"
