"""Training-run exclusivity (``relightableavatar_tpu/utils/preempt.py``).

The JAX package's TPU link serves one client at a time, so its entry points
stop a running training group before they touch the device.  A CUDA card
serves many processes: both calls are logged no-ops.
"""
from __future__ import annotations

from relightableavatar_tpu_torch.utils.log import log


def register_training_group() -> None:
    log("register_training_group: no-op (a CUDA card serves many processes)", "yellow")


def preempt_training() -> bool:
    """Never stops anything; returns False (nothing was preempted)."""
    log("preempt_training: no-op (a CUDA card serves many processes)", "yellow")
    return False
