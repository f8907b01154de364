"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and never fall back to the CPU:
asking for a card that is not there raises.  The CPU is used only when the
caller asks for it (the tests do).  In a process of a multi-GPU launch
(``config.maybe_init_distributed``), "cuda" is the process's own card,
``cuda:LOCAL_RANK``.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from relightableavatar_tpu_torch.utils.profiling import host_sync


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present.  On CUDA it also turns TF32 off for matmuls and
    convolutions: the goldens are full float32
    (``relightableavatar_tpu/eval/golden.py:81-83``), and TF32 keeps about
    three decimal digits.  Under a process group an unnumbered "cuda" is
    ``cuda:LOCAL_RANK``, made the current device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was asked for but torch finds no CUDA "
                "device; pass device='cpu' to run on the CPU")
        if dev.index is None and dist.is_available() and dist.is_initialized():
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the bfloat16 MLP path accumulates in float32, as the JAX package's
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array (numpy, a list, a CPU tensor) on ``device``.  To a card
    that is a copy from pageable memory, after which the host waits for the
    card: counted as a host sync (``utils/profiling.host_sync``)."""
    if device.type == "cuda":
        host_sync("h2d")
    return torch.as_tensor(a, dtype=dtype, device=device)
