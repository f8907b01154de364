"""The ray mesh (``relightableavatar_tpu/parallel/mesh.py``): one process a
GPU under ``torchrun``, the rays of a render block or a train chunk split
into W contiguous slices (rank r holds slice r), the parameters and the
frame context replicated, the gradients summed.  The JAX package's 1-D
device mesh with the ray axis sharded has the same layout: a sharded array
is the concatenation of its slices, so a step or a frame over W ranks
equals the single-device one.

Only collectives that both gloo (the CPU, the tests) and NCCL (the card)
have are used: ``all_gather``, ``all_reduce``, ``broadcast`` and
``barrier``.  A mesh counts the collectives it issues (``RayMesh.counts``),
so a run can show that the mesh path ran and not the plain one, and keeps
the latest :data:`ISSUED_KEEP` of their sequence (``RayMesh.issued``: op,
element count, dtype), which must be the same on every rank: a collective
that one rank skips hangs the others.  Each collective is a program span
(``mesh.all_reduce``, ``mesh.all_sum``, ``mesh.gather``, ``mesh.broadcast``)
and adds the bytes it sends to the counter ``mesh.bytes``
(``utils/profiling.py``).
"""
from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from relightableavatar_tpu_torch.utils.profiling import count, span

ISSUED_KEEP = 4096      # latest collectives kept in RayMesh.issued (a 4-card step issues ~641)


@dataclass
class RayMesh:
    """A 1-D mesh over the ranks of the default process group.  ``group``
    is None for the world-1 mesh of a process without one: its helpers
    issue no collective."""
    group: object
    rank: int
    world: int
    device: torch.device
    counts: dict = field(default_factory=lambda: {"gather": 0, "all_reduce": 0,
                                                  "broadcast": 0})
    issued: deque = field(default_factory=lambda: deque(maxlen=ISSUED_KEEP))

    def record(self, kind: str, op: str, t: torch.Tensor) -> None:
        """Count a collective of ``kind``, append (op, numel, dtype) and add
        its bytes to ``mesh.bytes``."""
        self.counts[kind] += 1
        self.issued.append((op, t.numel(), str(t.dtype)))
        count("mesh.bytes", t.numel() * t.element_size())


def distributed() -> bool:
    """True when a default process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def process_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if distributed() else 0


def node_rank_world() -> tuple:
    """(node, nodes) of this process: torchrun's ``GROUP_RANK`` and
    ``WORLD_SIZE // LOCAL_WORLD_SIZE``; (0, 1) without a process group.  A
    JAX process is a host with all its chips, so the node is what the JAX
    package's ``jax.process_index()`` and ``process_count()`` count."""
    if not distributed():
        return 0, 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    rank = int(os.environ.get("GROUP_RANK", dist.get_rank() // local))
    return rank, dist.get_world_size() // local


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if distributed():
        dist.barrier()


def get_mesh(cfg=None, n_devices: int | None = None, device=None) -> RayMesh:
    """The mesh over every rank of the default process group.

    ``cfg.tpu.mesh_shape`` [-1] means every rank; any other shape, and
    ``n_devices``, must hold exactly the world's ranks (``ValueError``
    otherwise: a 1-D ray mesh takes no subset of the processes).  Without a
    process group: a world-1 mesh on ``device`` (the CPU by default),
    issuing no collective.  ``device`` defaults under a group to the
    current CUDA device for NCCL and to the CPU for gloo."""
    world = dist.get_world_size() if distributed() else 1
    asked = []
    if cfg is not None:
        shape = [int(s) for s in cfg.tpu.mesh_shape]
        if shape != [-1]:
            asked.append(("cfg.tpu.mesh_shape", shape, int(np.prod(shape))))
    if n_devices is not None:
        asked.append(("n_devices", n_devices, int(n_devices)))
    for name, value, n in asked:
        if n != world:
            raise ValueError(
                f"{name}={value} asks for {n} ranks but the process group has {world}: "
                f"launch with torchrun --nproc_per_node {n} (and --nnodes), or set "
                "tpu.mesh_shape [-1]")
    if not distributed():
        return RayMesh(group=None, rank=0, world=1,
                       device=torch.device(device if device is not None else "cpu"))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return RayMesh(group=dist.group.WORLD, rank=dist.get_rank(), world=world,
                   device=torch.device(device))


def shard_bounds(mesh: RayMesh, n: int) -> slice:
    """This rank's contiguous slice of ``n`` rays; raises when ``n`` is not
    a multiple of the world (the caller pads first)."""
    if n % mesh.world:
        raise ValueError(f"{n} rays do not split over {mesh.world} ranks: pad to a "
                         f"multiple of {mesh.world} first (pad_to_multiple)")
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_rays(mesh: RayMesh, x, axis: int = 0):
    """This rank's contiguous slice of ``x`` (a tensor or numpy array) along
    ``axis``."""
    idx = [slice(None)] * x.ndim
    idx[axis] = shard_bounds(mesh, x.shape[axis])
    return x[tuple(idx)]


def gather_rays(mesh: RayMesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The slices of every rank concatenated in rank order along ``axis``:
    the global array whose slice this rank holds.  Every rank's ``x`` has
    the same shape.  Outside autograd."""
    if mesh.group is None:
        return x
    with span("mesh.gather"):
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x, group=mesh.group)
        mesh.record("gather", "all_gather", x)
        return torch.cat(parts, dim=axis)


def all_sum(mesh: RayMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, with the gradient of this rank's own
    part: the value is the sum (the same bits on every rank) and the
    backward passes the upstream gradient to ``x`` alone, so that the
    gradients of a loss of global sums, summed over the ranks, are the
    single-device gradient.  (``torch.distributed.nn.functional.all_reduce``
    all-reduces the gradient again in its backward, W times too large.)"""
    if mesh.group is None:
        return x
    with span("mesh.all_sum"):
        total = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=mesh.group)
        mesh.record("all_reduce", "all_reduce", total)
        return total + (x - x.detach()) if x.requires_grad else total


def all_reduce_(mesh: RayMesh, tensors: list) -> None:
    """Sum each tensor over the ranks in place, one flat all-reduce a dtype."""
    if mesh.group is None or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        with span("mesh.all_reduce"):
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=mesh.group)
            mesh.record("all_reduce", "all_reduce", flat)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def replicate(mesh: RayMesh, tensors: list) -> None:
    """Broadcast each tensor from rank 0, in place (NCCL takes contiguous
    tensors only: a strided one goes through a contiguous copy)."""
    if mesh.group is None:
        return
    with torch.no_grad():
        for t in tensors:
            with span("mesh.broadcast"):
                buf = t.data.contiguous()
                dist.broadcast(buf, src=0, group=mesh.group)
                mesh.record("broadcast", "broadcast", buf)
                if buf.data_ptr() != t.data.data_ptr():
                    t.data.copy_(buf)


def pad_to_multiple(arr: np.ndarray, m: int, axis: int = 0, value=0.0) -> np.ndarray:
    pad = (-arr.shape[axis]) % m
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=value)
