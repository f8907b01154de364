"""The rank side of ``tests/test_torch_spans.py``'s collective check: what
each of W gloo ranks runs, started by ``torch.multiprocessing`` with the
spawn method.  A rank joins the group at ``127.0.0.1:<port>``, builds the
fixture's stage-1 trainer over the ray mesh (its parameters broadcast from
rank 0) and takes one step (the losses' sums and the gradients' all-reduce),
all inside ``utils/profiling.collecting()``; then it writes the span totals,
the counters and the mesh's own counts as ``rank<r>.json``.  Imports no
jax."""
import json
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from relightableavatar_tpu_torch.eval import train_check
from relightableavatar_tpu_torch.utils import profiling

B, R, S = 2, 64, 8
BUDGET = B * (R // 2) * S       # two chunks of R / 2 rays


def run_rank(rank: int, folder: str, port: int, world: int) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        cfg = train_check.step_cfg(B, S, bf16=False, perturb=True)
        cfg.n_rays = R
        cfg.tpu.grad_sample_budget = BUDGET
        with profiling.collecting():
            trainer, batch = train_check.make_step(cfg, "cpu", R)
            trainer.step(batch, 0)
        out = dict(profiling.totals(), mesh_counts=dict(trainer.mesh.counts),
                   issued_bytes=sum(n * torch.empty((), dtype=getattr(torch, dt[6:])).element_size()
                                    for _, n, dt in trainer.mesh.issued))
        with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
