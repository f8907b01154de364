"""Counts and numerics of the stage-2 train step on the CPU, behind the
predictions and the bfloat16 bar of ``chip_smoke.py``'s ``[train-relight]``.

    python -m relightableavatar_tpu_torch.eval.relight_cpu [count] [spread]

``count``: one float32 reference stage-2 step (``train_check.relight_step_cfg``,
2 frames x 1024 rays) on the CPU: the rays a frame whose trace hits, the KNN
calls of the step by point count (each is one K1 launch on the card), the
shadow rays traced and the analytic TFLOP of the step (``utils/flops.py``).
Several minutes on the CPU.

``spread``: the small bf16 check step of ``[train-relight]``
(``train_check.make_relight_check``, the residual MLP's last weight
re-drawn) twice on the CPU: as the port computes it, and with the float32
sums of the bfloat16 products taken in float64 and rounded to float32 (at
most one ulp a sum: another summation order, as another device has).
Prints the worst per-tensor and every per-sub-network cosine of the two
steps' gradients, and how far that moves the inference render's surface
points and normals of the check's first frame.
"""
from __future__ import annotations

import collections
import sys

import torch

from relightableavatar_tpu_torch.eval import train_check
from relightableavatar_tpu_torch.models import anisdf
from relightableavatar_tpu_torch.ops import mlp
from relightableavatar_tpu_torch.renderer.sphere_tracing import render_human_block


def count() -> None:
    cfg = train_check.relight_step_cfg(bf16=False)
    trainer, batch = train_check.make_step(cfg, "cpu", train_check.RELIGHT_R)
    print("rays a frame that hit:", train_check.ray_hits(trainer, batch).sum(1).tolist())
    calls = collections.Counter()
    dispatch = anisdf.knn_top3

    def counting(pts, verts):
        calls[pts.shape[0]] += 1
        return dispatch(pts, verts)

    anisdf.knn_top3 = counting
    try:
        trainer.step(batch, 0)
    finally:
        anisdf.knn_top3 = dispatch
    print(f"KNN calls a step: {sum(calls.values())} by points {sorted(calls.items())}; "
          f"shadow rays {trainer.shadow_rays}; {trainer.step_flops(batch) / 1e12:.3f} TFLOP "
          "(analytic)")


def _bf16_matmul_f64_sums(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``ops/mlp.py:_bf16_matmul`` with its sums taken in float64 and rounded
    to float32; the gradient is the port's own."""
    xb = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
    wb = w.to(torch.bfloat16)
    y = xb.float() @ wb.float()
    y = (xb.double() @ wb.double()).float().detach() + (y - y.detach())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def spread() -> None:
    port = mlp._bf16_matmul
    res, maps = {}, {}
    for name, fn in (("port", port), ("float64 sums", _bf16_matmul_f64_sums)):
        mlp._bf16_matmul = fn
        try:
            cfg = train_check.relight_step_cfg(bf16=True)
            trainer, batch, jitter = train_check.make_relight_check(cfg, "cpu")
            train_check.live_residual(trainer)
            with torch.no_grad():
                maps[name] = render_human_block(
                    trainer.params, trainer.mcfg, batch.ctx[0], batch.ray_o[0], batch.ray_d[0],
                    batch.near[0], batch.far[0], torch.ones(4, 8, 3), *trainer.lights,
                    trainer.st_surf, trainer.st_obj, trainer.rcfg)
            res[name] = train_check.step_result(trainer, batch, jitter)
        finally:
            mlp._bf16_matmul = port
    cmp = train_check.compare_grads(res["float64 sums"], res["port"])
    worst = sorted((v[1], k) for k, v in cmp.items()
                   if not k.startswith("rgb/") and not k.endswith(("/b", "beta")))
    print("worst tensor cosines:", ", ".join(f"{k} {c:.6f}" for c, k in worst[:6]))
    print("sub-network cosines:", {n: round(c, 6) for n, c in
                                   train_check.compare_nets(res["float64 sums"],
                                                            res["port"]).items()})
    for key in ("surf_map", "norm_map"):
        d = (maps["port"][key] - maps["float64 sums"][key]).abs().amax(dim=-1)
        print(f"{key}: {int((d > 1e-4).sum())} of {d.numel()} rays moved by more than 1e-4, "
              f"at most {float(d.max()):.3e}")


if __name__ == "__main__":
    torch.set_num_threads(max(torch.get_num_threads(), 1))
    for arg in sys.argv[1:] or ["count", "spread"]:
        {"count": count, "spread": spread}[arg]()
