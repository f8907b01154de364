"""How far the small option frames' maps move on the CPU alone when the
network's weights move by one part in 1e7, behind the ``spec_map`` bar of
``chip_smoke.py``'s ``[options]`` (card against CPU).

    python -m relightableavatar_tpu_torch.eval.options_cpu [--seeds N]

Each entry of ``golden.OPTION_CHECKS`` is rendered as its ``CHECK_SIZE``
squared frame (``golden.option_check_cfg``) with the fixture's weights (the
hash network of ``golden.hash_params`` under ``e_type='hash'``), then again
with every weight times (1 + 1e-7 z), z ~ N(0, 1) from a seeded generator,
N times.  Prints, for each, ``spec_map``'s largest change relative to a
pixel's value (max |diff| / max(|value|, 1)) and its PSNR, and the worst
PSNR of the other maps.  About a minute.
"""
from __future__ import annotations

import argparse

import torch

from relightableavatar_tpu_torch.eval import golden
from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer

REL_STEP = 1e-7


def _perturb(tree, gen: torch.Generator):
    if isinstance(tree, dict):
        return {k: _perturb(v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, gen) for v in tree]
    return tree * (1 + REL_STEP * torch.randn(tree.shape, generator=gen))


def spec_spread(seeds: int = 3) -> None:
    for name, opts in golden.OPTION_CHECKS:
        cfg = golden.option_check_cfg(opts)
        ctx, params, mcfg = golden.load_check_network(cfg, device="cpu")
        batch, _ = golden.frame_batch(ctx, golden.CHECK_SIZE, golden.CHECK_SIZE)
        render = lambda p: {k: v.numpy() for k, v in SphereTracingRenderer(
            cfg, p, mcfg, device="cpu").render(batch).items() if isinstance(v, torch.Tensor)}
        base = render(params)
        rows = []
        for seed in range(seeds):
            moved = render(_perturb(params, torch.Generator().manual_seed(seed)))
            spec = float((abs(moved["spec_map"] - base["spec_map"])
                          / abs(base["spec_map"]).clip(min=1)).max())
            worst = min(golden.psnr(moved[k], base[k]) for k in base if k != "spec_map")
            rows.append(f"spec_map {spec:.3e} ({golden.psnr(moved['spec_map'], base['spec_map']):.1f}"
                        f" dB), other maps >= {worst:.1f} dB")
        print(f"{name}: " + "; ".join(rows), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3, help="perturbations a frame")
    spec_spread(ap.parse_args().seeds)


if __name__ == "__main__":
    main()
