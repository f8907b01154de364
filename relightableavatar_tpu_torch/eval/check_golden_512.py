"""Hold the port's 512x512 render of bench.py's headline frame to the
JAX package's references (counterpart of ``scripts/check_golden_512.py``):

    python -m relightableavatar_tpu_torch.eval.check_golden_512

The frame: fixture motion frame 0, camera 0 of ``make_cameras(4, 512, 512)``,
the rays that meet the body's world bounds (``golden.frame_batch``, as
``bench._rays`` builds them) through ``SphereTracingRenderer.render`` at
``golden.golden512_cfg()`` (the acceleration stack, exact camera trace,
bfloat16 MLPs); their rgb scattered back into the full frame and clipped
to [0, 1].  It is compared by PSNR over the whole frame with the JAX
package's CPU render of the frame at HEAD, ``tests/golden_relight_512_jaxcpu.npy``
(``tests/make_golden_512_jaxcpu.py``), and passes above ``MIN_PSNR``
(45 dB, the JAX script's bar), exiting 1 otherwise.  It also prints the PSNR
against ``fixtures/golden_relight_512.png``, the golden the JAX script
holds: that file is stale against the JAX package at HEAD (the package's
own CPU render is 41.75 dB from it), so it is reported, not held.  The
port never writes ``fixtures/``: there is no ``--regen``.  Runs on the card
unless ``device`` says otherwise.
"""
from __future__ import annotations

import os
import time

import numpy as np

from relightableavatar_tpu_torch.eval import golden

MIN_PSNR = 45.0


def render(device="cuda") -> np.ndarray:
    """(512, 512, 3) float32 in [0, 1]: the headline frame, background 0."""
    import torch

    from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
    cfg = golden.golden512_cfg()
    ctx, params, mcfg = golden.load_fixture(cfg, device=device)
    mcfg = mcfg._replace(bf16=True)                     # bench.py's make_params
    size = golden.FRAME_SIZE
    batch, mab = golden.frame_batch(ctx, size, size)
    with torch.no_grad():
        out = SphereTracingRenderer(cfg, params, mcfg, device=device).render(batch)
    img = np.zeros((size * size, 3), np.float32)
    img[mab] = out.rgb_map.float().cpu().numpy()[:int(mab.sum()), :3]
    return np.clip(img.reshape(size, size, 3), 0, 1)


def main():
    t0 = time.perf_counter()
    img = render()
    ok, p = golden.check_golden(img, golden.GOLDEN_RELIGHT_512_JAXCPU, MIN_PSNR)
    _, p_png = golden.check_golden(img, golden.GOLDEN_RELIGHT_512, MIN_PSNR)
    print(f'golden 512: PSNR {p:.2f} dB vs '
          f'{os.path.relpath(golden.GOLDEN_RELIGHT_512_JAXCPU, golden.REPO)} -> '
          f'{"OK" if ok else "DRIFT"}; {p_png:.2f} dB vs the stored '
          f'{os.path.relpath(golden.GOLDEN_RELIGHT_512, golden.REPO)} (not held) '
          f'({time.perf_counter() - t0:.1f} s)')
    if not ok:
        raise SystemExit(1)


if __name__ == '__main__':
    main()
