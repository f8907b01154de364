"""Render bench.py's headline frame through the JAX package on the CPU and
store it as ``tests/golden_relight_512_jaxcpu.npy``:

    JAX_PLATFORMS=cpu python tests/make_golden_512_jaxcpu.py [--out PATH]

The frame is ``scripts/check_golden_512.py:render`` (bench.py's
``_setup``, ``make_cfg(relight=True)``, ``n_samples`` 3,
``_accel_knobs(on=True)``, the rays of ``bench._rays(ctx, 512, 512)``
scattered into the full frame, clipped to [0, 1]), stored as uint16 RGB
(``round(x * 65535)``, 512 x 512 x 3, 1.5 MiB).  It prints the render's
PSNR against ``fixtures/golden_relight_512.png``, the JAX package's stored
golden of the same frame, so that the two references can be compared.
About 40 minutes and 10 GiB on the CPU.  The port's
``eval/check_golden_512.py`` holds the port's render to the file.
"""
import argparse
import importlib.util
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, 'tests', 'golden_relight_512_jaxcpu.npy')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=OUT)
    a = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        'check_golden_512', os.path.join(REPO, 'scripts', 'check_golden_512.py'))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    t0 = time.perf_counter()
    img = script.render()
    import jax

    from relightableavatar_tpu_torch.data.image_io import read_png
    ref = read_png(script.GOLDEN).astype(np.float32) / 65535.0
    mse = float(((img.astype(np.float64) - ref) ** 2).mean())
    print(f'JAX on {jax.devices()[0].platform}: {time.perf_counter() - t0:.1f} s; PSNR '
          f'{-10 * np.log10(mse + 1e-12):.2f} dB against {os.path.relpath(script.GOLDEN, REPO)}')
    np.save(a.out, np.round(img * 65535.0).astype(np.uint16))
    print(f'wrote {a.out}')


if __name__ == '__main__':
    main()
