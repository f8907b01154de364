"""The port stands alone: it imports neither JAX nor the JAX package, and
its CUDA entry points raise instead of running on the CPU when no card is
present."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "relightableavatar_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "relightableavatar_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


def test_imports_with_jax_and_jax_package_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'relightableavatar_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import relightableavatar_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'relightableavatar_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


def test_yaml_is_not_imported_by_the_package():
    code = ("import sys\nsys.modules['yaml'] = None\n"
            "import relightableavatar_tpu_torch.config as c\n"
            "cfg = c.make_cfg(opts=['relighting', 'True'])\n"
            "assert cfg.relighting is True\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from relightableavatar_tpu_torch.device import resolve_device
    from relightableavatar_tpu_torch.eval.golden import fixture_cfg, load_fixture
    from relightableavatar_tpu_torch.models.anisdf import AniSDFConfig
    from relightableavatar_tpu_torch.ops.knn_cuda import knn_top3_cuda
    from relightableavatar_tpu_torch.renderer.orchestrate import SphereTracingRenderer
    from relightableavatar_tpu_torch.weights import params_from_flat

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_fixture()                       # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_flat({})
    cfg = fixture_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SphereTracingRenderer(cfg, {}, AniSDFConfig.from_cfg(cfg))
    with pytest.raises(ValueError, match="CUDA"):
        knn_top3_cuda(torch.zeros((4, 3)), torch.zeros((4, 3)))
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the rest of the repo, the smoke
    cannot import the port and exits non-zero with no result."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_bytes(open(src, "rb").read())
    proc = subprocess.run([sys.executable, str(dst)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
