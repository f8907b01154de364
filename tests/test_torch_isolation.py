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


def test_native_mesh_library_builds_from_the_ports_sources_alone():
    """The host C++ mesh library (marching tetrahedra, QEM decimation) loads
    from ``relightableavatar_tpu_torch/csrc`` with the JAX package and its
    native loader blocked, and marches and decimates a sphere."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'relightableavatar_tpu', 'relightableavatar_tpu.native'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from relightableavatar_tpu_torch.ops import marching, meshtools, native\n"
        "x = np.linspace(-1.3, 1.3, 24, dtype=np.float32)\n"
        "X, Y, Z = np.meshgrid(x, x, x, indexing='ij')\n"
        "V, F = marching.marching_tets(np.sqrt(X**2 + Y**2 + Z**2) - 1, 0.0)\n"
        "V2, F2 = meshtools.decimate(V, F, 200)\n"
        "assert len(F) > 1000 and 0 < len(F2) <= 200\n"
        "assert native._LIB is not None and native.BUILD_DIR.endswith('relightableavatar_tpu_torch/_build')\n"
        "assert not any(k.startswith('relightableavatar_tpu.') for k, v in sys.modules.items()\n"
        "               if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


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
    from relightableavatar_tpu_torch.renderer.mesh import MeshRenderer
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshRenderer(cfg, {}, AniSDFConfig.from_cfg(cfg))
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


def test_host_layer_imports_without_opencv_yaml_or_tqdm():
    """The card's machine has no OpenCV, PyYAML or tqdm: the CLI, the data
    layer, the visualizer, the evaluator, the generator, the two-stage
    pipeline, the golden 512² check and the lighting comparison import
    without them, and the config reads the YAML chain with the port's own
    reader."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'relightableavatar_tpu', 'cv2', 'yaml', 'tqdm'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('run', 'data.datasets', 'data.image_io', 'data.make_synthetic',\n"
        "          'vis.visualizer', 'eval.evaluator', 'eval.metrics', 'models.factory',\n"
        "          'config', 'renderer.mesh', 'ops.native', 'ops.marching',\n"
        "          'ops.meshtools', 'ops.point_mesh', 'train.e2e', 'eval.check_golden_512',\n"
        "          'eval.evaluate_lighting'):\n"
        "    importlib.import_module('relightableavatar_tpu_torch.' + n)\n"
        "import chip_smoke\n"
        "from relightableavatar_tpu_torch.config import setup\n"
        "cfg, args = setup(['-c', 'configs/synthetic/tubeman.yaml', '-t', 'evaluate',\n"
        "                   'relighting', 'True'])\n"
        "assert cfg.exp_name == 'tubeman_relight' and cfg.train.lr == 0.005\n"
        "assert cfg.renderer_module == 'lib.networks.renderer.sphere_tracing_renderer'\n"
        "assert not any(k in ('cv2', 'yaml', 'tqdm') for k, v in sys.modules.items()\n"
        "               if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cli_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(REPO)
    import numpy as np
    from relightableavatar_tpu_torch.config import setup
    from relightableavatar_tpu_torch.data.make_synthetic import (FIXTURE_PARAMS,
                                                                  make_dataset_tree)
    from relightableavatar_tpu_torch.models.factory import make_network

    ckpt = tmp_path / "trained_model" / "relight" / "tubeman_relight"
    os.makedirs(ckpt)
    with np.load(FIXTURE_PARAMS) as f:
        np.savez(ckpt / "latest.npz", **{"net:" + k: f[k] for k in f.files})
    cfg, _ = setup(['-c', 'configs/synthetic/tubeman.yaml', '-t', 'network', 'relighting',
                    'True', 'trained_model_dir', str(tmp_path / "trained_model")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_network(cfg)                    # device defaults to "cuda"
    assert make_network(cfg, device="cpu")[0]["sdf"]["layers"][0]["v"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dataset_tree(str(tmp_path / "data"), frames=1, views=1, size=8)
