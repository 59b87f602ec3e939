"""The port stands alone: nothing under ``fami_pose_torch/`` nor
``chip_smoke.py`` imports JAX, flax, optax or the JAX package; the package
imports on a machine without ``triton`` or ``nvcc``; its entry points run on
the card unless asked otherwise."""

import ast
import inspect
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fami_pose_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "fami_pose_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    files = _port_files()
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert len(files) > 15


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_imports_without_triton_or_nvcc(tmp_path):
    """Import every port module in a fresh interpreter whose PATH has no
    nvcc and in which ``triton`` cannot be imported; nothing gets built."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['triton'] = None\n"
        "import fami_pose_torch\n"
        "for m in pkgutil.walk_packages(fami_pose_torch.__path__, "
        "'fami_pose_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'fami_pose_tpu') "
        "for k in sys.modules), 'the port pulled in JAX'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda():
    from fami_pose_torch.demo import parse_args
    from fami_pose_torch.engine.predictor import PosePredictor

    sig = inspect.signature(PosePredictor.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert parse_args(["--cfg", "c", "--frames", "f"]).device == "cuda"


def test_cuda_build_needs_nvcc(tmp_path, monkeypatch):
    """Where there is no nvcc the build raises with a clear message (and
    only the CUDA branch of a wrapper ever asks for it)."""
    from fami_pose_torch.ops.cuda import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
