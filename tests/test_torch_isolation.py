"""The port stands alone: nothing under ``fami_pose_torch/`` nor
``chip_smoke.py`` imports JAX, flax, optax or the JAX package; the package
imports on a machine without ``triton`` or ``nvcc``; its entry points run on
the card unless asked otherwise."""

import ast
import inspect
import os
import subprocess
import sys
import types

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
    assert len(files) > 40
    rel = {os.path.relpath(f, os.path.join(ROOT, "fami_pose_torch"))
           for f in files}
    # the train slice's modules are under the same guard
    for name in ("engine/trainer.py", "engine/train_state.py",
                 "engine/checkpoints.py", "engine/steps.py",
                 "losses/heatmap.py", "optim/optimizer.py",
                 "utils/meters.py", "data/loader.py"):
        assert name in rel, name
    # and the evaluation slice's: datasets, protocol, evaluator, runner, CLI,
    # the probe kernels' wrappers and tool
    for name in ("utils/registry.py", "data/keypoints.py", "data/coco_json.py",
                 "data/video_dataset.py", "data/posetrack.py", "data/jhmdb.py",
                 "evaluation/__init__.py", "evaluation/poseval_data.py",
                 "evaluation/assign.py", "evaluation/ap.py",
                 "evaluation/tracking.py", "evaluation/evaluate.py",
                 "evaluation/pckh.py", "evaluation/convert.py",
                 "evaluation/seq_ids.py", "evaluation/annolist_writer.py",
                 "engine/evaluator.py", "engine/runner.py",
                 "engine/argument_parser.py", "run.py", "ops/probes.py",
                 "tools/hopper_watch.py"):
        assert name in rel, name
    # and the streaming slice's, with the tool that times the probes in turns
    for name in ("engine/streaming.py", "tools/probe_turns.py"):
        assert name in rel, name
    # and the int8 serving slice's: quantization, the int8 conv's wrappers,
    # the numerics tool
    for name in ("models/quant.py", "ops/int8_conv.py",
                 "tools/int8_numerics.py"):
        assert name in rel, name
    # and the slice of reference weights and train-time levers
    for name in ("models/pretrained.py", "models/build.py",
                 "engine/core_functions.py", "engine/metrics_writer.py",
                 "utils/profiling.py", "tools/convert_model.py",
                 "tools/validate_real_checkpoint.py"):
        assert name in rel, name
    # and the data-parallel slice's
    for name in ("parallel/__init__.py", "parallel/mesh.py"):
        assert name in rel, name
    # and the rest of the JAX package: visualisation, NMS (host, device,
    # native), the optional losses, offset targets, coords, initializers,
    # deform blocks, IO and logging helpers, the poseval converter
    for name in ("visualization/__init__.py", "visualization/draw.py",
                 "visualization/debug.py", "ops/nms.py", "native/__init__.py",
                 "native/nms.py", "losses/optional.py",
                 "data/target_generators.py", "ops/coords.py",
                 "models/weight_init.py", "models/deform_blocks.py",
                 "utils/io_utils.py", "utils/logging_utils.py",
                 "tools/convert_poseval.py"):
        assert name in rel, name
    # and the sustained-training slice's tools
    for name in ("tools/synthetic_fixture.py", "tools/sustained_train.py",
                 "tools/ab_dcn_bound.py"):
        assert name in rel, name
    # and the last trained-weights A/B tools
    for name in ("tools/flip_ab.py", "tools/streaming_ab.py",
                 "tools/ablate_dcn_bound.py"):
        assert name in rel, name


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
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'optax', "
        "'fami_pose_tpu') "
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
    from fami_pose_torch.engine.predictor import PosePredictor, serving_model
    from fami_pose_torch.engine.argument_parser import default_parse_args
    from fami_pose_torch.engine.evaluator import Evaluator
    from fami_pose_torch.engine.runner import Runner
    from fami_pose_torch.engine.trainer import Trainer
    from fami_pose_torch.tools import hopper_watch, validate_real_checkpoint

    for cls in (PosePredictor, Trainer, Evaluator):
        sig = inspect.signature(cls.__init__)
        assert sig.parameters["device"].default == "cuda", cls
    # the model the demo's stream serves (and PosePredictor's)
    sig = inspect.signature(serving_model)
    assert sig.parameters["device"].default == "cuda"
    assert parse_args(["--cfg", "c", "--frames", "f"]).device == "cuda"
    assert parse_args(["--cfg", "c", "--frames", "f",
                       "--streaming"]).device == "cuda"
    # python -m fami_pose_torch.run, and the Runner with or without its
    # command line's namespace
    args = default_parse_args(["--cfg", "c", "--val"])
    assert args.device == "cuda"
    for runner_args in (None, args, types.SimpleNamespace()):
        runner = Runner.__new__(Runner)  # no directories are made
        runner.setup_cfg = lambda: None
        runner.__init__(None, runner_args)
        assert runner.device == "cuda"
    # python -m fami_pose_torch.tools.hopper_watch
    source = inspect.getsource(hopper_watch.main)
    assert '"--device", default="cuda"' in source
    # python -m fami_pose_torch.tools.validate_real_checkpoint
    source = inspect.getsource(validate_real_checkpoint.main)
    assert '"--device", default="cuda"' in source
    # the sustained run, its A/B and the int8 numerics, with or without a
    # checkpoint
    from fami_pose_torch.tools import (
        ab_dcn_bound, int8_numerics, sustained_train,
    )

    assert sustained_train.parse_args([]).device == "cuda"
    assert ab_dcn_bound.parse_args(["--ckpt", "c"]).device == "cuda"
    assert int8_numerics.parse_args([]).device == "cuda"
    assert int8_numerics.parse_args(["--ckpt", "c"]).device == "cuda"
    # the flip-test, streaming and DCN-window A/Bs, from the command line
    # and from Python
    from fami_pose_torch.tools import ablate_dcn_bound, flip_ab, streaming_ab

    assert flip_ab.parse_args(["--ckpt", "c"]).device == "cuda"
    assert streaming_ab.parse_args(["--ckpt", "c"]).device == "cuda"
    assert ablate_dcn_bound.parse_args([]).device == "cuda"
    for run in (flip_ab.run, streaming_ab.run, ablate_dcn_bound.run):
        assert inspect.signature(run).parameters["device"].default == \
            "cuda", run.__module__


def test_cuda_tensor_never_reaches_a_plain_version():
    """Every probe wrapper takes its plain version only for a CPU tensor:
    any other device type but ``cuda`` raises, and the CUDA branch has no
    fallback (it builds and launches, or raises: here, without nvcc)."""
    import torch

    from fami_pose_torch.ops import probes

    for fn in (probes.gather_lane, probes.gather_3d, probes.gather_rows,
               probes.dynamic_roll):
        source = inspect.getsource(fn)
        assert source.count("_plain(") == 1, fn.__name__
        assert "except" not in source and "try:" not in source, fn.__name__
        x = torch.empty(2, 128, device="meta")
        with pytest.raises(ValueError, match="no probe kernel for device"):
            fn(x, x)


def test_int8_conv_wrappers_never_fall_back():
    """The int8 conv's two kernel wrappers (the quantize pass and the
    implicit GEMM) and the conv itself take their plain versions only for a
    CPU tensor, with no fallback on the card."""
    from fami_pose_torch.ops import int8_conv

    for fn in (int8_conv.quant_nhwc, int8_conv.implicit_gemm,
               int8_conv.int8_conv2d):
        source = inspect.getsource(fn)
        assert source.count("_plain(") == 1, fn.__name__
        assert "except" not in source and "try:" not in source, fn.__name__
        assert 'device.type == "cpu"' in source, fn.__name__


def test_cuda_build_needs_nvcc(tmp_path, monkeypatch):
    """Where there is no nvcc the build raises with a clear message (and
    only the CUDA branch of a wrapper ever asks for it)."""
    from fami_pose_torch.ops.cuda import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_distributed_entry_points(monkeypatch):
    """``run.py`` joins the process group before anything else;
    ``--device cuda`` is this rank's ``cuda:LOCAL_RANK`` under a launcher,
    an explicit index and ``cpu`` are kept, and joining is a no-op in one
    process; the group's backend is NCCL for the card and gloo for the CPU
    (read from the source: no group is joined here)."""
    from fami_pose_torch import run
    from fami_pose_torch.engine.runner import Runner
    from fami_pose_torch.parallel import mesh

    source = inspect.getsource(run.main)
    assert source.index("maybe_initialize_distributed(") < source.index(
        "get_cfg(")
    source = inspect.getsource(mesh.maybe_initialize_distributed)
    assert '"nccl" if on_card else "gloo"' in source
    assert source.index("set_device") < source.index("init_process_group")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mesh.maybe_initialize_distributed() is False
    assert mesh.local_device("cuda") == "cuda"
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device("cuda") == "cuda:3"
    assert mesh.local_device("cuda:1") == "cuda:1"
    assert mesh.local_device("cpu") == "cpu"
    for device, want in ((None, "cuda:3"), ("cuda", "cuda:3"),
                         ("cuda:0", "cuda:0"), ("cpu", "cpu")):
        runner = Runner.__new__(Runner)  # no directories are made
        runner.setup_cfg = lambda: None
        runner.__init__(None, types.SimpleNamespace(device=device))
        assert runner.device == want, device


def test_cuda_wrappers_launch_on_the_tensor_device():
    """Every CUDA wrapper launches inside ``torch.cuda.device`` of its
    tensor: a kernel launch goes to the current device, and a rank's
    tensors may live on another."""
    from fami_pose_torch.ops import deform_conv, int8_conv, probes, warp

    for fn in (deform_conv._deform_conv_cuda,
               deform_conv._deform_conv_backward_cuda,
               warp._warp_translate_cuda, warp._warp_translate_backward_cuda,
               int8_conv._quant_nhwc_cuda, int8_conv._implicit_gemm_cuda,
               probes._launch):
        source = inspect.getsource(fn)
        assert "with torch.cuda.device(" in source, fn.__name__
        guard = source.index("with torch.cuda.device(")
        assert source.index("check(lib", guard) > guard, fn.__name__
