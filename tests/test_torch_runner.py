"""The port's command line end to end on the CPU, as
``tests/test_end_to_end.py::test_runner_train_then_eval`` drives the JAX
package's: ``python -m fami_pose_torch.run --cfg <yaml> --train --val
--device cpu`` on the synthetic PoseTrack fixture at the tiny topology
writes the experiment's directories, per-phase log files and a checkpoint,
and logs AP tables for the final and the backbone heatmaps; ``--test`` and
``--val_from_checkpoint`` sweep the checkpoints that are there."""

import glob
import os
import os.path as osp
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from fami_pose_torch.config import get_cfg
from fami_pose_torch.engine.argument_parser import default_parse_args
from fami_pose_torch.engine.runner import Runner, dataset_tag
from fami_pose_torch.models import get_model_hyperparameter
from fami_pose_torch.models.hrnet import TINY_EXTRA
from fami_pose_tpu.engine.runner import dataset_tag as jax_dataset_tag
from fami_pose_tpu.models import get_model_hyperparameter as jax_hyper
from fixtures import make_cfg, make_posetrack_fixture
from test_end_to_end import _write_gt_annolists

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
KEYS = {"Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean"}
HYPER = "bbox_1.25_rot_45_scale_0.65-1.35_MseLoss_1.0"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_yaml(root, img_dir, annot_dir):
    cfg = {
        "EXPERIMENT_NAME": "smoke", "OUTPUT_DIR": osp.join(root, "out"),
        "WORKERS": 1, "PRINT_FREQ": 1, "DISTANCE": 3,
        "DATASET": {"NAME": "PoseTrack", "JSON_DIR": osp.join(root, "json"),
                    "IMG_DIR": img_dir, "TEST_IMG_DIR": img_dir,
                    "IS_POSETRACK18": False, "COLOR_RGB": True,
                    "BBOX_ENLARGE_FACTOR": 1.25},
        "MODEL": {"NAME": "FAMIPose", "NUM_JOINTS": 17, "PRETRAINED": "",
                  "IMAGE_SIZE": [96, 128], "HEATMAP_SIZE": [24, 32],
                  "SIGMA": 2, "EXTRA": TINY_EXTRA},
        "TRAIN": {"BATCH_SIZE_PER_GPU": 4, "BEGIN_EPOCH": 0, "END_EPOCH": 1,
                  "AUTO_RESUME": True, "PROB_HALF_BODY": 0.0,
                  "SCALE_FACTOR": 0.35, "ROT_FACTOR": 45},
        "VAL": {"ANNOT_DIR": annot_dir, "USE_GT_BBOX": True,
                "BATCH_SIZE_PER_GPU": 4, "POST_PROCESS": True,
                "FLIP_VAL": True},
        "TEST": {"ANNOT_DIR": annot_dir, "USE_GT_BBOX": True,
                 "BATCH_SIZE_PER_GPU": 4},
        "TPU": {"COMPUTE_DTYPE": "float32", "DCN_OFFSET_GROUPS": 4,
                "DCN_MAX_OFFSET": 2, "MESH_SHAPE": [1, 1]},
    }
    path = osp.join(root, "fixture.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The fixture, its yaml, and one ``--train --val`` run of the CLI."""
    root = str(tmp_path_factory.mktemp("runner"))
    _, img_dir = make_posetrack_fixture(root, n_videos=1, n_frames=6,
                                        people_per_frame=1)
    annot_dir = _write_gt_annolists(
        root, img_dir, make_cfg(osp.join(root, "json"), img_dir))
    cfg_path = _write_yaml(root, img_dir, annot_dir)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "fami_pose_torch.run", "--cfg", cfg_path,
         "--train", "--val", "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    out_dir = osp.join(root, "out", "smoke", "PoseTrack17", HYPER)
    return types.SimpleNamespace(root=root, cfg_path=cfg_path, run=run,
                                 out_dir=out_dir, env=env)


def _ap_tables(log_text):
    """{tag: {joint group: AP}} from the evaluator's ``[tag] AP: {...}``
    lines, in the order they were logged."""
    return [(m.group(1), eval(m.group(2)))  # a dict literal of floats
            for m in re.finditer(r"\[(final|backbone)\] AP: (\{.*?\})",
                                 log_text)]


def test_cli_train_then_val(experiment):
    run = experiment.run
    assert run.returncode == 0, run.stderr[-3000:]
    out = experiment.out_dir
    # directories of the experiment's identity
    for sub in ("checkpoints", "log", "results"):
        assert osp.isdir(osp.join(out, sub)), sub
    # a checkpoint of the one epoch (6 samples, batch 4, last batch dropped)
    assert os.listdir(osp.join(out, "checkpoints")) == ["epoch_0_state.ckpt"]
    payload = torch.load(osp.join(out, "checkpoints", "epoch_0_state.ckpt"),
                         weights_only=True)
    assert payload["step"] == 1 and payload["begin_epoch"] == 0
    # one log file per phase, each holding its own phase's lines
    (train_log,) = glob.glob(osp.join(out, "log", "train-*.log"))
    (val_log,) = glob.glob(osp.join(out, "log", "validate-*.log"))
    train_text, val_text = open(train_log).read(), open(val_log).read()
    assert "Epoch [0][0/1]" in train_text and "saved checkpoint" in train_text
    assert "AP:" not in train_text and "Epoch [" not in val_text
    assert "evaluating" in val_text and "epoch_0_state.ckpt" in val_text
    assert "eval forward done: 6 samples" in val_text
    # AP tables of both heatmaps, on the console too
    tables = _ap_tables(val_text)
    assert [t for t, _ in tables] == ["final", "backbone"]
    for _, table in tables:
        assert set(table) == KEYS
        assert all(np.isfinite(v) and 0.0 <= v <= 100.0
                   for v in table.values())
    assert "[final] AP:" in run.stderr
    # the annolists the protocol scored
    for tag in ("final", "backbone"):
        assert os.listdir(osp.join(out, "results", f"validate_{tag}_json")) \
            == ["video_0000.json"]


def test_cli_test_phase_and_checkpoint_sweep(experiment):
    """``--test`` scores the latest checkpoint into its own log file;
    ``--val --val_from_checkpoint 0`` scores every checkpoint >= 0."""
    assert experiment.run.returncode == 0
    ckpt_dir = osp.join(experiment.out_dir, "checkpoints")
    first = osp.join(ckpt_dir, "epoch_0_state.ckpt")
    second = osp.join(ckpt_dir, "epoch_3_state.ckpt")
    torch.save(torch.load(first, weights_only=True), second)
    try:
        run = subprocess.run(
            [sys.executable, "-m", "fami_pose_torch.run", "--cfg",
             experiment.cfg_path, "--test", "--val", "--val_from_checkpoint",
             "0", "--device", "cpu", "VAL.FLIP_VAL", "False"],
            cwd=experiment.root, env=experiment.env, capture_output=True,
            text=True, timeout=600)
    finally:
        os.remove(second)
    assert run.returncode == 0, run.stderr[-3000:]
    (test_log,) = glob.glob(osp.join(experiment.out_dir, "log", "test-*.log"))
    test_text = open(test_log).read()
    assert test_text.count("evaluating") == 1 and "epoch_3_" in test_text
    assert len(_ap_tables(test_text)) == 2
    val_logs = sorted(glob.glob(osp.join(experiment.out_dir, "log",
                                         "validate-*.log")))
    swept = open(val_logs[-1]).read()
    assert swept.count("evaluating") == 2
    tables = _ap_tables(swept)
    assert len(tables) == 4 and tables[0] == tables[2]  # the same weights


def test_runner_in_process(experiment, tmp_path):
    """``Runner(cfg, args).launch`` returns what the CLI logs."""
    assert experiment.run.returncode == 0
    args = default_parse_args(["--cfg", experiment.cfg_path, "--val",
                               "--device", "cpu"])
    cfg = get_cfg(args)
    runner = Runner(cfg, args)
    assert runner.device == "cpu"
    assert cfg.OUTPUT_DIR == experiment.out_dir
    results = runner.launch(val=args.val)
    assert set(results) == {"val"}
    ((path, tables),) = results["val"].items()
    assert path.endswith("epoch_0_state.ckpt")
    for tag in ("final", "backbone"):
        name_value, mean = tables[tag]
        assert set(name_value) == KEYS and np.isfinite(mean)
    # no checkpoint, nothing to evaluate
    cfg2 = get_cfg(args)
    cfg2.OUTPUT_DIR = str(tmp_path / "empty")
    assert Runner(cfg2, args).launch(val=True) == {"val": {}}


def test_argument_parser_matches_jax_flags():
    from fami_pose_tpu.engine.argument_parser import (
        default_parse_args as jax_parse,
    )

    argv = ["--cfg", "c.yaml", "--train", "--val", "--val_from_checkpoint",
            "3", "TRAIN.LR", "0.01"]
    ours, theirs = vars(default_parse_args(argv)), vars(jax_parse(argv))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert default_parse_args(["--cfg", "c", "--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("pt18", [False, True])
def test_output_directory_identity_matches_jax(tmp_path, pt18):
    import fami_pose_tpu.models  # noqa: F401  (registers the JAX models)

    jcfg = make_cfg(str(tmp_path), str(tmp_path), posetrack18=pt18)
    jcfg.MODEL.NAME = "FAMIPose"
    pcfg = get_cfg()
    pcfg.MODEL.NAME = "FAMIPose"
    pcfg.DATASET.NAME = "PoseTrack"
    pcfg.DATASET.IS_POSETRACK18 = pt18
    pcfg.DATASET.BBOX_ENLARGE_FACTOR = 1.25
    assert dataset_tag(pcfg) == jax_dataset_tag(jcfg)
    assert get_model_hyperparameter(pcfg) == jax_hyper(jcfg)
    pcfg.LOSS.HEATMAP_MSE.USE = jcfg.LOSS.HEATMAP_MSE.USE = False
    pcfg.TRAIN.SCALE_FACTOR = jcfg.TRAIN.SCALE_FACTOR = [0.25, 0.3]
    assert get_model_hyperparameter(pcfg) == jax_hyper(jcfg)
    pcfg.MODEL.NAME = "SomethingElse"
    assert get_model_hyperparameter(pcfg) == ""


def test_cli_val_with_the_int8_serving_levers(experiment):
    """``--val`` with the serving file's levers as options (int8 PTQ, the
    auto-window, flip-test): the checkpoint is calibrated before the window
    is chosen, and both heatmaps' AP tables are logged."""
    assert experiment.run.returncode == 0
    run = subprocess.run(
        [sys.executable, "-m", "fami_pose_torch.run", "--cfg",
         experiment.cfg_path, "--val", "--device", "cpu", "TPU.INT8_EVAL",
         "True", "TPU.INT8_CALIB_BATCHES", "1", "TPU.DCN_AUTO_WINDOW",
         "True", "VAL.FLIP_VAL", "True"],
        cwd=experiment.root, env=experiment.env, capture_output=True,
        text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    log = run.stderr
    cal = log.index("int8 PTQ calibration on 1 eval batches")
    assert cal < log.index("DCN auto-window")
    tables = _ap_tables(log[cal:])
    assert [t for t, _ in tables] == ["final", "backbone"]
    for _, table in tables:
        assert set(table) == KEYS
        assert all(np.isfinite(v) for v in table.values())
