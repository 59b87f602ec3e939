"""The port's checkpoint files against the JAX package's: both write
``epoch_{N}_state.ckpt``, the JAX package as flax msgpack and the port with
``torch.save``. A JAX file handed to the port is refused with a
``ValueError`` that names the file, the JAX format and the weight bridge
(``fami_pose_torch/models/bridge.py::state_dict_from_flax``), on every path
that loads one: ``load_variables``, ``resume``, the Trainer's auto-resume and
``Evaluator.load_variables``. A port checkpoint still round-trips bitwise.
"""

import os.path as osp
import types

import numpy as np
import pytest
import torch

from fami_pose_tpu.engine import checkpoints as jax_checkpoints
from fami_pose_torch.engine import checkpoints
from fami_pose_torch.engine.evaluator import Evaluator
from fami_pose_torch.engine.trainer import Trainer
from fixtures import make_posetrack_fixture
from test_torch_trainer import _cfg as trainer_cfg
from test_torch_trainer import _dataset, _states_equal
from torch_port_helpers import make_port_cfg, tiny_model_cfg

REFUSAL = r"not a fami_pose_torch checkpoint.*flax msgpack.*state_dict_from_flax"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_jax_checkpoint(directory, epoch=3):
    """``epoch_3_state.ckpt`` as the JAX package writes it
    (``fami_pose_tpu.engine.checkpoints.save_checkpoint``: flax
    ``serialization.to_bytes`` of params, batch_stats, opt_state, step)."""
    rs = np.random.RandomState(0)
    state = types.SimpleNamespace(
        params={"hrnet": {"stem_conv1": {
            "kernel": rs.randn(3, 3, 3, 4).astype(np.float32)}}},
        batch_stats={"hrnet": {"stem_norm1": {"bn": {
            "mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}}}},
        opt_state={"count": np.int32(7)},
        step=np.int32(7),
    )
    path = jax_checkpoints.save_checkpoint(directory, epoch, state)
    assert path == checkpoints.checkpoint_path(directory, epoch)
    with open(path, "rb") as f:
        assert f.read(2) != b"PK"  # msgpack, not torch.save's zip
    return path


def test_load_variables_refuses_a_jax_checkpoint(tmp_path):
    path = _write_jax_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match=REFUSAL) as err:
        checkpoints.load_variables(path)
    assert path in str(err.value) and "weights_only" not in str(err.value)


def test_resume_and_auto_resume_refuse_a_jax_checkpoint(tmp_path):
    cfg = trainer_cfg(str(tmp_path), end_epoch=1)
    ckpt_dir = str(tmp_path / "ckpt")
    path = _write_jax_checkpoint(ckpt_dir)
    cfg.TRAIN.AUTO_RESUME = False
    trainer = Trainer(cfg, dataset=_dataset(), device="cpu",
                      output_dirs={"checkpoints": ckpt_dir})
    with pytest.raises(ValueError, match=REFUSAL):
        checkpoints.resume(path, trainer.state)
    cfg.TRAIN.AUTO_RESUME = True  # the Trainer finds the file as the latest
    with pytest.raises(ValueError, match=REFUSAL):
        Trainer(cfg, dataset=_dataset(), device="cpu",
                output_dirs={"checkpoints": ckpt_dir})


def test_evaluator_refuses_a_jax_checkpoint(tmp_path):
    root = str(tmp_path)
    _, img_dir = make_posetrack_fixture(root, n_videos=1, n_frames=3,
                                        people_per_frame=1)
    cfg = tiny_model_cfg(make_port_cfg(osp.join(root, "json"), img_dir),
                         osp.join(root, "out"))
    ev = Evaluator(cfg, device="cpu")
    path = _write_jax_checkpoint(ev.checkpoints_dir)
    assert ev.list_model_files() == [path]
    with pytest.raises(ValueError, match=REFUSAL):
        ev.load_variables(path)


def test_port_checkpoint_round_trips(tmp_path):
    """A port checkpoint (a zip from ``torch.save``) still loads: resume
    restores the state after an epoch of training (Adam moments included)
    bitwise, and ``load_variables`` gives the model's ``state_dict``."""
    cfg = trainer_cfg(str(tmp_path), end_epoch=1)
    cfg.TRAIN.AUTO_RESUME = False
    ckpt_dir = str(tmp_path / "ckpt")
    dirs = {"checkpoints": ckpt_dir}
    saved = Trainer(cfg, dataset=_dataset(), device="cpu", output_dirs=dirs)
    saved.train()
    path = checkpoints.save_checkpoint(ckpt_dir, 3, saved.state)
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"
    cfg.SEED = int(cfg.SEED) + 1  # other initial weights
    fresh = Trainer(cfg, dataset=_dataset(), device="cpu", output_dirs=dirs)
    state, begin = checkpoints.resume(path, fresh.state)
    assert begin == 4
    _states_equal(state, saved.state)
    variables = checkpoints.load_variables(path)
    want = saved.state.model.state_dict()
    assert set(variables) == set(want)
    for k, v in want.items():
        assert torch.equal(variables[k], v), k


DEMO_OPTS = ["MODEL.IMAGE_SIZE", "[32,32]", "MODEL.HEATMAP_SIZE", "[8,8]"]


def _demo_frames(tmp_path):
    import cv2

    rs = np.random.RandomState(4)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        cv2.imwrite(str(frames / f"{i:04d}.png"),
                    rs.randint(0, 256, size=(40, 52, 3)).astype(np.uint8))
    return str(frames)


def _run_demo(frames, out, *flags):
    import json

    from fami_pose_torch import demo

    demo.main(["--cfg", "configs/posetrack17/fami_pose.yaml", "--frames",
               frames, "--out", out, "--device", "cpu", *flags, *DEMO_OPTS])
    with open(osp.join(out, "keypoints.json")) as f:
        return json.load(f)


def test_demo_checkpoint_reads_the_trainers_file(tmp_path):
    """``demo --checkpoint epoch_N_state.ckpt`` with the file the port's
    trainer writes (``save_checkpoint`` of its ``TrainState``) gives the
    keypoints that ``--weights`` gives with that file's ``model``
    state_dict, which are not the seeded init's."""
    from fami_pose_torch.config import get_cfg
    from fami_pose_torch.engine.train_state import TrainState
    from fami_pose_torch.models.bridge import init_weights
    from fami_pose_torch.models.fami_pose import FAMIPose
    from fami_pose_torch.optim import build_optimizer

    cfg = get_cfg(types.SimpleNamespace(
        cfg="configs/posetrack17/fami_pose.yaml", opts=DEMO_OPTS,
        root_dir="."))
    model = init_weights(FAMIPose.from_config(cfg), seed=11)
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch=1)
    path = checkpoints.save_checkpoint(str(tmp_path / "ckpt"), 5,
                                       TrainState(model, optimizer,
                                                  scheduler))
    assert osp.basename(path) == "epoch_5_state.ckpt"
    weights = str(tmp_path / "weights.pt")
    torch.save(checkpoints.load_variables(path), weights)
    frames = _demo_frames(tmp_path)
    by_ckpt = _run_demo(frames, str(tmp_path / "a"), "--checkpoint", path)
    by_weights = _run_demo(frames, str(tmp_path / "b"), "--weights", weights)
    seeded = _run_demo(frames, str(tmp_path / "c"))
    assert len(by_ckpt) == 3 and by_ckpt == by_weights
    assert by_ckpt != seeded


def test_demo_checkpoint_refuses_a_jax_checkpoint(tmp_path):
    path = _write_jax_checkpoint(str(tmp_path / "ckpt"), epoch=2)
    frames = _demo_frames(tmp_path)
    with pytest.raises(ValueError, match=REFUSAL) as err:
        _run_demo(frames, str(tmp_path / "out"), "--checkpoint", path)
    assert path in str(err.value)
