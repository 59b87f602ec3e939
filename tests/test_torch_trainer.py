"""The port's ``Trainer`` on the CPU: epochs on a seeded synthetic dataset at
the tiny topology, per-epoch checkpoints, a simulated kill and auto-resume
at the right epoch with bitwise state continuity (the dataset is the seeded
synthetic one ``chip_smoke.py`` trains on), the per-step LR schedule
carried across the resume; the checkpoint directory contract against the JAX
package's; the loader's epoch order against the JAX loader's; and the
refusal of what the port's trainer lacks.

Tolerances: a resumed state (parameters, BatchNorm statistics, Adam
moments, step) is compared bitwise (``torch.equal``); the loader orders and
batches are compared exactly.
"""

import logging
import math
import os

import numpy as np
import pytest
import torch

from chip_smoke import SyntheticPoseDataset
from fami_pose_tpu.data.loader import DataLoader as JaxDataLoader
from fami_pose_tpu.engine import checkpoints as jax_checkpoints
from fami_pose_tpu.utils.meters import AverageMeter as JaxAverageMeter
from fami_pose_torch.config import get_cfg
from fami_pose_torch.data.loader import DataLoader, collate
from fami_pose_torch.engine import checkpoints
from fami_pose_torch.engine.trainer import Trainer, check_supported
from fami_pose_torch.models.hrnet import TINY_EXTRA
from fami_pose_torch.utils.meters import AverageMeter


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny tensors: more threads than two only contend with the other test
    workers of a parallel run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _dataset(n=8, size=64, num_sup=4):
    return SyntheticPoseDataset(n, (size, size), num_sup)


def _cfg(root, end_epoch):
    cfg = get_cfg()
    cfg.MODEL.NAME = "FAMIPose"
    cfg.MODEL.EXTRA = TINY_EXTRA
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.NUM_JOINTS = 17
    cfg.MODEL.PRETRAINED = ""
    cfg.DISTANCE = 3
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DCN_OFFSET_GROUPS = 4
    cfg.TPU.DCN_MAX_OFFSET = 2
    cfg.TPU.BF16_GRADS = False
    cfg.TPU.REMAT_BACKBONE = False
    cfg.TPU.DEVICE_CROP = False
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 4
    cfg.TRAIN.BEGIN_EPOCH = 0
    cfg.TRAIN.END_EPOCH = end_epoch
    cfg.TRAIN.AUTO_RESUME = True
    cfg.TRAIN.SHUFFLE = True
    cfg.TRAIN.OPTIMIZER = "adam"
    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.LR_STEP = [1, 3]  # epochs: steps 2 and 6 at 2 steps an epoch
    cfg.TRAIN.LR_FACTOR = 0.1
    cfg.TRAIN.SAVE_MODEL_PER_EPOCH = 1
    cfg.PRINT_FREQ = 1
    cfg.WORKERS = 1
    cfg.OUTPUT_DIR = os.path.join(root, "out")
    return cfg


def _states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    assert set(oa) == set(ob) and len(oa) > 100
    for i in oa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[i][key], ob[i][key]), (i, key)


def test_trainer_epochs_checkpoint_kill_and_auto_resume(tmp_path, caplog):
    root = str(tmp_path)
    dirs = {"checkpoints": os.path.join(root, "ckpt"),
            "log": os.path.join(root, "log")}
    dataset = _dataset()

    # phase 1: epochs 0 and 1, a checkpoint after each
    t1 = Trainer(_cfg(root, 2), output_dirs=dirs, dataset=dataset,
                 device="cpu")
    assert t1.begin_epoch == 0 and t1.steps_per_epoch == 2
    first = {k: v.clone() for k, v in t1.model.state_dict().items()}
    with caplog.at_level(logging.INFO, logger="fami_pose_torch.engine.trainer"):
        state1 = t1.train()
    assert state1.step == 4 and t1.global_step == 4
    assert [e for e, _ in checkpoints.list_checkpoints(dirs["checkpoints"])] \
        == [0, 1]
    moved = sum(not torch.equal(v, first[k])
                for k, v in state1.model.state_dict().items())
    assert moved > 100
    # the line printed at PRINT_FREQ: every loss term and accuracy, the rate
    lines = [r.getMessage() for r in caplog.records if "Epoch [" in r.getMessage()]
    assert len(lines) == 4
    for key in ("loss=", "loss_mse=", "loss_sup_mse=", "loss_mi_6=", "acc=",
                "acc_sup4=", "samples/s", "lr 0.001"):
        assert key in lines[0], key
    assert "lr 0.0001" in lines[2]  # step 2: the first milestone's own step

    # phase 2: the process is gone; a fresh Trainer resumes after epoch 1
    t2 = Trainer(_cfg(root, 4), output_dirs=dirs, dataset=dataset,
                 device="cpu")
    assert t2.begin_epoch == 2
    assert t2.state.step == 4 and t2.global_step == 4
    _states_equal(state1, t2.state)
    assert t2.state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    state2 = t2.train()
    assert state2.step == 8
    assert [e for e, _ in checkpoints.list_checkpoints(dirs["checkpoints"])] \
        == [0, 1, 2, 3]
    # steps 6 and 7 ran past the second milestone
    assert state2.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)

    # a third Trainer at the same END_EPOCH has nothing left to do
    t3 = Trainer(_cfg(root, 4), output_dirs=dirs, dataset=dataset,
                 device="cpu")
    assert t3.begin_epoch == 4
    _states_equal(state2, t3.state)
    assert t3.train().step == 8

    # evaluation reads only the model's part of the latest checkpoint
    latest = checkpoints.get_latest_checkpoint(dirs["checkpoints"])
    variables = checkpoints.load_variables(latest)
    want = state2.model.state_dict()
    assert set(variables) == set(want)
    assert all(torch.equal(variables[k], want[k]) for k in want)


def test_trainer_without_auto_resume_starts_over(tmp_path):
    root = str(tmp_path)
    dataset = _dataset(n=4)
    cfg = _cfg(root, 1)
    Trainer(cfg, dataset=dataset, device="cpu").train()
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, "checkpoints")  # the default
    assert checkpoints.get_latest_checkpoint(ckpt_dir).endswith(
        "epoch_0_state.ckpt")
    cfg = _cfg(root, 1)
    cfg.TRAIN.AUTO_RESUME = False
    fresh = Trainer(cfg, dataset=dataset, device="cpu")
    assert fresh.begin_epoch == 0 and fresh.state.step == 0


def test_seeded_init_is_reproducible(tmp_path):
    """Two trainers of one config hold identical parameters, and
    ``MODEL.INIT_WEIGHTS`` re-samples the head."""
    dataset = _dataset(n=4)
    cfg = _cfg(str(tmp_path), 1)
    a = Trainer(cfg, dataset=dataset, device="cpu").model.state_dict()
    b = Trainer(cfg, dataset=dataset, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    cfg.MODEL.INIT_WEIGHTS = not bool(cfg.MODEL.INIT_WEIGHTS)
    c = Trainer(cfg, dataset=dataset, device="cpu").model.state_dict()
    assert torch.equal(a["hrnet.conv1.weight"], c["hrnet.conv1.weight"])
    assert not torch.equal(a["agg_final_layer.weight"],
                           c["agg_final_layer.weight"])


@pytest.mark.parametrize("key,value", [
    ("TPU.MESH_SHAPE", [2, 1]), ("TPU.MESH_SHAPE", [1, 4]),
    ("TPU.MESH_SHAPE", [8]), ("TPU.MESH_SHAPE", [2, 2]),
])
def test_unported_options_are_refused(tmp_path, key, value):
    """In one process a mesh that needs more devices than the process
    group has, on the data axis or the ``model`` axis, raises the JAX
    package's ``ValueError`` ("needs N devices, have 1"); over several
    processes the trainer runs (``tests/test_torch_distributed_run.py``,
    ``tests/test_torch_parallel.py``)."""
    cfg = _cfg(str(tmp_path), 1)
    section, name = key.split(".")
    setattr(getattr(cfg, section), name, value)
    error, match = ValueError, f"needs {math.prod(value)} devices, have 1"
    with pytest.raises(error, match=match):
        check_supported(cfg)
    with pytest.raises(error, match=match):
        Trainer(cfg, dataset=_dataset(n=4), device="cpu")


def test_other_refusals(tmp_path):
    cfg = _cfg(str(tmp_path), 1)
    # without dataset= the class comes from the registry by DATASET.NAME
    cfg.DATASET.NAME = "NoSuchDataset"
    with pytest.raises(KeyError, match="DATASET registry"):
        Trainer(cfg, device="cpu")
    # MODEL.PRETRAINED is loaded when the file exists: one that
    # torch.load(weights_only=True) cannot read is refused by name
    cfg = _cfg(str(tmp_path), 1)
    pretrained = tmp_path / "hrnet.pth"
    pretrained.write_bytes(b"x")
    cfg.MODEL.PRETRAINED = str(pretrained)
    check_supported(cfg)
    with pytest.raises(ValueError, match="hrnet.pth"):
        Trainer(cfg, dataset=_dataset(n=4), device="cpu")
    cfg = _cfg(str(tmp_path), 1)
    cfg.CORE_FUNCTION = "SomethingElse"
    with pytest.raises(KeyError, match="core function"):
        check_supported(cfg)
    cfg = _cfg(str(tmp_path), 1)
    cfg.MODEL.NAME = "PoseWarper"
    with pytest.raises(KeyError, match="Unknown model"):
        check_supported(cfg)
    # raw person windows (TPU.DEVICE_CROP samples) collate, and the
    # trainer's batch preparation crops them on the device: a window that
    # is the crop itself, centred, at scale 1, gives the host batch back
    sample = dict(_dataset(n=1)[0], crop_center=np.full(2, 31.5, np.float32),
                  scale=np.full(2, 64 / 200, np.float32))
    raw = collate([sample] * 4)
    assert raw["crop_center"].shape == (4, 2)
    trainer = Trainer(_cfg(str(tmp_path), 1), dataset=_dataset(n=4),
                      device="cpu")
    got = trainer.prepare(raw)
    want = trainer.prepare({k: v for k, v in raw.items()
                            if k != "crop_center"})
    for k in ("kf", "sup", "target", "target_weight"):
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=0)


def test_checkpoint_directory_contract_matches_jax(tmp_path):
    """Same file names, same latest-by-index rule, same listing as the JAX
    package's checkpoints module on one directory."""
    d = str(tmp_path)
    for epoch in (0, 2, 10, 9):
        open(checkpoints.checkpoint_path(d, epoch), "wb").close()
    open(os.path.join(d, "epoch_3_state.ckpt.tmp"), "wb").close()
    open(os.path.join(d, "notes.txt"), "wb").close()
    assert checkpoints.checkpoint_path(d, 7) == jax_checkpoints.checkpoint_path(d, 7)
    assert checkpoints.get_latest_checkpoint(d) \
        == jax_checkpoints.get_latest_checkpoint(d)
    assert checkpoints.get_latest_checkpoint(d).endswith("epoch_10_state.ckpt")
    assert checkpoints.get_all_checkpoints(d, min_epoch=2) \
        == jax_checkpoints.get_all_checkpoints(d, min_epoch=2)
    assert checkpoints.get_latest_checkpoint(os.path.join(d, "none")) is None
    assert checkpoints.list_checkpoints(os.path.join(d, "none")) == []


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("workers", [1, 3])
def test_loader_order_matches_jax_loader(shuffle, drop_last, workers):
    """Two epochs of both loaders on one dataset: the same batches in the
    same order, the same padding and ``valid`` count."""
    dataset = _dataset(n=7, size=16, num_sup=1)
    kw = dict(batch_size=3, shuffle=shuffle, num_workers=workers,
              drop_last=drop_last, seed=5)
    ours, theirs = DataLoader(dataset, **kw), JaxDataLoader(dataset, **kw)
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for _ in range(2):
        got, ref = list(ours), list(theirs)
        assert len(got) == len(ref) == len(ours)
        for g, r in zip(got, ref):
            assert g["image_path"] == r["image_path"]
            assert g["valid"] == r["valid"]
            for key in ("kf", "sup", "joints", "joints_vis"):
                np.testing.assert_array_equal(g[key], r[key])


def test_average_meter_matches_jax():
    ours, theirs = AverageMeter(), JaxAverageMeter()
    for val, n in ((1.5, 1), (2.0, 3), (torch.tensor(0.25), 2)):
        ours.update(val, n)
        theirs.update(float(val), n)
        assert (ours.val, ours.avg, ours.sum, ours.count) == pytest.approx(
            (theirs.val, theirs.avg, theirs.sum, theirs.count))
    ours.reset()
    assert ours.count == 0 and ours.avg == 0.0
