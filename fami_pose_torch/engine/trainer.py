"""Trainer: the epoch loop (``fami_pose_tpu/engine/trainer.py``).

Builds loader, model, optimizer and train step from a config, resumes from
the latest checkpoint when ``TRAIN.AUTO_RESUME`` is set, runs epochs with the
metrics fetched from the device only every ``PRINT_FREQ`` steps, steps the
per-step LR schedule, and saves per-epoch checkpoints.

Not ported yet, and refused rather than ignored when a config asks for them:
loading ``MODEL.PRETRAINED`` backbone weights, the profiler hook
(``TPU.PROFILE_DIR``), ``TPU.BF16_GRADS``, ``TPU.REMAT_BACKBONE``,
``TPU.DEVICE_CROP`` for training, and core functions other than the
FAMI-Pose one. There is no metric writer and no device mesh: one process,
one device.
"""

import logging
import os.path as osp
import time

import torch

import fami_pose_torch.data.jhmdb  # noqa: F401  (dataset registration)
import fami_pose_torch.data.posetrack  # noqa: F401
from fami_pose_torch.data.loader import build_train_loader, prepare_train_batch
from fami_pose_torch.models.bridge import init_weights
from fami_pose_torch.models.fami_pose import FAMIPose, init_weights_reference
from fami_pose_torch.optim import build_optimizer
from fami_pose_torch.utils.meters import AverageMeter
from fami_pose_torch.utils.registry import DATASET_REGISTRY, TRAIN_PHASE

from . import checkpoints
from .steps import make_train_step
from .train_state import TrainState

CORE_FUNCTIONS = ("", "FAMIPoseFunction", "AlignmentMIFunction_Term6_V1")


def check_model(cfg):
    """Raise for a core function or a model the port does not have."""
    if str(cfg.CORE_FUNCTION or "") not in CORE_FUNCTIONS:
        raise KeyError(
            f"Unknown core function {cfg.CORE_FUNCTION!r}; available: "
            f"{sorted(n for n in CORE_FUNCTIONS if n)}"
        )
    if str(cfg.MODEL.NAME) not in ("FAMIPose", "Alignment_V15"):
        raise KeyError(f"Unknown model {cfg.MODEL.NAME!r}")


def check_supported(cfg):
    """Raise for a config that turns on what the port's trainer lacks."""
    tpu = cfg.TPU
    unported = {
        "TPU.BF16_GRADS": bool(getattr(tpu, "BF16_GRADS", False)),
        "TPU.REMAT_BACKBONE": bool(getattr(tpu, "REMAT_BACKBONE", False)),
        "TPU.DEVICE_CROP": bool(getattr(tpu, "DEVICE_CROP", False)),
        "TPU.PROFILE_DIR": bool(str(getattr(tpu, "PROFILE_DIR", "") or "")),
        "MODEL.PRETRAINED (the file exists)": bool(
            cfg.MODEL.PRETRAINED and osp.isfile(cfg.MODEL.PRETRAINED)),
    }
    on = [name for name, flag in unported.items() if flag]
    if on:
        raise NotImplementedError(
            f"not ported to fami_pose_torch's trainer yet: {', '.join(on)}"
        )
    check_model(cfg)


class Trainer:
    """Train a FAMIPose model.

    Args:
      cfg: a merged config (``fami_pose_torch.config``).
      output_dirs: ``{"checkpoints": dir, "log": dir}``; defaults under
        ``cfg.OUTPUT_DIR``.
      dataset: any object with ``__len__`` and ``__getitem__`` that gives the
        sample dict ``data.loader.collate`` reads (uint8 ``kf`` (H, W, 3) and
        ``sup`` (H, W, 3N), ``joints`` (J, 2), ``joints_vis`` (J,), ...);
        None builds ``DATASET.NAME``'s class from the registry for the train
        phase.
      device: where the model and the batches live.
    """

    def __init__(self, cfg, output_dirs=None, dataset=None, device="cuda"):
        check_supported(cfg)
        if dataset is None:
            dataset = DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg, TRAIN_PHASE)
        self.cfg = cfg
        self.device = torch.device(device)
        self.logger = logging.getLogger(__name__)
        dirs = output_dirs or {}
        self.checkpoints_dir = dirs.get(
            "checkpoints", osp.join(cfg.OUTPUT_DIR or ".", "checkpoints")
        )
        self.log_dir = dirs.get("log", osp.join(cfg.OUTPUT_DIR or ".", "log"))

        self.dataset = dataset
        self.loader = build_train_loader(cfg, dataset)
        self.steps_per_epoch = max(1, len(self.loader))

        model = FAMIPose.from_config(cfg)
        init_weights(model, int(cfg.SEED))
        if bool(cfg.MODEL.INIT_WEIGHTS):
            init_weights_reference(model, int(cfg.SEED) + 1)
        model.to(self.device).train()
        optimizer, scheduler = build_optimizer(
            cfg, model, steps_per_epoch=self.steps_per_epoch
        )
        self.state = TrainState(model, optimizer, scheduler)

        self.begin_epoch = int(cfg.TRAIN.BEGIN_EPOCH)
        self.end_epoch = int(cfg.TRAIN.END_EPOCH)
        if bool(cfg.TRAIN.AUTO_RESUME):
            latest = checkpoints.get_latest_checkpoint(self.checkpoints_dir)
            if latest:
                self.state, self.begin_epoch = checkpoints.resume(
                    latest, self.state, device=self.device
                )
                self.logger.info(
                    f"resumed from {latest} at epoch {self.begin_epoch}"
                )

        self.train_step = make_train_step(
            mse_weight=float(cfg.LOSS.HEATMAP_MSE.WEIGHT),
            mi_alpha=float(getattr(cfg.LOSS, "MI_ALPHA", 0.5)),
            mi_beta=float(getattr(cfg.LOSS, "MI_BETA", 0.1)),
        )
        self.global_step = int(self.state.step)

    @property
    def model(self):
        return self.state.model

    def prepare(self, raw):
        """A collated host batch -> the train step's batch on the device."""
        cfg = self.cfg
        if "crop_center" in raw:
            raise NotImplementedError(
                "the batch carries 'crop_center' (TPU.DEVICE_CROP): the "
                "device crop for training is not ported yet"
            )
        return prepare_train_batch(
            raw["kf"], raw["sup"], raw["joints"], raw["joints_vis"],
            sigma=int(cfg.MODEL.SIGMA),
            image_size=tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE),
            heatmap_size=tuple(int(v) for v in cfg.MODEL.HEATMAP_SIZE),
            device=self.device,
        )

    @staticmethod
    def _tables(meters):
        """The loss and accuracy line printed every ``PRINT_FREQ`` steps."""
        keys = ([k for k in meters if k.startswith("loss")]
                + [k for k in meters if k.startswith("acc")])
        return " ".join(
            f"{k}={meters[k].val:.5f} ({meters[k].avg:.5f})" for k in keys
        )

    def train_epoch(self, epoch):
        """One pass over the loader; returns the epoch's meters (updated at
        the steps that print)."""
        meters = {}
        batch_time = AverageMeter()
        data_time = AverageMeter()
        self.model.train()
        end = time.time()
        for it, raw in enumerate(self.loader):
            data_time.update(time.time() - end)
            batch = self.prepare(raw)
            self.state, metrics = self.train_step(self.state, batch)
            self.global_step += 1
            batch_time.update(time.time() - end)
            end = time.time()

            if it % int(self.cfg.PRINT_FREQ) == 0:
                # the only place the loop waits for the device
                for k, v in metrics.items():
                    meters.setdefault(k, AverageMeter()).update(float(v))
                samples = raw["kf"].shape[0] / max(batch_time.val, 1e-9)
                self.logger.info(
                    f"Epoch [{epoch}][{it}/{self.steps_per_epoch}] "
                    f"time {batch_time.val:.3f}s data {data_time.val:.3f}s "
                    f"speed {samples:.1f} samples/s "
                    f"lr {self.state.optimizer.param_groups[0]['lr']:.3g}\n"
                    + self._tables(meters)
                )
        return meters

    def train(self):
        """Epochs ``begin_epoch .. end_epoch - 1`` with a checkpoint every
        ``TRAIN.SAVE_MODEL_PER_EPOCH`` epochs and after the last; returns
        the train state."""
        save_every = max(1, int(self.cfg.TRAIN.SAVE_MODEL_PER_EPOCH))
        for epoch in range(self.begin_epoch, self.end_epoch):
            self.train_epoch(epoch)
            if (epoch % save_every == 0) or epoch == self.end_epoch - 1:
                path = checkpoints.save_checkpoint(
                    self.checkpoints_dir, epoch, self.state
                )
                self.logger.info(f"saved checkpoint {path}")
        return self.state
