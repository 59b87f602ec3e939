"""Trainer: the epoch loop (``fami_pose_tpu/engine/trainer.py``).

Builds loader, model (``models/build.py``), optimizer and train step (the
core function of ``cfg.CORE_FUNCTION``, ``engine/core_functions.py``) from a
config, overlays ``MODEL.PRETRAINED`` backbone weights after
``MODEL.INIT_WEIGHTS`` (``models/pretrained.py``), resumes from the latest
checkpoint when ``TRAIN.AUTO_RESUME`` is set, runs epochs with the metrics
fetched from the device only every ``PRINT_FREQ`` steps (and written to
``metrics.jsonl``, ``engine/metrics_writer.py``), steps the per-step LR
schedule, and saves per-epoch checkpoints, on a thread with
``TPU.ASYNC_CHECKPOINT``.

The train-time levers of the JAX trainer: ``TPU.REMAT_BACKBONE`` (the
model's), ``TPU.BF16_GRADS`` (the train step's), ``TPU.DEVICE_CROP`` (raw
person windows cropped on the device, :meth:`Trainer.prepare`) and
``TPU.PROFILE_DIR`` (a ``torch.profiler`` trace of the first
``TPU.PROFILE_STEPS`` steps of epoch 0).

``TPU.MESH_SHAPE`` lays the data axis over the ranks of the process group
(``parallel/mesh.py``; one process a GPU, as ``python -m
torch.distributed.run`` starts them): the global batch is
``TRAIN.BATCH_SIZE_PER_GPU`` times the data axis, each rank loads and steps
its data index's slice (the ranks of a ``model`` axis replicate it),
BatchNorm statistics and gradients are global, and only rank 0 writes
checkpoints and ``metrics.jsonl``. Every rank builds the same seeded
initial weights, as every JAX process does; nothing broadcasts them.
"""

import logging
import os.path as osp
import time

import torch

import fami_pose_torch.data.jhmdb  # noqa: F401  (dataset registration)
import fami_pose_torch.data.posetrack  # noqa: F401
from fami_pose_torch.data.loader import (
    build_train_loader, prepare_train_batch, prepare_train_batch_device_crop,
)
from fami_pose_torch.models.bridge import init_weights
from fami_pose_torch.models.build import build_model, model_class
from fami_pose_torch.models.fami_pose import init_weights_reference
from fami_pose_torch.models.pretrained import (
    load_torch_state_dict, merge_into_variables, remap_hrnet_backbone_for_fami,
)
from fami_pose_torch.optim import build_optimizer
from fami_pose_torch.parallel.mesh import barrier, build_mesh
from fami_pose_torch.utils.meters import AverageMeter
from fami_pose_torch.utils.profiling import trace
from fami_pose_torch.utils.registry import DATASET_REGISTRY, TRAIN_PHASE

from . import checkpoints
from .core_functions import build_core_function, core_function_class
from .metrics_writer import MetricWriter
from .train_state import TrainState


def config_mesh(cfg):
    """The mesh of ``TPU.MESH_SHAPE`` over the process group's ranks
    (``parallel.mesh.build_mesh``: a shape needing more ranks than there
    are, or leaving ranks out, raises ``ValueError``)."""
    return build_mesh(list(getattr(cfg.TPU, "MESH_SHAPE", None) or [-1]))


def check_model(cfg):
    """Raise ``KeyError`` for a core function or a model that is not
    registered (the builders' own lookups and messages)."""
    core_function_class(cfg)
    model_class(cfg)


def check_supported(cfg):
    """Raise for a config the port's trainer cannot run: a mesh the process
    group cannot hold (:func:`config_mesh`), or an unregistered core
    function or model."""
    config_mesh(cfg)
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
      device: where the model and the batches live (this rank's device).
    """

    def __init__(self, cfg, output_dirs=None, dataset=None, device="cuda"):
        check_supported(cfg)
        self.mesh = config_mesh(cfg)
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
        self.writer = MetricWriter(self.log_dir) if self.mesh.rank == 0 \
            else None

        self.dataset = dataset
        self.loader = build_train_loader(
            cfg, dataset, mesh=self.mesh)
        self.steps_per_epoch = max(1, len(self.loader))

        model = build_model(cfg, TRAIN_PHASE)
        init_weights(model, int(cfg.SEED))
        if bool(cfg.MODEL.INIT_WEIGHTS):
            init_weights_reference(model, int(cfg.SEED) + 1)
        if cfg.MODEL.PRETRAINED and osp.isfile(cfg.MODEL.PRETRAINED):
            self._load_pretrained(model, cfg.MODEL.PRETRAINED)
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

        self.core_function = build_core_function(cfg)
        self.train_step = self.core_function.build_train_step(
            model, mesh=self.mesh)
        self.global_step = int(self.state.step)

    def _load_pretrained(self, model, path):
        """A reference HRNet ``.pth`` -> the backbone's parameters and
        statistics (remap + overlay, ``models/pretrained.py``)."""
        mapped, unmapped = remap_hrnet_backbone_for_fami(
            load_torch_state_dict(path))
        model.load_state_dict(
            merge_into_variables(model.state_dict(), mapped))
        self.logger.info(
            f"loaded pretrained backbone from {path} "
            f"({len(unmapped)} unmapped keys)"
        )

    @property
    def model(self):
        return self.state.model

    def prepare(self, raw):
        """A collated host batch -> the train step's batch on the device:
        host crops, or raw person windows (``TPU.DEVICE_CROP``: the batch
        carries ``crop_center``) cropped on the device."""
        cfg = self.cfg
        kw = dict(
            sigma=int(cfg.MODEL.SIGMA),
            image_size=tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE),
            heatmap_size=tuple(int(v) for v in cfg.MODEL.HEATMAP_SIZE),
            device=self.device,
        )
        if "crop_center" in raw:
            return prepare_train_batch_device_crop(
                raw["kf"], raw["sup"], raw["crop_center"], raw["scale"],
                raw["rotation"], raw["joints"], raw["joints_vis"], **kw)
        return prepare_train_batch(
            raw["kf"], raw["sup"], raw["joints"], raw["joints_vis"], **kw)

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
        the steps that print). Epoch 0's first ``TPU.PROFILE_STEPS`` steps
        are traced when ``TPU.PROFILE_DIR`` is set."""
        meters = {}
        batch_time = AverageMeter()
        data_time = AverageMeter()
        self.model.train()
        profile_dir = str(getattr(self.cfg.TPU, "PROFILE_DIR", "") or "")
        profile_steps = int(getattr(self.cfg.TPU, "PROFILE_STEPS", 0) or 0)
        profiler = trace(profile_dir) if (profile_dir and epoch == 0) else None
        if profiler is not None:
            profiler.__enter__()
        end = time.time()
        for it, raw in enumerate(self.loader):
            if profiler is not None and it == profile_steps:
                profiler.__exit__(None, None, None)
                profiler = None
            data_time.update(time.time() - end)
            batch = self.prepare(raw)
            self.state, metrics = self.train_step(self.state, batch)
            self.global_step += 1
            batch_time.update(time.time() - end)
            end = time.time()

            if it % int(self.cfg.PRINT_FREQ) == 0:
                # the only place the loop waits for the device; the metrics
                # are already global (the step's all-reduce runs every step
                # on every rank), so this issues no collective
                for k, v in metrics.items():
                    v = float(v)
                    meters.setdefault(k, AverageMeter()).update(v)
                    if self.writer is not None:
                        self.writer.add_scalar(f"train_{k}", v,
                                               self.global_step)
                samples = (raw["kf"].shape[0] * self.mesh.data
                           / max(batch_time.val, 1e-9))
                self.logger.info(
                    f"Epoch [{epoch}][{it}/{self.steps_per_epoch}] "
                    f"time {batch_time.val:.3f}s data {data_time.val:.3f}s "
                    f"speed {samples:.1f} samples/s "
                    f"lr {self.state.optimizer.param_groups[0]['lr']:.3g}\n"
                    + self._tables(meters)
                )
        if profiler is not None:
            profiler.__exit__(None, None, None)
        return meters

    def train(self):
        """Epochs ``begin_epoch .. end_epoch - 1`` with a checkpoint every
        ``TRAIN.SAVE_MODEL_PER_EPOCH`` epochs and after the last (written by
        rank 0, on a thread with ``TPU.ASYNC_CHECKPOINT``, all joined, then
        a barrier of every rank, before this returns, so that no rank reads
        a file still being written); returns the train state."""
        save_every = max(1, int(self.cfg.TRAIN.SAVE_MODEL_PER_EPOCH))
        async_save = bool(getattr(self.cfg.TPU, "ASYNC_CHECKPOINT", False))
        for epoch in range(self.begin_epoch, self.end_epoch):
            meters = self.train_epoch(epoch)
            if meters.get("acc") and self.writer is not None:
                self.writer.add_scalar("train_acc_avg", meters["acc"].avg,
                                       epoch)
            if (epoch % save_every == 0) or epoch == self.end_epoch - 1:
                path = checkpoints.save_checkpoint(
                    self.checkpoints_dir, epoch, self.state,
                    async_save=async_save,
                )
                self.logger.info(f"saved checkpoint {path}")
        checkpoints.wait_for_pending_saves()
        barrier(self.mesh)
        if self.writer is not None:
            self.writer.flush()
        return self.state
