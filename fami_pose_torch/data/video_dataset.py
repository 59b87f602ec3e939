"""Dataset base classes: shared config-derived state + info tables.

Mirrors ``datasets/zoo/base.py:20-108`` (``BaseDataset`` / ``VideoDataset``):
pixel_std 200, image/heatmap sizes, aspect ratio from image width/height,
augmentation factors, and the tabulated parameter logging surface.
Samples are plain dicts of numpy arrays (no torch Dataset dependency).
"""

import logging
from typing import Dict, List

import numpy as np

from fami_pose_torch.utils.registry import TRAIN_PHASE

PIXEL_STD = 200.0
# ImageNet RGB normalization (reference datasets/transforms/build.py:17-29)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class BaseDataset:
    def __init__(self, cfg, phase: str, **kwargs):
        self.cfg = cfg
        self.phase = phase
        self.is_train = phase == TRAIN_PHASE
        self.pixel_std = PIXEL_STD
        self.num_joints = int(cfg.MODEL.NUM_JOINTS)
        self.image_size = np.array(cfg.MODEL.IMAGE_SIZE)  # (w, h)
        self.heatmap_size = np.array(cfg.MODEL.HEATMAP_SIZE)  # (w, h)
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self.sigma = int(cfg.MODEL.SIGMA)
        self.color_rgb = bool(cfg.DATASET.COLOR_RGB)

        self.scale_factor = cfg.TRAIN.SCALE_FACTOR
        self.rotation_factor = float(cfg.TRAIN.ROT_FACTOR)
        self.flip = bool(cfg.TRAIN.FLIP)
        self.prob_half_body = float(cfg.TRAIN.PROB_HALF_BODY)
        self.num_joints_half_body = int(cfg.TRAIN.NUM_JOINTS_HALF_BODY)
        self.use_different_joints_weight = bool(
            cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT
        )

        self.data: List[Dict] = []

    def __len__(self):
        return len(self.data)

    def show_parameters(self):
        logger = logging.getLogger(__name__)
        try:
            from tabulate import tabulate

            rows = [
                ["phase", self.phase],
                ["num_samples", len(self.data)],
                ["image_size", tuple(self.image_size)],
                ["heatmap_size", tuple(self.heatmap_size)],
                ["sigma", self.sigma],
            ]
            logger.info("\n" + tabulate(rows, tablefmt="pipe"))
        except ImportError:
            logger.info(f"{self.phase}: {len(self.data)} samples")


class VideoDataset(BaseDataset):
    """Adds the temporal-window state shared by video datasets."""

    def __init__(self, cfg, phase: str, **kwargs):
        super().__init__(cfg, phase, **kwargs)
        self.distance = int(cfg.DISTANCE)
        self.num_sup = 2 * (self.distance - 1)


def normalize_image_uint8(img: np.ndarray) -> np.ndarray:
    """HWC uint8 RGB -> float32 normalized (host-side, per-sample path)."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
