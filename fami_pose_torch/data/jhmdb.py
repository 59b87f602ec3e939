"""Sub-JHMDB video pose dataset.

The reference supports JHMDB in config (``datasets/zoo/build.py:23-25``,
``coco2jhmdb_ord_infer``) but ships no dataset class; this
fills the gap. Data contract: a COCO-style json per split
(``jhmdb_train.json`` / ``jhmdb_val.json`` in ``DATASET.JSON_DIR``) with
15-joint JHMDB-order keypoints and per-frame person bboxes — the same index
machinery as PoseTrack, with Sub-JHMDB's protocol differences:

  * 15 joints in JHMDB order (``data.keypoints.JHMDB_JOINTS``),
  * every frame annotated (single person), GT boxes always,
  * evaluation = PCK@alpha normalized by bbox size (the standard Sub-JHMDB
    metric), not the PoseTrack AP protocol.
"""

import os.path as osp
from collections import OrderedDict

import numpy as np

from fami_pose_torch.utils.registry import DATASET_REGISTRY, TRAIN_PHASE

from .posetrack import PoseTrackDataset

# JHMDB_JOINTS order: neck belly head Rsho Lsho Rhip Lhip Relb Lelb Rknee
# Lknee Rwri Lwri Rank Lank
JHMDB_FLIP_PAIRS = [[3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14]]
JHMDB_UPPER_BODY_IDS = (0, 1, 2, 3, 4, 7, 8, 11, 12)


@DATASET_REGISTRY.register(name="JHMDB")
@DATASET_REGISTRY.register(name="Jhmdb")
class JHMDBDataset(PoseTrackDataset):
    def __init__(self, cfg, phase: str, **kwargs):
        json_name = "jhmdb_train.json" if phase == TRAIN_PHASE else "jhmdb_val.json"
        kwargs.setdefault(
            "json_path", osp.join(cfg.DATASET.JSON_DIR, json_name)
        )
        super().__init__(cfg, phase, **kwargs)
        self.flip_pairs = JHMDB_FLIP_PAIRS
        self.upper_body_ids = JHMDB_UPPER_BODY_IDS
        self.joints_weight = np.ones((self.num_joints, 1), np.float32)

    def _list_data(self):
        # JHMDB always uses GT boxes (single annotated person per clip)
        return self._load_gt_annotations()

    def evaluate(self, cfg, preds, output_dir, boxes, img_path_map, **kwargs):
        """PCK@alpha over GT-matched frames, normalized by bbox diagonal.

        ``preds``: (N, J, 3) in original image coords, aligned with this
        dataset's sample order via ``img_path_map`` (image path -> indices).
        Returns (OrderedDict per-joint-group PCK, mean PCK).
        """
        alpha = float(kwargs.get("alpha", 0.2))
        total = np.zeros(self.num_joints)
        correct = np.zeros(self.num_joints)
        for idx, item in enumerate(self.data):
            pred_idx = None
            for pi in img_path_map.get(item["image"], []):
                pred_idx = pi  # one person per frame in Sub-JHMDB
                break
            if pred_idx is None:
                continue
            gt = item["joints_3d"][:, :2]
            vis = item["joints_3d_vis"][:, 0] > 0
            x, y, w, h = item["box"]
            norm = np.linalg.norm([w, h])
            if norm <= 0:
                continue
            d = np.linalg.norm(preds[pred_idx, :, :2] - gt, axis=1)
            hit = (d / norm) <= alpha
            total += vis
            correct += hit & vis
        pck = np.where(total > 0, 100.0 * correct / np.maximum(total, 1), np.nan)
        groups = OrderedDict(
            [
                ("Head", [2]),
                ("Shoulder", [3, 4]),
                ("Elbow", [7, 8]),
                ("Wrist", [11, 12]),
                ("Hip", [5, 6]),
                ("Knee", [9, 10]),
                ("Ankle", [13, 14]),
            ]
        )
        name_value = OrderedDict(
            (name, float(np.nanmean(pck[ids]))) for name, ids in groups.items()
        )
        name_value["Mean"] = float(np.nanmean(pck))
        return name_value, name_value["Mean"]
