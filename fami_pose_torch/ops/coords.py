"""Integral-regression coordinate decode (reference
``datasets/process/coordinate_process.py:6-20``); port of
``fami_pose_tpu/ops/coords.py``: de-normalize soft-argmax outputs and map
them back through the inverse affine (``ops.heatmap.transform_preds``)."""

import torch

from .heatmap import transform_preds


def get_final_preds_coord(batch_keypoints, center, scale, heatmap_size):
    """batch_keypoints: (B, J, 3) with normalized coords in [-0.5, 0.5]
    (+score); center, scale: (B, 2); heatmap_size: (w, h). Returns
    (preds (B, J, 2), maxvals (B, J, 1)), float32."""
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    kp = torch.as_tensor(batch_keypoints).to(torch.float32)
    maxvals = kp[..., 2:3]
    coords = torch.stack([(kp[..., 0] + 0.5) * w, (kp[..., 1] + 0.5) * h],
                         dim=-1)
    return transform_preds(coords, center, scale, (w, h)), maxvals
