"""Skeleton / bbox drawing for debug visualization (numpy + cv2).

A copy of ``fami_pose_tpu/visualization/draw.py``: the reference's
``engine/core/utils/vis_helper.py:20-69`` surface
(``draw_skeleton_in_origin_image``), which the evaluator's
``DEBUG.VIS_SKELETON`` / ``DEBUG.VIS_BBOX`` overlays and ``demo --vis``
call. Host-side: predictions arrive as numpy arrays.
"""

import os
import os.path as osp
from typing import Optional, Sequence

import cv2
import numpy as np

# COCO-17 limb pairs
COCO_SKELETON = [
    (0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),
    (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14), (14, 16),
]

_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170),
]


def draw_skeleton(
    image: np.ndarray,
    joints: np.ndarray,
    joints_vis: Optional[np.ndarray] = None,
    skeleton: Sequence = COCO_SKELETON,
    radius: int = 3,
    thickness: int = 2,
) -> np.ndarray:
    """Draw joints + limbs onto ``image`` (BGR uint8). ``joints`` (J, 2)."""
    out = image.copy()
    j = len(joints)
    vis = np.ones(j) if joints_vis is None else np.asarray(joints_vis).reshape(-1)
    for i, (x, y) in enumerate(joints[:, :2]):
        if vis[i] > 0:
            cv2.circle(out, (int(x), int(y)), radius, _COLORS[i % len(_COLORS)], -1)
    for a, b in skeleton:
        if a < j and b < j and vis[a] > 0 and vis[b] > 0:
            pa = (int(joints[a, 0]), int(joints[a, 1]))
            pb = (int(joints[b, 0]), int(joints[b, 1]))
            cv2.line(out, pa, pb, _COLORS[a % len(_COLORS)], thickness)
    return out


def draw_bbox(image: np.ndarray, bbox, color=(0, 255, 0), thickness=2):
    """bbox [x1, y1, x2, y2]."""
    out = image.copy()
    x1, y1, x2, y2 = (int(v) for v in bbox[:4])
    cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
    return out


def draw_skeleton_in_origin_image(
    image_path: str,
    preds: np.ndarray,
    output_dir: str,
    bbox=None,
    vis_thre: float = 0.0,
) -> str:
    """Load the original frame, draw predictions (J, 3), save under
    ``output_dir`` mirroring the video/frame structure. Returns the path."""
    img = cv2.imread(image_path)
    if img is None:
        raise IOError(f"Fail to read {image_path}")
    vis = preds[:, 2] > vis_thre if preds.shape[1] > 2 else None
    out = draw_skeleton(img, preds[:, :2], vis)
    if bbox is not None:
        out = draw_bbox(out, bbox)
    rel = "/".join(image_path.split("/")[-2:])
    out_path = osp.join(output_dir, rel)
    os.makedirs(osp.dirname(out_path), exist_ok=True)
    cv2.imwrite(out_path, out)
    return out_path
