"""Bounding box <-> (center, scale) conversions (host, numpy).

A copy of ``fami_pose_tpu/utils/bbox.py``: scale is in units of 200 px
(``PIXEL_STD``), boxes are widened or heightened to the target aspect ratio
before conversion, and an enlarge factor pads the crop.
"""

import numpy as np

PIXEL_STD = 200.0


def xywh2cs(x, y, w, h, aspect_ratio, enlarge_factor=1.0):
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / PIXEL_STD, h / PIXEL_STD], dtype=np.float32)
    if center[0] != -1:
        scale = scale * enlarge_factor
    return center, scale


def box2cs(box, aspect_ratio, enlarge_factor=1.0):
    x, y, w, h = box[:4]
    return xywh2cs(x, y, w, h, aspect_ratio, enlarge_factor)
