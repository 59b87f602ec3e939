"""Pose-level transforms (``fami_pose_tpu/ops/pose.py``): the horizontal flip
of heatmaps for flip-test (torch, on the device), and the host-side numpy
augmentation helpers of the datasets, joint flipping and the half-body crop."""

import numpy as np
import torch

from fami_pose_torch.data.keypoints import COCO_FLIP_PAIRS, COCO_UPPER_BODY_IDS


def flip_pair_permutation(num_joints, matched_parts=None):
    if matched_parts is None:
        matched_parts = COCO_FLIP_PAIRS
    perm = list(range(num_joints))
    for a, b in matched_parts:
        perm[a], perm[b] = b, a
    return perm


def flip_back(output_flipped, matched_parts=None):
    """Un-flip (B, J, H, W) heatmaps predicted on mirrored inputs: mirror
    the width axis and swap left/right joints."""
    perm = flip_pair_permutation(output_flipped.shape[1], matched_parts)
    idx = torch.as_tensor(perm, device=output_flipped.device)
    return torch.flip(output_flipped.index_select(1, idx), dims=(3,))


def flip_back_nhwc(output_flipped, matched_parts=None):
    """(B, H, W, J) variant of :func:`flip_back`."""
    return flip_back(
        output_flipped.permute(0, 3, 1, 2), matched_parts
    ).permute(0, 2, 3, 1)


def fliplr_joints(joints, joints_vis, width, matched_parts=None):
    """Mirror joints horizontally and swap left/right labels (numpy, host)."""
    if matched_parts is None:
        matched_parts = COCO_FLIP_PAIRS
    joints = np.array(joints, copy=True)
    joints_vis = np.array(joints_vis, copy=True)
    joints[:, 0] = width - joints[:, 0] - 1
    perm = np.asarray(flip_pair_permutation(joints.shape[0], matched_parts))
    joints = joints[perm]
    joints_vis = joints_vis[perm]
    return joints * joints_vis, joints_vis


def half_body_transform(
    joints, joints_vis, num_joints, upper_body_ids=None,
    aspect_ratio=0.75, pixel_std=200.0, rng=None,
):
    """Randomly crop to the upper or lower body (train-time augmentation).

    Returns (center, scale) of the sub-box, or (None, None) when too few
    joints are visible (caller keeps the full box).
    """
    if upper_body_ids is None:
        upper_body_ids = COCO_UPPER_BODY_IDS
    rng = rng or np.random
    vis_mask = joints_vis[:, 0] > 0
    upper_mask = np.zeros(num_joints, dtype=bool)
    upper_mask[list(upper_body_ids)] = True
    upper = joints[vis_mask & upper_mask]
    lower = joints[vis_mask & ~upper_mask]

    if rng.randn() < 0.5 and len(upper) > 2:
        selected = upper
    else:
        selected = lower if len(lower) > 2 else upper
    if len(selected) < 2:
        return None, None

    selected = np.asarray(selected, dtype=np.float32)[:, :2]
    center = selected.mean(axis=0)
    lt = selected.min(axis=0)
    rb = selected.max(axis=0)
    w, h = rb[0] - lt[0], rb[1] - lt[1]
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32) * 1.5
    return center, scale
