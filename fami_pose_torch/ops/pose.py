"""Horizontal flip of heatmaps for flip-test (``fami_pose_tpu/ops/pose.py``)."""

import torch

from fami_pose_torch.data.keypoints import COCO_FLIP_PAIRS


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
