"""Featuremap / gradient / batch-grid debug visualization (numpy + cv2).

Port of ``fami_pose_tpu/visualization/debug.py`` in the port's layout: the
reference's ``visualization/featuremaps_vis.py`` (per-channel featuremap
dumps), ``visualization/grad_vis.py`` (gradient color / gray / saliency
images) and ``visualization/debug_vis.py:14-45`` (image grid with joint
overlays).

Inputs are the port's NCHW tensors on any device (or numpy arrays in the
same layout): a batch is (N, C, H, W), one gradient (C, H, W). Everything is
pulled to host float32 first (``.detach().float().cpu()``); these are
offline debug hooks, not compute-path code. Each function writes the files
and returns the arrays of its JAX namesake given the NHWC transpose:
element-wise maps keep their input's layout, the images that cv2 writes
(grids, the gray gradient, the de-normalized frame) come out (H, W[, C]).
"""

import math
import os
import os.path as osp
from typing import Optional

import cv2
import numpy as np
import torch

from fami_pose_torch.data.video_dataset import IMAGENET_MEAN, IMAGENET_STD


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _batch_nhwc(x, what) -> np.ndarray:
    a = _to_numpy(x)
    if a.ndim != 4:
        raise ValueError(f"{what}: expected (N, C, H, W), got {a.shape}")
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _save_gray(path: str, img_hw: np.ndarray) -> None:
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, np.clip(img_hw, 0, 255).astype(np.uint8))


def save_featuremaps(
    featuremaps,
    save_folder: str,
    highlight: bool = True,
    per_channel: bool = False,
    file_prefix: Optional[str] = None,
    file_postfix: Optional[str] = None,
    max_channels: Optional[int] = None,
) -> int:
    """Dump per-(sample, channel) grayscale jpgs of an (N, C, H, W) batch
    as ``<prefix>_<n>_<c>_<postfix>.jpg``.

    ``highlight`` rescales to the full 0-255 range, globally (the
    reference's ``save_batch_featuremaps``) or per channel (its ``_develop``
    variant, ``per_channel=True``). ``max_channels`` caps the dump.
    Returns the number of files written.
    """
    fm = _batch_nhwc(featuremaps, "save_featuremaps")
    n, _, _, c = fm.shape
    if highlight and not per_channel:
        fm = fm * (255.0 / (fm.max() - fm.min() + 1e-9))

    prefix = "" if file_prefix is None else f"{file_prefix}_"
    postfix = "" if file_postfix is None else f"_{file_postfix}"
    c_end = c if max_channels is None else min(c, int(max_channels))
    written = 0
    for b in range(n):
        for ch in range(c_end):
            img = fm[b, :, :, ch]
            if highlight and per_channel:
                img = img * (255.0 / (img.max() - img.min() + 1e-9))
            _save_gray(
                osp.join(save_folder, f"{prefix}{b}_{ch}{postfix}.jpg"), img
            )
            written += 1
    return written


def gradient_color_image(gradient) -> np.ndarray:
    """Min-max normalize a gradient to uint8, in its own layout ((C, H, W)
    for the port's; ``grad_vis.get_gradient_color_image``)."""
    g = _to_numpy(gradient)
    g = g - g.min()
    g = g / (g.max() + 1e-12)
    return (g * 255).astype(np.uint8)


def gradient_gray_image(gradient) -> np.ndarray:
    """Channel-summed |grad| of a (C, H, W) gradient, 99th-percentile
    normalized: an (H, W) uint8 image (``grad_vis.get_gradient_gray_image``)."""
    g = _to_numpy(gradient)
    if g.ndim != 3:
        raise ValueError(f"gradient_gray_image: expected (C, H, W), got {g.shape}")
    gray = np.abs(np.ascontiguousarray(g.transpose(1, 2, 0))).sum(axis=-1)
    hi = np.percentile(gray, 99)
    lo = gray.min()
    gray = np.clip((gray - lo) / (hi - lo + 1e-12), 0, 1)
    return (gray * 255).astype(np.uint8)


def positive_negative_saliency(gradient):
    """(pos, neg) saliency uint8 maps in the gradient's own layout
    (``grad_vis.get_positive_negative_saliency``)."""
    g = _to_numpy(gradient)
    pos = np.maximum(0, g) / (g.max() + 1e-12)
    neg = np.maximum(0, -g) / (-g.min() + 1e-12)
    return (pos * 255).astype(np.uint8), (neg * 255).astype(np.uint8)


def _grid_nhwc(imgs: np.ndarray, nrow: int, padding: int) -> np.ndarray:
    n, h, w, c = imgs.shape
    imgs = imgs - imgs.min()
    imgs = imgs * (255.0 / (imgs.max() + 1e-12))
    xmaps = min(nrow, n)
    ymaps = int(math.ceil(n / xmaps))
    grid = np.zeros(
        (ymaps * (h + padding) + padding, xmaps * (w + padding) + padding, c),
        np.float32,
    )
    for k in range(n):
        y, x = divmod(k, xmaps)
        y0 = y * (h + padding) + padding
        x0 = x * (w + padding) + padding
        grid[y0 : y0 + h, x0 : x0 + w] = imgs[k]
    return grid


def make_grid(images, nrow: int = 4, padding: int = 8) -> np.ndarray:
    """Tile (N, C, H, W) images into one grid image, min-max normalized to
    0-255 (the torchvision ``make_grid(normalize=True)`` the reference
    uses). Returns (grid_h, grid_w, C) float32, the layout cv2 writes."""
    return _grid_nhwc(_batch_nhwc(images, "make_grid"), nrow, padding)


def save_batch_image_with_joints(
    batch_image,
    batch_joints,
    batch_joints_vis=None,
    file_name: str = "debug_joints.jpg",
    nrow: int = 4,
    padding: int = 8,
) -> np.ndarray:
    """Grid of (N, C, H, W) images with per-sample joints drawn, written to
    ``file_name`` (``debug_vis.save_batch_image_with_joints``); returns the
    (grid_h, grid_w, 3) uint8 grid.

    ``batch_joints`` (N, J, >=2) in per-image pixel coords; ``batch_joints_
    vis`` (N, J) or (N, J, 1) visibility, default all-visible.
    """
    imgs = _batch_nhwc(batch_image, "save_batch_image_with_joints")
    n, h, w, _ = imgs.shape
    joints = _to_numpy(batch_joints)
    if batch_joints_vis is None:
        vis = np.ones(joints.shape[:2], np.float32)
    else:
        vis = _to_numpy(batch_joints_vis).reshape(joints.shape[0], -1)

    grid = np.clip(_grid_nhwc(imgs, nrow, padding), 0, 255).astype(np.uint8)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    grid = np.ascontiguousarray(grid)

    xmaps = min(nrow, n)
    for k in range(n):
        y, x = divmod(k, xmaps)
        for j in range(joints.shape[1]):
            if vis[k, j] <= 0:
                continue
            px = int(x * (w + padding) + padding + joints[k, j, 0])
            py = int(y * (h + padding) + padding + joints[k, j, 1])
            cv2.circle(grid, (px, py), 2, (255, 0, 0), 2)
    os.makedirs(osp.dirname(file_name) or ".", exist_ok=True)
    cv2.imwrite(file_name, grid)
    return grid


def denormalize_image(image, mean=None, std=None) -> np.ndarray:
    """Reverse the ImageNet normalization of a (3, H, W) RGB float image:
    an (H, W, 3) uint8 BGR image (``featuremaps_vis.tensor2im``)."""
    img = _to_numpy(image)
    if img.ndim != 3:
        raise ValueError(f"denormalize_image: expected (3, H, W), got {img.shape}")
    img = np.ascontiguousarray(img.transpose(1, 2, 0))
    m = np.asarray(IMAGENET_MEAN if mean is None else mean, np.float32)
    s = np.asarray(IMAGENET_STD if std is None else std, np.float32)
    img = (img * s + m) * 255.0
    img = np.clip(img, 0, 255).astype(np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
