"""Eval input preparation on the device: person-box crop + ImageNet
normalization (``fami_pose_tpu/data/loader.py::prepare_eval_inputs_device_crop``).

Frames stay uint8 until the crop samples them; the crop runs on the device
(``ops.warp.crop_and_warp``), so no ``cv2`` is needed on this path.
"""

import numpy as np
import torch

from fami_pose_torch.ops.warp import crop_and_warp

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(x):
    """(N, 3k, H, W) pixel values in [0, 255] -> ImageNet-normalized f32."""
    c = x.shape[1] // 3
    mean = torch.as_tensor(np.tile(IMAGENET_MEAN, c), device=x.device)
    std = torch.as_tensor(np.tile(IMAGENET_STD, c), device=x.device)
    x = x.to(torch.float32) / 255.0
    return (x - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)


def prepare_eval_inputs_device_crop(kf_raw, sup_raw, center, scale, rotation,
                                    image_size):
    """Crop + normalize one key frame and its stacked supporting frames.

    Args:
      kf_raw: (B, 3, H, W) frames; sup_raw: (B, 3N, H, W), N frames stacked
        on the channel axis like the model's input.
      center, scale: (B, 2) box parameters; rotation: (B,) degrees.
      image_size: (w, h) of the crop, as in ``MODEL.IMAGE_SIZE``.

    Returns:
      (kf, sup): (B, 3, h, w) and (B, 3N, h, w) float32.
    """
    out_hw = (int(image_size[1]), int(image_size[0]))
    b, c3 = sup_raw.shape[:2]
    n = c3 // 3
    kf = crop_and_warp(kf_raw, center, scale, rotation, out_hw)
    sup = crop_and_warp(
        sup_raw.reshape(b * n, 3, *sup_raw.shape[2:]),
        center.repeat_interleave(n, 0), scale.repeat_interleave(n, 0),
        rotation.repeat_interleave(n, 0), out_hw,
    ).reshape(b, c3, *out_hw)
    return normalize(kf), normalize(sup)
