"""Offset-field target generator (DEKR-style); port of
``fami_pose_tpu/data/target_generators.py``.

The reference's ``datasets/target_generators/target_generators.py:11-88``
(``OffsetGenerator``): per-joint (dx, dy) offset maps and weights between
two frames' joints, present in the reference but not wired into its
pipeline; kept for offset-supervised variants. Vectorized over joints and
on the device of the joints. The port's layout puts the joint and the
offset axis before the map: (B, J, 2, h, w) offsets, (B, J, h, w) weights.
"""

import torch


def generate_offset_targets(joints_a, joints_b, joints_vis, output_size,
                            radius: int = 4, per_pixel: bool = True):
    """Offset targets from frame A joints toward frame B joints.

    Args:
      joints_a, joints_b: (B, J, 2) coords in heatmap pixels.
      joints_vis: (B, J) visibility of both.
      output_size: (w, h).
      radius: stamp radius around the frame-A joint.
      per_pixel: per-pixel offsets within the radius (True) or a constant
        offset per joint (False).

    Returns:
      offsets: (B, J, 2, h, w) float32, channel 0 dx and 1 dy;
      weights: (B, J, h, w) float32.
    """
    w, h = int(output_size[0]), int(output_size[1])
    a = torch.as_tensor(joints_a).to(torch.float32)
    dev = a.device
    b = torch.as_tensor(joints_b, device=dev).to(torch.float32)
    vis = torch.as_tensor(joints_vis, device=dev).to(torch.float32)

    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (h, w)

    ax = a[..., 0][:, :, None, None]  # (B, J, 1, 1)
    ay = a[..., 1][:, :, None, None]
    bx = b[..., 0][:, :, None, None]
    by = b[..., 1][:, :, None, None]

    within = ((gx - ax).abs() <= radius) & ((gy - ay).abs() <= radius)
    weight = within.to(torch.float32) * vis[:, :, None, None]

    if per_pixel:
        dx = bx - gx
        dy = by - gy
    else:
        dx = (bx - ax).expand(weight.shape)
        dy = (by - ay).expand(weight.shape)
    offsets = torch.stack([dx, dy], dim=2) * weight[:, :, None]
    return offsets, weight
