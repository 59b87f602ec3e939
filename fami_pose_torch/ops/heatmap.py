"""Heatmap decode on the device (``fami_pose_tpu/ops/heatmap.py``):
argmax, the classic ±0.25-pixel gradient-sign refinement, and the
inverse-affine back-transform to source-image pixels.

The back-transform uses the *classic* (non-DARK) affine even though the
crops are DARK-warped: that asymmetry is part of the reference protocol.
"""

import torch

from .affine import affine_matrix, apply_affine


def get_max_preds(heatmaps):
    """(B, J, H, W) -> coords (B, J, 2) xy float32, maxvals (B, J, 1)."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, h * w)
    maxvals = flat.amax(dim=-1, keepdim=True)
    idx = torch.argmax(flat, dim=-1)  # first maximum, as jnp.argmax
    px = (idx % w).to(torch.float32)
    py = torch.floor(idx.to(torch.float32) / w)
    coords = torch.stack([px, py], dim=-1)
    return coords * (maxvals > 0.0).to(torch.float32), maxvals


def _gather_pixel(heatmaps, px, py):
    b, j, h, w = heatmaps.shape
    px = px.clamp(0, w - 1)
    py = py.clamp(0, h - 1)
    flat = heatmaps.reshape(b, j, h * w)
    return torch.gather(flat, 2, (py * w + px)[..., None])[..., 0]


def shift_by_gradient_sign(heatmaps, coords):
    """Move each coordinate 0.25 px toward the higher neighbour, per axis."""
    _, _, h, w = heatmaps.shape
    px = torch.floor(coords[..., 0] + 0.5).long()
    py = torch.floor(coords[..., 1] + 0.5).long()
    interior = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    dx = _gather_pixel(heatmaps, px + 1, py) - _gather_pixel(heatmaps, px - 1, py)
    dy = _gather_pixel(heatmaps, px, py + 1) - _gather_pixel(heatmaps, px, py - 1)
    delta = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return coords + delta * interior[..., None].to(coords.dtype)


def transform_preds(coords, center, scale, heatmap_wh):
    """Heatmap coords (B, J, 2) -> source-image pixels (classic inverse
    affine); center/scale (B, 2); heatmap_wh (w, h)."""
    center = torch.as_tensor(center, dtype=torch.float32, device=coords.device)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=coords.device)
    inv = affine_matrix(
        center, scale, torch.zeros(center.shape[:-1], device=coords.device),
        heatmap_wh, inv=True, dark=False,
    )
    return apply_affine(coords, inv)


def get_final_preds(heatmaps, center, scale):
    """argmax + gradient-sign shift + inverse affine: (B, J, H, W) float32
    heatmaps -> preds (B, J, 2), maxvals (B, J, 1)."""
    heatmaps = heatmaps.to(torch.float32)
    coords, maxvals = get_max_preds(heatmaps)
    coords = shift_by_gradient_sign(heatmaps, coords)
    hw = heatmaps.shape[3], heatmaps.shape[2]
    return transform_preds(coords, center, scale, hw), maxvals
