"""Gaussian heatmap targets and heatmap decode on the device
(``fami_pose_tpu/ops/heatmap.py``): the separable integer-quantized target
stamp, and for the decode argmax, the classic ±0.25-pixel gradient-sign
refinement or the DARK refinement (Gaussian blur, log, one Newton step on
the second-order Taylor expansion), and the inverse-affine back-transform to
source-image pixels.

The back-transform uses the *classic* (non-DARK) affine even though the
crops are DARK-warped: that asymmetry is part of the reference protocol.
"""

import numpy as np
import torch

from .affine import affine_matrix, apply_affine


def generate_heatmaps(joints, joints_vis, sigma, image_size, heatmap_size):
    """Batched Gaussian target stamping.

    Args:
      joints: (..., J, 2) joint coordinates in input-crop pixels.
      joints_vis: (..., J) visibility (0/1).
      sigma: Gaussian width in heatmap pixels; the stamp covers 3 sigma.
      image_size, heatmap_size: (w, h) of the crop and of the target map.

    Returns ``target`` (..., J, Hh, Hw) float32 and ``weight`` (..., J, 1)
    float32 (1 visible, 0 invisible or window off the map). The centre is
    quantized as ``trunc(x / stride + 0.5)``; one outer product of two 1-D
    windows per joint reproduces the reference's windowed stamp.
    """
    hw, hh = int(heatmap_size[0]), int(heatmap_size[1])
    stride_x = image_size[0] / heatmap_size[0]
    stride_y = image_size[1] / heatmap_size[1]
    t = int(sigma * 3)
    joints = torch.as_tensor(joints).to(torch.float32)
    vis = torch.as_tensor(joints_vis).to(torch.float32).to(joints.device)

    mu_x = torch.trunc(joints[..., 0] / stride_x + 0.5)
    mu_y = torch.trunc(joints[..., 1] / stride_y + 0.5)
    in_window = ((mu_x - t < hw) & (mu_y - t < hh)
                 & (mu_x + t + 1 >= 0) & (mu_y + t + 1 >= 0))
    weight = vis * in_window.to(torch.float32)
    stamp = (weight > 0.5).to(torch.float32)

    xs = torch.arange(hw, dtype=torch.float32, device=joints.device)
    ys = torch.arange(hh, dtype=torch.float32, device=joints.device)
    dx = xs - mu_x[..., None]  # (..., J, Hw)
    dy = ys - mu_y[..., None]  # (..., J, Hh)
    inv_two_sigma2 = 1.0 / (2.0 * float(sigma) ** 2)
    gx = torch.exp(-dx * dx * inv_two_sigma2) * (dx.abs() <= t)
    gy = torch.exp(-dy * dy * inv_two_sigma2) * (dy.abs() <= t)
    target = gy[..., :, None] * gx[..., None, :] * stamp[..., None, None]
    return target, weight[..., None]


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


def _gaussian_kernel1d(ksize):
    """OpenCV's default Gaussian kernel for sigma=0:
    sigma = 0.3*((k-1)/2 - 1) + 0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def dark_blur(heatmaps, ksize=11):
    """Max-preserving Gaussian blur of (B, J, H, W) float32 heatmaps on
    zero-padded maps: two depthwise 1-D convolutions, then each map rescaled
    to its maximum before the blur."""
    b, j, h, w = heatmaps.shape
    k1 = torch.as_tensor(_gaussian_kernel1d(ksize), device=heatmaps.device)
    border = (ksize - 1) // 2
    orig_max = heatmaps.amax(dim=(2, 3), keepdim=True)
    x = heatmaps.reshape(b * j, 1, h, w)
    conv = torch.nn.functional.conv2d
    # float32 maps on the card: keep cuDNN out of TF32 for these two calls
    # (the one attribute, not ``torch.backends.cudnn.flags``, whose context
    # takes ~12 ms on an H100 host against the convolutions' 0.12 ms)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = conv(x, k1.view(1, 1, ksize, 1), padding=(border, 0))
        x = conv(x, k1.view(1, 1, 1, ksize), padding=(0, border))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    x = x.reshape(b, j, h, w)
    new_max = x.amax(dim=(2, 3), keepdim=True)
    # ratio first: x * orig_max can overflow f32 when heatmap magnitudes are
    # extreme (random weights); orig_max / new_max is always ~1
    return x * (orig_max / new_max.clamp(min=1e-20))


def taylor_refine(log_hm, coords):
    """Second-order (Newton) sub-pixel refinement on log heatmaps; no move
    next to the border or where the Hessian's determinant is zero."""
    _, _, h, w = log_hm.shape
    px = coords[..., 0].long()
    py = coords[..., 1].long()
    interior = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2)

    def g(dx, dy):
        return _gather_pixel(log_hm, px + dx, py + dy)

    dx = 0.5 * (g(1, 0) - g(-1, 0))
    dy = 0.5 * (g(0, 1) - g(0, -1))
    dxx = 0.25 * (g(2, 0) - 2.0 * g(0, 0) + g(-2, 0))
    dyy = 0.25 * (g(0, 2) - 2.0 * g(0, 0) + g(0, -2))
    dxy = 0.25 * (g(1, 1) - g(-1, 1) - g(1, -1) + g(-1, -1))

    det = dxx * dyy - dxy * dxy
    ok = interior & (det != 0.0)
    safe_det = torch.where(ok, det, torch.ones_like(det))
    # offset = -H^{-1} d, H = [[dxx, dxy], [dxy, dyy]]
    off_x = -(dyy * dx - dxy * dy) / safe_det
    off_y = -(-dxy * dx + dxx * dy) / safe_det
    offset = torch.stack([off_x, off_y], dim=-1) * ok[..., None].to(log_hm.dtype)
    return coords + offset


def dark_get_final_preds(heatmaps, center, scale):
    """DARK decode: blur + log + Taylor refinement + inverse affine, in
    float32: (B, J, H, W) heatmaps -> preds (B, J, 2), maxvals (B, J, 1)."""
    heatmaps = heatmaps.to(torch.float32)
    coords, maxvals = get_max_preds(heatmaps)
    hm = dark_blur(heatmaps, 11)
    log_hm = torch.log(hm.clamp(min=1e-10))
    coords = taylor_refine(log_hm, coords)
    hw = heatmaps.shape[3], heatmaps.shape[2]
    return transform_preds(coords, center, scale, hw), maxvals
