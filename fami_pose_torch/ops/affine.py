"""Affine crop-warp geometry, in closed form (``fami_pose_tpu/ops/affine.py``).

The person-crop transform is a uniform-scale similarity: scale factor
``dst_w / src_w`` with ``src_w = scale[0] * 200``, a rotation, and a
translation, so it is computed analytically instead of by solving a
3-point system per box.

Two pixel conventions are kept, as in the reference protocol:
  * classic (``get_affine_transform``): extents measured as ``w``; used by
    the decode back-transform;
  * DARK (``dark_get_affine_transform``): extents measured as ``w - 1``;
    used for the input crop.

``affine_matrix`` is the batched torch version (the device crop and the
decode run it on the device); the ``*_affine_transform`` wrappers are the
numpy host side for one box.
"""

import math

import numpy as np
import torch

PIXEL_STD = 200.0


def _matvec(m, v):
    # explicit 2x2 multiply-add, the same arithmetic as the JAX package
    ox = m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1]
    oy = m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1]
    return torch.stack([ox, oy], dim=-1)


def affine_matrix(center, scale, rot_deg, output_size, shift=None, inv=False,
                  dark=False):
    """Closed-form crop transform, batched, in float32.

    Args:
      center: (..., 2) box centers in source-image pixels.
      scale: (..., 2) box scale in units of 200 px.
      rot_deg: (...,) rotation in degrees.
      output_size: (w, h) of the destination crop.
      shift: optional (..., 2) shift in units of the source box size.
      inv: return the dst->src matrix instead of src->dst.
      dark: DARK half-pixel convention (extent = size - 1).

    Returns:
      (..., 2, 3) float32 matrices, on ``center``'s device.
    """
    center = torch.as_tensor(center, dtype=torch.float32)
    dev = center.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    rot = torch.as_tensor(rot_deg, dtype=torch.float32, device=dev) * (
        math.pi / 180.0
    )
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src_w = scale[..., 0] * PIXEL_STD
    if dark:
        s = (dst_w - 1.0) / (src_w - 1.0)
        d0 = torch.stack(
            [torch.full_like(src_w, (dst_w - 1.0) * 0.5),
             torch.full_like(src_w, (dst_h - 1.0) * 0.5)], dim=-1,
        )
    else:
        s = dst_w / src_w
        d0 = torch.stack(
            [torch.full_like(src_w, dst_w * 0.5),
             torch.full_like(src_w, dst_h * 0.5)], dim=-1,
        )
    p0 = center
    if shift is not None:
        p0 = p0 + scale * PIXEL_STD * torch.as_tensor(
            shift, dtype=torch.float32, device=dev
        )
    rot = torch.broadcast_to(rot, src_w.shape)
    cs, sn = torch.cos(rot), torch.sin(rot)
    if inv:
        # src = center + R(rot) @ (dst - d0) / s
        inv_s = 1.0 / s
        lin = torch.stack(
            [torch.stack([cs * inv_s, -sn * inv_s], dim=-1),
             torch.stack([sn * inv_s, cs * inv_s], dim=-1)], dim=-2,
        )
        trans = p0 - _matvec(lin, d0)
    else:
        # dst = d0 + s * R(-rot) @ (src - center)
        lin = torch.stack(
            [torch.stack([cs * s, sn * s], dim=-1),
             torch.stack([-sn * s, cs * s], dim=-1)], dim=-2,
        )
        trans = d0 - _matvec(lin, p0)
    return torch.cat([lin, trans[..., None]], dim=-1)


def apply_affine(points, mat):
    """Apply (..., 2, 3) matrices to (..., N, 2) points (or (..., 2))."""
    points = torch.as_tensor(points, dtype=torch.float32)
    mat = torch.as_tensor(mat, dtype=torch.float32, device=points.device)
    m = mat if points.dim() == mat.dim() - 1 else mat[..., None, :, :]
    x, y = points[..., 0], points[..., 1]
    ox = m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2]
    oy = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2]
    return torch.stack([ox, oy], dim=-1)


def invert_affine(mat):
    """Invert (..., 2, 3) affine matrices analytically."""
    a, b, tx = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    c, d, ty = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack(
        [torch.stack([ia, ib, itx], dim=-1),
         torch.stack([ic, id_, ity], dim=-1)], dim=-2,
    )


def _host_matrix(center, scale, rot, output_size, shift, inv, dark):
    """:func:`affine_matrix` for one box in numpy float32, operation for
    operation as the JAX package's host path computes it: the datasets hand
    this matrix to ``cv2.warpAffine``, where a last-bit difference moves
    pixels, so the host crops of both packages agree bit for bit."""
    f32 = np.float32
    center = np.asarray(center, f32)
    scale = np.asarray(scale, f32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], f32)
    rot = np.asarray(float(rot), f32) * (np.pi / 180.0)
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src_w = scale[..., 0] * PIXEL_STD
    if dark:
        s = (dst_w - 1.0) / (src_w - 1.0)
        d0 = np.stack([np.full_like(src_w, (dst_w - 1.0) * 0.5),
                       np.full_like(src_w, (dst_h - 1.0) * 0.5)], axis=-1)
    else:
        s = dst_w / src_w
        d0 = np.stack([np.full_like(src_w, dst_w * 0.5),
                       np.full_like(src_w, dst_h * 0.5)], axis=-1)
    p0 = center + scale * PIXEL_STD * np.asarray(shift, f32)
    cs, sn = np.cos(rot), np.sin(rot)

    def matvec(m, v):
        return np.stack([m[0, 0] * v[0] + m[0, 1] * v[1],
                         m[1, 0] * v[0] + m[1, 1] * v[1]], axis=-1)

    if inv:
        inv_s = 1.0 / s
        lin = np.stack([np.stack([cs * inv_s, -sn * inv_s], axis=-1),
                        np.stack([sn * inv_s, cs * inv_s], axis=-1)], axis=-2)
        trans = p0 - matvec(lin, d0)
    else:
        lin = np.stack([np.stack([cs * s, sn * s], axis=-1),
                        np.stack([-sn * s, cs * s], axis=-1)], axis=-2)
        trans = d0 - matvec(lin, p0)
    return np.concatenate([lin, trans[..., None]], axis=-1).astype(np.float64)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], np.float32), inv=0):
    """Classic-convention crop matrix, numpy, one box."""
    return _host_matrix(center, scale, rot, output_size, shift, inv, False)


def dark_get_affine_transform(center, scale, rot, output_size,
                              shift=np.array([0, 0], np.float32), inv=0):
    """DARK-convention crop matrix, numpy, one box."""
    return _host_matrix(center, scale, rot, output_size, shift, inv, True)


def exec_affine_transform(pt, t):
    """Warp one 2-D point by a 2x3 matrix (host-side, numpy)."""
    pt = np.asarray(pt, dtype=np.float64)
    return t[:, :2] @ pt[:2] + t[:, 2]
