"""Translation warp, affine warp and the device person-box crop (NCHW).

Port of ``fami_pose_tpu/ops/warp.py``. ``warp_translate`` is the global
alignment head's warp, dst(x, y) = src(x - tx, y - ty), bilinear with zero
padding, translations clamped to ``±max_shift``. On a CUDA tensor it launches
the hand-written kernel ``ops/cuda/csrc/warp.cu`` (which replaces the TPU
kernel ``fami_pose_tpu/ops/pallas/warp.py::warp_translate_pallas``); on a CPU
tensor it runs :func:`warp_translate_plain`, the same function in plain
torch. The JAX package's ``WARP_IMPL`` choices (``slice``, ``matmul``,
``pallas``) all compute this one function, so the port has one warp for all
of them; only the clamp differs (32 for ``slice``).
"""

import torch

from .affine import affine_matrix, invert_affine


def warp_translate_plain(images, offsets, max_shift=32):
    """Plain torch translation warp.

    Args:
      images: (N, C, H, W).
      offsets: (N, 2) translations (tx, ty) in destination pixels.

    Returns (N, C, H, W) in ``images``' dtype, blended in float32.
    """
    n, c, h, w = images.shape
    m = int(max_shift) + 1
    pad = torch.nn.functional.pad(images.to(torch.float32), (m, m, m, m))
    t = offsets.to(torch.float32).clamp(-max_shift, max_shift)
    t0 = torch.floor(t)
    f = t - t0
    # integer origin of the (y - ty0, x - tx0) corner inside the padded image
    ox = (m - t0[:, 0]).long()
    oy = (m - t0[:, 1]).long()
    rows = torch.arange(h, device=images.device)
    cols = torch.arange(w, device=images.device)
    bidx = torch.arange(n, device=images.device)[:, None, None]

    def window(dy, dx):
        yy = (oy[:, None] + dy + rows[None, :])[:, :, None]  # (N, H, 1)
        xx = (ox[:, None] + dx + cols[None, :])[:, None, :]  # (N, 1, W)
        return pad.permute(0, 2, 3, 1)[bidx, yy, xx].permute(0, 3, 1, 2)

    s11 = window(0, 0)
    s10 = window(0, -1)
    s01 = window(-1, 0)
    s00 = window(-1, -1)
    fx = f[:, 0].view(n, 1, 1, 1)
    fy = f[:, 1].view(n, 1, 1, 1)
    top = s00 * fx + s01 * (1 - fx)
    bot = s10 * fx + s11 * (1 - fx)
    return (top * fy + bot * (1 - fy)).to(images.dtype)


def _warp_translate_cuda(images, offsets, max_shift):
    from .cuda.build import DTYPE_CODES, check, load_library, stream_ptr

    dtype = str(images.dtype).replace("torch.", "")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"warp kernel takes float32 or bfloat16, got {dtype}")
    if images.dim() != 4 or offsets.shape != (images.shape[0], 2):
        raise ValueError(
            f"images (N, C, H, W) and offsets (N, 2) expected, got "
            f"{tuple(images.shape)} and {tuple(offsets.shape)}"
        )
    if offsets.device != images.device:
        raise ValueError("images and offsets must be on the same device")
    images = images.contiguous()
    offsets = offsets.to(torch.float32).contiguous()
    out = torch.empty_like(images)
    lib = load_library()
    n, c, h, w = images.shape
    err = lib.fami_warp_translate(
        images.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        DTYPE_CODES[dtype], n, c, h, w, float(max_shift), stream_ptr(images),
    )
    check(lib, err, "fami_warp_translate")
    warp_translate.launches += 1
    return out


class _WarpTranslate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, offsets, max_shift):
        return _warp_translate_cuda(images, offsets, max_shift)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "warp backward: comes with the training slice (ROADMAP Queue 1 "
            "item 7)"
        )


def warp_translate(images, offsets, max_shift=32):
    """Translation warp: the CUDA kernel for a CUDA tensor, the plain torch
    version for a CPU tensor. ``warp_translate.launches`` counts kernel
    launches."""
    if images.device.type == "cpu":
        return warp_translate_plain(images, offsets, max_shift)
    if images.device.type != "cuda":
        raise ValueError(f"no warp kernel for device {images.device}")
    return _WarpTranslate.apply(images, offsets, max_shift)


warp_translate.launches = 0


def bilinear_sample(img, sx, sy):
    """Bilinearly sample (N, C, H, W) ``img`` at per-image float coords;
    zeros outside.

    ``sx``/``sy`` are matching (N, ...) shapes; returns (N, C, ...) float32.
    The corners are gathered in ``img``'s dtype (e.g. uint8 frames) and
    blended in float32.
    """
    n, c, h, w = img.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0).unsqueeze(1)
    wy = (sy - y0).unsqueeze(1)
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(n, c, h * w)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, -1))
        return (vals.reshape(n, c, *yi.shape[1:]).to(torch.float32)
                * valid.unsqueeze(1).to(torch.float32))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def warp_affine(images, mats, out_hw, inverse_given=False):
    """Warp (N, C, H, W) images by per-image (N, 2, 3) affine matrices
    (src->dst, or dst->src with ``inverse_given``); returns (N, C, oh, ow)
    float32, all images in one batched gather."""
    inv = mats if inverse_given else invert_affine(mats)
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    dev = images.device
    gy, gx = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij",
    )
    m = inv.to(dev)[..., None, None]  # (N, 2, 3, 1, 1)
    sx = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    sy = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    return bilinear_sample(images, sx, sy)


def crop_and_warp(images, centers, scales, rots, out_hw, dark=True):
    """Batched person-box crop on the device: (N, C, H, W) frames (uint8 or
    float) -> (N, C, out_h, out_w) float32 crops.

    ``centers``/``scales`` (N, 2), ``rots`` (N,) degrees; ``dark`` selects
    the DARK half-pixel convention (the reference's input-crop choice).
    """
    out_h, out_w = out_hw
    inv = affine_matrix(
        torch.as_tensor(centers, dtype=torch.float32, device=images.device),
        scales, rots, (out_w, out_h), inv=True, dark=dark,
    )
    return warp_affine(images, inv, (out_h, out_w), inverse_given=True)
