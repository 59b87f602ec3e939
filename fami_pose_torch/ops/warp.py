"""Translation warp, affine warp and the device person-box crop (NCHW).

Port of ``fami_pose_tpu/ops/warp.py``. ``warp_translate`` is the global
alignment head's warp, dst(x, y) = src(x - tx, y - ty), bilinear with zero
padding, translations clamped to ``±max_shift``. On a CUDA tensor it launches
the hand-written kernel ``ops/cuda/csrc/warp.cu`` (which replaces the TPU
kernel ``fami_pose_tpu/ops/pallas/warp.py::warp_translate_pallas``); on a CPU
tensor it runs :func:`warp_translate_plain`, the same function in plain
torch. Its gradient is the kernel ``ops/cuda/csrc/warp_bwd.cu`` on the card
and :func:`warp_translate_backward_plain` on the CPU, through one
``torch.autograd.Function`` for both devices. The JAX package's ``WARP_IMPL``
choices (``slice``, ``matmul``, ``pallas``) compute this one function and
differ only where a bf16 warp rounds (and in the clamp: 32 for ``slice``), so
the port's warp takes the choice as ``impl`` and rounds at the same points
(:data:`BLEND_CODES`); in float32 the three agree to an ulp and the port
blends once. The backward is the gradient of the exact blend whatever
``impl`` is.
"""

import torch

from .affine import affine_matrix, invert_affine

# where a bf16 warp rounds, by the JAX warp it follows (the kernel's
# ``blend`` argument, ``csrc/warp.cu::Blend``):
#   pallas - blends columns, then rows, in f32 and rounds once;
#   matmul - rounds the four weights, blends rows first and rounds that
#            pass, then blends columns and rounds (two bf16 matmuls);
#   slice  - rounds fx, fy, then 1 - fx, 1 - fy, and every product and
#            sum of the column-then-row blend (bf16 elementwise ops).
BLEND_CODES = {"pallas": 0, "matmul": 1, "slice": 2}


def _blend_code(impl):
    if impl not in BLEND_CODES:
        raise ValueError(f"warp impl {impl!r}, expected one of "
                         f"{sorted(BLEND_CODES)}")
    return BLEND_CODES[impl]


def _shift_parts(offsets, max_shift):
    """Clamp (N, 2) translations and split them: integer parts (tx0, ty0) as
    int64 (N,), fractions (fx, fy) as float32 (N, 1, 1, 1), and the per-axis
    pass-through of the clamp (bounds included, as ``torch.clamp``)."""
    raw = offsets.to(torch.float32)
    t = raw.clamp(-max_shift, max_shift)
    t0 = torch.floor(t)
    f = (t - t0).view(-1, 2, 1, 1, 1)
    passes = (raw >= -max_shift) & (raw <= max_shift)
    return t0[:, 0].long(), t0[:, 1].long(), f[:, 0], f[:, 1], passes


def _shifted(img, dy, dx, margin):
    """``img`` (N, C, H, W) float32 read at (y + dy[n], x + dx[n]), zeros
    outside; per-image integer shifts within ``±margin``."""
    n, c, h, w = img.shape
    pad = torch.nn.functional.pad(img, (margin,) * 4).permute(0, 2, 3, 1)
    rows = torch.arange(h, device=img.device)
    cols = torch.arange(w, device=img.device)
    bidx = torch.arange(n, device=img.device)[:, None, None]
    yy = (margin + dy[:, None] + rows[None, :])[:, :, None]  # (N, H, 1)
    xx = (margin + dx[:, None] + cols[None, :])[:, None, :]  # (N, 1, W)
    return pad[bidx, yy, xx].permute(0, 3, 1, 2)


def _blend(s00, s01, s10, s11, fx, fy, impl, dtype):
    """The bilinear blend of the four corners (float32), rounded to
    ``dtype`` where the JAX warp ``impl`` rounds (:data:`BLEND_CODES`);
    in f32 and wider types the three agree to an ulp and blend once."""
    if _blend_code(impl) == BLEND_CODES["pallas"] or dtype.itemsize >= 4:
        top = s00 * fx + s01 * (1 - fx)
        bot = s10 * fx + s11 * (1 - fx)
        return top * fy + bot * (1 - fy)

    def rnd(t):
        return t.to(dtype).to(torch.float32)

    if impl == "matmul":
        wx, wx1, wy, wy1 = rnd(fx), rnd(1 - fx), rnd(fy), rnd(1 - fy)
        left = rnd(wy * s00 + wy1 * s10)  # the row pass, column x - tx0 - 1
        right = rnd(wy * s01 + wy1 * s11)  # column x - tx0
        return wx * left + wx1 * right
    wx, wy = rnd(fx), rnd(fy)
    wx1, wy1 = rnd(1 - wx), rnd(1 - wy)
    top = rnd(rnd(s00 * wx) + rnd(s01 * wx1))
    bot = rnd(rnd(s10 * wx) + rnd(s11 * wx1))
    return rnd(top * wy) + rnd(bot * wy1)


def warp_translate_plain(images, offsets, max_shift=32, impl="matmul"):
    """Plain torch translation warp.

    Args:
      images: (N, C, H, W).
      offsets: (N, 2) translations (tx, ty) in destination pixels.
      impl: the JAX warp whose bf16 roundings to follow (:data:`BLEND_CODES`).

    Returns (N, C, H, W) in ``images``' dtype.
    """
    m = int(max_shift) + 1
    img = images.to(torch.float32)
    tx0, ty0, fx, fy, _ = _shift_parts(offsets, max_shift)
    s11 = _shifted(img, -ty0, -tx0, m)
    s10 = _shifted(img, -ty0, -tx0 - 1, m)
    s01 = _shifted(img, -ty0 - 1, -tx0, m)
    s00 = _shifted(img, -ty0 - 1, -tx0 - 1, m)
    return _blend(s00, s01, s10, s11, fx, fy, impl,
                  images.dtype).to(images.dtype)


def warp_translate_backward_plain(images, offsets, gout, max_shift=32):
    """Plain torch gradients of :func:`warp_translate_plain`.

    Returns ``(d_images, d_offsets)`` in the inputs' dtypes. d_images is the
    4-corner adjoint, a translation of ``gout`` by -t. d_offsets sums
    ``gout * d out / d t`` over channels and pixels; the translation is split
    into floor and fraction, so at an integer translation this is the
    right-hand derivative (as in the JAX package's warps, and unlike the
    DCN's convention), and it is zero on an axis whose raw translation lies
    outside ``±max_shift``.
    """
    m = int(max_shift) + 1
    img = images.to(torch.float32)
    g = gout.to(torch.float32)
    tx0, ty0, fx, fy, passes = _shift_parts(offsets, max_shift)
    g11 = _shifted(g, ty0, tx0, m)
    g10 = _shifted(g, ty0, tx0 + 1, m)
    g01 = _shifted(g, ty0 + 1, tx0, m)
    g00 = _shifted(g, ty0 + 1, tx0 + 1, m)
    d_images = (fy * (fx * g00 + (1 - fx) * g01)
                + (1 - fy) * (fx * g10 + (1 - fx) * g11))
    s11 = _shifted(img, -ty0, -tx0, m)
    s10 = _shifted(img, -ty0, -tx0 - 1, m)
    s01 = _shifted(img, -ty0 - 1, -tx0, m)
    s00 = _shifted(img, -ty0 - 1, -tx0 - 1, m)
    d_tx = (g * (fy * (s00 - s01) + (1 - fy) * (s10 - s11))).sum(dim=(1, 2, 3))
    d_ty = (g * ((fx * s00 + (1 - fx) * s01)
                 - (fx * s10 + (1 - fx) * s11))).sum(dim=(1, 2, 3))
    d_offsets = torch.stack([d_tx, d_ty], dim=1) * passes
    return d_images.to(images.dtype), d_offsets.to(offsets.dtype)


def _check_warp_args(images, offsets):
    from .cuda.build import DTYPE_CODES

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
    return DTYPE_CODES[dtype]


def _warp_translate_cuda(images, offsets, max_shift, impl):
    from .cuda.build import check, load_library, stream_ptr

    code = _check_warp_args(images, offsets)
    blend = _blend_code(impl)
    images = images.contiguous()
    offsets = offsets.to(torch.float32).contiguous()
    out = torch.empty_like(images)
    lib = load_library()
    n, c, h, w = images.shape
    err = lib.fami_warp_translate(
        images.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        code, blend, n, c, h, w, float(max_shift),
        stream_ptr(images),
    )
    check(lib, err, "fami_warp_translate")
    warp_translate.launches += 1
    return out


def _warp_translate_backward_cuda(images, offsets, gout, max_shift):
    from .cuda.build import check, load_library, stream_ptr

    code = _check_warp_args(images, offsets)
    if gout.shape != images.shape or gout.device != images.device:
        raise ValueError(f"gout {tuple(gout.shape)} on {gout.device}, expected "
                         f"{tuple(images.shape)} on {images.device}")
    images = images.contiguous()
    gout = gout.to(images.dtype).contiguous()
    offs = offsets.to(torch.float32).contiguous()
    d_images = torch.empty_like(images)
    # the blocks write their partial sums into the scratch buffer; a second
    # launch sums each image's partials in a fixed order into d_offsets
    d_offsets = torch.empty_like(offs)
    lib = load_library()
    n, c, h, w = images.shape
    blocks = lib.fami_warp_translate_bwd_blocks(code, c, h, w)
    if blocks < 0:
        raise ValueError(f"warp_bwd takes no shape {tuple(images.shape)}")
    partials = torch.empty(2 * n * blocks, dtype=torch.float32,
                           device=images.device)
    err = lib.fami_warp_translate_bwd(
        images.data_ptr(), offs.data_ptr(), gout.data_ptr(),
        d_images.data_ptr(), d_offsets.data_ptr(), partials.data_ptr(), code,
        n, c, h, w, float(max_shift), stream_ptr(images),
    )
    check(lib, err, "fami_warp_translate_bwd")
    warp_translate_backward.launches += 1
    return d_images, d_offsets.to(offsets.dtype)


def warp_translate_backward(images, offsets, gout, max_shift=32):
    """Gradients ``(d_images, d_offsets)`` of the translation warp: the
    plain version for CPU tensors, the CUDA kernel ``ops/cuda/csrc/warp_bwd.cu``
    (counted in ``warp_translate_backward.launches``) for CUDA tensors, or an
    error. The kernel sums ``d_offsets`` in an order fixed by the shape, so
    two calls on the same inputs give the same bits."""
    if images.device.type == "cpu":
        return warp_translate_backward_plain(images, offsets, gout, max_shift)
    if images.device.type != "cuda":
        raise ValueError(f"no warp kernel for device {images.device}")
    return _warp_translate_backward_cuda(images, offsets, gout, max_shift)


warp_translate_backward.launches = 0


class _WarpTranslate(torch.autograd.Function):
    """The warp on either device: kernel or plain version, forward and
    backward, chosen by ``images.device``."""

    @staticmethod
    def forward(ctx, images, offsets, max_shift, impl):
        ctx.save_for_backward(images, offsets)
        ctx.max_shift = max_shift
        if images.device.type == "cpu":
            return warp_translate_plain(images, offsets, max_shift, impl)
        return _warp_translate_cuda(images, offsets, max_shift, impl)

    @staticmethod
    def backward(ctx, gout):
        images, offsets = ctx.saved_tensors
        d_images, d_offsets = warp_translate_backward(
            images, offsets, gout, ctx.max_shift
        )
        need = ctx.needs_input_grad
        return (d_images if need[0] else None,
                d_offsets if need[1] else None, None, None)


def warp_translate(images, offsets, max_shift=32, impl="matmul"):
    """Translation warp, differentiable in images and offsets: the CUDA
    kernels for a CUDA tensor, the plain torch versions for a CPU tensor.
    ``impl`` names the JAX warp (``TPU.WARP_IMPL``, default ``matmul`` as
    in both packages' configs) whose bf16 roundings the forward follows.
    ``warp_translate.launches`` counts the forward kernel's launches,
    ``warp_translate_backward.launches`` the backward's."""
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no warp kernel for device {images.device}")
    return _WarpTranslate.apply(images, offsets, max_shift, impl)


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
