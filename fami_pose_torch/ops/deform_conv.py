"""Modulated deformable convolution (DCNv2), NCHW.

Port of ``fami_pose_tpu/ops/deform_conv.py``, torchvision-compatible:
  * ``offset`` (N, 2*G*K, Ho, Wo): channel ``2*(g*K + k)`` is the vertical
    shift of group ``g``, tap ``k``, channel ``2*(g*K + k) + 1`` the
    horizontal one (the canonical ``[g][k][(dy, dx)]`` order);
  * ``mask`` (N, G*K, Ho, Wo) multiplies the sampled value raw (no sigmoid);
  * output pixel (i, j), tap (a, b) samples x at
    ``(i*stride - pad + a*dil + dy, j*stride - pad + b*dil + dx)``,
    bilinear, zeros outside the input.

``deform_conv2d_windowed`` is the model's DCN: the same function with each
offset clamped to ``[-max_offset, max_offset]`` per axis (``max_offset`` None
or <= 0: the exact, unclamped DCN). The JAX package computes the clamped
function with a gather-free hat-window scan because the TPU has no fast
gather; the scan is the same function as "clamp, then exact bilinear gather"
(``fami_pose_tpu/ops/deform_conv.py:225-245``), so the plain version here is
the latter. On a CUDA tensor the wrapper launches the hand-written kernel
``ops/cuda/csrc/dcn_fwd.cu`` (which replaces the TPU kernel
``fami_pose_tpu/ops/pallas/dcn.py::deform_conv2d_pallas``).
"""

import torch


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _bilinear_grouped(xg, py, px):
    """xg (N, G, Cg, H, W) float32; py/px (N, G, Ho, Wo) float32 sample
    coords -> (N, G, Cg, Ho, Wo), zeros outside the image.

    The integer and fractional parts of a coordinate are taken from the
    offset alone (``base + floor(t)``, ``t - floor(t)``), which is exact;
    ``floor(base + t)`` would round ``t`` to the coordinate's ulp first.
    """
    n, g, cg, h, w = xg.shape
    flat = xg.reshape(n, g, cg, h * w)

    def split(p):
        base, t = p
        t0 = torch.floor(t)
        return (base + t0).long(), (t - t0).unsqueeze(2)

    y0, fy = split(py)
    x0, fx = split(px)

    def corner(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).unsqueeze(2)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, g, 1, -1)
        vals = torch.gather(flat, 3, idx.expand(-1, -1, cg, -1))
        return vals.reshape(n, g, cg, *yi.shape[2:]) * valid

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def deform_conv2d(x, offset, mask, weight, bias=None, *, stride=1, padding=0,
                  dilation=1, offset_groups=None, max_offset=None):
    """Plain torch modulated deformable conv (NCHW), computed in float32.

    Args:
      x: (N, C, H, W); offset: (N, 2*G*K, Ho, Wo); mask: (N, G*K, Ho, Wo) or
        None (DCNv1); weight: (C_out, C, kh, kw); bias: (C_out,) or None.
      offset_groups: G, inferred from the offset channels by default.
      max_offset: clamp every offset to [-max_offset, max_offset] first
        (None or <= 0: no clamp).

    Returns (N, C_out, Ho, Wo) in ``x``'s dtype: the f32 result is cast,
    then the bias is added, as the kernel's wrapper does.
    """
    n, c, h, w = x.shape
    c_out, wc, kh, kw = weight.shape
    if wc != c:
        raise ValueError(f"weight expects {wc} input channels, x has {c}")
    k = kh * kw
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    g = offset_groups or offset.shape[1] // (2 * k)
    if offset.shape[1] != 2 * g * k:
        raise ValueError(
            f"offset has {offset.shape[1]} channels, expected {2 * g * k}"
        )
    if c % g != 0:
        raise ValueError(f"channels {c} not divisible by offset groups {g}")
    cg = c // g
    ho, wo = offset.shape[2], offset.shape[3]

    f32 = torch.float32
    off = offset.to(f32).reshape(n, g, k, 2, ho, wo)
    if max_offset is not None and float(max_offset) > 0:
        off = off.clamp(-float(max_offset), float(max_offset))
    msk = None if mask is None else mask.to(f32).reshape(n, g, k, ho, wo)
    xg = x.to(f32).reshape(n, g, cg, h, w)
    ys = (torch.arange(ho, device=x.device) * sh - ph).view(1, 1, ho, 1)
    xs = (torch.arange(wo, device=x.device) * sw - pw).view(1, 1, 1, wo)

    cols = []
    for a in range(kh):
        for b in range(kw):
            t = a * kw + b
            py = (ys + a * dh, off[:, :, t, 0])
            px = (xs + b * dw, off[:, :, t, 1])
            v = _bilinear_grouped(xg, py, px)  # (N, G, Cg, Ho, Wo)
            if msk is not None:
                v = v * msk[:, :, t].unsqueeze(2)
            cols.append(v.reshape(n, c, ho * wo))
    col = torch.stack(cols, dim=1).reshape(n, k * c, ho * wo)  # [k][c] rows
    w_flat = weight.to(f32).permute(0, 2, 3, 1).reshape(c_out, k * c)
    out = torch.matmul(w_flat, col).reshape(n, c_out, ho, wo).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out


def _check_kernel_args(x, offset, mask, weight, padding, dilation, groups):
    tensors = {"x": x, "offset": offset, "weight": weight}
    if mask is not None:
        tensors["mask"] = mask
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    n, c, h, w = x.shape
    c_out, wc, kh, kw = weight.shape
    k = kh * kw
    ho = h + 2 * padding - dilation * (kh - 1)
    wo = w + 2 * padding - dilation * (kw - 1)
    if wc != c or c % groups != 0:
        raise ValueError(f"bad channels: x {c}, weight {wc}, groups {groups}")
    if tuple(offset.shape) != (n, 2 * groups * k, ho, wo):
        raise ValueError(
            f"offset {tuple(offset.shape)}, expected "
            f"{(n, 2 * groups * k, ho, wo)}"
        )
    if mask is not None and tuple(mask.shape) != (n, groups * k, ho, wo):
        raise ValueError(
            f"mask {tuple(mask.shape)}, expected {(n, groups * k, ho, wo)}"
        )
    if c_out not in (16, 32, 48, 64):
        raise ValueError(f"DCN kernel takes C_out in 16/32/48/64, got {c_out}")
    smem = k * c * (c_out + 64) * 4
    if smem > 232448:
        raise ValueError(
            f"DCN kernel: weights + column tile need {smem} B of shared "
            f"memory (C={c}, C_out={c_out}); the card has 232448"
        )
    return ho, wo


def _deform_conv_cuda(x, offset, mask, weight, padding, dilation, groups,
                      max_offset):
    from .cuda.build import DTYPE_CODES, check, load_library, stream_ptr

    dtype = str(x.dtype).replace("torch.", "")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"DCN kernel takes float32 or bfloat16, got {dtype}")
    ho, wo = _check_kernel_args(
        x, offset, mask, weight, padding, dilation, groups
    )
    x, offset, weight = x.contiguous(), offset.contiguous(), weight.contiguous()
    mask = None if mask is None else mask.contiguous()
    n, c, h, w = x.shape
    c_out, _, kh, kw = weight.shape
    out = torch.empty((n, c_out, ho, wo), dtype=x.dtype, device=x.device)
    lib = load_library()
    err = lib.fami_dcn_fwd(
        x.data_ptr(), offset.data_ptr(),
        None if mask is None else mask.data_ptr(), weight.data_ptr(),
        out.data_ptr(), DTYPE_CODES[dtype], n, c, h, w, c_out, ho, wo, kh, kw,
        padding, dilation, groups,
        float(max_offset) if max_offset is not None else 0.0,
        stream_ptr(x),
    )
    check(lib, err, "fami_dcn_fwd")
    deform_conv2d_windowed.launches += 1
    return out


class _DeformConvWindowed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, weight, padding, dilation, groups,
                max_offset):
        return _deform_conv_cuda(
            x, offset, mask, weight, padding, dilation, groups, max_offset
        )

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("DCN backward kernel: ROADMAP Queue 2 item 2")


def deform_conv2d_windowed(x, offset, mask, weight, bias=None, *, padding=0,
                           dilation=1, offset_groups=None, max_offset=6):
    """The model's DCN: stride 1, offsets clamped to ±``max_offset`` (None or
    <= 0: exact). A CPU tensor runs :func:`deform_conv2d`; a CUDA tensor
    launches the kernel (``deform_conv2d_windowed.launches`` counts them)
    or raises. The bias is added after the kernel, in ``x``'s dtype."""
    if x.device.type == "cpu":
        return deform_conv2d(
            x, offset, mask, weight, bias, stride=1, padding=padding,
            dilation=dilation, offset_groups=offset_groups,
            max_offset=max_offset,
        )
    if x.device.type != "cuda":
        raise ValueError(f"no DCN kernel for device {x.device}")
    k = weight.shape[2] * weight.shape[3]
    groups = offset_groups or offset.shape[1] // (2 * k)
    d = float(max_offset) if max_offset is not None else 0.0
    out = _DeformConvWindowed.apply(
        x, offset, mask, weight, int(padding), int(dilation), int(groups),
        d if d > 0 else 0.0,
    )
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out


deform_conv2d_windowed.launches = 0
