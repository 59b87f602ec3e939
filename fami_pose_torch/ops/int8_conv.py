"""The int8 convolution of the serving path (``TPU.INT8_EVAL``): the port of
``QuantConv`` in mode ``"int8"`` (``fami_pose_tpu/models/quant.py``).

One conv takes NCHW activations ``x`` (float32 or bfloat16), the quantized
weight ``wq`` (N, C * kh * kw) int8 and its per-output-channel scales
``w_scale`` (:func:`quantize_weight`), and the calibrated per-tensor
activation scale ``act_scale`` (a one-element float32 tensor on ``x``'s
device), and computes, as the JAX package does:

  xq = clip(round(x_f32 * (1 / act_scale)), -127, 127)   (half to even)
  acc = conv(xq, kq)                                      (exact, int32)
  y = float(acc) * (w_scale * act_scale) [+ bias, in f32] -> out dtype

On a CPU tensor :func:`int8_conv2d` runs the plain version: quantize with
torch ops, ``F.conv2d`` in float64 on the integer-valued tensors (exact:
every partial sum is an integer below 9 * 384 * 127^2 < 2^53, whatever the
order of summation; float32 would be exact only below 2^24), the cast to
int32, then the dequant. On a CUDA tensor it runs two kernels
(``ops/cuda/csrc/int8_conv.cu``): :func:`quant_nhwc` writes the quantized
input once as an int8 channels-last copy (B, H, W, Cp), the channels
zero-padded to Cp, a multiple of 16; :func:`implicit_gemm` convolves that
copy with the packed weight (:func:`pack_weight`: (Np, Kp) int8, K = kh *
kw * Cp in (ky, kx, c) order padded to Kp, a multiple of 32, N padded to
Np, a multiple of 16) on the tensor cores in s32 and writes the
dequantized output NCHW. Integer sums are exact in any order, so the
route gives the plain version's bits. Nothing falls back to the plain
version on the card.

Each wrapper has its plain version beside it (:func:`quant_nhwc_plain`,
:func:`implicit_gemm_plain`) and a count of its launches.
"""

import torch
import torch.nn.functional as F

QMAX = 127
# the most shared memory one N tile's packed weights (at least 32 rows of
# Kp) may take in the implicit GEMM (csrc/int8_conv.cu::kWeightBudget)
WEIGHT_BUDGET = 112 * 1024
# the s8 wgmma widths the implicit GEMM cuts N into (csrc/int8_conv.cu::
# kWidths)
WIDTHS = (32, 48, 64, 96, 128, 192, 256)


def _pair(v):
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v),) * 2


def padded_c(c):
    """Channels rounded up to a multiple of 16 (one 16-byte chunk of the
    int8 channels-last copy)."""
    return -(-int(c) // 16) * 16


def packed_shape(n, c, kernel_size):
    """(Np, Kp) of :func:`pack_weight` for N outputs, C inputs: N rounded up
    to a multiple of 16 (every s8 wgmma width the kernel cuts N into is
    one; its tiles read rows past Np as zeros), K = kh * kw * Cp rounded up
    to a multiple of 32 (one s8 wgmma step)."""
    kh, kw = _pair(kernel_size)
    return -(-int(n) // 16) * 16, -(-kh * kw * padded_c(c) // 32) * 32


def n_tiling(n, kp):
    """The implicit GEMM's N tiles for ``n`` outputs and a packed K of
    ``kp``: ``(width, tiles)`` as ``csrc/int8_conv.cu::tile_n`` chooses
    them (the widest of :data:`WIDTHS` whose weight tile, width x Kp
    bytes, fits :data:`WEIGHT_BUDGET`, then the narrowest that covers N in
    as many tiles), or ``(0, 0)`` where none fits. Names the kernel
    instance a conv runs on (``igemm_kernel<T, width>``); change both
    together."""
    fit = [v for v in WIDTHS if v * kp <= WEIGHT_BUDGET]
    if n <= 0 or not fit:
        return 0, 0
    tiles = -(-n // fit[-1])
    return min(v for v in WIDTHS if v >= -(-n // tiles)), tiles


def quantize_weight(weight):
    """(N, C, kh, kw) float32 -> ``(wq, w_scale)``: ``round(W * (1 /
    w_scale))`` as int8 (N, C * kh * kw), flattened per output channel in
    (c, ky, kx) order, and ``w_scale = max(amax|W|, 1e-12) * (1 / 127)``
    (N,) float32, as ``QuantConv`` computes them."""
    w = weight.detach().to(torch.float32)
    w_scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) * (1.0 / QMAX)
    kq = torch.round(w * (1.0 / w_scale).view(-1, 1, 1, 1)).to(torch.int8)
    return kq.reshape(w.shape[0], -1), w_scale


def pack_weight(wq, in_channels, kernel_size):
    """``wq`` (N, C * kh * kw) -> the implicit GEMM's weight (Np, Kp) int8,
    K-major: row n holds tap (ky, kx)'s Cp channels at ((ky * kw + kx) * Cp),
    channels C..Cp-1, the columns past kh * kw * Cp and the rows past N
    zero."""
    kh, kw = _pair(kernel_size)
    n, c = wq.shape[0], int(in_channels)
    kq = wq.reshape(n, c, kh, kw).permute(0, 2, 3, 1)  # (N, kh, kw, C)
    out = torch.zeros(*packed_shape(n, c, (kh, kw)), dtype=torch.int8,
                      device=wq.device)
    view = out[:n, :kh * kw * padded_c(c)].view(n, kh, kw, padded_c(c))
    view[..., :c] = kq
    return out


def quantize_plain(x, act_scale):
    """``clip(round(x_f32 * (1 / act_scale)), -127, 127)`` as float32
    integers."""
    inv = 1.0 / act_scale.to(torch.float32)
    return torch.clamp(torch.round(x.to(torch.float32) * inv), -QMAX, QMAX)


def _out_hw(x_hw, kernel_size, stride, padding, dilation):
    (kh, kw), (sh, sw) = kernel_size, stride
    (ph, pw), (dh, dw) = padding, dilation
    ho = (x_hw[0] + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (x_hw[1] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    return ho, wo


def quant_nhwc_plain(x, act_scale):
    """(B, C, H, W) -> the int8 channels-last copy (B, H, W, Cp):
    :func:`quantize_plain`, then permute, then zero channels up to Cp."""
    b, c, h, w = x.shape
    out = torch.zeros(b, h, w, padded_c(c), dtype=torch.int8, device=x.device)
    out[..., :c] = quantize_plain(x, act_scale).to(torch.int8).permute(
        0, 2, 3, 1)
    return out


def _dequant_nchw(acc, w_scale, act_scale, bias, out_dtype):
    scale = w_scale.to(torch.float32) * act_scale.to(torch.float32)
    y = acc.to(torch.float32) * scale.view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.to(torch.float32).view(1, -1, 1, 1)
    return y.to(out_dtype)


def implicit_gemm_plain(xq, wp, w_scale, act_scale, bias, kernel_size,
                        stride=1, padding=0, dilation=1,
                        out_dtype=torch.float32):
    """The implicit GEMM in plain torch: the taps of the int8 channels-last
    copy ``xq`` gathered in (ky, kx, c) order (a zero border: JAX pads after
    quantizing), the K columns padded to Kp, an exact integer product with
    the packed weight ``wp`` (in float64: every partial sum is an integer
    below 2^53, on the CPU and on the card alike), the first N = len(w_scale)
    columns cast to int32, then the dequant: (B, N, Ho, Wo) ``out_dtype``."""
    (kh, kw), (sh, sw) = _pair(kernel_size), _pair(stride)
    (ph, pw), (dh, dw) = _pair(padding), _pair(dilation)
    b, h, w, cp = xq.shape
    ho, wo = _out_hw((h, w), (kh, kw), (sh, sw), (ph, pw), (dh, dw))
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    taps = [xp[:, ky * dh:ky * dh + (ho - 1) * sh + 1:sh,
               kx * dw:kx * dw + (wo - 1) * sw + 1:sw]
            for ky in range(kh) for kx in range(kw)]
    a = torch.cat(taps, dim=3).reshape(b * ho * wo, kh * kw * cp)
    a = F.pad(a, (0, wp.shape[1] - a.shape[1])).to(torch.float64)
    n = w_scale.shape[0]
    acc = (a @ wp.to(torch.float64).t())[:, :n].to(torch.int32)
    acc = acc.reshape(b, ho, wo, n).permute(0, 3, 1, 2)
    return _dequant_nchw(acc, w_scale, act_scale, bias, out_dtype)


def int8_conv2d_plain(x, wq, w_scale, act_scale, bias, kernel_size, stride=1,
                      padding=0, dilation=1, out_dtype=None):
    """The int8 convolution in plain torch: quantized activations and
    weights convolved in float64 (exact), the sums cast to int32, then the
    dequant. cuDNN is kept out (on a CUDA tensor, as ``chip_smoke.py``
    compares the card path with this): an FFT or Winograd algorithm would
    leave the integers."""
    kh, kw = _pair(kernel_size)
    n, c = wq.shape[0], x.shape[1]
    kq = wq.reshape(n, c, kh, kw)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(quantize_plain(x, act_scale).to(torch.float64),
                       kq.to(torch.float64), None, _pair(stride),
                       _pair(padding), _pair(dilation)).to(torch.int32)
    return _dequant_nchw(acc, w_scale, act_scale, bias,
                         out_dtype or x.dtype)


def _dtype_code(dtype):
    from .cuda.build import DTYPE_CODES

    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"int8 conv kernels take float32 or bfloat16, got "
                        f"{name}")
    return DTYPE_CODES[name]


def _check_scale(act_scale, device):
    if (act_scale.dtype != torch.float32 or act_scale.numel() != 1
            or act_scale.device != device):
        raise ValueError(f"act_scale must be one float32 on {device}, got "
                         f"{act_scale.dtype} {tuple(act_scale.shape)} on "
                         f"{act_scale.device}")


def _quant_nhwc_cuda(x, act_scale):
    from .cuda.build import check, load_library, stream_ptr

    code = _dtype_code(x.dtype)
    if x.dim() != 4:
        raise ValueError(f"x (B, C, H, W) expected, got {tuple(x.shape)}")
    _check_scale(act_scale, x.device)
    x = x.contiguous()
    b, c, h, w = x.shape
    out = torch.empty(b, h, w, padded_c(c), dtype=torch.int8, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):  # launches go to the current one
        err = lib.fami_int8_quant_nhwc(x.data_ptr(), act_scale.data_ptr(),
                                       out.data_ptr(), code, b, c, h, w,
                                       out.shape[3], stream_ptr(x))
        check(lib, err, "fami_int8_quant_nhwc")
    quant_nhwc.launches += 1
    return out


def quant_nhwc(x, act_scale):
    """The int8 channels-last copy (B, H, W, Cp) of ``x``: the plain version
    for a CPU tensor, the kernel ``fami_int8_quant_nhwc`` (counted in
    ``quant_nhwc.launches``) for a CUDA tensor, or an error."""
    if x.device.type == "cpu":
        return quant_nhwc_plain(x, act_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    return _quant_nhwc_cuda(x, act_scale)


quant_nhwc.launches = 0


def _check_vector(name, t, n, device):
    if t is not None and (t.dtype != torch.float32 or t.shape != (n,)
                          or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name}: contiguous float32 ({n},) on {device} "
                         f"expected, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _implicit_gemm_cuda(xq, wp, w_scale, act_scale, bias, kernel_size, stride,
                        padding, dilation, out_dtype):
    from .cuda.build import check, load_library, stream_ptr

    ks, st = _pair(kernel_size), _pair(stride)
    pad, dil = _pair(padding), _pair(dilation)
    code = _dtype_code(out_dtype)
    if (xq.dtype != torch.int8 or xq.dim() != 4 or xq.shape[3] % 16
            or not xq.is_contiguous()):
        raise ValueError(f"xq: contiguous int8 (B, H, W, Cp), Cp a multiple "
                         f"of 16, expected, got {xq.dtype} "
                         f"{tuple(xq.shape)}")
    b, h, w, cp = xq.shape
    n = w_scale.shape[0]
    if (wp.dtype != torch.int8 or wp.device != xq.device
            or not wp.is_contiguous()
            or tuple(wp.shape) != packed_shape(n, cp, ks)):
        raise ValueError(f"wp: contiguous int8 {packed_shape(n, cp, ks)} on "
                         f"{xq.device} expected, got {wp.dtype} "
                         f"{tuple(wp.shape)} on {wp.device}")
    _check_scale(act_scale, xq.device)
    _check_vector("w_scale", w_scale, n, xq.device)
    _check_vector("bias", bias, n, xq.device)
    ho, wo = _out_hw((h, w), ks, st, pad, dil)
    out = torch.empty(b, n, ho, wo, dtype=out_dtype, device=xq.device)
    lib = load_library()
    with torch.cuda.device(xq.device):  # launches go to the current one
        err = lib.fami_int8_implicit_gemm(
            xq.data_ptr(), wp.data_ptr(), w_scale.data_ptr(),
            act_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), code, b, h, w, cp, *ks, *st, *pad, *dil, ho, wo,
            n, *wp.shape, stream_ptr(xq))
        check(lib, err, "fami_int8_implicit_gemm")
    implicit_gemm.launches += 1
    return out


def implicit_gemm(xq, wp, w_scale, act_scale, bias, kernel_size, stride=1,
                  padding=0, dilation=1, out_dtype=torch.float32):
    """The conv of the int8 channels-last copy ``xq`` with the packed weight
    ``wp``, dequantized: (B, N, Ho, Wo) ``out_dtype``. The plain version for
    a CPU tensor, the kernel ``fami_int8_implicit_gemm`` (counted in
    ``implicit_gemm.launches``) for a CUDA tensor, or an error."""
    if xq.device.type == "cpu":
        return implicit_gemm_plain(xq, wp, w_scale, act_scale, bias,
                                   kernel_size, stride, padding, dilation,
                                   out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    return _implicit_gemm_cuda(xq, wp, w_scale, act_scale, bias, kernel_size,
                               stride, padding, dilation, out_dtype)


implicit_gemm.launches = 0


def check_conv(x_shape, wq, w_packed, kernel_size, stride, padding,
               dilation, name):
    """Raise, naming the conv, where the card route does not take it: ``wq``
    not int8 (N, C * kh * kw), ``w_packed`` missing or not int8 of
    :func:`packed_shape`, 32 rows of Kp past :data:`WEIGHT_BUDGET` (the
    implicit GEMM keeps an N tile's weights in shared memory), no output
    pixel, or 2^31 or more input or output pixels (the kernels index pixels
    in 32 bits)."""
    ks = _pair(kernel_size)
    b, c, h, w = x_shape
    k = c * ks[0] * ks[1]
    label = f"int8 conv {name or '(unnamed)'}"
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[1] != k:
        raise ValueError(f"{label}: wq must be int8 (N, {k}), got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    want = packed_shape(wq.shape[0], c, ks)
    if w_packed is None or (w_packed.dtype != torch.int8
                            or tuple(w_packed.shape) != want):
        got = ("none" if w_packed is None
               else f"{w_packed.dtype} {tuple(w_packed.shape)}")
        raise ValueError(f"{label}: w_packed must be int8 {want} "
                         f"(pack_weight of wq), got {got}")
    if 32 * want[1] > WEIGHT_BUDGET:
        raise ValueError(f"{label}: K = {k} ({want[1]} padded) is more than "
                         f"the implicit GEMM keeps in shared memory (32 rows "
                         f"of it in {WEIGHT_BUDGET} bytes)")
    ho, wo = _out_hw((h, w), ks, _pair(stride), _pair(padding),
                     _pair(dilation))
    if ho <= 0 or wo <= 0 or max(b * h * w, b * ho * wo) >= 2 ** 31:
        raise ValueError(f"{label}: the kernels take 1 to 2^31 - 1 input and "
                         f"output pixels; this conv has {b * h * w} in, "
                         f"{b * max(ho, 0) * max(wo, 0)} out")


def int8_conv2d(x, wq, w_scale, act_scale, bias, kernel_size, stride=1,
                padding=0, dilation=1, out_dtype=None, name=None,
                w_packed=None):
    """The int8 convolution (module docstring). ``x`` (B, C, H, W); ``wq``
    (N, C * kh * kw) and ``w_scale`` (N,) from :func:`quantize_weight`;
    ``act_scale`` one float32; ``bias`` (N,) float32 or None. Returns (B, N,
    Ho, Wo) in ``out_dtype`` (default ``x.dtype``). ``name`` names the conv
    in errors; ``w_packed``, :func:`pack_weight` of ``wq``, is what the card
    route reads, and it requires one (``Conv2d.set_act_scale`` packs it
    once)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, wq, w_scale, act_scale, bias, kernel_size,
                                 stride, padding, dilation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    check_conv(tuple(x.shape), wq, w_packed, kernel_size, stride, padding,
               dilation, name)
    xq = _quant_nhwc_cuda(x, act_scale)
    return _implicit_gemm_cuda(xq, w_packed, w_scale, act_scale, bias,
                               kernel_size, stride, padding, dilation,
                               out_dtype)
