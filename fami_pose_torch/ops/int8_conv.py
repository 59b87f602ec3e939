"""The int8 convolution of the serving path (``TPU.INT8_EVAL``): the port of
``QuantConv`` in mode ``"int8"`` (``fami_pose_tpu/models/quant.py``).

One conv takes NCHW activations ``x`` (float32 or bfloat16), the quantized
weight matrix ``wq`` (N, Kp) int8 and its per-output-channel scales
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
int32, then the dequant. On a CUDA tensor it runs three calls: the kernel
``fami_int8_quant_im2col`` (``ops/cuda/csrc/int8_conv.cu``), which writes
the int8 im2col matrix (B * Ho * Wo, Kp) with K = C * kh * kw padded with
zero columns to a multiple of 8; ``torch._int_mm`` (cuBLASLt, s8 x s8 ->
s32) against ``wq`` read as a column-major (Kp, N) matrix; and the kernel
``fami_int8_dequant``, which writes NCHW. ``_int_mm`` takes more than 16
rows, K and N multiples of 8, and the column-major second operand (on torch
2.11 / CUDA 12.8 a row-major one fails in cuBLASLt at small row counts); a
conv whose shape fails these raises with the conv's name. Nothing falls
back to the plain version on the card.

:func:`quant_im2col` and :func:`dequant` are the two kernels' wrappers,
each with its plain version beside it and a count of its launches.
"""

import torch
import torch.nn.functional as F

QMAX = 127


def _pair(v):
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v),) * 2


def padded_k(k):
    """K rounded up to a multiple of 8 (cuBLASLt's int8 rule)."""
    return -(-int(k) // 8) * 8


def quantize_weight(weight):
    """(N, C, kh, kw) float32 -> ``(wq, w_scale)``: the int8 matrix (N, Kp)
    of ``round(W * (1 / w_scale))`` flattened per output channel in (c, ky,
    kx) order, zero-padded to Kp columns, and ``w_scale = max(amax|W|,
    1e-12) * (1 / 127)`` (N,) float32, as ``QuantConv`` computes them."""
    w = weight.detach().to(torch.float32)
    n = w.shape[0]
    w_scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) * (1.0 / QMAX)
    kq = torch.round(w * (1.0 / w_scale).view(-1, 1, 1, 1)).to(torch.int8)
    k = kq[0].numel()
    wq = torch.zeros(n, padded_k(k), dtype=torch.int8, device=w.device)
    wq[:, :k] = kq.reshape(n, k)
    return wq, w_scale


def quantize_plain(x, act_scale):
    """``clip(round(x_f32 * (1 / act_scale)), -127, 127)`` as float32
    integers."""
    inv = 1.0 / act_scale.to(torch.float32)
    return torch.clamp(torch.round(x.to(torch.float32) * inv), -QMAX, QMAX)


def _out_hw(x, kernel_size, stride, padding, dilation):
    (kh, kw), (sh, sw) = kernel_size, stride
    (ph, pw), (dh, dw) = padding, dilation
    ho = (x.shape[2] + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (x.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    return ho, wo


def quant_im2col_plain(x, act_scale, kernel_size, stride=1, padding=0,
                       dilation=1):
    """The int8 im2col matrix (B * Ho * Wo, Kp) of ``x`` in plain torch:
    quantize, then gather (a zero border: JAX pads after quantizing), the
    columns in (c, ky, kx) order, zero columns up to Kp."""
    ks, st = _pair(kernel_size), _pair(stride)
    pad, dil = _pair(padding), _pair(dilation)
    xq = quantize_plain(x, act_scale)
    cols = F.unfold(xq, ks, dilation=dil, padding=pad, stride=st)
    k = cols.shape[1]
    a = cols.transpose(1, 2).reshape(-1, k)
    return F.pad(a, (0, padded_k(k) - k)).to(torch.int8)


def dequant_plain(acc, w_scale, act_scale, bias, b, ho, wo, out_dtype):
    """(B * Ho * Wo, N) int32 -> (B, N, Ho, Wo) ``out_dtype``:
    ``float(acc) * (w_scale * act_scale)``, the bias added in float32, one
    rounding to ``out_dtype``."""
    n = acc.shape[1]
    nchw = acc.reshape(b, ho * wo, n).transpose(1, 2).reshape(b, n, ho, wo)
    return _dequant_nchw(nchw, w_scale, act_scale, bias, out_dtype)


def _dequant_nchw(acc, w_scale, act_scale, bias, out_dtype):
    scale = w_scale.to(torch.float32) * act_scale.to(torch.float32)
    y = acc.to(torch.float32) * scale.view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.to(torch.float32).view(1, -1, 1, 1)
    return y.to(out_dtype)


def int8_conv2d_plain(x, wq, w_scale, act_scale, bias, kernel_size, stride=1,
                      padding=0, dilation=1, out_dtype=None):
    """The int8 convolution in plain torch: quantized activations and
    weights convolved in float64 (exact), the sums cast to int32, then the
    dequant. cuDNN is kept out (on a CUDA tensor, as ``chip_smoke.py``
    compares the card path with this): an FFT or Winograd algorithm would
    leave the integers."""
    kh, kw = _pair(kernel_size)
    n, c = wq.shape[0], x.shape[1]
    kq = wq[:, :c * kh * kw].reshape(n, c, kh, kw)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(quantize_plain(x, act_scale).to(torch.float64),
                       kq.to(torch.float64), None, _pair(stride),
                       _pair(padding), _pair(dilation)).to(torch.int32)
    return _dequant_nchw(acc, w_scale, act_scale, bias,
                         out_dtype or x.dtype)


def _dtype_code(t):
    from .cuda.build import DTYPE_CODES

    name = str(t.dtype).replace("torch.", "")
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


def _quant_im2col_cuda(x, act_scale, kernel_size, stride, padding, dilation):
    from .cuda.build import check, load_library, stream_ptr

    code = _dtype_code(x)
    if x.dim() != 4:
        raise ValueError(f"x (B, C, H, W) expected, got {tuple(x.shape)}")
    _check_scale(act_scale, x.device)
    ks, st = _pair(kernel_size), _pair(stride)
    pad, dil = _pair(padding), _pair(dilation)
    x = x.contiguous()
    b, c, h, w = x.shape
    ho, wo = _out_hw(x, ks, st, pad, dil)
    kp = padded_k(c * ks[0] * ks[1])
    out = torch.empty(b * ho * wo, kp, dtype=torch.int8, device=x.device)
    lib = load_library()
    err = lib.fami_int8_quant_im2col(
        x.data_ptr(), act_scale.data_ptr(), out.data_ptr(), code, b, c, h, w,
        *ks, *st, *pad, *dil, ho, wo, kp, stream_ptr(x))
    check(lib, err, "fami_int8_quant_im2col")
    quant_im2col.launches += 1
    return out


def quant_im2col(x, act_scale, kernel_size, stride=1, padding=0, dilation=1):
    """The int8 im2col matrix (B * Ho * Wo, Kp): the plain version for a CPU
    tensor, the kernel ``fami_int8_quant_im2col`` (counted in
    ``quant_im2col.launches``) for a CUDA tensor, or an error."""
    if x.device.type == "cpu":
        return quant_im2col_plain(x, act_scale, kernel_size, stride, padding,
                                  dilation)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    return _quant_im2col_cuda(x, act_scale, kernel_size, stride, padding,
                              dilation)


quant_im2col.launches = 0


def _dequant_cuda(acc, w_scale, act_scale, bias, b, ho, wo, out_dtype):
    from .cuda.build import check, load_library, stream_ptr

    m, n = acc.shape
    out = torch.empty(b, n, ho, wo, dtype=out_dtype, device=acc.device)
    code = _dtype_code(out)
    if acc.dtype != torch.int32 or not acc.is_contiguous() or m != b * ho * wo:
        raise ValueError(f"acc: contiguous int32 ({b * ho * wo}, N) expected, "
                         f"got {acc.dtype} {tuple(acc.shape)}")
    _check_scale(act_scale, acc.device)
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)
                              or t.device != acc.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: contiguous float32 ({n},) on "
                             f"{acc.device} expected, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    lib = load_library()
    err = lib.fami_int8_dequant(
        acc.data_ptr(), w_scale.data_ptr(), act_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), code, b, n,
        ho * wo, stream_ptr(acc))
    check(lib, err, "fami_int8_dequant")
    dequant.launches += 1
    return out


def dequant(acc, w_scale, act_scale, bias, b, ho, wo, out_dtype):
    """(B * Ho * Wo, N) int32 sums -> (B, N, Ho, Wo) ``out_dtype``: the plain
    version for a CPU tensor, the kernel ``fami_int8_dequant`` (counted in
    ``dequant.launches``) for a CUDA tensor, or an error."""
    if acc.device.type == "cpu":
        return dequant_plain(acc, w_scale, act_scale, bias, b, ho, wo,
                             out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {acc.device}")
    return _dequant_cuda(acc, w_scale, act_scale, bias, b, ho, wo, out_dtype)


dequant.launches = 0


def check_int_mm(m, kp, n, name):
    """Raise, naming the conv, where (M, Kp) x (Kp, N) fails ``_int_mm``'s
    conditions: more than 16 rows, K and N multiples of 8."""
    if m <= 16 or kp % 8 or n % 8:
        raise ValueError(
            f"int8 conv {name or '(unnamed)'}: torch._int_mm takes more than "
            f"16 rows and K, N multiples of 8; this conv gives M={m}, "
            f"K={kp}, N={n}")


def int8_conv2d(x, wq, w_scale, act_scale, bias, kernel_size, stride=1,
                padding=0, dilation=1, out_dtype=None, name=None):
    """The int8 convolution (module docstring). ``x`` (B, C, H, W); ``wq``
    (N, Kp) and ``w_scale`` (N,) from :func:`quantize_weight`;
    ``act_scale`` one float32; ``bias`` (N,) float32 or None. Returns (B, N,
    Ho, Wo) in ``out_dtype`` (default ``x.dtype``). ``name`` names the conv
    in errors."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, wq, w_scale, act_scale, bias, kernel_size,
                                 stride, padding, dilation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    ks = _pair(kernel_size)
    n, kp = wq.shape
    if wq.dtype != torch.int8 or kp != padded_k(x.shape[1] * ks[0] * ks[1]):
        raise ValueError(f"int8 conv {name}: wq must be int8 (N, "
                         f"{padded_k(x.shape[1] * ks[0] * ks[1])}), got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    ho, wo = _out_hw(x, ks, _pair(stride), _pair(padding), _pair(dilation))
    b = x.shape[0]
    check_int_mm(b * ho * wo, kp, n, name)
    a = _quant_im2col_cuda(x, act_scale, ks, stride, padding, dilation)
    # wq (N, Kp) row-major is the column-major (Kp, N) operand
    acc = torch._int_mm(a, wq.contiguous().t())
    return _dequant_cuda(acc, w_scale, act_scale, bias, b, ho, wo, out_dtype)
