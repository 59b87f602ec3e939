"""Layer library (NCHW) for the port; counterpart of
``fami_pose_tpu/models/layers.py``.

Module and parameter names are the reference PyTorch ones (``conv``/``bn``,
``conv1``/``bn1``, ``downsample.0``/``downsample.1``, ``layers.N``), so a
port ``state_dict`` maps onto the JAX package's flax tree through
``fami_pose_tpu.models.torch_remap``.

Compute dtype: parameters stay float32; :class:`Conv2d` and :class:`Linear`
cast their weights to the dtype of their input (bfloat16 on the serving path)
and add their bias to the rounded output, as flax does, and
:class:`BatchNorm` normalizes in float32 and casts back: with its running
statistics in eval mode, with the batch's in training mode.

Every conv of the residual blocks takes a ``quant`` mode (``models/quant.py``;
``"off"`` by default), which the HRNet backbone and the head's residual
chains pass down for the int8 serving path (``TPU.INT8_EVAL``).
"""

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from fami_pose_torch.ops.int8_conv import (
    int8_conv2d, pack_weight, quantize_weight,
)
from fami_pose_torch.parallel.mesh import all_reduce_sum, is_distributed

from .quant import QUANT_CALIBRATE, QUANT_INT8, QUANT_MODES, QUANT_OFF

BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype. The bias is added
    to the convolution's output in that dtype, as flax's ``nn.Conv`` does:
    a bfloat16 output is rounded, then the bias added and rounded again (a
    bias fused into the convolution, as the CPU's kernels do, rounds once
    and differs from the JAX package in the last bit).

    ``quant`` (``models/quant.py``) selects the int8 serving path: in
    ``"calibrate"`` the float path runs and ``act_absmax`` keeps the running
    max of ``|x|`` (float32); in ``"int8"`` the conv is
    ``ops.int8_conv.int8_conv2d`` with ``act_scale`` and the weights
    quantized (and packed for the card's implicit GEMM) by
    :meth:`set_act_scale`. There the bias is added in float32 before the one
    rounding to the output's dtype, as ``QuantConv`` does. These five
    buffers are not part of the ``state_dict``, and loading one clears
    them. ``weight_q`` (N, C * kh * kw) is ``QuantConv``'s kq: the CPU
    branch computes with it, and the card route checks the packed copy
    against its shape. So both int8 copies stay, one byte a weight each, a
    quarter of the float32 weights' bytes."""

    def __init__(self, *args, quant=QUANT_OFF, **kwargs):
        super().__init__(*args, **kwargs)
        if quant not in QUANT_MODES:
            raise ValueError(f"quant {quant!r}, expected one of {QUANT_MODES}")
        if quant != QUANT_OFF and self.groups != 1:
            raise ValueError("the int8 path takes no grouped convolution")
        self.quant = quant
        self.quant_name = None  # the conv's name in the model, for errors
        for name in ("act_absmax", "act_scale", "weight_q", "weight_scale",
                     "weight_packed"):
            self.register_buffer(name, None, persistent=False)

    def clear_quant(self):
        self.act_absmax = self.act_scale = None
        self.weight_q = self.weight_scale = self.weight_packed = None

    @torch.no_grad()
    def set_act_scale(self, scale, name=None):
        """Set the activation scale and quantize the weights
        (``ops.int8_conv.quantize_weight``), then pack them once for the
        card's implicit GEMM (``ops.int8_conv.pack_weight``)."""
        scale = (scale.detach() if torch.is_tensor(scale)
                 else torch.tensor(scale)).to(torch.float32).reshape(())
        if not (torch.isfinite(scale) and scale > 0):
            raise ValueError(f"int8 conv {name}: activation scale {scale}")
        self.quant_name = name
        self.act_scale = scale.to(self.weight.device)
        self.weight_q, self.weight_scale = quantize_weight(self.weight)
        self.weight_packed = pack_weight(self.weight_q, self.in_channels,
                                         self.kernel_size)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.clear_quant()

    def forward(self, x):
        if self.quant == QUANT_INT8:
            if self.act_scale is None:
                raise RuntimeError(
                    f"int8 conv {self.quant_name or '(unnamed)'} has no "
                    "activation scale: calibrate the model first "
                    "(models.quant.calibrate)")
            bias = None if self.bias is None else self.bias.detach()
            return int8_conv2d(x, self.weight_q, self.weight_scale,
                               self.act_scale, bias, self.kernel_size,
                               self.stride, self.padding, self.dilation,
                               name=self.quant_name,
                               w_packed=self.weight_packed)
        if self.quant == QUANT_CALIBRATE:
            amax = x.detach().abs().amax().to(torch.float32)
            self.act_absmax = (amax if self.act_absmax is None
                               else torch.maximum(self.act_absmax, amax))
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is None:
            return y
        return y + self.bias.to(x.dtype).view(1, -1, 1, 1)


def activation(name: str):
    """The activation of a reference ``act`` name (``fami_pose_tpu/models/
    layers.py::activation``): ReLU, LeakyReLU (slope 0.1, as inside the
    reference's BasicBlock) or SiLU."""
    if name == "ReLU":
        return F.relu
    if name == "LeakyReLU":
        return lambda x: F.leaky_relu(x, negative_slope=0.1)
    if name == "SiLU":
        return F.silu
    raise ValueError(f"Unsupported activation {name!r}")


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype, the bias added to
    the product's output in that dtype (flax's ``nn.Dense``; see
    :class:`Conv2d`)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


BN_MOMENTUM = 0.1  # update fraction (flax: retain fraction 0.9)

# per thread, > 0 while a rematerialized module recomputes its forward
# (BatchNorm then leaves its running statistics alone); the recomputation
# runs in the thread that runs the backward
_REMAT = threading.local()


@contextlib.contextmanager
def recomputing():
    """The context of a checkpointed module's second forward
    (``torch.utils.checkpoint``'s ``context_fn``): BatchNorm does not move
    its running statistics again."""
    _REMAT.depth = getattr(_REMAT, "depth", 0) + 1
    try:
        yield
    finally:
        _REMAT.depth -= 1


class BatchNorm(nn.Module):
    """BatchNorm2d (eps 1e-5) over the channel axis, in float32 arithmetic
    (float64 for a float64 module and input, as a reference computation).

    Eval mode normalizes with the running statistics. Training mode
    (``module.train()``) normalizes with the batch's mean and biased
    variance and moves the running statistics a fraction 0.1 toward them.
    The running variance takes the *biased* batch variance, as flax's
    ``nn.BatchNorm`` does (``F.batch_norm`` alone would store the unbiased
    one): the fused op writes the batch statistics into scratch buffers
    (momentum 1), and the unbiased variance it reports is scaled back by
    (n - 1) / n before the update.

    The scale and bias are cast to the arithmetic's type where they are
    used: a bfloat16 copy of them (``TPU.BF16_GRADS``, ``engine/steps.py``)
    is widened exactly, as flax's ``nn.BatchNorm`` widens bfloat16
    parameters, and its gradient comes back in bfloat16.

    The running statistics move once a training forward. Under
    :func:`recomputing` (the second pass of a rematerialized module,
    ``TPU.REMAT_BACKBONE``) the forward normalizes with the batch's
    statistics as before and leaves the running ones as they are: in flax
    they are an output of the function, which recomputation never writes.

    Over a mesh of more than one rank (``mesh``, set by
    :func:`sync_batch_norm`), a training forward normalizes with the
    statistics of the global batch, as the JAX package's BatchNorm over a
    sharded batch does: one all-reduce of (sum x, sum x^2, count) a layer,
    then flax's fast variance ``E[x^2] - E[x]^2`` clipped at 0, in float32.
    The gradient passes back through that all-reduce
    (``parallel.mesh.all_reduce_sum``), and a recomputed forward under
    :func:`recomputing` issues it again (every rank recomputes in the same
    order).
    """

    def __init__(self, num_features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.mesh = None

    def _global_batch_norm(self, x32, weight, bias):
        """Normalize with the statistics of the batch over every rank;
        returns the output and the statistics (mean, biased variance)."""
        c = x32.shape[1]
        dims = [d for d in range(x32.dim()) if d != 1]
        count = x32.new_full((1,), x32.numel() // c)
        sums = all_reduce_sum(torch.cat(
            [x32.sum(dims), (x32 * x32).sum(dims), count]))
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
        shape = [1, c] + [1] * (x32.dim() - 2)
        mul = torch.rsqrt(var + BN_EPS) * weight
        y = (x32 - mean.view(shape)) * mul.view(shape) + bias.view(shape)
        return y, mean.detach(), var.detach()

    def forward(self, x):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        weight = self.weight.to(x32.dtype)
        bias = self.bias.to(x32.dtype)
        if not self.training:
            y = F.batch_norm(
                x32, self.running_mean, self.running_var, weight, bias,
                False, 0.0, BN_EPS,
            )
            return y.to(x.dtype)
        if self.mesh is not None:
            y, mean, var = self._global_batch_norm(x32, weight, bias)
            if not getattr(_REMAT, "depth", 0):
                with torch.no_grad():
                    self.running_mean.lerp_(mean, BN_MOMENTUM)
                    self.running_var.lerp_(var, BN_MOMENTUM)
            return y.to(x.dtype)
        count = x.numel() // x.shape[1]
        # zeros, not empty: the op computes 0 * old + 1 * batch
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x32, mean, var, weight, bias, True, 1.0, BN_EPS)
        if getattr(_REMAT, "depth", 0):
            return y.to(x.dtype)
        with torch.no_grad():
            self.running_mean.lerp_(mean, BN_MOMENTUM)
            self.running_var.lerp_(var * ((count - 1) / count), BN_MOMENTUM)
        return y.to(x.dtype)


def sync_batch_norm(model, mesh):
    """Make every :class:`BatchNorm` of ``model`` normalize a training
    batch with the global batch's statistics over ``mesh`` when it has more
    than one rank (the ranks of one data index replicate their sums, and
    the count with them); with one rank (or no mesh) they keep the local
    path, with no collective. Returns ``model``."""
    sync = mesh if is_distributed(mesh) else None
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.mesh = sync
    return model


def conv3x3(cin, cout, stride=1, quant=QUANT_OFF):
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False,
                  quant=quant)


class ConvBnAct(nn.Module):
    """conv (+ bias) + optional BN + optional ReLU (reference
    ``conv_bn_relu``: bias on by default)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=1,
                 dilation=1, has_bias=True, has_bn=True, has_act=True):
        super().__init__()
        self.conv = Conv2d(
            cin, cout, kernel_size, stride=stride, padding=padding,
            dilation=dilation, bias=has_bias,
        )
        self.bn = BatchNorm(cout) if has_bn else None
        self.has_act = has_act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.has_act else x


class Downsample(nn.Sequential):
    """1x1 (strided) conv + BN shortcut: ``downsample.0`` / ``downsample.1``."""

    def __init__(self, cin, cout, stride=1, quant=QUANT_OFF):
        super().__init__(
            Conv2d(cin, cout, 1, stride=stride, bias=False, quant=quant),
            BatchNorm(cout),
        )


class Interpolate(nn.Module):
    """Nearest-neighbour upsampling by an integer factor."""

    def __init__(self, scale_factor):
        super().__init__()
        self.scale_factor = int(scale_factor)

    def forward(self, x):
        f = self.scale_factor
        return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual; expansion 1. As in the reference, ``stride``
    is passed to both convs."""

    expansion = 1

    def __init__(self, cin, cout, stride=1, has_downsample=False,
                 quant=QUANT_OFF):
        super().__init__()
        self.conv1 = conv3x3(cin, cout, stride, quant)
        self.bn1 = BatchNorm(cout)
        self.conv2 = conv3x3(cout, cout, stride, quant)
        self.bn2 = BatchNorm(cout)
        self.downsample = (
            Downsample(cin, cout, stride, quant) if has_downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) + residual; expansion 4."""

    expansion = 4

    def __init__(self, cin, planes, stride=1, has_downsample=False,
                 quant=QUANT_OFF):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, bias=False, quant=quant)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv3x3(planes, planes, stride, quant)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False, quant=quant)
        self.bn3 = BatchNorm(cout)
        self.downsample = (
            Downsample(cin, cout, stride, quant) if has_downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ChainOfBasicBlocks(nn.Module):
    """A 1x1-downsampling BasicBlock (cin -> cout) + (num_blocks - 1)
    BasicBlocks, under ``layers.N``."""

    def __init__(self, cin, cout, num_blocks=1, quant=QUANT_OFF):
        super().__init__()
        blocks = [BasicBlock(cin, cout, has_downsample=True, quant=quant)]
        blocks += [BasicBlock(cout, cout, quant=quant)
                   for _ in range(1, num_blocks)]
        self.layers = nn.Sequential(*blocks)

    def forward(self, x):
        return self.layers(x)
