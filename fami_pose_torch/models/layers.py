"""Layer library (NCHW) for the port; counterpart of
``fami_pose_tpu/models/layers.py``.

Module and parameter names are the reference PyTorch ones (``conv``/``bn``,
``conv1``/``bn1``, ``downsample.0``/``downsample.1``, ``layers.N``), so a
port ``state_dict`` maps onto the JAX package's flax tree through
``fami_pose_tpu.models.torch_remap``.

Compute dtype: parameters stay float32; :class:`Conv2d` and :class:`Linear`
cast their weights to the dtype of their input (bfloat16 on the serving path), and
:class:`BatchNorm` normalizes in float32 with its running statistics and
casts back. This is the eval slice: BatchNorm has no batch-statistics mode.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm2d (eps 1e-5) over the channel axis, running
    statistics, float32 arithmetic."""

    def __init__(self, num_features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        y = F.batch_norm(
            x.to(torch.float32), self.running_mean, self.running_var,
            self.weight, self.bias, False, 0.0, BN_EPS,
        )
        return y.to(x.dtype)


def conv3x3(cin, cout, stride=1):
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


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

    def __init__(self, cin, cout, stride=1):
        super().__init__(
            Conv2d(cin, cout, 1, stride=stride, bias=False), BatchNorm(cout)
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

    def __init__(self, cin, cout, stride=1, has_downsample=False):
        super().__init__()
        self.conv1 = conv3x3(cin, cout, stride)
        self.bn1 = BatchNorm(cout)
        self.conv2 = conv3x3(cout, cout, stride)
        self.bn2 = BatchNorm(cout)
        self.downsample = (
            Downsample(cin, cout, stride) if has_downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) + residual; expansion 4."""

    expansion = 4

    def __init__(self, cin, planes, stride=1, has_downsample=False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm(cout)
        self.downsample = (
            Downsample(cin, cout, stride) if has_downsample else None
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

    def __init__(self, cin, cout, num_blocks=1):
        super().__init__()
        blocks = [BasicBlock(cin, cout, has_downsample=True)]
        blocks += [BasicBlock(cout, cout) for _ in range(1, num_blocks)]
        self.layers = nn.Sequential(*blocks)

    def forward(self, x):
        return self.layers(x)
