"""Named weight initializers (reference ``posetimation/utils/weight_init.py``
surface, present but unused there); port of
``fami_pose_tpu/models/weight_init.py``.

:func:`get_initializer` returns an in-place initializer ``init(tensor,
generator=None)`` that draws from the distribution flax's initializer of
the same name draws from for the same layer. Fans follow flax's
``variance_scaling``: a torch conv weight (O, I, kh, kw) has fan-in ``I *
kh * kw`` and fan-out ``O * kh * kw``, as flax's (kh, kw, I, O) kernel; a
linear weight (O, I) has fan-in I and fan-out O. flax's
``truncated_normal`` draws a standard normal truncated to [-2, 2] and
scales it by ``sqrt(variance) / 0.87962566103423978`` (the standard
deviation of that truncated normal), so the result has the variance asked
for and lies within +-2 of those scaled units.
"""

import math

import torch

# the standard deviation of a standard normal truncated to (-2, 2)
TRUNCATED_STD = 0.87962566103423978


def _fans(shape):
    if len(shape) < 2:
        raise ValueError(f"variance scaling needs a weight of >= 2 dims, "
                         f"got shape {tuple(shape)}")
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def variance_scaling(scale, mode, distribution):
    """flax's ``variance_scaling(scale, mode, distribution)`` on a torch
    weight; modes ``fan_in`` / ``fan_out`` / ``fan_avg``, distributions
    ``truncated_normal`` / ``normal`` / ``uniform``."""

    @torch.no_grad()
    def init(tensor, generator=None):
        fan_in, fan_out = _fans(tensor.shape)
        denominator = {"fan_in": fan_in, "fan_out": fan_out,
                       "fan_avg": (fan_in + fan_out) / 2}[mode]
        variance = scale / denominator
        if distribution == "truncated_normal":
            std = math.sqrt(variance) / TRUNCATED_STD
            return torch.nn.init.trunc_normal_(
                tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        if distribution == "normal":
            return torch.nn.init.normal_(tensor, 0.0, math.sqrt(variance),
                                         generator=generator)
        if distribution == "uniform":
            limit = math.sqrt(3.0 * variance)
            return torch.nn.init.uniform_(tensor, -limit, limit,
                                          generator=generator)
        raise ValueError(f"unknown distribution {distribution!r}")

    return init


def get_initializer(name: str, **kwargs):
    """'kaiming' | 'kaiming_normal' | 'xavier' | 'xavier_normal' | 'normal'
    | 'uniform' | 'constant' | 'lecun' -> ``init(tensor, generator=None)``;
    an unknown name raises ``KeyError``."""
    name = name.lower()
    if name in ("kaiming", "kaiming_uniform", "he"):
        # torch's kaiming_uniform(a=sqrt(5)) scale
        return variance_scaling(1.0 / 3.0, "fan_in", "uniform")
    if name == "kaiming_normal":
        return variance_scaling(2.0, "fan_in", "truncated_normal")
    if name in ("xavier", "glorot"):
        return variance_scaling(1.0, "fan_avg", "uniform")
    if name == "xavier_normal":
        return variance_scaling(1.0, "fan_avg", "truncated_normal")
    if name == "lecun":
        return variance_scaling(1.0, "fan_in", "truncated_normal")
    if name == "normal":
        std = float(kwargs.get("std", 0.001))

        @torch.no_grad()
        def normal(tensor, generator=None):
            return torch.nn.init.normal_(tensor, 0.0, std, generator=generator)

        return normal
    if name == "uniform":
        # flax's uniform(scale): U[0, scale)
        s = float(kwargs.get("scale", 0.01))

        @torch.no_grad()
        def uniform(tensor, generator=None):
            return torch.nn.init.uniform_(tensor, 0.0, s, generator=generator)

        return uniform
    if name == "constant":
        v = float(kwargs.get("value", 0.0))

        @torch.no_grad()
        def constant(tensor, generator=None):
            return tensor.fill_(v)

        return constant
    raise KeyError(f"Unknown initializer {name!r}")
