"""Weights between the JAX package's flax tree and the port, and the port's
own seeded initialisation.

:func:`state_dict_from_flax` is the inverse of
``fami_pose_tpu.models.torch_remap.remap_fami_pose_state_dict``: it takes the
``{"params", "batch_stats"}`` tree as nested dicts of numpy arrays and
returns a port ``state_dict``:

  * conv kernels HWIO -> OIHW, dense kernels IO -> OI;
  * ``fc1``'s input features from flax's (H, W, C) flatten back to torch's
    (C, H, W);
  * BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``;
  * the top-level ``final_layer`` (flax scopes the shared heatmap head
    there) -> ``hrnet.final_layer``.

The flax offset/mask convs keep the canonical ``[g][k][(dy, dx)]`` output
order whatever ``DCN_AUX_CHANNEL_FIRST`` says (the JAX model permutes at call
time), so they carry over as they are.

:func:`init_weights` gives the port random weights from a seed without JAX
(the card machine has none): lecun-normal convs and dense layers, uniform
DCN weights (flax's ``variance_scaling(1/3, fan_in, uniform)``), zero
biases, identity BatchNorm. :func:`calibrate_batch_norm` then sets the
BatchNorm statistics from one forward, so that random weights give
unit-scale activations as trained ones do.

:func:`block_state_dict_from_flax` does the same for one deform block of
``models/deform_blocks.py`` (the JAX names kept, torch's leaves).

:func:`quant_scales_from_flax` carries the JAX package's int8 ``quant``
collection (``.../<conv>/act_scale`` leaves) over as the port's scales by
conv name (``models.quant.set_quant_scales``).
"""

import math
import re
from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn

from .fami_pose import DeformConv
from .layers import BatchNorm

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
_CHAINS = ("sup_agg_block", "combined_feat_layers", "init_feature_agg_block")

# flax path (after the BN leaf rename) -> port key, in order; the first rule
# that matches rewrites the path
_RULES = [
    (r"hrnet/stem_conv(\d)/kernel", r"hrnet.conv\1.weight"),
    (r"hrnet/stem_norm(\d)/bn/(\w+)", r"hrnet.bn\1.\2"),
    (r"hrnet/layer1_block(\d+)/(.*)", r"hrnet.layer1.\1.<block>\2"),
    (r"hrnet/transition(\d)/adapt(\d+)/kernel", r"hrnet.transition\1.\2.0.weight"),
    (r"hrnet/transition(\d)/adapt(\d+)_norm/bn/(\w+)", r"hrnet.transition\1.\2.1.\3"),
    (r"hrnet/transition(\d)/new(\d+)_(\d+)/kernel", r"hrnet.transition\1.\2.\3.0.weight"),
    (r"hrnet/transition(\d)/new(\d+)_(\d+)_norm/bn/(\w+)",
     r"hrnet.transition\1.\2.\3.1.\4"),
    (r"hrnet/stage(\d)_module(\d+)/branch(\d+)/block(\d+)/(.*)",
     r"hrnet.stage\1.\2.branches.\3.\4.<block>\5"),
    (r"hrnet/stage(\d)_module(\d+)/fuse(\d+)_(\d+)/conv/kernel",
     r"hrnet.stage\1.\2.fuse_layers.\3.\4.0.weight"),
    (r"hrnet/stage(\d)_module(\d+)/fuse(\d+)_(\d+)/norm/bn/(\w+)",
     r"hrnet.stage\1.\2.fuse_layers.\3.\4.1.\5"),
    (r"hrnet/stage(\d)_module(\d+)/fuse(\d+)_(\d+)/conv(\d+)/kernel",
     r"hrnet.stage\1.\2.fuse_layers.\3.\4.\5.0.weight"),
    (r"hrnet/stage(\d)_module(\d+)/fuse(\d+)_(\d+)/norm(\d+)/bn/(\w+)",
     r"hrnet.stage\1.\2.fuse_layers.\3.\4.\5.1.\6"),
    (r"final_layer/final_conv/kernel", "hrnet.final_layer.weight"),
    (r"final_layer/final_conv/bias", "hrnet.final_layer.bias"),
    (r"global_offset/chain/block(\d+)/(.*)",
     r"feat_global_offset_layers.0.layers.\1.<block>\2"),
    (r"global_offset/down(\d)/conv/kernel", r"feat_global_offset_layers.<down\1>.conv.weight"),
    (r"global_offset/down(\d)/conv/bias", r"feat_global_offset_layers.<down\1>.conv.bias"),
    (r"global_offset/down(\d)/norm/bn/(\w+)", r"feat_global_offset_layers.<down\1>.bn.\2"),
    (r"global_offset/fc(\d)/kernel", r"feat_global_offset_layers.<fc\1>.weight"),
    (r"global_offset/fc(\d)/bias", r"feat_global_offset_layers.<fc\1>.bias"),
    (r"(%s)/block(\d+)/(.*)" % "|".join(_CHAINS), r"\1.layers.\2.<block>\3"),
    (r"(dcn_(?:offset|mask)_\d)/conv/kernel", r"\1.conv.weight"),
    (r"(dcn_(?:offset|mask)_\d)/conv/bias", r"\1.conv.bias"),
    (r"(dcn_\d)/kernel", r"\1.weight"),
    (r"(dcn_\d)/bias", r"\1.bias"),
    (r"agg_final_layer/kernel", "agg_final_layer.weight"),
    (r"agg_final_layer/bias", "agg_final_layer.bias"),
]

# the inside of a residual block (BasicBlock or Bottleneck)
_BLOCK_RULES = [
    (r"conv(\d)/kernel", r"conv\1.weight"),
    (r"norm(\d)/bn/(\w+)", r"bn\1.\2"),
    (r"downsample/conv/kernel", "downsample.0.weight"),
    (r"downsample/norm/bn/(\w+)", r"downsample.1.\1"),
]


def _port_key(path):
    for pat, rep in _RULES:
        m = re.fullmatch(pat, path)
        if m is None:
            continue
        key = m.expand(rep)
        if "<block>" in key:
            head, rest = key.split("<block>")
            for bpat, brep in _BLOCK_RULES:
                bm = re.fullmatch(bpat, rest)
                if bm is not None:
                    return head + bm.expand(brep)
            break
        key = re.sub(r"<down(\d)>", lambda d: str(int(d.group(1)) + 1), key)
        return re.sub(r"<fc(\d)>", lambda d: str(int(d.group(1)) + 6), key)
    raise KeyError(f"no port name for flax path {path!r}")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _fc1_to_torch(kernel, channels=16):
    """flax fc1 kernel (H*W*C, out) -> torch weight (out, C*H*W)."""
    w = kernel.T
    hw = w.shape[1] // channels
    side = int(round(math.sqrt(hw)))
    if side * side != hw:
        raise ValueError(f"fc1 expects a square {channels}-channel map, "
                         f"got {w.shape[1]} inputs")
    return (w.reshape(w.shape[0], side, side, channels)
            .transpose(0, 3, 1, 2).reshape(w.shape[0], -1))


def state_dict_from_flax(variables):
    """Flax ``{"params", "batch_stats"}`` (nested dicts of arrays) -> port
    ``state_dict`` (an ``OrderedDict`` of float32 CPU tensors)."""
    out = OrderedDict()
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            if path[-2:-1] == ("bn",):
                path = path[:-1] + (_BN_LEAF[path[-1]],)
            key = _port_key("/".join(path))
            if path[-1] == "kernel":
                if value.ndim == 4:
                    value = value.transpose(3, 2, 0, 1)
                elif path[-2] == "fc1":
                    value = _fc1_to_torch(value)
                else:
                    value = value.T
            out[key] = torch.from_numpy(
                np.ascontiguousarray(value, dtype=np.float32)
            )
    return out


def block_state_dict_from_flax(variables):
    """A deform block's flax ``{"params", "batch_stats"}``
    (``fami_pose_tpu/models/deform_blocks.py``: ``AdaptBlock``,
    ``AdaptBlockV2``, ``DeformBlock``) -> the port block's ``state_dict``
    (``models/deform_blocks.py``). Submodules keep their names; conv
    kernels go HWIO -> OIHW; ``norm/bn/*`` -> ``norm.*`` and the shortcut's
    ``downsample/{conv,norm/bn}/*`` -> ``downsample.{0,1}.*`` with torch's
    leaf names."""
    out = OrderedDict()
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            if path[-2:-1] == ("bn",):
                path = path[:-2] + (_BN_LEAF[path[-1]],)
            if path[0] == "downsample":
                path = ("downsample", {"conv": "0", "norm": "1"}[path[1]]) \
                    + path[2:]
            if path[-1] == "kernel":
                path = path[:-1] + ("weight",)
                value = value.transpose(3, 2, 0, 1)
            out[".".join(path)] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return out


def quant_scales_from_flax(quant):
    """JAX ``quant`` collection (nested dicts of ``act_scale`` leaves) ->
    ``{port conv name: float32 scale}``: each conv's flax path, with
    ``kernel`` as its leaf, named as :func:`state_dict_from_flax` names the
    kernel, less ``.weight``."""
    out = OrderedDict()
    for path, value in _leaves(quant):
        if path[-1] != "act_scale":
            raise KeyError(f"unexpected quant leaf {'/'.join(path)}")
        key = _port_key("/".join(path[:-1] + ("kernel",)))
        out[key[:-len(".weight")]] = torch.tensor(
            np.asarray(value, dtype=np.float32))
    return out


@torch.no_grad()
def init_weights(model, seed=0):
    """Seeded random weights for the port (no JAX needed)."""
    gen = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, DeformConv):
            fan_in = module.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            module.weight.copy_(
                torch.rand(module.weight.shape, generator=gen) * 2 * bound
                - bound
            )
            module.bias.zero_()
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            module.weight.copy_(
                torch.randn(module.weight.shape, generator=gen)
                / math.sqrt(fan_in)
            )
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    return model


@torch.no_grad()
def calibrate_batch_norm(model, *inputs):
    """Set every BatchNorm's running mean and variance to those of what
    reaches it in one forward of ``inputs``, layer after layer.

    With identity statistics the raw (un-squashed) DCN masks compound
    through the four DCN stages and random-weight heatmaps reach ~1e27;
    calibrated, they stay O(1), and some offsets still pass the clamp.
    """
    def set_stats(bn, args):
        x = args[0].to(torch.float32)
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return model
