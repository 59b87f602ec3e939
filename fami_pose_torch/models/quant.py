"""Post-training int8 quantization for the eval path (``TPU.INT8_EVAL``); the
port of ``fami_pose_tpu/models/quant.py``.

Scheme (per-tensor activation scales, per-output-channel weight scales,
symmetric, as in the JAX package):

  * Each quantizable :class:`~fami_pose_torch.models.layers.Conv2d` (every
    conv of the HRNet backbone except ``final_layer``, and the head's three
    residual chains ``sup_agg_block``, ``combined_feat_layers`` and
    ``init_feature_agg_block``, which share the backbone's mode in the JAX
    model) carries a mode, ``conv.quant``: ``"off"`` (the float path),
    ``"calibrate"`` (the float path, keeping the running ``max(|x|)`` of
    its input in float32) or ``"int8"`` (``ops/int8_conv.py``).
  * :func:`calibrate` runs unflipped eval forwards with the convs in
    ``"calibrate"``, turns the absmaxes into scales
    (:func:`quant_scales_from_stats`), and sets them with
    :func:`set_quant_scales`, which also quantizes each conv's weights once
    (the JAX package quantizes them at every call; the bits are the same).
  * The scales and the quantized weights are non-persistent buffers: a
    ``state_dict`` and a checkpoint are the same with int8 as without, as
    the JAX package keeps its ``quant`` collection out of checkpoints.
    Loading a ``state_dict`` clears them, so the scales of one checkpoint
    never serve another; an int8 forward without scales raises.

An explicitly non-parity serving mode: the float path stays the default.
"""

from collections import OrderedDict

import torch

QUANT_OFF = "off"
QUANT_CALIBRATE = "calibrate"
QUANT_INT8 = "int8"
QUANT_MODES = (QUANT_OFF, QUANT_CALIBRATE, QUANT_INT8)


def quant_scales_from_stats(stats, margin=1.0):
    """``{conv name: act_absmax}`` -> ``{conv name: act_scale}``:
    ``max(absmax * margin, 1e-12) * (1 / 127)`` in float32. A dead input
    (absmax 0) still gets a positive scale; ``margin`` > 1 leaves clipping
    headroom."""
    return OrderedDict(
        (name, torch.clamp_min(
            torch.as_tensor(v, dtype=torch.float32) * margin, 1e-12)
         * (1.0 / 127.0))
        for name, v in stats.items())


def quantized_convs(model):
    """``{name: conv}`` of the convs of ``model`` whose mode is not
    ``"off"``, in module order."""
    return OrderedDict((name, m) for name, m in model.named_modules()
                       if getattr(m, "quant", QUANT_OFF) != QUANT_OFF)


def set_quant_scales(model, scales):
    """Give every quantized conv its activation scale (``{name: scale}``,
    exactly the names of :func:`quantized_convs`) and quantize its weights."""
    convs = quantized_convs(model)
    if set(scales) != set(convs):
        missing = sorted(set(convs) - set(scales))
        extra = sorted(set(scales) - set(convs))
        raise KeyError(f"int8 scales: missing {missing[:5]} "
                       f"({len(missing)}), unknown {extra[:5]} ({len(extra)})")
    for name, conv in convs.items():
        conv.set_act_scale(scales[name], name)
    return model


def quant_scales(model):
    """``{name: act_scale}`` of the quantized convs (None where unset)."""
    return OrderedDict((name, conv.act_scale)
                       for name, conv in quantized_convs(model).items())


@torch.no_grad()
def calibrate(model, batches, margin=1.0):
    """Calibrate ``model`` (eval mode, built with its quantizable convs in
    ``"int8"``) on ``batches``, an iterable of argument tuples for
    ``model(*args)``: a running max over every batch of each conv's input
    absmax, then the scales (:func:`quant_scales_from_stats`), set on the
    model with its weights quantized. Returns the scales."""
    if model.training:
        raise ValueError("calibrate runs eval forwards: call .eval() first")
    convs = quantized_convs(model)
    if not convs:
        raise ValueError("calibrate: the model has no quantized conv "
                         "(build it with backbone_quant='int8')")
    modes = {name: conv.quant for name, conv in convs.items()}
    for conv in convs.values():
        conv.clear_quant()
        conv.quant = QUANT_CALIBRATE
    seen = 0
    try:
        for args in batches:
            model(*args)
            seen += 1
        stats = OrderedDict((name, conv.act_absmax)
                            for name, conv in convs.items())
    finally:
        for name, conv in convs.items():
            conv.quant = modes[name]
    if seen == 0:
        raise ValueError("calibrate() needs at least one batch")
    idle = [name for name, v in stats.items() if v is None]
    if idle:
        raise RuntimeError(f"calibration never reached {idle[:5]} "
                           f"({len(idle)} convs)")
    scales = quant_scales_from_stats(stats, margin)
    set_quant_scales(model, scales)
    for conv in convs.values():
        conv.act_absmax = None
    return scales
