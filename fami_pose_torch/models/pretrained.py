"""Reference PyTorch checkpoints into the port
(``fami_pose_tpu/models/torch_remap.py``).

The reference loads a pretrained HRNet with an ``X -> hrnet.X`` key remap
(``Alignment_V15.py:216-240``) and its own checkpoints as ``{begin_epoch,
state_dict, optimizer}`` payloads. The port keeps the reference's module and
parameter names (``models/bridge.py``), so nothing is transposed here:

  * a backbone-only ``pose_hrnet_w48`` state dict (official HRNet names,
    ``final_layer`` included) becomes ``hrnet.X``
    (:func:`remap_hrnet_backbone_for_fami`);
  * a full ``Alignment_V15`` state dict keeps its names
    (:func:`remap_fami_pose_state_dict`);
  * ``num_batches_tracked`` is skipped (the port's BatchNorm has none).

Which keys count as mapped follows the JAX package's remap key for key, so
both packages report the same unmapped list for the same file.
:func:`merge_into_variables` overlays the mapped tensors on a model's
``state_dict`` with the JAX overlay's checks: ``KeyError`` for a key the
model lacks, ``ValueError`` for a shape that differs.
"""

import pickle
import re
from collections import OrderedDict

import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")

# official HRNet names the JAX remap maps, as (pattern, slot group index or
# None, leaf group index): a pattern with a slot takes the conv's ``weight``
# at slot 0 and a BatchNorm leaf at slot 1; one without takes the conv
# ``weight`` (leaf None) or a BatchNorm leaf (leaf group given)
_HRNET_KEYS = [
    (r"conv[12]\.weight", None, None),
    (r"bn[12]\.(\w+)", None, 1),
    (r"layer1\.\d+\.conv\d\.weight", None, None),
    (r"layer1\.\d+\.bn\d\.(\w+)", None, 1),
    (r"layer1\.\d+\.downsample\.0\.weight", None, None),
    (r"layer1\.\d+\.downsample\.1\.(\w+)", None, 1),
    (r"transition\d\.\d+\.(\d+)\.(\w+)", 1, 2),
    (r"transition\d\.\d+\.\d+\.(\d)\.(\w+)", 1, 2),
    (r"stage\d\.\d+\.branches\.\d+\.\d+\.conv\d\.weight", None, None),
    (r"stage\d\.\d+\.branches\.\d+\.\d+\.bn\d\.(\w+)", None, 1),
    (r"stage\d\.\d+\.branches\.\d+\.\d+\.downsample\.(\d)\.(\w+)", 1, 2),
    (r"stage\d\.\d+\.fuse_layers\.\d+\.\d+\.(\d)\.(\w+)", 1, 2),
    (r"stage\d\.\d+\.fuse_layers\.\d+\.\d+\.\d+\.(\d)\.(\w+)", 1, 2),
    (r"final_layer\.(?:weight|bias)", None, None),
]

# the alignment head's chains of BasicBlocks: the parts of a block key
_BLOCK_KEYS = [
    (r"conv[12]\.weight", None, None),
    (r"bn[12]\.(\w+)", None, 1),
    (r"downsample\.0\.weight", None, None),
    (r"downsample\.1\.(\w+)", None, 1),
]
_CHAINS = ("combined_feat_layers", "sup_agg_block", "init_feature_agg_block")


def load_torch_state_dict(path):
    """A ``.pth`` file -> ``{name: tensor}`` on the CPU: the ``state_dict``
    of a ``{begin_epoch, state_dict, optimizer}`` payload (or the file's
    dict itself), with a leading ``module.`` stripped from each name and
    entries that are not tensors dropped.

    The file is read with ``torch.load(weights_only=True)``; a file that
    needs arbitrary unpickling is refused with a ``ValueError`` that names
    it, and is never unpickled."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} cannot be read with torch.load(weights_only=True) "
            f"({type(e).__name__}: {e}); it is not loaded by unpickling "
            f"arbitrary objects: re-save its state_dict of tensors"
        ) from e
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = OrderedDict()
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
    return out


def _maps(patterns, key):
    """Whether ``key`` is one the JAX remap maps, by its patterns."""
    for pat, slot, leaf in patterns:
        m = re.fullmatch(pat, key)
        if m is None:
            continue
        if slot is None:
            return leaf is None or m.group(leaf) in _BN_LEAVES
        if m.group(slot) == "0":
            return m.group(leaf) == "weight"
        return m.group(slot) == "1" and m.group(leaf) in _BN_LEAVES
    return False


def remap_hrnet_state_dict(sd, prefix=""):
    """An HRNet state dict (official names, bare or ``hrnet.``-prefixed) ->
    ``(mapped, unmapped)``: ``{prefix + name: tensor}`` for every key the
    JAX remap maps, and the other keys as given (``num_batches_tracked``
    aside)."""
    mapped = OrderedDict()
    unmapped = []
    for key, value in sd.items():
        k = key[len("hrnet."):] if key.startswith("hrnet.") else key
        if _maps(_HRNET_KEYS, k):
            mapped[prefix + k] = value
        elif not k.endswith("num_batches_tracked"):
            unmapped.append(key)
    return mapped, unmapped


def remap_hrnet_backbone_for_fami(sd):
    """A backbone-only HRNet state dict -> ``(mapped, unmapped)`` with the
    FAMIPose names ``hrnet.X``, ``hrnet.final_layer`` included (the port
    keeps the shared heatmap head inside the backbone, where the reference
    has it). The loader of ``MODEL.PRETRAINED``."""
    return remap_hrnet_state_dict(sd, prefix="hrnet.")


def _head_key_maps(parts):
    """Whether a key of the alignment head (split at dots) is one the JAX
    remap of a full ``Alignment_V15`` state dict maps."""
    if parts[0] in _CHAINS and parts[1:2] == ["layers"]:
        return _maps(_BLOCK_KEYS, ".".join(parts[3:]))
    if parts[0] == "feat_global_offset_layers":
        slot = int(parts[1])
        if slot == 0 and parts[2] == "layers":
            return _maps(_BLOCK_KEYS, ".".join(parts[4:]))
        if 1 <= slot <= 5:
            return parts[2] == "conv" or (parts[2] == "bn"
                                          and parts[3] in _BN_LEAVES)
        if slot in (7, 8, 9):
            return parts[2] in ("weight", "bias")
        return False
    if parts[0].startswith(("dcn_offset_", "dcn_mask_")):
        return parts[1] == "conv"
    if parts[0].startswith("dcn_"):
        return parts[1] in ("weight", "bias")
    return parts[0] == "agg_final_layer"


def remap_fami_pose_state_dict(sd):
    """A full reference ``Alignment_V15`` state dict -> ``(mapped,
    unmapped)``. Names pass through as they are; the backbone's keys go
    through :func:`remap_hrnet_state_dict`, and ``hrnet.final_layer`` is
    always mapped. Unmapped keys are listed in the JAX remap's order: the
    head's as met, then the backbone's."""
    mapped = OrderedDict()
    unmapped = []
    backbone = OrderedDict()
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        if parts[0] == "hrnet":
            if parts[1] == "final_layer":
                mapped[key] = value
            else:
                backbone[key[len("hrnet."):]] = value
        elif _head_key_maps(parts):
            mapped[key] = value
        else:
            unmapped.append(key)
    hrnet, hrnet_unmapped = remap_hrnet_state_dict(backbone, prefix="hrnet.")
    mapped.update(hrnet)
    return mapped, unmapped + [f"hrnet.{k}" for k in hrnet_unmapped]


def merge_into_variables(variables, mapped):
    """Overlay ``mapped`` on a copy of the model ``state_dict``
    ``variables``; each value is cast to the dtype of the entry it replaces
    and put on its device. Raises ``KeyError`` for a key the model lacks and
    ``ValueError`` for a shape mismatch. Returns the new ``state_dict``."""
    out = OrderedDict(variables)
    for key, value in mapped.items():
        if key not in variables:
            raise KeyError(f"remap produced unknown key {key!r}")
        dst = variables[key]
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key!r}: "
                             f"{tuple(dst.shape)} vs {tuple(value.shape)}")
        out[key] = value.to(dtype=dst.dtype, device=dst.device)
    return out

