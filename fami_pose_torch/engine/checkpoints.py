"""Epoch-indexed checkpoints with auto-resume
(``fami_pose_tpu/engine/checkpoints.py``): ``epoch_{N}_state.ckpt`` files in
a checkpoints directory, the latest found by the index in the name, payload
``{begin_epoch, model, optimizer, scheduler, step}`` written with
``torch.save`` (to a temporary name, then renamed). ``resume`` returns the
epoch to continue with, ``begin_epoch + 1``. The JAX package writes the same
file names as flax msgpack; loading one here raises a ``ValueError`` that
names the weight bridge (``models/bridge.py::state_dict_from_flax``)."""

import os
import os.path as osp
import re

import torch

CKPT_PATTERN = re.compile(r"epoch_(\d+)_state\.ckpt$")


def checkpoint_path(directory, epoch):
    return osp.join(directory, f"epoch_{epoch}_state.ckpt")


def list_checkpoints(directory):
    """``[(epoch, path), ...]`` in epoch order."""
    if not osp.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = CKPT_PATTERN.match(name)
        if m:
            out.append((int(m.group(1)), osp.join(directory, name)))
    return sorted(out)


def get_latest_checkpoint(directory):
    ckpts = list_checkpoints(directory)
    return ckpts[-1][1] if ckpts else None


def get_all_checkpoints(directory, min_epoch=0):
    return [p for e, p in list_checkpoints(directory) if e >= min_epoch]


def save_checkpoint(directory, epoch, state):
    """Write ``state`` (a ``TrainState``) as the checkpoint of ``epoch``;
    returns its path."""
    path = checkpoint_path(directory, epoch)
    os.makedirs(directory, exist_ok=True)
    payload = dict(state.state_dict(), begin_epoch=int(epoch))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _load(path, device):
    """The payload of a port checkpoint. ``torch.save`` writes a zip archive,
    which starts with ``PK``; anything else (the JAX package writes the same
    file name as flax msgpack) is refused with a ``ValueError`` before
    ``torch.load`` could suggest unpickling it."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        raise ValueError(
            f"{path} is not a fami_pose_torch checkpoint (torch.save's zip "
            f"archive): it may be a flax msgpack checkpoint written by "
            f"fami_pose_tpu, which shares the file name. Convert its "
            f"variables with fami_pose_torch/models/bridge.py::"
            f"state_dict_from_flax and save them with torch.save"
        )
    return torch.load(path, map_location=device, weights_only=True)


def resume(path, state, device=None):
    """Restore ``state`` in place from ``path``; returns
    ``(state, begin_epoch + 1)``."""
    payload = _load(path, device)
    state.load_state_dict(payload)
    return state, int(payload["begin_epoch"]) + 1


def load_variables(path, device="cpu"):
    """Only the model's ``state_dict`` (parameters and BatchNorm statistics),
    for evaluation."""
    return _load(path, device)["model"]
