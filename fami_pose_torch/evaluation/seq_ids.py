"""PoseTrack18 image-id <-> sequence-filename converters.

Equivalent of the reference's ``poseval/py/posetrack18_id2fname.py`` (1713
LoC, of which ~1570 lines are the official train/test-val sequence split
registry). The registry itself is protocol data — it defines which
``(source, sequence)`` pairs belong to the train vs. test/val splits of
PoseTrack17/18 — and is stored here as a compact packed JSON
(``data/posetrack_sequences.json``: sorted ints ``source_idx * 1e6 + seq_idx``
per split). The converters re-implement the id scheme:

    image_id = T * 10_000_000_000 + SSSSSS * 10_000 + FFFF

with ``T`` the sequence source (1 = mpii, 2 = bonn, 3 = mpiinew), ``SSSSSS``
the 6-digit sequence index and ``FFFF`` the 4-digit frame index; filenames
are ``{seq:06d}_{source}_{split}``.
"""

import json
import os
from functools import lru_cache
from typing import Tuple

_SEQ_SOURCES = {1: "mpii", 2: "bonn", 3: "mpiinew"}
_SEQ_SOURCE_IDX = {v: k for k, v in _SEQ_SOURCES.items()}

_DATA_PATH = os.path.join(
    os.path.dirname(__file__), "data", "posetrack_sequences.json"
)


@lru_cache(maxsize=1)
def _tables():
    with open(_DATA_PATH) as f:
        packed = json.load(f)

    def unpack(codes):
        return frozenset((c // 1000000, c % 1000000) for c in codes)

    return {k: unpack(v) for k, v in packed.items()}


def idx2seqtype(idx: int) -> str:
    try:
        return _SEQ_SOURCES[int(idx)]
    except KeyError:
        raise ValueError(f"unknown sequence source index {idx!r}") from None


def seqtype2idx(seqtype: str) -> int:
    try:
        return _SEQ_SOURCE_IDX[seqtype]
    except KeyError:
        raise ValueError(f"unknown sequence type {seqtype!r}") from None


def posetrack18_id2fname(image_id: int) -> Tuple[str, int]:
    """image id -> (sequence filename, frame index)."""
    image_id = int(image_id)
    source_idx = image_id // 10_000_000_000
    seq_idx = (image_id % 10_000_000_000) // 10_000
    frame_idx = image_id % 10_000

    t = _tables()
    key = (source_idx, seq_idx)
    if key in t["pt17_testval"] or key in t["pt18_testval"]:
        split = "test"
    elif key in t["pt17_train"] or key in t["pt18_train"]:
        split = "train"
    else:
        raise ValueError(
            f"sequence ({source_idx}, {seq_idx}) not in any PoseTrack split"
        )
    fname = f"{seq_idx:06d}_{idx2seqtype(source_idx)}_{split}"
    return fname, frame_idx


def posetrack18_fname2id(fname: str, frame_idx: int) -> int:
    """(sequence filename, frame index) -> image id."""
    tokens = os.path.basename(fname).split("_")
    seq_idx = int(tokens[0])
    source_idx = seqtype2idx(tokens[1])
    frame_idx = int(frame_idx)
    if not 0 <= frame_idx < 10_000:
        raise ValueError(f"frame index {frame_idx} out of range [0, 10000)")
    return source_idx * 10_000_000_000 + seq_idx * 10_000 + frame_idx
