"""Prediction -> poseval annolist JSON writer.

Reimplements ``datasets/process/structure/data_format.py:12-49``
(``convert_data_to_annorect_struct``: COCO-17 poses -> PoseTrack-15 annopoint
records, dummy detection for empty frames — a MOTA requirement) and the
per-video regrouping + JSON writing half of ``PoseTrack_Alignment.evaluate``
(``:894-1018``: group flat predictions by video, emit one annolist json per
video, fill frames that got no predictions).
"""

import json
import os
import os.path as osp
from typing import Dict, List

import numpy as np

from fami_pose_torch.data.keypoints import coco2posetrack_ord


def _dummy_annorect():
    """MOTA requires >= 1 detection per frame (data_format.py:37-48)."""
    return {
        "annopoints": [{"point": [{"id": [0], "x": [0], "y": [0], "score": [-100.0]}]}],
        "score": [0],
        "track_id": [0],
    }


def convert_data_to_annorect_struct(poses, tracks, boxes, **kwargs):
    """Args mirror the reference: ``poses`` N x (4, 17) arrays (x, y, 1,
    score rows), ``tracks`` N ids, ``boxes`` N x (1, 6) arrays whose [0, 5]
    is the detection score."""
    eval_tracking = kwargs.get("eval_tracking", False)
    tracking_threshold = kwargs.get("tracking_threshold", 0)
    annorect = []
    for pose, track, box in zip(poses, tracks, boxes):
        score = float(np.asarray(box)[0, 5])
        # NOTE: reproduces the reference's comparison direction verbatim
        # (data_format.py:26: `if eval_tracking and score > threshold: continue`)
        if eval_tracking and score > tracking_threshold:
            continue
        point = coco2posetrack_ord(pose, global_score=score)
        annorect.append(
            {
                "annopoints": [{"point": point}],
                "score": [score],
                "track_id": [int(track)],
            }
        )
    if len(poses) == 0:
        annorect.append(_dummy_annorect())
    return annorect


def write_video_annolists(
    predictions_by_frame: Dict[str, dict],
    frames_by_video: Dict[str, List[str]],
    output_dir: str,
    **kwargs,
) -> List[str]:
    """Write one ``<video>.json`` annolist per video.

    Args:
      predictions_by_frame: frame image path -> dict(poses, tracks, boxes)
        (each as in :func:`convert_data_to_annorect_struct`).
      frames_by_video: video name -> ordered list of frame image paths
        (every frame of the sequence; frames without predictions get the
        dummy detection).
    Returns the list of file paths written.
    """
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for video, frame_paths in frames_by_video.items():
        annolist = []
        for fp in frame_paths:
            pred = predictions_by_frame.get(fp)
            if pred is None:
                annorect = [_dummy_annorect()]
            else:
                annorect = convert_data_to_annorect_struct(
                    pred["poses"], pred["tracks"], pred["boxes"], **kwargs
                )
            annolist.append({"image": [{"name": fp}], "annorect": annorect})
        out_name = osp.join(output_dir, video.split("/")[-1] + ".json")
        with open(out_name, "w") as f:
            json.dump({"annolist": annolist}, f)
        written.append(out_name)
    return written
