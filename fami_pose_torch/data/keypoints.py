"""Keypoint topologies and cross-dataset re-orderings.

The reference imports these tables from modules missing in its snapshot
(``datasets/zoo/coco``, ``datasets/zoo/posetrack/pose_topology``,
``datasets/zoo/jhmdb`` — see reference ``keypoints_ord.py:10-12``); the
orderings here are reconstructed from the vendored poseval protocol
(``poseval/py/eval_helpers.py:18-70`` for the 15-joint PoseTrack order,
``poseval/py/convert.py:37-53`` for landmark names) and the standard COCO-17
convention. Conversion semantics follow reference
``datasets/process/structure/keypoints_ord.py:14-237`` (neck = shoulder
midpoint; head_top = nose reflected about the shoulder midpoint).
"""

import numpy as np

# -- COCO 17 ------------------------------------------------------------------
COCO_JOINTS = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]
COCO_FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]
COCO_UPPER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
COCO_LOWER_BODY_IDS = (11, 12, 13, 14, 15, 16)
# per-joint loss weights used when LOSS.USE_DIFFERENT_JOINTS_WEIGHT is on
COCO_JOINTS_WEIGHT = np.array(
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.2, 1.2, 1.5, 1.5, 1.0, 1.0, 1.2, 1.2, 1.5, 1.5],
    dtype=np.float32,
).reshape((17, 1))

# COCO OKS per-joint sigmas (used by OKS-NMS; reference datasets/process/nms.py)
COCO_OKS_SIGMAS = (
    np.array(
        [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89]
    )
    / 10.0
)

# -- PoseTrack 15 (poseval protocol order) --------------------------------------
POSETRACK_JOINTS = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "right_wrist", "right_elbow", "right_shoulder",
    "left_shoulder", "left_elbow", "left_wrist", "neck", "nose", "head_top",
]

# -- Sub-JHMDB 15 ---------------------------------------------------------------
JHMDB_JOINTS = [
    "neck", "belly", "head_top", "right_shoulder", "left_shoulder",
    "right_hip", "left_hip", "right_elbow", "left_elbow",
    "right_knee", "left_knee", "right_wrist", "left_wrist",
    "right_ankle", "left_ankle",
]


def _neck_from_coco(pose):
    """(x, y, score) of the shoulder midpoint."""
    r, l = COCO_JOINTS.index("right_shoulder"), COCO_JOINTS.index("left_shoulder")
    xy = (pose[r, :2] + pose[l, :2]) / 2.0
    score = (pose[r, 2] + pose[l, 2]) / 2.0
    return xy, score


def _head_top_from_coco(pose):
    """Nose reflected about the shoulder midpoint (reference keypoints_ord.py:51-72)."""
    msho, score = _neck_from_coco(pose)
    nose = pose[COCO_JOINTS.index("nose"), :2]
    return nose - (msho - nose), score


def _convert_pose(pose, dst_names, global_score, as_records):
    """Shared conversion core: COCO-17 (J,3) array -> dst ordering."""
    pose = np.asarray(pose, dtype=np.float64)
    out_array = np.zeros((len(dst_names), 3))
    records = []
    for k, name in enumerate(dst_names):
        if name in COCO_JOINTS:
            idx = COCO_JOINTS.index(name)
            xy = pose[idx, :2]
            score = pose[idx, 2] * global_score
        elif name == "neck" or name == "head_bottom":
            xy, local = _neck_from_coco(pose)
            score = local * global_score
        elif name == "head_top":
            xy, score = _head_top_from_coco(pose)
            # NOTE: the reference does NOT multiply head_top by global_score
            # (keypoints_ord.py:64-72) — reproduced for protocol parity.
        else:
            # joints with no COCO analog (e.g. JHMDB belly): midpoint of hips
            rh, lh = COCO_JOINTS.index("right_hip"), COCO_JOINTS.index("left_hip")
            xy = (pose[rh, :2] + pose[lh, :2]) / 2.0
            score = (pose[rh, 2] + pose[lh, 2]) / 2.0 * global_score
        out_array[k, :2] = xy
        out_array[k, 2] = score
        records.append(
            {"id": [k], "x": [float(xy[0])], "y": [float(xy[1])], "score": [float(score)]}
        )
    return records if as_records else out_array


def coco2posetrack_ord(preds, global_score=1.0):
    """(3, 17) array -> list of poseval point dicts (reference keypoints_ord.py:14-73)."""
    pose = np.asarray(preds, dtype=np.float64).T  # (17, 3)
    return _convert_pose(pose, POSETRACK_JOINTS, float(global_score), as_records=True)


def coco2posetrack_ord_infer(pose, global_score=1.0, output_posetrack_format=False):
    """(17, 3) array -> (15, 3) array or poseval point dicts."""
    return _convert_pose(pose, POSETRACK_JOINTS, float(global_score), output_posetrack_format)


def coco2jhmdb_ord_infer(pose, global_score=1.0, output_posetrack_format=False):
    """(17, 3) array -> JHMDB 15-joint ordering."""
    return _convert_pose(pose, JHMDB_JOINTS, float(global_score), output_posetrack_format)
