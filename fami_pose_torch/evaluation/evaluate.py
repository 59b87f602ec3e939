"""Top-level evaluation entry point (``poseval/py/evaluate_simple.py:13-50``).

``evaluate(gt_dir, pred_dir, eval_pose, eval_track)`` loads the aligned
GT/prediction annolists and returns the per-joint AP table (and tracking
table when requested), as OrderedDicts in the reference's result format
(Head/Shou/Elb/Wri/Hip/Knee/Ankl/Total groupings are the caller's concern;
here the raw 15-joint + mean arrays are returned alongside the grouped
summary).
"""

from collections import OrderedDict
from typing import Dict

import numpy as np

from .ap import compute_metrics, evaluate_ap
from .assign import assign_gt_multi
from .poseval_data import JOINT_NAMES, load_data_dir
from .tracking import evaluate_tracking

# poseval result-table grouping: joint ids averaged per column
# (eval_helpers printTable: head={14,13?}.. use the standard poseval groups)
GROUPS = OrderedDict(
    [
        ("Head", [14]),          # head_top
        ("Shou", [8, 9]),        # shoulders
        ("Elb", [7, 10]),
        ("Wri", [6, 11]),
        ("Hip", [2, 3]),
        ("Knee", [1, 4]),
        ("Ankl", [0, 5]),
    ]
)


def group_table(per_joint: np.ndarray) -> "OrderedDict[str, float]":
    """15-joint array (+ mean slot) -> the 8-column summary table."""
    out = OrderedDict()
    for name, ids in GROUPS.items():
        out[name] = float(np.mean([per_joint[i] for i in ids]))
    out["Mean"] = float(per_joint[len(JOINT_NAMES)])
    return out


def evaluate_ap_files(gt_dir: str, pred_dir: str):
    """AP-only evaluation; returns (grouped OrderedDict, raw ap array)."""
    gt, pr = load_data_dir(gt_dir, pred_dir)
    ap, pre, rec = evaluate_ap(gt, pr)
    return group_table(ap[:, 0]), ap


def evaluate(
    gt_dir: str, pred_dir: str, eval_pose: bool = True, eval_track: bool = False
) -> Dict:
    """Full evaluation; mirrors ``evaluate_simple.evaluate``'s call pattern."""
    gt, pr = load_data_dir(gt_dir, pred_dir)
    result: Dict = {}
    mot_all = None
    if eval_pose or eval_track:
        scores_all, labels_all, n_gt_all, mot_all = assign_gt_multi(gt, pr, 0.5)
    if eval_pose:
        ap, pre, rec = compute_metrics(scores_all, labels_all, n_gt_all)
        result["ap"] = ap
        result["ap_table"] = group_table(ap[:, 0])
        result["precision"] = pre
        result["recall"] = rec
    if eval_track:
        track = evaluate_tracking(gt, mot_all)
        result["mota"] = track["mota"]
        result["mota_table"] = group_table(track["mota"])
        result["motp"] = track["motp"]
        result["track_pre"] = track["pre"]
        result["track_rec"] = track["rec"]
    return result
