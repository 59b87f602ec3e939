"""PoseTrack annolist data loading + preprocessing.

Protocol-equivalent reimplementation of the vendored poseval loaders
(``poseval/py/eval_helpers.py:305-446``, ``convert.py``): reads per-sequence
GT/prediction JSON files ("annolist" PoseTrack17 format, or COCO-style
PoseTrack18 format which is converted on the fly), namespaces track ids per
sequence, drops GT-empty frames, strips rects without annotated points, and
removes points inside ignore regions (pure-numpy point-in-polygon; the
vendored code used shapely).
"""

import glob
import json
import os.path as osp
from typing import Dict, List, Tuple

import numpy as np

MIN_SCORE = -9999
MAX_TRACK_ID = 10000
N_JOINTS = 15

# PoseTrack15 joint id order (eval_helpers.py:18-70)
JOINT_NAMES = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "right_wrist", "right_elbow", "right_shoulder",
    "left_shoulder", "left_elbow", "left_wrist", "neck", "nose", "head_top",
]

# PoseTrack18 COCO-style keypoint slot names (convert.py:19-37)
PT18_COCO_ORDER = [
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]
_PT18_NAME_TO_ID = {n: i for i, n in enumerate(JOINT_NAMES)}
_PT18_NAME_TO_ID["head_bottom"] = JOINT_NAMES.index("neck")


def get_head_size(x1, y1, x2, y2) -> float:
    """0.6 * head bbox diagonal (eval_helpers.py:82-84)."""
    return 0.6 * float(np.linalg.norm([x2 - x1, y2 - y1]))


def point_by_id(points: List[dict], pid: int):
    for p in points:
        if p.get("id") is not None and p["id"][0] == pid:
            return p
    return None


def _coco_style_to_annolist(data: dict) -> List[dict]:
    """PoseTrack18 COCO-style json -> annolist frames (convert.py semantics)."""
    imgs = {im["id"]: im for im in data.get("images", [])}
    per_image: Dict[int, List[dict]] = {im_id: [] for im_id in imgs}
    kp_names = None
    for cat in data.get("categories", []):
        if cat.get("keypoints"):
            kp_names = cat["keypoints"]
    kp_names = kp_names or PT18_COCO_ORDER

    for ann in data.get("annotations", []):
        per_image.setdefault(ann["image_id"], []).append(ann)

    annolist = []
    for im_id in sorted(imgs.keys()):
        im = imgs[im_id]
        annorect = []
        for ann in per_image.get(im_id, []):
            kps = ann.get("keypoints", [])
            scores = ann.get("scores", [])
            points = []
            for slot, name in enumerate(kp_names):
                jid = _PT18_NAME_TO_ID.get(name)
                if jid is None:
                    continue  # ears have no PT15 slot
                if slot * 3 + 2 >= len(kps):
                    continue
                x, y, vis = kps[slot * 3 : slot * 3 + 3]
                if vis == 0 and not (x or y):
                    continue
                pt = {"id": [jid], "x": [float(x)], "y": [float(y)]}
                if slot < len(scores):
                    pt["score"] = [float(scores[slot])]
                points.append(pt)
            rect = {"annopoints": [{"point": points}] if points else []}
            if "bbox_head" in ann:
                bx, by, bw, bh = ann["bbox_head"]
                rect.update(
                    x1=[float(bx)], y1=[float(by)],
                    x2=[float(bx + bw)], y2=[float(by + bh)],
                )
            if "track_id" in ann:
                rect["track_id"] = [int(ann["track_id"])]
            if "score" in ann:
                rect["score"] = [float(ann["score"])]
            annorect.append(rect)
        frame = {
            "image": [{"name": im.get("file_name", im.get("posetrack_filename", ""))}],
            "annorect": annorect,
        }
        ignore = im.get("ignore_regions_x")
        if ignore:
            regions = []
            for rx, ry in zip(im["ignore_regions_x"], im["ignore_regions_y"]):
                regions.append(
                    {"point": [{"x": [x], "y": [y]} for x, y in zip(rx, ry)]}
                )
            frame["ignore_regions"] = regions
        annolist.append(frame)
    return annolist


def load_annolist_file(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    if "annolist" in data:
        return data["annolist"]
    return _coco_style_to_annolist(data)


def _has_points(rect) -> bool:
    ap = rect.get("annopoints")
    return bool(ap) and bool(ap[0].get("point"))


def _poly_contains(px, py, poly_x, poly_y) -> bool:
    """Ray-casting point-in-polygon."""
    n = len(poly_x)
    inside = False
    j = n - 1
    for i in range(n):
        xi, yi = poly_x[i], poly_y[i]
        xj, yj = poly_x[j], poly_y[j]
        if (yi > py) != (yj > py) and px < (xj - xi) * (py - yi) / (yj - yi) + xi:
            inside = not inside
        j = i
    return inside


def _remove_ignored(frames_gt: List[dict], frames_pr: List[dict]):
    """Drop points inside GT ignore regions (eval_helpers.py:322-368)."""
    for gt, pr in zip(frames_gt, frames_pr):
        regions = gt.get("ignore_regions")
        if not regions:
            continue
        polys = []
        for reg in regions:
            pts = reg.get("point", [])
            if len(pts) >= 3:
                polys.append((
                    [p["x"][0] for p in pts], [p["y"][0] for p in pts],
                ))
        if not polys:
            continue
        for frame in (gt, pr):
            kept_rects = []
            for rect in frame["annorect"]:
                if not _has_points(rect):
                    kept_rects.append(rect)
                    continue
                pts = rect["annopoints"][0]["point"]
                kept = [
                    p for p in pts
                    if not any(
                        _poly_contains(p["x"][0], p["y"][0], px, py)
                        for px, py in polys
                    )
                ]
                if kept:
                    rect["annopoints"][0]["point"] = kept
                    kept_rects.append(rect)
            frame["annorect"] = kept_rects
    return frames_gt, frames_pr


def video2filenames(annot_dir: str) -> Tuple[Dict[str, str], Dict[str, int]]:
    """Map ``images/<video>`` -> GT json filename and frame count, by
    scanning the GT annolist dir (reference ``utils_json/video2filenames``
    semantics: prediction files must mirror the GT file names)."""
    out_fnames: Dict[str, str] = {}
    out_len: Dict[str, int] = {}
    for path in sorted(glob.glob(osp.join(annot_dir, "*.json"))):
        frames = load_annolist_file(path)
        if not frames:
            continue
        name = frames[0]["image"][0]["name"]
        video = osp.dirname(name)
        out_fnames[video] = osp.basename(path)
        out_len[video] = len(frames)
    return out_fnames, out_len


def load_data_dir(gt_dir: str, pred_dir: str) -> Tuple[List[dict], List[dict]]:
    """Load + align GT and prediction annolists across all sequences."""
    gt_all: List[dict] = []
    pr_all: List[dict] = []
    files = sorted(glob.glob(osp.join(gt_dir, "*.json")))
    if not files:
        raise IOError(f"no GT json files in {gt_dir}")
    for seq_idx, gt_file in enumerate(files):
        gt = load_annolist_file(gt_file)
        pred_file = osp.join(pred_dir, osp.basename(gt_file))
        if not osp.exists(pred_file):
            raise IOError(f"Prediction file {pred_file} does not exist")
        pr = load_annolist_file(pred_file)
        if len(pr) != len(gt):
            raise ValueError(
                f"#pred frames {len(pr)} != #GT frames {len(gt)} for {pred_file}"
            )
        for frames in (gt, pr):
            for frame in frames:
                frame["seq_id"] = seq_idx
                frame["seq_name"] = osp.basename(gt_file).split(".")[0]
                for rect in frame["annorect"]:
                    if "track_id" in rect:
                        assert rect["track_id"][0] < MAX_TRACK_ID
                        rect["track_id"][0] += seq_idx * MAX_TRACK_ID
        gt_all += gt
        pr_all += pr

    # drop GT-empty frames, strip point-less rects (cleanupData)
    keep = [i for i, f in enumerate(gt_all) if len(f["annorect"]) > 0]
    gt_all = [gt_all[i] for i in keep]
    pr_all = [pr_all[i] for i in keep]
    for frame in gt_all + pr_all:
        frame["annorect"] = [r for r in frame["annorect"] if _has_points(r)]

    return _remove_ignored(gt_all, pr_all)
