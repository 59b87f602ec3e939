"""Two-way PoseTrack17 (annolist) <-> PoseTrack18 (COCO-style) converter.

Functional re-implementation of the vendored poseval converter
(``datasets/zoo/posetrack/posetrack_utils/poseval/py/convert.py:1-627``):
same JSON contract in both directions — landmark order tables, the ear-slots-
zeroed COCO ordering, singleton-list wrapping of every annolist scalar, the
0.65-extent person rect synthesized from landmarks, ``imgnum = frame + 1``,
``id = frame_id * 100 + person_idx`` — but written as plain dict->dict
functions (no Video/Image/Person class tree) with an indexed pass over
annotations instead of the reference's O(images x annotations) scan.

Image-id codec (``posetrack18_id2fname.py:1595-1666``): ids are
``T*1e10 + SSSSSS*1e4 + FFFF`` with T in {1: mpii, 2: bonn, 3: mpiinew}.
The reference resolves the ``_train``/``_test`` filename suffix from ~1500
hardcoded sequence-id pairs; here the codec *learns* suffixes from the
filenames it has seen (every old->new conversion registers its sequence), and
``register_sequence``/``load_split_table`` seed it explicitly when converting
new->old files whose sequences were never observed. Unknown sequences default
to ``_train`` with a warning rather than asserting.
"""

import json
import logging
import os
import os.path as osp
from typing import Dict, List, Optional, Tuple

LOGGER = logging.getLogger(__name__)

# COCO-17 keypoint slots as PoseTrack18 names them; the ear slots carry no
# PoseTrack landmark and stay zeroed (convert.py:19-37).
PT18_NAMES_COCO_ORDER = [
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

# Canonical 15-landmark order; a landmark's index here IS its annolist point
# id (convert.py:38-54).
PT_CANONICAL_NAMES = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "right_wrist", "right_elbow", "right_shoulder",
    "left_shoulder", "left_elbow", "left_wrist", "head_bottom", "nose",
    "head_top",
]

COCO_SKELETON = [
    [16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13],
    [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3], [1, 2], [1, 3],
    [2, 4], [3, 5], [4, 6], [5, 7],
]

_SEQ_TYPES = {1: "mpii", 2: "bonn", 3: "mpiinew"}
_SEQ_TYPE_IDS = {v: k for k, v in _SEQ_TYPES.items()}

# learned (seqtype_idx, seqidx) -> "train" | "test" suffix registry
_SPLIT_REGISTRY: Dict[Tuple[int, int], str] = {}


def register_sequence(seq_name: str) -> None:
    """Record a sequence folder name (e.g. ``000043_mpii_train``) so
    ``posetrack18_id2fname`` can reproduce its split suffix later."""
    toks = osp.basename(seq_name).split("_")
    if len(toks) >= 3 and toks[1] in _SEQ_TYPE_IDS and toks[2] in ("train", "test"):
        _SPLIT_REGISTRY[(_SEQ_TYPE_IDS[toks[1]], int(toks[0]))] = toks[2]


def load_split_table(gt_dir: str) -> int:
    """Seed the split registry from a directory of per-sequence JSON files
    (their basenames are the sequence names). Returns sequences registered."""
    n = 0
    for name in os.listdir(gt_dir):
        if name.endswith(".json"):
            register_sequence(name[: -len(".json")])
            n += 1
    return n


def posetrack18_fname2id(fname: str, frameidx: int) -> int:
    """Sequence name + frame index -> PT18 image id
    (``posetrack18_id2fname.py:1651-1665``)."""
    register_sequence(fname)
    toks = osp.basename(fname).split("_")
    seqidx = int(toks[0])
    seqtype = toks[1]
    if seqtype not in _SEQ_TYPE_IDS:
        raise ValueError(f"unknown sequence type in {fname!r}")
    if not 0 <= frameidx < 10**4:
        raise ValueError(f"frame index {frameidx} out of range")
    return _SEQ_TYPE_IDS[seqtype] * 10**10 + seqidx * 10**4 + frameidx


def posetrack18_id2fname(image_id: int) -> Tuple[str, int]:
    """PT18 image id -> (sequence name, frame index)
    (``posetrack18_id2fname.py:1618-1648``). The train/test suffix comes from
    the learned registry; unknown sequences default to ``train``."""
    seqtype_idx = image_id // 10**10
    seqidx = (image_id % 10**10) // 10**4
    frameidx = image_id % 10**4
    suffix = _SPLIT_REGISTRY.get((seqtype_idx, seqidx))
    if suffix is None:
        LOGGER.warning(
            "sequence (%d, %d) not in the split registry; assuming _train "
            "(seed it with register_sequence/load_split_table)",
            seqtype_idx, seqidx,
        )
        suffix = "train"
    return f"{seqidx:06}_{_SEQ_TYPES[seqtype_idx]}_{suffix}", frameidx


# --------------------------------------------------------------------------
# old (PT17 annolist) -> new (PT18 COCO-style)
# --------------------------------------------------------------------------

def _person_from_old(rect: dict) -> dict:
    """annorect dict -> internal person dict (convert.py:316-372)."""
    person = {
        "track_id": rect["track_id"][0],
        "rect_head": {k: rect[k][0] for k in ("x1", "x2", "y1", "y2")},
        "rect": None,
        "score": rect["score"][0] if "score" in rect else None,
        "landmarks": [],
    }
    points = (rect.get("annopoints") or [{}])[0].get("point", [])
    xs, ys = [], []
    for p in points:
        lm = {"x": p["x"][0], "y": p["y"][0], "id": p["id"][0]}
        if "score" in p:
            lm["score"] = p["score"][0]
        if "is_visible" in p:
            lm["is_visible"] = p["is_visible"][0]
        xs.append(lm["x"])
        ys.append(lm["y"])
        person["landmarks"].append(lm)
    if xs:
        # person rect = landmark extent scaled 1.3x about its center
        # (convert.py:361-372)
        cx, cy = (max(xs) + min(xs)) / 2.0, (max(ys) + min(ys)) / 2.0
        ex, ey = max(xs) - min(xs), max(ys) - min(ys)
        person["rect"] = {
            "x1": cx - ex * 0.65, "x2": cx + ex * 0.65,
            "y1": cy - ey * 0.65, "y2": cy + ey * 0.65,
        }
    return person


def _person_to_new(person: dict) -> dict:
    """internal person -> PT18 annotation (convert.py:225-276)."""
    by_id = {lm["id"]: lm for lm in person["landmarks"]}
    write_scores = any("score" in lm for lm in person["landmarks"])
    keypoints, scores = [], []
    for name in PT18_NAMES_COCO_ORDER:
        lm_id = PT_CANONICAL_NAMES.index(name) if name in PT_CANONICAL_NAMES else -1
        lm = by_id.get(lm_id, {"x": 0, "y": 0, "is_visible": 0})
        keypoints.extend([lm["x"], lm["y"], lm.get("is_visible", 1)])
        if "score" in lm:
            scores.append(lm["score"])
        elif write_scores:
            LOGGER.warning("landmark missing score; writing 0")
            scores.append(0.0)
    ann = {
        "track_id": person["track_id"],
        "category_id": 1,
        "keypoints": keypoints,
        "scores": scores,
    }
    for key, rect in (("bbox", person["rect"]), ("bbox_head", person["rect_head"])):
        if rect:
            ann[key] = [
                rect["x1"], rect["y1"],
                rect["x2"] - rect["x1"], rect["y2"] - rect["y1"],
            ]
    return ann


def _old_to_new(track_data: dict) -> dict:
    """One annolist file -> one PT18 COCO-style dict (convert.py:84-128,
    251-268 of Video.from_old/to_new)."""
    frames = track_data["annolist"]
    images, annotations = [], []
    vid_id = None
    for frame in frames:
        fname = frame["image"][0]["name"]
        seq_dir = osp.basename(osp.dirname(fname))
        if vid_id is None:
            vid_id = seq_dir.split("_")[0]
        stem = osp.basename(fname).split(".")[0]
        if "_" in stem:
            stem = stem.split("_")[0]
        frame_id = posetrack18_fname2id(seq_dir, int(stem))

        image = {
            "file_name": fname,
            "has_no_densepose": True,
            "is_labeled": bool(frame.get("annorect")),
            "frame_id": frame_id,
            "vid_id": vid_id,
            "nframes": len(frames),
            "id": frame_id,
        }
        if "ignore_regions" in frame:
            image["ignore_regions_x"] = [
                [pt["x"][0] for pt in reg["point"]]
                for reg in frame["ignore_regions"]
            ]
            image["ignore_regions_y"] = [
                [pt["y"][0] for pt in reg["point"]]
                for reg in frame["ignore_regions"]
            ]
        images.append(image)

        for pi, rect in enumerate(frame.get("annorect", [])):
            ann = _person_to_new(_person_from_old(rect))
            ann["image_id"] = frame_id
            ann["id"] = frame_id * 100 + pi
            annotations.append(ann)

    return {
        "images": images,
        "annotations": annotations,
        "categories": [{
            "supercategory": "person",
            "name": "person",
            "skeleton": COCO_SKELETON,
            "keypoints": PT18_NAMES_COCO_ORDER,
            "id": 1,
        }],
    }


# --------------------------------------------------------------------------
# new (PT18 COCO-style) -> old (PT17 annolist)
# --------------------------------------------------------------------------

def _person_from_new(ann: dict, conversion: List[Optional[int]]) -> dict:
    """PT18 annotation -> internal person (convert.py:375-423)."""
    person = {
        "track_id": ann["track_id"],
        "rect_head": None,
        "rect": None,
        "score": ann.get("score"),
        "landmarks": [],
    }
    for key, field in (("bbox_head", "rect_head"), ("bbox", "rect")):
        if key in ann:
            x, y, w, h = ann[key][:4]
            person[field] = {"x1": x, "x2": x + w, "y1": y, "y2": y + h}
    scores = ann.get("scores")
    kps = ann["keypoints"]
    for i, can_id in enumerate(conversion):
        if can_id is None:
            continue
        x, y, vis = kps[3 * i], kps[3 * i + 1], kps[3 * i + 2]
        lm = {"x": x, "y": y, "id": can_id, "is_visible": vis}
        if scores:
            lm["score"] = scores[i]
        person["landmarks"].append(lm)
    return person


def _person_to_old(person: dict) -> dict:
    """internal person -> annorect dict (convert.py:278-314)."""
    points = []
    for lm in person["landmarks"]:
        if lm["x"] == 0 and lm["y"] == 0 and lm.get("is_visible") == 0:
            continue  # unannotated slot in the new format (convert.py:283-289)
        point = {"id": [lm["id"]], "x": [lm["x"]], "y": [lm["y"]]}
        if "score" in lm:
            point["score"] = [lm["score"]]
        if "is_visible" in lm:
            point["is_visible"] = [lm["is_visible"]]
        points.append(point)
    rect = {
        "track_id": [person["track_id"]],
        "annopoints": [{"point": points}],
    }
    if person["rect_head"]:
        for k in ("x1", "x2", "y1", "y2"):
            rect[k] = [person["rect_head"][k]]
    if person["score"] is not None:
        rect["score"] = [person["score"]]
    return rect


def _split_new_by_video(track_data: dict) -> List[dict]:
    """Group a PT18 file's images/annotations by video, converting each to
    one annolist dict (convert.py:130-148, 171-204)."""
    names = track_data["categories"][0]["keypoints"]
    assert track_data["categories"][0]["name"] == "person"
    assert len(names) in (15, 17), f"unexpected keypoint count {len(names)}"
    conversion = [
        PT_CANONICAL_NAMES.index(n) if n in PT_CANONICAL_NAMES else None
        for n in names
    ]
    missing = set(range(len(PT_CANONICAL_NAMES))) - set(
        c for c in conversion if c is not None
    )
    assert not missing, f"landmarks missing from categories: {missing}"

    anns_by_image: Dict[int, List[dict]] = {}
    for ann in track_data["annotations"]:
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    videos: Dict[str, dict] = {}
    order: List[str] = []
    for image in track_data["images"]:
        fname = image["file_name"]
        seq_dir = osp.basename(osp.dirname(fname))
        register_sequence(seq_dir)
        vid = seq_dir.split("_")[0]
        if vid not in videos:
            videos[vid] = {"annolist": []}
            order.append(vid)

        frame = {"image": [{"name": fname}]}
        frame["imgnum"] = [int(osp.basename(fname).split(".")[0]) + 1]
        if "ignore_regions_x" in image and "ignore_regions_y" in image:
            frame["ignore_regions"] = [
                {"point": [{"x": [x], "y": [y]} for x, y in zip(xs, ys)]}
                for xs, ys in zip(
                    image["ignore_regions_x"], image["ignore_regions_y"]
                )
            ]
        people = [
            _person_to_old(_person_from_new(a, conversion))
            for a in anns_by_image.get(image["id"], [])
        ]
        frame["annorect"] = people
        frame["is_labeled"] = [1 if people else 0]
        videos[vid]["annolist"].append(frame)
    return [videos[v] for v in order]


def convert_videos(track_data: dict) -> List[dict]:
    """Auto-detecting single-dict entry point (convert.py:605-621):
    annolist-keyed input -> [one PT18 dict]; COCO-keyed input -> one annolist
    dict per video."""
    if "annolist" in track_data:
        return [_old_to_new(track_data)]
    assert "images" in track_data, "unknown input format"
    return _split_new_by_video(track_data)


def convert_dir(in_path: str, out_dir: str) -> List[str]:
    """Convert a file or directory of JSONs; one output file per video named
    after its sequence (convert.py:538-583). Returns written paths."""
    if osp.isfile(in_path):
        files = [in_path]
    else:
        files = sorted(
            osp.join(in_path, f)
            for f in os.listdir(in_path)
            if f.endswith(".json")
        )
        # first pass: learn every split suffix before any id2fname lookup
        for f in files:
            register_sequence(osp.basename(f)[: -len(".json")])
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fp in files:
        with open(fp) as inf:
            data = json.load(inf)
        for video in convert_videos(data):
            if "annolist" in video:
                first = video["annolist"][0]["image"][0]["name"]
                seq = osp.basename(osp.dirname(first))
            else:
                seq = posetrack18_id2fname(video["images"][0]["frame_id"])[0]
            out_fp = osp.join(out_dir, seq + ".json")
            with open(out_fp, "w") as outf:
                json.dump(video, outf)
            written.append(out_fp)
    return written
