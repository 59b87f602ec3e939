"""A synthetic PoseTrack-style dataset that a model can overfit: a few tiny
videos, a COCO-style json and poseval GT annolists, written from a seed.

:func:`make_posetrack_fixture` is the port's copy of the JAX repository's
test fixture (``tests/fixtures.py::make_posetrack_fixture``) with every
argument and the same random stream, so that the same seed and arguments
write the same jpeg and json bytes: a trained checkpoint's fixture is
regenerated from its seed and flags alone (``tools/sustained_train.py``,
``tools/ab_dcn_bound.py``, ``tools/int8_numerics.py --ckpt``).
:func:`make_cfg` is the same copy of its config (``fixtures.make_cfg``) on
the port's config tree, and :func:`write_gt_annolists` writes the GT
annolists that the poseval protocol reads (``VAL.ANNOT_DIR``), one per
video, from the fixture's COCO-17 keypoints.
"""

import json
import os
import os.path as osp

import cv2
import numpy as np

IMG_W, IMG_H = 128, 96


def _person(rng, cx, cy):
    """17 COCO keypoints around a center, all visible."""
    base = np.array([cx, cy], np.float32)
    offs = rng.uniform(-18, 18, size=(17, 2)).astype(np.float32)
    pts = base + offs
    pts[:, 0] = np.clip(pts[:, 0], 2, IMG_W - 3)
    pts[:, 1] = np.clip(pts[:, 1], 2, IMG_H - 3)
    return pts


def make_posetrack_fixture(
    root, n_videos=2, n_frames=5, people_per_frame=2, posetrack18=False,
    seed=0, draw_joints=False, motion=None, occlude=0.0,
):
    """Write images + a COCO-style json; returns ``(json_path, img_dir)``.

    PT18 naming: 6-digit frames starting at 0; PT17: 8-digit starting at 1.

    ``draw_joints`` paints a disc of a colour of its own at every keypoint,
    so that the image-to-pose mapping is learnable from local features.

    ``motion``: None keeps each person's center fixed across frames with
    i.i.d. keypoint jitter a frame (its random stream is the one trained
    checkpoints were made on); ``"drift"`` gives each person a rigid pose
    translating at a constant velocity of 6-10 px a frame, one background a
    video; ``"articulated"`` adds to it a constant velocity of its own to
    every joint (±6 px a frame), non-rigid motion that the global
    translation warp cannot absorb, so that recovering an occluded key
    frame takes deformable offsets.

    ``occlude``: the probability, per person and frame, that the joint
    markers are not drawn (with ``draw_joints``); the annotations keep the
    true keypoints, so an occluded key frame's pose must come from its
    supporting frames.
    """
    rng = np.random.RandomState(seed)
    img_dir = osp.join(root, "images")
    zero_fill = 6 if posetrack18 else 8
    start = 0 if posetrack18 else 1

    images, annotations = [], []
    img_id, ann_id = 0, 0
    for v in range(n_videos):
        vid_name = f"video_{v:04d}"
        vdir = osp.join(img_dir, vid_name)
        os.makedirs(vdir, exist_ok=True)
        centers0 = rng.uniform([30, 30], [IMG_W - 30, IMG_H - 30],
                               size=(people_per_frame, 2))
        if motion in ("drift", "articulated"):
            # drawn after the centers, so that motion=None's stream is the
            # same as without motion models
            ang = rng.uniform(0, 2 * np.pi, size=people_per_frame)
            speed = rng.uniform(6.0, 10.0, size=people_per_frame)
            vel = np.stack([np.cos(ang), np.sin(ang)], -1) * speed[:, None]
            rigid_offs = rng.uniform(
                -18, 18, size=(people_per_frame, 17, 2)
            ).astype(np.float32)
            joint_vel = (
                rng.uniform(-6.0, 6.0, size=(people_per_frame, 17, 2))
                .astype(np.float32)
                if motion == "articulated"
                else np.zeros((people_per_frame, 17, 2), np.float32)
            )
            # one background a video: a background of its own a frame would
            # name the frame, and an overfit model could memorize occluded
            # key frames' poses instead of aligning supporting frames
            video_bg = rng.randint(0, 255, (IMG_H, IMG_W, 3), np.uint8)
        elif motion is not None:
            raise ValueError(f"unknown motion model {motion!r}")
        moving = motion in ("drift", "articulated")
        for f in range(n_frames):
            if moving:
                centers = np.clip(
                    centers0 + f * vel, [24, 24], [IMG_W - 24, IMG_H - 24]
                )
            else:
                centers = centers0
            frame_idx = start + f
            fname = f"{str(frame_idx).zfill(zero_fill)}.jpg"
            img = (
                video_bg.copy() if moving
                else rng.randint(0, 255, (IMG_H, IMG_W, 3), np.uint8)
            )
            if moving:
                frame_pts = []
                for p in range(people_per_frame):
                    pts = (
                        centers[p].astype(np.float32) + rigid_offs[p]
                        + f * joint_vel[p]
                    )
                    pts[:, 0] = np.clip(pts[:, 0], 2, IMG_W - 3)
                    pts[:, 1] = np.clip(pts[:, 1], 2, IMG_H - 3)
                    frame_pts.append(pts)
            else:
                frame_pts = [_person(rng, *centers[p])
                             for p in range(people_per_frame)]
            if draw_joints:
                for pts in frame_pts:
                    if occlude > 0.0 and rng.rand() < occlude:
                        continue  # markers hidden this frame, GT kept
                    for j, (x, y) in enumerate(pts):
                        color = (
                            int(40 + 12 * j), int(255 - 12 * j),
                            int(128 + 7 * j) % 256,
                        )
                        cv2.circle(
                            img, (int(round(x)), int(round(y))), 3, color, -1
                        )
            cv2.imwrite(osp.join(vdir, fname), img)
            img_id += 1
            images.append(
                {
                    "id": img_id,
                    "file_name": f"{vid_name}/{fname}",
                    "width": IMG_W,
                    "height": IMG_H,
                    "nframes": n_frames,
                    "frame_id": frame_idx,
                    "vid_id": vid_name,
                    "is_labeled": True,
                }
            )
            for p in range(people_per_frame):
                pts = frame_pts[p]
                kps = []
                for x, y in pts:
                    kps += [float(x), float(y), 1]
                x0, y0 = pts.min(0) - 4
                x1, y1 = pts.max(0) + 4
                ann_id += 1
                annotations.append(
                    {
                        "id": ann_id,
                        "image_id": img_id,
                        "category_id": 1,
                        "bbox": [float(x0), float(y0), float(x1 - x0),
                                 float(y1 - y0)],
                        "area": float((x1 - x0) * (y1 - y0)),
                        "iscrowd": 0,
                        "keypoints": kps,
                        "track_id": p,
                        "bbox_head": [float(x0), float(y0), 20.0, 20.0],
                        "scores": [],
                    }
                )

    dataset = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": 1, "name": "person"}],
    }
    os.makedirs(osp.join(root, "json"), exist_ok=True)
    json_path = osp.join(root, "json", "posetrack_train.json")
    with open(json_path, "w") as fh:
        json.dump(dataset, fh)
    # the same content serves as the val index
    val_path = osp.join(root, "json", "posetrack_val.json")
    with open(val_path, "w") as fh:
        json.dump(dataset, fh)
    return json_path, img_dir


def make_cfg(json_dir, img_dir, posetrack18=False, distance=3):
    """A port config reading the fixture: 17 joints, a 96x128 crop, GT
    boxes, one loader thread."""
    from fami_pose_torch.config import get_cfg

    cfg = get_cfg()
    cfg.DISTANCE = distance
    cfg.MODEL.NUM_JOINTS = 17
    cfg.MODEL.IMAGE_SIZE = [96, 128]  # (w, h): divisible by 32 at 1/4
    cfg.MODEL.HEATMAP_SIZE = [24, 32]
    cfg.MODEL.SIGMA = 2
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.IS_POSETRACK18 = posetrack18
    cfg.DATASET.COLOR_RGB = True
    cfg.DATASET.BBOX_ENLARGE_FACTOR = 1.25
    cfg.TRAIN.PROB_HALF_BODY = 0.0
    cfg.VAL.USE_GT_BBOX = True
    cfg.WORKERS = 1
    return cfg


def write_gt_annolists(root):
    """GT annolists ``<root>/gt_annolist/<video>.json`` of the fixture under
    ``root`` (its ``json/posetrack_val.json``): each person's COCO-17
    keypoints in the 15-landmark PoseTrack order, its head box and track
    id. Returns the directory, for ``VAL.ANNOT_DIR``."""
    from fami_pose_torch.data.keypoints import coco2posetrack_ord_infer

    with open(osp.join(root, "json", "posetrack_val.json")) as f:
        data = json.load(f)
    anns = {}
    for ann in data["annotations"]:
        anns.setdefault(ann["image_id"], []).append(ann)
    annot_dir = osp.join(root, "gt_annolist")
    os.makedirs(annot_dir, exist_ok=True)
    by_video = {}
    for im in sorted(data["images"], key=lambda i: i["id"]):
        rects = []
        for ann in anns.get(im["id"], []):
            kps = np.array(ann["keypoints"], np.float64).reshape(17, 3)
            pts = [
                {"id": [j], "x": [float(x)], "y": [float(y)]}
                for j, (x, y, _) in enumerate(coco2posetrack_ord_infer(kps))
            ]
            bx, by, bw, bh = ann["bbox_head"]
            rects.append(
                {
                    "x1": [bx], "y1": [by], "x2": [bx + bw], "y2": [by + bh],
                    "track_id": [ann["track_id"]], "score": [1.0],
                    "annopoints": [{"point": pts}],
                }
            )
        by_video.setdefault(osp.dirname(im["file_name"]), []).append(
            {"image": [{"name": "images/" + im["file_name"]}],
             "annorect": rects}
        )
    for video, frames in by_video.items():
        with open(osp.join(annot_dir, osp.basename(video) + ".json"),
                  "w") as f:
            json.dump({"annolist": frames}, f)
    return annot_dir
