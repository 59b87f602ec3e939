"""PoseTrack 2017/2018 video dataset.

Re-design of ``datasets/zoo/posetrack/PoseTrack_Alignment.py`` (1073 LoC) with
the same data contract:

  * **Index**: COCO-style ``posetrack_train.json`` / ``posetrack_val.json``
    in ``DATASET.JSON_DIR``; GT keypoint entries with bbox sanitization +
    ``box2cs`` for train / ``USE_GT_BBOX`` (``:656-733``), or precomputed
    detector boxes filtered by ``IMAGE_THRE`` for eval (``:830-881``).
  * **Temporal window**: sup-frame deltas from ``DISTANCE`` with the
    reference's exact boundary padding (key-frame duplicates, ``:311-359``);
    filename zero-fill 6 => PoseTrack18, 8 => PoseTrack17 (``:302-309``).
  * **Augmentation** (train): half-body crop, scale jitter
    ``clip(randn*sf+1, 1-sf, 1+sf)``, rotation ``clip(randn*rf, +/-2rf)`` with
    p=0.6, horizontal flip p=0.5 — ONE draw shared by every frame of the clip
    (``:386-423``).
  * **Crop**: DARK-convention affine warp to ``MODEL.IMAGE_SIZE``; joints
    warped with the same matrix; out-of-bounds joints zeroed (``:416-440``).

A copy of ``fami_pose_tpu/data/posetrack.py`` (host numpy and cv2 only).
Host/device split: ``__getitem__`` does jpeg decode + augmentation draw +
cv2 crop-warp and returns uint8 crops; normalization and Gaussian target
generation run batched on the device (``data.loader.prepare_train_batch``,
``ops.heatmap.generate_heatmaps``). The reference's per-sample normalize +
per-joint numpy stamping was HOT LOOP #1.

Dropped warts: the hardcoded ``clustering`` debug path with absolute
``/media/...`` output (``:27,91-96``).
"""

import logging
import os
import os.path as osp
from collections import defaultdict
from typing import Dict, List, Tuple

import cv2
import numpy as np

from fami_pose_torch.utils.bbox import box2cs
from fami_pose_torch.utils.registry import DATASET_REGISTRY, VAL_PHASE
from fami_pose_torch.ops.affine import dark_get_affine_transform, exec_affine_transform
from fami_pose_torch.ops.pose import fliplr_joints, half_body_transform

from .video_dataset import VideoDataset

POSETRACK_FLIP_PAIRS = [[3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]
POSETRACK_JOINTS_WEIGHT = np.array(
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.2, 1.2, 1.5, 1.5, 1.0, 1.0, 1.2, 1.2, 1.5, 1.5],
    np.float32,
).reshape((17, 1))
UPPER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)


def support_frame_deltas(
    current_idx: int, nframes: int, distance: int, is_posetrack18: bool
) -> Tuple[List[int], List[int]]:
    """Prev/next frame deltas with boundary padding (``:311-359``).

    Returns (prev_deltas, next_deltas). Prev frames are ``current - d`` in the
    returned order (farthest first); next frames ``current + d``. Padding
    entries are delta 0, i.e. the key frame itself (the reference's
    always-true self-check at ``:324`` makes 0 the only pad value).
    """
    span = distance - 1
    avail_prev = (current_idx + 1) if is_posetrack18 else current_idx
    avail_next = (nframes - current_idx) if is_posetrack18 else (nframes - current_idx + 1)
    prev = list(range(1, min(avail_prev, distance)))
    nxt = list(range(1, min(avail_next, distance)))
    prev = ([0] * (span - len(prev)) + prev)[::-1]
    nxt = nxt + [0] * (span - len(nxt))
    return prev, nxt


def support_frame_paths(image_file_path: str, nframes: int, distance: int):
    """Full sup-frame path list for a key frame path (zero-fill detection)."""
    base = osp.basename(image_file_path)
    stem = base.replace(".jpg", "")
    zero_fill = len(stem)
    is_pt18 = zero_fill == 6
    current_idx = int(stem)
    prev, nxt = support_frame_deltas(current_idx, nframes, distance, is_pt18)
    dirname = osp.dirname(image_file_path)
    paths = []
    for d in prev:
        paths.append(osp.join(dirname, str(current_idx - d).zfill(zero_fill) + ".jpg"))
    for d in nxt:
        paths.append(osp.join(dirname, str(current_idx + d).zfill(zero_fill) + ".jpg"))
    return paths


def read_image(path: str) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        raise IOError(f"Fail to read {path}")
    return img


@DATASET_REGISTRY.register(name="PoseTrack")
class PoseTrackDataset(VideoDataset):
    def __init__(self, cfg, phase: str, **kwargs):
        super().__init__(cfg, phase, **kwargs)
        self.logger = logging.getLogger(__name__)
        self.flip_pairs = POSETRACK_FLIP_PAIRS
        self.joints_weight = POSETRACK_JOINTS_WEIGHT
        self.upper_body_ids = UPPER_BODY_IDS

        self.is_posetrack18 = bool(cfg.DATASET.IS_POSETRACK18)
        self.bbox_enlarge_factor = float(cfg.DATASET.BBOX_ENLARGE_FACTOR)
        self.img_dir = cfg.DATASET.IMG_DIR
        self.json_dir = cfg.DATASET.JSON_DIR

        if not self.is_train:
            self.img_dir = cfg.DATASET.TEST_IMG_DIR or self.img_dir
            sub = cfg.VAL if phase == VAL_PHASE else cfg.TEST
            self.nms_thre = float(sub.NMS_THRE)
            self.image_thre = float(sub.IMAGE_THRE)
            self.soft_nms = bool(sub.SOFT_NMS)
            self.oks_thre = float(sub.OKS_THRE)
            self.in_vis_thre = float(sub.IN_VIS_THRE)
            self.bbox_file = sub.COCO_BBOX_FILE
            self.use_gt_bbox = bool(sub.USE_GT_BBOX)
            self.annotation_dir = sub.ANNOT_DIR

        json_name = "posetrack_train.json" if self.is_train else "posetrack_val.json"
        json_path = kwargs.get("json_path") or osp.join(self.json_dir, json_name)
        from .coco_json import COCOJson

        self.coco = COCOJson(json_path)
        # 'spatiotemporal_window' (default) or 'single_frame' (sup frames are
        # key-frame copies; reference _get_single_frame path, :543-632)
        self.model_input_type = cfg.DATASET.INPUT_TYPE or "spatiotemporal_window"
        # on-device crop mode (TPU.DEVICE_CROP): __getitem__ skips the
        # per-frame cv2.warpAffine and returns a person-centered raw window;
        # the evaluator's batch prep does the crop-warp on the device
        self.device_crop = bool(getattr(cfg.TPU, "DEVICE_CROP", False))
        canvas = getattr(cfg.TPU, "DEVICE_CROP_CANVAS", [768, 768])
        self.device_crop_canvas = (int(canvas[0]), int(canvas[1]))
        self.data = self._list_data()
        self.video_image_index = self._build_video_index(self.data)
        self.show_parameters()

    # -- index ---------------------------------------------------------------

    def _build_video_index(self, data):
        video_image_index: Dict[str, Dict[int, List[int]]] = {}
        for item_index, item in enumerate(data):
            vid = item["video_name"]
            video_image_index.setdefault(vid, defaultdict(list))[
                item["frame_id"]
            ].append(item_index)
        return video_image_index

    def _list_data(self):
        if self.is_train or getattr(self, "use_gt_bbox", True):
            return self._load_gt_annotations()
        return self._load_detection_results()

    def _load_gt_annotations(self):
        db = []
        for img_id in self.coco.getImgIds():
            im = self.coco.loadImgs(img_id)[0]
            width, height = im["width"], im["height"]
            file_name = im["file_name"]
            nframes = int(im["nframes"])
            frame_id = int(im["frame_id"])
            ann_ids = self.coco.getAnnIds(imgIds=img_id, iscrowd=False)
            for obj in self.coco.loadAnns(ann_ids):
                if obj.get("category_id", 1) != 1:
                    continue
                x, y, w, h = obj["bbox"]
                x1, y1 = max(0, x), max(0, y)
                x2 = min(width - 1, x1 + max(0, w - 1))
                y2 = min(height - 1, y1 + max(0, h - 1))
                if obj.get("area", w * h) <= 0 or x2 < x1 or y2 < y1:
                    continue
                clean_bbox = [x1, y1, x2 - x1, y2 - y1]
                kpts = obj.get("keypoints", [])
                if not kpts or max(kpts) == 0:
                    continue
                joints = np.zeros((self.num_joints, 3), np.float32)
                joints_vis = np.zeros((self.num_joints, 3), np.float32)
                for j in range(self.num_joints):
                    joints[j, 0] = kpts[j * 3 + 0]
                    joints[j, 1] = kpts[j * 3 + 1]
                    vis = min(1.0, float(kpts[j * 3 + 2]))
                    joints_vis[j, :2] = vis
                center, scale = box2cs(
                    clean_bbox, self.aspect_ratio, self.bbox_enlarge_factor
                )
                db.append(
                    {
                        "image": osp.join(self.img_dir, file_name),
                        "center": np.asarray(center, np.float32),
                        "scale": np.asarray(scale, np.float32),
                        "box": clean_bbox,
                        "joints_3d": joints,
                        "joints_3d_vis": joints_vis,
                        "score": 1.0,
                        "nframes": nframes,
                        "frame_id": frame_id,
                        "video_name": "/".join(file_name.split("/")[:-1]),
                    }
                )
        return db

    def _load_detection_results(self):
        import json

        with open(self.bbox_file) as f:
            all_boxes = json.load(f)
        db = []
        for det in all_boxes:
            if det.get("category_id", 1) != 1:
                continue
            if det["score"] < self.image_thre:
                continue
            center, scale = box2cs(
                det["bbox"], self.aspect_ratio, self.bbox_enlarge_factor
            )
            db.append(
                {
                    "image": osp.join(self.img_dir, det["image_name"]),
                    "center": np.asarray(center, np.float32),
                    "scale": np.asarray(scale, np.float32),
                    "box": det["bbox"],
                    "joints_3d": np.zeros((self.num_joints, 3), np.float32),
                    "joints_3d_vis": np.ones((self.num_joints, 3), np.float32),
                    "score": float(det["score"]),
                    "nframes": int(det["nframes"]),
                    "frame_id": int(det["frame_id"]),
                    "video_name": "/".join(det["image_name"].split("/")[:-1]),
                }
            )
        self.logger.info(
            f"detections: {len(all_boxes)} boxes -> {len(db)} after "
            f"score >= {self.image_thre}"
        )
        return db

    # -- sample --------------------------------------------------------------

    def __getitem__(self, idx: int):
        item = self.data[idx]
        rng = np.random
        image_path = item["image"]
        key_img = read_image(image_path)
        if self.color_rgb:
            key_img = cv2.cvtColor(key_img, cv2.COLOR_BGR2RGB)

        if self.model_input_type == "single_frame":
            sup_paths = [image_path] * self.num_sup
        elif self.model_input_type == "single_ref_frame":
            # one randomly-sampled aux frame (train) / nearest next (eval);
            # reference _get_single_ref path (:128-291, RANDOM_AUX_FRAME)
            sup_paths = [
                self._sample_ref_path(image_path, item["nframes"])
                for _ in range(max(1, self.num_sup))
            ]
        else:
            sup_paths = support_frame_paths(
                image_path, item["nframes"], self.distance
            )
        sup_imgs = []
        for p in sup_paths:
            im = read_image(p)
            if self.color_rgb:
                im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
            sup_imgs.append(im)

        joints = item["joints_3d"].copy()
        joints_vis = item["joints_3d_vis"].copy()
        center = np.asarray(item["center"], np.float32).copy()
        scale = np.asarray(item["scale"], np.float32).copy()
        score = float(item.get("score", 1.0))
        r = 0.0

        if self.is_train:
            if (
                np.sum(joints_vis[:, 0]) > self.num_joints_half_body
                and rng.rand() < self.prob_half_body
            ):
                c_half, s_half = half_body_transform(
                    joints, joints_vis, self.num_joints, self.upper_body_ids,
                    self.aspect_ratio, self.pixel_std,
                )
                if c_half is not None:
                    center, scale = c_half, s_half

            sf = self.scale_factor
            if isinstance(sf, (list, tuple)):
                sf = sf[0]
            scale = scale * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            rf = self.rotation_factor
            r = (
                float(np.clip(rng.randn() * rf, -rf * 2, rf * 2))
                if rng.rand() <= 0.6
                else 0.0
            )
            if self.flip and rng.rand() <= 0.5:
                key_img = key_img[:, ::-1, :]
                sup_imgs = [im[:, ::-1, :] for im in sup_imgs]
                joints, joints_vis = fliplr_joints(
                    joints, joints_vis, key_img.shape[1], self.flip_pairs
                )
                center[0] = key_img.shape[1] - center[0] - 1

        trans = dark_get_affine_transform(center, scale, r, self.image_size)
        out_wh = (int(self.image_size[0]), int(self.image_size[1]))
        if self.device_crop:
            # raw person-centered window; the crop-warp runs on device
            # (ops.warp.crop_and_warp, data.loader.prepare_eval_inputs_device_crop)
            self._check_device_crop_extent(scale, r)
            kf, origin = self._extract_window(key_img, center)
            sups = [self._extract_window(im, center)[0] for im in sup_imgs]
            crop_center = center - origin
        else:
            kf = cv2.warpAffine(key_img, trans, out_wh, flags=cv2.INTER_LINEAR)
            sups = [
                cv2.warpAffine(im, trans, out_wh, flags=cv2.INTER_LINEAR)
                for im in sup_imgs
            ]
            crop_center = center

        for j in range(self.num_joints):
            if joints_vis[j, 0] > 0:
                joints[j, :2] = exec_affine_transform(joints[j, :2], trans)
        for j, (x, y, _) in enumerate(joints):
            if x < 0 or y < 0 or x > self.image_size[0] or y > self.image_size[1]:
                joints_vis[j] = 0

        sample = {
            "kf": np.ascontiguousarray(kf),  # (H, W, 3) uint8
            "sup": np.ascontiguousarray(np.concatenate(sups, axis=-1)),  # (H, W, 3N)
            "joints": joints[:, :2].astype(np.float32),
            "joints_vis": joints_vis[:, 0].astype(np.float32),
            "center": center.astype(np.float32),
            "scale": scale.astype(np.float32),
            "rotation": np.float32(r),
            "score": np.float32(score),
            "image_path": image_path,
            "sup_paths": sup_paths,
        }
        if self.device_crop:
            sample["crop_center"] = crop_center.astype(np.float32)
        return sample

    def _check_device_crop_extent(self, scale, rotation):
        """Warn (once) when the crop-warp's source footprint exceeds the
        ``device_crop_canvas`` window: the host cv2 path would sample real
        pixels there, the device path substitutes zeros (a silent train/eval
        divergence otherwise)."""
        if getattr(self, "_device_crop_warned", False):
            return
        w_src = float(scale[0]) * self.pixel_std
        h_src = float(scale[1]) * self.pixel_std
        rad = abs(float(rotation)) * np.pi / 180.0
        ext_w = w_src * np.cos(rad) + h_src * np.sin(rad)
        ext_h = w_src * np.sin(rad) + h_src * np.cos(rad)
        ch, cw = self.device_crop_canvas
        if ext_w > cw or ext_h > ch:
            self._device_crop_warned = True
            logging.getLogger(__name__).warning(
                "TPU.DEVICE_CROP: person box source extent (%.0fx%.0f px, "
                "rotation %.0f deg) exceeds DEVICE_CROP_CANVAS (%dx%d); "
                "out-of-window pixels are zero-filled where the host cv2 "
                "path samples real pixels. Raise TPU.DEVICE_CROP_CANVAS to "
                "cover the largest augmented box.",
                ext_w, ext_h, float(rotation), cw, ch,
            )

    def _extract_window(self, img, center):
        """Paste the ``device_crop_canvas`` window centered at ``center`` into
        a zero canvas; returns (window_u8, origin_xy). Out-of-image regions
        are zero — the same values cv2.warpAffine's border would produce."""
        ch, cw = self.device_crop_canvas
        ih, iw = img.shape[:2]
        ox = int(round(float(center[0]))) - cw // 2
        oy = int(round(float(center[1]))) - ch // 2
        out = np.zeros((ch, cw, img.shape[2]), img.dtype)
        sy0, sy1 = max(0, oy), min(ih, oy + ch)
        sx0, sx1 = max(0, ox), min(iw, ox + cw)
        if sy1 > sy0 and sx1 > sx0:
            out[sy0 - oy : sy1 - oy, sx0 - ox : sx1 - ox] = img[sy0:sy1, sx0:sx1]
        return out, np.asarray([ox, oy], np.float32)

    def _sample_ref_path(self, image_path: str, nframes: int) -> str:
        base = osp.basename(image_path)
        stem = base.replace(".jpg", "")
        zero_fill = len(stem)
        is_pt18 = zero_fill == 6
        cur = int(stem)
        lo = 0 if is_pt18 else 1
        hi = nframes - 1 if is_pt18 else nframes
        if self.is_train and bool(self.cfg.DATASET.RANDOM_AUX_FRAME):
            delta = int(np.random.randint(1, max(2, self.distance)))
            sign = 1 if np.random.rand() < 0.5 else -1
            tgt = int(np.clip(cur + sign * delta, lo, hi))
        else:
            tgt = min(cur + 1, hi)
        return osp.join(
            osp.dirname(image_path), str(tgt).zfill(zero_fill) + ".jpg"
        )

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, cfg, preds, output_dir, boxes, img_path_map, **kwargs):
        """Official PoseTrack AP via the poseval-equivalent protocol.

        Mirrors ``PoseTrack_Alignment.evaluate`` (``:883-1037``): regroup the
        flat prediction array by video, write per-video annolist JSONs named
        after the GT files (empty frames get the dummy detection), run the
        AP evaluation against ``annotation_dir``, and return the grouped
        (Head..Ankle, Mean) OrderedDict.

        Args:
          preds: (N, 17, 3) array — x, y, maxval in original image coords.
          boxes: (N, 6) array — center(2), scale(2), area, score.
          img_path_map: OrderedDict image path -> list of pred indices.
        """
        import json
        from collections import OrderedDict

        from fami_pose_torch.evaluation import (
            convert_data_to_annorect_struct,
        )
        from fami_pose_torch.evaluation.evaluate import evaluate as run_eval
        from fami_pose_torch.evaluation.poseval_data import video2filenames

        os.makedirs(output_dir, exist_ok=True)
        annot_dir = self.annotation_dir
        out_fnames, vid_len = video2filenames(annot_dir)

        zero_fill = 6 if self.is_posetrack18 else 8
        start = 0 if self.is_posetrack18 else 1

        # group predictions by video / frame number
        by_video: Dict[str, Dict[int, Tuple[str, list, list]]] = {}
        for key, idx_list in img_path_map.items():
            parts = key.split("/")
            video = "/".join(parts[-3:-1])
            img_sfx = "/".join(parts[-3:])
            frame_num = int(parts[-1].replace(".jpg", ""))
            poses, box_list = [], []
            for idx in idx_list:
                pose = np.zeros((4, 17))
                pose[0] = preds[idx, :, 0]
                pose[1] = preds[idx, :, 1]
                pose[2] = preds[idx, :, 2]
                pose[3] = preds[idx, :, 2]
                poses.append(pose)
                box = np.zeros((1, 6))
                box[0] = boxes[idx]
                box_list.append(box)
            by_video.setdefault(video, {})[frame_num] = (img_sfx, poses, box_list)

        for video, frames in by_video.items():
            n = vid_len.get("images/" + video) or vid_len.get(video)
            if n is None:
                n = max(frames.keys()) - start + 1
            annolist = []
            for frame_num in range(start, start + n):
                if frame_num in frames:
                    img_sfx, poses, box_list = frames[frame_num]
                    tracks = list(range(len(poses)))
                else:
                    img_sfx = "/".join(
                        [video, str(frame_num).zfill(zero_fill) + ".jpg"]
                    )
                    poses, box_list, tracks = [], [], []
                annolist.append(
                    {
                        "image": {"name": img_sfx},
                        "imgnum": [frame_num],
                        "annorect": convert_data_to_annorect_struct(
                            poses, tracks, box_list
                        ),
                    }
                )
            fname = out_fnames.get("images/" + video) or out_fnames.get(
                video, video.split("/")[-1] + ".json"
            )
            with open(osp.join(output_dir, fname), "w") as f:
                json.dump({"annolist": annolist}, f)

        eval_track = bool(kwargs.get("eval_track", False))
        result = run_eval(
            annot_dir, output_dir, eval_pose=True, eval_track=eval_track
        )
        table = result["ap_table"]
        name_value = OrderedDict(
            [
                ("Head", table["Head"]),
                ("Shoulder", table["Shou"]),
                ("Elbow", table["Elb"]),
                ("Wrist", table["Wri"]),
                ("Hip", table["Hip"]),
                ("Knee", table["Knee"]),
                ("Ankle", table["Ankl"]),
                ("Mean", table["Mean"]),
            ]
        )
        if eval_track:
            # surface the MOTA table alongside AP (the reference's
            # evaluate_simple computes it when eval_track is on; its
            # PredsAccPrinter shows AP only, so these extra keys are
            # additive and absent in the default eval_track=False path)
            mota = result["mota_table"]
            for key, col in [
                ("MOTA_Head", "Head"), ("MOTA_Shoulder", "Shou"),
                ("MOTA_Elbow", "Elb"), ("MOTA_Wrist", "Wri"),
                ("MOTA_Hip", "Hip"), ("MOTA_Knee", "Knee"),
                ("MOTA_Ankle", "Ankl"), ("MOTA_Mean", "Mean"),
            ]:
                name_value[key] = mota[col]
        return name_value, name_value["Mean"]
