"""Video frames + person boxes -> keypoints, on the port.

    python -m fami_pose_torch.demo --cfg configs/posetrack17/fami_pose.yaml \\
        --frames /path/to/frames_dir --boxes boxes.json \\
        --weights fami_pose_state_dict.pt --out demo_out [--device cuda] \\
        [--streaming] [--vis]

The flags are those of ``tools/demo.py`` plus ``--weights`` (a port
``state_dict`` saved with ``torch.save``; without it the weights are the
seeded random init) and ``--device``. ``--boxes`` is a json list of
``{"frame": <index-or-filename>, "bbox": [x, y, w, h], "score": s}``; omit it
for one full-frame box per frame. Writes ``<out>/keypoints.json`` in the
format of ``tools/demo.py``. Flip-test follows ``VAL.FLIP_VAL``'s default of
the demo: off. ``--vis`` draws each emitted pose onto its source frame
under ``<out>/vis/<frames dir name>/<frame>`` (``visualization/draw.py``,
as ``tools/demo.py`` does, for both serving paths; poses of one frame draw
over the same file, the last one standing).

Without ``--streaming`` every box of every frame runs the batch protocol
(``engine/predictor.py``: the key frame and its supporting frames cropped
with the box and run through the whole model). ``--streaming`` serves the
clip with the cached-feature stream (``engine/streaming.py``): the backbone
runs once a frame and the alignment head reads the rolling feature buffer.
Crops are locked at the first annotated frame's boxes, one stream per box
(a warning says so when later boxes differ), each frame is cropped with
``cv2.warpAffine`` and normalised as the model's inputs, and ``DISTANCE -
1`` extra copies of the last frame are fed so that the tail key frames see
the clamp-to-last neighbours of the batch protocol.

A config with ``TPU.INT8_EVAL`` is refused with ``NotImplementedError``
(``engine/predictor.py::serving_model``): int8 needs a calibration pass
over data, which the demo does not have, as ``tools/demo.py`` has none.
"""

import argparse
import json
import logging
import os
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--frames", required=True, help="directory of ordered frames")
    p.add_argument("--boxes", default="", help="per-frame person boxes json")
    p.add_argument("--checkpoint", default="",
                   help="JAX checkpoint: not readable by the port, use --weights")
    p.add_argument("--weights", default="", help="port state_dict (torch.save)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="demo_out")
    p.add_argument("--vis", action="store_true",
                   help="skeleton overlays under <out>/vis")
    p.add_argument("--streaming", action="store_true",
                   help="cached-feature streaming serving (crops locked at "
                   "the first annotated frame's boxes; see the docstring)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.checkpoint:
        raise SystemExit("--checkpoint is not supported by the port: convert "
                         "it with models.bridge and pass --weights")
    args.root_dir = "."

    import cv2
    import numpy as np
    import torch

    from fami_pose_torch.config import get_cfg
    from fami_pose_torch.engine.predictor import PosePredictor

    cfg = get_cfg(args)
    names = sorted(
        f for f in os.listdir(args.frames)
        if f.lower().endswith((".jpg", ".png", ".jpeg"))
    )
    if not names:
        raise SystemExit(f"no frames in {args.frames}")
    frames = [
        cv2.cvtColor(cv2.imread(osp.join(args.frames, n)), cv2.COLOR_BGR2RGB)
        for n in names
    ]
    boxes_by_frame = None
    if args.boxes:
        boxes_by_frame = {}
        with open(args.boxes) as f:
            for det in json.load(f):
                key = det["frame"]
                idx = key if isinstance(key, int) else names.index(osp.basename(key))
                boxes_by_frame.setdefault(idx, []).append(
                    (det["bbox"], det.get("score", 1.0))
                )
    state_dict = (
        torch.load(args.weights, map_location="cpu") if args.weights else None
    )
    if args.streaming:
        results = stream_clip(cfg, state_dict, args.device, frames,
                              boxes_by_frame, names)
    else:
        predictor = PosePredictor(cfg, state_dict, device=args.device)
        results = predictor(np.stack(frames), boxes_by_frame,
                            frame_names=names)
    os.makedirs(args.out, exist_ok=True)
    out_json = osp.join(args.out, "keypoints.json")
    with open(out_json, "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} poses to {out_json}"
          + (" (streaming)" if args.streaming else ""))
    if args.vis:
        draw_results(results, args.frames, osp.join(args.out, "vis"))
        print(f"drew {len(results)} overlays under "
              f"{osp.join(args.out, 'vis')}")


def draw_results(results, frames_dir, out_dir):
    """Each record's pose drawn onto its source frame under ``out_dir``
    (``tools/demo.py``'s ``--vis``)."""
    import numpy as np

    from fami_pose_torch.visualization import draw_skeleton_in_origin_image

    for r in results:
        draw_skeleton_in_origin_image(
            osp.join(frames_dir, r["frame"]),
            np.asarray(r["keypoints"], np.float32), out_dir)


def stream_clip(cfg, state_dict, device, frames, boxes_by_frame, names):
    """The records of every key frame of the clip served by one stream per
    box of the first annotated frame, crops locked (``tools/demo.py``'s
    streaming branch)."""
    import cv2
    import numpy as np
    import torch

    from fami_pose_torch.data.loader import normalize
    from fami_pose_torch.engine.predictor import serving_model
    from fami_pose_torch.engine.streaming import StreamingPosePredictor
    from fami_pose_torch.ops.affine import dark_get_affine_transform
    from fami_pose_torch.ops.heatmap import get_final_preds
    from fami_pose_torch.utils.bbox import box2cs

    img_w, img_h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    span = int(cfg.DISTANCE) - 1
    if boxes_by_frame is None:
        h0, w0 = frames[0].shape[:2]
        boxes_by_frame = {i: [([0, 0, w0, h0], 1.0)]
                          for i in range(len(frames))}
    first_fi = min(boxes_by_frame)
    tracks = boxes_by_frame[first_fi]
    if any(v != tracks for v in boxes_by_frame.values()):
        logging.warning("--streaming locks crops at frame %d's boxes; later "
                        "box changes are ignored", first_fi)
    cs = [box2cs(bbox, img_w / img_h, float(cfg.DATASET.BBOX_ENLARGE_FACTOR))
          for bbox, _ in tracks]
    transes = [dark_get_affine_transform(c, s, 0, (img_w, img_h))
               for c, s in cs]
    device = torch.device(device)
    centers = torch.as_tensor(np.stack([c for c, _ in cs]), device=device)
    scales = torch.as_tensor(np.stack([s for _, s in cs]), device=device)

    def crop_batch(i):
        raw = np.stack([cv2.warpAffine(frames[i], t, (img_w, img_h),
                                       flags=cv2.INTER_LINEAR)
                        for t in transes])
        return normalize(torch.from_numpy(raw).to(device).permute(0, 3, 1, 2))

    predictor = StreamingPosePredictor(
        serving_model(cfg, state_dict, device), distance=span + 1)
    predictor.prime(crop_batch(0))
    n = len(frames)
    records = []
    # feed span extra copies of the last frame so that the tail key frames
    # see the clamp-to-last neighbours of the batch protocol
    for t in range(n + span):
        hm, _ = predictor(crop_batch(min(t, n - 1)))
        key_t = t - span
        if key_t < 0:
            continue
        preds, maxvals = get_final_preds(hm, centers, scales)
        pose = torch.cat([preds, maxvals], dim=-1).cpu().numpy()
        for (bbox, score), p in zip(tracks, pose):
            records.append({
                "frame": names[key_t],
                "bbox": [float(v) for v in bbox],
                "bbox_score": float(score),
                "keypoints": p.tolist(),
            })
    return records


if __name__ == "__main__":
    main()
