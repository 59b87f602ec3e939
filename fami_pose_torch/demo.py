"""Video frames + person boxes -> keypoints, on the port.

    python -m fami_pose_torch.demo --cfg configs/posetrack17/fami_pose.yaml \\
        --frames /path/to/frames_dir --boxes boxes.json \\
        --weights fami_pose_state_dict.pt --out demo_out [--device cuda]

The flags are those of ``tools/demo.py`` plus ``--weights`` (a port
``state_dict`` saved with ``torch.save``; without it the weights are the
seeded random init) and ``--device``. ``--boxes`` is a json list of
``{"frame": <index-or-filename>, "bbox": [x, y, w, h], "score": s}``; omit it
for one full-frame box per frame. Writes ``<out>/keypoints.json`` in the
format of ``tools/demo.py``. Flip-test follows ``VAL.FLIP_VAL``'s default of
the demo: off. ``cv2`` is imported only to read the image files.
"""

import argparse
import json
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
                   help="skeleton overlays (not ported yet)")
    p.add_argument("--streaming", action="store_true",
                   help="cached-feature streaming serving (not ported yet)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag, item in (("checkpoint", "convert it with models.bridge and "
                        "pass --weights"),
                       ("vis", "ROADMAP Queue 1 item 12"),
                       ("streaming", "ROADMAP Queue 1 item 9")):
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not supported by the port yet: {item}")
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
    predictor = PosePredictor(cfg, state_dict, device=args.device)
    results = predictor(np.stack(frames), boxes_by_frame, frame_names=names)
    os.makedirs(args.out, exist_ok=True)
    out_json = osp.join(args.out, "keypoints.json")
    with open(out_json, "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} poses to {out_json}")


if __name__ == "__main__":
    main()
