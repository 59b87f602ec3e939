"""Convert PoseTrack17 annolist JSONs <-> PoseTrack18 COCO-style JSONs.

    python -m fami_pose_torch.tools.convert_poseval IN_PATH [--out_fp DIR]

The port of ``tools/convert_poseval.py`` (the vendored poseval converter
CLI, ``poseval/py/convert.py:538-583``, with argparse instead of click and
no zip staging: point it at a directory or a single file), over the port's
``evaluation/convert.py::convert_dir``. Writes one file per video.
"""

import argparse
import logging

from fami_pose_torch.evaluation.convert import convert_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Convert PoseTrack17 <-> PoseTrack18 annotation JSONs")
    p.add_argument("in_fp", help="input .json file or directory of them")
    p.add_argument(
        "--out_fp", default="converted",
        help="output directory (created if missing); one file per video",
    )
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    written = convert_dir(args.in_fp, args.out_fp)
    print(f"wrote {len(written)} file(s) -> {args.out_fp}")
    return written


if __name__ == "__main__":
    main()
