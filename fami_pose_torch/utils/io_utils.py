"""Small IO helpers (reference ``utils/utils_json.py`` / ``utils_folder.py``
/ ``utils_image.py`` / natural sort surface); a copy of
``fami_pose_tpu/utils/io_utils.py``."""

import json
import os
import re
from typing import List


def read_json_from_file(path: str):
    with open(path, "r") as f:
        return json.load(f)


def write_json_to_file(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def create_folder(path: str):
    os.makedirs(path, exist_ok=True)


def list_immediate_childfile_paths(folder: str, ext=None) -> List[str]:
    names = sorted(os.listdir(folder))
    if ext is not None:
        exts = (ext,) if isinstance(ext, str) else tuple(ext)
        names = [n for n in names if n.endswith(exts)]
    return [os.path.join(folder, n) for n in names]


def natural_sort(items: List[str]) -> List[str]:
    """Sort strings with embedded numbers numerically ('f2' < 'f10')."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(items, key=key)


def read_image(path: str):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        raise IOError(f"Fail to read {path}")
    return img


def save_image(path: str, img):
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, img)
