"""Config system: ``get_cfg(args)`` / ``update_config(cfg, args)``.

A copy of ``fami_pose_tpu/config`` (the port imports nothing of the JAX
package): YAML merge with ``_BASE_`` inheritance, CLI dotted-path overrides
via ``args.opts``, path absolutization against ``args.root_dir``.
"""

import os
import os.path as osp

from .node import CfgNode
from .defaults import get_default_cfg

__all__ = ["CfgNode", "get_default_cfg", "get_cfg", "update_config"]

# config keys whose values are filesystem paths to absolutize against root_dir
_PATH_KEYS = [
    ("OUTPUT_DIR",),
    ("LOG_DIR",),
    ("DATA_DIR",),
    ("MODEL_DIR",),
    ("MODEL", "PRETRAINED"),
    ("MODEL", "BACKBONE_PRETRAINED"),
    ("DATASET", "JSON_DIR"),
    ("DATASET", "JSON_FILE"),
    ("DATASET", "IMG_DIR"),
    ("DATASET", "TEST_IMG_DIR"),
    ("DATASET", "POSETRACK17_JSON_DIR"),
    ("DATASET", "POSETRACK18_JSON_DIR"),
    ("DATASET", "POSETRACK17_IMG_DIR"),
    ("DATASET", "POSETRACK18_IMG_DIR"),
    ("DATASET", "POSETRACK17_TEST_IMG_DIR"),
    ("DATASET", "POSETRACK18_TEST_IMG_DIR"),
    ("VAL", "ANNOT_DIR"),
    ("VAL", "COCO_BBOX_FILE"),
    ("VAL", "MODEL_FILE"),
    ("TEST", "ANNOT_DIR"),
    ("TEST", "COCO_BBOX_FILE"),
    ("TEST", "MODEL_FILE"),
    ("INFERENCE", "MODEL_FILE"),
]


def update_config(cfg: CfgNode, args) -> CfgNode:
    cfg.defrost()
    if getattr(args, "cfg", None):
        cfg.merge_from_file(args.cfg)
    opts = getattr(args, "opts", None)
    if opts:
        cfg.merge_from_list(list(opts))

    root_dir = getattr(args, "root_dir", None) or cfg.ROOT_DIR or "."
    root_dir = osp.abspath(root_dir)
    cfg.ROOT_DIR = root_dir
    for key_path in _PATH_KEYS:
        node = cfg
        for k in key_path[:-1]:
            node = node[k]
        leaf = key_path[-1]
        val = node.get(leaf, "")
        if val and not osp.isabs(val):
            node[leaf] = osp.abspath(osp.join(root_dir, val))
    return cfg


def get_cfg(args=None) -> CfgNode:
    """Build a config from defaults, then (optionally) merge args."""
    cfg = get_default_cfg()
    if args is not None:
        cfg = update_config(cfg, args)
    return cfg
