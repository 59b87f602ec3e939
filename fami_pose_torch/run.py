"""CLI entry point of the port, the counterpart of ``tools/run.py``.

    python -m fami_pose_torch.run --cfg configs/posetrack17/fami_pose.yaml \\
        --train --val [--test] [--val_from_checkpoint N] [--device cuda] \\
        [KEY VALUE ...]

Phases run in the order train -> val -> test on ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions). ``--val`` scores the
latest checkpoint of the experiment's directory (``VAL.MODEL_FILE`` or
``--val_from_checkpoint`` choose otherwise) and logs the AP tables of the
final and the backbone heatmaps.

Over N processes, one a GPU (``TPU.MESH_SHAPE [-1, 1]`` spans them)::

    python -m torch.distributed.run --nproc_per_node N -m fami_pose_torch.run \
        --cfg configs/posetrack17/fami_pose.yaml --train --val

Each rank joins the process group first (NCCL; gloo with ``--device
cpu``) and runs on ``cuda:LOCAL_RANK``.
"""

import logging
import random

import numpy as np
import torch
import torch.distributed as dist

from fami_pose_torch.config import get_cfg
from fami_pose_torch.engine.argument_parser import default_parse_args
from fami_pose_torch.engine.runner import Runner
from fami_pose_torch.parallel.mesh import maybe_initialize_distributed


def set_random_seed(seed):
    # fixed seeds at entry: the datasets draw augmentation from ``np.random``
    # and ``random``; model init is seeded from cfg.SEED inside the engine
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    args = default_parse_args(argv)
    joined = maybe_initialize_distributed(device=args.device)
    try:
        cfg = get_cfg(args)
        set_random_seed(int(cfg.SEED))
        runner = Runner(cfg, args)
        return runner.launch(train=args.train, val=args.val, test=args.test)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
