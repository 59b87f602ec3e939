"""CLI argument surface (``fami_pose_tpu/engine/argument_parser.py``, plus
``--device``)."""

import argparse


def default_parse_args(argv=None):
    parser = argparse.ArgumentParser(description="fami_pose_torch runner")
    parser.add_argument("--cfg", required=True, help="experiment yaml path")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument(
        "--val_from_checkpoint", type=int, default=-1,
        help="evaluate every checkpoint with epoch >= this id",
    )
    parser.add_argument("--PE_Name", default="FAMI", help="pose estimator tag")
    parser.add_argument("--root_dir", default="./", help="project root")
    parser.add_argument(
        "--use_mppe_config", action="store_true",
        help="retained for reference-CLI compatibility (single default tree here)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the model and the batches live (cuda, or cpu); under "
             "torch.distributed.run, cuda is cuda:LOCAL_RANK and the ranks "
             "join over NCCL (gloo with cpu)",
    )
    parser.add_argument(
        "opts", nargs=argparse.REMAINDER, default=None,
        help="dotted-path config overrides, e.g. TRAIN.LR 0.001",
    )
    return parser.parse_args(argv)
