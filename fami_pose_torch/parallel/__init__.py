"""Data parallelism over processes (``fami_pose_tpu/parallel``)."""
