"""fami_pose_torch: the PyTorch/CUDA port of fami_pose_tpu for NVIDIA Hopper.

The JAX package ``fami_pose_tpu`` is the reference; this package imports
nothing of it (nor JAX). Entry points take ``device="cuda"`` by default; on
a CPU tensor every hand-written kernel's wrapper runs its plain torch
version instead. Importing the package builds nothing: the CUDA kernels
(``ops/cuda/csrc``) are compiled with ``nvcc`` at their first launch.
"""
