#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fami_pose_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each (``[phase] {json}``), then ``[timeline]``
(each phase's wall seconds), the kernel table line ``{"kernels": [...]}``,
the card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``:

  1. device  - needs CUDA; TF32 off for cuDNN and matmuls (parity phases).
  2. build   - nvcc builds every kernel in ``fami_pose_torch/ops/cuda/csrc``
               for sm_90a (one nvcc per source, in parallel).
  3. kernels - each kernel against its plain torch version on the card at
               the main-path shapes: the DCN forward and backward at B=8, 48
               channels, 96x72, 12 groups, D in {4, 1, exact}, f32 and bf16,
               a third of the offsets past D and a quarter rounded to
               integers; the translation warp at (32, 48, 96, 72), the
               serving path's shape, and at (8, 48, 96, 72), the train
               path's, and its backward at (8, 48, 96, 72), with shifts past
               +-26, and both at the val path's shapes (the DCN at B=32 with
               D in {4, 3, exact}, the warp at 128 images), and the DCN
               forward and backward at the deform blocks' settings (exact,
               dilation 1, B = 8; ``BLOCK_DCN_CASES``: bf16 at HRNet-W48's
               four branch widths, C = C_out = 48 at 96x72, 96 at 48x36, 192
               at 24x18 and 384 at 12x9, one group without a mask or two
               with one, the JAX tests' odd widths 6 -> 6 and 18 -> 16,
               C_out = 24, and f32 at C = C_out = 64 and 96; offsets
               ~N(0, 8) px, many samples off the image). Each kernel call
               is synchronised before its plain version runs, so that a
               fault names the kernel (``run_kernel``). Every kernel is timed
               device-side (``device_ms``: its launches in one CUDA graph),
               since host-paced calls cannot read a kernel below the
               wrapper's ~40-60 us, beside the host-paced reading; the
               library yardsticks likewise (``grid_sample`` and
               ``grid_sampler_2d_backward`` for the warps); the build phase
               counts each bf16 DCN instance's ``HGMMA`` instructions with
               ``cuobjdump -sass``. The warp backward is also timed with
               the L2 flushed between launches (``device_ms_cold``) and
               called twice for bitwise equal outputs. Every DCN backward
               row (B=8 at D = 4, 1 and exact in both types, B=32 at D = 4
               in bf16, every ``BLOCK_DCN_CASES`` row, and in the
               Sub-JHMDB, sustain and serving-ab rows) also makes 20 calls
               on its inputs: the elements of each output that differ from
               the first call's, limit 0 (``repeat_differences``; dx is the
               window's fixed-order gather, in the exact mode the gather
               from sources sorted by target pixel). Then
               the four
               on-chip gather / rotate probes (``ops/probes.py``) at the TPU
               probes' shapes, bitwise against ``torch.gather`` /
               ``torch.roll``, beside the floor of one empty kernel node in
               a replayed CUDA graph.
  4. main    - ``PosePredictor`` on ``configs/posetrack17/fami_pose.yaml``
               (HRNet-W48, 384x288, bf16, D=4, 4 supporting frames,
               flip-test as under VAL.FLIP_VAL) with seeded random weights,
               on a synthetic 10-frame 480x640 clip with 2 boxes a frame
               (20 requests, batches of 8). Launch counts of every kernel in
               that run, output checks, latency and clips/s; then one B=8
               batch split into crop / forward / backbone, and traced with
               torch.profiler (device busy share, top operators); and the
               DCN forward on ``dcn_1``'s own inputs from one such batch.
  5. card-vs-cpu - the same weights in f32, one key frame: final heatmaps of
               the CUDA path against the port on the CPU (plain versions).
  5b. streaming - ``engine/streaming.py`` on the same model: 8 streams, one
               a box of frames 0-3 of the clip, crops locked, every frame
               fed (flip-test; paired, then ``flip_batched``). Launches a
               streamed frame (8 DCN + 2 warp, no backward; 4 + 1 batched)
               and backbone calls a step (a forward hook: 2 of B, or 1 of
               2B); every key frame against the batch protocol's eval step
               on the same locked crops (f32 with TF32 off: heatmaps and
               decoded keypoints; bf16: within the batch protocol's own
               bf16-vs-f32 gap); ms a step, key
               frames/s, device-busy ms of a traced step and peak memory,
               beside the batch protocol's.
  6. train   - ``Trainer`` on the same config at ``TRAIN.BATCH_SIZE_PER_GPU
               8`` (the file's 48 is per GPU of the reference's 8-GPU host),
               seeded init, a seeded synthetic dataset: one epoch of 4 steps
               through ``Trainer.train`` (launch counts of the four kernels,
               checkpoint, resume), then ``trainer.train_step`` timed from
               synchronisation to synchronisation, a forward / backward /
               optimizer split by CUDA events as a per-layer reading, then 8
               steps on one fixed batch (finite loss terms and gradients,
               ``loss_mse`` falling), two runs of 3 steps on it from one
               state, every state tensor bit for bit
               (``repeat_train_steps``), the same two runs of a trainer with
               ``TPU.DCN_MAX_OFFSET 0`` (the exact DCN; its launches are
               the kernel line's exact-mode ``dcn_bwd`` row), one more step traced with
               torch.profiler, and one in which ``dcn_1``'s inputs and the
               gradient of its output are captured by hooks: ``dcn_bwd`` on
               them against its plain version, timed device-side.
  7. train-card-vs-cpu - f32, TF32 off, full W48 width at 256x192, B=2: the
               loss terms and every parameter's gradient of one train-mode
               forward and backward on the card against the port on the CPU
               (the head per tensor, the whole model as one vector), and the
               backbone's gradients in float64 per tensor.
  7b. train-levers - ``Trainer.train`` at full width, B=8, with every
               train-time lever on (``MODEL.PRETRAINED`` from a reference
               backbone ``.pth`` the script writes from seeded, calibrated
               weights, ``TPU.REMAT_BACKBONE``, ``TPU.BF16_GRADS``,
               ``TPU.DEVICE_CROP`` on raw windows of the val fixture's train
               split, ``TPU.PROFILE_DIR`` over 2 steps,
               ``TPU.ASYNC_CHECKPOINT``): the loaded backbone bit for bit,
               4 launches of each train kernel a step, finite loss terms and
               non-zero gradients (norms in float64) of the DCNs, their
               offset and mask convs, the offset head and the stem, a trace
               with kernels, ``metrics.jsonl``, the async checkpoint (also
               one saved while a step runs) and resume; each offset conv's
               gradient explained with ``BF16_GRADS`` off and on (live
               offsets, d_offset, float32 and float64 norms); then each
               lever alone against none (step and prepare ms, device-busy ms
               of a traced step, peak memory, the largest batch of a remat
               step by arithmetic), ``BF16_GRADS`` against none in turns and
               its casts alone; at 256x192, B=2, remat against none on the
               card (f32; the gradients and running statistics bit for bit,
               and two plain steps bit for bit) and, on tame weights at one
               block a stage branch,
               the ``BF16_GRADS`` step on the card against the CPU by
               ``bf16_rule`` (the rule ``tests/test_torch_train_levers.py``
               holds the port to against JAX), with planted faults; and
               ``fami_pose_torch.tools.validate_real_checkpoint``
               on the val fixture with a full reference ``epoch_20_state.pth``,
               in the exact DCN mode and at ``--dcn-bound 4``.

  8. probes  - ``fami_pose_torch.tools.hopper_watch``'s ``main()`` as the
               tool runs: every probe ``SUPPORTED``, exit code 0.
  9. val     - ``Runner(cfg, args).launch(val=True)`` on the same config at
               full width: the script writes a seeded synthetic PoseTrack17
               fixture (640x480 jpegs, 3 videos x 12 frames x 2 people = 72
               samples, COCO json, GT annolists) and a seeded,
               BatchNorm-calibrated W48 checkpoint, then scores it through
               the dataset class, the padded eval loader (batch 32: two full
               batches and one of 8), the flip-tested forward, the decode and
               the poseval protocol. Checks: 72 samples, 8 DCN + 2 warp
               launches a batch, finite AP tables for both heatmaps,
               predictions inside their boxes, GT as predictions -> Mean 100,
               card vs CPU in f32 on one batch of 4. Then a pass with the
               DARK decode (``VAL.POST_PROCESS``) and two with
               ``TPU.DCN_AUTO_WINDOW`` on checkpoints whose offset heads are
               pinned (D = 3 chosen; beyond the cap, the kernel's exact mode).
               Eval-loop samples/s, the loader's share, the decode's ms.
  10. int8   - the int8 serving path (``TPU.INT8_EVAL``) at full W48:
               ``Runner.launch(val=True)`` on phase val's fixture and
               checkpoint with the serving file's levers as options
               (``TPU.INT8_EVAL``, ``INT8_CALIB_BATCHES 2``,
               ``DCN_AUTO_WINDOW``; flip-test on; the file's PT18 tree
               needs a PT18 fixture), once to warm up and once counted:
               calibration before the window, every quantized conv's
               scale finite and positive (292 backbone convs and the head's
               15 chain convs, as the JAX model quantizes them; not
               ``final_layer``), 8 DCN + 2 warp launches a batch, 307
               quantize-pass + 307 implicit-GEMM launches a forward,
               finite AP tables, eval-loop samples/s, a traced int8 eval
               step's device-busy ms beside the bf16 step's; the card's
               int8 path against the port's on the CPU (f32, TF32 off, one
               key frame, the same scales: each int8 conv bit for bit on
               the same input, the heatmaps within twice the CPU int8
               path's own move under one-ulp noise at every int8 conv); phase streaming's 8 locked
               streams on the int8 model against the int8 batch protocol
               (f32 and bf16), key frames/s and device-busy ms beside bf16
               streaming's; then every distinct int8 conv geometry of one
               B=8 forward (hooks): both kernels against their plain
               versions and the card conv against the float64 plain conv,
               bit for bit, in f32 and bf16, each timed device-side beside
               its bound, with ``torch._int_mm`` on the conv's im2col
               matrix and cuDNN's bf16 conv on the same shapes, summed over
               the forward, each row naming the kernel instance that took
               it (``int8_instance``: the width of ``ops.int8_conv.
               n_tiling`` and its N tiles) with that instance's registers
               and spills; and ``fami_pose_torch.tools.int8_numerics`` at
               W48, 384x288. The build phase counts the implicit GEMM's
               ``IGMMA`` instructions and reads its registers and spills
               from ``-Xptxas -v``.
  10b. remainder - the modules ported last: each deform block
               (``models/deform_blocks.py``: AdaptBlock, AdaptBlockV2 with 2
               groups and masks, DeformBlock) at C = 64, 96x72, B = 8, bf16,
               a train-mode forward and backward on the card with one
               ``dcn_fwd`` and one ``dcn_bwd`` launch a block, and at C = 48
               in f32 (TF32 off) against the port on the CPU with the same
               weights, DeformBlock also at C = 96; a block at each width
               of ``BLOCK_DCN_CASES``, a train step on the card in the
               case's type (the launches of the kernels line's block rows);
               device NMS
               (``oks_nms_device`` on 64 CUDA poses, ``box_nms_device`` on
               256 CUDA boxes, with and without padded slots) against the
               host numpy keep lists; the native NMS library built from
               source on the card's host against numpy; ``--val`` with
               ``DEBUG.VIS_SKELETON`` and ``DEBUG.VIS_BBOX`` on phase val's
               fixture and checkpoint (50 overlays, each file pixel-equal
               to ``draw_skeleton_in_origin_image`` on the CPU from the same
               predictions); ``demo --vis`` (its ``main``) on the synthetic
               clip, batch and ``--streaming``: one overlay drawn per pose.
  10c. jhmdb - the Sub-JHMDB configuration (``configs/jhmdb/fami_pose.yaml``:
               HRNet-W48, 256x256, 15 joints, ``DISTANCE: 2`` so 2
               supporting frames, bf16, DCN window 6) at full width on a
               seeded synthetic fixture the script writes (2 clips x 16
               frames, one person a frame, 15 JHMDB-order joints): the
               flip-tested eval step at B = 8 with ``JHMDB_FLIP_PAIRS`` (8
               DCN + 2 warp launches, ms, a traced call's device-busy ms),
               its f32 forward on the card against the CPU (one key frame,
               phase card-vs-cpu's tolerance), ``Trainer`` for one epoch of
               4 steps at B = 8 (the file's 32 cut to 8; 4 DCN forward and
               backward launches a step, 2 warp and 2 warp backward) and its
               step timed, ``Runner.launch(val=True)`` on the checkpoint it
               wrote, scored with the dataset's PCK (GT as predictions ->
               100; the file leaves VAL.FLIP_VAL off: 4 DCN + 1 warp a
               batch). Phase kernels times the four kernels at this path's
               shapes (the DCN at (8, 48, 64, 64), D = 6; the warp on 16
               and 8 images of 48 x 64 x 64).
  10d. sustain - training to convergence with a mid-run resume, then the
               serving levers on the trained checkpoint, in a scratch
               directory removed at the phase's end:
               ``fami_pose_torch.tools.sustained_train``'s recipe (the JAX
               repository's ``tools/sustained_train_w48.py``: HRNet-W48,
               96x128, bf16, DCN window 4, B=8, LR 1e-3 flat, no
               augmentation, 150 epochs of 2 steps on the seed-3 fixture
               with ``--motion articulated --occlude 0.4``, killed at epoch
               75 and resumed by a fresh ``Trainer`` with
               ``TRAIN.AUTO_RESUME``; ``TPU.REMAT_BACKBONE`` turned off to
               save time, the port's remat being bit for bit no remat): 4
               launches of each train kernel a step, every resumed tensor
               bit for bit the saved one, the train PCK of the last 5 logs
               above 0.9 (the script fails otherwise), step ms, a traced
               step's device-busy ms; ``tools.ab_dcn_bound.run`` on the
               last checkpoint (the trained |offset| distribution at
               ``dcn_1..4``; per-joint AP and decoded-keypoint drift for
               exact, D = 1, 2, 4, 6, the window covering every offset, the
               auto window, int8 at D = 4 and the serving file's levers
               together; every window at or past the cover equal to exact
               joint by joint, or the script fails); ``tools.int8_numerics
               --ckpt``; ``tools.ablate_dcn_bound`` with the checkpoint's
               offsets (2 ``dcn_fwd`` a row); every int8 conv geometry of
               the trained int8 model at 96x128 (down to 4x3 maps) bit for
               bit against its plain
               versions and timed; ``dcn_fwd`` and ``dcn_bwd`` on each
               DCN stage's own inputs (the A/B's eval batch of 4, a train
               step's batch of 8) with the trained offsets and with them
               zeroed, against their plain versions, timed; the warps at
               the run's 8 images of 48x32x24.
  10e. serving-ab - the JAX repository's last trained-weights A/Bs, in a
               scratch directory removed at the phase's end: (A) the same
               recipe with ``--flip --motion drift --occlude 0.4`` for 47
               epochs (the JAX flip reading's epoch 46), killed and resumed
               at 23 (bit for bit, 4 launches of each train kernel a step);
               (B) ``tools.flip_ab.run --int8`` on its last checkpoint
               (flip-test off and on, bf16 and int8: every AP finite, each
               row's DCN and warp launches counted exactly, the int8
               kernels in the int8 rows only, no backward); (C)
               ``tools.streaming_ab.run`` (the batch protocol, crop-locked
               streaming, the auto re-prime policy at IoU 0.9 / 0.7 / 0.5:
               14 / 8 / 4 re-primes of 20 emissions or the script fails;
               4 DCN + 1 warp a forward or a streamed step, no backward);
               (D) ``tools.ablate_dcn_bound.run`` with the trained offsets
               (2 ``dcn_fwd`` a row: the window and the exact mode); (E)
               the ``BF16_GRADS`` step at full W48 depth on the checkpoint,
               B=2 at 96x128, card against the port on the CPU by
               ``bf16_rule`` (planted faults in the held ``BF16_HELD``
               tensors caught, or the script fails; the held count, the
               broken tensors beside the rule's verdict on the CPU against
               itself with its frames rounded otherwise, the tensors whose
               own gap is past ``BF16_TAME`` by name); then
               ``dcn_fwd`` / ``dcn_bwd`` on ``dcn_1``'s trained inputs and
               the warps at the path's shapes, timed.
  11. distributed - the data-parallel path (``parallel/mesh.py``) in
               processes of their own (``python3 chip_smoke.py
               --distributed-worker ...``): (a) one rank over NCCL:
               ``Trainer`` of ``TPU.MESH_SHAPE [-1, 1]`` at W48, 384x288,
               bf16, B=8, three steps, against the plain trainer on the
               same seed and batches (no collective; the first step's
               metrics and the state bit for bit, and two plain runs bit
               for bit: every kernel of the step sums in a fixed order),
               and each collective helper once on CUDA tensors; two NCCL
               ranks on the one card, whose answer is recorded (NCCL
               refuses two ranks on one GPU); (b) two ranks on the one card
               over gloo: ``Trainer.train`` at W48, global B=8, one epoch of
               3 steps, both ranks' states bit for bit equal, the
               checkpoint written by rank 0 only and auto-resumed on both
               bit for bit; one f32 step (TF32 off, one block a branch,
               256x192, global B=4) against one process's within
               ``DIST_GRAD_L2_LIMIT`` / ``DIST_LOSS_RTOL``; ``--val`` on
               phase val's fixture and checkpoint in f32 and with the int8
               serving levers (rank 0 scores, rank 1 returns ``{}``, the
               same predictions, int8 scales and window on both ranks; the
               f32 keypoints within ``DIST_PX_TOL`` of one process's); 8
               streams, 4 a rank, gathered, against one process's stream
               (f32, ``STREAM_F32_TOL``); (c) ``TPU.MESH_SHAPE [1, 2]``
               on the same two ranks, both replicas of data index 0:
               ``Trainer.train`` (global B=4, 2 steps) with both states bit
               for bit equal, the f32 step on the whole batch within
               ``DIST_GRAD_L2_LIMIT`` of one process's, f32 ``--val`` with
               every sample one row and the keypoints within
               ``DIST_PX_TOL`` of one process's. Each rank's step ms, the
               gradient bucket's bytes and all-reduce ms and the
               collectives a step,
               labelled as gloo through one card, not a multi-GPU reading.

Any failure raises: the script exits non-zero and prints no last line.
"""

import copy
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def emit(phase, **fields):
    print(f"[{phase}] {json.dumps(fields)}", flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, launches=50, replays=5):
    """Device-side time of one call of ``fn``: ``launches`` calls captured
    in one CUDA graph, the graph replayed ``replays`` times between two
    events, the fastest replay over ``launches``. A replay runs the
    recorded kernels with no Python, ctypes or allocator work between them,
    so this reads the kernels (and the few hundred nanoseconds the card
    needs between two of them), where :func:`time_ms`, which paces every
    launch from the host, cannot read below the wrapper's cost per call.
    The inputs stay in the 50 MB L2 between launches when they fit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    del graph
    return best


DEVICE_TIMING = ("ms and library_ms: 50 launches in one CUDA graph, fastest "
                 "of 5 replays; *host_paced_ms: 20 calls made one by one")
DCN_TIMING = ("ms: 20 launches in one CUDA graph, fastest of 5 replays; "
              "host_paced_ms: 20 calls made one by one")


FLUSH_BYTES = 96 * 2 ** 20  # read between launches: more than the 50 MB L2
COLD_TIMING = ("cold_ms: 50 launches in one CUDA graph, each after a read "
               "of 96 MB (more than the 50 MB L2), fastest of 5 replays, "
               "less the reads timed alone the same way")


def device_ms_cold(fn, launches=50):
    """Device-side time of one call of ``fn`` that finds its inputs outside
    the L2, as the train path's warp backward finds the supporting frame's
    features: :func:`device_ms` of (a read of a 96 MB buffer, then ``fn``)
    less :func:`device_ms` of the read alone. The read leaves the L2 full
    of clean lines, so ``fn`` pays no write-back of another kernel's
    output."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")

    def read():
        torch.sum(flush, dim=0, out=sink)

    def both():
        read()
        fn()

    return (device_ms(both, launches=launches)
            - device_ms(read, launches=launches))


def bound_ms(n_bytes, n_ops, dtype):
    """Least time on an H100 (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s f32):
    the larger of the bytes over the memory rate and the operations over
    the peak rate for the input type."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def run_kernel(name, fn):
    """One call of a kernel's wrapper, synchronised at once, before anything
    else runs: a fault on the card during the kernel is reported here under
    the kernel's name, not at the next call that checks for errors."""
    out = fn()
    try:
        torch.cuda.synchronize()
    except RuntimeError as err:
        raise RuntimeError(f"{name}: CUDA fault during the kernel: {err}") \
            from err
    return out


REPEAT_CALLS = 20
DCN_GRAD_NAMES = ("dx", "doffset", "dmask", "dweight")


def repeat_differences(name, run_k, calls=REPEAT_CALLS):
    """``calls`` calls of the DCN backward's wrapper on the same inputs: the
    elements of each output that differ from the first call's in any later
    call. The backward sums every output in a fixed order (dx by the
    window's gather, or in the exact mode from sources sorted by target
    pixel; dweight from per-block partials), so the limit is 0 and anything
    else raises."""
    first = [None if t is None else t.clone() for t in run_kernel(name, run_k)]
    differ = [None if t is None else torch.zeros_like(t, dtype=torch.bool)
              for t in first]
    for _ in range(calls - 1):
        for d, a, b in zip(differ, run_k(), first):
            if d is not None:
                d |= a != b
    counts = {n: int(d.sum()) for n, d in zip(DCN_GRAD_NAMES, differ)
              if d is not None}
    if any(counts.values()):
        raise AssertionError(f"{name}: {calls} calls differ from the first "
                             f"at {counts} elements (limit 0)")
    return counts


def check_close(name, got, ref, dtype):
    """f32: 1e-4 of the output's scale (sum order over 432 products);
    bf16: one bf16 ulp (2^-7 relative) of the largest output, since both
    sides round the same f32 sum to bf16 once."""
    scale = max(1.0, float(ref.float().abs().max()))
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4) * scale
    err = max_err(got, ref)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err, tol


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32="off for cuDNN convolutions and matmuls")
    return smi


def hgmma_counts(sass):
    """``HGMMA`` (bf16 wgmma) instructions of each bf16 DCN kernel instance
    and ``IGMMA`` (s8 wgmma) of each implicit-GEMM instance in ``cuobjdump
    -sass`` output: {"dcn_fwd" / "dcn_bwd" / "int8_implicit_gemm":
    {instance: n}}."""
    import re

    counts, row, op = {}, None, None
    for line in sass.splitlines():
        if "Function : " in line:
            row = None
            m = re.search(r"(dcn_(?:fwd|bwd))_bf16_(?:chunked_)?kernelILi"
                          r"(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?", line)
            g = re.search(r"igemm_kernelI(13__nv_bfloat16|f)Li(\d+)E", line)
            if m:
                row, op = counts.setdefault(m.group(1), {}), "HGMMA"
                chunked = "_chunked" if "chunked" in line else ""
                args = ", ".join(g for g in m.group(2, 3) if g) + (
                    ", wide" if m.group(4) == "1" else "")
                key = f"{m.group(1)}_bf16{chunked}_kernel<{args}>"
            elif g:
                row, op = counts.setdefault("int8_implicit_gemm", {}), "IGMMA"
                dt = "float" if g.group(1) == "f" else "bf16"
                key = f"igemm_kernel<{dt}, {g.group(2)}>"
            if row is not None:
                row[key] = 0
        elif row is not None and op in line:
            row[key] += 1
    return counts


DCN_KERNEL_NAMES = (
    "dcn_fwd_bf16_kernel", "dcn_fwd_bf16_chunked_kernel",
    "dcn_fwd_bf16_staged_kernel", "dcn_fwd_f32_kernel", "sum_kernel",
    "pack_kernel", "grouped_channels_last_kernel", "dcn_bwd_bf16_kernel",
    "dcn_bwd_f32_kernel", "dx_gather_kernel", "dx_tiles_kernel",
    "dx_lists_kernel", "bucket_count_kernel", "bucket_scan_kernel",
    "bucket_place_kernel", "key_sort_kernel", "prep_kernel", "finish_kernel",
    "dw_split_kernel")


def kernel_instance(mangled, names):
    """``name<args>`` of a mangled kernel whose name is one of ``names``
    (template arguments: numbers, true / false, bf16, float, unsigned,
    u64, int2, int4), or None."""
    import re

    m = re.search(r"\d+(" + "|".join(names) + r")(I((?:Li\d+E|Lb[01]E|"
                  r"13__nv_bfloat16|4int[24]|[fjy])+)E)?E", mangled)
    if not m:
        return None
    words = {"13__nv_bfloat16": "bf16", "f": "float", "j": "unsigned",
             "y": "u64", "Lb1E": "true", "Lb0E": "false", "4int2": "int2",
             "4int4": "int4"}
    args = [words.get(t) or t[2:-1] for t in re.findall(
        r"Li\d+E|Lb[01]E|13__nv_bfloat16|4int[24]|[fjy]", m.group(3) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ptxas_usage(log, names=("igemm_kernel", "quant_nhwc_kernel")):
    """Registers and spill bytes of each instance of the kernels ``names``
    (by default the int8 conv's), from ``-Xptxas -v`` output:
    {"igemm_kernel<bf16, 48>" ...: [registers, spill stores, spill
    loads]}."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_instance(m.group(1), names)
            if name:
                out[name] = [None, None, None]
        elif name:
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
            rg = re.search(r"Used (\d+) registers", line)
            if sp:
                out[name][1:] = [int(sp.group(1)), int(sp.group(2))]
            if rg:
                out[name][0] = int(rg.group(1))
    return out


# -Xptxas -v of the int8 kernels' instances: {instance: [registers, spill
# stores, spill loads]} (phase build, where it built the library)
INT8_USAGE = {}


def phase_build():
    """Builds the kernels; returns the wgmma kernels' HGMMA / IGMMA
    counts."""
    from fami_pose_torch.ops.cuda import build

    t0 = time.perf_counter()
    logs = []
    so = build.build(verbose=True, out_logs=logs)
    build.load_library()
    seconds = time.perf_counter() - t0
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    hgmma = hgmma_counts(subprocess.run(
        [tool, "-sass", so], capture_output=True, text=True, check=True,
        timeout=300).stdout)
    if not all(hgmma.get("int8_implicit_gemm", {}).values()) or \
            not hgmma.get("int8_implicit_gemm"):
        raise AssertionError(f"implicit GEMM without IGMMA: {hgmma}")
    usage = ptxas_usage("\n".join(logs))
    INT8_USAGE.update(usage)
    dcn_usage = ptxas_usage("\n".join(logs), DCN_KERNEL_NAMES)
    spilled = {k: v for k, v in dcn_usage.items() if v[1] or v[2]}
    emit("build", seconds=round(seconds, 3),
         library=os.path.relpath(so, ROOT), sources=list(build.SOURCES),
         hgmma=hgmma, int8_registers_spill_stores_spill_loads=usage or
         "not rebuilt in this process (the library was cached)",
         dcn_registers_spill_stores_spill_loads=dcn_usage or
         "not rebuilt in this process (the library was cached)",
         dcn_instances_that_spill=spilled)
    return hgmma


def dcn_inputs(gen, dtype, d, b=8, c=48, h=96, w=72, g=12):
    dev = "cuda"
    spread = 1.5 * d if d > 0 else 6.0  # a third of the offsets past D
    x = torch.randn(b, c, h, w, generator=gen, device=dev).to(dtype)
    off = ((torch.rand(b, 2 * g * 9, h, w, generator=gen, device=dev) * 2 - 1)
           * spread)
    # a quarter exactly integer: where the backward's offset derivative is 0
    pick = torch.rand(off.shape, generator=gen, device=dev) < 0.25
    off = torch.where(pick, off.round(), off).to(dtype)
    msk = torch.rand(b, g * 9, h, w, generator=gen, device=dev).to(dtype)
    wgt = (torch.randn(c, c, 3, 3, generator=gen, device=dev) * 0.05).to(dtype)
    return x, off, msk, wgt


DCN_NO_LIBRARY = ("none: no single PyTorch call computes a modulated DCN "
                  "(no torchvision on the machine)")
WARP_BWD_LIBRARY = (
    "torch.ops.aten.grid_sampler_2d_backward(bilinear, zeros, "
    "align_corners=True) on a precomputed grid, device-side: the image "
    "gradient and a per-pixel grid gradient, which is not summed into "
    "d_offsets as the kernel does")


def dcn_fwd_bound(x, off, msk, wgt, out):
    """Every input read once and the output written once; the contraction
    (2 * 9C * Cout a pixel) and ~9 operations a sampled value."""
    b, c, h, w = x.shape
    ops = 2 * b * h * w * 9 * c * wgt.shape[0] + 9 * b * h * w * 9 * c
    return bound_ms(nbytes(x, off, msk, wgt, out), ops, x.dtype)


def dcn_bwd_bound(x, off, msk, wgt, gout, grads):
    """Every input read once and every gradient written once in its own
    type; two contractions (dcol, dweight) and ~30 operations per sampled
    (pixel, tap, channel)."""
    b, c, h, w = x.shape
    ops = 4 * b * h * w * 9 * c * wgt.shape[0] + 30 * b * h * w * 9 * c
    return bound_ms(nbytes(x, off, msk, wgt, gout, *grads), ops, x.dtype)


# the deform blocks' DCN (models/deform_blocks.py): exact, dilation and
# padding 1, offsets ~N(0, 8) px (many samples off the image), B = 8. Each
# case is (dtype, C, C_out, groups, plane), a mask with 2 groups and none
# (DCNv1) with 1: the blocks inside HRNet-W48's four branches, C = C_out =
# 48 at 96x72, 96 at 48x36, 192 at 24x18 and 384 at 12x9; the JAX tests'
# odd widths (6 -> 6 and 18 -> 16); C_out = 24; float32 at C = C_out = 64
# and 96 (the chunked f32 forward: the whole-W layout needed 297,216 B of
# shared memory at 64 and was refused)
HRNET_W48_BRANCHES = ((48, (96, 72)), (96, (48, 36)), (192, (24, 18)),
                      (384, (12, 9)))
BLOCK_DCN_CASES = (
    [(torch.bfloat16, c, c, g, hw) for c, hw in HRNET_W48_BRANCHES
     for g in (1, 2)]
    + [(torch.bfloat16, 6, 6, 1, (96, 72)), (torch.bfloat16, 18, 16, 1, (96, 72)),
       (torch.bfloat16, 48, 24, 2, (96, 72)),
       (torch.float32, 64, 64, 1, (96, 72)), (torch.float32, 64, 64, 2, (96, 72)),
       (torch.float32, 96, 96, 1, (48, 36))])
BLOCK_OFFSET_STD = 8.0
BLOCK_BATCH = 8


def block_case_key(dtype, c, c_out, groups):
    return f"{str(dtype)[6:]} C={c} C_out={c_out} G={groups}"


def block_dcn_inputs(gen, dtype, c, c_out, groups, hw, b=BLOCK_BATCH):
    dev, (h, w) = "cuda", hw
    x = torch.randn(b, c, h, w, generator=gen, device=dev).to(dtype)
    off = (torch.randn(b, 18 * groups, h, w, generator=gen, device=dev)
           * BLOCK_OFFSET_STD).to(dtype)
    msk = (torch.rand(b, 9 * groups, h, w, generator=gen, device=dev)
           .to(dtype) if groups > 1 else None)
    wgt = (torch.randn(c_out, c, 3, 3, generator=gen, device=dev)
           * (0.4 / math.sqrt(c))).to(dtype)
    return x, off, msk, wgt


def off_image_share(off, groups):
    """The share of a 3x3, dilation 1, padding 1 DCN's samples whose
    position lies wholly off the image (every bilinear corner outside:
    they read zeros)."""
    b, _, h, w = off.shape
    o = off.float().view(b, groups, 9, 2, h, w)
    k = torch.arange(9, device=off.device)
    y = (torch.arange(h, device=off.device).view(1, 1, 1, h, 1)
         + (k // 3 - 1).view(1, 1, 9, 1, 1) + o[:, :, :, 0])
    x = (torch.arange(w, device=off.device).view(1, 1, 1, 1, w)
         + (k % 3 - 1).view(1, 1, 9, 1, 1) + o[:, :, :, 1])
    return float(((y <= -1) | (y >= h) | (x <= -1) | (x >= w)).float().mean())


def block_kernel_rows(gen):
    """``dcn_fwd`` and ``dcn_bwd`` at the deform blocks' settings
    (``BLOCK_DCN_CASES``), each against its plain version through
    ``run_kernel``, the backward 20 calls bit for bit
    (``repeat_differences``), timed device-side beside its bound. Returns the rows of
    the kernels line, keyed ("dcn_fwd" / "dcn_bwd", "blocks", case key)."""
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d, deform_conv2d_backward, deform_conv2d_backward_plain,
        deform_conv2d_windowed,
    )

    rows = {}
    kw = dict(padding=1, dilation=1, max_offset=None)
    for dtype, c, c_out, groups, hw in BLOCK_DCN_CASES:
        x, off, msk, wgt = block_dcn_inputs(gen, dtype, c, c_out, groups, hw)
        with_mask = msk is not None
        outside = off_image_share(off, groups)
        key = block_case_key(dtype, c, c_out, groups)
        tag = f"{key} {'mask' if with_mask else 'no mask'}"
        run_k = lambda: deform_conv2d_windowed(x, off, msk, wgt,
                                               offset_groups=groups, **kw)
        run_p = lambda: deform_conv2d(x, off, msk, wgt, offset_groups=groups,
                                      **kw)
        got = run_kernel(f"dcn_fwd blocks {tag}", run_k)
        err, tol = check_close(f"dcn_fwd blocks {tag}", got, run_p(), dtype)
        host_ms, k_ms = time_ms(run_k), device_ms(run_k, launches=20)
        p_ms = time_ms(run_p, iters=3, warmup=1)
        bnd, by = dcn_fwd_bound(x, off, msk, wgt, got)
        common = dict(shape=list(x.shape), c_out=c_out, groups=groups,
                      mask=with_mask, dilation=1, D="exact",
                      dtype=str(dtype)[6:])
        fwd = dict(common, offsets_std_px=BLOCK_OFFSET_STD,
                   samples_off_the_image=float(outside), max_abs_err=err,
                   tol=tol, ms=k_ms, host_paced_ms=host_ms,
                   timing=DCN_TIMING, plain_ms=p_ms, bound_ms=bnd,
                   bound_by=by, library_ms=None, library=DCN_NO_LIBRARY)
        emit("kernels", kernel="dcn_fwd", path="deform blocks", **fwd)

        gout = torch.randn(got.shape, generator=gen, device="cuda").to(dtype)
        run_k = lambda: deform_conv2d_backward(x, off, msk, wgt, gout,
                                               offset_groups=groups, **kw)
        run_p = lambda: deform_conv2d_backward_plain(
            x, off, msk, wgt, gout, offset_groups=groups, **kw)
        got_b = run_kernel(f"dcn_bwd blocks {tag}", run_k)
        repeats = repeat_differences(f"dcn_bwd blocks {tag}", run_k)
        ref_b = run_p()
        errs = {}
        for name, a, r in zip(("dx", "doffset", "dmask", "dweight"), got_b,
                              ref_b):
            if r is None:  # DCNv1: no mask, no mask gradient
                if a is not None:
                    raise AssertionError(f"dcn_bwd blocks {tag}: a dmask "
                                         "without a mask")
                continue
            errs[name] = check_close(f"dcn_bwd blocks {name} {tag}", a, r,
                                     dtype)
        host_ms, k_ms = time_ms(run_k), device_ms(run_k, launches=20)
        p_ms = time_ms(run_p, iters=3, warmup=1)
        bnd, by = dcn_bwd_bound(x, off, msk, wgt, gout,
                                [g for g in got_b if g is not None])
        bwd = dict(common, max_abs_err=max(e for e, _ in errs.values()),
                   max_abs_err_by_output={k: e for k, (e, _) in errs.items()},
                   tol={k: t for k, (_, t) in errs.items()}, ms=k_ms,
                   host_paced_ms=host_ms, timing=DCN_TIMING, plain_ms=p_ms,
                   bound_ms=bnd, bound_by=by, library_ms=None,
                   library="none: no single PyTorch call computes a "
                   "deformable conv's gradients",
                   differing_in_20_calls=repeats)
        emit("kernels", kernel="dcn_bwd", path="deform blocks", **bwd)
        rows["dcn_fwd", "blocks", key] = fwd
        rows["dcn_bwd", "blocks", key] = bwd
        del x, off, msk, wgt, got, got_b, ref_b, gout
    torch.cuda.empty_cache()
    return rows


# the Sub-JHMDB path's shapes (configs/jhmdb/fami_pose.yaml: 256x256 input,
# 64x64 features, 2 supporting frames, DCN window 6): the DCN at B = 8, the
# forward warp on the 16 supporting-frame features of a B = 8 eval batch
# (one call), its backward on the 8 of one supporting frame of a train step
JHMDB_DCN_D = 6
JHMDB_PLANE = (64, 64)


def jhmdb_kernel_rows(gen):
    """``dcn_fwd``, ``dcn_bwd``, ``warp_translate`` and ``warp_bwd`` in bf16
    at the Sub-JHMDB path's shapes, against their plain versions, timed
    device-side beside their bounds. Returns the rows keyed (name,
    "jhmdb")."""
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d, deform_conv2d_backward, deform_conv2d_backward_plain,
        deform_conv2d_windowed,
    )

    dtype, d, (h, w) = torch.bfloat16, JHMDB_DCN_D, JHMDB_PLANE
    rows = {}
    x, off, msk, wgt = dcn_inputs(gen, dtype, d, b=JHMDB_BATCH, h=h, w=w)
    kw = dict(padding=3, dilation=3, offset_groups=12, max_offset=d)
    run_k = lambda: deform_conv2d_windowed(x, off, msk, wgt, **kw)
    run_p = lambda: deform_conv2d(x, off, msk, wgt, **kw)
    got = run_kernel("dcn_fwd Sub-JHMDB", run_k)
    err, tol = check_close("dcn_fwd Sub-JHMDB", got, run_p(), dtype)
    bnd, by = dcn_fwd_bound(x, off, msk, wgt, got)
    rows["dcn_fwd", "jhmdb"] = dict(
        shape=list(x.shape), D=d, max_abs_err=err, tol=tol,
        ms=device_ms(run_k, launches=20), host_paced_ms=time_ms(run_k),
        timing=DCN_TIMING, plain_ms=time_ms(run_p, iters=3, warmup=1),
        bound_ms=bnd, bound_by=by, library_ms=None, library=DCN_NO_LIBRARY)
    gout = torch.randn(got.shape, generator=gen, device="cuda").to(dtype)
    run_k = lambda: deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
    run_p = lambda: deform_conv2d_backward_plain(x, off, msk, wgt, gout, **kw)
    got_b = run_kernel("dcn_bwd Sub-JHMDB", run_k)
    repeats = repeat_differences("dcn_bwd Sub-JHMDB", run_k)
    errs = {n: check_close(f"dcn_bwd {n} Sub-JHMDB", a, r, dtype)[0]
            for n, a, r in zip(("dx", "doffset", "dmask", "dweight"), got_b,
                               run_p())}
    bnd, by = dcn_bwd_bound(x, off, msk, wgt, gout, got_b)
    rows["dcn_bwd", "jhmdb"] = dict(
        shape=list(x.shape), D=d, max_abs_err=max(errs.values()),
        max_abs_err_by_output=errs, ms=device_ms(run_k, launches=20),
        host_paced_ms=time_ms(run_k), timing=DCN_TIMING,
        plain_ms=time_ms(run_p, iters=3, warmup=1), bound_ms=bnd,
        bound_by=by, library_ms=None,
        library="none: no single PyTorch call computes a deformable conv's "
        "gradients", differing_in_20_calls=repeats)
    del x, off, msk, wgt, got, got_b, gout
    rows.update(warp_kernel_rows(
        gen, "jhmdb", {"warp_translate": 2 * JHMDB_BATCH,
                       "warp_bwd": JHMDB_BATCH}, (h, w)))
    for (name, _), row in rows.items():
        emit("kernels", kernel=name, path="Sub-JHMDB", dtype="bfloat16",
             **row)
    torch.cuda.empty_cache()
    return rows


def warp_kernel_rows(gen, label, images, plane):
    """``warp_translate`` and ``warp_bwd`` in bf16 on ``images[name]``
    feature maps of 48 x ``plane`` (h, w), shifts ~U(-40, 40), against
    their plain versions, timed device-side beside their bounds and the
    library's ``grid_sample`` calls. Returns the rows keyed (name,
    ``label``)."""
    from fami_pose_torch.ops.warp import (
        warp_translate, warp_translate_backward,
        warp_translate_backward_plain, warp_translate_plain,
    )

    dtype, (h, w) = torch.bfloat16, plane
    rows = {}
    for name, n in images.items():
        img = torch.randn(n, 48, h, w, generator=gen, device="cuda").to(dtype)
        offs = (torch.rand(n, 2, generator=gen, device="cuda") * 2 - 1) * 40.0
        grid = translation_grid(offs, h, w, dtype)
        if name == "warp_translate":
            run_k = lambda: warp_translate(img, offs, max_shift=26)
            run_p = lambda: warp_translate_plain(img, offs, 26)
            run_l = lambda: torch.nn.functional.grid_sample(
                img, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True)
            got = run_kernel(f"warp_translate {label}", run_k)
            err = check_close(f"warp_translate {label}", got, run_p(),
                              dtype)[0]
            bnd, by = bound_ms(nbytes(img, offs, got), 9 * img.numel(), dtype)
            library = ("F.grid_sample(bilinear, zeros, align_corners=True) "
                       "on a precomputed grid")
        else:
            gout = torch.randn(img.shape, generator=gen,
                               device="cuda").to(dtype)
            run_k = lambda: warp_translate_backward(img, offs, gout, 26)
            run_p = lambda: warp_translate_backward_plain(img, offs, gout, 26)
            run_l = lambda: torch.ops.aten.grid_sampler_2d_backward(
                gout, img, grid, 0, 0, True, [True, True])
            got = run_kernel(f"warp_bwd {label}", run_k)
            ref = run_p()
            err = max(check_close(f"warp_bwd d_images {label}", got[0],
                                  ref[0], dtype)[0],
                      check_close(f"warp_bwd d_offsets {label}", got[1],
                                  ref[1], torch.float32)[0])
            bnd, by = bound_ms(nbytes(img, offs, gout, *got),
                               30 * img.numel(), dtype)
            library = WARP_BWD_LIBRARY
        rows[name, label] = dict(
            shape=[n, 48, h, w], max_shift=26, max_abs_err=err,
            ms=device_ms(run_k), host_paced_ms=time_ms(run_k),
            plain_ms=time_ms(run_p), bound_ms=bnd, bound_by=by,
            library_ms=device_ms(run_l), library=library,
            timing=DEVICE_TIMING)
        del img, offs, grid, got
    return rows


def translation_grid(offs, h, w, dtype):
    """grid_sample's sampling grid (align_corners=True) for the warp at
    p - clamp(t, +-26)."""
    t = offs.clamp(-26, 26)
    ys = torch.arange(h, device=offs.device, dtype=torch.float32)
    xs = torch.arange(w, device=offs.device, dtype=torch.float32)
    gx = (xs[None, None, :] - t[:, 0, None, None]) * (2.0 / (w - 1)) - 1
    gy = (ys[None, :, None] - t[:, 1, None, None]) * (2.0 / (h - 1)) - 1
    return torch.stack(torch.broadcast_tensors(gx, gy), dim=-1).to(dtype)


def phase_kernels(hgmma):
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d, deform_conv2d_backward, deform_conv2d_backward_plain,
        deform_conv2d_windowed,
    )
    from fami_pose_torch.ops.warp import (
        warp_translate, warp_translate_backward,
        warp_translate_backward_plain, warp_translate_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for d in (4, 1, 0):
            x, off, msk, wgt = dcn_inputs(gen, dtype, d)
            kw = dict(padding=3, dilation=3, offset_groups=12)
            run_k = lambda: deform_conv2d_windowed(x, off, msk, wgt, max_offset=d, **kw)
            run_p = lambda: deform_conv2d(x, off, msk, wgt, max_offset=d, **kw)
            name = f"dcn_fwd D={d} {dtype}"
            got = run_kernel(name, run_k)
            err, tol = check_close(name, got, run_p(), dtype)
            past = float((off.float().abs() > d).float().mean()) if d else 0.0
            host_ms, k_ms = time_ms(run_k), device_ms(run_k, launches=20)
            p_ms = time_ms(run_p, iters=5, warmup=1)
            bnd, by = dcn_fwd_bound(x, off, msk, wgt, got)
            emit("kernels", kernel="dcn_fwd", dtype=str(dtype)[6:], D=d,
                 shape=list(x.shape), offsets_past_D=round(past, 4),
                 max_abs_err=err, tol=tol, ms=k_ms, host_paced_ms=host_ms,
                 timing=DCN_TIMING, plain_ms=p_ms,
                 bound_ms=bnd, bound_by=by, library_ms=None,
                 library=DCN_NO_LIBRARY)
            if dtype == torch.bfloat16 and d == 4:
                rows["dcn_fwd"] = dict(shape=list(x.shape), max_abs_err=err,
                                       ms=k_ms, host_paced_ms=host_ms,
                                       timing=DCN_TIMING, plain_ms=p_ms,
                                       bound_ms=bnd, bound_by=by,
                                       library_ms=None,
                                       library=DCN_NO_LIBRARY)

            # the backward on the same inputs; every output against the plain
            # backward; 20 calls bit for bit in both modes (dx by the
            # window's gather, or in the exact mode from sorted lists)
            gout = torch.randn(got.shape, generator=gen,
                               device="cuda").to(dtype)
            run_k = lambda: deform_conv2d_backward(x, off, msk, wgt, gout,
                                                   max_offset=d, **kw)
            run_p = lambda: deform_conv2d_backward_plain(
                x, off, msk, wgt, gout, max_offset=d, **kw)
            got_b = run_kernel(f"dcn_bwd D={d} {dtype}", run_k)
            repeats = repeat_differences(f"dcn_bwd D={d} {dtype}", run_k)
            ref_b = run_p()
            errs = {}
            for name, a, r in zip(("dx", "doffset", "dmask", "dweight"),
                                  got_b, ref_b):
                errs[name] = check_close(f"dcn_bwd {name} D={d} {dtype}", a, r,
                                         dtype)
            integer = float(
                (off.float() == off.float().round()).float().mean())
            host_ms, k_ms = time_ms(run_k), device_ms(run_k, launches=20)
            p_ms = time_ms(run_p, iters=3, warmup=1)
            bnd, by = dcn_bwd_bound(x, off, msk, wgt, gout, got_b)
            worst = max(e for e, _ in errs.values())
            emit("kernels", kernel="dcn_bwd", dtype=str(dtype)[6:], D=d,
                 shape=list(x.shape), offsets_past_D=round(past, 4),
                 offsets_integer=round(integer, 4),
                 max_abs_err={k: e for k, (e, _) in errs.items()},
                 tol={k: t for k, (_, t) in errs.items()}, ms=k_ms,
                 host_paced_ms=host_ms, timing=DCN_TIMING,
                 plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None,
                 library="none: no single PyTorch call computes a modulated "
                 "DCN's gradients",
                 differing_in_20_calls=repeats)
            if dtype == torch.bfloat16 and d in (4, 0):
                rows["dcn_bwd", d] = dict(
                    shape=list(x.shape), max_abs_err=worst, ms=k_ms,
                    host_paced_ms=host_ms, timing=DCN_TIMING, plain_ms=p_ms,
                    bound_ms=bnd, bound_by=by, library_ms=None,
                    hgmma=hgmma["dcn_bwd"], differing_in_20_calls=repeats)

    # the DCN forward at the val path's shape (VAL.BATCH_SIZE_PER_GPU 32):
    # the configured window, one the auto-window picks, and the exact mode
    for d in (4, 3, 0):
        dtype = torch.bfloat16
        x, off, msk, wgt = dcn_inputs(gen, dtype, d, b=32)
        kw = dict(padding=3, dilation=3, offset_groups=12)
        run_k = lambda: deform_conv2d_windowed(x, off, msk, wgt, max_offset=d, **kw)
        run_p = lambda: deform_conv2d(x, off, msk, wgt, max_offset=d, **kw)
        name = f"dcn_fwd B=32 D={d}"
        got = run_kernel(name, run_k)
        err, tol = check_close(name, got, run_p(), dtype)
        host_ms, k_ms = time_ms(run_k), device_ms(run_k, launches=20)
        p_ms = time_ms(run_p, iters=3, warmup=1)
        bnd, by = dcn_fwd_bound(x, off, msk, wgt, got)
        emit("kernels", kernel="dcn_fwd", dtype="bfloat16", D=d,
             shape=list(x.shape), max_abs_err=err, tol=tol, ms=k_ms,
             host_paced_ms=host_ms, timing=DCN_TIMING, plain_ms=p_ms,
             bound_ms=bnd, bound_by=by, library_ms=None,
             library=DCN_NO_LIBRARY)
        if d == 4:
            rows["dcn_fwd", 32] = dict(shape=list(x.shape), max_abs_err=err,
                                       ms=k_ms, host_paced_ms=host_ms,
                                       timing=DCN_TIMING, plain_ms=p_ms,
                                       bound_ms=bnd, bound_by=by,
                                       library_ms=None,
                                       library=DCN_NO_LIBRARY)
            # the backward at B=32: against its plain version, 20 calls bit
            # for bit, timed
            gout = torch.randn(got.shape, generator=gen,
                               device="cuda").to(dtype)
            run_k = lambda: deform_conv2d_backward(x, off, msk, wgt, gout,
                                                   max_offset=d, **kw)
            got_b = run_kernel("dcn_bwd B=32 D=4", run_k)
            repeats = repeat_differences("dcn_bwd B=32 D=4", run_k)
            errs = {n: check_close(f"dcn_bwd {n} B=32 D=4", a, r, dtype)[0]
                    for n, a, r in zip(DCN_GRAD_NAMES, got_b,
                                       deform_conv2d_backward_plain(
                                           x, off, msk, wgt, gout,
                                           max_offset=d, **kw))}
            bnd, by = dcn_bwd_bound(x, off, msk, wgt, gout, got_b)
            rows["dcn_bwd", 32] = dict(
                shape=list(x.shape), max_abs_err=max(errs.values()),
                max_abs_err_by_output=errs, ms=device_ms(run_k, launches=20),
                host_paced_ms=time_ms(run_k), timing=DCN_TIMING,
                plain_ms=time_ms(lambda: deform_conv2d_backward_plain(
                    x, off, msk, wgt, gout, max_offset=d, **kw), iters=3,
                    warmup=1),
                bound_ms=bnd, bound_by=by, library_ms=None,
                library=DCN_BWD_NO_LIBRARY, differing_in_20_calls=repeats)
            emit("kernels", kernel="dcn_bwd", dtype="bfloat16", D=d,
                 **rows["dcn_bwd", 32])
            del gout, got_b
        del x, off, msk, got
    torch.cuda.empty_cache()
    rows.update(block_kernel_rows(gen))
    rows.update(jhmdb_kernel_rows(gen))

    # the forward warp at the shapes the main paths give it: 128 images (one
    # call for the 4 supporting frames of a B=32 val batch), 32 images (the
    # same of a B=8 serving batch) and 8 images (one call per supporting
    # frame of a B=8 train step), with the configured blend (TPU.WARP_IMPL
    # matmul); in bf16 at 32 images also the other two blends
    cases = [(dtype, n, "matmul") for dtype, n in itertools.product(
        (torch.float32, torch.bfloat16), (128, 32, 8))]
    cases[4:4] = [(torch.bfloat16, 32, "pallas"), (torch.bfloat16, 32, "slice")]
    for dtype, n, impl in cases:
        c, h, w = 48, 96, 72
        img = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
        offs = (torch.rand(n, 2, generator=gen, device="cuda") * 2 - 1) * 40.0
        run_k = lambda: warp_translate(img, offs, max_shift=26, impl=impl)
        run_p = lambda: warp_translate_plain(img, offs, 26, impl)
        name = f"warp_translate n={n} {dtype} {impl}"
        got = run_kernel(name, run_k)
        ref = run_p()
        err, tol = check_close(name, got, ref, dtype)
        bitwise = bool(torch.equal(got, ref))
        # library yardstick: grid_sample (bilinear, zeros) at p - clamp(t)
        grid = translation_grid(offs, h, w, dtype)
        run_l = lambda: torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)
        lib_err = max_err(run_l(), ref)
        del ref
        host_ms, p_ms, l_host_ms = time_ms(run_k), time_ms(run_p), time_ms(run_l)
        k_ms, l_ms = device_ms(run_k), device_ms(run_l)
        bnd, by = bound_ms(nbytes(img, offs, got), 9 * img.numel(), dtype)
        past = float((offs.abs() > 26).float().mean())
        emit("kernels", kernel="warp_translate", dtype=str(dtype)[6:],
             impl=impl, shape=[n, c, h, w], max_shift=26,
             shifts_past_clamp=past, max_abs_err=err, tol=tol,
             bitwise_equal=bitwise, ms=k_ms, host_paced_ms=host_ms,
             plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms,
             library_host_paced_ms=l_host_ms, timing=DEVICE_TIMING,
             library="F.grid_sample(bilinear, zeros, align_corners=True) on "
             "a precomputed grid", library_max_abs_err=lib_err)
        if dtype == torch.bfloat16 and impl == "matmul":
            rows["warp_translate", n] = dict(
                shape=[n, c, h, w], impl=impl, max_abs_err=err, ms=k_ms,
                host_paced_ms=host_ms, plain_ms=p_ms, bound_ms=bnd,
                bound_by=by, library_ms=l_ms,
                library_host_paced_ms=l_host_ms, timing=DEVICE_TIMING,
            )

    # the warp's backward at the train path's shape (one call per supporting
    # frame, B=8) and at 32 images
    for dtype, n in itertools.product((torch.float32, torch.bfloat16),
                                      (8, 32)):
        c, h, w = 48, 96, 72
        img = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
        offs = (torch.rand(n, 2, generator=gen, device="cuda") * 2 - 1) * 40.0
        offs[0] = torch.tensor([3.0, -2.0])  # an integer translation
        gout = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
        run_k = lambda: warp_translate_backward(img, offs, gout, 26)
        run_p = lambda: warp_translate_backward_plain(img, offs, gout, 26)
        got_b = run_kernel(f"warp_bwd n={n} {dtype}", run_k)
        ref_b = run_p()
        err_i, tol_i = check_close(f"warp_bwd d_images {dtype}", got_b[0],
                                   ref_b[0], dtype)
        # d_offsets: float32 sums of c*h*w products, in another order
        err_o, tol_o = check_close(f"warp_bwd d_offsets {dtype}", got_b[1],
                                   ref_b[1], torch.float32)
        # library yardstick: grid_sample's own backward on a precomputed
        # grid, device-side. It returns the image gradient and a per-pixel
        # grid gradient; the sum of the latter into d_offsets is not in it
        grid = translation_grid(offs, h, w, dtype)
        run_l = lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, img, grid, 0, 0, True, [True, True])
        lib_err = max_err(run_l()[0], ref_b[0])
        # d_offsets is summed in a fixed order: a second call, same bits
        again = run_kernel(f"warp_bwd n={n} {dtype}", run_k)
        if not (torch.equal(again[0], got_b[0])
                and torch.equal(again[1], got_b[1])):
            raise AssertionError(f"warp_bwd n={n} {dtype}: two calls differ")
        host_ms, p_ms = time_ms(run_k), time_ms(run_p)
        k_ms, l_ms = device_ms(run_k), device_ms(run_l)
        cold_ms = device_ms_cold(run_k)
        bnd, by = bound_ms(nbytes(img, offs, gout, *got_b), 30 * img.numel(),
                           dtype)
        emit("kernels", kernel="warp_bwd", dtype=str(dtype)[6:],
             shape=[n, c, h, w], max_shift=26,
             shifts_past_clamp=float((offs.abs() > 26).float().mean()),
             max_abs_err={"d_images": err_i, "d_offsets": err_o},
             tol={"d_images": tol_i, "d_offsets": tol_o}, ms=k_ms,
             cold_ms=cold_ms, host_paced_ms=host_ms,
             timing=DEVICE_TIMING + "; " + COLD_TIMING, deterministic=True,
             plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms,
             library=WARP_BWD_LIBRARY, library_d_images_max_abs_err=lib_err)
        rows["warp_bwd", n, str(dtype)[6:]] = dict(
            shape=[n, c, h, w], dtype=str(dtype)[6:],
            max_abs_err=max(err_i, err_o), ms=k_ms, cold_ms=cold_ms,
            host_paced_ms=host_ms,
            timing=DEVICE_TIMING + "; " + COLD_TIMING, deterministic=True,
            plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms,
            library=WARP_BWD_LIBRARY,
        )
    rows.update(probe_kernel_rows())
    return rows


def launch_floor_ms():
    """One empty kernel's node in a replayed CUDA graph (``device_ms``):
    the least time a launch of one block occupies the card."""
    from fami_pose_torch.ops.cuda.build import check, load_library

    lib = load_library()

    def run():
        check(lib, lib.fami_empty_launch(
            torch.cuda.current_stream().cuda_stream), "fami_empty_launch")

    return device_ms(run)


PROBES = {
    # kernel name: (wrapper's name in ops.probes, kwargs, TPU probe's line,
    # the library call timed beside it)
    "probe_gather_lane": ("gather_lane", {}, 55, "torch.gather(x, 1, idx)"),
    "probe_gather_lane_shfl": ("gather_lane", {"variant": "shfl"}, 55,
                               "torch.gather(x, 1, idx)"),
    "probe_gather_3d": ("gather_3d", {}, 69, "torch.gather(x, 2, idx)"),
    "probe_gather_rows": ("gather_rows", {}, 86, "torch.gather(x, 0, idx)"),
    "probe_dynamic_roll": ("dynamic_roll", {}, 100,
                           "torch.roll(x, 5, 1), the shift a host integer"),
}


def probe_kernel_rows():
    """The on-chip gather / rotate probes at the TPU probes' shapes: each
    kernel against its plain version, bitwise (the outputs are copies of
    input values), timed device-side and host-paced beside the floor of an
    empty launch; the bound is the tile and its indices read once and the
    tile written once. ``gather_rows`` is also timed cold."""
    from fami_pose_torch.ops import probes

    floor = launch_floor_ms()
    emit("kernels", kernel="empty launch", graph_node_floor_ms=floor,
         timing=DEVICE_TIMING)
    rows = {}
    for kernel, (fn_name, kw, _, library) in PROBES.items():
        fn = getattr(probes, fn_name)
        plain = probes.PLAIN[fn]
        cases = ([probes.probe_inputs(fn_name, seed=11, device="cuda", shift=s)
                  for s in (5, 0, 127, 128, -3)]
                 if fn_name == "dynamic_roll"
                 else [probes.probe_inputs(fn_name, seed=11, device="cuda")])
        for args in cases:
            before = fn.launches
            got = run_kernel(kernel, lambda: fn(*args, **kw))
            ref = plain(*args)
            if fn.launches != before + 1:
                raise AssertionError(f"{kernel}: no launch was counted")
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(f"{kernel}: differs from {library}")
        x, other = cases[0]
        run_k = lambda: fn(x, other, **kw)
        if fn_name == "dynamic_roll":  # torch.roll takes a host integer
            run_p = lambda: torch.roll(x, 5, 1)
        else:
            long_idx = other.long()  # torch.gather wants int64 indices
            run_p = lambda: plain(x, long_idx)
        host_ms, p_host_ms = time_ms(run_k), time_ms(run_p)
        k_ms, p_ms = device_ms(run_k), device_ms(run_p)
        bnd, by = bound_ms(nbytes(x, other, got), 0, x.dtype)
        rows[kernel] = dict(
            shape=list(x.shape), dtype=str(x.dtype)[6:], max_abs_err=0.0,
            ms=k_ms, host_paced_ms=host_ms, plain_ms=p_ms, bound_ms=bnd,
            bound_by=by, library_ms=p_ms, library_host_paced_ms=p_host_ms,
            library=library, graph_node_floor_ms=floor, timing=DEVICE_TIMING)
        if kernel == "probe_gather_rows":
            rows[kernel]["cold_ms"] = device_ms_cold(run_k)
            rows[kernel]["timing"] += "; " + COLD_TIMING
        emit("kernels", kernel=kernel, compared="bitwise", **rows[kernel])
    return rows


def profile_call(fn):
    """One call of ``fn`` (a B=8 serving batch, a train step) under
    ``torch.profiler``: the device's busy share (the union of the kernels'
    intervals over the call's host time, both taken under the profiler,
    whose host overhead makes this a lower bound) and the operators with
    the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(prof.key_averages(), key=lambda a: a.self_device_time_total,
                 reverse=True)[:10]
    return dict(
        device_events=len(spans), traced_ms=wall_us / 1e3,
        device_busy_ms=busy / 1e3,
        device_busy_share=busy / wall_us if spans else "not measured",
        top_self_device_ms={a.key[:70]: a.self_device_time_total / 1e3
                            for a in top},
    )


def synthetic_clip(seed=0, t=10, h=480, w=640):
    rs = np.random.RandomState(seed)
    frames = rs.randint(0, 256, size=(t, h, w, 3)).astype(np.uint8)
    boxes = {}
    for i in range(t):
        boxes[i] = [([100.0 + 3 * i, 60.0, 150.0, 300.0], 0.95),
                    ([380.0 - 2 * i, 120.0 + i, 120.0, 260.0], 0.9)]
    return frames, boxes


def check_outputs(records, boxes, aspect, enlarge, heatmap_w):
    """Finite keypoints inside each request's enlarged, aspect-fixed person
    box (the crop region), with one heatmap pixel of slack for the 0.25 px
    shift; scores finite."""
    from fami_pose_torch.utils.bbox import box2cs

    for rec in records:
        kp = np.asarray(rec["keypoints"])
        if kp.shape != (17, 3) or not np.all(np.isfinite(kp)):
            raise AssertionError(f"bad keypoints for frame {rec['frame']}")
        c, s = box2cs(rec["bbox"], aspect, enlarge)
        half = np.asarray(s) * 100.0
        slack = s[0] * 200.0 / heatmap_w
        lo, hi = c - half - slack, c + half + slack
        if not (np.all(kp[:, :2] >= lo) and np.all(kp[:, :2] <= hi)):
            raise AssertionError(
                f"keypoints outside the crop box for frame {rec['frame']}: "
                f"{kp[:, :2].min(0)}..{kp[:, :2].max(0)} vs {lo}..{hi}"
            )


def dcn_on_model_inputs(pred, dev_frames, reqs):
    """``dcn_fwd`` on the model's own inputs: ``dcn_1``'s (x, offset, mask,
    weight) captured by a forward hook in one flip-tested B=8 serving batch
    (the first of its two forwards), the kernel held against its plain
    version on them and timed device-side; the offsets' spread and their
    share past D. Random i.i.d. offsets are the gather's worst case; a
    trained model's are smoother (these are seeded random weights)."""
    from fami_pose_torch.models.fami_pose import DCN_DILATION
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d, deform_conv2d_windowed,
    )

    module = pred.model.dcn_1
    seen = []
    hook = module.register_forward_hook(
        lambda mod, args, out: seen.append(tuple(a.clone() for a in args))
        if not seen else None)
    try:
        pred.predict_batch(dev_frames, reqs)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    x, off, msk = seen[0]
    off, msk = off.to(x.dtype), msk.to(x.dtype)  # as DeformConv.forward
    wgt = module.weight.detach().to(x.dtype)
    d = module.max_offset
    kw = dict(padding=DCN_DILATION, dilation=DCN_DILATION,
              offset_groups=module.offset_groups, max_offset=d)
    run_k = lambda: deform_conv2d_windowed(x, off, msk, wgt, **kw)
    run_p = lambda: deform_conv2d(x, off, msk, wgt, **kw)
    got = run_kernel("dcn_fwd on dcn_1's inputs", run_k)
    err, tol = check_close("dcn_fwd on dcn_1's inputs", got, run_p(), x.dtype)
    k_ms = device_ms(run_k, launches=20)
    p_ms = time_ms(run_p, iters=3, warmup=1)
    bnd, by = dcn_fwd_bound(x, off, msk, wgt, got)
    o = off.float()
    q = torch.quantile(o.abs().flatten()[:: max(1, o.numel() // 2_000_000)],
                       torch.tensor([0.5, 0.9, 0.99], device=o.device))
    return dict(
        layer="dcn_1", shape=list(x.shape), dtype=str(x.dtype)[6:],
        D=d, max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
        bound_by=by, timing=DCN_TIMING,
        offsets_std=float(o.std()), offsets_abs_max=float(o.abs().max()),
        offsets_abs_p50_p90_p99=[float(v) for v in q],
        offsets_past_D=float((o.abs() > d).float().mean()) if d else 0.0,
        mask_abs_max=float(msk.float().abs().max()))


def phase_main():
    import types

    from fami_pose_torch.config import get_cfg
    from fami_pose_torch.engine.predictor import PosePredictor
    from fami_pose_torch.ops.deform_conv import deform_conv2d_windowed
    from fami_pose_torch.ops.warp import warp_translate

    cfg = get_cfg(types.SimpleNamespace(
        cfg=os.path.join(ROOT, "configs/posetrack17/fami_pose.yaml"),
        opts=[], root_dir=ROOT,
    ))
    pred = PosePredictor(cfg, None, device="cuda", flip_test=True,
                         batch_size=8, seed=0)
    frames, boxes = synthetic_clip()
    n_req = sum(len(v) for v in boxes.values())
    n_batches = math.ceil(n_req / 8)
    pred(frames, boxes)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    deform_conv2d_windowed.launches = 0
    warp_translate.launches = 0
    t0 = time.perf_counter()
    records = pred(frames, boxes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dcn_fwd": deform_conv2d_windowed.launches,
                "warp_translate": warp_translate.launches}
    if launches["dcn_fwd"] != 8 * n_batches:
        raise AssertionError(f"DCN launches {launches['dcn_fwd']}, expected "
                             f"8 per flip-tested batch x {n_batches}")
    if launches["warp_translate"] != 2 * n_batches:
        raise AssertionError(f"warp launches {launches['warp_translate']}, "
                             f"expected 2 x {n_batches}")
    if len(records) != n_req:
        raise AssertionError(f"{len(records)} records for {n_req} requests")
    check_outputs(records, boxes, pred.aspect, pred.enlarge,
                  int(cfg.MODEL.HEATMAP_SIZE[0]))

    # one full batch of 8 requests, repeated: device-synchronised host time
    dev_frames = torch.from_numpy(frames).cuda().permute(0, 3, 1, 2)
    reqs = [(fi, b) for fi in range(4) for b, _ in boxes[fi]]
    batch_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred.predict_batch(dev_frames, reqs)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t1) * 1e3)

    # where the time goes in one B=8 batch: crop, forward (x2 with flip:
    # backbone + head), decode
    crop = lambda: pred.crop(dev_frames, reqs)
    crop_ms = time_ms(crop, iters=5, warmup=1)
    kf, sup, _, _ = crop()
    model = pred.model
    with torch.inference_mode():
        x = torch.cat([kf] + list(torch.split(sup, 3, dim=1)), 0)
        x = x.to(model.compute_dtype)
        feat = model.hrnet(x)[1][0]
        fwd_ms = time_ms(lambda: model(kf, sup), iters=10, warmup=2)
        bb_ms = time_ms(lambda: model.hrnet(x), iters=10, warmup=2)
        head_ms = time_ms(lambda: model.head(feat, kf.shape[0]), iters=10,
                          warmup=2)
    trace = profile_call(lambda: pred.predict_batch(dev_frames, reqs))
    model_dcn = dcn_on_model_inputs(pred, dev_frames, reqs)
    emit("kernels", kernel="dcn_fwd", inputs="the model's own", **model_dcn)
    batch = dict(batch8_ms=batch_ms,
                 batch8_clips_per_s=8 / (float(np.median(batch_ms)) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 trace=trace)
    emit("main", config="configs/posetrack17/fami_pose.yaml",
         model="FAMIPose HRNet-W48 384x288 bf16 D=4 num_sup=4 flip_test",
         weights="seeded random init (seed 0)", requests=n_req,
         batches=n_batches, launches=launches,
         run_seconds=wall, latency_ms_per_request=wall / n_req * 1e3,
         clips_per_s=n_req / wall, crop_b8_ms=crop_ms, forward_b8_ms=fwd_ms,
         backbone_b8_ms=bb_ms, head_b8_ms=head_ms, **batch)
    return pred, launches, model_dcn, batch


def phase_card_vs_cpu(pred):
    from fami_pose_torch.engine.steps import make_eval_step

    frames, boxes = synthetic_clip()
    dev_frames = torch.from_numpy(frames).cuda().permute(0, 3, 1, 2)
    kf, sup, _, _ = pred.crop(dev_frames, [(5, boxes[5][0][0])])
    outs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(pred.model).to(dev).float()
        model.compute_dtype = torch.float32
        t0 = time.perf_counter()
        final, _ = make_eval_step(model)(kf.to(dev), sup.to(dev))
        outs[dev] = final.cpu()
        outs[dev + "_s"] = time.perf_counter() - t0
    ref = outs["cpu"]
    err = max_err(outs["cuda"], ref)
    scale = max(1.0, float(ref.abs().max()))
    tol = 1e-3 * scale
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"card vs CPU: max abs diff {err} > {tol}")
    emit("card-vs-cpu", dtype="float32", tf32="off", key_frames=1,
         max_abs_diff=err, tol=tol, heatmap_absmax=float(ref.abs().max()),
         cuda_s=outs["cuda_s"], cpu_s=outs["cpu_s"])


def locked_crops(pred, dev_frames, tracks):
    """Every frame of the clip cropped with each stream's locked box (one
    affine a stream for all its frames) and normalised on the card, as
    ``PosePredictor.crop`` crops a frame: (T, B, 3, h, w) float32, and the
    boxes' centers and scales (B, 2)."""
    from fami_pose_torch.data.loader import normalize
    from fami_pose_torch.ops.warp import crop_and_warp
    from fami_pose_torch.utils.bbox import box2cs

    cs = [box2cs(bbox, pred.aspect, pred.enlarge) for bbox in tracks]
    center = torch.as_tensor(np.stack([c for c, _ in cs]), device="cuda")
    scale = torch.as_tensor(np.stack([s for _, s in cs]), device="cuda")
    b = len(tracks)
    out_hw = (pred.image_size[1], pred.image_size[0])
    rot = torch.zeros(b, device="cuda")
    with torch.inference_mode():
        crops = torch.stack([
            normalize(crop_and_warp(frame.expand(b, -1, -1, -1), center,
                                    scale, rot, out_hw))
            for frame in dev_frames])
    return crops, center, scale


def batch_window(crops, t, span):
    """The batch protocol's (kf, sup) of key frame t on the locked crops:
    supporting frames t - span .. t + span clamped to the clip, in
    ``PosePredictor.window``'s order."""
    n = crops.shape[0]
    sup = [t - d for d in range(span, 0, -1)] + [t + d
                                                 for d in range(1, span + 1)]
    return crops[t], torch.cat([crops[min(max(s, 0), n - 1)] for s in sup],
                               dim=1)


def stream_clip(model, crops, span, calls=None, **kw):
    """Every key frame of the clip through a stream primed with frame 0
    and fed ``span`` more copies of the last frame: (T, B, J, h, w)
    float32. ``calls``, a list, receives the batch size of every backbone
    call the steps make (not the priming's)."""
    from fami_pose_torch.engine.streaming import StreamingPosePredictor

    spred = StreamingPosePredictor(model, distance=span + 1, **kw)
    spred.prime(crops[0])
    calls = [] if calls is None else calls
    hook = model.hrnet.register_forward_hook(
        lambda mod, args, out: calls.append(int(args[0].shape[0])))
    try:
        n = crops.shape[0]
        out = [spred(crops[min(t, n - 1)])[0] for t in range(n + span)]
    finally:
        hook.remove()
    return torch.stack(out[span:])


def steady_stream(model, crops, span, steps=14):
    """A flip-tested stream in its steady state: primed and fed 3 frames,
    then ``steps`` steps each synchronised before and after (ms), and one
    traced step (``profile_call``). Returns the predictor, the ms and the
    trace."""
    from fami_pose_torch.engine.streaming import StreamingPosePredictor

    n = crops.shape[0]
    spred = StreamingPosePredictor(model, distance=span + 1, flip_test=True)
    spred.prime(crops[0])
    for t in range(3):
        spred(crops[t])
    step_ms = []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spred(crops[t % n])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return spred, step_ms, profile_call(lambda: spred(crops[0]))


def keypoint_px(hms, center, scale):
    """Decoded keypoints (T, B, J, 2) in image pixels."""
    from fami_pose_torch.ops.heatmap import get_final_preds

    return torch.stack([get_final_preds(hm, center, scale)[0] for hm in hms])


STREAM_F32_TOL = 1e-4  # of the heatmaps' largest magnitude
STREAM_PX_TOL = 1e-3


def phase_streaming(pred, batch):
    """Streaming serving (``engine/streaming.py``) of the serving config at
    full W48, bf16, flip-test: 8 streams, one a box of frames 0-3 of the
    synthetic clip, crops locked, every frame of the clip fed and every key
    frame emitted. The counted run checks the launches of each streamed
    frame (8 ``dcn_fwd``, 2 ``warp_translate``, no backward) and the
    backbone calls of each step (a forward hook: 2 of B frames with paired
    flip; 1 of 2B with ``flip_batched``, 4 DCN and 1 warp launch). Every
    key frame against the batch protocol (``PosePredictor``'s eval step on
    the same locked crops, windows clamped to the clip as the stream
    clamps): in f32 with TF32 off the heatmaps within STREAM_F32_TOL of
    their scale and the decoded keypoints within STREAM_PX_TOL pixels. In
    bf16 the backbone's convolutions round differently at batch 8 (the
    stream's calls) and 40 (the batch protocol's), and the seeded model
    amplifies a rounding, so the heatmaps are held within the batch
    protocol's own gap between bf16 and f32 (the 1e-3 of the scale that
    card-vs-cpu allows in f32 is printed beside it). Then ms a step
    (synchronised, 14 steps), key frames/s, device-busy ms of one traced
    step and peak memory, beside the batch protocol's on the same crops
    and phase main's."""
    from fami_pose_torch.engine.steps import make_eval_step

    frames, boxes = synthetic_clip()
    tracks = [bbox for fi in range(4) for bbox, _ in boxes[fi]]
    dev_frames = torch.from_numpy(frames).cuda().permute(0, 3, 1, 2)
    crops, center, scale = locked_crops(pred, dev_frames, tracks)
    n, b = crops.shape[:2]
    span = pred.span
    steps = n + span
    model = pred.model

    # the counted run: bf16, paired flip
    stream_clip(model, crops, span, flip_test=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = []
    reset_launches()
    hm_bf16 = stream_clip(model, crops, span, calls=calls, flip_test=True)
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls_batched = []
    reset_launches()
    hm_batched = stream_clip(model, crops, span, calls=calls_batched,
                             flip_test=True, flip_batched=True)
    torch.cuda.synchronize()
    launches_batched = read_launches()

    with torch.inference_mode():
        ref_bf16 = torch.stack([pred.eval_step(*batch_window(crops, t, span))[0]
                                for t in range(n)])
    m32 = copy.deepcopy(model).float()
    m32.compute_dtype = torch.float32
    hm_f32 = stream_clip(m32, crops, span, flip_test=True)
    step32 = make_eval_step(m32, flip_test=True)
    ref_f32 = torch.stack([step32(*batch_window(crops, t, span))[0]
                           for t in range(n)])
    px = keypoint_px(hm_f32, center, scale)
    px_ref = keypoint_px(ref_f32, center, scale)
    px_err = (px - px_ref).abs().amax(dim=-1)  # (T, B, J)
    px_bf16 = (keypoint_px(hm_bf16, center, scale)
               - keypoint_px(ref_bf16, center, scale)).abs().amax(dim=-1)
    # where the two protocols part: the same 40 frames through the
    # backbone in one call (the batch protocol's) and in 5 calls of 8 (the
    # stream's), in each type
    fold_diff = {}
    with torch.inference_mode():
        for m in (model, m32):
            f40 = m.features(crops[:5].flatten(0, 1))[1]
            f8 = torch.cat([m.features(crops[i])[1] for i in range(5)])
            fold_diff[str(f40.dtype)[6:]] = max_err(f8, f40)
    del m32, step32

    def gap(got, ref):
        scale_ = max(1.0, float(ref.abs().max()))
        return max_err(got, ref), scale_

    f32_err, f32_scale = gap(hm_f32, ref_f32)
    bf16_err, bf16_scale = gap(hm_bf16, ref_bf16)
    bf16_own_gap = max_err(ref_bf16, ref_f32)
    interior = slice(span, n - span)
    checks = dict(
        f32_max_abs_diff=f32_err, f32_scale=f32_scale,
        f32_tol=STREAM_F32_TOL * f32_scale,
        f32_interior_max_abs_diff=max_err(hm_f32[interior], ref_f32[interior]),
        f32_keypoints_max_px=float(px_err.max()),
        f32_keypoints_px_tol=STREAM_PX_TOL,
        f32_joints_differing=int((px_err > STREAM_PX_TOL).sum()),
        joints=int(px_err.numel()),
        bf16_max_abs_diff=bf16_err, bf16_scale=bf16_scale,
        bf16_tol=bf16_own_gap,
        bf16_card_vs_cpu_gap=1e-3 * bf16_scale,
        bf16_interior_max_abs_diff=max_err(hm_bf16[interior],
                                           ref_bf16[interior]),
        bf16_keypoints_equal_share=float((px_bf16 <= STREAM_PX_TOL)
                                         .float().mean()),
        backbone_b8_vs_b40_max_abs_diff=fold_diff,
        bf16_vs_f32_stream_max_abs_diff=max_err(hm_bf16, hm_f32),
        batched_vs_paired_max_abs_diff=max_err(hm_batched, hm_bf16),
    )

    # steady state: ms a step, synchronised, and one traced step
    spred, step_ms, trace = steady_stream(model, crops, span)
    state = spred._state
    state_gb = nbytes(state.feats, state.feats_f, state.bb_hms) / 1e9
    with torch.inference_mode():
        bb_hm, feat = model.features(crops[0])
        fold = feat.repeat(1 + model.num_sup, 1, 1, 1)
        features_ms = time_ms(lambda: model.features(crops[0]), iters=10,
                              warmup=2)
        head_ms = time_ms(lambda: model.head_eval(fold, bb_hm), iters=10,
                          warmup=2)
        kf, sup = batch_window(crops, n // 2, span)
        batch_ms = time_ms(lambda: pred.eval_step(kf, sup), iters=5,
                           warmup=1)
    batch_trace = profile_call(lambda: pred.eval_step(kf, sup))
    med = float(np.median(step_ms))
    emit("streaming", config="configs/posetrack17/fami_pose.yaml",
         model="FAMIPose HRNet-W48 384x288 bf16 D=4 num_sup=4 flip_test",
         streams=b, frames=n, steps=steps, crops="locked (one box a stream)",
         launches=launches, launches_per_step={
             k: v / steps for k, v in launches.items()},
         backbone_calls_per_step=len(calls) / steps,
         backbone_call_batch=sorted(set(calls)),
         flip_batched=dict(launches=launches_batched,
                           backbone_calls_per_step=len(calls_batched) / steps,
                           backbone_call_batch=sorted(set(calls_batched))),
         **checks,
         step_ms=step_ms, step_ms_median=med,
         key_frames_per_s=b / (med / 1e3),
         features_b8_ms=features_ms, head_eval_fold40_ms=head_ms,
         trace=trace, peak_mem_gb=peak_gb, state_gb=state_gb,
         batch_protocol=dict(
             eval_step_b8_ms=batch_ms,
             eval_step_key_frames_per_s=b / (batch_ms / 1e3),
             eval_step_device_busy_ms=batch_trace["device_busy_ms"],
             main_batch8_ms_median=float(np.median(batch["batch8_ms"])),
             main_batch8_clips_per_s=batch["batch8_clips_per_s"],
             main_device_busy_ms=batch["trace"]["device_busy_ms"],
             main_peak_mem_gb=batch["peak_mem_gb"]))

    want = {"dcn_fwd": 8 * steps, "warp_translate": 2 * steps, "dcn_bwd": 0,
            "warp_bwd": 0}
    if launches != want:
        raise AssertionError(f"streaming launches {launches}, expected "
                             f"{want} (8 DCN + 2 warp a streamed frame)")
    want_b = dict(want, dcn_fwd=4 * steps, warp_translate=steps)
    if launches_batched != want_b:
        raise AssertionError(f"flip_batched launches {launches_batched}, "
                             f"expected {want_b}")
    if calls != [b] * (2 * steps) or calls_batched != [2 * b] * steps:
        raise AssertionError(f"backbone calls {calls} / {calls_batched}: "
                             f"expected 2 of {b} / 1 of {2 * b} a step")
    if not (math.isfinite(f32_err) and f32_err <= STREAM_F32_TOL * f32_scale):
        raise AssertionError(f"stream vs batch protocol, f32: {f32_err}")
    if not float(px_err.max()) <= STREAM_PX_TOL:
        raise AssertionError(f"keypoints differ by {float(px_err.max())} px")
    if not (math.isfinite(bf16_err) and bf16_err <= bf16_own_gap):
        raise AssertionError(f"stream vs batch protocol, bf16: {bf16_err} "
                             f"past the batch protocol's own bf16-vs-f32 "
                             f"gap {bf16_own_gap}")
    return launches, dict(step_ms_median=med, key_frames_per_s=b / (med / 1e3),
                          device_busy_ms=trace["device_busy_ms"],
                          peak_mem_gb=peak_gb)


KERNEL_COUNTERS = ("dcn_fwd", "dcn_bwd", "warp_translate", "warp_bwd")
INT8_COUNTERS = ("int8_quant_nhwc", "int8_implicit_gemm")


def kernel_counters():
    """The wrappers that hold a launch count, by kernel name: the four of
    the float paths, then the int8 conv's two."""
    from fami_pose_torch.ops import kernel_wrappers

    wrappers = kernel_wrappers()
    return {k: wrappers[k] for k in KERNEL_COUNTERS + INT8_COUNTERS}


def reset_launches():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches(names=KERNEL_COUNTERS):
    counters = kernel_counters()
    return {name: counters[name].launches for name in names}


class SyntheticPoseDataset:
    """Seeded stand-in for a pose dataset: uint8 noise crops with a bright
    5x5 mark on every visible joint, random joints, ~85% of them visible.
    Gives the sample dict ``fami_pose_torch.data.loader.collate`` reads."""

    def __init__(self, n, image_size, num_sup, num_joints=17, seed=0):
        w, h = image_size
        rs = np.random.RandomState(seed)
        self.frames = rs.randint(0, 200, size=(n, h, w, 3 * (1 + num_sup)),
                                 dtype=np.uint8)
        self.joints = (rs.rand(n, num_joints, 2) * [w - 9, h - 9] + 4).astype(
            np.float32)
        self.vis = (rs.rand(n, num_joints) < 0.85).astype(np.float32)
        for i in range(n):
            for (x, y), v in zip(self.joints[i].astype(int), self.vis[i]):
                if v:
                    self.frames[i, y - 2:y + 3, x - 2:x + 3] = 255

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return {
            "kf": self.frames[i, :, :, :3], "sup": self.frames[i, :, :, 3:],
            "joints": self.joints[i], "joints_vis": self.vis[i],
            "center": np.zeros(2, np.float32), "scale": np.ones(2, np.float32),
            "rotation": np.float32(0), "score": np.float32(1),
            "image_path": f"synthetic/{i:06d}.jpg",
        }


def train_cfg(out_dir, *opts):
    import types

    from fami_pose_torch.config import get_cfg

    return get_cfg(types.SimpleNamespace(
        cfg=os.path.join(ROOT, "configs/posetrack17/fami_pose.yaml"),
        opts=["OUTPUT_DIR", out_dir, *opts], root_dir=ROOT,
    ))


GRAD_GROUPS = {
    "dcn weights": tuple(f"dcn_{i}.weight" for i in range(1, 5)),
    "offset convs": tuple(f"dcn_offset_{i}.conv.weight" for i in range(1, 5)),
    "mask convs": tuple(f"dcn_mask_{i}.conv.weight" for i in range(1, 5)),
    "offset head": ("feat_global_offset_layers.0.layers.0.conv1.weight",
                    "feat_global_offset_layers.8.weight"),
    "backbone stem": ("hrnet.conv1.weight",),
}


def check_gradients(model, exempt=()):
    """Every parameter's gradient finite; those of the named groups (the
    DCN weights, the offset and mask convs, the offset head and the
    backbone's stem), but the ``exempt`` names, with non-zero norm. Returns
    the norms of the named groups."""
    grads = {n: p.grad for n, p in model.named_parameters()}
    missing = [n for n, g in grads.items() if g is None]
    if missing:
        raise AssertionError(f"no gradient for {missing[:5]} "
                             f"({len(missing)} parameters)")
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"non-finite gradient in {bad[:5]}")
    norms = {}
    for group, names in GRAD_GROUPS.items():
        for n in names:
            # float64: a float32 norm squares entries under ~1e-19 to 0
            norms[n] = float(grads[n].double().norm())
            if n not in exempt and not norms[n] > 0.0:
                raise AssertionError(f"zero gradient for {n} ({group})")
    return norms


def dcn_bwd_on_model_inputs(trainer, state, batch):
    """``dcn_bwd`` on the model's own inputs and gradient: ``dcn_1``'s (x,
    offset, mask, weight) and the gradient of its output captured during
    one bf16 train step (``dcn_stage_inputs``), the kernel held
    against its plain version on them and timed device-side; the offsets'
    spread and their share past D."""
    from fami_pose_torch.models.fami_pose import DCN_DILATION
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d_backward, deform_conv2d_backward_plain,
    )

    module = state.model.dcn_1
    x, off, msk, wgt, raw_gout = dcn_stage_inputs(trainer, state, batch)[0]
    # as DeformConv.forward hands them to the kernel
    off, msk, wgt = off.to(x.dtype), msk.to(x.dtype), wgt.to(x.dtype)
    # the seeded model's gradient at dcn_1 is tiny (~1e-17): scaled by a
    # power of two to a largest entry in [1, 2), exactly in bf16 (the
    # gradients are linear in it), so that the tolerances, 2^-7 of the
    # larger of 1 and each gradient's scale, bound something
    raw_max = float(raw_gout.float().abs().max())
    if not raw_max > 0:
        raise AssertionError(f"dcn_1's output gradient is {raw_max}")
    exponent = -math.floor(math.log2(raw_max))
    gout = raw_gout * 2.0 ** exponent
    d = module.max_offset
    kw = dict(padding=DCN_DILATION, dilation=DCN_DILATION,
              offset_groups=module.offset_groups, max_offset=d)
    run_k = lambda: deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
    run_p = lambda: deform_conv2d_backward_plain(x, off, msk, wgt, gout, **kw)
    got = run_kernel("dcn_bwd on dcn_1's inputs", run_k)
    errs = {name: check_close(f"dcn_bwd {name} on dcn_1's inputs", a, r,
                              x.dtype)
            for name, a, r in zip(("dx", "doffset", "dmask", "dweight"),
                                  got, run_p())}
    k_ms = device_ms(run_k, launches=20)
    p_ms = time_ms(run_p, iters=3, warmup=1)
    bnd, by = dcn_bwd_bound(x, off, msk, wgt, gout, got)
    o = off.float()
    q = torch.quantile(o.abs().flatten()[:: max(1, o.numel() // 2_000_000)],
                       torch.tensor([0.5, 0.9, 0.99], device=o.device))
    return dict(
        layer="dcn_1", shape=list(x.shape), dtype=str(x.dtype)[6:], D=d,
        max_abs_err={k: e for k, (e, _) in errs.items()},
        tol={k: t for k, (_, t) in errs.items()}, ms=k_ms, plain_ms=p_ms,
        bound_ms=bnd, bound_by=by, timing=DCN_TIMING,
        gout_abs_max=raw_max, gout_scaled_by=f"2^{exponent}",
        offsets_std=float(o.std()), offsets_abs_max=float(o.abs().max()),
        offsets_abs_p50_p90_p99=[float(v) for v in q],
        offsets_past_D=float((o.abs() > d).float().mean()) if d else 0.0,
        mask_abs_max=float(msk.float().abs().max()))


def repeat_train_steps(trainer, state, batch, steps=3):
    """``steps`` train steps on ``batch``, twice from one state (its host
    copy loaded again in between): every tensor of the state after them
    (parameters, BatchNorm statistics, Adam moments and steps, the
    scheduler) must be equal bit for bit in the two runs: the step's
    kernels sum in a fixed order, and it pins cuDNN's deterministic
    algorithms."""
    from fami_pose_torch.engine.checkpoints import _to_host

    start = _to_host(state.state_dict())
    ends = []
    for _ in range(2):
        # a fresh copy each time: the optimizer keeps the loaded step
        # tensors (on the host) as they are and counts them up in place
        state.load_state_dict(_to_host(start))
        for _ in range(steps):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        ends.append(_to_host(state.state_dict()))
    l2, differ, n = state_distance(ends[0], ends[1])
    moved = state_distance(ends[0]["model"], start["model"])[0]
    out = dict(steps=steps, state_tensors=n, differing=differ, l2=l2,
               steps_move_l2=moved, rule="bit for bit")
    if differ or not moved > 0:
        raise AssertionError(f"two {steps}-step runs from one state: {out}")
    return out


def phase_train(smi, batch=8, epoch_steps=4, timed_steps=2, split_steps=2,
                fixed_steps=8):
    import tempfile

    from fami_pose_torch.engine.trainer import Trainer
    from fami_pose_torch.losses import fami_total_loss

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as out_dir:
        cfg = train_cfg(out_dir, "TRAIN.BATCH_SIZE_PER_GPU", batch,
                        "TRAIN.END_EPOCH", 1, "PRINT_FREQ", 1, "WORKERS", 4)
        image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
        num_sup = 2 * (int(cfg.DISTANCE) - 1)
        dataset = SyntheticPoseDataset(batch * epoch_steps, image_size,
                                       num_sup, int(cfg.MODEL.NUM_JOINTS))
        trainer = Trainer(cfg, dataset=dataset, device="cuda")
        if trainer.begin_epoch != 0 or trainer.steps_per_epoch != epoch_steps:
            raise AssertionError("fresh trainer expected")

        # the main path: one epoch through Trainer.train (its first step
        # warms up cuDNN and the allocator), then the checkpoint it wrote
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = read_launches()
        for name, count in launches.items():
            if count != 4 * epoch_steps:
                raise AssertionError(
                    f"{name}: {count} launches over {epoch_steps} train "
                    f"steps, expected 4 a step")
        if state.step != epoch_steps:
            raise AssertionError(f"step counter {state.step}")

        resumed = Trainer(cfg, dataset=dataset, device="cuda")
        if resumed.begin_epoch != 1 or resumed.state.step != state.step:
            raise AssertionError(
                f"resume: epoch {resumed.begin_epoch}, step "
                f"{resumed.state.step}, expected 1 and {state.step}")
        ours, theirs = state.model.state_dict(), resumed.model.state_dict()
        differ = [k for k in ours if not torch.equal(ours[k], theirs[k])]
        if differ or len(ours) != len(theirs):
            raise AssertionError(f"resume changed {differ[:5]}")
        opt_a = state.optimizer.state_dict()["state"]
        opt_b = resumed.state.optimizer.state_dict()["state"]
        for i in opt_a:
            if not torch.equal(opt_a[i]["exp_avg"], opt_b[i]["exp_avg"]):
                raise AssertionError(f"resume changed Adam moment {i}")
        resumed_note = (
            f"epoch_0_state.ckpt written; resume gave epoch "
            f"{resumed.begin_epoch}, step {resumed.state.step}, identical "
            f"parameters and Adam moments")
        del resumed, theirs, opt_b
        torch.cuda.empty_cache()
        # peak memory from here on: one trainer, its Adam moments in place
        torch.cuda.reset_peak_memory_stats()

        # timed steps: the trainer's own step (forward, loss, backward, Adam,
        # scheduler, the six PCK passes) on the loader's batches in turn,
        # each from one device synchronisation to the next
        raws = list(trainer.loader)
        step_ms, prepare_ms = [], []
        for i in range(timed_steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch_t = trainer.prepare(raws[i % len(raws)])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            trainer.train_step(state, batch_t)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t2) * 1e3)
            prepare_ms.append((t2 - t1) * 1e3)

        # a per-layer reading, not the step's time: the step's parts written
        # out here (no PCK passes, no step counter) between CUDA events
        model, opt = state.model, state.optimizer
        marks = []
        for i in range(split_steps):
            batch_t = trainer.prepare(raws[i % len(raws)])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            ev[0].record()
            final, sup_hms, _, mi = model(batch_t["kf"], batch_t["sup"],
                                          train=True)
            total, _ = fami_total_loss(
                final, sup_hms, mi, batch_t["target"],
                batch_t["target_weight"],
                mse_weight=float(cfg.LOSS.HEATMAP_MSE.WEIGHT))
            ev[1].record()
            opt.zero_grad(set_to_none=True)
            total.backward()
            ev[2].record()
            opt.step()
            state.scheduler.step()
            ev[3].record()
            torch.cuda.synchronize()
            marks.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
        split = np.median(np.asarray(marks), axis=0)

        # 8 steps of the trainer's own step on one fixed batch
        fixed = trainer.prepare(raws[0])
        history = []
        reset_launches()
        for _ in range(fixed_steps):
            _, metrics = trainer.train_step(state, fixed)
            history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        fixed_launches = read_launches()
        if any(c != 4 * fixed_steps for c in fixed_launches.values()):
            raise AssertionError(f"fixed-batch launches {fixed_launches}")
        for i, rec in enumerate(history):
            bad = [k for k, v in rec.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"step {i}: non-finite {bad}")
        norms = check_gradients(model)
        repeat = repeat_train_steps(trainer, state, fixed)
        # the same two runs with the exact DCN (TPU.DCN_MAX_OFFSET 0: no
        # clamp, dx from the sources sorted by target pixel), a trainer of
        # its own on the same batch
        exact_trainer = Trainer(
            train_cfg(os.path.join(out_dir, "exact"),
                      "TRAIN.BATCH_SIZE_PER_GPU", batch, "TRAIN.END_EPOCH",
                      1, "PRINT_FREQ", 1, "WORKERS", 4, "TPU.DCN_MAX_OFFSET",
                      0), dataset=dataset, device="cuda")
        windows = {getattr(exact_trainer.state.model, f"dcn_{i}").max_offset
                   for i in range(1, 5)}
        if windows != {None}:
            raise AssertionError(f"TPU.DCN_MAX_OFFSET 0 built windows "
                                 f"{windows}")
        reset_launches()
        repeat_exact = repeat_train_steps(
            exact_trainer, exact_trainer.state, exact_trainer.prepare(raws[0]))
        torch.cuda.synchronize()
        exact_launches = read_launches()
        if any(c != 4 * 2 * repeat_exact["steps"]
               for c in exact_launches.values()):
            raise AssertionError(f"exact-mode launches {exact_launches}")
        del exact_trainer
        torch.cuda.empty_cache()
        trace = profile_call(lambda: trainer.train_step(state, fixed))
        model_dcn_bwd = dcn_bwd_on_model_inputs(trainer, state, fixed)
        emit("kernels", kernel="dcn_bwd", inputs="the model's own",
             **model_dcn_bwd)
        first, last = history[0]["loss_mse"], history[-1]["loss_mse"]
        if not last < first:
            raise AssertionError(
                f"loss_mse did not fall on the fixed batch: {first} -> {last}")
        med = float(np.median(step_ms))
        emit("train", config="configs/posetrack17/fami_pose.yaml",
             model="FAMIPose HRNet-W48 384x288 bf16 D=4 num_sup=4, train mode",
             card=smi, batch_size=batch,
             batch_size_note="the file's TRAIN.BATCH_SIZE_PER_GPU is 48 per "
             "GPU of the reference's host; cut to 8 for one card's smoke",
             optimizer=f"{cfg.TRAIN.OPTIMIZER} lr {cfg.TRAIN.LR}",
             weights=f"seeded init (seed {int(cfg.SEED)}) + reference head "
             "init", dataset=f"{len(dataset)} seeded synthetic samples",
             epoch_steps=epoch_steps, epoch_seconds=epoch_s,
             launches=launches, launches_per_step=4,
             step_ms_median=med, step_ms_min=min(step_ms),
             step_ms_max=max(step_ms), samples_per_s=batch / (med / 1e3),
             step_timed="trainer.train_step(state, batch), synchronised "
             "before and after", timed_steps=timed_steps,
             prepare_ms_median=float(np.median(prepare_ms)),
             split_forward_ms=float(split[0]),
             split_backward_ms=float(split[1]),
             split_optimizer_ms=float(split[2]),
             split_note=f"median of {split_steps} steps written out in the "
             "script between CUDA events, without the step's PCK passes: a "
             "per-layer reading, not the step's time",
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             peak_mem_note="after the epoch and the resume check: timed, "
             "split, fixed-batch and traced steps of one trainer",
             fixed_batch_loss_mse=[r["loss_mse"] for r in history],
             fixed_batch_loss=[r["loss"] for r in history],
             last_step_terms=history[-1], grad_norms=norms, trace=trace,
             checkpoint=resumed_note,
             two_three_step_runs_from_one_state=repeat,
             two_three_step_runs_exact_dcn=dict(
                 repeat_exact, launches=exact_launches))
    return launches, model_dcn_bwd, exact_launches


def train_grads(model, batch, feat=None):
    """Loss terms and gradients of one train-mode forward and backward: the
    whole model on ``batch``, or with ``feat`` (backbone features, key frames
    first) only the head, whose gradient with respect to ``feat`` is
    returned under the name ``feat``."""
    from fami_pose_torch.losses import fami_total_loss

    if feat is None:
        final, sup_hms, _, mi = model(batch["kf"], batch["sup"], train=True)
    else:
        feat = feat.clone().requires_grad_()
        final, sup_hms, mi = model.head(feat, batch["kf"].shape[0])
    total, aux = fami_total_loss(final, sup_hms, mi, batch["target"],
                                 batch["target_weight"])
    model.zero_grad(set_to_none=True)
    total.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    if feat is not None:
        grads["feat"] = feat.grad.cpu()
    return {k: float(v.detach()) for k, v in aux.items()}, grads


def grad_errors(got, ref):
    """Per-tensor max abs difference over the reference's largest entry,
    and the relative L2 error of all gradients taken as one vector."""
    rel = {}
    num = den = 0.0
    for n, r in ref.items():
        diff = (got[n] - r).double()
        num += float(diff.square().sum())
        den += float(r.double().square().sum())
        rel[n] = float(diff.abs().max()) / max(float(r.abs().max()), 1e-30)
    return rel, math.sqrt(num / den)


# Relative L2 distance allowed between the card's and the CPU's float32
# gradient of the whole model. On an H100 host the CPU's own gradient moved
# 3.1-4.8% under 1e-6 input noise over four seeds and 9.2% under 1e-5
# (PERF.md, Findings): the limit lies above the first and below the second.
# The noise runs are printed beside the card's distance, not compared.
WHOLE_GRAD_L2_LIMIT = 0.08
NOISE_SEEDS = (2, 3, 4, 5)
BACKBONE_F64_TOL = 1e-6


def backbone_f64_grads(hrnet, frames, cotangents, device):
    """Gradients of the float64 backbone under fixed cotangents on its
    heatmaps and first-branch features."""
    net = copy.deepcopy(hrnet).double().to(device).train()
    hm, feats = net(frames.double().to(device))
    net.zero_grad(set_to_none=True)
    torch.autograd.backward([hm, feats[0]],
                            [c.to(device) for c in cotangents])
    return {n: p.grad.detach().cpu() for n, p in net.named_parameters()}


def phase_train_card_vs_cpu():
    """One train-mode forward and backward in f32 (TF32 off) at full W48
    width, 256x192, B=2, seeded weights, the card against the port on the
    CPU (plain kernels), twice:

    * the head alone on the same backbone features (offset head, 4 warps,
      4 DCN stages, fusion, MI terms: every kernel of the train path, 4
      launches each): every loss term within 1e-3 of itself (plus 1e-4
      absolute: the MI terms are ~1e-4 and pass through a temperature-0.05
      softmax); every gradient, the features' included, within 1% of its
      own largest entry or 1e-4 of the largest gradient of all (sums in
      another order, BatchNorm over as few as 8 values in the offset
      head);
    * the backbone alone in float64 on both devices, under one seeded
      cotangent on its two outputs: every gradient within 1e-6 of its own
      largest entry. In float64 the two devices' rounding (1e-16) stays far
      from any ReLU's switching point, so this bound holds per tensor. With
      the head's gradient with respect to the features (bounded above), it
      bounds the chain through the whole model;
    * the whole model in float32: the loss terms as above; every gradient
      finite; all gradients, taken as one vector, within a relative L2
      error of ``WHOLE_GRAD_L2_LIMIT``. No per-parameter bound is set in
      float32: the gradient of this randomly initialised network is not a
      continuous function of its inputs at float32 resolution (ReLU masks
      flip under rounding differences of 1e-7, and ~300 train-mode
      BatchNorms carry each flip on), on the CPU alone as between card and
      CPU. To show that, the CPU's own gradient is taken again with noise
      of 1e-6 on its inputs from ``NOISE_SEEDS`` and of 1e-5 from the first
      of them, and the changes are printed beside the card's distance.
    """
    from fami_pose_torch.data.loader import prepare_train_batch
    from fami_pose_torch.models.bridge import init_weights
    from fami_pose_torch.models.fami_pose import FAMIPose

    cfg = train_cfg("", "MODEL.IMAGE_SIZE", "[192, 256]",
                    "MODEL.HEATMAP_SIZE", "[48, 64]",
                    "TPU.COMPUTE_DTYPE", "float32")
    image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(int(v) for v in cfg.MODEL.HEATMAP_SIZE)
    num_sup = 2 * (int(cfg.DISTANCE) - 1)
    data = SyntheticPoseDataset(2, image_size, num_sup, seed=1)
    base = init_weights(FAMIPose.from_config(cfg), seed=0).train()
    host_batch = prepare_train_batch(
        np.stack([data[i]["kf"] for i in range(2)]),
        np.stack([data[i]["sup"] for i in range(2)]),
        data.joints, data.vis, int(cfg.MODEL.SIGMA), image_size,
        heatmap_size, device="cpu")
    with torch.no_grad():
        frames = torch.cat([host_batch["kf"]]
                           + list(torch.split(host_batch["sup"], 3, dim=1)))
        bb_hm, (feat, *_) = copy.deepcopy(base.hrnet)(frames)

    out = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(dev)
        batch = {k: v.to(dev) for k, v in host_batch.items()}
        reset_launches()
        t0 = time.perf_counter()
        head = train_grads(model, batch, feat.to(dev))
        head_launches = read_launches()
        whole = train_grads(model, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = dict(head=head, whole=whole, head_launches=head_launches,
                        launches=read_launches(),
                        seconds=time.perf_counter() - t0)
    # how far the CPU's own float32 gradient moves under input noise of a
    # few float32 ulps of the O(1) normalized pixels (`model` and `batch`
    # are the CPU's here)
    def cpu_change(seed, eps):
        noise = torch.Generator().manual_seed(seed)
        jittered = dict(batch)
        for k in ("kf", "sup"):
            jittered[k] = batch[k] + eps * torch.randn(batch[k].shape,
                                                       generator=noise)
        ref = out["cpu"]["whole"][1]
        got = train_grads(model, jittered)[1]
        floor = 1e-6 * max(float(g.abs().max()) for g in ref.values())
        worst = max(float((got[n] - r).norm() / r.norm())
                    for n, r in ref.items() if float(r.abs().max()) > floor)
        return grad_errors(got, ref)[1], worst

    noise_l2, noise_worst = zip(*(cpu_change(seed, 1e-6)
                                  for seed in NOISE_SEEDS))
    noise_l2_tenfold, _ = cpu_change(NOISE_SEEDS[0], 1e-5)

    # the backbone in float64, card against CPU, per tensor
    cot_gen = torch.Generator().manual_seed(3)
    cots = [torch.randn(t.shape, generator=cot_gen, dtype=torch.float64)
            / t.numel() ** 0.5 for t in (bb_hm, feat)]
    t0 = time.perf_counter()
    bb_ref = backbone_f64_grads(base.hrnet, frames, cots, "cpu")
    bb_cpu_s = time.perf_counter() - t0
    bb_got = backbone_f64_grads(base.hrnet, frames, cots, "cuda")
    bb_rel, bb_l2 = grad_errors(bb_got, bb_ref)
    bb_scale = max(float(g.abs().max()) for g in bb_ref.values())
    bb_sized = {n: v for n, v in bb_rel.items()
                if float(bb_ref[n].abs().max()) > 1e-6 * bb_scale}
    bb_worst = max(bb_sized, key=bb_sized.get)
    if not (bb_sized[bb_worst] <= BACKBONE_F64_TOL
            and len(bb_sized) >= 0.9 * len(bb_ref)):
        raise AssertionError(
            f"float64 backbone: gradient of {bb_worst} differs by "
            f"{bb_sized[bb_worst]} of its largest entry "
            f"({len(bb_sized)} of {len(bb_ref)} tensors compared)")
    if (any(c != 4 for c in out["cuda"]["head_launches"].values())
            or any(c != 8 for c in out["cuda"]["launches"].values())):
        raise AssertionError(f"card launches {out['cuda']['launches']}")
    if any(out["cpu"]["launches"].values()):
        raise AssertionError("the CPU path launched a kernel")

    report = {}
    for part in ("head", "whole"):
        (got_t, got_g), (ref_t, ref_g) = out["cuda"][part], out["cpu"][part]
        term_err = max(abs(got_t[k] - ref_t[k]) / (abs(ref_t[k]) + 1e-4)
                       for k in ref_t)
        if not term_err <= 1e-3:
            raise AssertionError(f"{part}: loss terms {got_t} vs {ref_t}")
        if set(got_g) != set(ref_g):
            raise AssertionError(f"{part}: gradients of different parameters")
        bad = [n for n, g in got_g.items()
               if not bool(torch.isfinite(g).all())]
        if bad:
            raise AssertionError(f"{part}: non-finite gradient in {bad[:5]}")
        rel, l2 = grad_errors(got_g, ref_g)
        g_scale = max(float(g.abs().max()) for g in ref_g.values())
        if part == "head":
            for n, r in ref_g.items():
                err = rel[n] * float(r.abs().max())
                tol = max(1e-2 * float(r.abs().max()), 1e-4 * g_scale)
                if not err <= tol:
                    raise AssertionError(
                        f"head: gradient of {n}: max abs diff {err} > {tol}")
        elif not l2 <= WHOLE_GRAD_L2_LIMIT:
            raise AssertionError(
                f"whole model: gradient L2 error {l2} > "
                f"{WHOLE_GRAD_L2_LIMIT}; the CPU gradient's own changes "
                f"under input noise: {list(noise_l2)}")
        # a conv bias before a train-mode BatchNorm has a gradient of exactly
        # zero: its entries are rounding noise, left out of the statistics
        sized = sorted((v, n) for n, v in rel.items()
                       if float(ref_g[n].abs().max()) > 1e-6 * g_scale)
        report[part] = dict(
            loss_terms_cpu=ref_t, loss_terms_max_rel_diff=term_err,
            gradients=len(ref_g),
            grad_absmax=g_scale, grad_rel_l2_err=l2,
            grad_rel_err_median=sized[len(sized) // 2][0],
            grad_rel_err_max=sized[-1][0], grad_rel_err_max_at=sized[-1][1])
    emit("train-card-vs-cpu", dtype="float32", tf32="off",
         model="FAMIPose HRNet-W48 256x192 D=4 num_sup=4", batch_size=2,
         loss_term_tol="1e-3 relative + 1e-4 absolute, each term",
         head_tol="per gradient: 1% of its largest entry or 1e-4 of the "
         "largest gradient", whole_tol="relative L2 of all gradients <= "
         f"{WHOLE_GRAD_L2_LIMIT}",
         head=report["head"], whole=report["whole"],
         whole_cpu_grad_rel_l2_change_under_input_noise=dict(
             noise=1e-6, seeds=list(NOISE_SEEDS), changes=list(noise_l2),
             worst_tensor_rel_l2=list(noise_worst),
             tenfold_noise=1e-5, tenfold_change=noise_l2_tenfold),
         backbone_float64=dict(
             tol=f"{BACKBONE_F64_TOL} of each gradient's largest entry",
             gradients=len(bb_ref), compared=len(bb_sized),
             grad_rel_l2_err=bb_l2, grad_rel_err_max=bb_sized[bb_worst],
             grad_rel_err_max_at=bb_worst, cpu_s=bb_cpu_s),
         card_launches=out["cuda"]["launches"],
         cuda_s=out["cuda"]["seconds"], cpu_s=out["cpu"]["seconds"])


# -- phase train-levers ---------------------------------------------------------

# of the val fixture's 36 frames, the first 16 are the train split: 32
# people, 4 steps of 8
LEVERS_TRAIN_IMAGES = 16
LEVERS_STEPS = 4
LEVERS_TIMED_STEPS = 1
# the rule for a bf16 gradient tensor against a reference's
# (tests/test_torch_train_levers.py holds the port against JAX with it, and
# phase train-levers the card against the port on the CPU): a tensor is held
# where the reference's own gap to the f32 step is at most BF16_TAME of the
# f32 gradient (L2), and there |got - ref| <= BF16_CROSS |ref - f32| +
# BF16_SCALE |f32|; the same bound holds the loss terms, and the running
# statistics in max-abs with the f32 step's move for scale. The step runs on
# tame weights (tame_weights), where a bf16 step is not chaotic; BF16_HELD
# must be held, and a fault planted in any of them must break the rule there
BF16_TAME = 0.2
BF16_CROSS = 3.0
BF16_SCALE = 2.0 ** -6
BF16_HELD = ("dcn_1.weight", "dcn_offset_1.conv.weight",
             "dcn_mask_1.conv.weight", "feat_global_offset_layers.8.weight",
             "hrnet.conv1.weight")


def bf16_rule(got, ref, f32):
    """The per-tensor rule of ``got``'s bf16 gradients against ``ref``'s:
    the tensors held (``ref``'s own gap to ``f32`` at most ``BF16_TAME`` of
    the f32 gradient, in L2), those of them that break ``|got - ref| <=
    BF16_CROSS |ref - f32| + BF16_SCALE |f32|``, and each held tensor's
    ``|got - ref|`` over that bound."""
    held, broken, ratios = [], [], {}
    for n, f in f32.items():
        f = f.double()
        size = float(f.norm())
        own = float((ref[n].double() - f).norm())
        if size == 0 or own > BF16_TAME * size:
            continue
        held.append(n)
        ratios[n] = float((got[n].double() - ref[n].double()).norm()) / (
            BF16_CROSS * own + BF16_SCALE * size)
        if ratios[n] > 1.0:
            broken.append(n)
    return held, broken, ratios


def planted_faults(got, ref, f32):
    """``bf16_rule`` on ``got`` with one held ``BF16_HELD`` tensor
    doubled, zeroed or sign-flipped at a time: the ratio each fault reaches,
    and the faults that did not break the rule there alone."""
    reached, missed = {}, []
    held = bf16_rule(got, ref, f32)[0]
    for name in (n for n in BF16_HELD if n in held):
        for fault in (2.0, 0.0, -1.0):
            planted = dict(got, **{name: fault * got[name]})
            _, broken, ratios = bf16_rule(planted, ref, f32)
            reached[f"{name} x {fault}"] = ratios.get(name)
            if broken != [name]:
                missed.append((name, fault, broken[:3]))
    return reached, missed


def residual_closers(model):
    """The BatchNorms whose output is added to a shortcut before a ReLU:
    each residual block's last (a bottleneck's ``bn3``, a basic block's
    ``bn2``) and the last of each HRNet fuse path."""
    from fami_pose_torch.models.layers import BatchNorm

    names, last = set(), {}
    for name, module in model.named_modules():
        if not isinstance(module, BatchNorm):
            continue
        if "fuse_layers." in name:
            head, tail = name.split("fuse_layers.")
            steps = tail.split(".")
            path = head + ".".join(steps[:2])
            step = int(steps[2]) if len(steps) == 4 else -1
            if step >= last.get(path, (-2, None))[0]:
                last[path] = (step, name)
        elif name.endswith(".bn3") or (name.endswith(".bn2")
                                       and ".layer1." not in name
                                       and name != "hrnet.bn2"):
            names.add(name)
    return names | {name for _, name in last.values()}


@torch.no_grad()
def tame_weights(model, seed=0):
    """Seeded weights (``init_weights``) on which a bf16 step is not
    chaotic (``tests/test_torch_train_levers.py::tame_variables`` is the
    CPU test's): every BatchNorm's scale 0.1 and shift 0.4 (each +-10%), so
    every ReLU after one passes (4 standard deviations above 0); the
    residual closers' (``residual_closers``) scale 0.05 and shift 0, so a
    shortcut's mean does not pile up block after block (a conv's weight
    gradient over an input whose mean is many times its spread cancels, and
    cuDNN's bf16 one then strays from f32 several times as far as the CPU
    library's); and every conv and linear kernel outside the backbone, or
    of its final layer, at half size (the DCNs' own as they are)."""
    from fami_pose_torch.models.bridge import init_weights
    from fami_pose_torch.models.layers import BatchNorm

    init_weights(model, seed)
    closers = residual_closers(model)
    gen = torch.Generator().manual_seed(int(seed) + 3)
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            closer = name in closers
            for p, centre in ((module.weight, 0.05 if closer else 0.1),
                              (module.bias, 0.0 if closer else 0.4)):
                p.copy_(centre * (1 + 0.1 * torch.randn(p.shape,
                                                        generator=gen)))
        elif isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)) and (
                not name.startswith("hrnet.")
                or name.startswith("hrnet.final_layer")):
            module.weight.mul_(0.5)
    return model


def levers_cfg(root, dirs, *opts):
    """The full-width config on the fixture's train split, B=8, one epoch of
    ``LEVERS_STEPS`` steps."""
    json_dir, img_dir, _ = dirs
    return train_cfg(os.path.join(root, "out"), "DATASET.JSON_DIR", json_dir,
                     "DATASET.IMG_DIR", img_dir, "DATASET.TEST_IMG_DIR",
                     img_dir, "TRAIN.BATCH_SIZE_PER_GPU", 8,
                     "TRAIN.END_EPOCH", 1, "PRINT_FREQ", 1, "WORKERS", 4,
                     *opts)


def write_reference_files(model, root):
    """The model's weights as the reference saves them: a backbone-only
    ``pose_hrnet_w48.pth`` (bare HRNet names under ``module.``, in a
    ``state_dict`` wrapper) and a full ``Alignment_V15`` ``epoch_20_state.pth``
    (``{begin_epoch, state_dict, optimizer}``), both with BatchNorm
    ``num_batches_tracked`` counters. Returns the two paths and the
    weights on the CPU."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    def with_counters(items):
        out = {}
        for k, v in items:
            out[k] = v
            if k.endswith("running_var"):
                out[k[:-len("running_var")] + "num_batches_tracked"] = \
                    torch.tensor(1000)
        return out

    backbone = with_counters((k[len("hrnet."):], v) for k, v in sd.items()
                             if k.startswith("hrnet."))
    bb_path = os.path.join(root, "pose_hrnet_w48.pth")
    torch.save({"state_dict": {"module." + k: v
                               for k, v in backbone.items()}}, bb_path)
    full_path = os.path.join(root, "epoch_20_state.pth")
    torch.save({"begin_epoch": 20,
                "state_dict": {"module." + k: v for k, v in
                               with_counters(sd.items()).items()},
                "optimizer": {"state": {}, "param_groups": []}}, full_path)
    return bb_path, full_path, sd


def offset_shares(offset, max_offset):
    """The shares of ``offset``'s entries whose derivative the DCN backward
    sets to zero, outside ``[-D, D]`` (clamped) or at an integer inside,
    and of the rest (live)."""
    o = offset.detach().float()
    outside = (o.abs() > float(max_offset) if max_offset
               else torch.zeros_like(o, dtype=torch.bool))
    integer = ~outside & (o == o.round())
    n = o.numel()
    return dict(outside=float(outside.sum()) / n,
                integer=float(integer.sum()) / n,
                live=float((~outside & ~integer).sum()) / n)


def watch_offsets(model):
    """Forward hooks on the four DCNs that keep each one's offsets of the
    last forward; returns ``(last, handles)``."""
    last = {}

    def keep(i):
        def hook(mod, args, out):
            last[i] = (args[1].detach(), mod.max_offset)
        return hook

    handles = [getattr(model, f"dcn_{i}").register_forward_hook(keep(i))
               for i in range(1, 5)]
    return last, handles


def offset_gradient_cause(trainer, batch):
    """At the trainer's weights and one batch, a train step of a copy of
    the state with ``BF16_GRADS`` off and then on: for each DCN the shares
    of its offsets outside the window, at an integer and live, the share of
    non-zero entries of the gradient reaching them (``dcn_bwd``'s d_offset),
    and the offset conv's weight-gradient norm. Raises where offsets are
    live and the gradient reaching them is non-zero, but the conv's is
    zero."""
    from fami_pose_torch.engine.core_functions import build_core_function
    from fami_pose_torch.engine.train_state import TrainState
    from fami_pose_torch.models.fami_pose import FAMIPose
    from fami_pose_torch.optim import build_optimizer

    out = {}
    for bf16_grads in (False, True):
        cfg = trainer.cfg.clone()
        cfg.TPU.BF16_GRADS = bf16_grads
        model = FAMIPose.from_config(cfg)
        model.load_state_dict(trainer.model.state_dict())
        model.to("cuda").train()
        seen = {}

        def watch(i):
            def hook(mod, args, _):
                seen[i] = offset_shares(args[1], mod.max_offset)
                args[1].register_hook(lambda g: seen[i].update(
                    d_offset_nonzero=float((g != 0).float().mean())))
            return hook

        handles = [getattr(model, f"dcn_{i}").register_forward_hook(watch(i))
                   for i in range(1, 5)]
        opt, sched = build_optimizer(cfg, model, steps_per_epoch=5)
        build_core_function(cfg).build_train_step(model)(
            TrainState(model, opt, sched), batch)
        for h in handles:
            h.remove()
        for i in range(1, 5):
            grad = getattr(model, f"dcn_offset_{i}").conv.weight.grad
            # a float32 norm squares entries under ~1e-19 to 0, a float64
            # one does not
            seen[i].update(
                offset_conv_grad_norm_f32=float(grad.float().norm()),
                offset_conv_grad_norm=float(grad.double().norm()),
                offset_conv_grad_max=float(grad.abs().max()))
            if (seen[i]["live"] > 0 and seen[i]["d_offset_nonzero"] > 0
                    and not seen[i]["offset_conv_grad_norm"] > 0):
                raise AssertionError(f"dcn_offset_{i}: live offsets and a "
                                     f"non-zero d_offset, zero weight "
                                     f"gradient ({seen[i]})")
        out["on" if bf16_grads else "off"] = {
            f"dcn_{i}": seen[i] for i in range(1, 5)}
        del model, opt
    return out


def bf16_cast_ms(model, reps=5):
    """Host ms, synchronised, of ``BF16_GRADS``'s casts alone at the
    model's parameters: ``params_cast``'s entry and exit (the copies cast
    at once, and the swap), the gradients cast back (``set_grads``, with
    bf16 stand-ins of the right shapes), and the same two casts made one
    parameter at a time (the lever's first version), for comparison."""
    from fami_pose_torch.engine.steps import (
        cast_copies, params_cast, set_grads,
    )

    params = [p for p in model.parameters() if p.is_floating_point()]
    stand_ins = cast_copies(params, torch.bfloat16)

    def per_parameter():
        grads = [p.detach().to(torch.bfloat16).requires_grad_()
                 for p in params]
        for p, g in zip(params, grads):
            p.grad = g.detach().to(p.dtype)

    def swap():
        with params_cast(model, torch.bfloat16):
            pass

    times = {}
    for name, fn in (("params_cast", swap),
                     ("set_grads", lambda: set_grads(params, stand_ins)),
                     ("per_parameter_both_ways", per_parameter)):
        fn()
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = dict(median=float(np.median(ms)), min=min(ms),
                           max=max(ms))
    for p in params:
        p.grad = None
    return dict(parameters=len(params), reps=reps, **times)


def lever_turns(trainer, raws, rounds=1, steps=1):
    """Host ms of a synchronised train step without a lever and with
    ``BF16_GRADS`` alone, in turns (none, bf16, bf16, none, each
    ``steps`` steps after one warm-up, ``rounds`` times)."""
    from fami_pose_torch.engine.core_functions import build_core_function

    step = {}
    for on in (False, True):
        cfg = trainer.cfg.clone()
        cfg.TPU.BF16_GRADS = on
        step[on] = build_core_function(cfg).build_train_step(trainer.model)
    trainer.model.hrnet.remat = False
    state = trainer.state
    batch = trainer.prepare(raws[0])
    ms = {False: [], True: []}
    for _ in range(rounds):
        for on in (False, True, True, False):
            step[on](state, batch)
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step[on](state, batch)
                torch.cuda.synchronize()
                ms[on].append((time.perf_counter() - t0) * 1e3)
    return {("BF16_GRADS" if on else "none"): dict(
        median=float(np.median(v)), min=min(v), max=max(v), steps=len(v))
        for on, v in ms.items()}


def lever_steps(trainer, raws, remat, bf16_grads, steps):
    """``steps`` train steps of ``trainer``'s state with the levers set:
    prepare (host crops, or the device crop of raw windows) and step, each
    timed from synchronisation to synchronisation, after one warm-up; then
    the peak memory of one more step above what the state holds, and one
    traced step. Returns the readings."""
    from fami_pose_torch.engine.core_functions import build_core_function

    cfg = trainer.cfg.clone()
    cfg.TPU.BF16_GRADS = bf16_grads
    trainer.model.hrnet.remat = remat
    step = build_core_function(cfg).build_train_step(trainer.model)
    state = trainer.state
    step(state, trainer.prepare(raws[0]))
    prepare_ms, step_ms = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = trainer.prepare(raws[i % len(raws)])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        prepare_ms.append((t1 - t0) * 1e3)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    traced = profile_call(lambda: step(state, trainer.prepare(raws[0])))
    trainer.model.hrnet.remat = False
    return dict(
        step_ms_median=float(np.median(step_ms)), step_ms_min=min(step_ms),
        step_ms_max=max(step_ms),
        prepare_ms_median=float(np.median(prepare_ms)),
        prepare_ms_min=min(prepare_ms), prepare_ms_max=max(prepare_ms),
        traced_step=dict(device_busy_ms=traced["device_busy_ms"],
                         traced_ms=traced["traced_ms"],
                         device_busy_share=traced["device_busy_share"],
                         top_self_device_ms=traced["top_self_device_ms"]),
        held_gb=held / 1e9, peak_gb=peak / 1e9,
        step_peak_above_held_gb=(peak - held) / 1e9)


def one_lever_step(base, model_cfg, host_batch, device, remat=False,
                   bf16_grads=False):
    """One Adam step (``make_train_step``) of a copy of ``base`` on
    ``device``; returns its loss terms, gradients and running statistics
    on the CPU."""
    from fami_pose_torch.engine.steps import make_train_step
    from fami_pose_torch.engine.train_state import TrainState
    from fami_pose_torch.models.fami_pose import FAMIPose
    from fami_pose_torch.optim import build_optimizer

    model = FAMIPose.from_config(model_cfg)
    model.load_state_dict(base.state_dict())
    model.hrnet.remat = remat
    model.to(device).train()
    opt, sched = build_optimizer(model_cfg, model, steps_per_epoch=5)
    batch = {k: v.to(device) for k, v in host_batch.items()}
    _, metrics = make_train_step(bf16_grads=bf16_grads)(
        TrainState(model, opt, sched), batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
             if "running_" in k}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def levers_card_vs_cpu():
    """Remat against no remat on the card (f32, TF32 off), and the
    ``BF16_GRADS`` step on the card against the port on the CPU by
    ``bf16_rule`` (at one module of one block a stage branch), at full W48
    width, 256x192, B=2, on tame seeded weights (``tame_weights``)."""
    from fami_pose_torch.data.loader import prepare_train_batch
    from fami_pose_torch.models.fami_pose import FAMIPose

    opts = ("MODEL.IMAGE_SIZE", "[192, 256]", "MODEL.HEATMAP_SIZE", "[48, 64]")
    cfg32 = train_cfg("", *opts, "TPU.COMPUTE_DTYPE", "float32")
    cfg16 = train_cfg("", *opts, "TPU.COMPUTE_DTYPE", "bfloat16")
    image_size = tuple(int(v) for v in cfg32.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(int(v) for v in cfg32.MODEL.HEATMAP_SIZE)
    num_sup = 2 * (int(cfg32.DISTANCE) - 1)
    data = SyntheticPoseDataset(2, image_size, num_sup, seed=1)
    base = tame_weights(FAMIPose.from_config(cfg32), seed=0)
    host_batch = prepare_train_batch(
        np.stack([data[i]["kf"] for i in range(2)]),
        np.stack([data[i]["sup"] for i in range(2)]),
        data.joints, data.vis, int(cfg32.MODEL.SIGMA), image_size,
        heatmap_size, device="cpu")

    # remat on the card: the running statistics come from the first pass,
    # and the gradients, bit for bit (the step's kernels sum in a fixed
    # order and it pins cuDNN's deterministic algorithms, without which
    # 946 of these 984 float32 gradients varied: two plain steps agree bit
    # for bit too)
    _, g_a, s_a = one_lever_step(base, cfg32, host_batch, "cuda")
    _, g_b, _ = one_lever_step(base, cfg32, host_batch, "cuda")
    reset_launches()
    _, g_r, s_r = one_lever_step(base, cfg32, host_batch, "cuda", remat=True)
    torch.cuda.synchronize()
    remat_launches = read_launches()
    plain_differ = [k for k in g_a if not torch.equal(g_a[k], g_b[k])]
    grads_differ = [k for k in g_a if not torch.equal(g_a[k], g_r[k])]
    stats_differ = [k for k in s_a if not torch.equal(s_a[k], s_r[k])]
    remat = dict(grads_differing_from_plain=len(grads_differ),
                 grad_rel_l2_vs_plain=grad_errors(g_r, g_a)[1],
                 plain_run_to_run_grads_differing=len(plain_differ),
                 grads=len(g_a), tol="bit for bit",
                 running_stats_bitwise_equal=not stats_differ,
                 launches=remat_launches)
    if stats_differ or grads_differ or plain_differ \
            or any(c != 4 for c in remat_launches.values()):
        raise AssertionError(
            f"remat on the card: {remat}, running statistics differ at "
            f"{stats_differ[:5]}, gradients at "
            f"{(grads_differ + plain_differ)[:5]}")

    # BF16_GRADS: the card against the CPU, by the CPU's own gap to its
    # f32 step. At full depth the bf16 step stayed chaotic on tame weights
    # (a first reading: the CPU's own gap above BF16_TAME at every DCN
    # weight, offset and mask conv), so this step cuts the depth to one
    # module of one block a branch, at full W48 width
    for cfg in (cfg32, cfg16):
        for stage in ("STAGE2", "STAGE3", "STAGE4"):
            extra = cfg.MODEL.EXTRA[stage]
            extra.NUM_MODULES = 1
            extra.NUM_BLOCKS = [1] * len(extra.NUM_BLOCKS)
    base = tame_weights(FAMIPose.from_config(cfg32), seed=0)
    t0 = time.perf_counter()
    t32, g32, s32 = one_lever_step(base, cfg32, host_batch, "cpu")
    t_cpu, g_cpu, s_cpu = one_lever_step(base, cfg16, host_batch, "cpu",
                                         bf16_grads=True)
    cpu_s = time.perf_counter() - t0
    t_card, g_card, s_card = one_lever_step(base, cfg16, host_batch, "cuda",
                                            bf16_grads=True)
    not_bf16 = [n for g in (g_card, g_cpu) for n, t in g.items()
                if not torch.equal(t, t.bfloat16().float())]
    bad = [n for n, t in g_card.items() if not bool(torch.isfinite(t).all())]
    terms = {}
    for k in t32:
        if not k.startswith("loss"):
            continue
        bound = BF16_CROSS * abs(t_cpu[k] - t32[k]) + BF16_SCALE * abs(t32[k])
        terms[k] = dict(card=t_card[k], cpu=t_cpu[k], cpu_f32=t32[k],
                        ratio=abs(t_card[k] - t_cpu[k]) / bound)
    before = base.state_dict()
    stats = {}
    for k, f in s32.items():
        bound = (BF16_CROSS * float((s_cpu[k] - f).abs().max())
                 + BF16_SCALE * float((f - before[k]).abs().max()))
        cross = float((s_card[k] - s_cpu[k]).abs().max())
        stats[k] = cross / bound if bound > 0 else (0.0 if cross == 0
                                                    else math.inf)
    held, broken, ratios = bf16_rule(g_card, g_cpu, g32)
    faults, missed = planted_faults(g_card, g_cpu, g32)
    dcn = [n for n in g32 if n.startswith("dcn") and n.endswith("weight")]
    unheld = sorted(set(dcn) - set(held))
    quantiles = (0.5, 0.9, 1.0)
    bf16 = dict(
        rule=f"per gradient tensor held (the CPU's own gap to its f32 step "
        f"at most {BF16_TAME} of the f32 gradient, L2): |card - cpu| <= "
        f"{BF16_CROSS} |cpu - cpu_f32| + 2^-6 |cpu_f32|; the same for every "
        "loss term, and for running statistics in max-abs with the f32 "
        "step's move for scale; every gradient a bf16 value; every DCN "
        "weight, offset and mask conv held; a fault planted in one of the "
        "named tensors held breaks the rule there alone",
        held=len(held), of=len(g32), broken=broken,
        named_held=[n for n in BF16_HELD if n in held],
        dcn_ratios={n: ratios.get(n) for n in dcn},
        worst_tensors={n: dict(
            ratio=ratios[n],
            **{k: float((g[n].double() - r[n].double()).norm())
               / float(g32[n].double().norm())
               for k, g, r in (("own_cpu", g_cpu, g32),
                               ("own_card", g_card, g32),
                               ("cross", g_card, g_cpu))})
            for n in sorted(ratios, key=ratios.get)[-3:]},
        ratio_quantiles=dict(zip(quantiles, (
            float(np.quantile(list(ratios.values()), q)) for q in quantiles))),
        worst=max(ratios, key=ratios.get),
        loss_term_ratio_max=max(t["ratio"] for t in terms.values()),
        stats_ratio_max=max(stats.values()), loss_terms=terms,
        planted_fault_ratio_min=min(faults.values(), default=None),
        cpu_s=cpu_s)
    if (not_bf16 or bad or broken or missed or unheld
            or len(held) < 0.6 * len(g32)
            or bf16["loss_term_ratio_max"] > 1.0
            or bf16["stats_ratio_max"] > 1.0):
        raise AssertionError(
            f"BF16_GRADS card vs CPU: {bf16}; not bf16 values "
            f"{not_bf16[:5]}, non-finite {bad[:5]}, not held {unheld}, "
            f"faults missed {missed}")
    return dict(model="FAMIPose HRNet-W48 256x192 D=4 num_sup=4, B=2; "
                "BF16_GRADS at one module of one block a stage branch",
                remat_f32=remat, bf16_grads=bf16)


def validate_tool_pass(root, dirs, full_path, n_samples, *extra):
    """``fami_pose_torch.tools.validate_real_checkpoint``'s ``main()`` on the
    val fixture with the full reference file: its printout, launch counts
    and AP table."""
    import contextlib
    import io

    from fami_pose_torch.tools import validate_real_checkpoint

    json_dir, img_dir, annot_dir = dirs
    argv = ["--checkpoint", full_path, "--cfg",
            os.path.join(ROOT, "configs/posetrack17/fami_pose.yaml"),
            "--root-dir", ROOT, *extra,
            "OUTPUT_DIR", os.path.join(root, "validate_out"),
            "DATASET.JSON_DIR", json_dir, "DATASET.IMG_DIR", img_dir,
            "DATASET.TEST_IMG_DIR", img_dir, "VAL.ANNOT_DIR", annot_dir,
            "VAL.USE_GT_BBOX", "True", "WORKERS", "4"]
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = validate_real_checkpoint.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    text = out.getvalue()
    name_value, mean = results["final"]
    batches = math.ceil(n_samples / 32)
    if (f"loaded full checkpoint {full_path} (0 unmapped torch keys)"
            not in text or tuple(name_value) != AP_KEYS
            or not all(math.isfinite(v) for v in name_value.values())
            or launches != {"dcn_fwd": 8 * batches, "dcn_bwd": 0,
                            "warp_translate": 2 * batches, "warp_bwd": 0}):
        raise AssertionError(f"validate_real_checkpoint: launches "
                             f"{launches}, output:\n{text}")
    window = [ln for ln in text.splitlines() if ln.startswith("DCN window")]
    return dict(argv_extra=list(extra), window=window[0], launches=launches,
                ap_final=dict(name_value), seconds=seconds,
                delta=[ln.strip() for ln in text.splitlines()
                       if "delta" in ln])


def phase_train_levers(smi):
    """Phase train-levers: ``Trainer.train`` with every train-time lever on,
    then the levers one at a time, the card against itself and the CPU, and
    ``validate_real_checkpoint`` on a reference file."""
    from fami_pose_torch.data.loader import build_train_loader
    from fami_pose_torch.data.posetrack import PoseTrackDataset
    from fami_pose_torch.engine import checkpoints
    from fami_pose_torch.engine.trainer import Trainer
    from fami_pose_torch.models.bridge import (
        calibrate_batch_norm, init_weights,
    )
    from fami_pose_torch.models.fami_pose import FAMIPose
    from fami_pose_torch.utils.registry import TRAIN_PHASE

    t_phase = time.perf_counter()
    n_samples = VAL_VIDEOS * VAL_FRAMES * VAL_PEOPLE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_levers_") as root:
        dirs = write_val_fixture(os.path.join(root, "data"),
                                 train_images=LEVERS_TRAIN_IMAGES)
        # seeded, BatchNorm-calibrated W48 weights in the reference's files
        cfg = levers_cfg(root, dirs)
        model = init_weights(FAMIPose.from_config(cfg), seed=0).cuda().eval()
        w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
        frames = torch.randn(2, 3 * (1 + model.num_sup), h, w,
                             generator=torch.Generator().manual_seed(0)).cuda()
        with torch.inference_mode():
            calibrate_batch_norm(model, frames[:, :3], frames[:, 3:])
        bb_path, full_path, file_sd = write_reference_files(model, root)
        del model, frames

        prof_dir = os.path.join(root, "profile")
        levers = ("MODEL.PRETRAINED", bb_path, "TPU.REMAT_BACKBONE", True,
                  "TPU.BF16_GRADS", True, "TPU.DEVICE_CROP", True,
                  "TPU.PROFILE_DIR", prof_dir, "TPU.PROFILE_STEPS", 2,
                  "TPU.ASYNC_CHECKPOINT", True)
        cfg = levers_cfg(root, dirs, *levers)
        trainer = Trainer(cfg, device="cuda")
        if trainer.begin_epoch != 0 or trainer.steps_per_epoch != LEVERS_STEPS:
            raise AssertionError(
                f"fresh trainer of {LEVERS_STEPS} steps expected, got "
                f"{trainer.steps_per_epoch} from epoch {trainer.begin_epoch}")
        loaded = trainer.model.state_dict()
        differ = [k for k, v in file_sd.items() if k.startswith("hrnet.")
                  and not torch.equal(loaded[k].cpu(), v)]
        if differ:
            raise AssertionError(f"MODEL.PRETRAINED: {differ[:5]} differ "
                                 f"from the file")
        loaded_note = (f"{sum(k.startswith('hrnet.') for k in file_sd)} "
                       f"hrnet.* tensors equal the file's bit for bit")

        # the main path: one epoch through Trainer.train, every lever on
        last_offsets, watching = watch_offsets(trainer.model)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = read_launches()
        for h in watching:
            h.remove()
        if any(c != 4 * LEVERS_STEPS for c in launches.values()):
            raise AssertionError(f"train-levers launches {launches}, "
                                 f"expected 4 a step")
        # an offset conv's gradient is zero when no offset of its DCN is
        # live in the step (all outside the window or at an integer, where
        # the DCN backward's d_offset is zero): required only where some are
        offsets = {f"dcn_{i}": offset_shares(*last_offsets[i])
                   for i in range(1, 5)}
        exempt = [f"dcn_offset_{i}.conv.weight" for i in range(1, 5)
                  if offsets[f"dcn_{i}"]["live"] == 0]
        del last_offsets
        norms = check_gradients(trainer.model, exempt=exempt)
        if not all(p.dtype == torch.float32 for p in trainer.model.parameters()):
            raise AssertionError("BF16_GRADS changed a master parameter's "
                                 "dtype")
        traces = os.listdir(prof_dir)
        if len(traces) != 1:
            raise AssertionError(f"profile directory holds {traces}")
        trace_path = os.path.join(prof_dir, traces[0])
        with open(trace_path, "rb") as f:
            trace_bytes = f.read()
        if b'"cat": "kernel"' not in trace_bytes:
            raise AssertionError(f"{trace_path}: no kernel in the trace")
        with open(os.path.join(trainer.log_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        steps_logged = sorted(r["step"] for r in records
                              if r["tag"] == "train_loss")
        bad = [r for r in records if not math.isfinite(r["value"])]
        if (steps_logged != list(range(1, LEVERS_STEPS + 1)) or bad
                or not any(r["tag"] == "train_acc_avg" for r in records)):
            raise AssertionError(f"metrics.jsonl: steps {steps_logged}, "
                                 f"non-finite {bad[:3]}")
        last = {r["tag"][len("train_"):]: r["value"] for r in records
                if r["step"] == LEVERS_STEPS and r["tag"] != "train_acc_avg"}

        # the async checkpoint Trainer.train wrote, and one written while
        # the next step updates the state in place
        ckpt = checkpoints.get_latest_checkpoint(trainer.checkpoints_dir)
        saved = checkpoints.load_variables(ckpt)
        now = state.model.state_dict()
        if any(not torch.equal(saved[k], now[k].cpu()) for k in now):
            raise AssertionError(f"{ckpt} differs from the state at its save")
        raws = list(trainer.loader)
        cause = offset_gradient_cause(trainer, trainer.prepare(raws[0]))
        torch.cuda.empty_cache()
        at_save = {k: v.detach().cpu().clone() for k, v in now.items()}
        race_dir = os.path.join(root, "async")
        race = checkpoints.save_checkpoint(race_dir, 7, state,
                                           async_save=True)
        trainer.train_step(state, trainer.prepare(raws[0]))
        checkpoints.wait_for_pending_saves()
        saved = checkpoints.load_variables(race)
        if any(not torch.equal(saved[k], at_save[k]) for k in at_save):
            raise AssertionError("the async save holds a later state")
        resumed = Trainer(cfg, device="cuda")
        if resumed.begin_epoch != 1 or resumed.state.step != LEVERS_STEPS:
            raise AssertionError(f"resume: epoch {resumed.begin_epoch}, "
                                 f"step {resumed.state.step}")
        theirs = resumed.model.state_dict()
        saved = checkpoints.load_variables(ckpt)
        if any(not torch.equal(theirs[k].cpu(), saved[k]) for k in saved):
            raise AssertionError("resume did not restore the checkpoint")
        del resumed, theirs, saved
        torch.cuda.empty_cache()

        # the levers one at a time against none: host crops from the same
        # split for the variants without the device crop
        host_cfg = levers_cfg(root, dirs)
        host_raws = list(build_train_loader(
            host_cfg, PoseTrackDataset(host_cfg, TRAIN_PHASE)))
        variants = {
            "none": (False, False, False),
            "REMAT_BACKBONE": (True, False, False),
            "BF16_GRADS": (False, True, False),
            "DEVICE_CROP": (False, False, True),
        }
        readings = {}
        for name, (remat, bf16_grads, crop) in variants.items():
            readings[name] = lever_steps(
                trainer, raws if crop else host_raws, remat, bf16_grads,
                LEVERS_TIMED_STEPS)
            emit("train-levers-step", lever=name, card=smi, batch_size=8,
                 **readings[name])
        casts = bf16_cast_ms(trainer.model)
        turns = lever_turns(trainer, host_raws)
        total = torch.cuda.get_device_properties(0).total_memory
        held = readings["REMAT_BACKBONE"]["held_gb"] * 1e9
        per_sample = readings["REMAT_BACKBONE"]["step_peak_above_held_gb"] \
            * 1e9 / 8
        per_sample_plain = readings["none"]["step_peak_above_held_gb"] \
            * 1e9 / 8
        memory = dict(
            card_total_gb=total / 1e9,
            peak_gb_b8={k: readings[k]["peak_gb"]
                        for k in ("none", "REMAT_BACKBONE")},
            per_sample_gb={"none": per_sample_plain / 1e9,
                           "REMAT_BACKBONE": per_sample / 1e9},
            largest_batch_remat=int((total - held) // per_sample),
            largest_batch_none=int((total - held) // per_sample_plain),
            note="largest batch = (card memory - what the state holds) / "
            "the step's peak per sample at B=8: arithmetic on the measured "
            "peak, not probed")
        del trainer, state, raws, host_raws
        torch.cuda.empty_cache()

        versus = levers_card_vs_cpu()
        torch.cuda.empty_cache()

        exact = validate_tool_pass(root, dirs, full_path, n_samples)
        ref_scores = os.path.join(root, "exact_ap.json")
        with open(ref_scores, "w") as f:
            json.dump(exact["ap_final"], f)
        bounded = validate_tool_pass(root, dirs, full_path, n_samples,
                                     "--dcn-bound", "4",
                                     "--reference-scores", ref_scores)
        if exact["window"] != "DCN window: exact" \
                or bounded["window"] != "DCN window: 4":
            raise AssertionError(f"windows {exact['window']!r}, "
                                 f"{bounded['window']!r}")
    emit("train-levers", config="configs/posetrack17/fami_pose.yaml",
         model="FAMIPose HRNet-W48 384x288 bf16 D=4 num_sup=4, train mode",
         card=smi, batch_size=8, levers=[str(v) for v in levers[::2]],
         dataset=f"the val fixture's first {LEVERS_TRAIN_IMAGES} frames as "
         f"its train split ({8 * LEVERS_STEPS} people), raw 768x768 windows",
         weights="seeded init (seed 0), BatchNorm calibrated, written as "
         "a reference backbone .pth and a full epoch_20_state.pth",
         pretrained=loaded_note, epoch_steps=LEVERS_STEPS,
         epoch_seconds=epoch_s, launches=launches, launches_per_step=4,
         last_step_terms=last, grad_norms=norms,
         offsets_last_step=offsets, offset_convs_exempt=exempt,
         offset_gradient_cause=cause, bf16_casts=casts,
         bf16_grads_in_turns=turns,
         trace=dict(file=os.path.basename(trace_path),
                    bytes=len(trace_bytes), steps=2),
         metrics_records=len(records),
         async_checkpoint="the epoch's async checkpoint equals the state; "
         "one saved while the next step ran equals the state at its save; "
         "resume gave epoch 1, step 4, the checkpoint's parameters",
         readings={k: {x: v[x] for x in ("step_ms_median", "step_ms_min",
                                         "step_ms_max", "prepare_ms_median")}
                   | {"device_busy_ms": v["traced_step"]["device_busy_ms"]}
                   for k, v in readings.items()},
         memory=memory, card_vs_cpu=versus,
         validate_real_checkpoint=dict(exact=exact, dcn_bound_4=bounded),
         phase_seconds=time.perf_counter() - t_phase)
    return launches, exact["launches"], bounded["launches"]


def phase_probes():
    """The capability tool as it runs from the command line."""
    from fami_pose_torch.ops import probes
    from fami_pose_torch.tools import hopper_watch

    wrappers = (probes.gather_lane, probes.gather_3d, probes.gather_rows,
                probes.dynamic_roll)
    for fn in wrappers:
        fn.launches = 0
    probes.gather_lane.shfl_launches = 0
    rc = hopper_watch.main([])
    if rc != 0:
        raise AssertionError(f"hopper_watch exited {rc}")
    launches = {
        "probe_gather_lane": (probes.gather_lane.launches
                              - probes.gather_lane.shfl_launches),
        "probe_gather_lane_shfl": probes.gather_lane.shfl_launches,
        "probe_gather_3d": probes.gather_3d.launches,
        "probe_gather_rows": probes.gather_rows.launches,
        "probe_dynamic_roll": probes.dynamic_roll.launches,
    }
    # one launch for each of the tool's lines, five shifts for the roll's
    want = dict.fromkeys(launches, 1)
    want["probe_dynamic_roll"] = 5
    if launches != want:
        raise AssertionError(f"hopper_watch launches {launches}, expected "
                             f"{want}")
    emit("probes", tool="python -m fami_pose_torch.tools.hopper_watch",
         exit_code=rc, launches=launches)
    return launches


VAL_VIDEOS, VAL_FRAMES, VAL_PEOPLE = 3, 12, 2
AP_KEYS = ("Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean")


def write_val_fixture(root, seed=0, w=640, h=480, train_images=0):
    """A seeded synthetic PoseTrack17-style dataset under ``root``: jpeg
    frames ``images/video_000v/0000000f.jpg`` (8 digits from 1), the COCO
    json ``json/posetrack_val.json`` with 17 visible keypoints and a box per
    person, and GT annolists ``annolists/video_000v.json`` in the 15-joint
    order. With ``train_images`` the first that many frames and their people
    are also the train split, ``json/posetrack_train.json``, which the
    dataset's train phase reads (as raw windows under ``TPU.DEVICE_CROP``).
    Returns (json_dir, img_dir, annot_dir)."""
    import cv2

    from fami_pose_torch.data.keypoints import coco2posetrack_ord_infer

    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    json_dir = os.path.join(root, "json")
    annot_dir = os.path.join(root, "annolists")
    os.makedirs(json_dir)
    os.makedirs(annot_dir)
    images, annotations = [], []
    for v in range(VAL_VIDEOS):
        video = f"video_{v:04d}"
        os.makedirs(os.path.join(img_dir, video))
        centers = rs.uniform([130, 180], [w - 130, h - 180],
                             size=(VAL_PEOPLE, 2))
        skeleton = rs.uniform([-70, -130], [70, 130],
                              size=(VAL_PEOPLE, 17, 2))
        velocity = rs.uniform(-4, 4, size=(VAL_PEOPLE, 2))
        annolist = []
        for f in range(1, VAL_FRAMES + 1):
            fname = f"{video}/{f:08d}.jpg"
            frame = rs.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(img_dir, fname), frame)
            img_id = len(images) + 1
            images.append(dict(id=img_id, file_name=fname, width=w, height=h,
                               nframes=VAL_FRAMES, frame_id=f, vid_id=video,
                               is_labeled=True))
            rects = []
            for p in range(VAL_PEOPLE):
                pts = centers[p] + f * velocity[p] + skeleton[p]
                pts = np.clip(pts, [2, 2], [w - 3, h - 3])
                x0, y0 = pts.min(0) - 8
                x1, y1 = pts.max(0) + 8
                kps = np.concatenate([pts, np.ones((17, 1))], axis=1)
                head = [float(x0), float(y0), 40.0, 40.0]
                annotations.append(dict(
                    id=len(annotations) + 1, image_id=img_id, category_id=1,
                    bbox=[float(x0), float(y0), float(x1 - x0),
                          float(y1 - y0)],
                    area=float((x1 - x0) * (y1 - y0)), iscrowd=0,
                    keypoints=[float(t) for t in kps.ravel()], track_id=p,
                    bbox_head=head, scores=[]))
                pt15 = coco2posetrack_ord_infer(kps)
                rects.append({
                    "x1": [head[0]], "y1": [head[1]],
                    "x2": [head[0] + head[2]], "y2": [head[1] + head[3]],
                    "track_id": [p], "score": [1.0],
                    "annopoints": [{"point": [
                        {"id": [j], "x": [float(x)], "y": [float(y)]}
                        for j, (x, y, _) in enumerate(pt15)]}]})
            annolist.append({"image": [{"name": "images/" + fname}],
                             "annorect": rects})
        with open(os.path.join(annot_dir, video + ".json"), "w") as fh:
            json.dump({"annolist": annolist}, fh)
    with open(os.path.join(json_dir, "posetrack_val.json"), "w") as fh:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=1, name="person")]), fh)
    if train_images:
        train = images[:train_images]
        ids = {im["id"] for im in train}
        with open(os.path.join(json_dir, "posetrack_train.json"), "w") as fh:
            json.dump(dict(images=train, annotations=[
                a for a in annotations if a["image_id"] in ids],
                categories=[dict(id=1, name="person")]), fh)
    return json_dir, img_dir, annot_dir


def val_cfg(root, dirs, *opts):
    """The full-width config pointed at the fixture, with the command line
    namespace ``Runner`` reads."""
    import types

    from fami_pose_torch.config import get_cfg

    json_dir, img_dir, annot_dir = dirs
    args = types.SimpleNamespace(
        cfg=os.path.join(ROOT, "configs/posetrack17/fami_pose.yaml"),
        opts=["OUTPUT_DIR", os.path.join(root, "out"),
              "DATASET.JSON_DIR", json_dir, "DATASET.IMG_DIR", img_dir,
              "DATASET.TEST_IMG_DIR", img_dir, "VAL.ANNOT_DIR", annot_dir,
              "VAL.USE_GT_BBOX", True, "WORKERS", 4, *opts],
        root_dir=ROOT, device="cuda", val_from_checkpoint=-1)
    return get_cfg(args), args


def check_val_results(results, evaluator, n_samples, in_box=True):
    """One checkpoint scored; finite AP tables with the eight keys for both
    heatmaps; every sample scored once; finite predictions, with ``in_box``
    inside each sample's enlarged crop box (one heatmap pixel of slack).
    Returns the checkpoint, the tables and the share of predictions inside
    their boxes."""
    ((path, tables),) = results["val"].items()
    for tag in ("final", "backbone"):
        name_value, mean = tables[tag]
        if tuple(name_value) != AP_KEYS:
            raise AssertionError(f"[{tag}] AP keys {tuple(name_value)}")
        bad = {k: v for k, v in name_value.items()
               if not (math.isfinite(v) and 0.0 <= v <= 100.0)}
        if bad or mean != name_value["Mean"]:
            raise AssertionError(f"[{tag}] AP table {dict(name_value)}")
    scored = sorted(i for idxs in evaluator.img_path_map.values()
                    for i in idxs)
    if (evaluator.timings["samples"] != n_samples
            or scored != list(range(n_samples))):
        raise AssertionError(
            f"{evaluator.timings['samples']} samples scored, {n_samples} "
            f"expected")
    boxes = evaluator.all_boxes
    hm_w = int(evaluator.cfg.MODEL.HEATMAP_SIZE[0])
    inside = []
    for preds in (evaluator.all_preds, evaluator.all_preds_bb):
        if not np.all(np.isfinite(preds)):
            raise AssertionError("non-finite predictions")
        half = boxes[:, None, 2:4] * 100.0
        slack = boxes[:, None, 2:3] * 200.0 / hm_w
        lo = boxes[:, None, 0:2] - half - slack
        hi = boxes[:, None, 0:2] + half + slack
        ok = np.all((preds[..., :2] >= lo) & (preds[..., :2] <= hi), axis=-1)
        inside.append(float(ok.mean()))
        if in_box and not ok.all():
            raise AssertionError("predictions outside their crop boxes")
    if not np.allclose(boxes[:, 4], np.prod(boxes[:, 2:4] * 200, axis=1)):
        raise AssertionError("all_boxes[:, 4] is not prod(scale * 200)")
    return path, {tag: dict(tables[tag][0]) for tag in tables}, min(inside)


def val_pass(root, dirs, n_samples, *opts, calibration_batches=0,
             in_box=True, int8_launches=0):
    """One ``Runner.launch(val=True)`` with the launch counts around it
    (``int8_launches`` of each int8 conv kernel; 0 on the float path)."""
    from fami_pose_torch.engine.runner import Runner

    cfg, args = val_cfg(root, dirs, *opts)
    runner = Runner(cfg, args)
    batch = int(cfg.VAL.BATCH_SIZE_PER_GPU)
    batches = math.ceil(n_samples / batch)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = runner.launch(val=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    int8 = read_launches(INT8_COUNTERS)
    ev = runner.evaluator
    # 8 DCN + 2 warp launches a flip-tested batch; a calibration batch (of
    # the auto-window or of the int8 scales) is one plain forward: 4 + 1
    want = {"dcn_fwd": 8 * batches + 4 * calibration_batches,
            "warp_translate": 2 * batches + calibration_batches,
            "dcn_bwd": 0, "warp_bwd": 0}
    if launches != want:
        raise AssertionError(f"val launches {launches}, expected {want}")
    if int8 != dict.fromkeys(INT8_COUNTERS, int8_launches):
        raise AssertionError(f"val int8 launches {int8}, expected "
                             f"{int8_launches} each")
    path, tables, inside = check_val_results(results, ev, n_samples, in_box)
    t = ev.timings
    report = dict(
        opts=[str(o) for o in opts], checkpoint=os.path.basename(path),
        samples=t["samples"], batches=t["batches"], batch_size=batch,
        launches=dict(launches, **int8),
        dcn_window=ev.dcn_max_offset or "exact",
        ap_final=tables["final"], ap_backbone=tables["backbone"],
        predictions_inside_their_boxes=inside,
        launch_seconds=wall, eval_loop_s=t["loop_s"],
        samples_per_s=t["samples"] / t["loop_s"],
        loader_share=t["loader_s"] / t["loop_s"],
        forward_ms_per_batch=t["forward_s"] / t["batches"] * 1e3,
        decode_ms_per_batch=t["decode_s"] / t["batches"] * 1e3)
    return runner, report


def phase_val(smi, root):
    """Phase val in ``root``, a scratch directory: the fixture under
    ``root/data`` and the seeded checkpoint, then the passes. Returns the
    main pass's launches and the fixture's directories."""
    from fami_pose_torch.engine.checkpoints import save_checkpoint
    from fami_pose_torch.engine.evaluator import Evaluator
    from fami_pose_torch.engine.runner import Runner
    from fami_pose_torch.engine.train_state import TrainState
    from fami_pose_torch.models.bridge import (
        calibrate_batch_norm, init_weights,
    )
    from fami_pose_torch.models.fami_pose import FAMIPose
    from fami_pose_torch.optim import build_optimizer

    n_samples = VAL_VIDEOS * VAL_FRAMES * VAL_PEOPLE
    t0 = time.perf_counter()
    dirs = write_val_fixture(os.path.join(root, "data"))
    fixture_s = time.perf_counter() - t0

    # a seeded, BatchNorm-calibrated W48 checkpoint, written as the
    # trainer writes its own
    cfg, args = val_cfg(root, dirs)
    runner = Runner(cfg, args)
    model = init_weights(FAMIPose.from_config(cfg), seed=0).cuda().eval()
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    gen = torch.Generator().manual_seed(0)
    frames = torch.randn(2, 3 * (1 + model.num_sup), h, w,
                         generator=gen).cuda()
    with torch.inference_mode():
        calibrate_batch_norm(model, frames[:, :3], frames[:, 3:])
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch=1)
    state = TrainState(model, optimizer, scheduler)
    save_checkpoint(runner.dirs["checkpoints"], 0, state)

    # checkpoints with every offset head pinned to a constant, for the
    # auto-window passes (kernel zero, bias the value)
    pinned = {}
    for value in (2.6, 9.5):
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        for i in range(1, 5):
            sd[f"dcn_offset_{i}.conv.weight"].zero_()
            sd[f"dcn_offset_{i}.conv.bias"].fill_(value)
        pinned[value] = os.path.join(root, f"pinned_{value}.ckpt")
        torch.save({"model": sd, "begin_epoch": 0}, pinned[value])
    del state, optimizer, scheduler

    # the main pass, twice: the first warms up cuDNN and the allocator
    val_pass(root, dirs, n_samples)
    torch.cuda.reset_peak_memory_stats()
    runner, main = val_pass(root, dirs, n_samples)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = runner.evaluator
    log_files = os.listdir(runner.dirs["log"])
    if not any(f.startswith("validate-") for f in log_files):
        raise AssertionError(f"no validate log file in {log_files}")

    # GT keypoints fed as predictions through the protocol: Mean 100
    gt = np.zeros_like(ev.all_preds)
    for i, item in enumerate(ev.dataset.data):
        gt[i, :, :2] = item["joints_3d"][:, :2]
        gt[i, :, 2] = 0.9
    gt_table, gt_mean = ev.dataset.evaluate(
        cfg, gt, os.path.join(root, "gt_json"), ev.all_boxes,
        ev.img_path_map)
    if abs(gt_mean - 100.0) > 1e-9:
        raise AssertionError(f"GT as predictions: {dict(gt_table)}")

    # card vs the port on the CPU: f32, TF32 off, one batch of 4 (two
    # people of one frame, one of each other video)
    f32_cfg, _ = val_cfg(root, dirs, "TPU.COMPUTE_DTYPE", "float32",
                         "VAL.BATCH_SIZE_PER_GPU", 4)
    subset = copy.copy(ev.dataset)
    per_video = VAL_FRAMES * VAL_PEOPLE  # one video's samples
    subset.data = [ev.dataset.data[i]
                   for i in (0, 1, per_video, 2 * per_video)]
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    side = {}
    for dev in ("cuda", "cpu"):
        one = Evaluator(f32_cfg, dataset=subset, device=dev,
                        output_dirs={"results": os.path.join(
                            root, f"f32_{dev}")})
        t1 = time.perf_counter()
        one.eval_checkpoint(weights)
        side[dev] = (one.all_preds.copy(), one.all_preds_bb.copy(),
                     time.perf_counter() - t1)
    px = max(float(np.abs(side["cuda"][i][..., :2]
                          - side["cpu"][i][..., :2]).max())
             for i in (0, 1))
    mv = max(float(np.abs(side["cuda"][i][..., 2]
                          - side["cpu"][i][..., 2]).max())
             for i in (0, 1))
    if not px <= 0.1:
        raise AssertionError(f"card vs CPU predictions differ by {px} px")

    # DARK decode; then the per-checkpoint window: D = 3 for offsets of
    # 2.6 px, and past the cap of 8 the exact mode of the kernel
    # (seeded random weights give heatmaps that are no Gaussians: where
    # the Hessian is near-singular DARK's Newton step is long, and the
    # reference does not bound it, so this pass is not held to the boxes:
    # the share inside them and the share moved by less than a heatmap
    # pixel from the argmax pass's predictions are reported)
    dark_runner, dark = val_pass(root, dirs, n_samples,
                                 "VAL.POST_PROCESS", True, in_box=False)
    step = np.abs(dark_runner.evaluator.all_preds[..., :2]
                  - ev.all_preds[..., :2]).max(-1)
    px_per_hm = ev.all_boxes[:, None, 2] * 200.0 / int(
        cfg.MODEL.HEATMAP_SIZE[0])
    dark["moved_under_one_heatmap_px"] = float(
        (step <= px_per_hm).mean())
    _, win3 = val_pass(root, dirs, n_samples, "TPU.DCN_AUTO_WINDOW", True,
                       "VAL.MODEL_FILE", pinned[2.6],
                       calibration_batches=2)
    _, exact = val_pass(root, dirs, n_samples, "TPU.DCN_AUTO_WINDOW",
                        True, "VAL.MODEL_FILE", pinned[9.5],
                        calibration_batches=2)
    if (main["dcn_window"], win3["dcn_window"], exact["dcn_window"]) != (
            4, 3, "exact"):
        raise AssertionError(
            f"DCN windows {main['dcn_window']}, {win3['dcn_window']}, "
            f"{exact['dcn_window']}; expected 4, 3, exact")
    emit("val", config="configs/posetrack17/fami_pose.yaml",
         model="FAMIPose HRNet-W48 384x288 bf16 D=4 num_sup=4 flip_test",
         card=smi, entry="Runner(cfg, args).launch(val=True)",
         fixture=f"{VAL_VIDEOS} videos x {VAL_FRAMES} frames x "
         f"{VAL_PEOPLE} people, 640x480 jpeg, seeded",
         fixture_seconds=fixture_s,
         weights="seeded init (seed 0), BatchNorm calibrated",
         main=main, peak_mem_gb=peak_gb,
         gt_as_predictions_mean=gt_mean,
         card_vs_cpu=dict(dtype="float32", tf32="off", samples=4,
                          max_px_diff=px, tol_px=0.1,
                          max_maxval_diff=mv, cuda_s=side["cuda"][2],
                          cpu_s=side["cpu"][2]),
         dark=dark, auto_window_3=win3, auto_window_exact=exact)
    return main["launches"], dirs


JHMDB_CFG = "configs/jhmdb/fami_pose.yaml"
# the Sub-JHMDB fixture: clips x frames, one person a frame, every frame
# labelled; the same clips are the train and the val split
JHMDB_CLIPS, JHMDB_FRAMES = 2, 16
JHMDB_BATCH = 8  # the file's TRAIN / VAL.BATCH_SIZE_PER_GPU 32, cut to 8
JHMDB_TIMED = 3  # synchronised eval and train steps timed


def write_jhmdb_fixture(root, seed=0, w=320, h=240):
    """A seeded synthetic Sub-JHMDB-style dataset under ``root``: jpeg
    frames ``images/clip_000c/0000000f.jpg`` (8 digits from 1), one person a
    frame with 15 visible joints in the JHMDB order and a box, in the COCO
    json ``json/jhmdb_train.json`` and ``json/jhmdb_val.json`` (the same
    clips: the dataset reads GT boxes in both). Returns (json_dir,
    img_dir)."""
    import cv2

    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    json_dir = os.path.join(root, "json")
    os.makedirs(json_dir)
    images, annotations = [], []
    for v in range(JHMDB_CLIPS):
        clip = f"clip_{v:04d}"
        os.makedirs(os.path.join(img_dir, clip))
        center = rs.uniform([100, 90], [w - 100, h - 90])
        skeleton = rs.uniform([-50, -80], [50, 80], size=(15, 2))
        velocity = rs.uniform(-2, 2, size=2)
        for f in range(1, JHMDB_FRAMES + 1):
            fname = f"{clip}/{f:08d}.jpg"
            cv2.imwrite(os.path.join(img_dir, fname),
                        rs.randint(0, 256, size=(h, w, 3), dtype=np.uint8))
            img_id = len(images) + 1
            images.append(dict(id=img_id, file_name=fname, width=w, height=h,
                               nframes=JHMDB_FRAMES, frame_id=f, vid_id=clip,
                               is_labeled=True))
            pts = np.clip(center + f * velocity + skeleton, [2, 2],
                          [w - 3, h - 3])
            x0, y0 = pts.min(0) - 8
            x1, y1 = pts.max(0) + 8
            kps = np.concatenate([pts, np.ones((15, 1))], axis=1)
            annotations.append(dict(
                id=len(annotations) + 1, image_id=img_id, category_id=1,
                bbox=[float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                area=float((x1 - x0) * (y1 - y0)), iscrowd=0,
                keypoints=[float(t) for t in kps.ravel()], track_id=0))
    for split in ("train", "val"):
        with open(os.path.join(json_dir, f"jhmdb_{split}.json"), "w") as fh:
            json.dump(dict(images=images, annotations=annotations,
                           categories=[dict(id=1, name="person")]), fh)
    return json_dir, img_dir


def jhmdb_cfg(root, dirs, *opts):
    """``configs/jhmdb/fami_pose.yaml`` at full width pointed at the
    fixture, batches of ``JHMDB_BATCH``, with the command line namespace
    ``Runner`` reads."""
    import types

    from fami_pose_torch.config import get_cfg

    json_dir, img_dir = dirs
    args = types.SimpleNamespace(
        cfg=os.path.join(ROOT, JHMDB_CFG),
        opts=["OUTPUT_DIR", os.path.join(root, "out"),
              "DATASET.JSON_DIR", json_dir, "DATASET.IMG_DIR", img_dir,
              "DATASET.TEST_IMG_DIR", img_dir,
              "TRAIN.BATCH_SIZE_PER_GPU", JHMDB_BATCH,
              "VAL.BATCH_SIZE_PER_GPU", JHMDB_BATCH, "TRAIN.END_EPOCH", 1,
              "TRAIN.AUTO_RESUME", False, "WORKERS", 4, *opts],
        root_dir=ROOT, device="cuda", val_from_checkpoint=-1)
    return get_cfg(args), args


def synced_ms(fn, reps=JHMDB_TIMED):
    """Median host ms of ``fn`` from one device synchronisation to the
    next, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_jhmdb(smi, root):
    """The Sub-JHMDB configuration (``configs/jhmdb/fami_pose.yaml``:
    HRNet-W48, 256x256, 15 joints, ``DISTANCE: 2`` so 2 supporting frames,
    bf16) through the port's entry points at full width: the flip-tested
    eval step at B = 8 with ``JHMDB_FLIP_PAIRS`` (launches, ms, a traced
    step's device-busy ms), its f32 forward on the card against the CPU
    (phase card-vs-cpu's tolerance), ``Trainer`` for one epoch of B = 8
    steps on the fixture's train split (launches, ms a step), and
    ``Runner.launch(val=True)`` on the checkpoint it wrote, scored with the
    dataset's PCK (GT as predictions -> 100). Returns the launches of the
    phase by kernel."""
    from fami_pose_torch.data.jhmdb import JHMDB_FLIP_PAIRS
    from fami_pose_torch.engine.runner import Runner
    from fami_pose_torch.engine.steps import make_eval_step
    from fami_pose_torch.engine.trainer import Trainer
    from fami_pose_torch.models.bridge import (
        calibrate_batch_norm, init_weights,
    )
    from fami_pose_torch.models.fami_pose import FAMIPose

    t0 = time.perf_counter()
    dirs = write_jhmdb_fixture(os.path.join(root, "jhmdb_data"))
    n_samples = JHMDB_CLIPS * JHMDB_FRAMES
    cfg, _ = jhmdb_cfg(root, dirs)
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    gen = torch.Generator().manual_seed(0)
    model = init_weights(FAMIPose.from_config(cfg), seed=0).cuda().eval()
    num_sup, joints = model.num_sup, int(cfg.MODEL.NUM_JOINTS)
    if (num_sup, joints, (w, h)) != (2, 15, (256, 256)):
        raise AssertionError(f"Sub-JHMDB model: {num_sup} supporting "
                             f"frames, {joints} joints, {w}x{h}")
    frames = torch.randn(JHMDB_BATCH, 3 * (1 + num_sup), h, w, generator=gen)
    with torch.inference_mode():
        calibrate_batch_norm(model, frames[:2, :3].cuda(),
                             frames[:2, 3:].cuda())
    kf, sup = frames[:, :3].cuda(), frames[:, 3:].cuda()

    # the flip-tested eval step at B = 8 with the dataset's flip pairs
    step = make_eval_step(model, flip_test=True, flip_pairs=JHMDB_FLIP_PAIRS)
    step(kf, sup)
    torch.cuda.synchronize()
    reset_launches()
    final, kf_bb = step(kf, sup)
    torch.cuda.synchronize()
    eval_launches = read_launches()
    want = {"dcn_fwd": 8, "dcn_bwd": 0, "warp_translate": 2, "warp_bwd": 0}
    if eval_launches != want:
        raise AssertionError(f"Sub-JHMDB eval step launches {eval_launches}, "
                             f"expected {want}")
    hm = (JHMDB_BATCH, joints, h // 4, w // 4)
    for name, t in (("final", final), ("kf_bb", kf_bb)):
        if tuple(t.shape) != hm or not torch.isfinite(t).all():
            raise AssertionError(f"Sub-JHMDB {name} heatmaps {tuple(t.shape)}"
                                 ", expected finite " + str(hm))
    eval_ms = synced_ms(lambda: step(kf, sup))
    eval_trace = profile_call(lambda: step(kf, sup))

    # card against the CPU: the same weights in f32, TF32 off, one key frame
    outs = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev).float()
        m.compute_dtype = torch.float32
        t1 = time.perf_counter()
        outs[dev] = make_eval_step(m, flip_test=True,
                                   flip_pairs=JHMDB_FLIP_PAIRS)(
            kf[:1].to(dev), sup[:1].to(dev))[0].cpu()
        outs[dev + "_s"] = time.perf_counter() - t1
        del m
    err = max_err(outs["cuda"], outs["cpu"])
    scale = max(1.0, float(outs["cpu"].abs().max()))
    tol = 1e-3 * scale  # phase card-vs-cpu's
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"Sub-JHMDB card vs CPU: max abs diff {err} > "
                             f"{tol}")
    del model, step, final, kf_bb
    torch.cuda.empty_cache()

    # Trainer: one epoch of B = 8 steps on the fixture's train split, the
    # checkpoint into the Runner's directory; then the trainer's own step
    # timed on the loader's batches
    runner = Runner(*jhmdb_cfg(root, dirs))
    tcfg, _ = jhmdb_cfg(root, dirs)
    trainer = Trainer(tcfg, output_dirs=runner.dirs, device="cuda")
    steps = trainer.steps_per_epoch
    if steps != n_samples // JHMDB_BATCH or len(trainer.dataset) != n_samples:
        raise AssertionError(f"Sub-JHMDB train split: {len(trainer.dataset)} "
                             f"samples, {steps} steps")
    reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = trainer.train()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t1
    train_launches = read_launches()
    want = {"dcn_fwd": 4 * steps, "dcn_bwd": 4 * steps,
            "warp_translate": num_sup * steps, "warp_bwd": num_sup * steps}
    if train_launches != want:
        raise AssertionError(f"Sub-JHMDB train launches {train_launches}, "
                             f"expected {want}")
    raws = list(trainer.loader)
    batch0 = trainer.prepare(raws[0])
    metrics = trainer.train_step(state, batch0)[1]
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"Sub-JHMDB train step: non-finite {bad}")
    train_ms = synced_ms(lambda: trainer.train_step(state, batch0))
    train_trace = profile_call(lambda: trainer.train_step(state, batch0))
    ckpts = sorted(os.listdir(runner.dirs["checkpoints"]))
    del trainer, state, raws, batch0
    torch.cuda.empty_cache()

    # --val on the checkpoint the trainer wrote: flip-tested, PCK
    vcfg, vargs = jhmdb_cfg(root, dirs)
    val_runner = Runner(vcfg, vargs)
    reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = val_runner.launch(val=True)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t1
    val_launches = read_launches()
    # VAL.FLIP_VAL is off in this file: one forward a batch, 4 DCN + 1 warp
    batches = math.ceil(n_samples / JHMDB_BATCH)
    passes = 2 if bool(vcfg.VAL.FLIP_VAL) else 1
    want = {"dcn_fwd": 4 * passes * batches, "dcn_bwd": 0,
            "warp_translate": passes * batches, "warp_bwd": 0}
    if val_launches != want:
        raise AssertionError(f"Sub-JHMDB val launches {val_launches}, "
                             f"expected {want}")
    ev = val_runner.evaluator
    ((path, tables),) = results["val"].items()
    pck = {tag: dict(tables[tag][0]) for tag in tables}
    for tag, table in pck.items():
        if not all(math.isfinite(v) and 0.0 <= v <= 100.0
                   for v in table.values()):
            raise AssertionError(f"Sub-JHMDB PCK [{tag}] {table}")
    if ev.timings["samples"] != n_samples or not np.all(
            np.isfinite(ev.all_preds)):
        raise AssertionError("Sub-JHMDB val: samples or predictions")
    gt = np.zeros_like(ev.all_preds)
    for i, item in enumerate(ev.dataset.data):
        gt[i, :, :2] = item["joints_3d"][:, :2]
        gt[i, :, 2] = 0.9
    gt_table, gt_mean = ev.dataset.evaluate(vcfg, gt, root, ev.all_boxes,
                                            ev.img_path_map)
    if abs(gt_mean - 100.0) > 1e-9:
        raise AssertionError(f"Sub-JHMDB GT as predictions: {dict(gt_table)}")
    t = ev.timings
    launches = {k: eval_launches[k] + train_launches[k] + val_launches[k]
                for k in KERNEL_COUNTERS}
    emit("jhmdb", config=JHMDB_CFG, card=smi,
         model="FAMIPose HRNet-W48 256x256 bf16 15 joints DISTANCE 2 "
         "(num_sup=2)", fixture=f"{JHMDB_CLIPS} clips x {JHMDB_FRAMES} "
         "frames, 1 person, 320x240 jpeg, seeded", batch_size=JHMDB_BATCH,
         batch_size_note="the file's TRAIN and VAL.BATCH_SIZE_PER_GPU 32, "
         "cut to 8",
         weights="seeded init (seed 0), BatchNorm calibrated; --val on the "
         "trainer's epoch_0 checkpoint",
         eval_step=dict(flip_test=True, flip_pairs="JHMDB_FLIP_PAIRS",
                        launches=eval_launches, ms=eval_ms,
                        key_frames_per_s=JHMDB_BATCH / (eval_ms / 1e3),
                        timed=f"median of {JHMDB_TIMED} synchronised calls",
                        trace=eval_trace),
         card_vs_cpu=dict(dtype="float32", tf32="off", key_frames=1,
                          flip_test=True, max_abs_diff=err, tol=tol,
                          heatmap_absmax=float(outs["cpu"].abs().max()),
                          cuda_s=outs["cuda_s"], cpu_s=outs["cpu_s"]),
         train=dict(entry="Trainer(cfg).train()", steps=steps,
                    launches=train_launches, epoch_seconds=epoch_s,
                    step_ms_median=train_ms,
                    samples_per_s=JHMDB_BATCH / (train_ms / 1e3),
                    last_metrics={k: float(v) for k, v in metrics.items()},
                    checkpoints=ckpts, trace=train_trace),
         val=dict(entry="Runner(cfg, args).launch(val=True)",
                  flip_test=bool(vcfg.VAL.FLIP_VAL),
                  checkpoint=os.path.basename(path), samples=t["samples"],
                  batches=t["batches"], launches=val_launches,
                  pck_final=pck["final"], pck_backbone=pck["backbone"],
                  gt_as_predictions_mean=gt_mean, launch_seconds=val_s,
                  samples_per_s=t["samples"] / t["loop_s"],
                  loader_share=t["loader_s"] / t["loop_s"]),
         phase_seconds=time.perf_counter() - t0)
    return launches


INT8_OPTS = ("TPU.INT8_EVAL", True, "TPU.INT8_CALIB_BATCHES", 2,
             "TPU.DCN_AUTO_WINDOW", True)
# the int8 convs of one W48 FAMIPose forward: the backbone's 292 (all but
# final_layer) and the 15 of the head's three residual chains, which share
# the backbone's mode in the JAX model
INT8_BACKBONE_CONVS, INT8_CONVS = 292, 307
INT8_REPLACES = ("none: XLA's s8 conv_general_dilated "
                 "(fami_pose_tpu/models/quant.py:102-111)")
INT8_TIMING = ("ms: 20 launches in one CUDA graph, fastest of 3 replays; "
               "plain_ms: 1 call after 1 warm-up")
H100_INT8_OPS = 1979e12  # dense int8 tensor-core operations a second
INT8_NOISE_FACTOR = 2.0  # card vs CPU: this many times the CPU's own
# int8 move under one-ulp noise at every int8 conv's input
INT8_NOISE_SEEDS = (2, 3, 4)


def conv_geometries(model, kf, sup):
    """Every distinct geometry of the int8 convs in one eval forward of
    ``model`` on (kf, sup): {(C_in, C_out, H, W, kernel, stride, frames):
    {"name", "module", "x", "count"}}, ``x`` the input of the first conv
    of that geometry, captured by a forward pre-hook."""
    from fami_pose_torch.models.quant import quantized_convs

    seen = {}

    def pre(mod, args):
        x = args[0]
        key = (x.shape[1], mod.out_channels, x.shape[2], x.shape[3],
               mod.kernel_size[0], mod.stride[0], x.shape[0])
        if key in seen:
            seen[key]["count"] += 1
        else:
            seen[key] = dict(name=mod.quant_name, module=mod,
                             x=x.detach().clone(), count=1)

    hooks = [m.register_forward_pre_hook(pre)
             for m in quantized_convs(model).values()]
    try:
        with torch.inference_mode():
            model(kf, sup)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return seen


def im2col_s8(x, act_scale, mod):
    """The conv's int8 im2col matrix (B * Ho * Wo, K padded to a multiple of
    8) and its weight (N, K padded), in (c, ky, kx) order: the operands of
    ``torch._int_mm``, timed beside the kernels as a yardstick."""
    import torch.nn.functional as F

    from fami_pose_torch.ops.int8_conv import quantize_plain

    cols = F.unfold(quantize_plain(x, act_scale), mod.kernel_size,
                    dilation=mod.dilation, padding=mod.padding,
                    stride=mod.stride)
    k = cols.shape[1]
    kp = -(-k // 8) * 8
    a = F.pad(cols.transpose(1, 2).reshape(-1, k), (0, kp - k))
    return a.to(torch.int8), F.pad(mod.weight_q, (0, kp - k))


def int8_instance(mod):
    """The implicit GEMM's kernel instance that takes the conv in bf16
    (``igemm_kernel<bf16, width>``, the width of ``ops.int8_conv.
    n_tiling``) and its number of N tiles."""
    from fami_pose_torch.ops.int8_conv import n_tiling

    width, tiles = n_tiling(mod.weight_q.shape[0],
                            mod.weight_packed.shape[1])
    return f"igemm_kernel<bf16, {width}>", tiles


def int8_geometry(key, g):
    """The int8 conv at one geometry. The quantize pass and the implicit
    GEMM (with a bias in f32) against their plain versions, and the card
    conv against the float64 plain conv, bit for bit, in f32 and bf16, each
    kernel call synchronised before its plain version runs. Then in bf16,
    the serving type, device times of the two kernels, the whole conv,
    ``torch._int_mm`` on the conv's im2col matrix and cuDNN's bf16 conv on
    the same shapes, beside their bounds, and the plain versions'
    host-paced times."""
    import torch.nn.functional as F

    from fami_pose_torch.ops.int8_conv import (
        implicit_gemm, implicit_gemm_plain, int8_conv2d, int8_conv2d_plain,
        quant_nhwc, quant_nhwc_plain,
    )

    mod, name = g["module"], g["name"]
    geo = dict(kernel_size=mod.kernel_size, stride=mod.stride,
               padding=mod.padding, dilation=mod.dilation)
    act, wq, ws = mod.act_scale, mod.weight_q, mod.weight_scale
    wp = mod.weight_packed
    gen = torch.Generator(device="cuda").manual_seed(1)
    bias = torch.randn(wq.shape[0], generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x = g["x"].to(dtype)
        tag = f"{name} {str(dtype)[6:]}"
        xq = run_kernel(f"int8_quant_nhwc {tag}", lambda: quant_nhwc(x, act))
        if not torch.equal(xq, quant_nhwc_plain(x, act)):
            raise AssertionError(f"int8_quant_nhwc {tag}: differs from its "
                                 "plain version")
        bb = bias if dtype == torch.float32 else None
        y = run_kernel(f"int8_implicit_gemm {tag}", lambda: implicit_gemm(
            xq, wp, ws, act, bb, out_dtype=dtype, **geo))
        if not torch.equal(y, implicit_gemm_plain(xq, wp, ws, act, bb,
                                                  out_dtype=dtype, **geo)):
            raise AssertionError(f"int8_implicit_gemm {tag}: differs from "
                                 "its plain version")
        whole = run_kernel(f"int8 conv {tag}", lambda: int8_conv2d(
            x, wq, ws, act, None, name=name, w_packed=wp, **geo))
        if not torch.equal(whole, int8_conv2d_plain(x, wq, ws, act, None,
                                                    **geo)):
            raise AssertionError(f"int8 conv {tag}: differs from the "
                                 "float64 plain conv")

    # bf16 (x, xq, whole are the bf16 pass's)
    w16 = mod.weight.detach().to(torch.bfloat16)
    a, wq8 = im2col_s8(x, act, mod)
    wt = wq8.t()
    dev = dict(launches=20, replays=3)
    ms = dict(
        quant_nhwc=device_ms(lambda: quant_nhwc(x, act), **dev),
        implicit_gemm=device_ms(lambda: implicit_gemm(
            xq, wp, ws, act, None, out_dtype=torch.bfloat16, **geo), **dev),
        int8_conv=device_ms(lambda: int8_conv2d(
            x, wq, ws, act, None, w_packed=wp, **geo), **dev),
        int_mm=device_ms(lambda: torch._int_mm(a, wt), **dev),
        cudnn_bf16_conv=device_ms(lambda: F.conv2d(
            x, w16, None, mod.stride, mod.padding, mod.dilation), **dev))
    plain_ms = dict(
        quant_nhwc=time_ms(lambda: quant_nhwc_plain(x, act), iters=1,
                           warmup=1),
        implicit_gemm=time_ms(lambda: implicit_gemm_plain(
            xq, wp, ws, act, None, out_dtype=torch.bfloat16, **geo),
            iters=1, warmup=1))
    m_rows, n = a.shape[0], wq.shape[0]
    k = wq.shape[1]  # C * kh * kw: the products the conv needs
    ops = 2 * m_rows * k * n

    def s8_bound(n_bytes, n_ops):
        t = (n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_INT8_OPS * 1e3)
        return (t[0], "bytes") if t[0] >= t[1] else (t[1], "operations")

    acc_bytes = m_rows * n * 4  # _int_mm's int32 sums
    bounds = dict(
        quant_nhwc=bound_ms(nbytes(x, act, xq), 0, torch.bfloat16),
        implicit_gemm=s8_bound(nbytes(xq, wp, ws, act, whole), ops),
        # the int8 conv's least work: x in, y out, the products
        int8_conv=s8_bound(nbytes(x, wq, ws, act, whole), ops),
        int_mm=s8_bound(nbytes(a, wq8) + acc_bytes, 2 * m_rows * a.shape[1]
                        * n),
        cudnn_bf16_conv=bound_ms(nbytes(x, w16, whole), ops, torch.bfloat16))
    instance, n_tiles = int8_instance(mod)
    return dict(
        conv=name, c_in=key[0], c_out=key[1], hw=[key[2], key[3]],
        kernel=key[4], stride=key[5], frames=key[6], instance=instance,
        n_tiles=n_tiles, registers_spill_stores_spill_loads=INT8_USAGE.get(
            instance, "not rebuilt in this process"), rows=m_rows, k=k,
        kp=wp.shape[1], np=wp.shape[0], cp=xq.shape[3],
        convs_per_forward=g["count"], bitwise_equal=True, ms=ms,
        plain_ms=plain_ms, bound_ms={kk: v[0] for kk, v in bounds.items()},
        bound_by={kk: v[1] for kk, v in bounds.items()})


def int8_kernel_rows(geometries, shape=None):
    """The two kernels' rows of the kernel table: times, bounds and plain
    times summed over the int8 convs of one forward (each geometry times
    the number of its convs), the whole conv's time and bound likewise, the
    yardsticks (``_int_mm`` on the im2col matrix and cuDNN's bf16 conv) and
    the largest geometry's own numbers. ``shape`` describes the forward
    (default: phase int8's B=8 at 384x288)."""
    def total(part, field):
        return sum(r["convs_per_forward"] * r[field][part]
                   for r in geometries)

    def by(part):
        t = {}
        for r in geometries:
            t[r["bound_by"][part]] = (t.get(r["bound_by"][part], 0.0)
                                      + r["convs_per_forward"]
                                      * r["bound_ms"][part])
        return max(t, key=t.get)

    biggest = max(geometries, key=lambda r: r["rows"] * r["k"] * r["c_out"])
    whole = dict(ms=total("int8_conv", "ms"),
                 bound_ms=total("int8_conv", "bound_ms"))
    rows = {}
    for kernel, part in (("int8_quant_nhwc", "quant_nhwc"),
                         ("int8_implicit_gemm", "implicit_gemm")):
        t, bnd = total(part, "ms"), total(part, "bound_ms")
        rows[kernel] = dict(
            shape=shape or (
                f"all {INT8_CONVS} int8 convs of one B=8 eval forward (40 "
                f"frames of 384x288; {len(geometries)} geometries)"),
            max_abs_err=0.0, bitwise_equal=True, ms=t,
            plain_ms=total(part, "plain_ms"), bound_ms=bnd, bound_by=by(part),
            bound_share=bnd / t, library_ms=None,
            library="none: no one PyTorch call computes it; beside it, "
            "per forward: torch._int_mm on the convs' im2col matrices and "
            "cuDNN's bf16 conv2d on the same shapes",
            int_mm_ms=total("int_mm", "ms"),
            cudnn_bf16_conv_ms=total("cudnn_bf16_conv", "ms"),
            int8_conv_ms=whole["ms"], int8_conv_bound_ms=whole["bound_ms"],
            int8_conv_bound_share=whole["bound_ms"] / whole["ms"],
            timing=INT8_TIMING + "; sums over the forward's convs",
            largest_geometry=dict(
                conv=biggest["conv"], rows=biggest["rows"], k=biggest["k"],
                ms=biggest["ms"][part], bound_ms=biggest["bound_ms"][part],
                int8_conv_ms=biggest["ms"]["int8_conv"],
                int8_conv_bound_ms=biggest["bound_ms"]["int8_conv"],
                int_mm_ms=biggest["ms"]["int_mm"],
                cudnn_bf16_conv_ms=biggest["ms"]["cudnn_bf16_conv"]))
    return rows


def int8_serving(root, dirs):
    """The serving file's levers through ``Runner.launch(val=True)`` at full
    W48: int8 calibration before the DCN window (the evaluator's two steps
    recorded in order), the launch counts of the counted pass, every
    quantized conv's scale finite and positive and no other conv's set."""
    from fami_pose_torch.engine.evaluator import Evaluator
    from fami_pose_torch.models.layers import Conv2d
    from fami_pose_torch.models.quant import quantized_convs

    n_samples = VAL_VIDEOS * VAL_FRAMES * VAL_PEOPLE
    cfg, _ = val_cfg(root, dirs, *INT8_OPTS)
    batches = math.ceil(n_samples / int(cfg.VAL.BATCH_SIZE_PER_GPU))
    n_cal = int(cfg.TPU.INT8_CALIB_BATCHES)
    order = []
    steps = ("_maybe_calibrate_int8", "_maybe_auto_window")
    originals = {name: getattr(Evaluator, name) for name in steps}

    def recorded(name):
        def run(self):
            order.append(name)
            return originals[name](self)
        return run

    for name in steps:
        setattr(Evaluator, name, recorded(name))
    try:
        # the calibration forwards (float) and the window's (int8) are
        # plain forwards: 4 DCN + 1 warp each; the int8 convs run in the
        # window's forwards and in both forwards of each flip-tested batch
        kw = dict(calibration_batches=2 * n_cal,
                  int8_launches=INT8_CONVS * (2 * batches + n_cal))
        val_pass(root, dirs, n_samples, *INT8_OPTS, **kw)  # warm-up
        order.clear()
        runner, report = val_pass(root, dirs, n_samples, *INT8_OPTS, **kw)
    finally:
        for name in steps:
            setattr(Evaluator, name, originals[name])
    if order != list(steps):
        raise AssertionError(f"evaluator steps {order}: the int8 scales "
                             f"must be calibrated before the DCN window")
    ev = runner.evaluator
    convs = quantized_convs(ev.model)
    scales = torch.stack([c.act_scale for c in convs.values()])
    hrnet = [n for n in convs if n.startswith("hrnet.")]
    others = [n for n, m in ev.model.named_modules()
              if isinstance(m, Conv2d) and n not in convs
              and m.act_scale is not None]
    if (len(convs) != INT8_CONVS or len(hrnet) != INT8_BACKBONE_CONVS
            or "hrnet.final_layer" in convs or others
            or not bool(torch.isfinite(scales).all() & (scales > 0).all())):
        raise AssertionError(
            f"int8 scales: {len(convs)} quantized convs ({len(hrnet)} in "
            f"the backbone), others with a scale {others[:5]}, scales in "
            f"[{float(scales.min())}, {float(scales.max())}]")
    report["int8_scales"] = dict(
        convs=len(convs), backbone=len(hrnet),
        head_chains=len(convs) - len(hrnet), min=float(scales.min()),
        max=float(scales.max()), evaluator_steps=order)
    return runner, report


def int8_eval_step_traces(ev):
    """One flip-tested eval step of the int8 evaluator's model and of the
    same weights with a bf16 backbone, on the same batch: ms a step and
    the device-busy ms of a traced step."""
    from fami_pose_torch.engine.steps import make_eval_step
    from fami_pose_torch.models.fami_pose import FAMIPose

    kf, sup = ev._prepare(next(iter(ev.loader)))
    bf16 = FAMIPose.from_config(ev.cfg).cuda().eval()  # train phase: float
    bf16.load_state_dict(ev.model.state_dict())
    for i in range(1, 5):
        getattr(bf16, f"dcn_{i}").max_offset = ev.dcn_max_offset
    out = {}
    for tag, step in (("int8", ev.eval_step),
                      ("bf16", make_eval_step(bf16, flip_test=True))):
        ms = time_ms(lambda: step(kf, sup), iters=3, warmup=1)
        trace = profile_call(lambda: step(kf, sup))
        out[tag] = dict(eval_step_ms=ms, device_busy_ms=trace["device_busy_ms"],
                        device_busy_share=trace["device_busy_share"],
                        top_self_device_ms=trace["top_self_device_ms"])
    out["batch"] = int(kf.shape[0])
    return out


def int8_card_vs_cpu(model, kf, sup):
    """f32 with TF32 off, one key frame, the same scales: the card's int8
    path against the port's on the CPU. Two checks:

      * conv by conv, exact: during the CPU's forward each of the 307 int8
        convs is also run on the card on the CPU's input; every output must
        equal the CPU's bit for bit;
      * end to end, both heatmaps: the int8 path is not continuous. A float
        ulp of a conv's input (cuDNN's BatchNorm and the CPU's round
        differently) can move a value across a rounding boundary of the
        quantizer, a whole step of 1/127 of the tensor's scale, and the
        seeded model amplifies every such step through its depth. So the
        tolerance is the CPU's own int8 path under that change:
        INT8_NOISE_FACTOR times the most its heatmaps move when the input
        of every int8 conv is moved by at most one float32 ulp (x * (1 + u
        * 2^-23), u in {-1, 0, 1} at random, from each of INT8_NOISE_SEEDS).
        The gap between the CPU's int8 and float paths is printed beside
        it."""
    from fami_pose_torch.models.quant import QUANT_OFF, quantized_convs

    m32 = copy.deepcopy(model).float()
    m32.compute_dtype = torch.float32
    cpu = copy.deepcopy(m32).to("cpu")
    kf1, sup1 = kf[:1].float().cpu(), sup[:1].float().cpu()
    card_convs = quantized_convs(m32)
    cpu_convs = quantized_convs(cpu)

    def run(m, dev="cpu", hook=None, pre=False):
        hooks = [(c.register_forward_pre_hook if pre
                  else c.register_forward_hook)(functools.partial(hook, n))
                 for n, c in cpu_convs.items()] if hook else []
        try:
            with torch.inference_mode():
                return [t.float().cpu() for t in m(kf1.to(dev),
                                                   sup1.to(dev))]
        finally:
            for h in hooks:
                h.remove()

    t0 = time.perf_counter()
    card = run(m32, "cuda")
    card_s = time.perf_counter() - t0
    differing = []

    def same_conv_on_card(name, mod, args, out):
        with torch.inference_mode():
            got = card_convs[name](args[0].cuda()).cpu()
        if not torch.equal(got, out):
            differing.append(name)

    t0 = time.perf_counter()
    ref = run(cpu, hook=same_conv_on_card)
    cpu_s = time.perf_counter() - t0
    if differing:
        raise AssertionError(f"int8 convs whose card output differs from "
                             f"the CPU's on the same input: {differing[:5]} "
                             f"({len(differing)} of {len(cpu_convs)})")
    moves = []
    for seed in INT8_NOISE_SEEDS:
        gen = torch.Generator().manual_seed(seed)

        def ulp_noise(name, mod, args):
            u = torch.randint(-1, 2, args[0].shape, generator=gen)
            return (args[0] * (1 + u.to(args[0].dtype) * 2.0 ** -23),)

        noisy = run(cpu, hook=ulp_noise, pre=True)
        moves.append([max_err(a, r) for a, r in zip(noisy, ref)])
    for conv in cpu_convs.values():
        conv.quant = QUANT_OFF
    floats = run(cpu)
    report, bad = {}, []
    for i, head in enumerate(("final", "backbone")):
        err = max_err(card[i], ref[i])
        tol = INT8_NOISE_FACTOR * max(m[i] for m in moves)
        report[head] = dict(
            max_abs_diff=err, tol=tol,
            cpu_moves_under_ulp_noise=[m[i] for m in moves],
            cpu_int8_vs_float=max_err(ref[i], floats[i]),
            heatmap_absmax=float(ref[i].abs().max()))
        if not (math.isfinite(err) and err <= tol):
            bad.append(head)
    report.update(
        dtype="float32", tf32="off", key_frames=1,
        convs_equal_on_the_same_input=len(cpu_convs),
        noise_seeds=list(INT8_NOISE_SEEDS),
        tol_rule=f"{INT8_NOISE_FACTOR} x the CPU's largest move with every "
        "int8 conv's input moved by at most one float32 ulp",
        cuda_s=card_s, cpu_s=cpu_s)
    if bad:
        raise AssertionError(f"int8 card vs CPU past the tolerance for "
                             f"{bad}: {report}")
    return report


def int8_streaming(stream_bf16):
    """Phase streaming's 8 locked streams on the int8 model (the serving
    config's seeded weights, int8 backbone calibrated on two unflipped
    batches of 8 key frames' windows), flip-test paired: every key frame
    against the int8 batch protocol in f32 with TF32 off (STREAM_F32_TOL of
    scale, STREAM_PX_TOL px) and in bf16 (the batch protocol's own
    bf16-vs-f32 gap); launches a step; ms a step, key frames/s and the
    device-busy ms of a traced step beside bf16 streaming's. Returns the
    report, the int8 model and one batch-protocol window (for the kernel
    checks)."""
    import types

    from fami_pose_torch.config import get_cfg
    from fami_pose_torch.engine.predictor import PosePredictor
    from fami_pose_torch.engine.steps import make_eval_step
    from fami_pose_torch.models.fami_pose import FAMIPose
    from fami_pose_torch.models.quant import calibrate

    def serving_cfg(*opts):
        return get_cfg(types.SimpleNamespace(
            cfg=os.path.join(ROOT, "configs/posetrack17/fami_pose.yaml"),
            opts=list(opts), root_dir=ROOT))

    # the predictor (which refuses int8) gives the seeded weights and the
    # crops; the int8 model takes its weights
    pred = PosePredictor(serving_cfg(), None, device="cuda", flip_test=True,
                         batch_size=8, seed=0)
    q = FAMIPose.from_config(serving_cfg("TPU.INT8_EVAL", True),
                             phase="validate").cuda().eval()
    q.load_state_dict(pred.model.state_dict())
    frames, boxes = synthetic_clip()
    tracks = [bbox for fi in range(4) for bbox, _ in boxes[fi]]
    dev_frames = torch.from_numpy(frames).cuda().permute(0, 3, 1, 2)
    crops, center, scale = locked_crops(pred, dev_frames, tracks)
    n, b = crops.shape[:2]
    span = pred.span
    steps = n + span
    calibrate(q, [batch_window(crops, t, span) for t in (2, n - 3)])

    stream_clip(q, crops, span, flip_test=True)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    hm_q = stream_clip(q, crops, span, flip_test=True)
    torch.cuda.synchronize()
    launches = dict(read_launches(), **read_launches(INT8_COUNTERS))
    want = dict(dcn_fwd=8 * steps, dcn_bwd=0, warp_translate=2 * steps,
                warp_bwd=0)
    # a step: two backbone calls (frames, mirrored frames) and two heads;
    # priming: the backbone on the first frame and its mirror
    want.update(dict.fromkeys(INT8_COUNTERS, 2 * INT8_CONVS * steps
                              + 2 * INT8_BACKBONE_CONVS))
    if launches != want:
        raise AssertionError(f"int8 streaming launches {launches}, expected "
                             f"{want}")
    step_q = make_eval_step(q, flip_test=True)
    with torch.inference_mode():
        ref_q = torch.stack([step_q(*batch_window(crops, t, span))[0]
                             for t in range(n)])
    q32 = copy.deepcopy(q).float()
    q32.compute_dtype = torch.float32
    hm32 = stream_clip(q32, crops, span, flip_test=True)
    step32 = make_eval_step(q32, flip_test=True)
    with torch.inference_mode():
        ref32 = torch.stack([step32(*batch_window(crops, t, span))[0]
                             for t in range(n)])
    del q32, step32
    f32_err = max_err(hm32, ref32)
    f32_scale = max(1.0, float(ref32.abs().max()))
    px_err = float((keypoint_px(hm32, center, scale)
                    - keypoint_px(ref32, center, scale)).abs().max())
    bf16_err, bf16_gap = max_err(hm_q, ref_q), max_err(ref_q, ref32)
    if not (math.isfinite(f32_err) and f32_err <= STREAM_F32_TOL * f32_scale):
        raise AssertionError(f"int8 stream vs batch protocol, f32: {f32_err}")
    if not px_err <= STREAM_PX_TOL:
        raise AssertionError(f"int8 stream keypoints differ by {px_err} px")
    if not (math.isfinite(bf16_err) and bf16_err <= bf16_gap):
        raise AssertionError(f"int8 stream vs batch protocol, bf16: "
                             f"{bf16_err} > {bf16_gap}")

    _, step_ms, trace = steady_stream(q, crops, span)
    med = float(np.median(step_ms))
    report = dict(
        streams=b, frames=n, steps=steps, launches=launches,
        f32_max_abs_diff=f32_err, f32_tol=STREAM_F32_TOL * f32_scale,
        f32_keypoints_max_px=px_err, f32_keypoints_px_tol=STREAM_PX_TOL,
        bf16_max_abs_diff=bf16_err, bf16_tol=bf16_gap,
        step_ms_median=med, key_frames_per_s=b / (med / 1e3),
        device_busy_ms=trace["device_busy_ms"],
        device_busy_share=trace["device_busy_share"],
        top_self_device_ms=trace["top_self_device_ms"],
        bf16_streaming=stream_bf16)
    return report, q, batch_window(crops, n // 2, span)


def phase_int8(smi, root, dirs, stream_bf16):
    """The int8 serving path (``TPU.INT8_EVAL``) at full W48; see the
    module docstring. Returns the int8 kernels' launches in the counted
    ``--val`` pass and their rows of the kernel table."""
    from fami_pose_torch.tools.int8_numerics import report as numerics

    t0 = time.perf_counter()
    runner, serving = int8_serving(root, dirs)
    ev = runner.evaluator
    eval_steps = int8_eval_step_traces(ev)
    emit("int8-serving", card=smi, serving=serving, eval_step_b32=eval_steps)
    kf, sup = ev._prepare(next(iter(ev.loader)))
    card_vs_cpu = int8_card_vs_cpu(ev.model, kf, sup)
    emit("int8-card-vs-cpu", **card_vs_cpu)
    del runner, ev, kf, sup
    torch.cuda.empty_cache()
    streaming, q, window = int8_streaming(stream_bf16)
    emit("int8-streaming", **streaming)
    geos = conv_geometries(q, *window)
    if sum(g["count"] for g in geos.values()) != INT8_CONVS:
        raise AssertionError(f"{sum(g['count'] for g in geos.values())} "
                             f"int8 convs in a forward, {INT8_CONVS} expected")
    rows = [int8_geometry(key, g) for key, g in sorted(geos.items())]
    for row in rows:
        emit("int8-kernels", timing=INT8_TIMING, **row)
    del geos, q
    per_forward = {part: sum(r["convs_per_forward"] * r["ms"][part]
                             for r in rows) for part in rows[0]["ms"]}
    per_forward_bound = {part: sum(r["convs_per_forward"]
                                   * r["bound_ms"][part] for r in rows)
                         for part in rows[0]["bound_ms"]}
    torch.cuda.empty_cache()
    emit("int8-numerics", **numerics(batch=16, seed=0,
                                     image_size=(288, 384), device="cuda"))
    emit("int8", config="configs/posetrack17/fami_pose.yaml + "
         + " ".join(str(o) for o in INT8_OPTS),
         model="FAMIPose HRNet-W48 384x288 bf16 D=4 num_sup=4 flip_test, "
         "int8 backbone", card=smi,
         entry="Runner(cfg, args).launch(val=True)",
         weights="seeded init (seed 0), BatchNorm calibrated",
         samples_per_s=serving["samples_per_s"],
         eval_step_device_busy_ms={k: eval_steps[k]["device_busy_ms"]
                                   for k in ("int8", "bf16")},
         card_vs_cpu={k: card_vs_cpu[k]["max_abs_diff"]
                      for k in ("final", "backbone")},
         streaming_key_frames_per_s=streaming["key_frames_per_s"],
         geometries=len(rows),
         int8_convs_per_forward=INT8_CONVS,
         per_forward_b8_device_ms=per_forward,
         per_forward_b8_bound_ms=per_forward_bound,
         per_forward_note="device ms of one B=8 eval forward's int8 convs "
         "(40 frames through the backbone, 8 through the head's chains), "
         "by part, beside cuDNN's bf16 conv on the same shapes",
         phase_seconds=time.perf_counter() - t0)
    return ({name: serving["launches"][name] for name in INT8_COUNTERS},
            int8_kernel_rows(rows))


# -- phase sustain: training to convergence, resumed, then the serving levers --

# the JAX tool's run (tools/sustained_train_w48.py --motion articulated
# --occlude 0.4): W48 at 96x128, bf16, window 4, B=8, 150 epochs of 2 steps
# with the kill at the half; remat is turned off to save time (~2,500
# launches a step): the port's remat is bit for bit no remat
# (tests/test_torch_train_levers.py); 2 loader threads in place of the
# fixture config's 1 load the epoch's second batch during its first step
# (the same batches in the same order)
SUSTAIN_EPOCHS = 150
SUSTAIN_FIXTURE = dict(motion="articulated", occlude=0.4)
SUSTAIN_OPTS = ("TPU.REMAT_BACKBONE", False, "WORKERS", 2)
SUSTAIN_BOUNDS = (1, 2, 4, 6)
SUSTAIN_PATH = "sustain (fixture-trained W48, 96x128)"
# the warp's calls in the sustained run: one a supporting frame of a B=8
# train step, on 48 x 32 x 24 feature maps
SUSTAIN_WARP_IMAGES = {"warp_translate": 8, "warp_bwd": 8}
SUSTAIN_PLANE = (32, 24)
DCN_BWD_NO_LIBRARY = ("none: no single PyTorch call computes a deformable "
                      "conv's gradients")


def dcn_stage_inputs(trainer, state, batch):
    """Each of ``dcn_1..4``'s (x, offset, mask, weight) as its forward gets
    them, and the gradient of its output, captured by hooks during one
    train step of ``trainer`` on ``state`` (which it updates)."""
    stages = [getattr(state.model, f"dcn_{i}") for i in range(1, 5)]
    seen, grads = {}, {}

    def capture(mod, args, out):
        if mod not in seen:
            seen[mod] = (args[0].detach().clone(), args[1].detach().clone(),
                         args[2].detach().clone(), mod.weight.detach().clone())
            out.register_hook(
                lambda g, m=mod: grads.setdefault(m, g.detach().clone()))

    hooks = [m.register_forward_hook(capture) for m in stages]
    try:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return [seen[m] + (grads[m],) for m in stages]


def dcn_trained_vs_zeroed(name, x, off, msk, wgt, d, gout=None):
    """``dcn_fwd`` (and with ``gout`` ``dcn_bwd``) on a stage's captured
    inputs, once with its trained offsets and once with them zeroed: each
    against its plain version, timed device-side, beside its bound. The
    output gradient is scaled by a power of two to a largest entry in
    [1, 2), as ``dcn_bwd_on_model_inputs`` does, so that the tolerances
    bound something."""
    from fami_pose_torch.models.fami_pose import DCN_DILATION
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d, deform_conv2d_backward, deform_conv2d_backward_plain,
        deform_conv2d_windowed,
    )

    # as DeformConv.forward hands them to the kernel
    off, msk, wgt = off.to(x.dtype), msk.to(x.dtype), wgt.to(x.dtype)
    groups = off.shape[1] // 18
    kw = dict(padding=DCN_DILATION, dilation=DCN_DILATION,
              offset_groups=groups, max_offset=d)
    out = dict(shape=list(x.shape), D=d, dtype=str(x.dtype)[6:],
               offsets_abs_max=float(off.float().abs().max()),
               offsets_past_D=float((off.float().abs() > d).float().mean())
               if d else 0.0)
    if gout is not None:
        raw = float(gout.float().abs().max())
        if not raw > 0:
            raise AssertionError(f"{name}: output gradient is {raw}")
        gout = gout * 2.0 ** -math.floor(math.log2(raw))
        out["gout_abs_max"] = raw
    for kind, o in (("trained", off), ("zeroed", torch.zeros_like(off))):
        tag = f"{name} {kind} offsets"
        run_k = lambda: deform_conv2d_windowed(x, o, msk, wgt, **kw)
        got = run_kernel(f"dcn_fwd {tag}", run_k)
        err, _ = check_close(f"dcn_fwd {tag}", got,
                             deform_conv2d(x, o, msk, wgt, **kw), x.dtype)
        bnd, by = dcn_fwd_bound(x, o, msk, wgt, got)
        row = dict(dcn_fwd=dict(ms=device_ms(run_k, launches=20),
                                max_abs_err=err, bound_ms=bnd, bound_by=by))
        if kind == "trained":
            row["dcn_fwd"]["plain_ms"] = time_ms(
                lambda: deform_conv2d(x, o, msk, wgt, **kw), iters=3,
                warmup=1)
        if gout is not None:
            run_k = lambda: deform_conv2d_backward(x, o, msk, wgt, gout, **kw)
            got_b = run_kernel(f"dcn_bwd {tag}", run_k)
            repeats = repeat_differences(f"dcn_bwd {tag}", run_k)
            errs = [check_close(f"dcn_bwd {n} {tag}", a, r, x.dtype)[0]
                    for n, a, r in zip(
                        ("dx", "doffset", "dmask", "dweight"), got_b,
                        deform_conv2d_backward_plain(x, o, msk, wgt, gout,
                                                     **kw))]
            bnd, by = dcn_bwd_bound(x, o, msk, wgt, gout, got_b)
            row["dcn_bwd"] = dict(ms=device_ms(run_k, launches=20),
                                  max_abs_err=max(errs), bound_ms=bnd,
                                  bound_by=by, differing_in_20_calls=repeats)
            if kind == "trained":
                row["dcn_bwd"]["plain_ms"] = time_ms(
                    lambda: deform_conv2d_backward_plain(
                        x, o, msk, wgt, gout, **kw), iters=3, warmup=1)
        out[kind] = row
    return out


def sustain_train(root):
    """Step 1: the sustained run with its resume check; returns
    ``(summary, trainer, launches)``."""
    from fami_pose_torch.tools import sustained_train as st

    st.write_fixture(root, **SUSTAIN_FIXTURE)
    cfg = st.recipe_cfg(root, epochs=SUSTAIN_EPOCHS, opts=SUSTAIN_OPTS)
    reset_launches()
    summary, trainer = st.train_with_resume(root, cfg, SUSTAIN_EPOCHS,
                                            device="cuda")
    launches = read_launches()
    passed = st.report(summary)
    want = {k: 4 * summary["total_steps"] for k in KERNEL_COUNTERS}
    if launches != want:
        raise AssertionError(f"sustained run launched {launches}, expected "
                             f"{want} (4 of each kernel a step)")
    if summary["resume"]["mismatched"]:
        raise AssertionError(f"{summary['resume']['mismatched']} resumed "
                             f"tensors differ: "
                             f"{summary['resume']['mismatched_names']}")
    if not passed:
        raise AssertionError(f"train PCK {summary['pck_last5']} <= "
                             f"{st.MIN_PCK} over the last 5 logs")
    return summary, trainer, launches


def check_ab(report):
    """Every row scored with finite AP; the exact row and every row whose
    window covers every offset (at or above ceil(max |offset|)) equal,
    joint by joint."""
    exact = report["rows"][0]["ap"]
    for r in report["rows"]:
        if not r["ap"] or not all(math.isfinite(v) for v in r["ap"].values()):
            raise AssertionError(f"A/B row {r['row']}: AP {r['ap']}")
        covers = (r["window"] is not None and not r["row"].startswith(
            ("int8", "serving")) and r["window"] >= report["cover_window"])
        if covers and r["ap"] != exact:
            raise AssertionError(
                f"A/B row {r['row']} (window {r['window']} >= "
                f"{report['cover_window']}) differs from exact: {r['ap']} "
                f"against {exact}")


def sustain_int8_rows(cfg, ckpt, kf, sup):
    """The int8 convs of the checkpoint's int8 model at 96x128 (one eval
    batch's frames; the lowest branch at 3x4): every distinct geometry's
    kernels bit for bit against their plain versions, timed (the rows of
    ``int8_kernel_rows``)."""
    from fami_pose_torch.engine.checkpoints import load_variables
    from fami_pose_torch.models.build import build_model
    from fami_pose_torch.models.quant import calibrate

    c = cfg.clone()
    c.TPU.INT8_EVAL = True
    q = build_model(c, "validate")
    q.load_state_dict(load_variables(ckpt))
    q.cuda().eval()
    with torch.inference_mode():
        calibrate(q, [(kf, sup)])
    geos = conv_geometries(q, kf, sup)
    rows = [int8_geometry(key, g) for key, g in sorted(geos.items())]
    del geos, q
    smallest = min(rows, key=lambda r: r["hw"][0] * r["hw"][1])["hw"]
    frames = kf.shape[0] * (1 + sup.shape[1] // 3)
    return int8_kernel_rows(rows, shape=(
        f"all {sum(r['convs_per_forward'] for r in rows)} int8 convs of one "
        f"B={kf.shape[0]} eval forward ({frames} frames of 96x128; "
        f"{len(rows)} geometries; smallest map {smallest[0]}x"
        f"{smallest[1]})")), smallest


def phase_sustain(smi):
    """Training to convergence with a mid-run resume, then the serving
    levers on the trained checkpoint; see the module docstring. Returns
    the path's launches by kernel (train, A/B, numerics and the ablation)
    and the rows of the kernel table keyed (kernel, "sustain")."""
    from fami_pose_torch.engine.checkpoints import get_latest_checkpoint
    from fami_pose_torch.tools import ab_dcn_bound, ablate_dcn_bound
    from fami_pose_torch.tools.int8_numerics import report as numerics
    from fami_pose_torch.tools.sustained_train import output_dirs

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sustain_") as root:
        summary, trainer, train_launches = sustain_train(root)
        t_train = time.perf_counter() - t0
        batch = trainer.prepare(next(iter(trainer.loader)))
        traced = profile_call(lambda: trainer.train_step(trainer.state,
                                                         batch))
        emit("sustain", card=smi, config="fami_pose_torch.tools."
             "sustained_train recipe, --motion articulated --occlude 0.4",
             model="FAMIPose HRNet-W48 96x128 bf16 D=4, B=8 (the recipe's "
             "remat off: bit for bit no remat)",
             epochs=SUSTAIN_EPOCHS, **{k: v for k, v in summary.items()
                                       if k != "step_ms"},
             step_ms=summary["step_ms"], traced_step=traced,
             launches=train_launches, seconds=t_train)

        ckpt = get_latest_checkpoint(output_dirs(root)["checkpoints"])
        t1 = time.perf_counter()
        reset_launches()
        report, extras = ab_dcn_bound.run(
            ckpt, bounds=SUSTAIN_BOUNDS, device="cuda",
            root=os.path.join(root, "ab"), **SUSTAIN_FIXTURE)
        ab_launches = read_launches(KERNEL_COUNTERS + INT8_COUNTERS)
        ab_dcn_bound.print_tables(report)
        emit("sustain-ab", card=smi, seconds=time.perf_counter() - t1,
             launches=ab_launches, **report)
        check_ab(report)
        if ab_launches["dcn_bwd"] or ab_launches["warp_bwd"] or not all(
                ab_launches[k] for k in ("dcn_fwd", "warp_translate")
                + INT8_COUNTERS):
            raise AssertionError(f"A/B launches {ab_launches}")

        reset_launches()
        num = numerics(batch=16, device="cuda", ckpt=ckpt, **SUSTAIN_FIXTURE)
        num_launches = read_launches(KERNEL_COUNTERS + INT8_COUNTERS)
        emit("sustain-int8-numerics", **num)

        # the window's op-level deviation on this checkpoint's offsets, the
        # trained distribution of the longest run
        t1 = time.perf_counter()
        ablation, _ = ablate_dcn_bound.run(
            ckpt, device="cuda", root=os.path.join(root, "ablate"),
            **SUSTAIN_FIXTURE)
        ablate_dcn_bound.print_tables(ablation)
        ablate_launches = {k: ablation["capture_launches"][k] + sum(
            r["launches"][k] for r in ablation["rows"]) for k in num_launches}
        emit("sustain-ablate", card=smi, seconds=time.perf_counter() - t1,
             launches=ablate_launches, **ablation)
        check_ablation(ablation)

        # comparisons and timing from here on: their launches are not the
        # path's
        kf, sup = extras["eval_batch"]
        int8_rows, smallest = sustain_int8_rows(trainer.cfg, ckpt, kf, sup)
        # clones made here are ordinary tensors (the A/B captured them
        # under inference mode)
        eval_rows = {
            name: dcn_trained_vs_zeroed(f"{name} eval",
                                        *(t.clone() for t in inputs), d=4)
            for name, inputs in extras["dcn_inputs"].items()}
        del extras, kf, sup
        train_rows = {
            f"dcn_{i}": dcn_trained_vs_zeroed(f"dcn_{i} train", x, o, m, w,
                                              d=4, gout=g)
            for i, (x, o, m, w, g) in enumerate(
                dcn_stage_inputs(trainer, trainer.state, batch), 1)}
        emit("sustain-dcn", card=smi, timing=DCN_TIMING,
             note="each stage's own inputs from the trained checkpoint "
             "(eval: the exact A/B row's first batch, D = 4 applied here; "
             "train: one train step after the run), with its trained "
             "offsets and with them zeroed", eval=eval_rows,
             train=train_rows)
        del trainer, batch
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = warp_kernel_rows(gen, "sustain", SUSTAIN_WARP_IMAGES,
                            SUSTAIN_PLANE)
    first = eval_rows["dcn_1"]["trained"]["dcn_fwd"]
    rows["dcn_fwd", "sustain"] = dict(
        shape=eval_rows["dcn_1"]["shape"], D=4, max_abs_err=first[
            "max_abs_err"], ms=first["ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"],
        ms_zeroed_offsets=eval_rows["dcn_1"]["zeroed"]["dcn_fwd"]["ms"],
        plain_ms=first["plain_ms"], library_ms=None, library=DCN_NO_LIBRARY, timing=DCN_TIMING,
        inputs="dcn_1's trained inputs in the A/B's exact row, B=4")
    first = train_rows["dcn_1"]["trained"]["dcn_bwd"]
    rows["dcn_bwd", "sustain"] = dict(
        shape=train_rows["dcn_1"]["shape"], D=4,
        max_abs_err=first["max_abs_err"], ms=first["ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        ms_zeroed_offsets=train_rows["dcn_1"]["zeroed"]["dcn_bwd"]["ms"],
        plain_ms=first["plain_ms"], library_ms=None,
        library=DCN_BWD_NO_LIBRARY, timing=DCN_TIMING,
        inputs="dcn_1's inputs and output gradient in a train step of the "
        "trained model, B=8",
        differing_in_20_calls={kind: train_rows["dcn_1"][kind]["dcn_bwd"][
            "differing_in_20_calls"] for kind in ("trained", "zeroed")})
    for name, row in int8_rows.items():
        rows[name, "sustain"] = dict(row, int8_smallest_map=smallest)
    for (name, _), row in rows.items():
        emit("kernels", kernel=name, path=SUSTAIN_PATH, **row)
    launches = {k: train_launches.get(k, 0) + ab_launches[k]
                + num_launches[k] + ablate_launches[k]
                for k in KERNEL_COUNTERS + INT8_COUNTERS}
    emit("sustain-launches", train=train_launches, ab=ab_launches,
         int8_numerics=num_launches, ablate=ablate_launches, total=launches,
         phase_seconds=time.perf_counter() - t0)
    return launches, rows


# -- phase serving-ab: the JAX repository's last trained-weights A/Bs --------

# the recipe of the JAX repository's flip reading (docs/SERVING.md:156-180:
# tools/sustained_train_w48.py --flip --motion drift --occlude 0.4, read at
# epoch 46, below saturation): 47 epochs of 2 steps, killed and resumed at
# 23, the last checkpoint epoch_46_state; the sustain phase's remat-off and
# loader settings
SERVING_AB_EPOCHS = 47
SERVING_AB_FIXTURE = dict(motion="drift", occlude=0.4)
SERVING_AB_PATH = "serving-ab (flip-trained W48, 96x128)"
# re-primes of 20 emissions at each IoU on the drift fixture: a property of
# its boxes (the JAX repository's docs/STREAMING_AB.md:56-62)
REPRIME_COUNTS = {0.9: 14, 0.7: 8, 0.5: 4}
# one eval forward of the fixture's batch of 4 (20 samples, 5 batches):
# 4 DCN stages and one warp of the folded supporting frames
EVAL_BATCHES, CALIB_BATCHES = 5, 2
BF16_DEPTH_BATCH = 2


def only(launches, want):
    """``launches`` (every kernel's) equal ``want`` on its kernels and 0 on
    the others."""
    return all(launches[k] == want.get(k, 0) for k in launches)


def flip_row_launches(row):
    """What a flip_ab row must launch: each eval batch's forward (two with
    flip-test), plus the int8 rows' calibration forwards."""
    fwd = EVAL_BATCHES * (2 if row["flip"] else 1) + (
        CALIB_BATCHES if row["int8"] else 0)
    return dict(dcn_fwd=4 * fwd, warp_translate=fwd)


def check_flip_ab(report):
    for r in report["rows"]:
        if not all(math.isfinite(v) for v in r["ap"].values()):
            raise AssertionError(f"flip_ab row {r['row']}: AP {r['ap']}")
        want = flip_row_launches(r)
        got = r["launches"]
        int8_ok = (all(got[k] > 0 for k in INT8_COUNTERS) if r["int8"]
                   else not any(got[k] for k in INT8_COUNTERS))
        if not int8_ok or not only(
                {k: v for k, v in got.items() if k not in INT8_COUNTERS},
                want):
            raise AssertionError(f"flip_ab row {r['row']} launched {got}, "
                                 f"expected {want} and int8 "
                                 f"{'on' if r['int8'] else 'off'}")


def check_streaming_ab(report):
    from fami_pose_torch.tools.streaming_ab import reprime_counts

    counts = reprime_counts(report)
    if counts != REPRIME_COUNTS or report["emissions"] != 20:
        raise AssertionError(f"re-primes {counts} of {report['emissions']} "
                             f"emissions, expected {REPRIME_COUNTS} of 20")
    steps = 5 + 2  # 5 frames, then 2 more to emit the last key frames
    for r in report["rows"]:
        if not all(math.isfinite(v) for v in r["ap"].values()):
            raise AssertionError(f"streaming_ab {r['variant']}: AP {r['ap']}")
        fwd = 1 if r["variant"] == "batch" else steps
        if not only(r["launches"], dict(dcn_fwd=4 * fwd,
                                        warp_translate=fwd)):
            raise AssertionError(f"streaming_ab {r['variant']} launched "
                                 f"{r['launches']}, expected {4 * fwd} DCN "
                                 f"+ {fwd} warp")


def check_ablation(report):
    if not only(report["capture_launches"], dict(dcn_fwd=4,
                                                  warp_translate=1)):
        raise AssertionError(f"ablation capture launched "
                             f"{report['capture_launches']}")
    for r in report["rows"]:
        if not only(r["launches"], dict(dcn_fwd=2)) or not all(
                math.isfinite(r[k]) for k in ("max_dev", "rel_err")):
            raise AssertionError(f"ablation row {r['sigma']} D={r['D']}: "
                                 f"{r}")


def bf16_full_depth(trainer, ckpt):
    """Step E: the ``BF16_GRADS`` step at full W48 depth on the trained
    checkpoint, B = 2 at 96x128, one fixed batch of the fixture, train-mode
    BatchNorm: the card against the port on the CPU by ``bf16_rule``, the
    CPU's f32 step for scale, with planted faults in the held
    ``BF16_HELD`` tensors, beside the rule's verdict on the CPU against
    itself with the frames rounded otherwise (``cpu_vs_nudged_cpu``).

    Fails on an uncaught planted fault, a gradient that is not a bf16 value
    or not finite, or launches other than 4 of each train kernel. A held
    tensor that breaks the rule is reported, not failed: at full depth the
    step is chaotic on trained weights too (train-mode BatchNorm uses the
    batch's statistics, not the trained running ones), and the rule then
    misfires on the port against itself: the control breaks it on some
    flip-trained checkpoints where the card does not (PERF.md)."""
    from fami_pose_torch.data.loader import prepare_train_batch
    from fami_pose_torch.engine.checkpoints import load_variables
    from fami_pose_torch.models.fami_pose import FAMIPose

    cfg16, cfg32 = trainer.cfg.clone(), trainer.cfg.clone()
    cfg16.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    base = FAMIPose.from_config(cfg32)
    base.load_state_dict(load_variables(ckpt))
    raw = next(iter(trainer.loader))
    n = BF16_DEPTH_BATCH
    host_batch = prepare_train_batch(
        raw["kf"][:n], raw["sup"][:n], raw["joints"][:n],
        raw["joints_vis"][:n], int(cfg32.MODEL.SIGMA),
        tuple(int(v) for v in cfg32.MODEL.IMAGE_SIZE),
        tuple(int(v) for v in cfg32.MODEL.HEATMAP_SIZE), device="cpu")
    t0 = time.perf_counter()
    t32, g32, _ = one_lever_step(base, cfg32, host_batch, "cpu")
    t_cpu, g_cpu, _ = one_lever_step(base, cfg16, host_batch, "cpu",
                                     bf16_grads=True)
    cpu_s = time.perf_counter() - t0
    # the rule's false alarms at this depth: the port on the CPU against
    # itself, with its frames scaled by 1 + 2^-9 (half a bf16 ulp, so that
    # about half of them round to the neighbouring bf16 value: the change
    # another rounding of the input cast would make)
    nudged = dict(host_batch, **{k: host_batch[k] * (1 + 2.0 ** -9)
                                 for k in ("kf", "sup")})
    _, g_nudged, _ = one_lever_step(base, cfg16, nudged, "cpu",
                                    bf16_grads=True)
    reset_launches()
    t_card, g_card, _ = one_lever_step(base, cfg16, host_batch, "cuda",
                                       bf16_grads=True)
    torch.cuda.synchronize()
    launches = read_launches(KERNEL_COUNTERS + INT8_COUNTERS)
    not_bf16 = [k for g in (g_card, g_cpu) for k, t in g.items()
                if not torch.equal(t, t.bfloat16().float())]
    bad = [k for k, t in g_card.items() if not bool(torch.isfinite(t).all())]
    held, broken, ratios = bf16_rule(g_card, g_cpu, g32)
    # a fault is caught where it breaks the rule at its tensor (another
    # tensor may break it already at this depth: see the docstring)
    faults = planted_faults(g_card, g_cpu, g32)[0]
    missed = [k for k, r in faults.items() if not r > 1.0]
    c_held, c_broken, c_ratios = bf16_rule(g_nudged, g_cpu, g32)

    def own_gap(name):
        size = float(g32[name].double().norm())
        gap = float((g_cpu[name].double() - g32[name].double()).norm())
        return gap / size if size else None

    # the tensors of the cut model (one module of one block a branch) that
    # phase train-levers holds on tame weights
    cut = trainer.cfg.clone()
    extra = copy.deepcopy(dict(cut.MODEL.EXTRA))
    for stage in ("STAGE2", "STAGE3", "STAGE4"):
        extra[stage] = dict(extra[stage], NUM_MODULES=1, NUM_BLOCKS=[1] * len(
            extra[stage]["NUM_BLOCKS"]))
    cut.MODEL.EXTRA = extra
    cut_names = [k for k, _ in FAMIPose.from_config(cut).named_parameters()]
    over_tame = {k: own_gap(k) for k in g32 if k not in held
                 and own_gap(k) is not None}
    quantiles = (0.5, 0.9, 1.0)
    out = dict(
        model="FAMIPose HRNet-W48 at full depth, 96x128, D=4, B=2 of the "
        "fixture (train-mode BatchNorm), the trained checkpoint",
        rule=f"bf16_rule: held where the CPU's own bf16 gap to its f32 step "
        f"is at most {BF16_TAME} of the f32 gradient (L2); there |card - "
        f"cpu| <= {BF16_CROSS} |cpu - cpu_f32| + 2^-6 |cpu_f32|",
        held=len(held), of=len(g32), broken=broken,
        cut_model_tensors=len(cut_names),
        cut_model_tensors_held=sum(k in held for k in cut_names),
        named_held=[k for k in BF16_HELD if k in held],
        named_not_held={k: own_gap(k) for k in BF16_HELD if k not in held},
        over_tame=dict(sorted(over_tame.items(), key=lambda kv: -kv[1])),
        ratio_quantiles=dict(zip(quantiles, (
            float(np.quantile(list(ratios.values()), q)) for q in quantiles)))
        if ratios else None,
        worst_tensors={k: dict(
            ratio=ratios[k],
            **{tag: float((a[k].double() - b[k].double()).norm())
               / float(g32[k].double().norm())
               for tag, a, b in (("own_cpu", g_cpu, g32),
                                 ("own_card", g_card, g32),
                                 ("cross", g_card, g_cpu))})
            for k in sorted(ratios, key=ratios.get)[-3:]},
        planted_fault_ratio_min=min(faults.values(), default=None),
        faults_missed=missed,
        cpu_vs_nudged_cpu=dict(
            held=len(c_held), broken=c_broken,
            ratio_max=max(c_ratios.values(), default=None),
            note="bf16_rule on the CPU's step with its frames scaled by "
            "1 + 2^-9 against the CPU's own step: the rule's verdict on two "
            "equally valid bf16 roundings of the port"),
        loss_terms={k: dict(card=t_card[k], cpu=t_cpu[k], cpu_f32=t32[k])
                    for k in t32 if k.startswith("loss")},
        launches=launches, cpu_s=cpu_s)
    if not_bf16 or bad or missed or not only(
            launches, {k: 4 for k in KERNEL_COUNTERS}):
        raise AssertionError(f"BF16_GRADS at full depth: {out}; not bf16 "
                             f"values {not_bf16[:5]}, non-finite {bad[:5]}")
    return out


def phase_serving_ab(smi, sustain_rows):
    """The JAX repository's last trained-weights A/Bs on the card (see the
    module docstring): A trains the flip checkpoint, B runs
    ``tools/flip_ab.py`` (bf16 and int8), C ``tools/streaming_ab.py``, D
    ``tools/ablate_dcn_bound.py`` on its trained offsets, E the
    ``BF16_GRADS`` step at full depth on it. Returns the path's launches by
    kernel and the rows of the kernel table keyed (kernel, "serving-ab")."""
    from fami_pose_torch.engine.checkpoints import get_latest_checkpoint
    from fami_pose_torch.tools import (
        ablate_dcn_bound, flip_ab, streaming_ab, sustained_train as st,
    )

    t0 = time.perf_counter()
    steps = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_ab_") as root:
        # A: the flip-trained checkpoint, killed and resumed at the half
        st.write_fixture(root, **SERVING_AB_FIXTURE)
        cfg = st.recipe_cfg(root, flip=True, epochs=SERVING_AB_EPOCHS,
                            opts=SUSTAIN_OPTS)
        reset_launches()
        t1 = time.perf_counter()
        summary, trainer = st.train_with_resume(root, cfg, SERVING_AB_EPOCHS,
                                                device="cuda")
        launches = read_launches(KERNEL_COUNTERS + INT8_COUNTERS)
        ckpt = get_latest_checkpoint(st.output_dirs(root)["checkpoints"])
        steps["train"] = launches
        emit("serving-ab-train", card=smi, seconds=time.perf_counter() - t1,
             config="fami_pose_torch.tools.sustained_train --flip --motion "
             f"drift --occlude 0.4 --epochs {SERVING_AB_EPOCHS} (remat off)",
             checkpoint=os.path.basename(ckpt), launches=launches,
             **{k: v for k, v in summary.items()})
        if summary["resume"]["mismatched"] or not only(
                launches, {k: 4 * summary["total_steps"]
                           for k in KERNEL_COUNTERS}) or not ckpt.endswith(
                f"epoch_{SERVING_AB_EPOCHS - 1}_state.ckpt"):
            raise AssertionError(f"flip-trained run: resume {summary['resume']}"
                                 f", launches {launches}, checkpoint {ckpt}")

        # B: flip-test off and on, bf16 and int8
        t1 = time.perf_counter()
        flip = flip_ab.run(ckpt, int8=True, device="cuda",
                           root=os.path.join(root, "flip"),
                           **SERVING_AB_FIXTURE)
        flip_ab.print_tables(flip)
        steps["flip"] = {k: sum(r["launches"][k] for r in flip["rows"])
                         for k in launches}
        emit("serving-ab-flip", card=smi, seconds=time.perf_counter() - t1,
             launches=steps["flip"], **flip)
        check_flip_ab(flip)

        # C: the batch protocol, crop-locked streaming, the re-prime policy
        t1 = time.perf_counter()
        stream, _ = streaming_ab.run(ckpt, device="cuda",
                                     root=os.path.join(root, "stream"),
                                     **SERVING_AB_FIXTURE)
        streaming_ab.print_tables(stream)
        steps["streaming"] = {k: sum(r["launches"][k] for r in stream["rows"])
                              for k in launches}
        emit("serving-ab-streaming", card=smi,
             seconds=time.perf_counter() - t1, launches=steps["streaming"],
             **stream)
        check_streaming_ab(stream)

        # D: the window's op-level deviation, with the trained offsets
        t1 = time.perf_counter()
        ablation, stages = ablate_dcn_bound.run(
            ckpt, device="cuda", root=os.path.join(root, "ablate"),
            **SERVING_AB_FIXTURE)
        ablate_dcn_bound.print_tables(ablation)
        steps["ablate"] = {k: ablation["capture_launches"][k] + sum(
            r["launches"][k] for r in ablation["rows"]) for k in launches}
        emit("serving-ab-ablate", card=smi, seconds=time.perf_counter() - t1,
             launches=steps["ablate"], **ablation)
        check_ablation(ablation)

        # E: BF16_GRADS at full depth on the trained checkpoint
        t1 = time.perf_counter()
        bf16 = bf16_full_depth(trainer, ckpt)
        steps["bf16"] = bf16["launches"]
        emit("serving-ab-bf16", card=smi, seconds=time.perf_counter() - t1,
             **bf16)

        # comparisons and timing from here on: their launches are not the
        # path's
        batch = trainer.prepare(next(iter(trainer.loader)))
        x, o, m, w, g = dcn_stage_inputs(trainer, trainer.state, batch)[0]
        eval_row = dcn_trained_vs_zeroed(
            "dcn_1 serving-ab eval", *(t.clone() for t in stages["dcn_1"]),
            d=4)
        train_row = dcn_trained_vs_zeroed("dcn_1 serving-ab train", x, o, m,
                                          w, d=4, gout=g)
        del trainer, batch, stages, x, o, m, w, g
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(15)
    # the eval forward warps the 4 supporting frames of a batch of 4 in one
    # call; the train step each supporting frame of its batch of 8
    rows = warp_kernel_rows(gen, "serving-ab",
                            {"warp_translate": 16, "warp_bwd": 8},
                            SUSTAIN_PLANE)
    for name, r, library, inputs in (
            ("dcn_fwd", eval_row, DCN_NO_LIBRARY, "dcn_1's trained inputs in "
             "the ablation's first eval batch (exact DCN), B=4"),
            ("dcn_bwd", train_row, DCN_BWD_NO_LIBRARY, "dcn_1's inputs and "
             "output gradient in a train step of the trained model, B=8")):
        k = r["trained"][name]
        rows[name, "serving-ab"] = dict(
            shape=r["shape"], D=4, max_abs_err=k["max_abs_err"], ms=k["ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            ms_zeroed_offsets=r["zeroed"][name]["ms"],
            plain_ms=k["plain_ms"], library_ms=None, library=library,
            timing=DCN_TIMING, inputs=inputs)
        if name == "dcn_bwd":
            rows[name, "serving-ab"]["differing_in_20_calls"] = {
                kind: r[kind][name]["differing_in_20_calls"]
                for kind in ("trained", "zeroed")}
    for name in INT8_COUNTERS:
        # the same 32 geometries (a B=4 eval forward at 96x128) that phase
        # sustain timed on its checkpoint in this run
        rows[name, "serving-ab"] = dict(
            sustain_rows[name, "sustain"],
            timing_from="phase sustain's rows: the same int8 conv geometries "
            "(B=4 eval forward at 96x128), timed on that checkpoint")
    total = {k: sum(s[k] for s in steps.values()) for k in launches}
    for (name, _), row in rows.items():
        emit("kernels", kernel=name, path=SERVING_AB_PATH, launches=total[name],
             **row)
    emit("serving-ab-launches", **steps, total=total,
         phase_seconds=time.perf_counter() - t0)
    return total, rows


# -- phase distributed: the data-parallel path on the one card ----------------------

# -- phase remainder: the rest of the JAX package -----------------------------

REMAINDER_BLOCKS = (("AdaptBlock", {}), ("AdaptBlockV2",
                                         {"deformable_groups": 2}),
                    ("DeformBlock", {}))
# a block on the card against the port on the CPU, f32 with TF32 off: the
# output, the input gradient and every parameter gradient, each within this
# share of its largest magnitude (the blocks' exact-mode DCN backward sums
# dx from sorted lists, in another order than the CPU's scatter; the DCN's
# bias, whose gradient a train-mode BatchNorm
# cancels, within it of the largest parameter gradient)
BLOCK_F32_TOL = 1e-4
BLOCK_F32_BATCH = 2  # the CPU side's plain DCN is the slow part


def nms_boxes(seed, n=256):
    """(n, 5) [x1 y1 x2 y2 score] around 12 centres, jittered: boxes that
    overlap, so that NMS suppresses."""
    rs = np.random.RandomState(seed)
    centres = rs.rand(12, 2) * 400
    c = centres[rs.randint(0, 12, n)] + rs.randn(n, 2) * 6
    wh = 40 + rs.rand(n, 2) * 30
    dets = np.concatenate([c - wh / 2, c + wh / 2, rs.rand(n, 1)], axis=1)
    return dets.astype(np.float32)


def nms_poses(seed, n=64, j=17):
    """``n`` pose records {'keypoints' (J, 3), 'score', 'area'} around 8
    poses, at three spreads."""
    rs = np.random.RandomState(seed)
    base = rs.rand(8, j, 2) * 200
    pick = rs.randint(0, 8, n)
    xy = base[pick] + rs.randn(n, j, 2) * rs.choice([0.5, 3.0, 12.0],
                                                    (n, 1, 1))
    kpts = np.concatenate([xy, rs.rand(n, j, 1)], axis=2).astype(np.float32)
    return [{"keypoints": kpts[i], "score": float(rs.rand()),
             "area": float(800 + rs.rand() * 4000)} for i in range(n)]


def block_step(block, x, cot):
    """One train-mode forward and backward of ``block`` on ``x`` (a leaf
    that requires its gradient): the output, the input gradient and the
    parameter gradients, on the CPU in float32."""
    block.zero_grad(set_to_none=True)
    x.grad = None
    out = block.train()(x)
    (out.float() * cot).sum().backward()
    return ({"out": out.detach().float().cpu(), "dx": x.grad.float().cpu()},
            {n: p.grad.detach().float().cpu()
             for n, p in block.named_parameters()})


def block_card_vs_cpu(name, kw, x, cot, seed=1):
    """The deform block ``name`` (keyword arguments ``kw``) of ``x``'s
    width, drawn from ``seed`` on the CPU, and a copy of it on the card:
    one train-mode forward and backward of each on the CPU tensors ``x``
    and ``cot``, in float32 (TF32 off on the card). Returns the output's,
    the input gradient's and every parameter gradient's largest difference
    over its own largest magnitude, by name (the DCN's bias feeds a
    train-mode BatchNorm, which makes its gradient zero up to rounding: it
    is held to the largest parameter gradient's), and the card step's
    launches."""
    from fami_pose_torch.models import deform_blocks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(seed)
    cpu = getattr(deform_blocks, name)(x.shape[1], x.shape[1], **kw)
    card = copy.deepcopy(cpu).cuda()
    reset_launches()
    got, got_g = block_step(card, x.cuda().requires_grad_(True), cot.cuda())
    torch.cuda.synchronize()
    seen = read_launches()
    ref, ref_g = block_step(cpu, x.clone().requires_grad_(True), cot)
    largest = max(float(r.abs().max()) for r in ref_g.values())
    errs = {}
    for k, r in list(ref.items()) + list(ref_g.items()):
        a = got.get(k, got_g.get(k))
        scale = largest if k == "adapt_conv.bias" else float(r.abs().max())
        errs[k] = float((a - r).abs().max()) / max(scale, 1e-30)
    return errs, seen


def block_for(c, c_out, groups):
    """The deform block of a width case: AdaptBlockV2 with its masks for 2
    offset groups, DeformBlock (DCNv1) for one; a downsample shortcut where
    C != C_out."""
    from fami_pose_torch.models import deform_blocks

    if groups > 1:
        return deform_blocks.AdaptBlockV2(c, c_out, deformable_groups=groups,
                                          has_downsample=c != c_out)
    return deform_blocks.DeformBlock(c, c_out, has_downsample=c != c_out)


def remainder_blocks():
    """Each deform block at C = 64, 96x72, B = 8, bf16, forward and
    backward on the card (one ``dcn_fwd`` and one ``dcn_bwd`` launch a
    block, counted); at C = 48 in f32 (TF32 off) against the port on the
    CPU with the same weights, and DeformBlock at C = 96 likewise; then a
    block at each width of ``BLOCK_DCN_CASES`` (the kernels once refused
    most of them), a train-mode forward and backward on the card in the
    case's type, its launches counted. Returns the report and the DCN
    launches by case key."""
    from fami_pose_torch.models import deform_blocks

    gen = torch.Generator().manual_seed(0)
    report = {}
    one_each = {"dcn_fwd": 1, "dcn_bwd": 1, "warp_translate": 0,
                "warp_bwd": 0}
    for name, kw in REMAINDER_BLOCKS:
        cls = getattr(deform_blocks, name)
        groups = kw.get("deformable_groups", 1)
        torch.manual_seed(0)
        card = cls(64, 64, **kw).cuda()
        x = torch.randn(8, 64, 96, 72, generator=gen).cuda().to(
            torch.bfloat16).requires_grad_(True)
        cot = torch.randn(8, 64, 96, 72, generator=gen).cuda()
        block_step(card, x, cot)  # warm-up: cuDNN's choice, the allocator
        torch.cuda.synchronize()
        reset_launches()
        got, grads = block_step(card, x, cot)
        torch.cuda.synchronize()
        seen = read_launches()
        if seen != one_each:
            raise AssertionError(f"{name} bf16 launches {seen}")
        if not all(torch.isfinite(t).all() for t in
                   list(got.values()) + list(grads.values())):
            raise AssertionError(f"{name} bf16: non-finite output or "
                                 "gradient")
        step_ms = time_ms(lambda: block_step(card, x, cot), iters=5,
                          warmup=1)
        del card, x, cot

        # f32, TF32 off: the card against the CPU
        x = torch.randn(BLOCK_F32_BATCH, 48, 96, 72, generator=gen)
        errs, f32_seen = block_card_vs_cpu(
            name, kw, x, torch.randn(x.shape, generator=gen))
        worst = max(errs, key=errs.get)
        if errs[worst] > BLOCK_F32_TOL:
            raise AssertionError(f"{name} f32 card vs CPU: {worst} off by "
                                 f"{errs[worst]} of its scale")
        if f32_seen != seen:
            raise AssertionError(f"{name} f32 launches {f32_seen}")
        report[name] = dict(
            offset_groups=groups, mask=name == "AdaptBlockV2",
            bf16=dict(shape=[8, 64, 96, 72], launches=seen,
                      train_step_ms=step_ms),
            f32_card_vs_cpu=dict(shape=[BLOCK_F32_BATCH, 48, 96, 72],
                                 tf32="off", launches=f32_seen,
                                 worst=worst, worst_rel_err=errs[worst],
                                 tol=BLOCK_F32_TOL))

    # a block at C = 96 (two of the backward's 64-channel slices, the
    # forward's chunks and two Cout tiles), f32 card against the CPU
    x = torch.randn(BLOCK_F32_BATCH, 96, 48, 36, generator=gen)
    errs, seen96 = block_card_vs_cpu("DeformBlock", {}, x,
                                     torch.randn(x.shape, generator=gen))
    worst = max(errs, key=errs.get)
    if errs[worst] > BLOCK_F32_TOL or seen96 != one_each:
        raise AssertionError(f"DeformBlock C = 96 f32 card vs CPU: {worst} "
                             f"off by {errs[worst]} of its scale, launches "
                             f"{seen96}")
    report["DeformBlock C=96"] = dict(
        f32_card_vs_cpu=dict(shape=list(x.shape), tf32="off", launches=seen96,
                             worst=worst, worst_rel_err=errs[worst],
                             tol=BLOCK_F32_TOL))

    # a block at each width case: the widths the kernels take now
    launches, widths = {}, {}
    for dtype, c, c_out, groups, (h, w) in BLOCK_DCN_CASES:
        key = block_case_key(dtype, c, c_out, groups)
        torch.manual_seed(0)
        card = block_for(c, c_out, groups).cuda()
        x = torch.randn(BLOCK_BATCH, c, h, w, generator=gen).cuda().to(
            dtype).requires_grad_(True)
        cot = torch.randn(BLOCK_BATCH, c_out, h, w, generator=gen).cuda()
        reset_launches()
        got, grads = block_step(card, x, cot)
        torch.cuda.synchronize()
        seen = read_launches()
        if seen != one_each:
            raise AssertionError(f"block {key}: launches {seen}")
        if not all(torch.isfinite(t).all() for t in
                   list(got.values()) + list(grads.values())):
            raise AssertionError(f"block {key}: non-finite output or "
                                 "gradient")
        launches[key] = {k: seen[k] for k in ("dcn_fwd", "dcn_bwd")}
        widths[key] = dict(block=type(card).__name__,
                           shape=[BLOCK_BATCH, c, h, w], launches=seen)
        del card, x, cot, got, grads
    report["widths"] = widths
    torch.cuda.empty_cache()
    return report, launches


def remainder_nms():
    """``oks_nms_device`` on 64 CUDA poses and ``box_nms_device`` on 256
    CUDA boxes (all valid, then with padded slots) against the host numpy
    keep lists; the native library built on this host against numpy."""
    from fami_pose_torch.native import nms as native
    from fami_pose_torch.ops import nms

    def mask_of(keep, n):
        m = np.zeros(n, bool)
        m[np.asarray(keep, np.int64)] = True
        return m

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    db = nms_poses(0)
    kpts = torch.from_numpy(np.stack([d["keypoints"] for d in db])).cuda()
    scores = torch.tensor([d["score"] for d in db]).cuda()
    areas = torch.tensor([d["area"] for d in db]).cuda()
    dets = nms_boxes(0)
    boxes = torch.from_numpy(dets).cuda()
    out = {}
    for pad in (0, 9):
        valid = np.ones(len(db), bool)
        valid[:pad] = False
        dvalid = torch.from_numpy(valid).cuda()
        run = lambda: nms.oks_nms_device(kpts, scores, areas, dvalid, thr=0.9)
        got = run().cpu().numpy()
        sub = [i for i in range(len(db)) if valid[i]]
        want = mask_of([sub[k] for k in nms.oks_nms([db[i] for i in sub],
                                                    0.9)], len(db))
        if not np.array_equal(got, want):
            raise AssertionError(f"oks_nms_device (pad {pad}) differs "
                                 "from the host keep list")
        valid_b = np.ones(len(dets), bool)
        valid_b[:4 * pad] = False
        bvalid = torch.from_numpy(valid_b).cuda()
        run_b = lambda: nms.box_nms_device(boxes[:, :4], boxes[:, 4], bvalid,
                                           thr=0.6)
        got_b = run_b().cpu().numpy()
        sub_b = np.flatnonzero(valid_b)
        want_b = mask_of(sub_b[nms.nms(dets[sub_b], 0.6)], len(dets))
        if not np.array_equal(got_b, want_b):
            raise AssertionError(f"box_nms_device (pad {pad}) differs "
                                 "from the host keep list")
        out[f"pad_{pad}"] = dict(
            oks_kept=int(got.sum()), oks_ms=timed(run),
            box_kept=int(got_b.sum()), box_ms=timed(run_b))
    built_here = not os.path.exists(native.library_path())
    t0 = time.perf_counter()
    so = native.build()
    build_s = time.perf_counter() - t0
    checks = {
        "cpu_nms": native.cpu_nms(dets, 0.6) == nms.nms(dets, 0.6),
        "oks_nms_native": native.oks_nms_native(db, 0.9) == list(
            nms.oks_nms(db, 0.9)),
        "oks_nms_native vis 0.3": native.oks_nms_native(
            db, 0.5, in_vis_thre=0.3) == list(nms.oks_nms(db, 0.5,
                                                          vis_thr=0.3)),
        "soft_oks_nms_native": native.soft_oks_nms_native(
            db, 0.3, soft_sigma=0.5)[0] == list(nms.soft_oks_nms(db, 0.5)),
    }
    if not all(checks.values()):
        raise AssertionError(f"native NMS against numpy: {checks}")
    out["native"] = dict(library=os.path.relpath(so, ROOT),
                         built_here=built_here, build_s=build_s,
                         flags=list(native.CXX_FLAGS), equal_to_numpy=checks)
    out["sizes"] = dict(poses=len(db), boxes=len(dets), oks_thr=0.9,
                        box_thr=0.6, timing="host-paced ms a call (N steps "
                        "of tensor operations, no host read)")
    return out


def replay_overlays(drawn, out_dir):
    """``draw_skeleton_in_origin_image`` on the CPU for each (path,
    predictions, box) in order into ``out_dir``."""
    from fami_pose_torch.visualization import draw_skeleton_in_origin_image

    for path, preds, bbox in drawn:
        draw_skeleton_in_origin_image(path, preds, out_dir, bbox=bbox)


def image_files(root):
    """The files under ``root``, relative to it, sorted."""
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def same_images(out_dir, ref_dir):
    """The same files under both directories, each decoding to the same
    pixels; returns how many."""
    import cv2

    files = image_files(out_dir)
    if not files or files != image_files(ref_dir):
        raise AssertionError(f"overlays {files} under {out_dir}, "
                             f"{image_files(ref_dir)} in the replay")
    for f in files:
        got = cv2.imread(os.path.join(out_dir, f))
        ref = cv2.imread(os.path.join(ref_dir, f))
        if got is None or ref is None or not np.array_equal(got, ref):
            raise AssertionError(f"overlay {f} differs from the replay's")
    return len(files)


def remainder_val_overlays(root, dirs):
    """``Runner.launch(val=True)`` on phase val's fixture and checkpoint
    with ``DEBUG.VIS_SKELETON`` and ``DEBUG.VIS_BBOX``: the files under
    ``<output>/validate_vis`` are those of the first 50 predictions drawn
    in turn on the CPU by ``draw_skeleton_in_origin_image`` with their
    boxes (two people a frame drawn onto its file, the last one standing:
    25 files; a 49th or a 51st overlay would change a file or add one),
    pixel for pixel."""
    from fami_pose_torch.utils.bbox import cs2box

    n_samples = VAL_VIDEOS * VAL_FRAMES * VAL_PEOPLE
    runner, report = val_pass(root, dirs, n_samples,
                              "DEBUG.VIS_SKELETON", True,
                              "DEBUG.VIS_BBOX", True)
    ev = runner.evaluator
    drawn = [(path, ev.all_preds[i], cs2box(
        ev.all_boxes[i, 0:2], ev.all_boxes[i, 2:4], pattern="xyxy"))
             for path, idxs in ev.img_path_map.items() for i in idxs][:50]
    if len(drawn) != 50:
        raise AssertionError(f"{len(drawn)} predictions, expected >= 50")
    ref_dir = os.path.join(root, "vis_ref")
    replay_overlays(drawn, ref_dir)
    files = same_images(os.path.join(ev.output_dir, "validate_vis"), ref_dir)
    return dict(drawn=len(drawn), files=files,
                launches=report["launches"],
                samples_per_s=report["samples_per_s"],
                eval_loop_s=report["eval_loop_s"])


def remainder_demo(root):
    """``python -m fami_pose_torch.demo --vis`` (its ``main``) on the
    synthetic clip, 2 boxes a frame, batch and ``--streaming``: the files
    under ``<out>/vis`` are those of every emitted pose drawn in turn on
    the CPU (one file a frame, its last pose standing), pixel for
    pixel."""
    import cv2

    from fami_pose_torch import demo

    frames, boxes = synthetic_clip()
    frames_dir = os.path.join(root, "demo", "clip")
    os.makedirs(frames_dir)
    names = [f"{i:04d}.png" for i in range(len(frames))]
    for name, f in zip(names, frames):
        cv2.imwrite(os.path.join(frames_dir, name),
                    np.ascontiguousarray(f[..., ::-1]))
    dets = [{"frame": i, "bbox": b, "score": s}
            for i, v in boxes.items() for b, s in v]
    boxes_json = os.path.join(root, "demo", "boxes.json")
    with open(boxes_json, "w") as fh:
        json.dump(dets, fh)
    out = {}
    for streaming in (False, True):
        tag = "streaming" if streaming else "batch"
        out_dir = os.path.join(root, "demo", tag)
        reset_launches()
        t0 = time.perf_counter()
        demo.main(["--cfg", os.path.join(
            ROOT, "configs/posetrack17/fami_pose.yaml"), "--frames",
            frames_dir, "--boxes", boxes_json, "--out", out_dir,
            "--vis"] + (["--streaming"] if streaming else []))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        seen = read_launches()
        with open(os.path.join(out_dir, "keypoints.json")) as fh:
            records = json.load(fh)
        if len(records) != len(dets):
            raise AssertionError(f"demo {tag}: {len(records)} poses for "
                                 f"{len(dets)} boxes")
        if not seen["dcn_fwd"] or seen["dcn_bwd"] or seen["warp_bwd"]:
            raise AssertionError(f"demo {tag} launches {seen}")
        ref_dir = os.path.join(root, "demo", f"{tag}_ref")
        replay_overlays(
            [(os.path.join(frames_dir, r["frame"]),
              np.asarray(r["keypoints"], np.float32), None) for r in records],
            ref_dir)
        files = same_images(os.path.join(out_dir, "vis"), ref_dir)
        out[tag] = dict(poses=len(records), files=files, launches=seen,
                        seconds=seconds)
    return out


def phase_remainder(smi, root, dirs):
    """The modules of the JAX package ported last: the deform blocks on the
    DCN kernels, device and native NMS, the overlays of ``--val`` and of
    ``demo --vis``. Returns the blocks' DCN launches by offset groups."""
    t0 = time.perf_counter()
    blocks, launches = remainder_blocks()
    nms_report = remainder_nms()
    overlays = remainder_val_overlays(root, dirs)
    demo_report = remainder_demo(root)
    emit("remainder", card=smi, blocks=blocks, nms=nms_report,
         val_overlays=overlays, demo_vis=demo_report,
         phase_seconds=time.perf_counter() - t0)
    return launches


DIST_SAMPLES = 24  # 3 steps of a global batch of 8
DIST_STREAMS, DIST_STREAM_FRAMES = 8, 6
DIST_TIMEOUT_S = 600
# the two-rank f32 step against one process's, as one vector of gradients
# and per loss term, relative (the ranks' BatchNorms and gradients sum in
# another order)
DIST_GRAD_L2_LIMIT = 1e-4
DIST_LOSS_RTOL = 1e-5
DIST_PX_TOL = 1e-3  # decoded keypoints, f32 val: two ranks against one
DIST_NOTE = ("gloo through one card: two processes share one H100 and every "
             "collective goes through host memory; not a multi-GPU reading")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task, world, work_dir, timeout=DIST_TIMEOUT_S):
    """Start ``world`` ranks of ``python3 chip_smoke.py --distributed-worker
    <task> <rank> <world> <port> <work_dir>`` on the card, wait for all of
    them (killing every rank on a timeout), and return their results
    (``torch.save``'d by each rank) and outputs; a rank that fails
    raises with its output."""
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--distributed-worker",
         task, str(rank), str(world), port, work_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"distributed {task} rank {rank} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    return [torch.load(os.path.join(work_dir, f"{task}_rank{r}.pt"),
                       weights_only=False) for r in range(world)], outs


def tensor_leaves(obj, prefix=""):
    """``{path: tensor}`` of every tensor in a nested state."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(tensor_leaves(v, f"{prefix}/{k}"))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(tensor_leaves(v, f"{prefix}/{i}"))
    return out


def state_digests(state):
    """sha256 of every tensor of a train state, by path (equal digests:
    equal bits)."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().reshape(-1).view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for k, v in tensor_leaves(state.state_dict()).items()}


def state_distance(a, b):
    """L2 distance of two host states as one float64 vector, and the number
    of tensors that differ."""
    la, lb = tensor_leaves(a), tensor_leaves(b)
    if list(la) != list(lb):
        raise AssertionError("states of different structure")
    sq, differ = 0.0, 0
    for k in la:
        if not torch.equal(la[k], lb[k]):
            differ += 1
            if la[k].is_floating_point():
                sq += float(((la[k].double() - lb[k].double()) ** 2).sum())
    return math.sqrt(sq), differ, len(la)


class CollectiveCount:
    """Count the calls of the ``torch.distributed`` collectives the port
    uses, while the block runs."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "barrier")

    def __enter__(self):
        import torch.distributed as dist

        self.calls = dict.fromkeys(self.NAMES, 0)
        self._orig = {n: getattr(dist, n) for n in self.NAMES}

        def counting(name):
            def call(*args, **kwargs):
                self.calls[name] += 1
                return self._orig[name](*args, **kwargs)
            return call

        for n in self.NAMES:
            setattr(dist, n, counting(n))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self._orig.items():
            setattr(dist, n, fn)


def join_group(backend, ctx):
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{ctx['port']}",
        rank=ctx["rank"], world_size=ctx["world"])


def dist_train_cfg(out_dir, *opts):
    return train_cfg(out_dir, "TPU.MESH_SHAPE", "[-1, 1]", "WORKERS", 2,
                     "PRINT_FREQ", 1, *opts)


def three_steps(cfg, dataset):
    """``Trainer`` on the card, three ``train_step`` calls on the first
    three batches of its loader; returns the state on the CPU before and
    after them, the first step's metrics and the trainer's mesh."""
    from fami_pose_torch.engine.checkpoints import _to_host
    from fami_pose_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, dataset=dataset, device="cuda")
    before = _to_host(trainer.state.state_dict())
    raws = list(itertools.islice(iter(trainer.loader), 3))
    first = None
    for raw in raws:
        trainer.state, metrics = trainer.train_step(trainer.state,
                                                    trainer.prepare(raw))
        if first is None:
            first = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    out = before, _to_host(trainer.state.state_dict()), first, trainer.mesh
    del trainer
    torch.cuda.empty_cache()
    return out


def collective_helpers_on_card(ctx):
    """Each collective helper of ``parallel/mesh.py`` once on CUDA tensors,
    its result checked against what ``ctx["world"]`` ranks must give."""
    from fami_pose_torch.parallel import mesh as pm

    n, r = ctx["world"], ctx["rank"]
    dev = torch.device("cuda")
    got = {}
    x = torch.arange(6.0, device=dev) * (r + 1)
    got["all_reduce_mean_"] = torch.equal(
        pm.all_reduce_mean_(x.clone()),
        torch.arange(6.0, device=dev) * sum(range(1, n + 1)) / n)
    rows = pm.all_gather_rows(torch.full((2, 3), float(r), device=dev))
    got["all_gather_rows"] = torch.equal(rows, torch.arange(
        float(n), device=dev).repeat_interleave(2)[:, None].expand(-1, 3))
    got["broadcast_"] = torch.equal(
        pm.broadcast_(torch.full((4,), float(r + 7), device=dev)),
        torch.full((4,), 7.0, device=dev))
    a, b = pm.broadcast_tensors([torch.full((3,), r + 1.0, device=dev),
                                 torch.tensor(float(r), device=dev)])
    got["broadcast_tensors"] = (torch.equal(a, torch.ones(3, device=dev))
                                and float(b) == 0.0)
    v = torch.tensor([1.0 + r, 2.0], device=dev, requires_grad=True)
    (pm.all_reduce_sum(v) * torch.tensor([1.0, 3.0], device=dev)).sum() \
        .backward()
    got["all_reduce_sum"] = torch.equal(
        v.grad, torch.tensor([float(n), 3.0 * n], device=dev))
    torch.cuda.synchronize()
    if not all(got.values()):
        raise AssertionError(f"collective helpers on the card: {got}")
    return got


def dist_nccl_one_rank(ctx):
    """(a) One rank over NCCL: the plain trainer twice (no process group),
    then the trainer of ``MESH_SHAPE [-1, 1]`` in a group of one: W48,
    384x288, bf16, B=8, three steps on the same seed and batches."""
    cfg = dist_train_cfg(os.path.join(ctx["dir"], "nccl_one"),
                         "TRAIN.BATCH_SIZE_PER_GPU", 8)
    image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    data = SyntheticPoseDataset(DIST_SAMPLES, image_size,
                                2 * (int(cfg.DISTANCE) - 1))
    init, plain, plain_first, plain_mesh = three_steps(cfg, data)
    _, again, _, _ = three_steps(cfg, data)
    torch.cuda.set_device(0)
    join_group("nccl", ctx)
    with CollectiveCount() as calls:
        reset_launches()
        _, meshed, meshed_first, mesh = three_steps(cfg, data)
        launches = read_launches()
    helpers = collective_helpers_on_card(ctx)
    moved, _, n = state_distance(plain["model"], init["model"])
    spread, spread_differ, _ = state_distance(again, plain)
    dist_m, differ, _ = state_distance(meshed, plain)
    dist_again, differ_again, _ = state_distance(meshed, again)
    rule = ("bit for bit both plain runs, which agree bit for bit (the "
            "step's kernels sum in a fixed order; cuDNN is pinned to its "
            "deterministic algorithms)")
    ok = differ == differ_again == spread_differ == 0
    report = dict(
        mesh=dict(mesh.shape), plain_mesh=dict(plain_mesh.shape),
        collectives_in_three_steps=calls.calls, launches=launches,
        first_step_metrics_bitwise=meshed_first == plain_first,
        model_tensors=n, three_steps_move_l2=moved,
        differ_from_plain=[differ, differ_again],
        l2_from_plain=[dist_m, dist_again],
        plain_run_to_run_differ=spread_differ, plain_run_to_run_l2=spread,
        rule=rule, helpers_checked=helpers)
    if (not ok or any(calls.calls.values()) or mesh.data != 1
            or meshed_first != plain_first
            or any(launches[k] != 12 for k in KERNEL_COUNTERS)):
        raise AssertionError(f"one rank over NCCL: {report}")
    return report


def dist_nccl_two_ranks(ctx):
    """Two NCCL ranks on the one card: the all-reduce NCCL refuses."""
    torch.cuda.set_device(0)
    join_group("nccl", ctx)
    x = torch.ones(4, device="cuda")
    try:
        import torch.distributed as dist

        dist.all_reduce(x)
        torch.cuda.synchronize()
        return {"refused": False, "result": x.tolist()}
    except Exception as e:  # recorded: what NCCL says to two ranks on one GPU
        return {"refused": True, "error": type(e).__name__,
                "message": str(e)[-600:]}


def dist_two_ranks(ctx):
    """(b) Two ranks on the one card over gloo; see ``phase_distributed``."""
    import torch.distributed as dist

    from fami_pose_torch.engine import checkpoints
    from fami_pose_torch.engine.runner import Runner
    from fami_pose_torch.engine.trainer import Trainer
    from fami_pose_torch.models.quant import quant_scales
    from fami_pose_torch.parallel import mesh as pm

    torch.cuda.set_device(0)
    join_group("gloo", ctx)
    rank = ctx["rank"]
    out = {"rank": rank}

    # the train path: Trainer.train at W48, global B=8, one epoch of 3
    # steps, the checkpoint rank 0 writes, auto-resume on both ranks
    train_dir = os.path.join(ctx["dir"], "train")
    cfg = dist_train_cfg(train_dir, "TRAIN.BATCH_SIZE_PER_GPU", 4,
                         "TRAIN.END_EPOCH", 1)
    image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    data = SyntheticPoseDataset(DIST_SAMPLES, image_size,
                                2 * (int(cfg.DISTANCE) - 1))
    saves = []
    save = checkpoints.torch.save

    def counting_save(obj, path, *a, **k):
        saves.append(os.path.basename(path))
        return save(obj, path, *a, **k)

    checkpoints.torch.save = counting_save
    try:
        trainer = Trainer(cfg, dataset=data, device="cuda")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        out["train_launches"] = read_launches()
    finally:
        checkpoints.torch.save = save
    out["saves"] = saves
    out["steps"] = trainer.state.step
    out["digests"] = state_digests(trainer.state)
    resumed = Trainer(cfg, dataset=data, device="cuda")
    out["resumed_epoch"] = resumed.begin_epoch
    out["resume_bitwise"] = state_digests(resumed.state) == out["digests"]
    out["checkpoints"] = sorted(os.listdir(trainer.checkpoints_dir))
    del resumed

    # readings: step ms (synchronised, one step on one batch), the
    # collectives of one step, the gradient bucket and its all-reduce
    raw = next(iter(trainer.loader))
    batch = trainer.prepare(raw)
    step_ms = []
    for _ in range(1):
        t0 = time.perf_counter()
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    with CollectiveCount() as calls:
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
    numel = sum(p.numel() for p in trainer.model.parameters()
                if p.grad is not None)
    bucket = torch.zeros(numel, device="cuda")
    pm.all_reduce_mean_(bucket)
    torch.cuda.synchronize()
    reduce_ms = []
    for _ in range(1):
        t0 = time.perf_counter()
        pm.all_reduce_mean_(bucket)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    out["readings"] = dict(
        train_epoch_s=train_s, step_ms=step_ms,
        collectives_a_step=calls.calls,
        bucket_bytes=numel * 4, bucket_all_reduce_ms=reduce_ms)
    del trainer, batch, bucket
    torch.cuda.empty_cache()

    # one f32 step (TF32 off) at one block a branch, 256x192, on this
    # rank's half of a global batch of 4: the gradients after the average
    from fami_pose_torch.engine.steps import make_train_step
    from fami_pose_torch.engine.train_state import TrainState
    from fami_pose_torch.optim import build_optimizer

    cfg32, host = cut_depth_step_inputs()
    model = cut_depth_model(cfg32).cuda().train()
    opt, sched = build_optimizer(cfg32, model, steps_per_epoch=5)
    rows = slice(2 * rank, 2 * rank + 2)
    reset_launches()
    _, metrics = make_train_step(mesh=pm.build_mesh([-1, 1]))(
        TrainState(model, opt, sched),
        {k: v[rows].cuda() for k, v in host.items()})
    torch.cuda.synchronize()
    out["f32_launches"] = read_launches()
    out["f32_grads"] = {n: p.grad.detach().cpu()
                        for n, p in model.named_parameters()}
    out["f32_metrics"] = {k: float(v) for k, v in metrics.items()}
    del model, opt
    torch.cuda.empty_cache()

    # --val on phase val's fixture and checkpoint: f32 (TF32 off), then
    # with the int8 serving levers
    root, dirs = ctx["root"], ctx["dirs"]
    for name, opts in (("val_f32", ("TPU.COMPUTE_DTYPE", "float32")),
                       ("val_int8", INT8_OPTS)):
        cfg, args = val_cfg(root, dirs, "TPU.MESH_SHAPE", "[-1, 1]", *opts)
        runner = Runner(cfg, args)
        reset_launches()
        results = runner.launch(val=True)
        torch.cuda.synchronize()
        ev = runner.evaluator
        scales = {k: float(v) for k, v in quant_scales(ev.model).items()
                  if v is not None}
        out[name] = dict(
            results={p: {t: dict(v[0]) for t, v in r.items()}
                     for p, r in results["val"].items()},
            launches=dict(read_launches(), **read_launches(INT8_COUNTERS)),
            window=ev.dcn_max_offset, scales=scales,
            all_preds=ev.all_preds.copy(), all_preds_bb=ev.all_preds_bb.copy(),
            samples=ev.timings["samples"])
        del runner, ev
        torch.cuda.empty_cache()

    # 8 streams, 4 a rank, f32 (TF32 off), on phase val's checkpoint
    from fami_pose_torch.engine.streaming import StreamingPosePredictor

    model = dist_stream_model(root, dirs)
    frames = dist_stream_frames()
    pred = StreamingPosePredictor(model, distance=model.num_sup // 2 + 1,
                                  flip_test=True,
                                  mesh=pm.build_mesh([-1, 1]))
    reset_launches()
    pred.prime(frames[0])
    outs = [pred(f) for f in frames[1:]]
    torch.cuda.synchronize()
    out["stream_launches"] = read_launches()
    out["stream_local_streams"] = int(pred._state.feats.shape[1])
    out["stream"] = [tuple(t.cpu() for t in o) for o in outs]
    del model, pred
    torch.cuda.empty_cache()
    out["model_axis"] = dist_model_axis(ctx)
    dist.barrier()
    return out


def dist_model_axis(ctx):
    """(c) The same two gloo ranks with ``TPU.MESH_SHAPE [1, 2]``: both
    hold data index 0 of every global batch. ``Trainer.train`` at W48,
    global B=4, one epoch of 2 steps; the f32 step of (b) on the whole
    global batch of 4; f32 ``--val`` on phase val's fixture and
    checkpoint."""
    import torch.distributed as dist

    from fami_pose_torch.engine.runner import Runner
    from fami_pose_torch.engine.steps import make_train_step
    from fami_pose_torch.engine.train_state import TrainState
    from fami_pose_torch.engine.trainer import Trainer
    from fami_pose_torch.optim import build_optimizer
    from fami_pose_torch.parallel import mesh as pm

    out = {"rank": ctx["rank"]}
    cfg = dist_train_cfg(os.path.join(ctx["dir"], "train_model_axis"),
                         "TPU.MESH_SHAPE", "[1, 2]",
                         "TRAIN.BATCH_SIZE_PER_GPU", 4, "TRAIN.END_EPOCH", 1)
    image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
    data = SyntheticPoseDataset(8, image_size, 2 * (int(cfg.DISTANCE) - 1))
    trainer = Trainer(cfg, dataset=data, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    out.update(train_s=time.perf_counter() - t0,
               train_launches=read_launches(), mesh=trainer.mesh,
               local_batch=trainer.loader.local_batch_size,
               steps=trainer.state.step,
               digests=state_digests(trainer.state))
    del trainer
    torch.cuda.empty_cache()

    cfg32, host = cut_depth_step_inputs()
    model = cut_depth_model(cfg32).cuda().train()
    opt, sched = build_optimizer(cfg32, model, steps_per_epoch=5)
    mesh = pm.build_mesh([1, 2])
    rows = pm.local_batch_slice(host["kf"].shape[0], mesh)
    reset_launches()
    _, metrics = make_train_step(mesh=mesh)(
        TrainState(model, opt, sched),
        {k: v[rows].cuda() for k, v in host.items()})
    torch.cuda.synchronize()
    out.update(f32_rows=rows, f32_launches=read_launches(),
               f32_grads={n: p.grad.detach().cpu()
                          for n, p in model.named_parameters()},
               f32_metrics={k: float(v) for k, v in metrics.items()})
    del model, opt
    torch.cuda.empty_cache()

    cfg, args = val_cfg(ctx["root"], ctx["dirs"], "TPU.MESH_SHAPE", "[1, 2]",
                        "TPU.COMPUTE_DTYPE", "float32")
    runner = Runner(cfg, args)
    reset_launches()
    results = runner.launch(val=True)
    torch.cuda.synchronize()
    ev = runner.evaluator
    out["val"] = dict(
        results={p: {t: dict(v[0]) for t, v in r.items()}
                 for p, r in results["val"].items()},
        launches=read_launches(), all_preds=ev.all_preds.copy(),
        all_preds_bb=ev.all_preds_bb.copy(), samples=ev.timings["samples"],
        rows=sorted(i for idxs in ev.img_path_map.values() for i in idxs),
        mesh=ev.mesh, local_batch=ev.loader.local_batch_size)
    del runner, ev
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def check_model_axis(a, b, ref_grads, ref_metrics, ref_preds, need):
    """(c), ``TPU.MESH_SHAPE [1, 2]``, against one process: both ranks'
    states bit for bit equal after ``Trainer.train``; the f32 step on the
    whole global batch within ``DIST_GRAD_L2_LIMIT`` / ``DIST_LOSS_RTOL``
    of one process's, equal on both ranks; ``--val`` scored by rank 0 once,
    every sample one row, the keypoints within ``DIST_PX_TOL`` of one
    process's. A data axis of 1 gathers nothing: the gather that drops
    replica rows runs at ``[2, 2]`` in the CPU tests. Returns the
    report."""
    from fami_pose_torch.parallel.mesh import Mesh

    n_samples = VAL_VIDEOS * VAL_FRAMES * VAL_PEOPLE
    for rank, r in enumerate((a, b)):
        need(r["mesh"] == Mesh(data=1, model=2, rank=rank)
             and r["val"]["mesh"] == r["mesh"], f"model axis mesh {rank}")
        need(r["local_batch"] == 4 and r["steps"] == 2,
             f"model axis: local batch {r['local_batch']}, {r['steps']} "
             "steps")
        need(r["f32_rows"] == slice(0, 4), f"model axis rows {r['f32_rows']}")
    need(a["digests"] == b["digests"], "model axis: states differ")
    grads = a["f32_grads"]
    need(all(torch.equal(grads[n], b["f32_grads"][n]) for n in grads),
         "model axis: f32 gradients differ across ranks")
    num = math.sqrt(sum(float(((grads[n].double() - ref_grads[n].double())
                               ** 2).sum()) for n in ref_grads))
    den = math.sqrt(sum(float((ref_grads[n].double() ** 2).sum())
                        for n in ref_grads))
    loss_rel = {k: abs(a["f32_metrics"][k] - v) / max(abs(v), 1e-12)
                for k, v in ref_metrics.items() if k.startswith("loss")}
    need(num / den <= DIST_GRAD_L2_LIMIT, f"model axis f32 rel L2 "
         f"{num / den}")
    need(max(loss_rel.values()) <= DIST_LOSS_RTOL,
         f"model axis loss terms {loss_rel}")
    ((path, tables),) = a["val"]["results"].items()
    need(set(tables) == {"final", "backbone"}
         and b["val"]["results"] == {path: {}}, "model axis val results")
    for r in (a, b):
        need(r["val"]["samples"] == n_samples
             and r["val"]["rows"] == list(range(n_samples))
             and len(r["val"]["all_preds"]) == n_samples,
             "model axis val rows")
        need(r["val"]["local_batch"] == 32, "model axis val batch")
    need(all(np.array_equal(a["val"][k], b["val"][k])
             for k in ("all_preds", "all_preds_bb")),
         "model axis val predictions differ across ranks")
    px = max(float(np.abs(a["val"][k][..., :2] - ref[..., :2]).max())
             for k, ref in zip(("all_preds", "all_preds_bb"), ref_preds))
    need(px <= DIST_PX_TOL, f"model axis val keypoints {px} px")
    return dict(
        mesh_shape=[1, 2], states_bitwise_equal=a["digests"] == b["digests"],
        train=dict(global_batch=4, per_rank=4, steps=a["steps"],
                   seconds=[a["train_s"], b["train_s"]],
                   launches_rank0=a["train_launches"]),
        f32_step=dict(grad_rel_l2_vs_one_process=num / den,
                      limit=DIST_GRAD_L2_LIMIT,
                      loss_rel_vs_one_process=loss_rel),
        val=dict(samples=a["val"]["samples"], px_vs_one_process=px,
                 tol_px=DIST_PX_TOL,
                 mean_ap={t: tables[t]["Mean"] for t in tables},
                 launches_rank0=a["val"]["launches"]))


def cut_depth_model(cfg32):
    """The depth-cut W48 model of the two-rank f32 step: tame seeded
    weights (``tame_weights``)."""
    from fami_pose_torch.models.fami_pose import FAMIPose

    return tame_weights(FAMIPose.from_config(cfg32), seed=0)


def cut_depth_step_inputs():
    """The f32 config at one module of one block a stage branch, 256x192,
    full W48 width, and a seeded host batch of 4."""
    from fami_pose_torch.data.loader import prepare_train_batch

    cfg32 = train_cfg("", "MODEL.IMAGE_SIZE", "[192, 256]",
                      "MODEL.HEATMAP_SIZE", "[48, 64]",
                      "TPU.COMPUTE_DTYPE", "float32")
    for stage in ("STAGE2", "STAGE3", "STAGE4"):
        extra = cfg32.MODEL.EXTRA[stage]
        extra.NUM_MODULES = 1
        extra.NUM_BLOCKS = [1] * len(extra.NUM_BLOCKS)
    image_size = tuple(int(v) for v in cfg32.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(int(v) for v in cfg32.MODEL.HEATMAP_SIZE)
    data = SyntheticPoseDataset(4, image_size, 2 * (int(cfg32.DISTANCE) - 1),
                                seed=2)
    host = prepare_train_batch(
        np.stack([data[i]["kf"] for i in range(4)]),
        np.stack([data[i]["sup"] for i in range(4)]),
        data.joints, data.vis, int(cfg32.MODEL.SIGMA), image_size,
        heatmap_size, device="cpu")
    return cfg32, host


def dist_stream_model(root, dirs):
    """Phase val's checkpoint in an f32 eval model on the card."""
    from fami_pose_torch.engine import checkpoints
    from fami_pose_torch.engine.runner import Runner
    from fami_pose_torch.models.fami_pose import FAMIPose

    cfg, args = val_cfg(root, dirs, "TPU.COMPUTE_DTYPE", "float32")
    path = checkpoints.get_latest_checkpoint(
        Runner(cfg, args).dirs["checkpoints"])
    model = FAMIPose.from_config(cfg, phase="validate")
    model.load_state_dict(checkpoints.load_variables(path))
    return model.cuda().eval()


def dist_stream_frames():
    """Seeded normalised frames of the streams: (T, 8, 3, 384, 288)."""
    gen = torch.Generator().manual_seed(3)
    return torch.randn(DIST_STREAM_FRAMES, DIST_STREAMS, 3, 384, 288,
                       generator=gen).cuda()


DIST_TASKS = {"nccl_one_rank": dist_nccl_one_rank,
              "nccl_two_ranks": dist_nccl_two_ranks,
              "two_ranks": dist_two_ranks}


def distributed_worker(task, rank, world, port, work_dir):
    """A rank of phase distributed (``run_ranks``): TF32 off as in the
    parent, the task, its result saved for the parent."""
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(work_dir, "context.json")) as f:
        ctx = dict(json.load(f), rank=int(rank), world=int(world),
                   port=int(port), dir=work_dir)
    result = DIST_TASKS[task](ctx)
    torch.save(result, os.path.join(work_dir, f"{task}_rank{rank}.pt"))
    if task == "nccl_two_ranks":
        # NCCL's communicator is in its error state: no teardown
        sys.stdout.flush()
        os._exit(0)
    dist.destroy_process_group()


def phase_distributed(smi, root, dirs):
    """The data-parallel path (``parallel/mesh.py``) on the one card; see
    the module docstring. Returns the launches of its train and val paths,
    summed over the ranks."""
    from fami_pose_torch.engine.streaming import StreamingPosePredictor

    t0 = time.perf_counter()
    work = os.path.join(root, "distributed")
    os.makedirs(work)
    with open(os.path.join(work, "context.json"), "w") as f:
        json.dump({"root": root, "dirs": list(dirs)}, f)

    # (a) one rank over NCCL, in a process of its own
    (one,), _ = run_ranks("nccl_one_rank", 1, work)
    emit("distributed-one-rank", card=smi, **one)
    # two NCCL ranks on the one card: what NCCL answers is recorded
    try:
        refusal, _ = run_ranks("nccl_two_ranks", 2, work, timeout=120)
    except subprocess.TimeoutExpired:
        refusal = "no answer within 120 s; both ranks killed"
    emit("distributed-nccl-two-ranks-one-card", card=smi, ranks=refusal)

    # the one-process references of (b), computed here (the f32 step once:
    # phase train-levers holds two such steps bit for bit)
    cfg32, host = cut_depth_step_inputs()
    ref_metrics, ref_grads, _ = one_lever_step(cut_depth_model(cfg32), cfg32,
                                               host, "cuda")
    f32_runner, _ = val_pass(root, dirs, VAL_VIDEOS * VAL_FRAMES * VAL_PEOPLE,
                             "TPU.COMPUTE_DTYPE", "float32")
    ref_preds = (f32_runner.evaluator.all_preds.copy(),
                 f32_runner.evaluator.all_preds_bb.copy())
    del f32_runner
    model = dist_stream_model(root, dirs)
    frames = dist_stream_frames()
    pred = StreamingPosePredictor(model, distance=model.num_sup // 2 + 1,
                                  flip_test=True)
    pred.prime(frames[0])
    ref_stream = [tuple(t.cpu() for t in pred(f)) for f in frames[1:]]
    del model, frames, pred
    torch.cuda.empty_cache()

    # (b) two ranks over gloo
    t1 = time.perf_counter()
    (r0, r1), _ = run_ranks("two_ranks", 2, work)
    ranks_s = time.perf_counter() - t1
    failures = []

    def need(ok, what):
        if not ok:
            failures.append(what)

    need(r0["digests"] == r1["digests"], "train states differ across ranks")
    need(r0["saves"] == ["epoch_0_state.ckpt.tmp"] and r1["saves"] == [],
         f"checkpoint writes {r0['saves']} / {r1['saves']}")
    need(r0["checkpoints"] == ["epoch_0_state.ckpt"], "checkpoint files")
    need(all(r["resume_bitwise"] and r["resumed_epoch"] == 1
             for r in (r0, r1)), "auto-resume not bit for bit")
    need(r0["steps"] == 3, f"{r0['steps']} steps")
    for r in (r0, r1):
        need(all(r["train_launches"][k] == 12 for k in KERNEL_COUNTERS),
             f"train launches {r['train_launches']}")
    # the f32 step against one process's
    grads = r0["f32_grads"]
    need(all(torch.equal(grads[n], r1["f32_grads"][n]) for n in grads),
         "f32 gradients differ across ranks")

    def rel_l2(a, b):
        num = math.sqrt(sum(float(((a[n].double() - b[n].double()) ** 2)
                                  .sum()) for n in b))
        den = math.sqrt(sum(float((b[n].double() ** 2).sum()) for n in b))
        return num / den

    f32_l2 = rel_l2(grads, ref_grads)
    loss_rel = {k: abs(r0["f32_metrics"][k] - v) / max(abs(v), 1e-12)
                for k, v in ref_metrics.items() if k.startswith("loss")}
    need(f32_l2 <= DIST_GRAD_L2_LIMIT, f"f32 gradient rel L2 {f32_l2}")
    need(max(loss_rel.values()) <= DIST_LOSS_RTOL, f"loss terms {loss_rel}")
    # --val: rank 0 scores, rank 1 returns {}; the same predictions on both
    val = {}
    for name in ("val_f32", "val_int8"):
        a, b = r0[name], r1[name]
        ((path, tables),) = a["results"].items()
        need(set(tables) == {"final", "backbone"}, f"{name} rank 0 tables")
        need(b["results"] == {path: {}}, f"{name} rank 1 returned "
             f"{b['results']}")
        need(a["samples"] == b["samples"] == VAL_VIDEOS * VAL_FRAMES
             * VAL_PEOPLE, f"{name} samples")
        need(all(np.array_equal(a[k], b[k])
                 for k in ("all_preds", "all_preds_bb")),
             f"{name} predictions differ across ranks")
        need(a["scales"] == b["scales"] and a["window"] == b["window"],
             f"{name} scales or window differ across ranks")
        val[name] = dict(mean_ap={t: tables[t]["Mean"] for t in tables},
                         window=a["window"] or "exact",
                         scales=len(a["scales"]),
                         launches_rank0=a["launches"],
                         launches_rank1=b["launches"])
    need(len(r0["val_int8"]["scales"]) == INT8_CONVS, "int8 scales")
    for r in (r0, r1):
        need(all(r["val_int8"]["launches"][k] > 0 for k in INT8_COUNTERS),
             "no int8 launch")
    px = max(float(np.abs(r0["val_f32"][k][..., :2] - ref[..., :2]).max())
             for k, ref in zip(("all_preds", "all_preds_bb"), ref_preds))
    score = max(float(np.abs(r0["val_f32"][k][..., 2] - ref[..., 2]).max())
                for k, ref in zip(("all_preds", "all_preds_bb"), ref_preds))
    need(px <= DIST_PX_TOL, f"f32 val keypoints {px} px from one process's")
    val["val_f32"].update(px_vs_one_process=px,
                          score_vs_one_process=score)
    # streams: 4 a rank, gathered, against one process's 8
    need(r0["stream_local_streams"] == r1["stream_local_streams"] == 4,
         "local streams")
    stream_err, stream_scale = 0.0, 0.0
    for o0, o1, ref in zip(r0["stream"], r1["stream"], ref_stream):
        for a, b, c in zip(o0, o1, ref):
            need(torch.equal(a, b) and a.shape == c.shape,
                 "stream outputs differ across ranks")
            stream_err = max(stream_err, float((a - c).abs().max()))
            stream_scale = max(stream_scale, float(c.abs().max()))
    need(stream_err <= STREAM_F32_TOL * stream_scale,
         f"streams {stream_err} from one process's (scale {stream_scale})")
    # (c) the model axis, in the same two ranks
    m0, m1 = r0["model_axis"], r1["model_axis"]
    model_axis = check_model_axis(m0, m1, ref_grads, ref_metrics, ref_preds,
                                  need)
    readings = {f"rank{r['rank']}": r["readings"] for r in (r0, r1)}
    report = dict(
        card=smi, note=DIST_NOTE,
        model="FAMIPose HRNet-W48 384x288 bf16 D=4 num_sup=4",
        train=dict(global_batch=8, per_rank=4, steps=r0["steps"],
                   launches_rank0=r0["train_launches"],
                   launches_rank1=r1["train_launches"],
                   states_bitwise_equal=r0["digests"] == r1["digests"],
                   checkpoint_writes=dict(rank0=r0["saves"],
                                          rank1=r1["saves"]),
                   resume_bitwise=[r0["resume_bitwise"],
                                   r1["resume_bitwise"]]),
        f32_step=dict(
            model="W48 at one module of one block a stage branch, 256x192, "
            "tame seeded weights, global batch 4 (2 a rank), TF32 off",
            grad_rel_l2_vs_one_process=f32_l2,
            limit=DIST_GRAD_L2_LIMIT, loss_rel_vs_one_process=loss_rel,
            loss_rtol=DIST_LOSS_RTOL),
        val=val,
        streams=dict(streams=DIST_STREAMS, per_rank=4,
                     frames=DIST_STREAM_FRAMES, max_abs_vs_one_process=
                     stream_err, scale=stream_scale,
                     tol=f"STREAM_F32_TOL x scale = "
                     f"{STREAM_F32_TOL * stream_scale}",
                     launches_rank0=r0["stream_launches"]),
        model_axis=model_axis,
        readings=readings, two_ranks_s=ranks_s,
        phase_seconds=time.perf_counter() - t0)
    emit("distributed", **report)
    if failures:
        raise AssertionError(f"phase distributed: {failures}")
    launches = {k: sum(r[p][k] for r in (r0, r1)
                       for p in ("train_launches", "f32_launches",
                                 "stream_launches"))
                + sum(r[v]["launches"][k] for r in (r0, r1)
                      for v in ("val_f32", "val_int8"))
                + sum(r[p][k] for r in (m0, m1)
                      for p in ("train_launches", "f32_launches"))
                + sum(r["val"]["launches"][k] for r in (m0, m1))
                for k in KERNEL_COUNTERS}
    launches.update({k: sum(r["val_int8"]["launches"][k] for r in (r0, r1))
                     for k in INT8_COUNTERS})
    for k in KERNEL_COUNTERS:
        launches[k] += one["launches"][k]
    return launches


def main():
    t_start = time.perf_counter()
    timeline = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        timeline[name] = time.perf_counter() - t0
        return out

    smi = phase_device()
    sys.path.insert(0, ROOT)
    hgmma = timed("build", phase_build)
    rows = timed("kernels", phase_kernels, hgmma)
    reset_launches()
    pred, serving, model_dcn, batch = timed("main", phase_main)
    if any(read_launches()[k] for k in ("dcn_bwd", "warp_bwd")):
        raise AssertionError("the serving path launched a backward kernel")
    timed("card-vs-cpu", phase_card_vs_cpu, pred)
    streaming, stream_bf16 = timed("streaming", phase_streaming, pred, batch)
    del pred
    torch.cuda.empty_cache()
    train, model_dcn_bwd, train_exact = timed("train", phase_train, smi)
    timed("train-card-vs-cpu", phase_train_card_vs_cpu)
    torch.cuda.empty_cache()
    levers, validate_exact, validate_d4 = timed(
        "train-levers", phase_train_levers, smi)
    torch.cuda.empty_cache()
    probe_launches = timed("probes", phase_probes)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_val_") as root:
        val, dirs = timed("val", phase_val, smi, root)
        torch.cuda.empty_cache()
        int8, int8_rows = timed("int8", phase_int8, smi, root, dirs,
                                stream_bf16)
        torch.cuda.empty_cache()
        block_launches = timed("remainder", phase_remainder, smi, root, dirs)
        torch.cuda.empty_cache()
        jhmdb = timed("jhmdb", phase_jhmdb, smi, root)
        torch.cuda.empty_cache()
        sustain, sustain_rows = timed("sustain", phase_sustain, smi)
        torch.cuda.empty_cache()
        serving_ab, serving_ab_rows = timed(
            "serving-ab", phase_serving_ab, smi, sustain_rows)
        torch.cuda.empty_cache()
        distributed = timed("distributed", phase_distributed, smi, root,
                            dirs)
    emit("timeline", seconds_by_phase=timeline,
         total_s=time.perf_counter() - t_start)
    csrc = "fami_pose_torch/ops/cuda/csrc/"
    replaces = {
        "dcn_fwd": "fami_pose_tpu/ops/pallas/dcn.py:1063",
        "dcn_bwd": "fami_pose_tpu/ops/pallas/dcn_bwd.py:530",
        "warp_translate": "fami_pose_tpu/ops/pallas/warp.py:119",
        "warp_bwd": "none: XLA VJP (fami_pose_tpu/ops/pallas/warp.py:165)",
    }
    sources = {"dcn_fwd": "dcn_fwd.cu", "dcn_bwd": "dcn_bwd.cu",
               "warp_translate": "warp.cu", "warp_bwd": "warp_bwd.cu"}
    # one row per kernel and shape: the forward kernels have a row for each
    # path whose calls differ in size (serving, train and train-levers at
    # B=8, val and validate_real_checkpoint at B=32); `launches` is the
    # count of that row's paths, each also given alone
    validate = {k: validate_exact[k] + validate_d4[k] for k in validate_exact}
    kernels = []
    for name in KERNEL_COUNTERS:
        common = dict(name=name, route="cuda", source=csrc + sources[name],
                      replaces=replaces[name])
        if name == "warp_translate":
            kernels.append(dict(
                common, path="val and validate_real_checkpoint",
                launches=val[name] + validate[name],
                launches_val=val[name],
                launches_validate_real_checkpoint=validate[name],
                **rows[name, 128]))
            kernels.append(dict(
                common, path="serving and streaming",
                launches=serving[name] + streaming[name],
                launches_serving=serving[name],
                launches_streaming=streaming[name], **rows[name, 32]))
            kernels.append(dict(
                common, path="train, train-levers and distributed",
                launches=train[name] + levers[name] + distributed[name],
                launches_train=train[name],
                launches_train_levers=levers[name],
                launches_distributed=distributed[name], **rows[name, 8]))
        elif name == "dcn_fwd":
            kernels.append(dict(
                common, path="val and validate_real_checkpoint",
                launches=val[name] + validate[name], launches_val=val[name],
                launches_validate_real_checkpoint=validate[name],
                **rows[name, 32]))
            kernels.append(dict(
                common, path="serving, streaming, train, train-levers and "
                "distributed",
                launches=(serving[name] + streaming[name] + train[name]
                          + levers[name] + distributed[name]),
                launches_serving=serving[name],
                launches_streaming=streaming[name], launches_train=train[name],
                launches_train_levers=levers[name],
                launches_distributed=distributed[name],
                model_inputs=model_dcn, **rows[name]))
        elif name == "warp_bwd":
            kernels.append(dict(
                common, path="train, train-levers and distributed",
                launches=train[name] + levers[name] + distributed[name],
                launches_train=train[name],
                launches_train_levers=levers[name],
                launches_distributed=distributed[name],
                **rows[name, 8, "bfloat16"]))
            kernels.append(dict(common, path="none: the shape of 32 images, "
                                "timed for comparison", launches=0,
                                **rows[name, 32, "bfloat16"]))
        else:  # dcn_bwd
            kernels.append(dict(
                common, path="train, train-levers and distributed",
                launches=train[name] + levers[name] + distributed[name],
                launches_train=train[name],
                launches_train_levers=levers[name],
                launches_distributed=distributed[name],
                model_inputs=model_dcn_bwd, **rows[name, 4]))
            # the exact mode (TPU.DCN_MAX_OFFSET 0): phase train's two
            # 3-step runs of the W48 model, the kernel timed at the main
            # path's shape with |t| up to 6 px
            kernels.append(dict(
                common, path="train with TPU.DCN_MAX_OFFSET 0 (exact DCN)",
                launches=train_exact[name], **rows[name, 0]))
            kernels.append(dict(common, path="none: the val path's batch of "
                                "32, timed and repeated for comparison",
                                launches=0, **rows[name, 32]))
        if name in ("dcn_fwd", "dcn_bwd"):
            # the deform blocks (phase remainder): exact, dilation 1, one
            # group without a mask (DeformBlock) or two with one
            # (AdaptBlockV2), at each width case; launches of phase
            # remainder's run of a block at that width
            for dtype, c, c_out, groups, _ in BLOCK_DCN_CASES:
                key = block_case_key(dtype, c, c_out, groups)
                kernels.append(dict(
                    common, path="deform blocks",
                    launches=block_launches[key][name],
                    launches_of="phase remainder's train step of one block "
                    "at this width", width=key,
                    blocks="AdaptBlockV2" if groups == 2 else "DeformBlock",
                    **rows[name, "blocks", key]))
        # the Sub-JHMDB path (phase jhmdb): its eval step, train epoch and
        # --val, each driven with the counts set to 0 just before it
        kernels.append(dict(
            common, path="Sub-JHMDB (configs/jhmdb/fami_pose.yaml)",
            launches=jhmdb[name], **rows[name, "jhmdb"]))
        # the sustained run, its A/B and int8 numerics (phase sustain)
        kernels.append(dict(common, path=SUSTAIN_PATH,
                            launches=sustain[name],
                            **sustain_rows[name, "sustain"]))
        # the flip-trained run and its A/Bs (phase serving-ab)
        kernels.append(dict(common, path=SERVING_AB_PATH,
                            launches=serving_ab[name],
                            **serving_ab_rows[name, "serving-ab"]))
    for name in INT8_COUNTERS:
        kernels.append(dict(
            name=name, route="cuda", source=csrc + "int8_conv.cu",
            replaces=INT8_REPLACES, path="val with the serving levers "
            "(TPU.INT8_EVAL), one process and two ranks",
            launches=int8[name] + distributed[name],
            launches_distributed=distributed[name], **int8_rows[name]))
        kernels.append(dict(
            name=name, route="cuda", source=csrc + "int8_conv.cu",
            replaces=INT8_REPLACES, path=SUSTAIN_PATH + ": the A/B's int8 "
            "rows and int8_numerics --ckpt", launches=sustain[name],
            **sustain_rows[name, "sustain"]))
        kernels.append(dict(
            name=name, route="cuda", source=csrc + "int8_conv.cu",
            replaces=INT8_REPLACES, path=SERVING_AB_PATH + ": flip_ab's "
            "int8 rows", launches=serving_ab[name],
            **serving_ab_rows[name, "serving-ab"]))
    for name, (_, _, line, _) in PROBES.items():
        kernels.append(dict(
            name=name, route="cuda", source=csrc + "probes.cu",
            replaces=f"tools/mosaic_watch.py:{line}", path="probes",
            launches=probe_launches[name], **rows[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        distributed_worker(*sys.argv[2:])
    else:
        main()
