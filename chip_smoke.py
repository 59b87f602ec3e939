#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fami_pose_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each (``[phase] {json}``), then the kernel table
line ``{"kernels": [...]}``, the card's ``nvidia-smi`` name and power limit,
and as the last line ``{"ok": true, "device": {...}}``:

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
               D in {4, 3, exact}, the warp at 128 images). Each kernel call
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
               called twice for bitwise equal outputs. Then the four
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
               ``loss_mse`` falling), one more step traced with
               torch.profiler, and one in which ``dcn_1``'s inputs and the
               gradient of its output are captured by hooks: ``dcn_bwd`` on
               them against its plain version, timed device-side.
  7. train-card-vs-cpu - f32, TF32 off, full W48 width at 256x192, B=2: the
               loss terms and every parameter's gradient of one train-mode
               forward and backward on the card against the port on the CPU
               (the head per tensor, the whole model as one vector), and the
               backbone's gradients in float64 per tensor.

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
               the forward; and ``fami_pose_torch.tools.int8_numerics`` at
               W48, 384x288. The build phase counts the implicit GEMM's
               ``IGMMA`` instructions and reads its registers and spills
               from ``-Xptxas -v``.

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
            m = re.search(r"(dcn_(?:fwd|bwd))_bf16_kernelILi(\d+)ELi(\d+)E",
                          line)
            g = re.search(r"igemm_kernelI(13__nv_bfloat16|f)Li(\d+)E", line)
            if m:
                row, op = counts.setdefault(m.group(1), {}), "HGMMA"
                key = f"{m.group(1)}_bf16_kernel<{m.group(2)}, {m.group(3)}>"
            elif g:
                row, op = counts.setdefault("int8_implicit_gemm", {}), "IGMMA"
                dt = "float" if g.group(1) == "f" else "bf16"
                key = f"igemm_kernel<{dt}, {g.group(2)}>"
            if row is not None:
                row[key] = 0
        elif row is not None and op in line:
            row[key] += 1
    return counts


def ptxas_usage(log):
    """Registers and spill bytes of each int8 conv kernel instance, from
    ``-Xptxas -v`` output: {"igemm_kernel<bf16, 48>" ...: [registers,
    spill stores, spill loads]}."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            g = re.search(r"(igemm_kernel|quant_nhwc_kernel)I(13__nv_bfloat16"
                          r"|f)(?:Li(\d+)E)?", m.group(1))
            name = g and (f"{g.group(1)}<"
                          f"{'float' if g.group(2) == 'f' else 'bf16'}"
                          + (f", {g.group(3)}>" if g.group(3) else ">"))
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
    emit("build", seconds=round(seconds, 3),
         library=os.path.relpath(so, ROOT), sources=list(build.SOURCES),
         hgmma=hgmma, int8_registers_spill_stores_spill_loads=usage or
         "not rebuilt in this process (the library was cached)")
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
            # backward (dx is summed with atomics: its last bits vary)
            gout = torch.randn(got.shape, generator=gen,
                               device="cuda").to(dtype)
            run_k = lambda: deform_conv2d_backward(x, off, msk, wgt, gout,
                                                   max_offset=d, **kw)
            run_p = lambda: deform_conv2d_backward_plain(
                x, off, msk, wgt, gout, max_offset=d, **kw)
            got_b = run_kernel(f"dcn_bwd D={d} {dtype}", run_k)
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
                 "DCN's gradients")
            if dtype == torch.bfloat16 and d == 4:
                rows["dcn_bwd"] = dict(shape=list(x.shape), max_abs_err=worst,
                                       ms=k_ms, host_paced_ms=host_ms,
                                       timing=DCN_TIMING, plain_ms=p_ms,
                                       bound_ms=bnd, bound_by=by,
                                       library_ms=None,
                                       hgmma=hgmma["dcn_bwd"])

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
        del x, off, msk, got
    torch.cuda.empty_cache()

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


def steady_stream(model, crops, span, steps=20):
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
    (synchronised, 20 steps), key frames/s, device-busy ms of one traced
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
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d_backward, deform_conv2d_windowed,
    )
    from fami_pose_torch.ops.int8_conv import implicit_gemm, quant_nhwc
    from fami_pose_torch.ops.warp import (
        warp_translate, warp_translate_backward,
    )

    return dict(zip(KERNEL_COUNTERS + INT8_COUNTERS, (
        deform_conv2d_windowed, deform_conv2d_backward, warp_translate,
        warp_translate_backward, quant_nhwc, implicit_gemm,
    )))


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


def check_gradients(model):
    """Every parameter's gradient finite; the DCN weights, the offset and
    mask convs, the offset head and the backbone's stem with non-zero norm.
    Returns the norms of the named groups."""
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
            norms[n] = float(grads[n].float().norm())
            if not norms[n] > 0.0:
                raise AssertionError(f"zero gradient for {n} ({group})")
    return norms


def dcn_bwd_on_model_inputs(trainer, state, batch):
    """``dcn_bwd`` on the model's own inputs and gradient: ``dcn_1``'s (x,
    offset, mask, weight) captured by a forward hook and the gradient of its
    output by a tensor hook during one bf16 train step, the kernel held
    against its plain version on them and timed device-side; the offsets'
    spread and their share past D."""
    from fami_pose_torch.models.fami_pose import DCN_DILATION
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d_backward, deform_conv2d_backward_plain,
    )

    module = state.model.dcn_1
    seen, grads = [], []

    def capture(mod, args, out):
        if not seen:
            seen.append(tuple(a.detach().clone() for a in args)
                        + (mod.weight.detach().clone(),))
            out.register_hook(lambda g: grads.append(g.detach().clone()))

    hook = module.register_forward_hook(capture)
    try:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    x, off, msk, wgt = seen[0]
    # as DeformConv.forward hands them to the kernel
    off, msk, wgt = off.to(x.dtype), msk.to(x.dtype), wgt.to(x.dtype)
    # the seeded model's gradient at dcn_1 is tiny (~1e-17): scaled by a
    # power of two to a largest entry in [1, 2), exactly in bf16 (the
    # gradients are linear in it), so that the tolerances, 2^-7 of the
    # larger of 1 and each gradient's scale, bound something
    raw_max = float(grads[0].float().abs().max())
    if not raw_max > 0:
        raise AssertionError(f"dcn_1's output gradient is {raw_max}")
    exponent = -math.floor(math.log2(raw_max))
    gout = grads[0] * 2.0 ** exponent
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


def phase_train(smi, batch=8, epoch_steps=4, timed_steps=7, split_steps=3,
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
             checkpoint=resumed_note)
    return launches, model_dcn_bwd


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
# 3.1-4.8% under 1e-6 input noise over NOISE_SEEDS and 9.2% under 1e-5
# (PERF.md, Findings): the limit lies above the first and below the second.
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
      another order, atomics, BatchNorm over as few as 8 values in the
      offset head);
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


def write_val_fixture(root, seed=0, w=640, h=480):
    """A seeded synthetic PoseTrack17-style dataset under ``root``: jpeg
    frames ``images/video_000v/0000000f.jpg`` (8 digits from 1), the COCO
    json ``json/posetrack_val.json`` with 17 visible keypoints and a box per
    person, and GT annolists ``annolists/video_000v.json`` in the 15-joint
    order. Returns (json_dir, img_dir, annot_dir)."""
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


INT8_OPTS = ("TPU.INT8_EVAL", True, "TPU.INT8_CALIB_BATCHES", 2,
             "TPU.DCN_AUTO_WINDOW", True)
# the int8 convs of one W48 FAMIPose forward: the backbone's 292 (all but
# final_layer) and the 15 of the head's three residual chains, which share
# the backbone's mode in the JAX model
INT8_BACKBONE_CONVS, INT8_CONVS = 292, 307
INT8_REPLACES = ("none: XLA's s8 conv_general_dilated "
                 "(fami_pose_tpu/models/quant.py:102-111)")
INT8_TIMING = ("ms: 20 launches in one CUDA graph, fastest of 3 replays; "
               "plain_ms: 3 calls made one by one")
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
        quant_nhwc=time_ms(lambda: quant_nhwc_plain(x, act), iters=3,
                           warmup=1),
        implicit_gemm=time_ms(lambda: implicit_gemm_plain(
            xq, wp, ws, act, None, out_dtype=torch.bfloat16, **geo),
            iters=3, warmup=1))
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
    return dict(
        conv=name, c_in=key[0], c_out=key[1], hw=[key[2], key[3]],
        kernel=key[4], stride=key[5], frames=key[6], rows=m_rows, k=k,
        kp=wp.shape[1], np=wp.shape[0], cp=xq.shape[3],
        convs_per_forward=g["count"], bitwise_equal=True, ms=ms,
        plain_ms=plain_ms, bound_ms={kk: v[0] for kk, v in bounds.items()},
        bound_by={kk: v[1] for kk, v in bounds.items()})


def int8_kernel_rows(geometries):
    """The two kernels' rows of the kernel table: times, bounds and plain
    times summed over the int8 convs of one forward (each geometry times
    the number of its convs), the whole conv's time and bound likewise, the
    yardsticks (``_int_mm`` on the im2col matrix and cuDNN's bf16 conv) and
    the largest geometry's own numbers."""
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
            shape=(f"all {INT8_CONVS} int8 convs of one B=8 eval forward "
                   f"(40 frames of 384x288; {len(geometries)} geometries)"),
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
        ms = time_ms(lambda: step(kf, sup), iters=5, warmup=2)
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


def main():
    smi = phase_device()
    sys.path.insert(0, ROOT)
    rows = phase_kernels(phase_build())
    reset_launches()
    pred, serving, model_dcn, batch = phase_main()
    if any(read_launches()[k] for k in ("dcn_bwd", "warp_bwd")):
        raise AssertionError("the serving path launched a backward kernel")
    phase_card_vs_cpu(pred)
    streaming, stream_bf16 = phase_streaming(pred, batch)
    del pred
    torch.cuda.empty_cache()
    train, model_dcn_bwd = phase_train(smi)
    phase_train_card_vs_cpu()
    torch.cuda.empty_cache()
    probe_launches = phase_probes()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_val_") as root:
        val, dirs = phase_val(smi, root)
        torch.cuda.empty_cache()
        int8, int8_rows = phase_int8(smi, root, dirs, stream_bf16)
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
    # path whose calls differ in size (serving and train at B=8, val at
    # B=32); `launches` is the count of that row's path
    kernels = []
    for name in KERNEL_COUNTERS:
        common = dict(name=name, route="cuda", source=csrc + sources[name],
                      replaces=replaces[name])
        if name == "warp_translate":
            kernels.append(dict(common, path="val", launches=val[name],
                                **rows[name, 128]))
            kernels.append(dict(
                common, path="serving and streaming",
                launches=serving[name] + streaming[name],
                launches_serving=serving[name],
                launches_streaming=streaming[name], **rows[name, 32]))
            kernels.append(dict(common, path="train", launches=train[name],
                                **rows[name, 8]))
        elif name == "dcn_fwd":
            kernels.append(dict(common, path="val", launches=val[name],
                                **rows[name, 32]))
            kernels.append(dict(
                common, path="serving, streaming and train",
                launches=serving[name] + streaming[name] + train[name],
                launches_serving=serving[name],
                launches_streaming=streaming[name], launches_train=train[name],
                model_inputs=model_dcn, **rows[name]))
        elif name == "warp_bwd":
            kernels.append(dict(common, path="train", launches=train[name],
                                **rows[name, 8, "bfloat16"]))
            kernels.append(dict(common, path="none: the shape of 32 images, "
                                "timed for comparison", launches=0,
                                **rows[name, 32, "bfloat16"]))
        else:  # dcn_bwd
            kernels.append(dict(common, path="train", launches=train[name],
                                model_inputs=model_dcn_bwd, **rows[name]))
    for name in INT8_COUNTERS:
        kernels.append(dict(
            name=name, route="cuda", source=csrc + "int8_conv.cu",
            replaces=INT8_REPLACES, path="val with the serving levers "
            "(TPU.INT8_EVAL)", launches=int8[name], **int8_rows[name]))
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
    main()
