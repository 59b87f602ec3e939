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
               the main-path shapes: the DCN at B=8, 48 channels, 96x72,
               12 groups, D in {4, 1, exact}, f32 and bf16, offsets drawn
               past D; the translation warp at (32, 48, 96, 72) with shifts
               past +-26. Kernel, plain and library times (CUDA events).
  4. main    - ``PosePredictor`` on ``configs/posetrack17/fami_pose.yaml``
               (HRNet-W48, 384x288, bf16, D=4, 4 supporting frames,
               flip-test as under VAL.FLIP_VAL) with seeded random weights,
               on a synthetic 10-frame 480x640 clip with 2 boxes a frame
               (20 requests, batches of 8). Launch counts of every kernel in
               that run, output checks, latency and clips/s; then one B=8
               batch split into crop / forward / backbone, and traced with
               torch.profiler (device busy share, top operators).
  5. card-vs-cpu - the same weights in f32, one key frame: final heatmaps of
               the CUDA path against the port on the CPU (plain versions).

Any failure raises: the script exits non-zero and prints no last line.
"""

import copy
import json
import math
import os
import subprocess
import sys
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


def phase_build():
    from fami_pose_torch.ops.cuda import build

    t0 = time.perf_counter()
    so = build.build(verbose=True)
    build.load_library()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=os.path.relpath(so, ROOT), sources=list(build.SOURCES))


def dcn_inputs(gen, dtype, d, b=8, c=48, h=96, w=72, g=12):
    dev = "cuda"
    spread = 1.5 * d if d > 0 else 6.0  # a third of the offsets past D
    x = torch.randn(b, c, h, w, generator=gen, device=dev).to(dtype)
    off = ((torch.rand(b, 2 * g * 9, h, w, generator=gen, device=dev) * 2 - 1)
           * spread).to(dtype)
    msk = torch.rand(b, g * 9, h, w, generator=gen, device=dev).to(dtype)
    wgt = (torch.randn(c, c, 3, 3, generator=gen, device=dev) * 0.05).to(dtype)
    return x, off, msk, wgt


def phase_kernels():
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d, deform_conv2d_windowed,
    )
    from fami_pose_torch.ops.warp import warp_translate, warp_translate_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for d in (4, 1, 0):
            x, off, msk, wgt = dcn_inputs(gen, dtype, d)
            kw = dict(padding=3, dilation=3, offset_groups=12)
            run_k = lambda: deform_conv2d_windowed(x, off, msk, wgt, max_offset=d, **kw)
            run_p = lambda: deform_conv2d(x, off, msk, wgt, max_offset=d, **kw)
            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            err, tol = check_close(f"dcn D={d} {dtype}", got, ref, dtype)
            past = float((off.float().abs() > d).float().mean()) if d else 0.0
            k_ms = time_ms(run_k)
            p_ms = time_ms(run_p, iters=5, warmup=1)
            b, c, h, w = x.shape
            ops = 2 * b * h * w * 9 * c * c + 9 * b * h * w * 9 * c
            bnd, by = bound_ms(nbytes(x, off, msk, wgt, got), ops, dtype)
            emit("kernels", kernel="dcn_fwd", dtype=str(dtype)[6:], D=d,
                 shape=list(x.shape), offsets_past_D=round(past, 4),
                 max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms,
                 bound_ms=bnd, bound_by=by,
                 library_ms=None, library="none: no single PyTorch call "
                 "computes a modulated DCN (no torchvision on the machine)")
            if dtype == torch.bfloat16 and d == 4:
                rows["dcn_fwd"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                       bound_ms=bnd, bound_by=by,
                                       library_ms=None)

    for dtype in (torch.float32, torch.bfloat16):
        n, c, h, w = 32, 48, 96, 72
        img = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
        offs = (torch.rand(n, 2, generator=gen, device="cuda") * 2 - 1) * 40.0
        run_k = lambda: warp_translate(img, offs, max_shift=26)
        run_p = lambda: warp_translate_plain(img, offs, max_shift=26)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        err, tol = check_close(f"warp {dtype}", got, ref, dtype)
        # library yardstick: grid_sample (bilinear, zeros) at p - clamp(t)
        t = offs.clamp(-26, 26)
        ys = torch.arange(h, device="cuda", dtype=torch.float32)
        xs = torch.arange(w, device="cuda", dtype=torch.float32)
        gx = (xs[None, None, :] - t[:, 0, None, None]) * (2.0 / (w - 1)) - 1
        gy = (ys[None, :, None] - t[:, 1, None, None]) * (2.0 / (h - 1)) - 1
        grid = torch.stack(torch.broadcast_tensors(gx, gy), dim=-1).to(dtype)
        run_l = lambda: torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)
        lib_err = max_err(run_l(), ref)
        k_ms, p_ms, l_ms = time_ms(run_k), time_ms(run_p), time_ms(run_l)
        bnd, by = bound_ms(nbytes(img, offs, got), 9 * img.numel(), dtype)
        past = float((offs.abs() > 26).float().mean())
        emit("kernels", kernel="warp_translate", dtype=str(dtype)[6:],
             shape=[n, c, h, w], max_shift=26, shifts_past_clamp=past,
             max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
             bound_by=by, library_ms=l_ms,
             library="F.grid_sample(bilinear, zeros, align_corners=True) on "
             "a precomputed grid", library_max_abs_err=lib_err)
        if dtype == torch.bfloat16:
            rows["warp_translate"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
                bound_by=by, library_ms=l_ms,
            )
    return rows


def profile_batch(pred, dev_frames, reqs):
    """One B=8 batch under ``torch.profiler``: the device's busy share (the
    union of the kernels' intervals over the batch's host time, both taken
    under the profiler, whose host overhead makes this a lower bound) and
    the operators with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_batch(dev_frames, reqs)
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
        device_events=len(spans), traced_batch_ms=wall_us / 1e3,
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
    trace = profile_batch(pred, dev_frames, reqs)
    emit("main", config="configs/posetrack17/fami_pose.yaml",
         model="FAMIPose HRNet-W48 384x288 bf16 D=4 num_sup=4 flip_test",
         weights="seeded random init (seed 0)", requests=n_req,
         batches=n_batches, launches=launches,
         run_seconds=wall, latency_ms_per_request=wall / n_req * 1e3,
         clips_per_s=n_req / wall, batch8_ms=batch_ms,
         batch8_clips_per_s=8 / (float(np.median(batch_ms)) / 1e3),
         crop_b8_ms=crop_ms, forward_b8_ms=fwd_ms, backbone_b8_ms=bb_ms,
         head_b8_ms=head_ms,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, trace=trace)
    return pred, launches


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


def main():
    smi = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    rows = phase_kernels()
    pred, launches = phase_main()
    phase_card_vs_cpu(pred)
    kernels = [
        dict(name="dcn_fwd", route="cuda",
             source="fami_pose_torch/ops/cuda/csrc/dcn_fwd.cu",
             replaces="fami_pose_tpu/ops/pallas/dcn.py:1063",
             launches=launches["dcn_fwd"], **rows["dcn_fwd"]),
        dict(name="warp_translate", route="cuda",
             source="fami_pose_torch/ops/cuda/csrc/warp.cu",
             replaces="fami_pose_tpu/ops/pallas/warp.py:119",
             launches=launches["warp_translate"], **rows["warp_translate"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
