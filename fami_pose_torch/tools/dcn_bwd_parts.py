"""The DCN backward's kernels one by one, by batch size, on one card.

    python -m fami_pose_torch.tools.dcn_bwd_parts [--batches 2 4 8 16] \\
        [--rounds N] [--out chiprun_out/dcn_bwd_parts.jsonl]

For the main path's call (96x72, C = C_out = 48, 12 groups, D = 4, bf16,
``chip_smoke.dcn_inputs``) at each batch size, ``torch.profiler`` over 10
calls of ``deform_conv2d_backward`` gives each kernel's device ms a call;
the dx gather's is also given a image. In windowed mode the gather reads
the main kernel's float32 m * dcol scratch (12 MB an image): at B = 4 it
fits the 50 MB L2, from B = 8 on it goes through device memory, so the
gather's ms a image against B shows what that round trip costs.

It prints one JSON line per batch and round and the card's name and power
limit, and writes the lines to ``--out``. Needs a CUDA device and
``nvcc``; run it from the root of a checkout.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def kernel_ms(prof, calls):
    """Device ms a call of each CUDA kernel the profile saw, by name."""
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / calls
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, nargs="+", default=[2, 4, 8, 16])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dcn_bwd_parts: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import dcn_inputs
    from fami_pose_torch.ops.deform_conv import deform_conv2d_backward
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(padding=3, dilation=3, offset_groups=12, max_offset=4)
    calls = 10
    rows = []
    for rnd in range(args.rounds):
        for b in args.batches:
            x, off, msk, wgt = dcn_inputs(gen, torch.bfloat16, 4, b=b)
            gout = torch.randn(b, 48, 96, 72, generator=gen,
                               device="cuda").to(torch.bfloat16)
            for _ in range(3):
                deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
                torch.cuda.synchronize()
            ms = kernel_ms(prof, calls)
            row = {"round": rnd, "B": b, "ms_a_call": ms,
                   "gather_ms_a_image": ms.get("dx_gather_kernel", 0.0) / b,
                   "card": smi}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, off, msk, wgt, gout
            torch.cuda.empty_cache()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
