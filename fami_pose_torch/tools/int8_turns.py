"""Time the int8 implicit GEMM of this tree against an earlier version, in
turns, on one card.

    python -m fami_pose_torch.tools.int8_turns --old-dir OLD_CSRC \\
        [--rounds N] [--out int8_turns.json]

``OLD_CSRC`` holds another version's ``int8_conv.cu`` and the
``dcn_common.cuh`` it was written against (for example ``git show
<commit>:fami_pose_torch/ops/cuda/csrc/<file>`` written into a git-ignored
directory). The tool builds that source with ``nvcc`` and this tree's flags
into a library of its own and calls each library's
``fami_int8_implicit_gemm`` through ``ctypes`` on the same buffers (the
entry has kept its arguments since the int8 conv's first kernels).

The convs are every int8 conv geometry of one B=8 eval forward of
HRNet-W48 FAMIPose at 384x288 (40 frames through the backbone, 8 through
the head's chains; 307 convs, 32 geometries): seeded weights with
BatchNorm calibrated on seeded noise (``tools.int8_numerics``'s setup),
the int8 scales calibrated on that batch, each geometry's input captured by
``chip_smoke.conv_geometries``. For each geometry it

  * quantizes the input once (this tree's ``quant_nhwc``) and runs both
    libraries on that copy, in float32 and bfloat16: the outputs must be
    equal bit for bit (and equal to ``implicit_gemm_plain``), or the tool
    fails;
  * names the kernel instance this tree runs (``chip_smoke.int8_instance``:
    ``igemm_kernel<bf16, width>`` and its N tiles);
  * times each library device-side in bfloat16, the serving type
    (``chip_smoke.device_ms``: 20 launches in one replayed CUDA graph), in
    the order old, tree, tree, old (``--rounds`` times), then with the
    inputs outside the L2 (``chip_smoke.device_ms_cold``: a 96 MB read
    before each launch, less the read alone), old, tree, tree, old;
  * times, as yardsticks, ``torch._int_mm`` on the conv's int8 im2col matrix
    and cuDNN's bf16 conv on the same shapes.

It prints one JSON line per geometry, then the sums over the forward (each
geometry's times its count of convs) and the card's name and power limit,
and writes them all to ``--out``. Needs a CUDA device and ``nvcc``; run it
from the root of a checkout.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

from fami_pose_torch.ops.cuda import build

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORWARD = dict(batch=8, seed=0, image_size=(288, 384))


def load_old(old_dir, workdir):
    """Build the old ``int8_conv.cu`` into a shared library and load it."""
    so = os.path.join(workdir, "libold_int8.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                    os.path.join(old_dir, "int8_conv.cu"), "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    fn = lib.fami_int8_implicit_gemm
    fn.argtypes = build.SIGNATURES["fami_int8_implicit_gemm"]
    fn.restype = ctypes.c_int
    return lib


def forward_geometries():
    """The seeded, calibrated int8 W48 model's geometries of one B=8
    forward (``chip_smoke.conv_geometries``)."""
    from chip_smoke import conv_geometries

    from fami_pose_torch.models.quant import calibrate
    from fami_pose_torch.tools.int8_numerics import seeded_setup

    s = seeded_setup(FORWARD["batch"], FORWARD["seed"], FORWARD["image_size"],
                     torch.device("cuda"))
    q = s["quant"]
    q.load_state_dict(s["base"].state_dict())
    q.cuda().eval()
    with torch.inference_mode():
        calibrate(q, [(s["kf"], s["sup"])])
    geos = conv_geometries(q, s["kf"], s["sup"])
    return geos, sum(g["count"] for g in geos.values())


class Gemm:
    """One library's implicit GEMM of one conv on the shared buffers."""

    def __init__(self, lib, xq, mod, dtype):
        b, h, w, cp = xq.shape
        self.lib, self.xq, self.mod = lib, xq, mod
        (kh, kw), (sh, sw) = mod.kernel_size, mod.stride
        (ph, pw), (dh, dw) = mod.padding, mod.dilation
        ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        n = mod.weight_q.shape[0]
        self.out = torch.empty(b, n, ho, wo, dtype=dtype, device="cuda")
        self.args = (1 if dtype == torch.bfloat16 else 0, b, h, w, cp, kh,
                     kw, sh, sw, ph, pw, dh, dw, ho, wo, n,
                     *mod.weight_packed.shape)

    def __call__(self):
        m = self.mod
        err = self.lib.fami_int8_implicit_gemm(
            self.xq.data_ptr(), m.weight_packed.data_ptr(),
            m.weight_scale.data_ptr(), m.act_scale.data_ptr(), None,
            self.out.data_ptr(), *self.args,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fami_int8_implicit_gemm: CUDA error {err}")
        return self.out


def geometry_row(key, g, libs, rounds):
    from chip_smoke import device_ms, device_ms_cold, im2col_s8, int8_instance

    from fami_pose_torch.ops.int8_conv import implicit_gemm_plain, quant_nhwc

    mod = g["module"]
    geo = dict(kernel_size=mod.kernel_size, stride=mod.stride,
               padding=mod.padding, dilation=mod.dilation)
    row = dict(conv=g["name"], c_in=key[0], c_out=key[1], hw=[key[2], key[3]],
               kernel=key[4], stride=key[5], frames=key[6],
               convs_per_forward=g["count"])
    for dtype in (torch.float32, torch.bfloat16):
        x = g["x"].to(dtype)
        xq = quant_nhwc(x, mod.act_scale)
        calls = {k: Gemm(lib, xq, mod, dtype) for k, lib in libs.items()}
        outs = {k: c().clone() for k, c in calls.items()}
        torch.cuda.synchronize()
        ref = implicit_gemm_plain(xq, mod.weight_packed, mod.weight_scale,
                                  mod.act_scale, None, out_dtype=dtype, **geo)
        if not (torch.equal(outs["old"], outs["tree"])
                and torch.equal(outs["tree"], ref)):
            raise AssertionError(f"{g['name']} {dtype}: the libraries or the "
                                 "plain version differ")
    row["instance"], row["n_tiles"] = int8_instance(mod)
    row["bitwise_equal"] = True
    for which in ("old", "tree", "tree", "old") * rounds:
        row.setdefault(f"{which}_ms", []).append(
            device_ms(calls[which], launches=20))
    for which in ("old", "tree", "tree", "old"):
        row.setdefault(f"{which}_cold_ms", []).append(
            device_ms_cold(calls[which], launches=20))
    a, wq8 = im2col_s8(x, mod.act_scale, mod)
    wt = wq8.t()
    w16 = mod.weight.detach().to(torch.bfloat16)
    row["int_mm_ms"] = device_ms(lambda: torch._int_mm(a, wt), launches=20)
    row["cudnn_bf16_conv_ms"] = device_ms(lambda: F.conv2d(
        x, w16, None, mod.stride, mod.padding, mod.dilation), launches=20)
    return row


def per_forward(rows):
    """Each timed column summed over the forward (a geometry's time its
    count of convs), the repeated columns per reading."""
    sums = {}
    for key in ("old_ms", "tree_ms", "old_cold_ms", "tree_cold_ms"):
        reads = len(rows[0][key])
        sums[key] = [sum(r["convs_per_forward"] * r[key][i] for r in rows)
                     for i in range(reads)]
    for key in ("int_mm_ms", "cudnn_bf16_conv_ms"):
        sums[key] = sum(r["convs_per_forward"] * r[key] for r in rows)
    for stride in sorted({r["stride"] for r in rows}):
        part = [r for r in rows if r["stride"] == stride]
        sums[f"stride_{stride}_convs"] = sum(r["convs_per_forward"]
                                             for r in part)
        for key in ("old_ms", "tree_ms"):
            sums[f"stride_{stride}_{key}"] = [
                sum(r["convs_per_forward"] * r[key][i] for r in part)
                for i in range(len(rows[0][key]))]
    return sums


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--old-dir", required=True,
                   help="a directory with an earlier int8_conv.cu and "
                   "dcn_common.cuh")
    p.add_argument("--out", default="")
    p.add_argument("--rounds", type=int, default=1,
                   help="times the order old, tree, tree, old is run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_turns: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    geos, convs = forward_geometries()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"old": load_old(os.path.abspath(args.old_dir), tmp),
                "tree": build.load_library()}
        for key, g in sorted(geos.items()):
            row = geometry_row(key, g, libs, args.rounds)
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = dict(forward="one B=8 eval forward of HRNet-W48 FAMIPose at "
                   "384x288, bf16", convs=convs, geometries=len(rows),
                   card=smi, per_forward_ms=per_forward(rows))
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows, "summary": summary}, f,
                      indent=1)


if __name__ == "__main__":
    main()
