"""Time the DCN kernels of this tree against an earlier version, in turns,
on one card.

    python -m fami_pose_torch.tools.dcn_turns --old-dir OLD_CSRC \\
        [--rounds N] [--out dcn_turns.json]

``OLD_CSRC`` holds another version's ``dcn_fwd.cu``, ``dcn_bwd.cu`` and the
``dcn_common.cuh`` they were written against (for example ``git show
<commit>:fami_pose_torch/ops/cuda/csrc/<file>`` written into a git-ignored
directory). The tool builds both sources with ``nvcc`` and this tree's flags
into a library of their own and calls each library's ``fami_dcn_fwd`` /
``fami_dcn_bwd`` through ``ctypes`` on the same buffers: an old library
without ``fami_dcn_fwd_workspace`` has the entries of before the kernels
took every width (no workspace; the backward's ``dw_part`` and
``dw_slots``). For the main path's calls (B=8 and the val path's B=32,
96x72, C = C_out = 48, 12 groups, D = 4) and the deform blocks' C = 64
(exact, dilation 1, one group):

  * compares the outputs (the forward bit for bit where the arithmetic is
    the same; the backward's largest difference: dx is summed with
    atomics);
  * times each device-side (``chip_smoke.device_ms``: 20 launches in one
    replayed CUDA graph), in the order old, tree, tree, old (``--rounds``
    times).

Then, this tree alone, the chunked forward's cost of sampling a pixel tile
again for each C_out tile of 64: C = 384 at 12x9, B = 8, exact, C_out 64
(one tile) against 384 (six).

It prints one JSON line per case and the card's name and power limit, and
writes them all to ``--out``. Needs a CUDA device and ``nvcc``; run it from
the root of a checkout.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from fami_pose_torch.ops.cuda import build

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_ABI = {"fami_dcn_fwd": [P] * 6 + [I] * 13 + [F, P],
           "fami_dcn_bwd": [P] * 12 + [I] * 14 + [F, P]}


def load_old(old_dir, workdir):
    """Build the old DCN sources into one shared library and load it;
    returns it and whether it has this tree's entries."""
    so = os.path.join(workdir, "libold_dcn.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                    os.path.join(old_dir, "dcn_fwd.cu"),
                    os.path.join(old_dir, "dcn_bwd.cu"), "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    current = hasattr(lib, "fami_dcn_fwd_workspace")
    for name in ("fami_dcn_fwd", "fami_dcn_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = build.SIGNATURES[name] if current else OLD_ABI[name]
        fn.restype = ctypes.c_int
    if current:
        for name, n in (("fami_dcn_fwd_workspace", 5),
                        ("fami_dcn_bwd_workspace", 8)):
            getattr(lib, name).argtypes = [I] * n
            getattr(lib, name).restype = ctypes.c_longlong
    return lib, current


def ptr(t):
    return None if t is None else t.data_ptr()


def stream():
    """The stream current at the call (``device_ms`` captures on a stream
    of its own)."""
    return torch.cuda.current_stream().cuda_stream


class Calls:
    """The forward and backward of one library on one case's buffers.
    ``current``: the library has this tree's entries (a workspace each)."""

    def __init__(self, lib, current, inputs, conv):
        x, off, msk, wgt = inputs
        b, c, h, w = x.shape
        cout = wgt.shape[0]
        self.x, self.off, self.msk, self.wgt = x, off, msk, wgt
        self.lib, self.current = lib, current
        self.dims = (1, b, c, h, w, cout, h, w, 3, 3, *conv)
        self.out = torch.empty(b, cout, h, w, device="cuda", dtype=x.dtype)
        self.xg = torch.empty_like(x)
        self.grads = [torch.empty_like(x), torch.empty_like(off),
                      None if msk is None else torch.empty_like(msk),
                      torch.empty_like(wgt)]
        self.acc = torch.empty(x.shape, device="cuda")
        if current:
            size = lib.fami_dcn_fwd_workspace(1, c, cout, 3, 3)
            self.work = torch.empty(max(size, 16), dtype=torch.uint8,
                                    device="cuda") if size else None
            self.part = torch.empty(lib.fami_dcn_bwd_workspace(
                b, c, cout, h, w, 3, 3, conv[2]), device="cuda")
        else:  # the kernels of before: 3 taps a block, 2 blocks an SM
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            self.slots = -(-2 * sms // 3)
            self.part = torch.empty(self.slots * 3 * cout * 3 * c,
                                    device="cuda")
        self.gout = None

    def fwd(self):
        head = (ptr(self.x), ptr(self.xg), ptr(self.off), ptr(self.msk),
                ptr(self.wgt), ptr(self.out))
        if self.current:
            head += (ptr(self.work),)
        err = self.lib.fami_dcn_fwd(*head, *self.dims, stream())
        if err != 0:
            raise RuntimeError(f"fami_dcn_fwd: CUDA error {err} at launch")

    def bwd(self):
        head = (ptr(self.x), ptr(self.xg), ptr(self.off), ptr(self.msk),
                ptr(self.wgt), ptr(self.gout), *map(ptr, self.grads),
                ptr(self.acc), ptr(self.part))
        if not self.current:
            head += (self.slots,)
        err = self.lib.fami_dcn_bwd(*head, *self.dims, stream())
        if err != 0:
            raise RuntimeError(f"fami_dcn_bwd: CUDA error {err} at launch")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--old-dir", required=True,
                   help="a directory with an earlier dcn_fwd.cu, dcn_bwd.cu "
                   "and dcn_common.cuh")
    p.add_argument("--out", default="")
    p.add_argument("--rounds", type=int, default=1,
                   help="times the order old, tree, tree, old is run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dcn_turns: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import block_dcn_inputs, dcn_inputs, device_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    cases = {
        "main B=8 D=4": (lambda: dcn_inputs(gen, bf16, 4), (3, 3, 12, 4.0)),
        "val B=32 D=4": (lambda: dcn_inputs(gen, bf16, 4, b=32),
                         (3, 3, 12, 4.0)),
        "blocks C=64 G=1 exact": (
            lambda: block_dcn_inputs(gen, bf16, 64, 64, 1, (96, 72)),
            (1, 1, 1, 0.0)),
    }
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        old, current = load_old(os.path.abspath(args.old_dir), tmp)
        tree = build.load_library()
        for name, (make, conv) in cases.items():
            inputs = make()
            calls = {"old": Calls(old, current, inputs, conv),
                     "tree": Calls(tree, True, inputs, conv)}
            gout = torch.randn(calls["old"].out.shape, generator=gen,
                               device="cuda").to(bf16)
            for c in calls.values():
                c.gout = gout
                c.fwd()
                c.bwd()
            torch.cuda.synchronize()
            diff = {k: float((a.float() - b.float()).abs().max())
                    for k, a, b in zip(("dx", "doffset", "dmask", "dweight"),
                                       calls["tree"].grads,
                                       calls["old"].grads) if b is not None}
            for kernel, what in (("dcn_fwd", "fwd"), ("dcn_bwd", "bwd")):
                row = {"case": name, "kernel": kernel,
                       "shape": list(inputs[0].shape), "dtype": "bfloat16"}
                if kernel == "dcn_fwd":
                    row["bitwise_equal"] = bool(torch.equal(
                        calls["old"].out, calls["tree"].out))
                else:
                    row["max_abs_diff"] = diff
                for which in ("old", "tree", "tree", "old") * args.rounds:
                    row.setdefault(f"{which}_ms", []).append(device_ms(
                        getattr(calls[which], what), launches=20))
                rows.append(row)
                print(json.dumps(row), flush=True)
            del calls, inputs, gout
        # the chunked forward: C_out tiles of 64 each sample the tile again
        row = {"case": "chunked forward, C = 384, 12x9, B = 8, exact",
               "kernel": "dcn_fwd"}
        for cout in (64, 384):
            inputs = block_dcn_inputs(gen, bf16, 384, cout, 1, (12, 9))
            c = Calls(tree, True, inputs, (1, 1, 1, 0.0))
            row[f"c_out_{cout}_ms"] = device_ms(c.fwd, launches=20)
            del c, inputs
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
