"""Time the DCN kernels of this tree against an earlier version, in turns,
on one card.

    python -m fami_pose_torch.tools.dcn_turns --old-dir OLD_CSRC \\
        [--rounds N] [--trained FILE] [--out dcn_turns.json]

``OLD_CSRC`` holds another version's ``dcn_fwd.cu``, ``dcn_bwd.cu`` and the
``dcn_common.cuh`` they were written against (for example ``git show
<commit>:fami_pose_torch/ops/cuda/csrc/<file>`` written into a git-ignored
directory). The tool builds both sources with ``nvcc`` and this tree's flags
into a library of their own and calls each library's ``fami_dcn_fwd`` /
``fami_dcn_bwd`` through ``ctypes`` on the same buffers: an old library
without ``fami_dcn_fwd_workspace`` has the entries of before the kernels
took every width (no workspace; the backward's ``dw_part`` and
``dw_slots``); one whose ``fami_dcn_bwd_workspace`` does not take
``max_offset`` (before the dx gather) is called without it, one whose
source names ``kDcol`` (a dx form chosen by type) with ``dtype`` after it,
and one whose ``fami_dcn_bwd`` takes ``dx_acc`` (the exact mode's float
atomics, before its sorted lists) with that buffer and a workspace entry
that does not take the input plane; a forward workspace entry that does not
take the batch and output plane is called without them. For the main
path's calls (B=8 and the val path's B=32, 96x72, C = C_out = 48, 12
groups, D = 4; B=8 at D = 8, the auto window's widest, and in the exact
mode), Sub-JHMDB's (B=8, 64x64, D = 6), the deform blocks' (exact,
dilation 1, B=8: every bf16 width of ``chip_smoke.BLOCK_DCN_CASES``, among
them the six rows of HRNet-W48's branches at C = 96, 192 and 384 with one
and two groups, and C = 64 with one group, also on a smooth offset field)
the main path's exact mode with ~1,000 sources of each image's first plane
on one floor corner (a hot spot: the longest key list ~1,000 long) and,
with ``--trained FILE``, one DCN's captured inputs (a ``torch.save``
of ``{"x", "offset", "mask", "weight", "gout", "max_offset"}``, 3x3,
dilation and padding 3) with their trained offsets and with them zeroed:

  * compares the outputs (the forward bit for bit where the arithmetic is
    the same; the backward's largest difference: the libraries sum dx in
    other orders; in the exact mode, where both sum in the same fixed
    order, whether dx is bit for bit the old library's);
  * counts the elements of each backward output that differ between two
    calls of the same library (0 where it sums in a fixed order);
  * sums the six branch rows' forward and backward times of each library,
    per turn;
  * times each device-side (``chip_smoke.device_ms``: 20 launches in one
    replayed CUDA graph), in the order old, tree, tree, old (``--rounds``
    times), then the backward with its inputs outside the L2
    (``chip_smoke.device_ms_cold``: a 96 MB read before each call, less
    the read alone), old, tree, tree, old;
  * records each library's backward workspace, in float32 elements.

Then, this tree alone: the chunked forward's cost of sampling a pixel tile
again for each C_out tile of 64 (C = 384 at 12x9, B = 8, exact, C_out 64,
one tile, against 384, six); each kernel's device time in one backward
call of the exact rows (``torch.profiler`` over 10 calls, ms a call); and,
as a yardstick beside the exact mode's dx (a reading only, never a path of
the port), one ``Tensor.index_put_(..., accumulate=True)`` of the main
path's precomputed (input pixel, m * w * dcol row) pairs under
``torch.use_deterministic_algorithms(True)``: the library's sort-based
deterministic scatter of the same sum, in its own order.

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


def workspace_args(csrc_dir):
    """What the backward's entries of the sources in ``csrc_dir`` take:
    ``max_offset`` past ``groups`` in the workspace entry (since the dx
    gather), ``dtype`` after it (where the source chooses a dx form by
    type), ``dx_acc`` (the exact mode's scatter buffer, before its sorted
    lists; without it the workspace entry takes the input plane H, W);
    ``fwd_call``, whether the forward's workspace entry takes the call's
    batch and output plane (since the reduction is cut across items)."""
    with open(os.path.join(csrc_dir, "dcn_bwd.cu")) as f:
        text = f.read()
    with open(os.path.join(csrc_dir, "dcn_fwd.cu")) as f:
        fwd = f.read()
    return {"max_offset": "kMaxGatherR" in text, "dtype": "kDcol" in text,
            "dx_acc": "void* dx_acc" in text,
            "fwd_call": "fami_dcn_fwd_workspace(int dtype, int B" in fwd}


def load_old(old_dir, workdir):
    """Build the old DCN sources into one shared library and load it;
    returns it and its entries: ``current``, this tree's entries (a
    workspace each), and :func:`workspace_args`."""
    so = os.path.join(workdir, "libold_dcn.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                    os.path.join(old_dir, "dcn_fwd.cu"),
                    os.path.join(old_dir, "dcn_bwd.cu"), "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    current = hasattr(lib, "fami_dcn_fwd_workspace")
    abi = dict(workspace_args(old_dir), current=current)
    for name in ("fami_dcn_fwd", "fami_dcn_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = build.SIGNATURES[name] if current else OLD_ABI[name]
        fn.restype = ctypes.c_int
    if current and abi["dx_acc"]:
        lib.fami_dcn_bwd.argtypes = [P] * 12 + [I] * 13 + [F, P]
    if current:
        lib.fami_dcn_fwd_workspace.argtypes = [I] * (8 if abi["fwd_call"]
                                                     else 5)
        lib.fami_dcn_bwd_workspace.argtypes = (
            [I] * (8 + 2 * (not abi["dx_acc"])) + [F] * abi["max_offset"]
            + [I] * abi["dtype"])
        for name in ("fami_dcn_fwd_workspace", "fami_dcn_bwd_workspace"):
            getattr(lib, name).restype = ctypes.c_longlong
    return lib, abi


def smooth_offsets(gen, inputs, cells=(12, 9), std=8.0):
    """``inputs`` with each offset plane replaced by a smooth field: an
    ~N(0, std) field on a coarse grid of ``cells``, bilinearly upsampled to
    the plane, so that neighbouring pixels sample near each other (as a
    trained model's offsets do) and not i.i.d."""
    x, off, msk, wgt = inputs
    coarse = torch.randn(off.shape[0], off.shape[1], *cells, generator=gen,
                         device=off.device) * std
    field = torch.nn.functional.interpolate(
        coarse, size=off.shape[2:], mode="bilinear", align_corners=True)
    return x, field.to(off.dtype), msk, wgt


def hot_corner(inputs, count=1000, dilation=3, point=(48.25, 24.5)):
    """``inputs`` (a 3x3 DCN, padding = dilation) with the first ``count``
    sources (tap-major: tap 0's output pixels first) of each image's first
    group sampled at ``point``: that many sources on one floor corner,
    whose four corners all weigh more than 0 (the offsets exact in bf16 at
    96 x 72)."""
    x, off, msk, wgt = inputs
    b, _, h, w = off.shape
    dev = off.device
    o = off.float().view(b, -1, 9, 2, h * w).clone()
    k = torch.arange(9, device=dev).view(9, 1)
    pix = torch.arange(h * w, device=dev).view(1, h * w)
    base_y = pix // w + (k // 3 - 1) * dilation
    base_x = pix % w + (k % 3 - 1) * dilation
    pick = (k * h * w + pix) < count
    o[:, 0, :, 0] = torch.where(pick, point[0] - base_y, o[:, 0, :, 0])
    o[:, 0, :, 1] = torch.where(pick, point[1] - base_x, o[:, 0, :, 1])
    return x, o.view(off.shape).to(off.dtype), msk, wgt


def scatter_pairs(x, off, msk, wgt, gout, padding, dilation):
    """The exact-mode dx as (row, contribution) pairs: row = (image, group,
    input pixel) of dx laid out (B, G, H, W, Cg), contribution = m * w *
    dcol of one source's corner (Cg floats), for every corner of non-zero
    weight on the image; float32. Returns (rows, contributions, B*G*H*W)."""
    n, c, h, w = x.shape
    c_out = wgt.shape[0]
    g = off.shape[1] // 18
    cg = c // g
    hwo = h * w
    dev = x.device
    o = off.float().view(n, g, 9, 2, hwo)
    fl = torch.floor(o)
    frac = o - fl
    md = torch.einsum("ock,nop->nkcp", wgt.float().view(c_out, c, 9),
                      gout.float().view(n, c_out, hwo))
    md = md.reshape(n, 9, g, cg, hwo).permute(0, 2, 1, 4, 3)
    if msk is not None:
        md = md * msk.float().view(n, g, 9, hwo, 1)
    md = md.reshape(-1, cg)
    pix = torch.arange(hwo, device=dev)
    taps = torch.arange(9, device=dev)
    y0 = ((pix // w - padding).view(1, 1, 1, hwo)
          + (taps // 3 * dilation).view(1, 1, 9, 1) + fl[:, :, :, 0])
    x0 = ((pix % w - padding).view(1, 1, 1, hwo)
          + (taps % 3 * dilation).view(1, 1, 9, 1) + fl[:, :, :, 1])
    plane = torch.arange(n * g, device=dev).view(n, g, 1, 1)
    ly, lx = frac[:, :, :, 0], frac[:, :, :, 1]
    rows, contribs = [], []
    for cy, cx in ((1, 1), (1, 0), (0, 1), (0, 0)):
        qy, qx = y0 + cy, x0 + cx
        wt = (ly if cy else 1 - ly) * (lx if cx else 1 - lx)
        hit = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w) & (wt != 0)
        rows.append(((plane * h + qy) * w + qx)[hit].long())
        contribs.append(wt[hit].unsqueeze(1) * md[hit.reshape(-1)])
    return torch.cat(rows), torch.cat(contribs), n * g * h * w


def library_scatter_ms(rows, contribs, n_rows, reps=5):
    """Device time (CUDA events, best of ``reps`` after two warm-up calls)
    of one ``index_put_(..., accumulate=True)`` of the pairs into a zeroed
    (n_rows, Cg) float32 buffer, under
    ``torch.use_deterministic_algorithms(True)``; returns (ms, buffer)."""
    out = torch.zeros(n_rows, contribs.shape[1], device=rows.device)
    torch.use_deterministic_algorithms(True)
    try:
        best = float("inf")
        for i in range(2 + reps):
            out.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out.index_put_((rows,), contribs, accumulate=True)
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                best = min(best, start.elapsed_time(end))
    finally:
        torch.use_deterministic_algorithms(False)
    return best, out


def kernel_split(fn, calls=10):
    """Each CUDA kernel's device ms a call of ``fn`` (``torch.profiler``
    over ``calls`` calls after three warm-up calls), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            split[e.key[:80]] = us / 1e3 / calls
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def ptr(t):
    return None if t is None else t.data_ptr()


def stream():
    """The stream current at the call (``device_ms`` captures on a stream
    of its own)."""
    return torch.cuda.current_stream().cuda_stream


class Calls:
    """The forward and backward of one library on one case's buffers;
    ``abi`` as :func:`load_old` returns it."""

    def __init__(self, lib, abi, inputs, conv):
        x, off, msk, wgt = inputs
        b, c, h, w = x.shape
        cout = wgt.shape[0]
        self.x, self.off, self.msk, self.wgt = x, off, msk, wgt
        current = abi["current"]
        self.lib, self.current = lib, current
        self.dx_acc = not current or abi["dx_acc"]
        self.dims = (1, b, c, h, w, cout, h, w, 3, 3, *conv)
        self.out = torch.empty(b, cout, h, w, device="cuda", dtype=x.dtype)
        self.xg = torch.empty_like(x)
        self.grads = [torch.empty_like(x), torch.empty_like(off),
                      None if msk is None else torch.empty_like(msk),
                      torch.empty_like(wgt)]
        self.acc = (torch.empty(x.shape, device="cuda") if self.dx_acc
                    else None)
        if current:
            code = 1 if x.dtype == torch.bfloat16 else 0
            size = (lib.fami_dcn_fwd_workspace(code, b, c, cout, h, w, 3, 3)
                    if abi["fwd_call"] else
                    lib.fami_dcn_fwd_workspace(code, c, cout, 3, 3))
            self.work = torch.empty(max(size, 16), dtype=torch.uint8,
                                    device="cuda") if size else None
            d = (conv[3],) if abi["max_offset"] else ()  # where taken
            d += (1 if x.dtype == torch.bfloat16 else 0,) * abi["dtype"]
            plane = () if abi["dx_acc"] else (h, w)  # stride 1, "same"
            self.workspace = lib.fami_dcn_bwd_workspace(
                b, c, cout, *plane, h, w, 3, 3, conv[2], *d)
            self.part = torch.empty(self.workspace, device="cuda")
        else:  # the kernels of before: 3 taps a block, 2 blocks an SM
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            self.slots = -(-2 * sms // 3)
            self.workspace = self.slots * 3 * cout * 3 * c
            self.part = torch.empty(self.workspace, device="cuda")
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
                ptr(self.wgt), ptr(self.gout), *map(ptr, self.grads))
        head += (ptr(self.acc),) * self.dx_acc + (ptr(self.part),)
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
    p.add_argument("--trained", default="",
                   help="a torch.save of one DCN's captured inputs (x, "
                   "offset, mask, weight, gout, max_offset)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dcn_turns: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import (
        BLOCK_DCN_CASES, HRNET_W48_BRANCHES, JHMDB_BATCH, JHMDB_DCN_D,
        JHMDB_PLANE, block_dcn_inputs, dcn_inputs, device_ms, device_ms_cold,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    cases = {
        "main B=8 D=4": (lambda: dcn_inputs(gen, bf16, 4), (3, 3, 12, 4.0)),
        "val B=32 D=4": (lambda: dcn_inputs(gen, bf16, 4, b=32),
                         (3, 3, 12, 4.0)),
        "Sub-JHMDB B=8 D=6": (
            lambda: dcn_inputs(gen, bf16, JHMDB_DCN_D, b=JHMDB_BATCH,
                               h=JHMDB_PLANE[0], w=JHMDB_PLANE[1]),
            (3, 3, 12, float(JHMDB_DCN_D))),
        "main B=8 D=8": (lambda: dcn_inputs(gen, bf16, 8), (3, 3, 12, 8.0)),
        "main B=8 exact": (lambda: dcn_inputs(gen, bf16, 0),
                           (3, 3, 12, 0.0)),
        "main B=8 exact, 1,000 sources on one corner": (
            lambda: hot_corner(dcn_inputs(gen, bf16, 0)), (3, 3, 12, 0.0)),
        "blocks C=64 G=1 exact": (
            lambda: block_dcn_inputs(gen, bf16, 64, 64, 1, (96, 72)),
            (1, 1, 1, 0.0)),
        "blocks C=64 G=1 exact, smooth offsets": (
            lambda: smooth_offsets(gen, block_dcn_inputs(
                gen, bf16, 64, 64, 1, (96, 72))), (1, 1, 1, 0.0)),
    }
    # the deform blocks' bf16 widths; the six at HRNet-W48's narrower
    # branches are summed per turn
    branches = []
    for dtype, c, c_out, g, hw in BLOCK_DCN_CASES:
        if dtype != bf16:
            continue
        name = f"blocks C={c} C_out={c_out} G={g} exact"
        if (c, hw) in HRNET_W48_BRANCHES[1:] and c == c_out:
            branches.append(name)
        cases[name] = ((lambda c=c, c_out=c_out, g=g, hw=hw: block_dcn_inputs(
            gen, bf16, c, c_out, g, hw)), (1, 1, g, 0.0))
    # the exact rows whose backward is split by kernel (this tree)
    exact_split = ("main B=8 exact", "blocks C=64 G=1 exact",
                   "main B=8 exact, 1,000 sources on one corner")
    gouts = {}
    if args.trained:
        saved = torch.load(args.trained, map_location="cuda")
        d = float(saved["max_offset"])
        conv = (3, 3, saved["offset"].shape[1] // 18, d)
        inputs = (saved["x"], saved["offset"], saved["mask"],
                  saved["weight"])
        for kind, off in (("trained", inputs[1]),
                          ("zeroed", torch.zeros_like(inputs[1]))):
            name = f"captured inputs, {kind} offsets"
            cases[name] = ((lambda i=inputs, o=off: (i[0], o, *i[2:])), conv)
            gouts[name] = saved["gout"]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        old, abi = load_old(os.path.abspath(args.old_dir), tmp)
        tree = build.load_library()
        tree_abi = dict(workspace_args(build.CSRC), current=True)
        for name, (make, conv) in cases.items():
            inputs = make()
            calls = {"old": Calls(old, abi, inputs, conv),
                     "tree": Calls(tree, tree_abi, inputs, conv)}
            gout = gouts.get(name)
            if gout is None:
                gout = torch.randn(calls["old"].out.shape, generator=gen,
                                   device="cuda").to(inputs[0].dtype)
            for c in calls.values():
                c.gout = gout
                c.fwd()
                c.bwd()
            torch.cuda.synchronize()
            names = ("dx", "doffset", "dmask", "dweight")
            diff = {k: float((a.float() - b.float()).abs().max())
                    for k, a, b in zip(names, calls["tree"].grads,
                                       calls["old"].grads) if b is not None}
            repeat = {}
            for which, c in calls.items():
                first = [None if g is None else g.clone() for g in c.grads]
                c.bwd()
                torch.cuda.synchronize()
                repeat[which] = {k: int((a != b).sum()) for k, a, b in zip(
                    names, c.grads, first) if b is not None}
            for kernel, what in (("dcn_fwd", "fwd"), ("dcn_bwd", "bwd")):
                row = {"case": name, "kernel": kernel,
                       "shape": list(inputs[0].shape), "D": conv[3],
                       "dtype": str(inputs[0].dtype)[6:]}
                if kernel == "dcn_fwd":
                    row["bitwise_equal"] = bool(torch.equal(
                        calls["old"].out, calls["tree"].out))
                else:
                    row["max_abs_diff"] = diff
                    row["dx_elements_differing"] = int(
                        (calls["tree"].grads[0] != calls["old"].grads[0])
                        .sum())
                    if conv[3] <= 0:
                        row["dx_bit_for_bit"] = bool(torch.equal(
                            calls["tree"].grads[0], calls["old"].grads[0]))
                    row["differing_in_a_second_call"] = repeat
                    row["workspace_floats"] = {
                        k: c.workspace for k, c in calls.items()}
                for which in ("old", "tree", "tree", "old") * args.rounds:
                    row.setdefault(f"{which}_ms", []).append(device_ms(
                        getattr(calls[which], what), launches=20))
                if kernel == "dcn_bwd":
                    for which in ("old", "tree", "tree", "old"):
                        row.setdefault(f"{which}_cold_ms", []).append(
                            device_ms_cold(calls[which].bwd, launches=20))
                rows.append(row)
                print(json.dumps(row), flush=True)
            if conv[3] <= 0 and name in exact_split:
                row = {"case": name, "kernel": "dcn_bwd",
                       "tree_split_ms": kernel_split(calls["tree"].bwd)}
                if name == "main B=8 exact":
                    pairs = scatter_pairs(*inputs, gout, conv[0], conv[1])
                    ms, out = library_scatter_ms(*pairs)
                    b, c, h, w = inputs[0].shape
                    g = conv[2]
                    lib_dx = out.view(b, g, h, w, c // g).permute(
                        0, 1, 4, 2, 3).reshape(b, c, h, w)
                    row["library_index_put_ms"] = ms
                    row["library_pairs"] = int(pairs[0].numel())
                    row["library_max_abs_diff_to_tree_dx"] = float(
                        (lib_dx - calls["tree"].grads[0].float()).abs()
                        .max())
                    del pairs, out, lib_dx
                rows.append(row)
                print(json.dumps(row), flush=True)
            del calls, inputs, gout
        for kernel in ("dcn_fwd", "dcn_bwd"):
            parts = [r for r in rows
                     if r["case"] in branches and r["kernel"] == kernel]
            row = {"case": "sum of the six branch rows", "kernel": kernel,
                   "cases": branches}
            for key in ("old_ms", "tree_ms"):
                row[key] = [sum(vals) for vals in zip(*(r[key]
                                                        for r in parts))]
            rows.append(row)
            print(json.dumps(row), flush=True)
        # the chunked forward: C_out tiles of 64 each sample the tile again
        row = {"case": "chunked forward, C = 384, 12x9, B = 8, exact",
               "kernel": "dcn_fwd"}
        for cout in (64, 384):
            inputs = block_dcn_inputs(gen, bf16, 384, cout, 1, (12, 9))
            c = Calls(tree, tree_abi, inputs, (1, 1, 1, 0.0))
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
