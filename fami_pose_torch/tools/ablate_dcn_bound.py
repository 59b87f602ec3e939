"""The DCN window's op-level deviation from the exact DCN over offset scales,
and on a trained checkpoint's own offsets.

    python -m fami_pose_torch.tools.ablate_dcn_bound \\
        [--offsets-from <ckpt> --motion drift --occlude 0.4] [--tiny] \\
        [--image-size 96 128] [--device cuda]

The counterpart of the JAX repository's ``tools/ablate_dcn_bound.py``, the
table behind its ``docs/DCN_OFFSET_BOUND.md``. The window clamps every
offset to ``[-D, D]`` where the exact DCN does not; on the seeded inputs of
the JAX tool (``RandomState(19970808)``: n = 2, 96x72, C = 48 -> 17, 12
offset groups, dilation 3, mask ~ U(0, 1), weights ~ N(0, 0.1^2), offsets
~ N(0, sigma^2) for sigma in 0.5, 1, 2, 4, 8, drawn in that order) and
for D in 4 and 6, each row gives:

  * ``clip%``: the share of offsets past the window;
  * ``max|dY|``: the largest elementwise deviation from the exact output,
    and ``rel_err``, that over the exact output's largest magnitude
    (``scale``);
  * ``kpt>0px%`` and ``kpt_max_px``: the output's channels decoded as
    heatmaps (argmax, ``ops/heatmap.py::get_max_preds``), the share of
    keypoints that move and the largest move, in output pixels.

With ``--offsets-from`` it adds one row per D and DCN stage whose inputs
are the trained model's: each stage's own input, offsets, mask and weight
in the first eval batch of the checkpoint's fixture (``tools/ab_dcn_bound.py``:
the exact DCN, forward pre-hooks on ``dcn_1..4``), in the model's compute
dtype. ``--motion`` and ``--occlude`` must be the checkpoint's.

On ``--device cuda`` every row runs ``dcn_fwd``: the window at D, and its
exact mode (window 0) for the reference; on the CPU both are its plain
version. Each report row carries the kernel launches it made.
"""

import argparse
import json
import shutil
import tempfile

import numpy as np
import torch

from fami_pose_torch.engine.checkpoints import load_variables
from fami_pose_torch.engine.evaluator import Evaluator
from fami_pose_torch.models.fami_pose import DCN_DILATION
from fami_pose_torch.ops import launch_counts, launches_since
from fami_pose_torch.ops.deform_conv import deform_conv2d_windowed
from fami_pose_torch.ops.heatmap import get_max_preds

from .ab_dcn_bound import dcn_capture, dcn_stages, eval_cfg
from .sustained_train import write_fixture

SEED = 19970808
SIGMAS = (0.5, 1.0, 2.0, 4.0, 8.0)
WINDOWS = (4, 6)


def seeded_inputs():
    """The JAX tool's draws, NHWC numpy: (x, weight (3, 3, C, C_out), mask,
    the random stream for the offsets)."""
    rng = np.random.RandomState(SEED)
    n, h, w, c, g, k, c_out = 2, 96, 72, 48, 12, 9, 17
    x = rng.randn(n, h, w, c).astype(np.float32)
    wgt = (rng.randn(3, 3, c, c_out) * 0.1).astype(np.float32)
    msk = rng.rand(n, h, w, g * k).astype(np.float32)
    return x, wgt, msk, rng


def decode(y):
    """argmax decode of (N, C, H, W) channels: (N, C, 2) numpy."""
    return get_max_preds(y.float().cpu())[0].numpy()


def row(label, d, x, off, msk, wgt, dilation=3):
    """One row on NCHW tensors: the window at ``d`` against the exact mode."""
    before = launch_counts()
    kw = dict(padding=dilation, dilation=dilation)
    exact = deform_conv2d_windowed(x, off, msk, wgt, max_offset=0, **kw)
    windowed = deform_conv2d_windowed(x, off, msk, wgt, max_offset=d, **kw)
    launched = launches_since(before)
    dev = float((windowed.float() - exact.float()).abs().max())
    scale = float(exact.float().abs().max())
    moved = np.sqrt(((decode(windowed) - decode(exact)) ** 2).sum(-1))
    return dict(sigma=label, D=int(d),
                clip_pct=int((off.float().abs() > d).sum()) / off.numel()
                * 100,
                max_dev=dev, rel_err=dev / scale, scale=scale,
                kpt_moved_pct=float((moved > 0).mean()) * 100,
                kpt_max_px=float(moved.max()), dtype=str(x.dtype)[6:],
                shape=list(x.shape), launches=launched)


def seeded_rows(device):
    x, wgt, msk, rng = seeded_inputs()

    def t(a):  # NHWC -> NCHW on the device
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(a, (0, 3, 1, 2)))).to(device)

    xt, mt = t(x), t(msk)
    wt = torch.from_numpy(np.ascontiguousarray(
        np.transpose(wgt, (3, 2, 0, 1)))).to(device)
    rows = []
    for sigma in SIGMAS:
        off = (rng.randn(*x.shape[:3], 2 * msk.shape[-1]) * sigma).astype(
            np.float32)
        for d in WINDOWS:
            rows.append(row(sigma, d, xt, t(off), mt, wt))
    return rows


@torch.inference_mode()
def trained_inputs(ckpt, motion, occlude, tiny, image_size, device, root):
    """Each DCN stage's (x, offset, mask, weight) in the first eval batch of
    the checkpoint's fixture, the exact DCN; and that forward's launches."""
    write_fixture(root, motion, occlude)
    cfg = eval_cfg(root, tiny=tiny, image_size=image_size)
    cfg.TPU.DCN_MAX_OFFSET = 0
    ev = Evaluator(cfg, output_dirs={"results": root}, device=device)
    ev.model.load_state_dict(ckpt if isinstance(ckpt, dict)
                             else load_variables(ckpt))
    before = launch_counts()
    with dcn_capture(ev.model, keep_first=True) as rec:
        ev.model(*ev._prepare(next(iter(ev.loader))))
    launched = launches_since(before)
    return {f"dcn_{i}": tuple(t.clone() for t in rec["first"][m])
            for i, m in enumerate(dcn_stages(ev.model), 1)}, launched


def run(offsets_from=None, motion=None, occlude=0.0, tiny=False,
        image_size=(96, 128), device="cuda", root=None):
    """The seeded rows, and with ``offsets_from`` (a checkpoint path, or a
    model ``state_dict``) the trained rows; returns ``(report, stages)``:
    the JSON line's dict, and each DCN stage's trained (x, offset, mask,
    weight) by name (empty without ``offsets_from``)."""
    report = dict(tool="fami_pose_torch.tools.ablate_dcn_bound",
                  device=str(device), seed=SEED,
                  rows=seeded_rows(device))
    if offsets_from is None:
        return report, {}
    own_root = root is None
    root = root or tempfile.mkdtemp(prefix="ablate_dcn_")
    try:
        stages, launched = trained_inputs(offsets_from, motion, occlude,
                                          tiny, image_size, device, root)
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)
    report.update(motion=motion, occlude=occlude, tiny=tiny,
                  capture_launches=launched,
                  ckpt=(offsets_from if isinstance(offsets_from, str)
                        else "state_dict"))
    for d in WINDOWS:
        for name, (x, off, msk, wgt) in stages.items():
            # as DeformConv.forward hands them to the kernel
            dt = x.dtype
            r = row(f"trained {name}", d, x, off.to(dt), msk.to(dt),
                    wgt.to(dt), dilation=DCN_DILATION)
            r["offsets_abs_p99"] = float(np.percentile(
                off.float().abs().cpu().numpy(), 99))
            r["offsets_abs_max"] = float(off.float().abs().max())
            report["rows"].append(r)
    return report, stages


def print_tables(report):
    print(f"{'sigma':>13} {'D':>3} {'clip%':>7} {'max|dY|':>9} "
          f"{'rel_err':>9} {'kpt>0px%':>9} {'kpt_max_px':>10}")
    for r in report["rows"]:
        s = r["sigma"]
        label = f"{s:13.1f}" if isinstance(s, float) else f"{s:>13}"
        print(f"{label} {r['D']:3d} {r['clip_pct']:7.2f} "
              f"{r['max_dev']:9.4f} {r['rel_err']:9.5f} "
              f"{r['kpt_moved_pct']:9.2f} {r['kpt_max_px']:10.2f}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--offsets-from", default=None, metavar="CKPT",
                   help="add rows on this tools/sustained_train.py "
                        "checkpoint's trained DCN inputs")
    p.add_argument("--motion", default=None,
                   choices=[None, "drift", "articulated"],
                   help="the fixture's motion: the checkpoint's own")
    p.add_argument("--occlude", type=float, default=0.0,
                   help="the fixture's occlusion rate: the checkpoint's own")
    p.add_argument("--tiny", action="store_true",
                   help="a sustained_train.py --tiny checkpoint")
    p.add_argument("--image-size", type=int, nargs=2, default=[96, 128],
                   metavar=("W", "H"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    report, _ = run(args.offsets_from, args.motion, args.occlude, args.tiny,
                    args.image_size, args.device)
    print_tables(report)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
