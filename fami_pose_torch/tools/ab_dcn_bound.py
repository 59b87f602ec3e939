"""The DCN window and the serving levers, through poseval AP, on a trained
checkpoint of ``tools/sustained_train.py``.

    python -m fami_pose_torch.tools.ab_dcn_bound --ckpt <epoch_149_state.ckpt> \\
        --motion articulated --occlude 0.4 [--bounds 1 2 4 6] [--skip-ap] \\
        [--tiny] [--image-size 96 128] [--device cuda]

The counterpart of the JAX repository's ``tools/ab_dcn_bound_ap.py
--ckpt``. It writes the checkpoint's own fixture again
(``tools/synthetic_fixture.py``: seed 3, joint markers; ``--motion`` and
``--occlude`` must be the run's) with its GT annolists, loads the weights
once and scores them through the real ``Evaluator`` (batch 4, GT boxes,
DARK decode) and the port's poseval, row by row:

  * ``exact``: ``DCN_MAX_OFFSET 0``, the unclamped DCN;
  * ``D=d`` for each ``--bounds`` window, and ``cover``: the smallest
    window at or above every offset the exact row fed the DCN
    (ceil(max |offset|));
  * ``auto``: ``TPU.DCN_AUTO_WINDOW``, with the window it picks for this
    checkpoint;
  * ``int8 D=4``: ``TPU.INT8_EVAL`` at window 4;
  * ``serving``: the levers of ``configs/posetrack18/fami_pose_serving.yaml``
    together (int8, its calibration batches, the auto window, flip-test).

It prints the trained |offset| distribution (p50, p95, p99, max and the
share beyond 1, 2 and 4 px) of the inputs of ``dcn_1..4`` over every eval
batch of the exact row (forward pre-hooks: what the model computes is
untouched), each row's per-joint AP and its delta against exact, the drift
of its DARK-decoded keypoints against exact's in image pixels (p50, p95,
max) and the share of offsets its window clamped in its scoring forwards,
then one JSON line with
all of it. ``--skip-ap`` runs the forwards and the decode only.

``--tiny`` reads a ``sustained_train.py --tiny`` checkpoint (``TINY_EXTRA``,
float32, 4 offset groups). Runs on ``--device`` (default ``cuda``, the
hand-written kernels; ``cpu`` runs their plain versions).
"""

import argparse
import contextlib
import json
import math
import os.path as osp
import shutil
import tempfile

import numpy as np
import torch

from fami_pose_torch.engine.checkpoints import load_variables
from fami_pose_torch.engine.evaluator import Evaluator

from .sustained_train import recipe_cfg, write_fixture
from .synthetic_fixture import write_gt_annolists

DEFAULT_BOUNDS = (1, 2, 4, 6)
INT8_WINDOW = 4
# the levers of configs/posetrack18/fami_pose_serving.yaml
SERVING_LEVERS = ("TPU.INT8_EVAL", True, "TPU.INT8_CALIB_BATCHES", 2,
                  "TPU.DCN_AUTO_WINDOW", True, "VAL.FLIP_VAL", True)
SHARES = (1, 2, 4)


def eval_cfg(root, tiny=False, image_size=(96, 128)):
    """The recipe's model on the fixture under ``root``, scored as the JAX
    A/B scores it: batch 4, GT boxes, the DARK decode, GT annolists."""
    cfg = recipe_cfg(root, image_size=image_size, tiny=tiny)
    cfg.VAL.BATCH_SIZE_PER_GPU = 4
    cfg.VAL.USE_GT_BBOX = True
    cfg.VAL.POST_PROCESS = True
    cfg.VAL.ANNOT_DIR = write_gt_annolists(root)
    return cfg


def dcn_stages(model):
    return [getattr(model, f"dcn_{i}") for i in range(1, 5)]


@contextlib.contextmanager
def dcn_capture(model, keep_first=False):
    """Record what ``dcn_1..4`` are fed while the block runs (forward
    pre-hooks): every offset's magnitude (float32, on the CPU), and for
    each call the stage's window then, how many offsets it got and how
    many lay past the window; with ``keep_first`` each stage's first (x,
    offset, mask) and weight."""
    rec = dict(abs_offsets=[], calls=[], first={})

    def hook(module, args):
        x, off = args[0], args[1]
        mask = args[2] if len(args) > 2 else None
        mag = off.detach().float().abs()
        rec["abs_offsets"].append(mag.flatten().cpu())
        d = module.max_offset
        rec["calls"].append((d, mag.numel(),
                             int((mag > float(d)).sum()) if d else 0))
        if keep_first and module not in rec["first"]:
            rec["first"][module] = tuple(
                None if t is None else t.detach().clone()
                for t in (x, off, mask, module.weight))

    handles = [m.register_forward_pre_hook(hook) for m in dcn_stages(model)]
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()


@torch.inference_mode()
def capture_offsets(model, kf, sup):
    """The offsets ``dcn_1..4`` are fed in one eval forward of ``model`` on
    (kf, sup): the offset convs' outputs, as the DCN reads them."""
    with dcn_capture(model, keep_first=True) as rec:
        model(kf, sup)
    return [rec["first"][m][1] for m in dcn_stages(model)]


def offset_stats(abs_offsets):
    a = torch.cat(abs_offsets).numpy() if abs_offsets else np.zeros(1)
    out = {f"p{q}": float(np.percentile(a, q)) for q in (50, 95, 99)}
    out["max"] = float(a.max())
    out.update({f"share>{d}": float((a > d).mean()) for d in SHARES})
    out["count"] = int(a.size)
    return out


@torch.inference_mode()
def forward_preds(ev, variables):
    """The evaluator's predictions without the protocol: load, int8
    calibration and window as ``eval_checkpoint`` does them, then the eval
    step and the decode over every eval batch. (N, J, 2) image pixels."""
    ev.model.load_state_dict(variables)
    ev.model.to(ev.device).eval()
    ev._maybe_calibrate_int8()
    ev._maybe_auto_window()
    preds = []
    for raw in ev.loader:
        valid = int(raw.get("valid", raw["kf"].shape[0]))
        final_hm, _ = ev.eval_step(*ev._prepare(raw))
        p, _ = ev._decode(final_hm[:valid], raw["center"][:valid],
                          raw["scale"][:valid])
        preds.append(p.cpu().numpy())
    return np.concatenate(preds)


def run_row(ev, variables, skip_ap, keep_first=False):
    """One row: ``(ap or None, preds (N, J, 2), window, capture)``."""
    with dcn_capture(ev.model, keep_first=keep_first) as rec:
        if skip_ap:
            ap, preds = None, forward_preds(ev, variables)
        else:
            name_value, _ = ev.eval_checkpoint(variables)["final"]
            ap = {k: float(v) for k, v in name_value.items()}
            preds = ev.all_preds[:, :, :2].copy()
    return ap, preds, ev.dcn_max_offset, rec


def clamped_share(rec, window):
    """The share of the offsets past ``window`` in the calls made at that
    window (the auto window's measuring forwards ran at the one before)."""
    calls = [(n, c) for d, n, c in rec["calls"] if d == window]
    return sum(c for _, c in calls) / max(1, sum(n for n, _ in calls))


def drift(preds, ref):
    d = np.linalg.norm(preds - ref, axis=-1).ravel()
    return dict(p50=float(np.percentile(d, 50)),
                p95=float(np.percentile(d, 95)), max=float(d.max()))


def row_specs(bounds):
    """(name, config overrides, window set before the row or None)."""
    rows = [(f"D={d}", (), int(d)) for d in bounds]
    rows.append(("auto", ("TPU.DCN_AUTO_WINDOW", True), None))
    rows.append((f"int8 D={INT8_WINDOW}",
                 ("TPU.INT8_EVAL", True, "TPU.DCN_MAX_OFFSET", INT8_WINDOW),
                 None))
    rows.append(("serving", SERVING_LEVERS, None))
    return rows


def run(ckpt, motion=None, occlude=0.0, bounds=DEFAULT_BOUNDS, skip_ap=False,
        tiny=False, image_size=(96, 128), device="cuda", root=None):
    """The A/B, with the fixture under ``root`` (default: a temporary
    directory, removed afterwards); returns ``(report, extras)``: the JSON
    line's dict, and ``extras``: ``dcn_inputs``, each stage's first (x,
    offset, mask, weight) in the exact row, and ``eval_batch``, the first
    eval batch's (kf, sup), on the device."""
    own_root = root is None
    root = root or tempfile.mkdtemp(prefix="ab_dcn_")
    try:
        write_fixture(root, motion, occlude)
        base = eval_cfg(root, tiny=tiny, image_size=image_size)
        variables = load_variables(ckpt)

        def evaluator(name, overrides):
            c = base.clone()
            c.merge_from_list(list(overrides))
            return Evaluator(c, output_dirs={"results": osp.join(
                root, "out", name.replace(" ", "_").replace("=", ""))},
                device=device)

        rows = []
        ev = evaluator("float", ("TPU.DCN_MAX_OFFSET", 0))
        ap, exact_preds, _, rec = run_row(ev, variables, skip_ap,
                                          keep_first=True)
        stats = offset_stats(rec["abs_offsets"])
        print("== trained |offset| distribution (dcn_1..4 inputs, all eval "
              "batches) ==\n" + " ".join(
                  f"{k}={v:.4g}" for k, v in stats.items()), flush=True)
        dcn_inputs = {f"dcn_{i}": rec["first"][m]
                      for i, m in enumerate(dcn_stages(ev.model), 1)}
        eval_batch = ev._prepare(next(iter(ev.loader)))
        rows.append(dict(row="exact", window=None, ap=ap,
                         drift_px=drift(exact_preds, exact_preds),
                         clamped_share=0.0))
        cover = max(1, math.ceil(stats["max"]))
        specs = row_specs(bounds)
        specs.insert(len(bounds), (f"cover D={cover}", (), cover))
        for name, overrides, window in specs:
            if overrides:
                ev = evaluator(name, overrides)
            else:  # the float evaluator at another window
                ev._set_dcn_window(window)
            ap, preds, used, rec = run_row(ev, variables, skip_ap)
            rows.append(dict(
                row=name, window=used, ap=ap,
                drift_px=drift(preds, exact_preds),
                clamped_share=clamped_share(rec, used)))
            print(f"{name}: window {used or 'exact'}, drift vs exact "
                  + " ".join(f"{k}={v:.4g}" for k, v in
                             rows[-1]["drift_px"].items())
                  + (f", Mean AP {ap.get('Mean', float('nan')):.2f}"
                     if ap else ""), flush=True)
        if not skip_ap:
            ref = rows[0]["ap"]
            for r in rows:
                r["ap_delta"] = {k: r["ap"][k] - ref[k] for k in ref}
        report = dict(tool="fami_pose_torch.tools.ab_dcn_bound", ckpt=ckpt,
                      motion=motion, occlude=occlude, tiny=tiny,
                      device=str(device), samples=int(len(exact_preds)),
                      offsets=stats, cover_window=cover, rows=rows)
        return report, dict(dcn_inputs=dcn_inputs, eval_batch=eval_batch)
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)


def print_tables(report):
    rows = report["rows"]
    print("\n== trained |offset| distribution (all eval batches) ==")
    print(" ".join(f"{k}={v:.4g}" for k, v in report["offsets"].items()))
    if rows[0]["ap"] is not None:
        joints = list(rows[0]["ap"])
        print("\n== per-joint AP (final heatmaps) and delta vs exact ==")
        print(f"{'row':12s} {'window':>6s} " + " ".join(
            f"{j:>9s}" for j in joints))
        for r in rows:
            print(f"{r['row']:12s} {str(r['window'] or 'exact'):>6s} "
                  + " ".join(f"{r['ap'][j]:9.3f}" for j in joints))
        for r in rows[1:]:
            print(f"{'d ' + r['row']:12s} {str(r['window'] or 'exact'):>6s} "
                  + " ".join(f"{r['ap_delta'][j]:9.3f}" for j in joints))
    print("\n== decoded-keypoint drift vs exact (DARK, image px) ==")
    print(f"{'row':12s} {'window':>6s} {'clamped':>9s} {'px_p50':>9s} "
          f"{'px_p95':>9s} {'px_max':>9s}")
    for r in rows:
        d = r["drift_px"]
        print(f"{r['row']:12s} {str(r['window'] or 'exact'):>6s} "
              f"{r['clamped_share']:9.2e} {d['p50']:9.4f} {d['p95']:9.4f} "
              f"{d['max']:9.4f}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="a tools/sustained_train.py checkpoint")
    p.add_argument("--motion", default=None,
                   choices=[None, "drift", "articulated"])
    p.add_argument("--occlude", type=float, default=0.0)
    p.add_argument("--bounds", type=int, nargs="+",
                   default=list(DEFAULT_BOUNDS))
    p.add_argument("--skip-ap", action="store_true",
                   help="forwards and decoded drift only, no poseval")
    p.add_argument("--tiny", action="store_true",
                   help="a sustained_train.py --tiny checkpoint")
    p.add_argument("--image-size", type=int, nargs=2, default=[96, 128],
                   metavar=("W", "H"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    report, _ = run(args.ckpt, args.motion, args.occlude, args.bounds,
                    args.skip_ap, args.tiny, args.image_size, args.device)
    print_tables(report)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
