"""Flip-test off and on through poseval AP, on a trained checkpoint of
``tools/sustained_train.py --flip``.

    python -m fami_pose_torch.tools.flip_ab --ckpt <epoch_46_state.ckpt> \\
        --motion drift --occlude 0.4 [--int8] [--tiny] \\
        [--image-size 96 128] [--device cuda]

The counterpart of the JAX repository's ``tools/flip_ab.py``. A flipped
second forward is a whole extra forward (a CNN is not reflection
equivariant), so flip-test is worth its cost only where it buys AP. The
tool writes the checkpoint's own fixture again (``tools/synthetic_fixture.py``:
seed 3, joint markers; ``--motion`` and ``--occlude`` must be the run's)
with its GT annolists, loads the weights once and scores them through the
real ``Evaluator`` (batch 4, GT boxes, the DARK decode) and the port's
poseval, row by row:

  * ``noflip`` and ``flip``: ``VAL.FLIP_VAL`` off, then on;
  * with ``--int8``, ``noflip_int8`` and ``flip_int8``: the same with
    ``TPU.INT8_EVAL``, calibrated on ``TPU.INT8_CALIB_BATCHES 2`` eval
    batches, as ``configs/posetrack18/fami_pose_serving.yaml`` sets it.

It prints each row's per-joint AP as it finishes (the JAX tool's
``[tag] (seconds) joint=AP, ...`` lines), then ``flip - noflip`` per joint
for each pair, a table of the rows with their eval wall seconds, the
forward's seconds and the kernel launches, and one JSON line with all of
it. A checkpoint whose no-flip mean AP is above ``SATURATED_AP`` is marked
``saturated``: at a saturated AP flip-test can show no gain, whatever it
is worth (the JAX repository's ``docs/SERVING.md``).

``--tiny`` reads a ``sustained_train.py --tiny`` checkpoint. Runs on
``--device`` (default ``cuda``, the hand-written kernels; ``cpu`` runs
their plain versions).
"""

import argparse
import json
import os.path as osp
import shutil
import tempfile
import time

from fami_pose_torch.engine.checkpoints import load_variables
from fami_pose_torch.engine.evaluator import Evaluator
from fami_pose_torch.ops import launch_counts, launches_since

from .ab_dcn_bound import eval_cfg
from .sustained_train import write_fixture

SATURATED_AP = 95.0
# the int8 levers of configs/posetrack18/fami_pose_serving.yaml
INT8_LEVERS = ("TPU.INT8_EVAL", True, "TPU.INT8_CALIB_BATCHES", 2)


def row_specs(int8=False):
    """(name, config overrides) of each row, in the order they run."""
    rows = [("noflip", ("VAL.FLIP_VAL", False)),
            ("flip", ("VAL.FLIP_VAL", True))]
    if int8:
        rows += [("noflip_int8", ("VAL.FLIP_VAL", False) + INT8_LEVERS),
                 ("flip_int8", ("VAL.FLIP_VAL", True) + INT8_LEVERS)]
    return rows


def pairs(rows):
    """(no-flip row, flip row) of each pair present, in order."""
    names = [r["row"] for r in rows]
    return [(a, b) for a, b in (("noflip", "flip"),
                                ("noflip_int8", "flip_int8"))
            if a in names and b in names]


def run(ckpt, int8=False, motion=None, occlude=0.0, tiny=False,
        image_size=(96, 128), device="cuda", root=None):
    """The A/B on ``ckpt`` (a checkpoint path, or a model ``state_dict``),
    with the fixture under ``root`` (default: a temporary directory,
    removed afterwards); returns the JSON line's dict."""
    own_root = root is None
    root = root or tempfile.mkdtemp(prefix="flip_ab_")
    try:
        write_fixture(root, motion, occlude)
        base = eval_cfg(root, tiny=tiny, image_size=image_size)
        variables = ckpt if isinstance(ckpt, dict) else load_variables(ckpt)
        rows = []
        for name, overrides in row_specs(int8):
            c = base.clone()
            c.merge_from_list(list(overrides))
            ev = Evaluator(c, output_dirs={"results": osp.join(
                root, "out", name)}, device=device)
            before = launch_counts()
            t0 = time.perf_counter()
            name_value, _ = ev.eval_checkpoint(variables)["final"]
            seconds = time.perf_counter() - t0
            ap = {k: float(v) for k, v in name_value.items()}
            rows.append(dict(row=name, flip=bool(c.VAL.FLIP_VAL),
                             int8=bool(c.TPU.INT8_EVAL), ap=ap,
                             seconds=seconds,
                             forward_s=ev.timings["forward_s"],
                             samples=ev.timings["samples"],
                             launches=launches_since(before)))
            print(f"[{name}] ({seconds:.1f}s) " + ", ".join(
                f"{k}={v:.2f}" for k, v in ap.items()), flush=True)
            del ev
        by_name = {r["row"]: r for r in rows}
        deltas = {f"{b}-{a}": {k: by_name[b]["ap"][k] - by_name[a]["ap"][k]
                               for k in by_name[a]["ap"]}
                  for a, b in pairs(rows)}
        return dict(tool="fami_pose_torch.tools.flip_ab",
                    ckpt=ckpt if isinstance(ckpt, str) else "state_dict",
                    motion=motion, occlude=occlude, tiny=tiny,
                    device=str(device), rows=rows, deltas=deltas,
                    saturated=rows[0]["ap"]["Mean"] > SATURATED_AP,
                    saturated_above=SATURATED_AP)
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)


def print_tables(report):
    rows = report["rows"]
    print("\n== flip-test AP delta (flip - noflip), trained weights ==")
    for pair, d in report["deltas"].items():
        print(f"{pair}: " + ", ".join(f"{k}={v:+.3f}" for k, v in d.items()))
    joints = list(rows[0]["ap"])
    print("\n== per-joint AP (final heatmaps), eval wall s and launches ==")
    print(f"{'row':12s} " + " ".join(f"{j:>9s}" for j in joints)
          + f" {'eval_s':>8s} {'fwd_s':>8s}  launches")
    for r in rows:
        launched = ", ".join(f"{k} {v}" for k, v in r["launches"].items()
                             if v) or "none (plain versions)"
        print(f"{r['row']:12s} " + " ".join(f"{r['ap'][j]:9.3f}"
                                            for j in joints)
              + f" {r['seconds']:8.2f} {r['forward_s']:8.2f}  {launched}")
    if report["saturated"]:
        print(f"\nsaturated: no-flip mean AP {rows[0]['ap']['Mean']:.2f} > "
              f"{report['saturated_above']}, so flip-test cannot show a "
              f"gain on this checkpoint")
    print("\n(eval wall time includes decode+protocol; the forward's own "
          "seconds are fwd_s)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="a tools/sustained_train.py --flip checkpoint")
    p.add_argument("--int8", action="store_true",
                   help="also run the int8 serving backbone's pair")
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
    report = run(args.ckpt, args.int8, args.motion, args.occlude, args.tiny,
                 args.image_size, args.device)
    print_tables(report)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
