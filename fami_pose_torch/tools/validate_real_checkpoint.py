"""Score a reference checkpoint with the port
(``tools/validate_real_checkpoint.py`` of the JAX package).

    python -m fami_pose_torch.tools.validate_real_checkpoint \\
        --checkpoint epoch_20_state.pth --cfg configs/posetrack17/... \\
        [--test] [--dcn-bound D] [--reference-scores ref_ap.json] \\
        [--device cuda] [KEY VALUE ...]

Given a reference ``.pth`` (a full ``Alignment_V15`` ``epoch_*_state.pth``
or a backbone-only ``pose_hrnet_w48.pth``) and an experiment config, this

  1. loads and remaps the state dict onto the port's model
     (``models/pretrained.py``: full when a key starts with ``hrnet.`` or
     ``module.hrnet.``, else backbone-only as ``MODEL.PRETRAINED`` loads);
  2. runs the ``Evaluator`` in the exact DCN mode (``TPU.DCN_MAX_OFFSET
     0``: offsets unclamped), or at the window ``--dcn-bound``;
  3. writes annolists and scores them with the poseval AP protocol;
  4. prints the per-joint AP table of the final heatmaps, and with
     ``--reference-scores`` (a JSON ``{joint: AP}`` of a reference run) the
     delta per joint and whether the worst lies within the 0.1 target.

It runs on the card unless ``--device cpu`` is given; trailing ``KEY
VALUE`` pairs override the config as on ``python -m fami_pose_torch.run``.
"""

import argparse
import json
import types

from fami_pose_torch.config import get_cfg
from fami_pose_torch.engine.evaluator import Evaluator
from fami_pose_torch.models.pretrained import (
    load_torch_state_dict, merge_into_variables, remap_fami_pose_state_dict,
    remap_hrnet_backbone_for_fami,
)
from fami_pose_torch.utils.registry import TEST_PHASE, VAL_PHASE

DELTA_TARGET = 0.1


def load_and_remap(path, model):
    """A reference ``.pth`` -> ``(state_dict, kind, unmapped)``: the file
    overlaid on ``model``'s ``state_dict``, ``kind`` ``"full"`` or
    ``"backbone"``."""
    sd = load_torch_state_dict(path)
    is_full = any(k.startswith(("hrnet.", "module.hrnet.")) for k in sd)
    remap = (remap_fami_pose_state_dict if is_full
             else remap_hrnet_backbone_for_fami)
    mapped, unmapped = remap(sd)
    variables = merge_into_variables(model.state_dict(), mapped)
    return variables, ("full" if is_full else "backbone"), unmapped


def main(argv=None):
    """Run the tool; returns the evaluator's results of the checkpoint
    (``{"final": (name_value, mean), "backbone": ...}``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True, help=".pth state dict")
    p.add_argument("--cfg", required=True, help="experiment yaml")
    p.add_argument("--test", action="store_true",
                   help="TEST phase (default VAL)")
    p.add_argument("--dcn-bound", type=int, default=0,
                   help="DCN window; 0 = exact unbounded gather (default)")
    p.add_argument("--reference-scores", default=None,
                   help="JSON {joint: AP} from the reference run to diff")
    p.add_argument("--root-dir", default=".")
    p.add_argument("--device", default="cuda",
                   help="where the model and the batches live (cuda, or cpu)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="dotted-path config overrides")
    args = p.parse_args(argv)

    cfg = get_cfg(types.SimpleNamespace(cfg=args.cfg, opts=args.opts,
                                        root_dir=args.root_dir))
    cfg.defrost()
    cfg.TPU.DCN_MAX_OFFSET = int(args.dcn_bound)
    phase = TEST_PHASE if args.test else VAL_PHASE

    ev = Evaluator(cfg, phase=phase, device=args.device)
    variables, kind, unmapped = load_and_remap(args.checkpoint, ev.model)
    print(f"loaded {kind} checkpoint {args.checkpoint} "
          f"({len(unmapped)} unmapped torch keys)")
    for k in unmapped[:10]:
        print(f"  unmapped: {k}")
    window = ev.dcn_max_offset
    print(f"DCN window: {window if window else 'exact'}")

    results = ev.eval_checkpoint(variables)
    name_value, _ = results["final"]
    print("\nper-joint AP (final heatmaps):")
    for k, v in name_value.items():
        print(f"  {k:10s} {v:6.2f}")

    if args.reference_scores:
        with open(args.reference_scores) as f:
            ref = json.load(f)
        print("\ndelta vs reference:")
        worst = 0.0
        for k, v in name_value.items():
            if k in ref:
                d = v - float(ref[k])
                worst = max(worst, abs(d))
                print(f"  {k:10s} {d:+6.3f}")
        print(f"worst |delta| = {worst:.3f} ({'within' if worst <= DELTA_TARGET else 'OUTSIDE'} "
              f"the {DELTA_TARGET} target)")
    return results


if __name__ == "__main__":
    main()
