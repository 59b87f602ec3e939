"""Does a training recipe repeat itself bit for bit on one card?

    python -m fami_pose_torch.tools.repeat_runs [--serial]
        [--save-dcn-inputs FILE] [--out FILE]

Runs ``chip_smoke.py`` phase serving-ab's flip recipe
(``tools/sustained_train.py --flip --motion drift --occlude 0.4``, 47
epochs, killed and resumed at 23) twice in one process, and prints the
state tensors that differ between the two runs' ends and each run's
no-flip and flip mean AP (``tools/flip_ab.py``, bf16). ``--serial`` loads
with one thread and seeds numpy, ``random`` and torch before each run (the
augmentations draw from numpy's global RNG, in an order that varies with
more than one loader thread). ``--save-dcn-inputs FILE`` keeps ``dcn_1``'s
inputs and output gradient (scaled to a largest entry in [1, 2)) in one
more train step of the second run, for ``tools/dcn_turns.py --trained``.

Each reading is printed as one JSON line, with the card's name and power
limit, and with ``--out`` appended to FILE. Needs a CUDA device; run it
from the root of a checkout (it imports ``chip_smoke.py``'s settings).
"""

import argparse
import json
import math
import os
import sys
import tempfile
import time


def emit(out, **fields):
    line = json.dumps(fields)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def recipe_runs(cs, torch, out, card, serial, save):
    import random

    import numpy as np

    from fami_pose_torch.engine.checkpoints import (
        _to_host, get_latest_checkpoint,
    )
    from fami_pose_torch.tools import flip_ab, sustained_train as st

    runs = []
    for i in range(2):
        with tempfile.TemporaryDirectory() as root:
            st.write_fixture(root, **cs.SERVING_AB_FIXTURE)
            opts = cs.SUSTAIN_OPTS + (("WORKERS", 1) if serial else ())
            cfg = st.recipe_cfg(root, flip=True, epochs=cs.SERVING_AB_EPOCHS,
                                opts=opts)
            if serial:
                np.random.seed(int(cfg.SEED))
                random.seed(int(cfg.SEED))
                torch.manual_seed(int(cfg.SEED))
            t0 = time.perf_counter()
            summary, trainer = st.train_with_resume(
                root, cfg, cs.SERVING_AB_EPOCHS, device="cuda")
            train_s = time.perf_counter() - t0
            ckpt = get_latest_checkpoint(st.output_dirs(root)["checkpoints"])
            state = _to_host(trainer.state.state_dict())
            flip = flip_ab.run(ckpt, int8=False, device="cuda",
                               root=os.path.join(root, "flip"),
                               **cs.SERVING_AB_FIXTURE)
            ap = {r["row"]: r["ap"]["Mean"] for r in flip["rows"]}
            runs.append((state, ap))
            emit(out, mode="recipe", card=card, serial=serial, run=i,
                 train_s=train_s, checkpoint=os.path.basename(ckpt),
                 resumed_mismatched=summary["resume"]["mismatched"],
                 pck_last5=summary["pck_last5"], mean_ap=ap)
            if save and i == 1:
                batch = trainer.prepare(next(iter(trainer.loader)))
                x, o, m, w, g = cs.dcn_stage_inputs(trainer, trainer.state,
                                                    batch)[0]
                g = g * 2.0 ** -math.floor(math.log2(
                    float(g.float().abs().max())))
                torch.save(dict(x=x, offset=o.to(x.dtype),
                                mask=m.to(x.dtype), weight=w.to(x.dtype),
                                gout=g.to(x.dtype), max_offset=4.0), save)
            del trainer
            torch.cuda.empty_cache()
    l2, differ, n = cs.state_distance(runs[0][0], runs[1][0])
    emit(out, mode="recipe", card=card, serial=serial, state_tensors=n,
         differing=differ, l2=l2, mean_ap=[r[1] for r in runs])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="")
    p.add_argument("--serial", action="store_true")
    p.add_argument("--save-dcn-inputs", default="")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("repeat_runs: needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    card = cs.phase_device()
    recipe_runs(cs, torch, args.out, card, args.serial,
                os.path.abspath(args.save_dcn_inputs)
                if args.save_dcn_inputs else "")


if __name__ == "__main__":
    main()
