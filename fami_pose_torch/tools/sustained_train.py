"""Sustained training with a mid-run resume: train FAMIPose to convergence
on a synthetic fixture it can overfit, killed and resumed at the half.

    python -m fami_pose_torch.tools.sustained_train [--epochs 150] \\
        [--image-size 96 128] [--motion articulated] [--occlude 0.4] \\
        [--flip] [--tiny] [--out DIR] [--device cuda] [KEY VALUE ...]
    python -m fami_pose_torch.tools.sustained_train --root DIR [same flags]

The counterpart of the JAX repository's ``tools/sustained_train_w48.py``
(and, with ``--root``, of ``tools/resume_train_w48.py``). The recipe is
HRNet-W48 (``W48_EXTRA``), a 96x128 crop, bfloat16, ``REMAT_BACKBONE``,
``DCN_MAX_OFFSET 4``; batch 8, LR 1e-3 on a flat schedule, no scale,
rotation or flip augmentation (``--flip`` turns flip on), no random
supporting frame; the fixture of seed 3 with joint markers drawn (2 videos
x 5 frames x 2 people, so 2 steps an epoch; ``--motion`` and
``--occlude`` as in ``tools/synthetic_fixture.py``). ``--tiny`` takes the
JAX package's test settings instead (``TINY_EXTRA``, float32,
``DCN_OFFSET_GROUPS 4``, ``DCN_MAX_OFFSET 2``, no remat), which a CPU runs
in seconds an epoch; trailing ``KEY VALUE`` pairs override the config.

  1. Phase 1 runs epochs [0, N/2) through ``Trainer`` and keeps its state.
  2. A fresh ``Trainer`` with ``TRAIN.AUTO_RESUME`` must resume at epoch
     N/2 with the same step, and every tensor of its state (parameters,
     BatchNorm buffers, Adam moments and steps, the scheduler's state) must
     equal phase 1's bit for bit.
  3. Phase 2 runs to epoch N.
  4. From ``metrics.jsonl`` it prints the mean loss of the first and last 5
     logs, the train PCK of the last 5 logs and the largest gap between
     logged steps, then one JSON line with them, the resume check, the
     step times (each step synchronised: median, min and max ms) and the
     seconds of each part (trainers, training, the resume check).

It exits non-zero unless the PCK exceeds 0.9 (``--tiny``: 0.08, the JAX
package's test threshold for the tiny model) and no resumed tensor
differs. The resume check compares the saved state with the
loaded one, not two runs: the augmentations draw from the process-global
numpy RNG in the loader's threads (``WORKERS`` > 1, as the JAX loader
does), in an order that varies from run to run. With ``WORKERS 1`` and
numpy's RNG seeded before each run, two runs on the card end bit for bit
equal: the train step's own kernels, ``dcn_bwd`` included, sum in a fixed
order, and it pins cuDNN's deterministic algorithms.

Checkpoints go to ``<root>/ckpt`` and ``metrics.jsonl`` to ``<root>/log``,
``<root>`` a new directory under ``--out`` (default: the system's
temporary directory), printed first. The trainer's default cadence
(``TRAIN.SAVE_MODEL_PER_EPOCH`` 2) would keep ~75 files of about a
gigabyte each at W48 (parameters and both Adam moments in float32), so
the cadence is N: epoch 0 and each phase's last epoch are kept. The
directory is left for ``tools/ab_dcn_bound.py --ckpt`` and
``tools/int8_numerics.py --ckpt``; remove it afterwards.

Runs on ``--device`` (default ``cuda``, the hand-written kernels; ``cpu``
runs their plain versions).
"""

import argparse
import json
import os.path as osp
import tempfile
import time
from collections import OrderedDict

import numpy as np
import torch

from fami_pose_torch.engine.trainer import Trainer
from fami_pose_torch.models.hrnet import TINY_EXTRA, W48_EXTRA

from .synthetic_fixture import make_cfg, make_posetrack_fixture

FIXTURE = dict(n_videos=2, n_frames=5, people_per_frame=2, seed=3,
               draw_joints=True)
MIN_PCK = 0.9
TINY_MIN_PCK = 0.08


def write_fixture(root, motion=None, occlude=0.0):
    """The recipe's fixture under ``root``; returns its image directory."""
    return make_posetrack_fixture(root, motion=motion, occlude=occlude,
                                  **FIXTURE)[1]


def recipe_cfg(root, image_size=(96, 128), flip=False, tiny=False,
               epochs=150, opts=()):
    """The recipe's config on the fixture under ``root``: checkpoints and
    logs under ``root``, a checkpoint at epoch 0 and at each phase's end
    (cadence ``epochs``), then ``opts`` (``KEY VALUE ...``)."""
    cfg = make_cfg(osp.join(root, "json"), osp.join(root, "images"))
    cfg.MODEL.NAME = "FAMIPose"
    w, h = (int(v) for v in image_size)
    cfg.MODEL.IMAGE_SIZE = [w, h]
    cfg.MODEL.HEATMAP_SIZE = [w // 4, h // 4]
    if tiny:
        cfg.MODEL.EXTRA = TINY_EXTRA
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TPU.DCN_OFFSET_GROUPS = 4
        cfg.TPU.DCN_MAX_OFFSET = 2
        cfg.TPU.REMAT_BACKBONE = False
    else:
        cfg.MODEL.EXTRA = W48_EXTRA
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
        cfg.TPU.DCN_MAX_OFFSET = 4
        cfg.TPU.REMAT_BACKBONE = True
    cfg.TPU.MESH_SHAPE = [1, 1]
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 8
    cfg.TRAIN.BEGIN_EPOCH = 0
    cfg.TRAIN.AUTO_RESUME = True
    cfg.TRAIN.SHUFFLE = True
    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.LR_STEP = [10000]
    cfg.TRAIN.SCALE_FACTOR = [0.0, 0.0]
    cfg.TRAIN.ROT_FACTOR = 0
    cfg.TRAIN.FLIP = bool(flip)
    cfg.TRAIN.SAVE_MODEL_PER_EPOCH = int(epochs)
    cfg.DATASET.RANDOM_AUX_FRAME = False
    cfg.PRINT_FREQ = 1
    cfg.OUTPUT_DIR = osp.join(root, "out")
    cfg.merge_from_list(list(opts))
    return cfg


def output_dirs(root):
    return {"checkpoints": osp.join(root, "ckpt"),
            "log": osp.join(root, "log")}


def state_tensors(state):
    """Every tensor (and number) of a ``TrainState`` by name: the model's
    parameters and buffers, the optimizer's state of each parameter and its
    groups' settings, the scheduler's state and the step."""
    out = OrderedDict()
    for k, v in state.model.state_dict().items():
        out[f"model/{k}"] = v
    opt = state.optimizer.state_dict()
    for idx, slots in opt["state"].items():
        for k, v in slots.items():
            out[f"optimizer/{idx}/{k}"] = v
    for i, group in enumerate(opt["param_groups"]):
        for k, v in group.items():
            if k != "params":
                out[f"optimizer/group{i}/{k}"] = v
    for k, v in state.scheduler.state_dict().items():
        out[f"scheduler/{k}"] = v
    out["step"] = int(state.step)
    return out


def snapshot(state):
    """:func:`state_tensors` with every tensor copied, so that later steps,
    which update the state in place, leave it as it is."""
    return OrderedDict(
        (k, v.detach().clone() if isinstance(v, torch.Tensor) else v)
        for k, v in state_tensors(state).items())


def differing(a, b):
    """Names of the entries of two :func:`state_tensors` that are not equal
    bit for bit (tensors: same dtype and shape, equal bytes, NaNs included),
    and of those only one of them has."""
    out = sorted(set(a) ^ set(b))
    for k in a.keys() & b.keys():
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            same = (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.cpu().reshape(-1).view(torch.uint8),
                                    y.cpu().reshape(-1).view(torch.uint8)))
        else:
            same = x == y
        if not same:
            out.append(k)
    return sorted(out)


def time_steps(trainer, times):
    """Wrap ``trainer.train_step`` so that each step is timed from its call
    to the end of its work on the device (synchronised), in ms."""
    step = trainer.train_step
    sync = trainer.device.type == "cuda"

    def timed(state, batch):
        t0 = time.perf_counter()
        out = step(state, batch)
        if sync:
            torch.cuda.synchronize(trainer.device)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.train_step = timed


def summarize(log_dir, steps_per_epoch):
    """The run's convergence figures from ``<log_dir>/metrics.jsonl``."""
    with open(osp.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    loss = [(r["step"], r["value"]) for r in recs if r["tag"] == "train_loss"]
    acc = [(r["step"], r["value"]) for r in recs if r["tag"] == "train_acc"]
    steps = sorted({s for s, _ in loss})
    gaps = np.diff(steps) if len(steps) > 1 else np.zeros(1, np.int64)
    first5 = float(np.mean([v for _, v in loss[:5]]))
    last5 = float(np.mean([v for _, v in loss[-5:]]))
    return dict(
        logs=len(loss), last_logged_step=int(steps[-1]) if steps else 0,
        loss_first5=first5, loss_last5=last5, loss_ratio=last5 / first5,
        pck_first5=float(np.mean([v for _, v in acc[:5]])),
        pck_last5=float(np.mean([v for _, v in acc[-5:]])),
        max_log_gap=int(gaps.max()), steps_per_epoch=int(steps_per_epoch))


def step_ms(times):
    t = np.asarray(times, np.float64)
    return dict(steps=len(t), median=float(np.median(t)), min=float(t.min()),
                max=float(t.max()))


def train_with_resume(root, cfg, epochs, device="cuda"):
    """Phases 1 and 2 on the fixture under ``root`` with ``cfg``; returns
    ``(summary, trainer)``, the trainer of phase 2 with its final state."""
    dirs = output_dirs(root)
    half = int(epochs) // 2
    times, seconds = [], {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    cfg1 = cfg.clone()
    cfg1.TRAIN.END_EPOCH = half
    t1 = Trainer(cfg1, output_dirs=dirs, device=device)
    spe = t1.steps_per_epoch
    lap("phase1_trainer")
    print(f"phase 1: {half} epochs x {spe} steps", flush=True)
    time_steps(t1, times)
    state1 = snapshot(t1.train())
    t1.writer.close()
    step1 = int(t1.state.step)
    del t1
    lap("phase1_train")

    cfg2 = cfg.clone()
    cfg2.TRAIN.END_EPOCH = int(epochs)
    t2 = Trainer(cfg2, output_dirs=dirs, device=device)
    lap("phase2_trainer_and_resume")
    mismatched = differing(state1, state_tensors(t2.state))
    resume = dict(begin_epoch=t2.begin_epoch, expected_epoch=half,
                  step=int(t2.state.step), expected_step=step1,
                  entries=len(state1), mismatched=len(mismatched),
                  mismatched_names=mismatched[:10])
    del state1
    print(f"resume at epoch {t2.begin_epoch}: step={resume['step']}, "
          f"{resume['entries']} state entries, {len(mismatched)} mismatched "
          f"(must be 0)", flush=True)
    if t2.begin_epoch != half or resume["step"] != step1:
        raise AssertionError(f"resumed at epoch {t2.begin_epoch}, step "
                             f"{resume['step']}; expected {half}, {step1}")
    lap("resume_check")
    time_steps(t2, times)
    t2.train()
    t2.writer.close()
    lap("phase2_train")

    summary = summarize(dirs["log"], spe)
    summary.update(total_steps=int(epochs) * spe, resume_step=step1,
                   resume=resume, step_ms=step_ms(times),
                   part_seconds=seconds)
    return summary, t2


def report(summary, min_pck=MIN_PCK):
    """The JAX tool's closing lines; returns whether the run passed."""
    ok = summary["pck_last5"] > min_pck and summary["resume"]["mismatched"] == 0
    print(f"\nsteps: {summary['total_steps']} total, resume at "
          f"{summary['resume_step']}")
    print(f"loss: {summary['loss_first5']:.5f} -> {summary['loss_last5']:.5f} "
          f"(ratio {summary['loss_ratio']:.3f})")
    print(f"final PCK (train meter, last 5 logs): {summary['pck_last5']:.3f}")
    print(f"max log-step gap: {summary['max_log_gap']} "
          f"(continuous <= {summary['steps_per_epoch']})")
    sm = summary["step_ms"]
    print(f"step ms: median {sm['median']:.2f} (min {sm['min']:.2f}, max "
          f"{sm['max']:.2f}) over {sm['steps']} steps")
    print(f"{'PASS' if ok else 'FAIL'}: overfit PCK "
          f"{'>' if summary['pck_last5'] > min_pck else '<='} {min_pck}, "
          f"bitwise resume continuity "
          f"{'ok' if summary['resume']['mismatched'] == 0 else 'BROKEN'}",
          flush=True)
    return ok


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--image-size", type=int, nargs=2, default=[96, 128],
                   metavar=("W", "H"), help="crop size; divisible by 32")
    p.add_argument("--motion", default=None,
                   choices=[None, "drift", "articulated"])
    p.add_argument("--occlude", type=float, default=0.0)
    p.add_argument("--flip", action="store_true",
                   help="train with flip augmentation (TRAIN.FLIP)")
    p.add_argument("--tiny", action="store_true",
                   help="TINY_EXTRA, float32, 4 offset groups, window 2")
    p.add_argument("--root", default=None,
                   help="resume the run in this existing fixture root (its "
                        "json/ images/ ckpt/ log/) to --epochs; the flags "
                        "must be the original run's")
    p.add_argument("--out", default=None,
                   help="parent of the new fixture root (default: the "
                        "system's temporary directory)")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="KEY VALUE config overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    min_pck = TINY_MIN_PCK if args.tiny else MIN_PCK
    kw = dict(image_size=args.image_size, flip=args.flip, tiny=args.tiny,
              epochs=args.epochs, opts=args.opts or ())
    if args.root:
        root = args.root
        if not (osp.isdir(osp.join(root, "images"))
                and osp.isdir(osp.join(root, "json"))):
            raise SystemExit(f"{root} holds no fixture (images/, json/)")
        cfg = recipe_cfg(root, **kw)
        cfg.TRAIN.END_EPOCH = args.epochs
        trainer = Trainer(cfg, output_dirs=output_dirs(root),
                          device=args.device)
        print(f"resuming at epoch {trainer.begin_epoch} (step "
              f"{int(trainer.state.step)}) -> {args.epochs}", flush=True)
        trainer.train()
        trainer.writer.close()
        s = summarize(output_dirs(root)["log"], trainer.steps_per_epoch)
        print(f"final PCK (train meter, last 5 logs): {s['pck_last5']:.3f}")
        print(f"final loss (last 5 logs): {s['loss_last5']:.5f}")
        print(json.dumps(dict(tool="fami_pose_torch.tools.sustained_train",
                              root=root, **s)), flush=True)
        return 0 if s["pck_last5"] > min_pck else 1

    root = tempfile.mkdtemp(prefix="sustain_", dir=args.out)
    write_fixture(root, args.motion, args.occlude)
    print(f"fixture + outputs under {root} (checkpoints: "
          f"{output_dirs(root)['checkpoints']})", flush=True)
    summary, _ = train_with_resume(root, recipe_cfg(root, **kw), args.epochs,
                                   args.device)
    ok = report(summary, min_pck)
    print(json.dumps(dict(tool="fami_pose_torch.tools.sustained_train",
                          root=root, motion=args.motion,
                          occlude=args.occlude, tiny=args.tiny, **summary)),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
