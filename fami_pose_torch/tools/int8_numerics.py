"""Int8-vs-bf16 numerics of the serving path (``TPU.INT8_EVAL``): the
counterpart of the JAX repository's ``tools/int8_numerics.py``, with its
``--ckpt`` mode.

    python -m fami_pose_torch.tools.int8_numerics [--batch 16] [--seed 0] \\
        [--image-size 288 384] [--device cuda]
    python -m fami_pose_torch.tools.int8_numerics --ckpt <epoch_N_state.ckpt> \\
        [--image-size 96 128] [--motion articulated] [--occlude 0.4] \\
        [--tiny] [--batch 16] [--device cuda]

Runs one eval forward of FAMIPose three ways on identical weights and
inputs: float32, bfloat16, and bfloat16 with the int8 backbone calibrated
on that batch (``models.quant.calibrate``). It prints one JSON line with,
for each pair (bf16 vs f32, int8 vs bf16, int8 vs f32): the heatmaps' max
and mean absolute difference relative to the f32 heatmaps' range, the
drift of the DARK-decoded keypoints (mean and 95th percentile, in
``drift_unit``), and the share of (sample, joint) heatmaps whose argmax
cell agrees; for the final heatmaps and for the backbone's
(``hrnet.final_layer`` on the key frames), where the int8 convs act before
the alignment head amplifies a difference. bf16 vs f32 is the yardstick:
how much of the int8 difference is quantization and how much bf16.

Without ``--ckpt``: HRNet-W48 (DCN window 4, 4 supporting frames) at
``--image-size`` (default 288x384) with seeded random weights
(``models.bridge.init_weights``) and BatchNorm statistics calibrated on the
same seeded noise (``calibrate_batch_norm``, so the heatmaps are O(1) as a
trained model's are); keypoints are decoded in heatmap pixels. Random
weights give heatmaps that are no Gaussians, and the seeded head (raw DCN
masks, random offsets) amplifies any rounding, so the decoded columns mean
little there.

With ``--ckpt``, a checkpoint of ``tools/sustained_train.py``: its trained
weights on real crops of its fixture (``tools/synthetic_fixture.py``, seed
3, joint markers; ``--motion`` and ``--occlude`` as the run's, default
none as in the JAX tool), the first ``--batch`` samples of the val split
taken in turn, at ``--image-size`` (default 96x128) with the recipe's
window 4 (``--tiny``: the tiny recipe's model); keypoints are decoded in
image pixels with each sample's box. The heatmaps are peaked, so the
decoded and argmax columns mean what they say.

Runs on ``--device`` (default ``cuda``, where the int8 convs are the
hand-written kernels; ``cpu`` runs their plain versions). TF32 is turned
off, so f32 is f32 on the card.
"""

import argparse
import json
import shutil
import tempfile

import numpy as np
import torch

from fami_pose_torch.data.loader import collate, prepare_eval_inputs
from fami_pose_torch.models.bridge import calibrate_batch_norm, init_weights
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.models.hrnet import W48_EXTRA
from fami_pose_torch.models.quant import QUANT_INT8, calibrate
from fami_pose_torch.ops.heatmap import dark_get_final_preds

NUM_SUP = 4
PAIRS = (("bf16 vs f32", "bf16", "f32"), ("int8 vs bf16", "int8", "bf16"),
         ("int8 vs f32", "int8", "f32"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", type=int, nargs=2, default=None,
                   metavar=("W", "H"),
                   help="default 288 384, or 96 128 with --ckpt")
    p.add_argument("--ckpt", default=None,
                   help="a tools/sustained_train.py checkpoint: trained "
                        "weights on its fixture's crops")
    p.add_argument("--motion", default=None,
                   choices=[None, "drift", "articulated"],
                   help="--ckpt: the run's fixture motion")
    p.add_argument("--occlude", type=float, default=0.0,
                   help="--ckpt: the run's marker occlusion rate")
    p.add_argument("--tiny", action="store_true",
                   help="--ckpt: a sustained_train.py --tiny checkpoint")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _identity_box(hm):
    """A box that maps the heatmap onto itself: keypoints in heatmap
    pixels."""
    b, _, h, w = hm.shape
    center = torch.tensor([[w / 2, h / 2]], device=hm.device).repeat(b, 1)
    scale = torch.tensor([[w / 200, h / 200]], device=hm.device).repeat(b, 1)
    return center, scale


def compare(a, ref, rng, center=None, scale=None):
    """The report's columns for heatmaps ``a`` against ``ref``; keypoints
    decoded with the boxes ``center`` / ``scale`` (None: heatmap pixels)."""
    if center is None:
        center, scale = _identity_box(a)
    d = (a - ref).abs()
    drift = torch.linalg.vector_norm(
        dark_get_final_preds(a, center, scale)[0]
        - dark_get_final_preds(ref, center, scale)[0], dim=-1)
    agree = a.flatten(2).argmax(-1) == ref.flatten(2).argmax(-1)
    return dict(
        max_abs_rel=float(d.max()) / rng, mean_abs_rel=float(d.mean()) / rng,
        drift_px_mean=float(drift.mean()),
        drift_px_p95=float(torch.quantile(drift.flatten(), 0.95)),
        argmax_agree=float(agree.float().mean()))


def seeded_setup(batch, seed, image_size, dev):
    """W48 with seeded weights and calibrated BatchNorm, seeded noise."""
    w, h = image_size
    kw = dict(extra=W48_EXTRA, num_joints=17, num_sup=NUM_SUP,
              feat_hw=(h // 4, w // 4), dcn_max_offset=4)
    base = init_weights(FAMIPose(**kw), seed).to(dev).eval()
    rs = np.random.RandomState(seed)
    kf = torch.from_numpy(rs.rand(batch, 3, h, w).astype(np.float32)).to(dev)
    sup = torch.from_numpy(
        rs.rand(batch, 3 * NUM_SUP, h, w).astype(np.float32)).to(dev)
    calibrate_batch_norm(base, kf, sup)
    quant = FAMIPose(**kw, compute_dtype=torch.bfloat16,
                     backbone_quant=QUANT_INT8)
    return dict(
        base=base, quant=quant, kf=kf, sup=sup, boxes=(None, None),
        model=f"FAMIPose HRNet-W48 {h}x{w} D=4 num_sup={NUM_SUP}",
        weights=f"seeded init (seed {seed}), BatchNorm calibrated",
        inputs="seeded uniform noise", drift_unit="heatmap px")


def checkpoint_setup(ckpt, batch, image_size, motion, occlude, tiny, dev,
                     root):
    """The checkpoint's model on the first ``batch`` val samples of its
    fixture (written under ``root``), taken in turn."""
    from fami_pose_torch.engine.checkpoints import load_variables
    from fami_pose_torch.models.build import build_model
    from fami_pose_torch.utils.registry import DATASET_REGISTRY, VAL_PHASE

    from .sustained_train import recipe_cfg, write_fixture

    write_fixture(root, motion, occlude)
    cfg = recipe_cfg(root, image_size=image_size, tiny=tiny)
    ds = DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg, VAL_PHASE)
    raw = collate([ds[i % len(ds)] for i in range(batch)])
    kf, sup = prepare_eval_inputs(raw["kf"], raw["sup"], device=dev)
    base = build_model(cfg, VAL_PHASE)
    base.load_state_dict(load_variables(ckpt))
    base.to(dev).eval()
    cfg.TPU.INT8_EVAL = True
    quant = build_model(cfg, VAL_PHASE)
    quant.compute_dtype = torch.bfloat16
    w, h = image_size
    return dict(
        base=base, quant=quant, kf=kf, sup=sup,
        boxes=(torch.as_tensor(raw["center"], device=dev),
               torch.as_tensor(raw["scale"], device=dev)),
        model=(f"FAMIPose {'TINY' if tiny else 'HRNet-W48'} {h}x{w} "
               f"D={base.dcn_1.max_offset} num_sup={base.num_sup}"),
        weights=f"trained: {ckpt}",
        inputs=(f"val crops of the sustained-training fixture (seed 3, "
                f"motion {motion}, occlude {occlude}), {len(ds)} samples "
                f"taken in turn"),
        drift_unit="image px")


@torch.inference_mode()
def report(batch=16, seed=0, image_size=None, device="cuda", ckpt=None,
           motion=None, occlude=0.0, tiny=False):
    """The numbers of the JSON line, as a dict."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if image_size is None:
        image_size = (96, 128) if ckpt else (288, 384)
    image_size = tuple(int(v) for v in image_size)
    root = tempfile.mkdtemp(prefix="int8num_") if ckpt else None
    try:
        s = (checkpoint_setup(ckpt, batch, image_size, motion, occlude, tiny,
                              dev, root) if ckpt
             else seeded_setup(batch, seed, image_size, dev))
    finally:
        if root:
            shutil.rmtree(root, ignore_errors=True)
    base, q, kf, sup = s["base"], s["quant"], s["kf"], s["sup"]

    hms = {}  # name -> (final, backbone) heatmaps, float32
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        base.compute_dtype = dtype
        hms[name] = [t.float() for t in base(kf, sup)]
    q.load_state_dict(base.state_dict())
    q.to(dev).eval()
    scales = calibrate(q, [(kf, sup)])
    hms["int8"] = [t.float() for t in q(kf, sup)]

    rows, ranges = {}, {}
    for i, head in enumerate(("final", "backbone")):
        ranges[head] = float(hms["f32"][i].abs().max())
        rows[head] = {label: compare(hms[a][i], hms[b][i], ranges[head],
                                     *s["boxes"])
                      for label, a, b in PAIRS}
    return dict(
        tool="fami_pose_torch.tools.int8_numerics",
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        model=s["model"], weights=s["weights"], inputs=s["inputs"],
        batch=batch, int8_convs=len(scales), heatmap_range_f32=ranges,
        drift_unit=s["drift_unit"], pairs=rows)


def main(argv=None):
    args = parse_args(argv)
    print(json.dumps(report(args.batch, args.seed, args.image_size,
                            args.device, args.ckpt, args.motion,
                            args.occlude, args.tiny)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
