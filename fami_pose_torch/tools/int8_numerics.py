"""Int8-vs-bf16 numerics of the serving path (``TPU.INT8_EVAL``): the
counterpart of ``tools/int8_numerics.py`` without ``--ckpt``.

    python -m fami_pose_torch.tools.int8_numerics [--batch 16] [--seed 0] \\
        [--image-size 288 384] [--device cuda]

Builds FAMIPose HRNet-W48 (DCN window 4, 4 supporting frames) with seeded
random weights (``models.bridge.init_weights``) and BatchNorm statistics
calibrated on the same seeded inputs (``calibrate_batch_norm``, so the
heatmaps are O(1) as a trained model's are), and runs one eval forward of a
seeded batch three ways on identical weights and inputs: float32, bfloat16,
and bfloat16 with the int8 backbone calibrated on that batch
(``models.quant.calibrate``). It prints one JSON line with, for each pair
(bf16 vs f32, int8 vs bf16, int8 vs f32): the heatmaps' max and mean
absolute difference relative to the f32 heatmaps' range, the drift of the
DARK-decoded keypoints in heatmap pixels (mean and 95th percentile), and the
share of (sample, joint) heatmaps whose argmax cell agrees; for the final
heatmaps and for the backbone's (``hrnet.final_layer`` on the key frames),
where the int8 convs act before the alignment head amplifies a difference.
bf16 vs f32 is the yardstick: how much of the int8 difference is
quantization and how much bf16. Random weights give heatmaps that are no
Gaussians, and the seeded head (raw DCN masks, random offsets) amplifies
any rounding, so the decoded columns mean less than on a trained checkpoint
(none is in the repository).

Runs on ``--device`` (default ``cuda``, where the int8 convs are the
hand-written kernels; ``cpu`` runs their plain versions). TF32 is turned off, so f32 is f32 on the card.
"""

import argparse
import json

import numpy as np
import torch

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
    p.add_argument("--image-size", type=int, nargs=2, default=[288, 384],
                   metavar=("W", "H"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _decode(hm):
    """DARK decode with a box that maps the heatmap onto itself: keypoints
    in heatmap pixels."""
    b, _, h, w = hm.shape
    center = torch.tensor([[w / 2, h / 2]], device=hm.device).repeat(b, 1)
    scale = torch.tensor([[w / 200, h / 200]], device=hm.device).repeat(b, 1)
    return dark_get_final_preds(hm, center, scale)[0]


def compare(a, ref, rng):
    """The report's columns for heatmaps ``a`` against ``ref``."""
    d = (a - ref).abs()
    drift = torch.linalg.vector_norm(_decode(a) - _decode(ref), dim=-1)
    agree = a.flatten(2).argmax(-1) == ref.flatten(2).argmax(-1)
    return dict(
        max_abs_rel=float(d.max()) / rng, mean_abs_rel=float(d.mean()) / rng,
        drift_hm_px_mean=float(drift.mean()),
        drift_hm_px_p95=float(torch.quantile(drift.flatten(), 0.95)),
        argmax_agree=float(agree.float().mean()))


@torch.inference_mode()
def report(batch=16, seed=0, image_size=(288, 384), device="cuda"):
    """The numbers of the JSON line, as a dict."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    w, h = (int(v) for v in image_size)
    kw = dict(extra=W48_EXTRA, num_joints=17, num_sup=NUM_SUP,
              feat_hw=(h // 4, w // 4), dcn_max_offset=4)
    base = init_weights(FAMIPose(**kw), seed).to(dev).eval()
    rs = np.random.RandomState(seed)
    kf = torch.from_numpy(rs.rand(batch, 3, h, w).astype(np.float32)).to(dev)
    sup = torch.from_numpy(
        rs.rand(batch, 3 * NUM_SUP, h, w).astype(np.float32)).to(dev)
    calibrate_batch_norm(base, kf, sup)

    hms = {}  # name -> (final, backbone) heatmaps, float32
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        base.compute_dtype = dtype
        hms[name] = [t.float() for t in base(kf, sup)]
    q = FAMIPose(**kw, compute_dtype=torch.bfloat16,
                 backbone_quant=QUANT_INT8).to(dev).eval()
    q.load_state_dict(base.state_dict())
    scales = calibrate(q, [(kf, sup)])
    hms["int8"] = [t.float() for t in q(kf, sup)]

    rows, ranges = {}, {}
    for i, head in enumerate(("final", "backbone")):
        ranges[head] = float(hms["f32"][i].abs().max())
        rows[head] = {label: compare(hms[a][i], hms[b][i], ranges[head])
                      for label, a, b in PAIRS}
    return dict(
        tool="fami_pose_torch.tools.int8_numerics",
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        model=f"FAMIPose HRNet-W48 {h}x{w} D=4 num_sup={NUM_SUP}",
        weights=f"seeded init (seed {seed}), BatchNorm calibrated",
        batch=batch, int8_convs=len(scales), heatmap_range_f32=ranges,
        pairs=rows)


def main(argv=None):
    args = parse_args(argv)
    print(json.dumps(report(args.batch, args.seed, args.image_size,
                            args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
