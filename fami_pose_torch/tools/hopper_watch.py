"""Hopper capability watch: the counterpart of ``tools/mosaic_watch.py``.

    python -m fami_pose_torch.tools.hopper_watch [--device cuda]

The TPU tool asks Mosaic, on the attached chip, for the on-chip data
movements whose absence shaped the TPU kernels (a bf16 lane gather, a
batched 3-D gather, a gather across rows, a lane rotation by a run-time
amount). This tool asks the same of the attached NVIDIA GPU: each probe
builds and launches its hand-written kernel (``ops/cuda/csrc/probes.cu``,
which gathers or rotates a tile staged in shared memory or registers) at
the TPU probe's shape and type, and holds the result bit for bit against
the plain version (``torch.gather``, ``torch.roll``). It prints the device,
then one line per probe, ``SUPPORTED`` or ``unsupported: <message>`` with
the build, launch or comparison error, and exits non-zero if any probe is
unsupported. A probe that launched no kernel (CPU tensors run the plain
version) is reported unsupported: the tool never answers for a kernel that
did not run.
"""

import argparse
import sys

import torch

from fami_pose_torch.ops import probes


def probe(name, fn, make_cases, **kwargs):
    """Run ``fn`` on every argument tuple ``make_cases()`` gives; print and
    return whether it launched its kernel each time and matched its plain
    version. The cases are made inside the ``try``: a device that cannot be
    reached is reported per probe, like any other failure."""
    try:
        for args in make_cases():
            before = fn.launches
            out = fn(*args, **kwargs)
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            if fn.launches != before + 1:
                raise RuntimeError(
                    f"no kernel was launched on {out.device.type} tensors "
                    "(the plain version ran)")
            ref = probes.PLAIN[fn](*args)
            if out.dtype != ref.dtype or not torch.equal(out, ref):
                raise RuntimeError("result differs from the plain version")
        print(f"{name:28s} SUPPORTED")
        return True
    except Exception as e:  # reported, and the tool then exits non-zero
        msg = str(e).replace("\n", " ")[:110]
        print(f"{name:28s} unsupported: {msg}")
        return False


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = args.device
    if dev.startswith("cuda") and torch.cuda.is_available():
        kind = torch.cuda.get_device_name(torch.device(dev))
    else:
        kind = "no CUDA device" if dev.startswith("cuda") else dev
    print(f"device: {dev} ({kind}), torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    def one(name):
        return lambda: [probes.probe_inputs(name, device=dev)]

    def rolls():
        return [probes.probe_inputs("dynamic_roll", device=dev, shift=s)
                for s in (5, 0, 127, 128, -3)]

    results = {
        "bf16 lane gather": probe(
            "bf16 lane gather", probes.gather_lane, one("gather_lane")),
        "bf16 lane gather (shuffle)": probe(
            "bf16 lane gather (shuffle)", probes.gather_lane,
            one("gather_lane"), variant="shfl"),
        "3-D gather": probe(
            "3-D gather", probes.gather_3d, one("gather_3d")),
        "row-axis gather": probe(
            "row-axis gather", probes.gather_rows, one("gather_rows")),
        "dynamic lane roll": probe(
            "dynamic lane roll", probes.dynamic_roll, rolls),
    }
    if all(results.values()):
        print("\n-> on-chip gathers exist on this device (shared memory, any "
              "axis, bf16 and f32; warp shuffles from registers): a Hopper "
              "DCN samples its 4 bilinear corners directly from a staged "
              "tile, with no hat-window sums and no bf16-to-f32 staging copy.")
        print("-> a lane rotation by a run-time amount is an index "
              "computation on a staged row: the translation warp needs no "
              "padded roll-and-slice form.")
        print("-> a gather across rows is conflict-free when the row length "
              "is a multiple of 32 words: row-stacked DCN tiles are viable.")
        return 0
    failed = [name for name, ok in results.items() if not ok]
    print(f"\n{len(failed)} probe(s) unsupported: {', '.join(failed)}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
