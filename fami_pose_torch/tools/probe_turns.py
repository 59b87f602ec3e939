"""Time the gather probes of this tree against an earlier ``probes.cu``, in
turns, on one card.

    python -m fami_pose_torch.tools.probe_turns --old OLD_PROBES_CU \\
        [--rounds N] [--out chiprun_out/probe_turns.json]

``OLD_PROBES_CU`` is another version of ``ops/cuda/csrc/probes.cu`` (for
example ``git show <commit>:fami_pose_torch/ops/cuda/csrc/probes.cu``
written into a git-ignored directory). It must keep this tree's C entry
points ``fami_probe_gather_lane``, ``fami_probe_gather_3d`` and
``fami_empty_launch``. The tool builds it with ``nvcc`` and this tree's
flags into a library of its own, and for each of the lane gather (shared
memory), the lane gather by warp shuffles and the 3-D gather, at the TPU
probes' shapes (``ops.probes.PROBE_SHAPES``):

  * holds both libraries' outputs bit for bit against the plain version;
  * times each device-side (``chip_smoke.device_ms``: launches in one
    replayed CUDA graph) and cold (``chip_smoke.device_ms_cold``: a 96 MB
    read before each launch, its own time subtracted), in the order old,
    tree, tree, old (``--rounds`` times).

It prints one JSON line per probe and the floor of an empty kernel node
(``fami_empty_launch``), and writes them all to ``--out``. Needs a CUDA
device and ``nvcc``; run it from the root of a checkout.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from fami_pose_torch.ops import probes
from fami_pose_torch.ops.cuda import build

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENTRIES = ("fami_probe_gather_lane", "fami_probe_gather_3d",
           "fami_empty_launch")
# probe name: (PROBE_SHAPES key, entry, arguments after the three pointers)
CASES = {
    "probe_gather_lane": ("gather_lane", "fami_probe_gather_lane",
                          lambda x: (1, *x.shape, 0)),
    "probe_gather_lane_shfl": ("gather_lane", "fami_probe_gather_lane",
                               lambda x: (1, *x.shape, 1)),
    "probe_gather_3d": ("gather_3d", "fami_probe_gather_3d",
                        lambda x: tuple(x.shape)),
}


def load_old(source, workdir):
    """Build ``source`` alone into a shared library and load it."""
    so = os.path.join(workdir, "libold_probes.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", source,
                    "-o", so], check=True)
    lib = ctypes.CDLL(so)
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def caller(lib, entry, x, idx, out, tail):
    """One launch on the stream current at the call (``device_ms``
    captures on a stream of its own)."""
    def run():
        err = getattr(lib, entry)(x.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), *tail,
                                  torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry}: CUDA error {err} at launch")

    return run


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--old", required=True, help="an earlier probes.cu")
    p.add_argument("--out", default="")
    p.add_argument("--rounds", type=int, default=1,
                   help="times the order old, tree, tree, old is run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_turns: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms, device_ms_cold

    libs = {"tree": build.load_library()}
    with tempfile.TemporaryDirectory() as tmp:
        libs["old"] = load_old(os.path.abspath(args.old), tmp)
        rows = []
        for name, (shape_key, entry, tail_of) in CASES.items():
            x, idx = probes.probe_inputs(shape_key, seed=11, device="cuda")
            ref = probes.PLAIN[getattr(probes, shape_key)](x, idx)
            runs = {}
            for which, lib in libs.items():
                out = torch.empty_like(x)
                runs[which] = caller(lib, entry, x, idx, out, tail_of(x))
                runs[which]()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name}: the {which} kernel "
                                         "differs from its plain version")
            row = {"probe": name, "shape": list(x.shape),
                   "dtype": str(x.dtype)[6:], "compared": "bitwise"}
            for which in ("old", "tree", "tree", "old") * args.rounds:
                row.setdefault(f"{which}_ms", []).append(
                    device_ms(runs[which]))
                row.setdefault(f"{which}_cold_ms", []).append(
                    device_ms_cold(runs[which]))
            rows.append(row)
            print(json.dumps(row), flush=True)
        lib = libs["tree"]
        floor = {"empty_node_ms": [device_ms(lambda: lib.fami_empty_launch(
            torch.cuda.current_stream().cuda_stream)) for _ in range(2)]}
        rows.append(floor)
        print(json.dumps(floor), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
