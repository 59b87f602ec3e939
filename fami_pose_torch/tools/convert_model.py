"""Convert a reference PyTorch HRNet checkpoint into a port checkpoint
(``tools/convert_model.py`` of the JAX package).

    python -m fami_pose_torch.tools.convert_model --torch pose_hrnet_w48.pth \\
        --out hrnet_w48.ckpt [--nested-under-hrnet]

The ``.pth`` (a state dict, or a ``{begin_epoch, state_dict, optimizer}``
payload; ``module.`` stripped) is remapped as the JAX tool remaps it
(``models/pretrained.py::remap_hrnet_state_dict``): official HRNet names,
bare, or with ``--nested-under-hrnet`` under ``hrnet.`` as in the FAMIPose
model. The output is a ``torch.save`` payload ``{begin_epoch: -1, model,
optimizer: {}, scheduler: {}, step: 0}``, which
``engine/checkpoints.py::load_variables`` reads (``VAL.MODEL_FILE``).
"""

import argparse

import torch

from fami_pose_torch.models.pretrained import (
    load_torch_state_dict, remap_hrnet_state_dict,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--torch", required=True, help="input .pth state dict")
    p.add_argument("--out", required=True, help="output port checkpoint")
    p.add_argument(
        "--nested-under-hrnet", action="store_true",
        help="name the tensors hrnet.X (the FAMIPose layout)",
    )
    args = p.parse_args(argv)

    sd = load_torch_state_dict(args.torch)
    prefix = "hrnet." if args.nested_under_hrnet else ""
    mapped, unmapped = remap_hrnet_state_dict(sd, prefix=prefix)
    print(f"mapped {len(mapped)} arrays; {len(unmapped)} unmapped torch keys")
    for k in unmapped[:10]:
        print("  unmapped:", k)
    payload = {
        "begin_epoch": -1,
        "model": {k: v.contiguous() for k, v in mapped.items()},
        "optimizer": {},
        "scheduler": {},
        "step": 0,
    }
    torch.save(payload, args.out)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
