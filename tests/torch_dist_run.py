"""A rank of ``python -m torch.distributed.run`` that drives the port's
command line (``fami_pose_torch.run.main``) and records what each rank
saw, for ``tests/test_torch_distributed_run.py``.

    python -m torch.distributed.run --nproc_per_node 2 tests/torch_dist_run.py \\
        <out_dir> <run.main argv> [-- <run.main argv> ...]

The rank joins the process group first, so that every ``main`` call runs
in it, then runs ``main`` once for each argument list. It records the
checkpoints it wrote (``torch.save`` on a checkpoint path), the state each
auto-resume loaded, the int8 scales and DCN window each evaluator chose,
the evaluators' predictions, their loaders' slices and their results,
and the final train state,
into ``<out_dir>/rank<r>.pt``.
"""

import copy
import os.path as osp
import sys

import torch
import torch.distributed as dist

from fami_pose_torch import run
from fami_pose_torch.engine import checkpoints
from fami_pose_torch.engine.evaluator import Evaluator
from fami_pose_torch.models.quant import quant_scales
from fami_pose_torch.parallel.mesh import maybe_initialize_distributed


def main(argv):
    out_dir, argvs = argv[0], [[]]
    for a in argv[1:]:
        if a == "--":
            argvs.append([])
        else:
            argvs[-1].append(a)
    assert maybe_initialize_distributed(device="cpu")
    rank = dist.get_rank()
    torch.set_num_threads(1)
    record = {"saved": [], "resumed": [], "evals": [], "results": []}

    save = checkpoints.torch.save

    def recording_save(obj, path, *args, **kwargs):
        record["saved"].append(path)
        return save(obj, path, *args, **kwargs)

    checkpoints.torch.save = recording_save

    resume = checkpoints.resume

    def recording_resume(path, state, device=None):
        state, epoch = resume(path, state, device=device)
        # a copy: the next steps update the state in place
        record["resumed"].append((osp.basename(path), epoch,
                                  copy.deepcopy(state.state_dict())))
        return state, epoch

    checkpoints.resume = recording_resume

    eval_checkpoint = Evaluator.eval_checkpoint

    def recording_eval(self, variables):
        out = eval_checkpoint(self, variables)
        scales = quant_scales(self.model)
        record["evals"].append({
            "window": self.dcn_max_offset, "results": out,
            "scales": {k: v.clone() for k, v in scales.items()
                       if v is not None},
            "all_preds": self.all_preds.copy(),
            "all_preds_bb": self.all_preds_bb.copy(),
            "all_boxes": self.all_boxes.copy(),
            "loader": (self.loader.process_index, self.loader.process_count,
                       self.loader.local_batch_size)})
        return out

    Evaluator.eval_checkpoint = recording_eval
    try:
        for args in argvs:
            results = run.main(args)
            if "train" in results:
                record["train_state"] = results["train"].state_dict()
            record["results"].append(
                {k: v for k, v in results.items() if k != "train"})
    finally:
        dist.destroy_process_group()
        checkpoints.torch.save = save
    torch.save(record, osp.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
