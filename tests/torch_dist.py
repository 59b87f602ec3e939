"""Run a function of the port in N processes over a gloo process group on
the CPU, for the data-parallel tests (``tests/test_torch_*.py``).

:func:`run_ranks` writes a payload with ``torch.save``, starts one Python
process a rank (``python tests/torch_dist.py <function> <rank> <world>
<dir>``: this file as a script, which imports torch and the port only, no
JAX), each joins a gloo group through a file in ``<dir>``, calls
``<function>(mesh, payload)`` from this module on one intra-op thread, and
saves what it returns; the results come back in rank order. ``mesh`` is
``build_mesh(payload["mesh_shape"])``, ``[-1, 1]`` (a data axis over every
rank) when the payload names none.
"""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import torch

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)


def run_ranks(function, world, directory, payload=None, timeout=300):
    """``[result of rank 0, result of rank 1, ...]`` of ``function(mesh,
    payload)`` run in ``world`` gloo processes; raises with a rank's output
    if it fails."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    torch.save(payload, osp.join(directory, "payload.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, osp.abspath(__file__), function, str(rank),
         str(world), directory],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {function} failed "
                               f"(rc {p.returncode}):\n{out[-6000:]}")
    return [torch.load(osp.join(directory, f"result{rank}.pt"),
                       weights_only=False) for rank in range(world)]


# -- functions run on every rank ---------------------------------------------------

def config(payload):
    """The config of ``payload["cfg"]`` (a ``CfgNode`` sent as its plain
    dict, ``CfgNode._to_plain``)."""
    from fami_pose_torch.config.node import CfgNode

    return CfgNode._from_plain(payload["cfg"])


def tiny_model(payload):
    """The port's FAMIPose of ``payload["model_kw"]`` (or of the config
    ``payload["cfg"]`` when there are none) with ``payload["state_dict"]``,
    in training mode."""
    from fami_pose_torch.models.fami_pose import FAMIPose

    if "model_kw" in payload:
        model = FAMIPose(**payload["model_kw"])
    else:
        model = FAMIPose.from_config(config(payload))
    model.load_state_dict(payload["state_dict"])
    return model.train()


def train_step(mesh, payload):
    """One train step of the tiny model on this rank's data index's slice
    of the global batch ``payload["batch"]`` (numpy, as
    ``prepare_train_batch`` takes it) with the optimizer of the config
    ``payload["cfg"]``; returns the state, the gradients and the
    metrics."""
    from fami_pose_torch.data.loader import prepare_train_batch
    from fami_pose_torch.engine.steps import make_train_step
    from fami_pose_torch.engine.train_state import TrainState
    from fami_pose_torch.optim import build_optimizer
    from fami_pose_torch.parallel.mesh import local_batch_slice

    model = tiny_model(payload)
    model.hrnet.remat = model.hrnet.remat or bool(payload.get("remat"))
    opt, sched = build_optimizer(config(payload), model, steps_per_epoch=5)
    state = TrainState(model, opt, sched)
    rows = local_batch_slice(payload["batch"][0].shape[0], mesh)
    batch = prepare_train_batch(*(a[rows] for a in payload["batch"]),
                                *payload["prepare"])
    step = make_train_step(mesh=mesh,
                           bf16_grads=bool(payload.get("bf16_grads", False)))
    state, metrics = step(state, batch)
    return {"state_dict": model.state_dict(),
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "metrics": {k: v.clone() for k, v in metrics.items()},
            "optimizer": opt.state_dict()}


def trainer_init(mesh, payload):
    """A ``Trainer`` of the config ``payload["cfg"]`` on the CPU over
    ``mesh``, on ``chip_smoke.SyntheticPoseDataset``: its mesh, its
    loader's share of the global batch and its model's initial state."""
    from chip_smoke import SyntheticPoseDataset
    from fami_pose_torch.engine.trainer import Trainer

    cfg = config(payload)
    data = SyntheticPoseDataset(8, tuple(cfg.MODEL.IMAGE_SIZE), 4)
    trainer = Trainer(cfg, dataset=data, device="cpu")
    return {"mesh": trainer.mesh,
            "local_batch": trainer.loader.local_batch_size,
            "state": trainer.model.state_dict()}


def batch_norm(mesh, payload):
    """The port's BatchNorm in training mode on this rank's rows of
    ``payload["x"]``: the output and the gradients of ``sum(y * cot)``,
    plainly and with the forward recomputed in the backward
    (``torch.utils.checkpoint`` with ``recomputing``, as
    ``TPU.REMAT_BACKBONE`` runs it)."""
    from torch.utils.checkpoint import checkpoint

    from fami_pose_torch.models.hrnet import _remat_contexts
    from fami_pose_torch.models.layers import BatchNorm, sync_batch_norm

    out = {}
    for remat in (False, True):
        bn = BatchNorm(payload["x"].shape[1])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(payload["scale"]))
            bn.bias.copy_(torch.from_numpy(payload["bias"]))
        sync_batch_norm(bn, mesh).train()
        rows = slice(mesh.rank * payload["local"],
                     (mesh.rank + 1) * payload["local"])
        x = torch.from_numpy(payload["x"][rows]).requires_grad_(True)
        cot = torch.from_numpy(payload["cot"][rows])
        if remat:
            y = checkpoint(bn, x, use_reentrant=False,
                           context_fn=_remat_contexts)
        else:
            y = bn(x)
        (y * cot).sum().backward()
        out[remat] = {"y": y.detach(), "dx": x.grad, "dscale": bn.weight.grad,
                      "dbias": bn.bias.grad,
                      "mean": bn.running_mean.clone(),
                      "var": bn.running_var.clone()}
    return out


def collectives(mesh, payload):
    """Each collective helper of ``parallel/mesh.py`` once, and the mesh
    arithmetic in a world of ``mesh.data`` ranks."""
    from fami_pose_torch.parallel import mesh as pm

    r = mesh.rank
    out = {"mean": pm.all_reduce_mean_(torch.tensor([1.0, 2.0]) * (r + 1)),
           "rows": pm.all_gather_rows(torch.full((2, 3), float(r))),
           "bcast": pm.broadcast_(torch.tensor([float(r + 5)])),
           "bcast_list": pm.broadcast_tensors(
               [torch.tensor([r + 1.0, r + 2.0]), torch.tensor(float(r))]),
           "slice": pm.local_batch_slice(8),
           "shard": pm.shard_batch({"a": np.ones((2, 3)), "n": 3}, "cpu")}
    x = torch.tensor([1.0 + r, 2.0], requires_grad=True)
    (pm.all_reduce_sum(x) * torch.tensor([1.0, 3.0 + r])).sum().backward()
    out["sum_grad"] = x.grad
    refused = {}
    for shape in ([4], [1, 1], [1, 2], [8, 1]):
        try:
            pm.build_mesh(shape)
        except (ValueError, NotImplementedError) as e:
            refused[str(shape)] = type(e).__name__
    out["refused"] = refused
    out["meshes"] = [pm.build_mesh(s) for s in ([-1, 1], [2], [-1], None)]
    out["model_meshes"] = [pm.build_mesh(s) for s in ([1, 2], [1, -1])]
    pm.barrier(mesh)
    return out


def streaming(mesh, payload):
    """The port's streaming predictor over ``mesh`` on the global frames
    ``payload["frames"]`` (T, B, 3, H, W), with a re-prime of the streams
    ``payload["moved"]`` at step ``payload["reprime_at"]``; returns every
    step's outputs."""
    from fami_pose_torch.engine.streaming import StreamingPosePredictor

    model = tiny_model(payload).eval()
    frames = torch.from_numpy(payload["frames"])
    pred = StreamingPosePredictor(model, distance=payload["distance"],
                                  flip_test=True, reprime_iou=0.5,
                                  mesh=mesh)
    centers, scales = payload["centers"], payload["scales"]
    pred.prime(frames[0], centers, scales)
    outs, masks = [], []
    for t in range(1, frames.shape[0]):
        if t == payload["reprime_at"]:
            moved = centers + payload["moved"][:, None] * 300.0
            masks.append(pred.maybe_reprime(moved, scales, frames[:t]))
        outs.append(pred(frames[t]))
    return {"outs": outs, "masks": masks,
            "local_streams": int(pred._state.feats.shape[1])}


def model_axis(mesh, payload):
    """Over a mesh with a model axis (``payload["mesh_shape"]``): the mesh,
    this rank's slice of a global batch of 4, what ``all_gather_rows``
    returns of rows filled with the rank, one train step of the
    tiny model on the data index's slice of ``payload["batch"]`` (its
    state, gradients and metrics), the ``Trainer``'s loader share of the
    config ``payload["cfg"]`` with that mesh, and the eval step's heatmaps
    on the slice."""
    from fami_pose_torch.data.loader import prepare_train_batch
    from fami_pose_torch.engine.steps import make_eval_step, make_train_step
    from fami_pose_torch.engine.train_state import TrainState
    from fami_pose_torch.optim import build_optimizer
    from fami_pose_torch.parallel import mesh as pm

    out = {"mesh": mesh, "slice": pm.local_batch_slice(4, mesh),
           "rows": pm.all_gather_rows(
               torch.full((2, 3), float(mesh.rank)), mesh)}
    model = tiny_model(payload)
    opt, sched = build_optimizer(config(payload), model, steps_per_epoch=5)
    rows = pm.local_batch_slice(payload["batch"][0].shape[0], mesh)
    batch = prepare_train_batch(*(a[rows] for a in payload["batch"]),
                                *payload["prepare"])
    state, metrics = make_train_step(mesh=mesh)(
        TrainState(model, opt, sched), batch)
    out.update(state_dict=model.state_dict(),
               grads={n: p.grad for n, p in model.named_parameters()},
               metrics={k: v.clone() for k, v in metrics.items()})
    model.eval()
    out["heatmaps"] = make_eval_step(model, flip_test=True, mesh=mesh)(
        batch["kf"], batch["sup"])
    from chip_smoke import SyntheticPoseDataset
    from fami_pose_torch.engine.trainer import Trainer

    cfg = config(payload)
    cfg.TPU.MESH_SHAPE = list(payload["mesh_shape"])
    trainer = Trainer(cfg, dataset=SyntheticPoseDataset(
        8, tuple(cfg.MODEL.IMAGE_SIZE), 4), device="cpu")
    out["trainer"] = (trainer.mesh, trainer.loader.local_batch_size,
                      trainer.loader.process_index,
                      trainer.loader.process_count)
    return out


def main(argv):
    function, rank, world, directory = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from fami_pose_torch.parallel.mesh import build_mesh

    dist.init_process_group(
        "gloo", init_method="file://" + osp.join(directory, "rendezvous"),
        rank=rank, world_size=world)
    try:
        payload = torch.load(osp.join(directory, "payload.pt"),
                             weights_only=False)
        mesh = build_mesh((payload or {}).get("mesh_shape") or [-1, 1])
        result = globals()[function](mesh, payload)
        torch.save(result, osp.join(directory, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
