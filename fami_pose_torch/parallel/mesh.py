"""Data parallelism over processes (``fami_pose_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over every chip with a ``data``
axis and lets XLA emit the collectives from sharding annotations. The
PyTorch idiom is one process per GPU over ``torch.distributed``: a rank
holds its own replica of the model and the optimizer, loads its contiguous
slice of every global batch (``data/loader.py``), and calls the few
collectives below where the JAX program's sharding implies one:

* the train step's gradient, averaged across ranks in one flat bucket after
  the backward (``engine/steps.py``);
* the train-mode BatchNorm statistics, summed across ranks, with the
  gradient passed back through the sum (``models/layers.py``);
* the eval loop's decoded predictions and the streams' outputs, gathered by
  rows (``engine/evaluator.py``, ``engine/streaming.py``);
* process 0's DCN window and int8 scales, broadcast to every rank.

Two properties of :class:`Mesh` decide where they are called:
``distributed`` (more than one rank) for the all-reduces, broadcasts and
the barrier, and ``sharded`` (a data axis larger than 1) for the gathers
and the slicing of rows. :func:`local_rows` and :func:`all_gather_rows`
read ``sharded`` themselves. With one rank the program is the
single-device program, with no collective.

:func:`maybe_initialize_distributed` joins the process group that a
launcher describes in the environment (``python -m torch.distributed.run``
sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``): NCCL for CUDA devices, gloo for the CPU. Gloo moves a
CUDA tensor through host memory here (:func:`_through_host`), so two ranks
can share one GPU, which NCCL refuses.

``TPU.MESH_SHAPE`` ``[d, m]`` lays d * m ranks out as the JAX package's
``reshape`` of its device list does: rank r holds data index ``r // m``.
The JAX package shards no layer on the ``model`` axis (its batch sharding is
``P("data")``), so the m ranks of one data index replicate one another:
they load the same slice of each global batch and compute the same thing.
The gradient bucket and the BatchNorm sums stay all-reduces over every rank
(each data index's value counted m times, and the BatchNorm count with
them, so the means are those of the d slices); gathered rows take one rank
of each data index (:func:`all_gather_rows`), so no row comes twice.
"""

import dataclasses
import math
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def process_count():
    """The number of ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device="cuda"):
    """``"cuda"`` -> ``"cuda:LOCAL_RANK"`` in a process a launcher started
    (``LOCAL_RANK`` set); an explicit index, or another device, is kept."""
    if str(device) == "cuda" and "LOCAL_RANK" in os.environ:
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return device


def maybe_initialize_distributed(device="cuda", backend=None):
    """Join the process group a launcher describes (``WORLD_SIZE`` > 1 in
    the environment); a no-op with one process or a group already joined.

    Each rank first makes ``cuda:LOCAL_RANK`` its current device when
    ``device`` is a CUDA device, before any CUDA work. The backend is NCCL
    for a CUDA ``device`` and gloo for the CPU, unless ``backend`` names
    one. Returns True when this call joined a group."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(torch.device(local_device(str(device))))
    dist.init_process_group(backend or ("nccl" if on_card else "gloo"),
                            init_method="env://")
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The layout of ``data * model`` ranks, each one device. ``rank`` is
    this process's rank; it holds data index ``rank // model``."""

    data: int
    model: int = 1
    rank: int = 0

    @property
    def shape(self):
        """``{"data": d, "model": m}``, as the JAX mesh's ``shape``."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self):
        """The number of ranks, ``data * model``."""
        return self.data * self.model

    @property
    def data_index(self):
        """This rank's index on the data axis: the slice of every global
        batch it loads."""
        return self.rank // self.model

    @property
    def distributed(self):
        """More than one rank: the gradient bucket, the BatchNorm sums, the
        broadcasts and the barrier go across the ranks."""
        return self.size > 1

    @property
    def sharded(self):
        """A data axis larger than 1: each rank holds a slice of the rows of
        every global batch, and outputs are gathered by rows."""
        return self.data > 1


def is_distributed(mesh):
    """``mesh.distributed``, False without a mesh."""
    return mesh is not None and mesh.distributed


def data_split(mesh=None):
    """``(parts, index)``: the number of slices of every global batch and
    the one this process loads, from ``mesh``'s data axis (default: one
    slice a rank of the process group)."""
    if mesh is None:
        return process_count(), process_index()
    return mesh.data, mesh.data_index


def build_mesh(mesh_shape=None, world=None, rank=None):
    """The mesh of ``TPU.MESH_SHAPE`` over the ranks of the process group
    (``world`` and ``rank`` default to the group's). Entries of -1 absorb
    the ranks the others leave, as in the JAX package's ``build_mesh``;
    missing trailing axes are 1.

    A shape that needs more ranks than there are raises the JAX package's
    ``ValueError``; a shape that leaves ranks out raises ``ValueError``:
    every rank trains or scores a slice of each global batch."""
    n = process_count() if world is None else int(world)
    shape = [int(s) for s in (mesh_shape if mesh_shape else [-1])]
    shape += [1] * (2 - len(shape))
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = n // known
    need = math.prod(shape)
    if need > n:
        raise ValueError(f"mesh shape {shape} needs {need} devices, have {n}")
    if need != n:
        raise ValueError(f"mesh shape {shape} leaves ranks out: the mesh "
                         f"must span all {n} processes")
    return Mesh(data=shape[0], model=shape[1],
                rank=process_index() if rank is None else int(rank))


def local_batch_slice(global_batch_size, mesh=None):
    """The contiguous rows of a global batch this process owns: its data
    index's slice of ``mesh`` (default: one slice a process)."""
    parts, index = data_split(mesh)
    if global_batch_size % parts:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{parts} processes")
    local = global_batch_size // parts
    return slice(index * local, (index + 1) * local)


def pad_to_multiple(n, k):
    return ((n + k - 1) // k) * k


def shard_batch(batch, device):
    """This rank's slice of a batch (a tensor, an array, or a dict, list or
    tuple of them), as the process-sliced loader gives it, on ``device``.
    Other leaves are kept."""
    if isinstance(batch, dict):
        return type(batch)((k, shard_batch(v, device))
                           for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, device) for v in batch)
    if isinstance(batch, torch.Tensor) or hasattr(batch, "__array__"):
        return torch.as_tensor(batch).to(device, non_blocking=True)
    return batch


def local_rows(x, mesh):
    """This rank's contiguous rows of a global batch ``x``: its data
    index's (all of them on a data axis of 1)."""
    if mesh is None or not mesh.sharded:
        return x
    return x[local_batch_slice(x.shape[0], mesh)]


# -- collectives -------------------------------------------------------------------

def _through_host(t, op):
    """Run ``op(u)`` on a tensor the backend can take, in place on ``t``:
    gloo takes host tensors, so a CUDA tensor goes through a host copy."""
    if t.device.type == "cuda" and dist.get_backend() == "gloo":
        u = t.cpu()
        op(u)
        t.copy_(u)
    else:
        op(t)
    return t


def all_reduce_mean_(flat):
    """Average ``flat`` across the ranks, in place: a sum in ``flat``'s
    dtype, then a division by the number of ranks."""
    _through_host(flat, lambda u: dist.all_reduce(u, op=dist.ReduceOp.SUM))
    return flat.div_(process_count())


def all_reduce_sum(x):
    """The sum of ``x`` over the ranks, differentiable: the gradient of
    every rank's output is summed back into each rank's input (each rank's
    loss depends on every rank's ``x`` through the sum)."""
    return _AllReduceSum.apply(x)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        return _through_host(
            out, lambda u: dist.all_reduce(u, op=dist.ReduceOp.SUM))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        return _through_host(
            grad, lambda u: dist.all_reduce(u, op=dist.ReduceOp.SUM))


def all_gather_rows(x, mesh=None):
    """The ranks' ``x`` (equal shapes) concatenated on the first axis, in
    rank order, on every rank. Over a ``mesh``, one rank of each data index
    (the first), in data order: the ranks of one data index hold the same
    rows; ``x`` itself when the mesh is not ``sharded``."""
    if mesh is not None and not mesh.sharded:
        return x
    host = x.device.type == "cuda" and dist.get_backend() == "gloo"
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    if mesh is not None and mesh.model > 1:
        parts = parts[::mesh.model]
    return torch.cat(parts).to(x.device)


def broadcast_(t, src=0):
    """Rank ``src``'s ``t`` into every rank's ``t``, in place."""
    return _through_host(t, lambda u: dist.broadcast(u, src=src))


def broadcast_tensors(tensors, src=0):
    """Rank ``src``'s values of a list of tensors on every rank, in one
    float32 broadcast of their concatenation; returns new float32 tensors
    of their shapes on the first one's device."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    broadcast_(flat, src)
    return [v.view_as(t) for t, v in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


def barrier(mesh):
    """Wait for every rank (a no-op on a mesh of one rank)."""
    if mesh.distributed:
        dist.barrier()
