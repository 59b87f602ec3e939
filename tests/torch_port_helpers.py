"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
random flax variables with non-trivial BatchNorm state, and NHWC <-> NCHW."""

import math

import jax
import numpy as np
import torch


def random_variables(init, seed=0):
    """Flax variables of the shapes ``init(key)`` returns, drawn with numpy.

    Only the shapes are traced (``jax.eval_shape``), so no init is compiled.
    Kernels are N(0, 1/fan_in); biases, BatchNorm scales, running means and
    running variances are random too, so eval-mode BN is not the identity.
    """
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def leaf(coll, name, shape):
        if name == "kernel":
            a = rs.randn(*shape) / math.sqrt(math.prod(shape[:-1]))
        elif coll == "batch_stats" and name == "mean":
            a = rs.randn(*shape) * 0.1
        elif coll == "batch_stats" and name == "var":
            a = rs.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "bias":
            a = 0.05 * rs.randn(*shape)
        else:
            raise KeyError(f"no rule for the flax leaf {coll}/.../{name}")
        return a.astype(np.float32)

    def walk(tree, coll):
        return {k: walk(v, coll) if hasattr(v, "items")
                else leaf(coll, k, v.shape) for k, v in tree.items()}

    return {coll: walk(shapes[coll], coll) for coll in shapes}


def nchw(a):
    """NHWC numpy -> NCHW torch (float32, contiguous)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def make_port_cfg(json_dir, img_dir, posetrack18=False, distance=3):
    """The port's twin of ``fixtures.make_cfg``: the same settings on a
    ``fami_pose_torch`` config (``tools/synthetic_fixture.py``)."""
    from fami_pose_torch.tools.synthetic_fixture import make_cfg

    return make_cfg(json_dir, img_dir, posetrack18, distance)


def tiny_model_cfg(cfg, out_dir):
    """The tiny FAMIPose settings of the JAX package's evaluator tests, on
    either package's config (``TINY_EXTRA`` is the same dict in both)."""
    from fami_pose_torch.models.hrnet import TINY_EXTRA

    cfg.MODEL.NAME = "FAMIPose"
    cfg.MODEL.EXTRA = TINY_EXTRA
    cfg.MODEL.PRETRAINED = ""
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DCN_OFFSET_GROUPS = 4
    cfg.TPU.DCN_MAX_OFFSET = 2
    cfg.TPU.MESH_SHAPE = [1, 1]
    cfg.VAL.BATCH_SIZE_PER_GPU = 4
    cfg.TEST.BATCH_SIZE_PER_GPU = 4
    cfg.OUTPUT_DIR = out_dir
    return cfg


def save_port_checkpoint(directory, epoch, variables):
    """Flax variables (nested dicts of numpy arrays, as a JAX checkpoint
    holds them) -> a port checkpoint ``epoch_{N}_state.ckpt`` that
    ``fami_pose_torch``'s ``Evaluator.load_variables`` reads; returns its
    path."""
    import os

    from fami_pose_torch.engine.checkpoints import checkpoint_path
    from fami_pose_torch.models.bridge import state_dict_from_flax

    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, epoch)
    torch.save({"model": state_dict_from_flax(variables),
                "begin_epoch": int(epoch)}, path)
    return path


def flax_variables_from_port(state_dict):
    """A port ``state_dict`` -> flax ``{"params", "batch_stats"}`` through
    the JAX package's reference-name remap (the reverse bridge)."""
    from fami_pose_tpu.models.torch_remap import remap_fami_pose_state_dict

    params, stats, unmapped = remap_fami_pose_state_dict(
        {k: v.detach().cpu().numpy() for k, v in state_dict.items()})
    assert unmapped == [], unmapped
    return {"params": params, "batch_stats": stats}
