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
