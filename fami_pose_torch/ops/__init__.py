"""Tensor ops: affine geometry, warps, the DCN, decode, flips."""
