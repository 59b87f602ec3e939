"""The port's warps (``fami_pose_torch.ops.warp``, NCHW) against the JAX
package's (NHWC) on the same numpy inputs: the translation warp against
``warp_translate`` (the ``slice`` form), ``warp_translate_matmul`` and the
Pallas kernel ``warp_translate_pallas`` (interpret mode), with shifts past
the clamp; and the device crop ``crop_and_warp``.

Tolerance: 1e-5 absolute for the f32 warps (the JAX matmul form is itself
1 ulp from the slice form); none in bf16, where each JAX warp rounds at its
own points and the port's ``impl`` follows them bit for bit; 5e-3 absolute on 0..255 pixel values for the
crop: both compute the sample coordinates in f32, which differ by ~1e-5 px
(XLA fuses and orders the multiply-adds differently), times an image
gradient of up to 255 per pixel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fami_pose_tpu.ops.pallas.warp import warp_translate_pallas
from fami_pose_tpu.ops.warp import crop_and_warp as jax_crop_and_warp
from fami_pose_tpu.ops.warp import warp_translate as jax_warp_translate
from fami_pose_tpu.ops.warp import warp_translate_matmul
from fami_pose_torch.ops.warp import crop_and_warp, warp_translate


def _inputs(rng, n=6, h=10, w=9, c=3, max_shift=26):
    img = rng.randn(n, h, w, c).astype(np.float32)
    # half the shifts beyond the clamp, two exactly on it
    off = ((rng.rand(n, 2) * 2 - 1) * 2 * max_shift).astype(np.float32)
    off[0] = [max_shift, -max_shift]
    off[1] = [0.25, -3.75]
    return img, off


def _port(img, off, max_shift):
    out = warp_translate(
        torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))),
        torch.from_numpy(off), max_shift=max_shift,
    )
    return out.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("max_shift", [26, 32])
def test_matches_slice_warp(rng, max_shift):
    img, off = _inputs(rng, max_shift=max_shift)
    ref = jax_warp_translate(jnp.asarray(img), jnp.asarray(off),
                             max_shift=max_shift)
    np.testing.assert_allclose(_port(img, off, max_shift), np.asarray(ref),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("max_shift", [26, 32])
def test_matches_matmul_warp(rng, max_shift):
    img, off = _inputs(rng, max_shift=max_shift)
    ref = warp_translate_matmul(jnp.asarray(img), jnp.asarray(off),
                                max_shift=max_shift)
    np.testing.assert_allclose(_port(img, off, max_shift), np.asarray(ref),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("max_shift", [26, 32])
def test_matches_pallas_warp(rng, max_shift):
    img, off = _inputs(rng, n=3, h=8, w=8, c=2, max_shift=max_shift)
    ref = warp_translate_pallas(jnp.asarray(img), jnp.asarray(off),
                                max_shift=max_shift)
    np.testing.assert_allclose(_port(img, off, max_shift), np.asarray(ref),
                               atol=1e-5, rtol=0)


JAX_WARPS = {"slice": jax_warp_translate, "matmul": warp_translate_matmul,
             "pallas": warp_translate_pallas}


@pytest.mark.parametrize("impl", sorted(JAX_WARPS))
def test_bf16_rounds_as_the_jax_warp(rng, impl):
    """In bf16 the three JAX warps differ (the matmul form rounds its
    weights and its row pass, the slice form every elementwise op, the
    Pallas kernel once); the port's warp with the same ``impl`` equals each
    bitwise, and differs from the other two."""
    img, off = _inputs(rng, n=4, h=8, w=8, c=3)
    img = torch.from_numpy(img).bfloat16().float().numpy()
    refs = {k: np.asarray(f(jnp.asarray(img, jnp.bfloat16), jnp.asarray(off),
                            max_shift=26).astype(jnp.float32))
            for k, f in JAX_WARPS.items()}
    got = warp_translate(
        torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
        .bfloat16(), torch.from_numpy(off), max_shift=26, impl=impl)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, refs[impl])
    for other in set(JAX_WARPS) - {impl}:
        assert not np.array_equal(refs[other], refs[impl])


def test_unknown_impl_is_refused(rng):
    img, off = _inputs(rng)
    with pytest.raises(ValueError, match="warp impl"):
        warp_translate(torch.from_numpy(img).bfloat16(),
                       torch.from_numpy(off), impl="gather")


def test_small_shift_moves_content(rng):
    """dst(p) = src(p - t): an integer shift moves the image by t."""
    img = rng.randn(1, 6, 7, 1).astype(np.float32)
    out = _port(img, np.array([[2.0, 1.0]], np.float32), 26)
    np.testing.assert_array_equal(out[0, 1:, 2:], img[0, :-1, :-2])
    assert np.all(out[0, 0] == 0) and np.all(out[0, :, :2] == 0)


@pytest.mark.parametrize("rot", [0.0, 17.0])
def test_crop_and_warp_matches_jax(rng, rot):
    frames = rng.randint(0, 256, size=(3, 40, 56, 3)).astype(np.uint8)
    centers = np.array([[28, 20], [10, 30], [50, 5]], np.float32)
    scales = np.array([[0.15, 0.2], [0.3, 0.4], [0.1, 0.133]], np.float32)
    rots = np.full((3,), rot, np.float32)
    ref = jax_crop_and_warp(jnp.asarray(frames), jnp.asarray(centers),
                            jnp.asarray(scales), jnp.asarray(rots), (32, 24))
    got = crop_and_warp(
        torch.from_numpy(frames).permute(0, 3, 1, 2), torch.from_numpy(centers),
        torch.from_numpy(scales), torch.from_numpy(rots), (32, 24),
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, 32, 24)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=5e-3, rtol=0)


def test_wrapper_refuses_a_device_without_kernel(rng):
    img, off = _inputs(rng)
    with pytest.raises(ValueError, match="no warp kernel"):
        warp_translate(torch.from_numpy(img).to("meta"),
                       torch.from_numpy(off).to("meta"))
