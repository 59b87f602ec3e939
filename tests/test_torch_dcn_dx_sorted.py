"""The plain sorted-list dx of the exact-mode DCN on the CPU.

:func:`deform_conv2d_dx_sorted_plain` sums each input pixel's sources in the
order of the card's exact-mode ``dcn_bwd.cu::dx_tiles_kernel``: the
pixel's four candidate floor-corner keys in ascending order, each key's
sources by ascending index ``k * Ho * Wo + p``. It is held

* to the dx of ``jax.vjp`` of ``fami_pose_tpu.ops.deform_conv.deform_conv2d``
  (the exact DCN, whose adjoint is XLA's scatter-add) on the same numpy
  inputs, at 1e-5 of dx's scale (f32 sums in another order);
* to the dx of :func:`deform_conv2d_backward_plain`'s scatter, at 1e-6 of
  dx's scale (the same products in another order);

at dilation 1 with padding 1 (the deform blocks) and dilation 3 with
padding 3 (the main path), groups of Cg in {1, 3, 4, 8} channels, with and
without a mask, on offsets that are fractional, integers, ~N(0, 8) px, a
mix of those, and wholly off the image; and, against the scatter, on the hot
spots of ``tests/dcn_hot_spots.py`` (hundreds of sources on one corner,
every source of a plane on the keys two 16 x 16 pixel tiles share, most
sources off the image), whose long lists the card's tiled gather streams
through shared memory in several windows. The exact mode's size limits
(``_check_backward_args``) are held here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcn_hot_spots import KINDS, corner_count, hot_spot_offsets
from fami_pose_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from fami_pose_torch.ops.deform_conv import (
    EXACT_MAX_KEY_TILES, EXACT_MAX_SOURCES, _check_backward_args,
    deform_conv2d_backward_plain, deform_conv2d_dx_sorted_plain,
)

C_OUT = 6


def _offsets(rng, shape, kind, plane):
    """NHWC offsets of one kind: fractional in (-2.5, 2.5), integers from
    ~N(0, 3), ~N(0, 8) px (the blocks' spread: many samples off the image),
    a mix of the three, or every sample wholly off the image (past the
    plane by a margin in a random direction)."""
    if kind == "fractional":
        return (rng.rand(*shape) * 5 - 2.5).astype(np.float32)
    if kind == "integer":
        return np.round(rng.randn(*shape) * 3).astype(np.float32)
    if kind == "normal8":
        return (rng.randn(*shape) * 8).astype(np.float32)
    if kind == "mixed":
        pick = rng.randint(0, 3, size=shape)
        return np.choose(pick, [_offsets(rng, shape, k, plane) for k in
                                ("fractional", "integer", "normal8")])
    far = sum(plane) + 5.0
    return (np.sign(rng.rand(*shape) - 0.5) * (far + rng.rand(*shape))
            ).astype(np.float32)


def _inputs(seed, n, plane, g, cg, kind, with_mask):
    rng = np.random.RandomState(seed)
    h, w = plane
    c = g * cg
    x = rng.randn(n, h, w, c).astype(np.float32)
    off = _offsets(rng, (n, h, w, 2 * g * 9), kind, plane)
    msk = rng.rand(n, h, w, g * 9).astype(np.float32) if with_mask else None
    wgt = (rng.randn(3, 3, c, C_OUT) * 0.2).astype(np.float32)
    gout = rng.randn(n, h, w, C_OUT).astype(np.float32)
    return x, off, msk, wgt, gout


def _t(a):
    """NHWC numpy -> NCHW torch."""
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_args(x, off, msk, wgt, gout):
    return (_t(x), _t(off), _t(msk),
            torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1))),
            _t(gout))


def _scale_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


# (dilation, G, Cg, mask, offsets, plane, batch): the blocks' settings
# (dilation 1, one group of 8 without a mask), the main path's 12 groups of
# 4 at dilation 3 with a mask, groups of 3 and of 1 channel, every offset
# kind; four settings, so that JAX compiles four VJPs (~6 s each on a CPU)
# and the other cases reuse them
CASES = [(1, 1, 8, False, "normal8", (9, 7), 2),
         (1, 1, 8, False, "off", (9, 7), 2),
         (3, 12, 4, True, "fractional", (8, 12), 1),
         (3, 12, 4, True, "integer", (8, 12), 1),
         (3, 12, 4, True, "mixed", (8, 12), 1),
         (3, 4, 3, False, "fractional", (7, 9), 1),
         (1, 3, 1, True, "integer", (6, 7), 2),
         (1, 3, 1, True, "normal8", (6, 7), 2)]
# held to the scatter only: the blocks' two groups of 4 with a mask, groups
# of 8 at dilation 3, ragged planes
SCATTER_ONLY = [(1, 2, 4, True, "normal8", (8, 9), 2),
                (1, 2, 4, True, "mixed", (11, 5), 1),
                (3, 2, 8, True, "mixed", (9, 8), 1),
                (3, 12, 4, False, "off", (6, 6), 1)]
IDS = [f"dil{d}-G{g}-Cg{cg}-{'mask' if m else 'nomask'}-{k}"
       for d, g, cg, m, k, _, _ in CASES + SCATTER_ONLY]


def _case(i, dil, g, cg, with_mask, kind, plane, n):
    arrays = _inputs(100 + i, n, plane, g, cg, kind, with_mask)
    kw = dict(padding=dil, dilation=dil, offset_groups=g)
    return arrays, kw


def _assert_matches(got, ref, tol):
    assert got.shape == ref.shape
    if not np.abs(np.asarray(ref)).max():  # every sample off the image
        assert not np.abs(np.asarray(got)).max()
        return
    assert _scale_err(got, ref) <= tol


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS[:len(CASES)])
def test_sorted_dx_matches_the_jax_vjp(i):
    (x, off, msk, wgt, gout), kw = _case(i, *CASES[i])

    def f(x_):
        return jax_deform_conv2d(
            x_, jnp.asarray(off), None if msk is None else jnp.asarray(msk),
            jnp.asarray(wgt), **kw)

    _, vjp = jax.vjp(f, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(gout))[0])
    got = deform_conv2d_dx_sorted_plain(*_port_args(x, off, msk, wgt, gout),
                                        **kw)
    _assert_matches(got.numpy().transpose(0, 2, 3, 1), ref, 1e-5)


@pytest.mark.parametrize("i", range(len(IDS)), ids=IDS)
def test_sorted_dx_matches_the_scatter_dx(i):
    (x, off, msk, wgt, gout), kw = _case(i, *(CASES + SCATTER_ONLY)[i])
    args = _port_args(x, off, msk, wgt, gout)
    got = deform_conv2d_dx_sorted_plain(*args, **kw)
    ref = deform_conv2d_backward_plain(*args, max_offset=None, **kw)[0]
    assert got.dtype == ref.dtype
    _assert_matches(got.numpy(), ref.numpy(), 1e-6)


def test_sorted_dx_exact_at_integer_offsets():
    """Integer offsets: each source feeds one corner with weight 1 (the
    other three weigh 0 and are skipped), so each dx is a sum of m * dcol
    values; the sorted lists and the scatter agree to the last bit in
    float64."""
    (x, off, msk, wgt, gout), kw = _case(3, *CASES[3])
    args = [a.double() for a in _port_args(x, off, msk, wgt, gout)]
    got = deform_conv2d_dx_sorted_plain(*args, **kw)
    ref = deform_conv2d_backward_plain(*args, max_offset=None, **kw)[0]
    assert got.dtype == torch.float64
    assert _scale_err(got.numpy(), ref.numpy()) <= 1e-14


def test_sorted_dx_rounds_once_into_the_input_type():
    (x, off, msk, wgt, gout), kw = _case(2, *CASES[2])
    args = _port_args(x, off, msk, wgt, gout)
    bf = deform_conv2d_dx_sorted_plain(
        *[a.to(torch.bfloat16) for a in args], **kw)
    ref = deform_conv2d_dx_sorted_plain(
        *[a.to(torch.bfloat16).float() for a in args], **kw)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, ref.to(torch.bfloat16))


def test_sorted_dx_sums_each_pixel_in_key_then_source_order():
    """Three sources land on input pixel (1, 1) with values whose float32
    sum depends on the order: 1.0 from key (0, 0) and 2^-24 twice from key
    (1, 1). Key order puts 1.0 first (1 + 2^-24 + 2^-24 rounds to 1), though
    its source index (tap 8 of pixel (0, 0), 72) is the largest; by source
    index alone (8, 40, 72) the sum would be 2^-23 + 1. The source at (1, 1)
    shifted by (-0.5, -0.5) keys (0, 0) and reaches (1, 1) by its corner 11
    at weight 1/4 (mask 4); tap 0 of pixel (2, 2) and tap 4 of pixel (1, 1)
    sit on (1, 1) (offset 0, key (1, 1), corner 00); every other mask is 0."""
    h = w = 3
    x = torch.zeros(1, 1, h, w)
    off = torch.zeros(1, 18, h, w)
    off[0, 2 * 8, 0, 0] = -0.5  # tap 8 (dy) of pixel (0, 0)
    off[0, 2 * 8 + 1, 0, 0] = -0.5  # tap 8 (dx)
    msk = torch.zeros(1, 9, h, w)
    msk[0, 8, 0, 0] = 4.0
    msk[0, 4, 1, 1] = 2.0 ** -24
    msk[0, 0, 2, 2] = 2.0 ** -24
    wgt = torch.ones(1, 1, 3, 3)
    gout = torch.zeros(1, 1, h, w)
    for p in range(3):
        gout[0, 0, p, p] = 1.0
    dx = deform_conv2d_dx_sorted_plain(x, off, msk, wgt, gout, padding=1,
                                       dilation=1)
    assert float(dx[0, 0, 1, 1]) == 1.0
    # the scatter goes tap by tap: 2^-24 + 2^-24 + 1
    ref = deform_conv2d_backward_plain(x, off, msk, wgt, gout, padding=1,
                                       dilation=1)[0]
    assert float(ref[0, 0, 1, 1]) == 1.0 + 2.0 ** -23


# (dilation, G, Cg, mask, plane): the main path's 12 groups of 4 at dilation
# 3 with a mask, the blocks' one group of 8 at dilation 1 without; two
# images each
HOT_SETTINGS = [(3, 12, 4, True, (16, 12)), (1, 1, 8, False, (18, 17))]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("setting", range(len(HOT_SETTINGS)),
                         ids=["dil3-G12-Cg4-mask", "dil1-G1-Cg8-nomask"])
def test_sorted_dx_matches_the_scatter_at_hot_spots(kind, setting):
    """Hot spots against the scatter at 1e-6 of dx's scale: 600 sources of
    each image's first plane on one corner (a list 600 long), every
    source of the first plane on shared tile-border keys, nine in ten
    sources off the image."""
    dil, g, cg, with_mask, (h, w) = HOT_SETTINGS[setting]
    rng = np.random.RandomState(7 + setting)
    n, c = 2, g * cg
    off = hot_spot_offsets(11 + setting, n, g, h, w, dil, kind, count=600)
    if kind == "corner":
        assert corner_count(off, dil, h, w) >= 600
    x = rng.randn(n, c, h, w).astype(np.float32)
    msk = rng.rand(n, 9 * g, h, w).astype(np.float32) if with_mask else None
    wgt = (rng.randn(C_OUT, c, 3, 3) * 0.2).astype(np.float32)
    gout = rng.randn(n, C_OUT, h, w).astype(np.float32)
    args = [None if a is None else torch.from_numpy(a)
            for a in (x, off, msk, wgt, gout)]
    kw = dict(padding=dil, dilation=dil, offset_groups=g)
    got = deform_conv2d_dx_sorted_plain(*args, **kw)
    ref = deform_conv2d_backward_plain(*args, max_offset=None, **kw)[0]
    assert float(ref.abs().max()) > 0
    _assert_matches(got.numpy(), ref.numpy(), 1e-6)


@pytest.mark.parametrize("case", ["sources", "key tiles", "planes", "taken"])
def test_exact_mode_size_limits(case):
    """The exact mode's dx kernel takes at most EXACT_MAX_SOURCES sources
    (taps x output pixels) and EXACT_MAX_KEY_TILES tiles of 16 x 16 keys a
    plane and 65535 planes; past any of them the check refuses by name,
    and a windowed call of the same size is not refused for it."""
    # (N, G, H, W): 9 * 1366^2 > 2^24 sources; 640^2 has 41^2 = 1681 key
    # tiles (9 * 640^2 < 2^24); 65536 planes; 623^2: 39^2 = 1521 tiles
    n, g, h, w = {"sources": (1, 1, 1366, 1366), "key tiles": (1, 1, 640, 640),
                  "planes": (65536, 1, 1, 1), "taken": (1, 1, 623, 623)}[case]
    x = torch.empty(n, g, h, w)
    off = torch.empty(n, 18 * g, h, w)
    wgt = torch.empty(1, g, 3, 3)
    gout = torch.empty(n, 1, h, w)
    if case == "sources":
        assert 9 * h * w > EXACT_MAX_SOURCES
    if case in ("key tiles", "taken"):
        assert (((h + 16) // 16) ** 2 > EXACT_MAX_KEY_TILES) == (
            case == "key tiles")
    if case == "taken":
        assert _check_backward_args(x, off, None, wgt, gout, 1, 1, g) == (h, w)
        return
    with pytest.raises(ValueError, match="exact mode's dx kernel"):
        _check_backward_args(x, off, None, wgt, gout, 1, 1, g)
    assert _check_backward_args(x, off, None, wgt, gout, 1, 1, g,
                                max_offset=4) == (h, w)
