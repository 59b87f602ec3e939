"""Offsets that pile the exact-mode DCN's sources onto a few keys.

The exact mode's dx keys every source (group, tap, output pixel) by the
floor corner of its sample and gathers each input pixel's four keys' lists
(``dcn_bwd.cu``: the sources bucketed by 16 x 16 key tile, each pixel tile's
lists streamed through shared memory in windows). These fields stress that
gather: many sources on one corner (more than a window holds), every
source of the first plane on the key rows and columns that two pixel tiles
share, most sources off the image. Numpy only, so that the CPU tests (held
against the scatter) and the card tests (held against the plain sorted
version) take the same fields.
"""

import numpy as np

KINDS = ("corner", "border", "off")


def _taps(dilation):
    k = np.arange(9)
    return (k // 3 - 1) * dilation, (k % 3 - 1) * dilation


def hot_spot_offsets(seed, n, groups, h, w, dilation, kind, count=0):
    """NCHW float32 offsets, (n, 2 * groups * 9, h, w), for a 3x3 DCN with
    padding = dilation (output plane h x w):

    * ``corner``: uniform in (-6, 6) px, then in each image the first
      ``count`` sources of group 0 (source s = tap * h * w + pixel, in
      order) sampled at one point, (h / 2 + 0.25, w / 3 + 0.5) in image 0
      and (h / 2 - 8 + 0.75, w / 2 - 6 + 0.5) in image 1: ``count`` sources
      on one floor corner, whose four corners all weigh more than 0 (the
      offsets exact in bfloat16 up to 96 x 72 at dilation 3);
    * ``border``: every source of image 0, group 0 moved onto the key rows
      y0 = 15, 31, ... and columns x0 = 15, 31, ... (the keys a pixel tile
      of 16 x 16 shares with the tile below or to its right: key y0 + 1 is
      a multiple of 16), each to the nearest such row or column at a
      fraction in {0, 1/4, 1/2, 3/4} (exact in bfloat16); the other planes
      uniform in (-6, 6);
    * ``off``: uniform in (-6, 6), then nine in ten sources of every plane
      wholly off the image (past the plane by a margin, in a random
      direction).
    """
    rng = np.random.RandomState(seed)
    shape = (n, groups, 9, 2, h, w)
    off = (rng.rand(*shape) * 12 - 6).astype(np.float32)
    ty, tx = _taps(dilation)
    oy = np.arange(h).reshape(1, h, 1) + ty.reshape(9, 1, 1)
    ox = np.arange(w).reshape(1, 1, w) + tx.reshape(9, 1, 1)
    oy = np.broadcast_to(oy, (9, h, w)).astype(np.float32)
    ox = np.broadcast_to(ox, (9, h, w)).astype(np.float32)
    if kind == "corner":
        points = [(h // 2 + 0.25, w // 3 + 0.5),
                  (h // 2 - 8 + 0.75, w // 2 - 6 + 0.5)]
        for b in range(n):
            py, px = points[b % 2]
            pick = np.zeros(9 * h * w, bool)
            pick[:count] = True
            pick = pick.reshape(9, h, w)
            off[b, 0, :, 0][pick] = (py - oy)[pick]
            off[b, 0, :, 1][pick] = (px - ox)[pick]
    elif kind == "border":
        # the nearest row 16 m - 1 (m >= 1) below the plane's end
        def onto(base, size):
            lines = np.arange(15, size, 16, dtype=np.float32)
            if not lines.size:
                lines = np.array([size - 1], np.float32)
            near = lines[np.abs(base[..., None] - lines).argmin(-1)]
            frac = rng.randint(0, 4, size=base.shape) / 4.0
            return (near + frac - base).astype(np.float32)
        axis = rng.rand(9, h, w) < 0.5
        dy, dx = onto(oy, h), onto(ox, w)
        off[0, 0, :, 0] = np.where(axis, dy, off[0, 0, :, 0])
        off[0, 0, :, 1] = np.where(axis, off[0, 0, :, 1], dx)
        # a quarter on both: a corner key of four tiles
        both = rng.rand(9, h, w) < 0.25
        off[0, 0, :, 0] = np.where(both, dy, off[0, 0, :, 0])
        off[0, 0, :, 1] = np.where(both, dx, off[0, 0, :, 1])
    elif kind == "off":
        far = float(h + w + 10)
        away = rng.rand(*shape) < 0.9
        direction = np.sign(rng.rand(*shape) - 0.5)
        off = np.where(away, direction * (far + rng.rand(*shape)), off)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return off.reshape(n, 2 * groups * 9, h, w).astype(np.float32)


def corner_count(off, dilation, h, w):
    """The most sources of any one (image, group) plane that share a floor
    corner, for NCHW offsets of a 3x3 DCN with padding = dilation."""
    n, c2 = off.shape[:2]
    groups = c2 // 18
    o = off.reshape(n, groups, 9, 2, h, w).astype(np.float64)
    ty, tx = _taps(dilation)
    y0 = np.floor(np.arange(h).reshape(1, 1, 1, h, 1)
                  + ty.reshape(1, 1, 9, 1, 1) + o[:, :, :, 0])
    x0 = np.floor(np.arange(w).reshape(1, 1, 1, 1, w)
                  + tx.reshape(1, 1, 9, 1, 1) + o[:, :, :, 1])
    keyed = (y0 >= -1) & (y0 <= h - 1) & (x0 >= -1) & (x0 <= w - 1)
    best = 0
    for b in range(n):
        for g in range(groups):
            sel = keyed[b, g]
            keys = ((y0[b, g][sel] + 1) * (w + 1) + x0[b, g][sel] + 1)
            if keys.size:
                best = max(best, int(np.bincount(keys.astype(np.int64)).max()))
    return best
