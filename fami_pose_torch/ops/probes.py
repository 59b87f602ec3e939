"""On-chip gather and rotate probes: the Hopper counterparts of the four
Mosaic capability probes in ``tools/mosaic_watch.py``.

Each function here computes what its TPU probe computes, at any shape its
kernel takes (the probes' own shapes are in :data:`PROBE_SHAPES`):

  * :func:`gather_lane`: ``take_along_axis(x, idx, axis=1)`` on a 2-D tile
    (the TPU probe ``bf16_gather``), from shared memory, or with
    ``variant="shfl"`` from registers by warp shuffles;
  * :func:`gather_3d`: ``take_along_axis(x, idx, axis=2)`` on a batch of f32
    tiles (``gather_3d``);
  * :func:`gather_rows`: ``take_along_axis(x, idx, axis=0)``, a gather across
    rows (``cross_tile_gather``);
  * :func:`dynamic_roll`: ``roll(x, shift, axis=1)`` with the shift read from
    device memory at run time (``dynamic_roll``).

On a CUDA tensor a function launches its hand-written kernel
(``ops/cuda/csrc/probes.cu``), counts the launch in its ``launches``
attribute (``gather_lane.shfl_launches`` says how many of its launches were
the shuffle kernel's), and raises on anything the kernel does not take; it never gives
way to the plain version. On a CPU tensor it runs the plain version
(``torch.gather``, ``torch.roll``), which the tests and the comparisons on
the card use. The results are copies of input values, so kernel and plain
version agree bit for bit.
"""

import torch

# name -> (x shape, x dtype): the shapes and types of the TPU probes
PROBE_SHAPES = {
    "gather_lane": ((16, 128), torch.bfloat16),
    "gather_3d": ((4, 16, 128), torch.float32),
    "gather_rows": ((64, 128), torch.float32),
    "dynamic_roll": ((16, 128), torch.float32),
}
MAX_TILE_BYTES = 48 * 1024  # one block's static shared-memory limit


def gather_lane_plain(x, idx):
    return torch.gather(x, 1, idx.long())


def gather_3d_plain(x, idx):
    return torch.gather(x, 2, idx.long())


def gather_rows_plain(x, idx):
    return torch.gather(x, 0, idx.long())


def dynamic_roll_plain(x, shift):
    return torch.roll(x, int(shift.reshape(-1)[0]), dims=1)


def _check(name, x, other, ndim, dtypes, other_shape=None):
    """Shared argument checks of the CUDA branches; returns contiguous
    ``x`` and the int32 contiguous index (or shift) tensor."""
    if x.dim() != ndim:
        raise ValueError(f"{name}: x must have {ndim} dimensions, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: kernel takes {dtypes}, got {x.dtype}")
    want = tuple(x.shape) if other_shape is None else other_shape
    if tuple(other.shape) != want:
        raise ValueError(f"{name}: second argument of shape {want} expected, "
                         f"got {tuple(other.shape)}")
    if other.device != x.device:
        raise ValueError(f"{name}: both arguments must be on one device")
    if other.dtype != torch.int32:
        raise TypeError(f"{name}: int32 indices expected, got {other.dtype}")
    tile = x.shape[-2] * x.shape[-1] * x.element_size()
    if x.numel() == 0 or tile > MAX_TILE_BYTES:
        raise ValueError(f"{name}: a tile of {tile} bytes does not fit one "
                         f"block's {MAX_TILE_BYTES} bytes of shared memory")
    return x.contiguous(), other.contiguous()


def _launch(fn, entry, *args, device):
    from .cuda.build import check, load_library

    lib = load_library()
    with torch.cuda.device(device):  # launches go to the current one
        check(lib, getattr(lib, entry)(*args), entry)
    fn.launches += 1


def gather_lane(x, idx, variant="smem"):
    """``out[r, j] = x[r, idx[r, j]]`` for a 2-D float32 or bfloat16 tile and
    int32 indices in ``[0, x.shape[1])``. ``variant``: ``"smem"`` gathers
    from shared memory, ``"shfl"`` from registers by warp shuffles
    (bfloat16, 128 columns)."""
    if x.device.type == "cpu":
        return gather_lane_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    from .cuda.build import DTYPE_CODES, stream_ptr

    if variant not in ("smem", "shfl"):
        raise ValueError(f"unknown variant {variant!r}")
    if variant == "shfl" and (x.dtype != torch.bfloat16 or x.shape[-1] != 128):
        raise ValueError("the shuffle variant takes bfloat16 tiles of 128 "
                         "columns")
    x, idx = _check("gather_lane", x, idx, 2, (torch.float32, torch.bfloat16))
    out = torch.empty_like(x)
    _launch(gather_lane, "fami_probe_gather_lane", x.data_ptr(),
            idx.data_ptr(), out.data_ptr(),
            DTYPE_CODES[str(x.dtype).replace("torch.", "")], x.shape[0],
            x.shape[1], int(variant == "shfl"), stream_ptr(x),
            device=x.device)
    if variant == "shfl":  # the shuffle kernel's own share of the count
        gather_lane.shfl_launches += 1
    return out


def gather_3d(x, idx):
    """``out[b, r, j] = x[b, r, idx[b, r, j]]`` for a 3-D float32 array and
    int32 indices in ``[0, x.shape[2])``."""
    if x.device.type == "cpu":
        return gather_3d_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    from .cuda.build import stream_ptr

    x, idx = _check("gather_3d", x, idx, 3, (torch.float32,))
    out = torch.empty_like(x)
    _launch(gather_3d, "fami_probe_gather_3d", x.data_ptr(), idx.data_ptr(),
            out.data_ptr(), *x.shape, stream_ptr(x), device=x.device)
    return out


def gather_rows(x, idx):
    """``out[i, j] = x[idx[i, j], j]`` for a 2-D float32 tile and int32 row
    numbers in ``[0, x.shape[0])``."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    from .cuda.build import stream_ptr

    x, idx = _check("gather_rows", x, idx, 2, (torch.float32,))
    out = torch.empty_like(x)
    _launch(gather_rows, "fami_probe_gather_rows", x.data_ptr(),
            idx.data_ptr(), out.data_ptr(), *x.shape, stream_ptr(x),
            device=x.device)
    return out


def dynamic_roll(x, shift):
    """``out[:, j] = x[:, (j - s) mod x.shape[1]]`` for a 2-D float32 tile;
    ``shift`` is an int32 tensor of one element on ``x``'s device, which the
    kernel reads at run time (any integer, negative too)."""
    if x.device.type == "cpu":
        return dynamic_roll_plain(x, shift)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    from .cuda.build import stream_ptr

    x, shift = _check("dynamic_roll", x, shift, 2, (torch.float32,),
                      other_shape=(1,))
    out = torch.empty_like(x)
    _launch(dynamic_roll, "fami_probe_dynamic_roll", x.data_ptr(),
            shift.data_ptr(), out.data_ptr(), *x.shape, stream_ptr(x),
            device=x.device)
    return out


for _fn in (gather_lane, gather_3d, gather_rows, dynamic_roll):
    _fn.launches = 0
gather_lane.shfl_launches = 0

PLAIN = {gather_lane: gather_lane_plain, gather_3d: gather_3d_plain,
         gather_rows: gather_rows_plain, dynamic_roll: dynamic_roll_plain}


def probe_inputs(name, seed=0, device="cpu", shift=5):
    """Seeded inputs of probe ``name`` at its TPU probe's shape and type:
    ``(x, idx)``, or ``(x, shift)`` for the roll."""
    shape, dtype = PROBE_SHAPES[name]
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=gen).to(dtype).to(device)
    if name == "dynamic_roll":
        return x, torch.tensor([shift], dtype=torch.int32, device=device)
    high = shape[0] if name == "gather_rows" else shape[-1]
    idx = torch.randint(0, high, shape, generator=gen, dtype=torch.int32)
    return x, idx.to(device)
