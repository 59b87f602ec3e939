"""Modulated deformable convolution (DCNv2), NCHW.

Port of ``fami_pose_tpu/ops/deform_conv.py``, torchvision-compatible:
  * ``offset`` (N, 2*G*K, Ho, Wo): channel ``2*(g*K + k)`` is the vertical
    shift of group ``g``, tap ``k``, channel ``2*(g*K + k) + 1`` the
    horizontal one (the canonical ``[g][k][(dy, dx)]`` order);
  * ``mask`` (N, G*K, Ho, Wo) multiplies the sampled value raw (no sigmoid);
  * output pixel (i, j), tap (a, b) samples x at
    ``(i*stride - pad + a*dil + dy, j*stride - pad + b*dil + dx)``,
    bilinear, zeros outside the input.

``deform_conv2d_windowed`` is the model's DCN: the same function with each
offset clamped to ``[-max_offset, max_offset]`` per axis (``max_offset`` None
or <= 0: the exact, unclamped DCN). The JAX package computes the clamped
function with a gather-free hat-window scan because the TPU has no fast
gather; the scan is the same function as "clamp, then exact bilinear gather"
(``fami_pose_tpu/ops/deform_conv.py:225-245``), so the plain version here is
the latter. On a CUDA tensor the wrapper launches the hand-written kernel
``ops/cuda/csrc/dcn_fwd.cu`` (which replaces the TPU kernel
``fami_pose_tpu/ops/pallas/dcn.py::deform_conv2d_pallas``).

The backward is ``ops/cuda/csrc/dcn_bwd.cu`` on a CUDA tensor (it replaces
``fami_pose_tpu/ops/pallas/dcn_bwd.py::deform_conv2d_windowed_bwd_pallas``)
and :func:`deform_conv2d_backward_plain` on a CPU tensor; one
``torch.autograd.Function`` routes both devices. In windowed mode the
kernel forms dx as the TPU's ``_bwd_dx_kernel`` does, by a gather summed in
a fixed order (:func:`deform_conv2d_dx_gather_plain` is its plain version),
so that two runs give the same gradients bit for bit.

The derivative with respect
to an offset follows the TPU kernel, the one the configured train path runs:
per axis it is the slope of the bilinear blend between the two neighbouring
samples, **zero where the clamped offset is an integer** (the hat weight's
``-sign(u) * (|u| < 1)`` vanishes at u = 0 and |u| = 1) and zero where the
raw offset lies outside ``[-max_offset, max_offset]`` (bounds included in the
pass-through, as ``torch.clamp``). Autograd through :func:`deform_conv2d`
would give the right-hand difference at an integer instead, and
``jax.vjp`` of the XLA form the central one; with bfloat16 offsets integers
are common, so the backward is written out in closed form here.
"""

import math

import torch


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _work_dtype(x):
    """float32 arithmetic, or float64 for float64 inputs (finite-difference
    checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _bilinear_grouped(xg, py, px):
    """xg (N, G, Cg, H, W) float32; py/px (N, G, Ho, Wo) float32 sample
    coords -> (N, G, Cg, Ho, Wo), zeros outside the image.

    The integer and fractional parts of a coordinate are taken from the
    offset alone (``base + floor(t)``, ``t - floor(t)``), which is exact;
    ``floor(base + t)`` would round ``t`` to the coordinate's ulp first.
    """
    n, g, cg, h, w = xg.shape
    flat = xg.reshape(n, g, cg, h * w)

    def split(p):
        base, t = p
        t0 = torch.floor(t)
        return (base + t0).long(), (t - t0).unsqueeze(2)

    y0, fy = split(py)
    x0, fx = split(px)

    def corner(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).unsqueeze(2)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, g, 1, -1)
        vals = torch.gather(flat, 3, idx.expand(-1, -1, cg, -1))
        return vals.reshape(n, g, cg, *yi.shape[2:]) * valid

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def deform_conv2d(x, offset, mask, weight, bias=None, *, stride=1, padding=0,
                  dilation=1, offset_groups=None, max_offset=None):
    """Plain torch modulated deformable conv (NCHW), computed in float32
    (float64 for float64 inputs).

    Args:
      x: (N, C, H, W); offset: (N, 2*G*K, Ho, Wo); mask: (N, G*K, Ho, Wo) or
        None (DCNv1); weight: (C_out, C, kh, kw); bias: (C_out,) or None.
      offset_groups: G, inferred from the offset channels by default.
      max_offset: clamp every offset to [-max_offset, max_offset] first
        (None or <= 0: no clamp).

    Returns (N, C_out, Ho, Wo) in ``x``'s dtype: the f32 result is cast,
    then the bias is added, as the kernel's wrapper does.
    """
    n, c, h, w = x.shape
    c_out, wc, kh, kw = weight.shape
    if wc != c:
        raise ValueError(f"weight expects {wc} input channels, x has {c}")
    k = kh * kw
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    g = offset_groups or offset.shape[1] // (2 * k)
    if offset.shape[1] != 2 * g * k:
        raise ValueError(
            f"offset has {offset.shape[1]} channels, expected {2 * g * k}"
        )
    if c % g != 0:
        raise ValueError(f"channels {c} not divisible by offset groups {g}")
    cg = c // g
    ho, wo = offset.shape[2], offset.shape[3]

    f32 = _work_dtype(x)
    off = offset.to(f32).reshape(n, g, k, 2, ho, wo)
    if max_offset is not None and float(max_offset) > 0:
        off = off.clamp(-float(max_offset), float(max_offset))
    msk = None if mask is None else mask.to(f32).reshape(n, g, k, ho, wo)
    xg = x.to(f32).reshape(n, g, cg, h, w)
    ys = (torch.arange(ho, device=x.device) * sh - ph).view(1, 1, ho, 1)
    xs = (torch.arange(wo, device=x.device) * sw - pw).view(1, 1, 1, wo)

    cols = []
    for a in range(kh):
        for b in range(kw):
            t = a * kw + b
            py = (ys + a * dh, off[:, :, t, 0])
            px = (xs + b * dw, off[:, :, t, 1])
            v = _bilinear_grouped(xg, py, px)  # (N, G, Cg, Ho, Wo)
            if msk is not None:
                v = v * msk[:, :, t].unsqueeze(2)
            cols.append(v.reshape(n, c, ho * wo))
    col = torch.stack(cols, dim=1).reshape(n, k * c, ho * wo)  # [k][c] rows
    w_flat = weight.to(f32).permute(0, 2, 3, 1).reshape(c_out, k * c)
    out = torch.matmul(w_flat, col).reshape(n, c_out, ho, wo).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out


def _check_kernel_args(x, offset, mask, weight, padding, dilation, groups):
    """The forward kernel's checks: device, type, rank and shape of every
    argument and the groups (any C and C_out: ``dcn_fwd_smem`` is bounded
    whatever they are). Returns (Ho, Wo)."""
    tensors = {"x": x, "offset": offset, "weight": weight}
    if mask is not None:
        tensors["mask"] = mask
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    n, c, h, w = x.shape
    c_out, wc, kh, kw = weight.shape
    k = kh * kw
    ho = h + 2 * padding - dilation * (kh - 1)
    wo = w + 2 * padding - dilation * (kw - 1)
    if wc != c or c % groups != 0:
        raise ValueError(f"bad channels: x {c}, weight {wc}, groups {groups}")
    if tuple(offset.shape) != (n, 2 * groups * k, ho, wo):
        raise ValueError(
            f"offset {tuple(offset.shape)}, expected "
            f"{(n, 2 * groups * k, ho, wo)}"
        )
    if mask is not None and tuple(mask.shape) != (n, groups * k, ho, wo):
        raise ValueError(
            f"mask {tuple(mask.shape)}, expected {(n, groups * k, ho, wo)}"
        )
    return ho, wo


SMEM_PER_BLOCK = 232448  # an H100 block's dynamic shared memory, opted in
RESIDENT_ROWS = 576  # dcn_fwd.cu's kResidentRows
CHUNK_ROWS = 128  # dcn_fwd.cu's kChunkRows


def _a128(n):
    return -(-n // 128) * 128


def dcn_fwd_smem(dtype, c, c_out, k, groups):
    """Shared memory of one block of the forward kernel (``dcn_fwd.cu``), in
    bytes. bfloat16 with C_out of 16, 32, 48 or 64 and the reduction
    ``k * c`` (padded to a multiple of 16) at most 576 rows, the resident
    form: W and the sampled column as wgmma operands, the f32 result tile
    and a table of the gather's units (group, tap, 4-channel chunk), 16
    bytes each. Every other width, the chunked form,
    whose size does not depend on C or C_out: bfloat16 two column and two
    W buffers of 128 reduction rows (64 pixels, 64 output channels) and the
    result tile; float32 W's chunk (C_out rounded up to 16, at most 64
    columns) and the column chunk in f32."""
    r = k * c
    rp = -(-r // 16) * 16
    if dtype != torch.bfloat16:
        return CHUNK_ROWS * (min(-(-c_out // 16) * 16, 64) + 64) * 4
    if c_out not in (16, 32, 48, 64) or rp > RESIDENT_ROWS:
        return 4 * CHUNK_ROWS * 64 * 2 + 64 * 68 * 4
    cg = c // groups
    units = groups * k * (cg // 4 if cg % 4 == 0 else cg)
    return (_a128(rp * c_out * 2) + _a128(rp * 64 * 2)
            + _a128(c_out * 68 * 4) + _a128(units * 16))


def _deform_conv_cuda(x, offset, mask, weight, padding, dilation, groups,
                      max_offset):
    from .cuda.build import DTYPE_CODES, check, load_library, stream_ptr

    dtype = str(x.dtype).replace("torch.", "")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"DCN kernel takes float32 or bfloat16, got {dtype}")
    ho, wo = _check_kernel_args(
        x, offset, mask, weight, padding, dilation, groups
    )
    x, offset, weight = x.contiguous(), offset.contiguous(), weight.contiguous()
    mask = None if mask is None else mask.contiguous()
    n, c, h, w = x.shape
    c_out, _, kh, kw = weight.shape
    out = torch.empty((n, c_out, ho, wo), dtype=x.dtype, device=x.device)
    # the kernel's copy of x in (N, G, H, W, C/G) order, which it gathers
    # from, and its workspace (W packed in chunks and the unit table, for
    # the widths the resident form does not take)
    x_grouped = torch.empty_like(x)
    lib = load_library()
    size = lib.fami_dcn_fwd_workspace(DTYPE_CODES[dtype], c, c_out, kh, kw)
    work = torch.empty(size, dtype=torch.uint8, device=x.device) \
        if size else None
    with torch.cuda.device(x.device):  # launches go to the current one
        err = lib.fami_dcn_fwd(
            x.data_ptr(), x_grouped.data_ptr(), offset.data_ptr(),
            None if mask is None else mask.data_ptr(), weight.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(),
            DTYPE_CODES[dtype], n, c, h, w, c_out, ho, wo, kh,
            kw, padding, dilation, groups,
            float(max_offset) if max_offset is not None else 0.0,
            stream_ptr(x),
        )
        check(lib, err, "fami_dcn_fwd")
    deform_conv2d_windowed.launches += 1
    return out


def deform_conv2d_backward_plain(x, offset, mask, weight, gout, *, padding=0,
                                 dilation=1, offset_groups=None,
                                 max_offset=None):
    """Plain torch gradients of the stride-1 :func:`deform_conv2d` (without
    its bias), computed in float32 in closed form.

    Args as :func:`deform_conv2d`, plus ``gout`` (N, C_out, Ho, Wo), the
    gradient of the output. Returns ``(dx, doffset, dmask, dweight)``: dx in
    ``x``'s dtype, doffset and dmask in ``offset``'s (dmask None without a
    mask), dweight in ``weight``'s. The offset derivative is zero on an axis
    whose clamped offset is an integer or whose raw offset lies outside
    ``[-max_offset, max_offset]`` (module docstring).
    """
    n, c, h, w = x.shape
    c_out, _, kh, kw = weight.shape
    k = kh * kw
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    g = offset_groups or offset.shape[1] // (2 * k)
    cg = c // g
    ho, wo = offset.shape[2], offset.shape[3]
    f32 = _work_dtype(x)
    dev = x.device

    raw = offset.to(f32).reshape(n, g, k, 2, ho, wo)
    clamped = max_offset is not None and float(max_offset) > 0
    if clamped:
        d = float(max_offset)
        off = raw.clamp(-d, d)
        passes = (raw >= -d) & (raw <= d)
    else:
        off = raw
        passes = torch.ones_like(raw, dtype=torch.bool)
    msk = None if mask is None else mask.to(f32).reshape(n, g, k, ho, wo)
    flat = x.to(f32).reshape(n, g, cg, h * w)
    go = gout.to(f32).reshape(n, c_out, ho * wo)
    w_k = weight.to(f32).reshape(c_out, c, k)
    ys = (torch.arange(ho, device=dev) - ph).view(1, 1, ho, 1)
    xs = (torch.arange(wo, device=dev) - pw).view(1, 1, 1, wo)

    dx = torch.zeros(n, g, cg, h * w, dtype=f32, device=dev)
    doff = torch.zeros_like(raw)
    dmsk = None if msk is None else torch.zeros_like(msk)
    dweight = torch.zeros(c_out, c, k, dtype=f32, device=dev)
    for a in range(kh):
        for b in range(kw):
            t = a * kw + b
            # gradient of the sampled column of this tap: gout . W_t^T
            dcol = torch.einsum("oc,nop->ncp", w_k[:, :, t], go)
            dcol = dcol.reshape(n, g, cg, ho, wo)
            ty, tx = off[:, :, t, 0], off[:, :, t, 1]
            ty0, tx0 = torch.floor(ty), torch.floor(tx)
            ly, lx = ty - ty0, tx - tx0
            y0 = (ys + a * dh + ty0).long()
            x0 = (xs + b * dw + tx0).long()
            m = 1.0 if msk is None else msk[:, :, t]

            vals, idxs, valids = [], [], []
            for yi, xi in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                           (y0 + 1, x0 + 1)):
                valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
                idx = idx.reshape(n, g, 1, -1).expand(-1, -1, cg, -1)
                v = torch.gather(flat, 3, idx).reshape(n, g, cg, ho, wo)
                vals.append(v * valid.unsqueeze(2))
                idxs.append(idx)
                valids.append(valid)
            v00, v01, v10, v11 = vals
            wts = ((1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx)
            s = sum(wt.unsqueeze(2) * v for wt, v in zip(wts, vals))

            col = (s * m.unsqueeze(2) if msk is not None else s)
            dweight[:, :, t] = torch.einsum(
                "nop,ncp->oc", go, col.reshape(n, c, ho * wo))
            if dmsk is not None:
                dmsk[:, :, t] = (s * dcol).sum(dim=2)
            slope_y = ((v10 - v00) * (1 - lx).unsqueeze(2)
                       + (v11 - v01) * lx.unsqueeze(2))
            slope_x = ((v01 - v00) * (1 - ly).unsqueeze(2)
                       + (v11 - v10) * ly.unsqueeze(2))
            doff[:, :, t, 0] = ((slope_y * dcol).sum(dim=2) * m
                                * (passes[:, :, t, 0] & (ly != 0)))
            doff[:, :, t, 1] = ((slope_x * dcol).sum(dim=2) * m
                                * (passes[:, :, t, 1] & (lx != 0)))
            for wt, idx, valid in zip(wts, idxs, valids):
                contrib = (wt * m * valid).unsqueeze(2) * dcol
                dx.scatter_add_(3, idx, contrib.reshape(n, g, cg, -1))
    return (
        dx.reshape(n, c, h, w).to(x.dtype),
        doff.reshape(offset.shape).to(offset.dtype),
        None if dmsk is None else dmsk.reshape(mask.shape).to(offset.dtype),
        dweight.reshape(weight.shape).to(weight.dtype),
    )


def deform_conv2d_dx_gather_plain(x, offset, mask, weight, gout, *,
                                  padding=0, dilation=1, offset_groups=None,
                                  max_offset=4):
    """dx of the stride-1 windowed :func:`deform_conv2d` in the gather form
    of the card's kernel (``dcn_bwd.cu::dx_gather_kernel``) and of the TPU's
    ``_bwd_dx_kernel``: each input pixel q sums, over the taps k and then
    the window's displacements d in ``[-R, R]^2`` row by row (R =
    ``ceil(max_offset)``), ``w_y * w_x * m * dcol`` of the source output
    pixel ``p = q - s_k - d`` (``s_k = k_pos * dilation - padding``) where
    ``q - (p + s_k) - floor(t)`` is a bilinear corner, in ``{0, 1}^2``.
    The window is exact: ``floor(t)`` lies in ``[-R, R]`` and the corner at
    ``d = R + 1`` needs ``t = max_offset``, where its weight is 0. The same
    products as :func:`deform_conv2d_backward_plain`'s scatter, summed in
    this fixed order in float32 (float64 for float64 inputs), rounded once
    into ``x``'s dtype. Windowed mode only (``max_offset`` > 0); slow (a
    pass a tap and displacement): a reference for the kernel, not a path of
    the model."""
    d = float(max_offset) if max_offset is not None else 0.0
    if not d > 0:
        raise ValueError("the dx gather needs a window: max_offset > 0")
    n, c, h, w = x.shape
    c_out, _, kh, kw = weight.shape
    k = kh * kw
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    g = offset_groups or offset.shape[1] // (2 * k)
    cg = c // g
    ho, wo = offset.shape[2], offset.shape[3]
    r = math.ceil(d)
    f32 = _work_dtype(x)
    dev = x.device

    off = offset.to(f32).reshape(n, g, k, 2, ho, wo).clamp(-d, d)
    fl = torch.floor(off)
    frac = off - fl
    fl = fl.long()
    msk = None if mask is None else mask.to(f32).reshape(n, g, k, ho, wo)
    go = gout.to(f32).reshape(n, c_out, ho * wo)
    w_k = weight.to(f32).reshape(c_out, c, k)
    qy = torch.arange(h, device=dev)
    qx = torch.arange(w, device=dev)
    acc = torch.zeros(n, g, cg, h, w, dtype=f32, device=dev)
    for t in range(k):
        sy = (t // kw) * dh - ph
        sx = (t % kw) * dw - pw
        md = torch.einsum("oc,nop->ncp", w_k[:, :, t], go)
        md = md.reshape(n, g, cg, ho, wo)
        if msk is not None:
            md = msk[:, :, t].unsqueeze(2) * md
        for dy in range(-r, r + 1):
            py = qy - sy - dy
            vy = ((py >= 0) & (py < ho)).view(h, 1)
            py = py.clamp(0, ho - 1)
            fy_r, ly_r = fl[:, :, t, 0][:, :, py], frac[:, :, t, 0][:, :, py]
            fx_r, lx_r = fl[:, :, t, 1][:, :, py], frac[:, :, t, 1][:, :, py]
            md_r = md[:, :, :, py]
            for dx_ in range(-r, r + 1):
                px = qx - sx - dx_
                vx = ((px >= 0) & (px < wo)).view(1, w)
                px = px.clamp(0, wo - 1)
                cy = dy - fy_r[..., px]
                cx = dx_ - fx_r[..., px]
                ly, lx = ly_r[..., px], lx_r[..., px]
                hit = vy & vx & (cy >= 0) & (cy <= 1) & (cx >= 0) & (cx <= 1)
                wt = (torch.where(cy == 1, ly, 1 - ly)
                      * torch.where(cx == 1, lx, 1 - lx))
                wt = torch.where(hit, wt, torch.zeros_like(wt))
                acc = acc + wt.unsqueeze(2) * md_r[..., px]
    return acc.reshape(n, c, h, w).to(x.dtype)


def dcn_bwd_smem(dtype, c, c_out, groups):
    """Shared memory of one block of the backward kernel (``dcn_bwd.cu``), in
    bytes. A block owns 3 taps, a chunk of the channels (the whole groups
    that fit in 64, or 64 channels of one wider group) and a chunk of 64
    output channels: with ``cp`` = the chunk's width rounded up to 16, ``nw
    = 3 * cp`` columns and ``ocp`` = C_out rounded up to 16, at most 64,
    bfloat16 holds W's slice (ocp x nw) and gout transposed (64 x ocp) as
    the dcol wgmma's operands, gout (64 x 64, rows past C_out zero) and the
    sampled column (64 x nw) as dW's, dcol in f32 (64 rows of nw + 4);
    float32 holds W's slice (64 x nw), gout (64 rows of 68) and the column
    (nw rows of 68) in f32, and the same dcol. Both: a table of 3 gather units a
    group of the chunk, 16 bytes each. Each region is rounded up to 128
    bytes; the total does not grow past C = C_out = 64's."""
    cg = c // groups
    if cg <= 64:
        gpc = min(64 // cg, groups)
        cc = gpc * cg
    else:
        gpc, cc = 1, 64
    cp = -(-cc // 16) * 16
    nw = 3 * cp
    ocp = min(-(-c_out // 16) * 16, 64)
    dcol_tab = _a128(64 * (nw + 4) * 4) + _a128(3 * gpc * 16)
    if dtype != torch.bfloat16:
        return (_a128(64 * nw * 4) + _a128(64 * 68 * 4)
                + _a128(nw * 68 * 4) + dcol_tab)
    return (_a128(ocp * nw * 2) + _a128(64 * ocp * 2) + _a128(64 * 64 * 2)
            + _a128(64 * nw * 2) + dcol_tab)


# the widest window the backward kernel's dx gather takes, ceil(max_offset)
# (``dcn_bwd.cu``'s ``kMaxGatherR``: a window row of 2R + 1 candidates is one
# 64-bit mask word)
MAX_GATHER_OFFSET = 31


def _check_backward_args(x, offset, mask, weight, gout, padding, dilation,
                         groups, max_offset=None):
    """The backward kernel's checks, as ``_check_kernel_args`` for the
    forward: the same shape and type checks, ``gout`` of the output's
    shape on x's device, and a window (``max_offset`` > 0) of at most
    ``MAX_GATHER_OFFSET`` px. Returns (Ho, Wo)."""
    ho, wo = _check_kernel_args(x, offset, mask, weight, padding, dilation,
                                groups)
    n = x.shape[0]
    c_out = weight.shape[0]
    if tuple(gout.shape) != (n, c_out, ho, wo) or gout.device != x.device:
        raise ValueError(f"gout {tuple(gout.shape)} on {gout.device}, expected "
                         f"{(n, c_out, ho, wo)} on {x.device}")
    d = float(max_offset) if max_offset is not None else 0.0
    if d > 0 and not math.ceil(d) <= MAX_GATHER_OFFSET:
        raise ValueError(
            f"max_offset {d}: the DCN backward kernel gathers dx over windows "
            f"of at most {MAX_GATHER_OFFSET} px; use the exact mode "
            f"(max_offset None) for wider offsets")
    return ho, wo


def _deform_conv_backward_cuda(x, offset, mask, weight, gout, padding,
                               dilation, groups, max_offset):
    from .cuda.build import DTYPE_CODES, check, load_library, stream_ptr

    dtype = str(x.dtype).replace("torch.", "")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"DCN kernel takes float32 or bfloat16, got {dtype}")
    ho, wo = _check_backward_args(
        x, offset, mask, weight, gout, padding, dilation, groups, max_offset
    )
    n, c, h, w = x.shape
    c_out, _, kh, kw = weight.shape
    x, offset, weight = x.contiguous(), offset.contiguous(), weight.contiguous()
    mask = None if mask is None else mask.contiguous()
    gout = gout.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    dweight = torch.empty_like(weight)
    doffset = torch.empty_like(offset)
    dmask = None if mask is None else torch.empty_like(mask)
    # scratch: x in (N, G, H, W, C/G) order, in the exact mode the f32 dx
    # accumulator of that order (its scatter), and the f32 workspace: the
    # blocks' dW partials, where an offset group has more than 64 channels
    # the doffset and dmask partials of its 64-channel slices, and in
    # windowed mode m * dcol for the dx gather (N * 9C * Ho * Wo floats)
    d = float(max_offset) if max_offset is not None else 0.0
    x_grouped = torch.empty_like(x)
    dx_acc = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
              if not d > 0 else None)
    lib = load_library()
    with torch.cuda.device(x.device):  # launches go to the current one
        size = lib.fami_dcn_bwd_workspace(n, c, c_out, ho, wo, kh, kw, groups,
                                          d)
        work = torch.empty(size, dtype=torch.float32, device=x.device)
        err = lib.fami_dcn_bwd(
            x.data_ptr(), x_grouped.data_ptr(), offset.data_ptr(),
            None if mask is None else mask.data_ptr(), weight.data_ptr(),
            gout.data_ptr(), dx.data_ptr(), doffset.data_ptr(),
            None if dmask is None else dmask.data_ptr(), dweight.data_ptr(),
            None if dx_acc is None else dx_acc.data_ptr(), work.data_ptr(), DTYPE_CODES[dtype], n, c, h,
            w, c_out, ho, wo, kh, kw, padding, dilation, groups, d,
            stream_ptr(x),
        )
        check(lib, err, "fami_dcn_bwd")
    deform_conv2d_backward.launches += 1
    return dx, doffset, dmask, dweight


def deform_conv2d_backward(x, offset, mask, weight, gout, *, padding=0,
                           dilation=1, offset_groups=None, max_offset=None):
    """Gradients ``(dx, doffset, dmask, dweight)`` of the model's DCN: the
    plain version for CPU tensors, the CUDA kernel (counted in
    ``deform_conv2d_backward.launches``) for CUDA tensors, or an error.
    On the card, in windowed mode, every output is summed in a fixed
    order, so two calls on the same inputs agree bit for bit: dweight from
    per-block partials, dx by the gather of
    :func:`deform_conv2d_dx_gather_plain`, for windows up to
    ``MAX_GATHER_OFFSET`` px (a wider one raises ``ValueError``). The exact
    mode (``max_offset`` None or <= 0) keeps a scatter of dx with float
    atomics, whose last bits vary from run to run: the exact adjoint has no
    bounded window to gather from."""
    k = weight.shape[2] * weight.shape[3]
    groups = int(offset_groups or offset.shape[1] // (2 * k))
    if x.device.type == "cpu":
        return deform_conv2d_backward_plain(
            x, offset, mask, weight, gout, padding=padding, dilation=dilation,
            offset_groups=groups, max_offset=max_offset,
        )
    if x.device.type != "cuda":
        raise ValueError(f"no DCN kernel for device {x.device}")
    return _deform_conv_backward_cuda(
        x, offset, mask, weight, gout, int(padding), int(dilation), groups,
        max_offset,
    )


deform_conv2d_backward.launches = 0


class _DeformConvWindowed(torch.autograd.Function):
    """The bias-free DCN on either device: kernel or plain version, forward
    and backward, chosen by ``x.device``."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, padding, dilation, groups,
                max_offset):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.conf = (padding, dilation, groups, max_offset)
        if x.device.type == "cpu":
            return deform_conv2d(
                x, offset, mask, weight, None, stride=1, padding=padding,
                dilation=dilation, offset_groups=groups,
                max_offset=max_offset,
            )
        return _deform_conv_cuda(
            x, offset, mask, weight, padding, dilation, groups, max_offset
        )

    @staticmethod
    def backward(ctx, gout):
        x, offset, mask, weight = ctx.saved_tensors
        padding, dilation, groups, max_offset = ctx.conf
        grads = deform_conv2d_backward(
            x, offset, mask, weight, gout, padding=padding, dilation=dilation,
            offset_groups=groups, max_offset=max_offset,
        )
        need = ctx.needs_input_grad
        return tuple(gr if need[i] else None
                     for i, gr in enumerate(grads)) + (None,) * 4


def deform_conv2d_windowed(x, offset, mask, weight, bias=None, *, padding=0,
                           dilation=1, offset_groups=None, max_offset=6):
    """The model's DCN: stride 1, offsets clamped to ±``max_offset`` (None or
    <= 0: exact), differentiable in x, offset, mask, weight and bias. A CPU
    tensor runs the plain versions; a CUDA tensor launches the kernels
    (``deform_conv2d_windowed.launches`` counts the forward's,
    ``deform_conv2d_backward.launches`` the backward's) or raises. The bias
    is added after the kernel, in ``x``'s dtype."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no DCN kernel for device {x.device}")
    k = weight.shape[2] * weight.shape[3]
    groups = offset_groups or offset.shape[1] // (2 * k)
    d = float(max_offset) if max_offset is not None else 0.0
    out = _DeformConvWindowed.apply(
        x, offset, mask, weight, int(padding), int(dilation), int(groups),
        d if d > 0 else 0.0,
    )
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out


deform_conv2d_windowed.launches = 0
