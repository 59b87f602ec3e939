"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels from
``fami_pose_torch/ops/cuda/csrc``); elsewhere they skip. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances: f32 1e-4 of the output's scale (the kernel sums the 9*C products
in another order than the plain matmul, and the backward's dx and dweight
are summed with atomics); bf16 one bf16 ulp of the largest output (both
sides round one f32 sum to bf16).

The last group runs every kernel on buffers placed between unmapped pages,
so that a read or write outside an argument faults: a check that needs no
``compute-sanitizer``.
"""

import ctypes
import os
import subprocess
import sys

import pytest
import torch

from fami_pose_torch.ops.deform_conv import deform_conv2d, deform_conv2d_windowed
from fami_pose_torch.ops.warp import warp_translate, warp_translate_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(got, ref, dtype):
    scale = max(1.0, float(ref.float().abs().max()))
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4) * scale
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_offset", [2, 0])
@pytest.mark.parametrize("with_mask", [True, False])
def test_dcn_kernel_matches_plain(gen, dtype, max_offset, with_mask):
    n, c, h, w, g, c_out = 2, 16, 13, 11, 4, 32
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    off = ((torch.rand(n, 2 * g * 9, h, w, generator=gen, device="cuda") * 2
            - 1) * 5).to(dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    msk = msk if with_mask else None
    wgt = (torch.randn(c_out, c, 3, 3, generator=gen, device="cuda")
           * 0.1).to(dtype)
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=max_offset)
    before = deform_conv2d_windowed.launches
    got = deform_conv2d_windowed(x, off, msk, wgt, **kw)
    torch.cuda.synchronize()
    assert deform_conv2d_windowed.launches == before + 1
    assert got.dtype == dtype
    _assert_close(got, deform_conv2d(x, off, msk, wgt, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_shift", [26, 32])
def test_warp_kernel_matches_plain(gen, dtype, max_shift):
    img = torch.randn(6, 5, 17, 23, generator=gen, device="cuda").to(dtype)
    offs = (torch.rand(6, 2, generator=gen, device="cuda") * 2 - 1) * 40
    before = warp_translate.launches
    got = warp_translate(img, offs, max_shift=max_shift)
    torch.cuda.synchronize()
    assert warp_translate.launches == before + 1
    _assert_close(got, warp_translate_plain(img, offs, max_shift), dtype)


def _offsets(gen, shape, d, dtype):
    """A third of the offsets past D, a quarter rounded to integers (the
    backward's zero-derivative points), some exactly at +-D."""
    spread = 1.5 * d if d > 0 else 5.0
    off = (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * spread
    pick = torch.rand(shape, generator=gen, device="cuda")
    off = torch.where(pick < 0.25, off.round(), off)
    if d > 0:
        off = torch.where(pick > 0.95, torch.full_like(off, float(d)), off)
    return off.to(dtype)


def _assert_grad_close(name, got, ref, dtype):
    """f32: 1e-4 of the gradient's scale (other sum order, atomics); bf16
    outputs: one bf16 ulp (2^-7) of the scale, both sides rounding an f32
    sum once."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    scale = max(1.0, float(ref.float().abs().max()))
    tol = (2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-4) * scale
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_offset", [2, 1, 0])
@pytest.mark.parametrize("with_mask", [True, False])
def test_dcn_backward_kernel_matches_plain(gen, dtype, max_offset, with_mask):
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d_backward, deform_conv2d_backward_plain,
    )

    n, c, h, w, g, c_out = 2, 16, 13, 11, 4, 32
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    off = _offsets(gen, (n, 2 * g * 9, h, w), max_offset, dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    msk = msk if with_mask else None
    wgt = (torch.randn(c_out, c, 3, 3, generator=gen, device="cuda")
           * 0.1).to(dtype)
    gout = torch.randn(n, c_out, h, w, generator=gen, device="cuda").to(dtype)
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=max_offset)
    before = deform_conv2d_backward.launches
    got = deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
    torch.cuda.synchronize()
    assert deform_conv2d_backward.launches == before + 1
    ref = deform_conv2d_backward_plain(x, off, msk, wgt, gout, **kw)
    for name, a, b in zip(("dx", "doffset", "dmask", "dweight"), got, ref):
        if b is None:
            assert a is None, name
        else:
            _assert_grad_close(name, a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_autograd_on_the_card(gen, dtype):
    """The autograd Function launches both kernels for CUDA tensors and
    returns the bias gradient as a plain sum."""
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d_backward, deform_conv2d_backward_plain,
    )

    n, c, h, w, g = 1, 16, 9, 8, 4
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    off = _offsets(gen, (n, 2 * g * 9, h, w), 2, dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    wgt = (torch.randn(16, c, 3, 3, generator=gen, device="cuda") * 0.1).to(dtype)
    bias = torch.zeros(16, device="cuda", dtype=dtype)
    leaves = [t.requires_grad_() for t in (x, off, msk, wgt, bias)]
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=2)
    fwd, bwd = deform_conv2d_windowed.launches, deform_conv2d_backward.launches
    out = deform_conv2d_windowed(*leaves, **kw)
    gout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    grads = torch.autograd.grad(out, leaves, gout)
    torch.cuda.synchronize()
    assert deform_conv2d_windowed.launches == fwd + 1
    assert deform_conv2d_backward.launches == bwd + 1
    ref = deform_conv2d_backward_plain(x, off, msk, wgt, gout, **kw)
    for name, a, b in zip(("dx", "doffset", "dmask", "dweight"), grads, ref):
        _assert_grad_close(name, a, b, dtype)
    _assert_grad_close("dbias", grads[4], gout.float().sum((0, 2, 3)).to(dtype),
                       dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_shift", [26, 32])
def test_warp_backward_kernel_matches_plain(gen, dtype, max_shift):
    from fami_pose_torch.ops.warp import (
        warp_translate_backward, warp_translate_backward_plain,
    )

    img = torch.randn(6, 5, 17, 23, generator=gen, device="cuda").to(dtype)
    offs = (torch.rand(6, 2, generator=gen, device="cuda") * 2 - 1) * 40
    offs[0] = torch.tensor([3.0, -2.0])  # integers: right-hand derivative
    gout = torch.randn(6, 5, 17, 23, generator=gen, device="cuda").to(dtype)
    before = warp_translate_backward.launches
    got = warp_translate_backward(img, offs, gout, max_shift)
    torch.cuda.synchronize()
    assert warp_translate_backward.launches == before + 1
    ref = warp_translate_backward_plain(img, offs, gout, max_shift)
    _assert_grad_close("d_images", got[0], ref[0], dtype)
    # d_offsets is an f32 sum of 5*17*23 products of bf16-rounded factors
    assert got[1].dtype == offs.dtype
    scale = max(1.0, float(ref[1].abs().max()))
    assert float((got[1] - ref[1]).abs().max()) <= 1e-4 * scale


def test_warp_autograd_on_the_card(gen):
    from fami_pose_torch.ops.warp import warp_translate_backward

    img = torch.randn(3, 4, 12, 10, generator=gen, device="cuda",
                      requires_grad=True)
    offs = ((torch.rand(3, 2, generator=gen, device="cuda") * 2 - 1)
            * 5).requires_grad_()
    fwd, bwd = warp_translate.launches, warp_translate_backward.launches
    out = warp_translate(img, offs, max_shift=26)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert warp_translate.launches == fwd + 1
    assert warp_translate_backward.launches == bwd + 1
    ref_img = img.detach().cpu().requires_grad_()
    ref_offs = offs.detach().cpu().requires_grad_()
    warp_translate(ref_img, ref_offs, max_shift=26).square().sum().backward()
    assert float((img.grad.cpu() - ref_img.grad).abs().max()) <= 1e-4
    assert float((offs.grad.cpu() - ref_offs.grad).abs().max()) <= 1e-3


# -- the on-chip gather and rotate probes (bitwise: copies of input values) --

def _probe_on_card(name, **kw):
    from fami_pose_torch.ops import probes

    return probes, probes.probe_inputs(name, device="cuda", **kw)


@pytest.mark.parametrize("variant", ["smem", "shfl"])
def test_probe_gather_lane_matches_plain(gen, variant):
    probes, (x, idx) = _probe_on_card("gather_lane", seed=1)
    before = probes.gather_lane.launches
    got = probes.gather_lane(x, idx, variant=variant)
    torch.cuda.synchronize()
    assert probes.gather_lane.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, probes.gather_lane_plain(x, idx))


def test_probe_gather_lane_f32_and_other_shapes(gen):
    from fami_pose_torch.ops import probes

    x = torch.rand(5, 96, generator=gen, device="cuda")
    idx = torch.randint(0, 96, (5, 96), generator=gen, device="cuda",
                        dtype=torch.int32)
    assert torch.equal(probes.gather_lane(x, idx),
                       probes.gather_lane_plain(x, idx))
    with pytest.raises(ValueError, match="shuffle"):
        probes.gather_lane(x, idx, variant="shfl")


def test_probe_gather_3d_matches_plain(gen):
    probes, (x, idx) = _probe_on_card("gather_3d", seed=2)
    before = probes.gather_3d.launches
    got = probes.gather_3d(x, idx)
    torch.cuda.synchronize()
    assert probes.gather_3d.launches == before + 1
    assert torch.equal(got, probes.gather_3d_plain(x, idx))


def test_probe_gather_rows_matches_plain(gen):
    probes, (x, idx) = _probe_on_card("gather_rows", seed=3)
    before = probes.gather_rows.launches
    got = probes.gather_rows(x, idx)
    torch.cuda.synchronize()
    assert probes.gather_rows.launches == before + 1
    assert torch.equal(got, probes.gather_rows_plain(x, idx))


@pytest.mark.parametrize("shift", [0, 5, 127, 128, -3, -1000, 2 ** 31 - 1])
def test_probe_dynamic_roll_matches_plain(gen, shift):
    probes, (x, s) = _probe_on_card("dynamic_roll", seed=4, shift=shift)
    before = probes.dynamic_roll.launches
    got = probes.dynamic_roll(x, s)
    # the shift lives in device memory: changing it there changes the result
    # of the same call, with no new host argument
    s.fill_(shift + 1 if shift < 2 ** 31 - 1 else 0)
    again = probes.dynamic_roll(x, s)
    torch.cuda.synchronize()
    assert probes.dynamic_roll.launches == before + 2
    assert torch.equal(got, torch.roll(x, shift % 128, dims=1))
    assert torch.equal(again, probes.dynamic_roll_plain(x, s))


def test_probes_refuse_what_the_kernels_do_not_take(gen):
    from fami_pose_torch.ops import probes

    x = torch.rand(64, 128, device="cuda")
    idx = torch.zeros(64, 128, device="cuda", dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        probes.gather_rows(x, idx)
    with pytest.raises(ValueError, match="shared memory"):
        probes.gather_rows(torch.rand(128, 128, device="cuda"),
                           torch.zeros(128, 128, device="cuda",
                                       dtype=torch.int32))
    with pytest.raises(TypeError, match="kernel takes"):
        probes.gather_3d(torch.rand(2, 4, 128, device="cuda").bfloat16(),
                         torch.zeros(2, 4, 128, device="cuda",
                                     dtype=torch.int32))
    with pytest.raises(ValueError, match="one device"):
        probes.dynamic_roll(x[:16], torch.tensor([5], dtype=torch.int32))


def test_hopper_watch_reports_supported(gen, capsys):
    from fami_pose_torch.tools import hopper_watch

    assert hopper_watch.main([]) == 0
    out = capsys.readouterr().out
    assert out.count("SUPPORTED") == 5 and "unsupported" not in out


# -- guard pages: no kernel reads or writes outside its arguments ------------
#
# Every argument of a launch lives in a mapping of its own made with the
# cuMem* virtual-memory calls of libcuda, inside a reserved address range
# whose pages before and after the mapping stay unmapped. With the buffer
# flush against the mapping's end an overrun faults, flush against its start
# an underrun does; inside the caching allocator's large blocks either would
# pass unnoticed. A fault ends the process's CUDA context, so a failure here
# fails every later test of the run too.

class _Loc(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte),
                ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]


class _AllocProp(ctypes.Structure):  # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _Loc), ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", _AllocFlags)]


class _AccessDesc(ctypes.Structure):  # CUmemAccessDesc
    _fields_ = [("location", _Loc), ("flags", ctypes.c_int)]


class GuardedBuffers:
    """Device buffers between unmapped pages; ``where`` is ``"end"`` or
    ``"start"``. ``put`` copies a tensor in and returns the address, ``get``
    copies a buffer back into a tensor like the given one."""

    def __init__(self, where):
        torch.zeros(1, device="cuda")  # the context the cuMem* calls use
        self.cu = ctypes.CDLL("libcuda.so.1")
        self.where = where
        # pinned device memory on device 0
        self.prop = _AllocProp(type=1, location=_Loc(1, 0))
        gran = ctypes.c_size_t()
        self._ck(self.cu.cuMemGetAllocationGranularity(
            ctypes.byref(gran), ctypes.byref(self.prop), 0))
        self.gran = gran.value
        self.held = []

    @staticmethod
    def _ck(rc):
        if rc != 0:
            raise RuntimeError(f"libcuda call failed: CUresult {rc}")

    def sync(self):
        self._ck(self.cu.cuCtxSynchronize())

    def put(self, t):
        cu, u64, sz = self.cu, ctypes.c_uint64, ctypes.c_size_t
        nb = t.numel() * t.element_size()
        mapped = -(-nb // self.gran) * self.gran
        va, handle = u64(), u64()
        self._ck(cu.cuMemAddressReserve(
            ctypes.byref(va), sz(mapped + 2 * self.gran), sz(0), u64(0),
            u64(0)))
        self._ck(cu.cuMemCreate(ctypes.byref(handle), sz(mapped),
                                ctypes.byref(self.prop), u64(0)))
        base = va.value + self.gran
        self._ck(cu.cuMemMap(u64(base), sz(mapped), sz(0), handle, u64(0)))
        access = _AccessDesc(_Loc(1, 0), 3)  # read and write
        self._ck(cu.cuMemSetAccess(u64(base), sz(mapped),
                                   ctypes.byref(access), sz(1)))
        self.held.append((va.value, base, mapped, handle))
        addr = base + (mapped - nb if self.where == "end" else 0)
        torch.cuda.synchronize()
        self._ck(cu.cuMemcpyDtoD_v2(u64(addr), u64(t.data_ptr()), sz(nb)))
        self.sync()
        return addr

    def get(self, addr, like):
        out = torch.empty_like(like)
        self._ck(self.cu.cuMemcpyDtoD_v2(
            ctypes.c_uint64(out.data_ptr()), ctypes.c_uint64(addr),
            ctypes.c_size_t(out.numel() * out.element_size())))
        self.sync()
        return out

    def close(self):
        cu, u64, sz = self.cu, ctypes.c_uint64, ctypes.c_size_t
        for va, base, mapped, handle in self.held:
            cu.cuMemUnmap(u64(base), sz(mapped))
            cu.cuMemRelease(handle)
            cu.cuMemAddressFree(u64(va), sz(mapped + 2 * self.gran))
        self.held = []


@pytest.fixture(params=["end", "start"])
def guarded(request, gen):
    bufs = GuardedBuffers(request.param)
    yield bufs
    bufs.close()


def _kernel_library():
    from fami_pose_torch.ops.cuda.build import load_library

    return load_library()


def _overrun_child():
    """Launches the warp on 3 planes of a 1-plane guarded buffer: must fault
    (run in a process of its own by the test below)."""
    bufs = GuardedBuffers("end")
    img = torch.zeros(1, 1, 96, 72, device="cuda")
    a, o = bufs.put(img), bufs.put(torch.zeros(1, 2, device="cuda"))
    _kernel_library().fami_warp_translate(a, o, bufs.put(img), 0, 1, 400, 96,
                                          72, 26.0, None)
    bufs.sync()


def test_guard_pages_fault_on_an_overrun(gen):
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [here, os.path.dirname(here)]
    code = (f"import sys; sys.path[:0] = {paths!r}; "
            "import test_torch_cuda_kernels as t; t._overrun_child()")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "CUresult 700" in run.stderr, run.stderr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_offset", [4, 0])
def test_dcn_kernels_stay_inside_their_buffers(guarded, gen, dtype,
                                               max_offset):
    """Forward and backward at the main path's plane size (96x72, C=48,
    G=12, a third of the offsets past D), results equal to the wrappers'."""
    from fami_pose_torch.ops.deform_conv import deform_conv2d_backward

    n, c, h, w, g = 2, 48, 96, 72, 12
    code = 0 if dtype == torch.float32 else 1
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    off = _offsets(gen, (n, 2 * g * 9, h, w), max_offset, dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    wgt = (torch.randn(c, c, 3, 3, generator=gen, device="cuda")
           * 0.05).to(dtype)
    gout = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=max_offset)
    ref = deform_conv2d_windowed(x, off, msk, wgt, **kw)
    ref_b = deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
    lib = _kernel_library()
    px, po, pm, pw, pout = (guarded.put(t) for t in (x, off, msk, wgt, ref))
    dims = (code, n, c, h, w, c, h, w, 3, 3, 3, 3, g, float(max_offset), None)
    assert lib.fami_dcn_fwd(px, po, pm, pw, pout, *dims) == 0
    guarded.sync()
    assert torch.equal(guarded.get(pout, ref), ref)
    dx0 = torch.zeros(x.shape, device="cuda")
    dw0 = torch.zeros(wgt.shape, device="cuda")
    pg, pdx, pdo, pdm, pdw = (guarded.put(t)
                              for t in (gout, dx0, off, msk, dw0))
    assert lib.fami_dcn_bwd(px, po, pm, pw, pg, pdx, pdo, pdm, pdw,
                            *dims) == 0
    guarded.sync()
    _assert_grad_close("dx", guarded.get(pdx, dx0).to(dtype), ref_b[0], dtype)
    assert torch.equal(guarded.get(pdo, off), ref_b[1])
    assert torch.equal(guarded.get(pdm, msk), ref_b[2])
    _assert_grad_close("dweight", guarded.get(pdw, dw0).to(dtype), ref_b[3],
                       dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernels_stay_inside_their_buffers(guarded, gen, dtype):
    """Shifts at, inside and far past the clamp of 26 in both directions."""
    from fami_pose_torch.ops.warp import warp_translate_backward

    n, c, h, w = 8, 48, 96, 72
    code = 0 if dtype == torch.float32 else 1
    img = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    offs = (torch.rand(n, 2, generator=gen, device="cuda") * 2 - 1) * 40
    offs[:3] = torch.tensor([[26.0, -26.0], [-100.0, 100.0], [3.0, -7.0]])
    gout = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    ref = warp_translate(img, offs, max_shift=26)
    d_img, d_offs = warp_translate_backward(img, offs, gout, max_shift=26)
    lib = _kernel_library()
    pi, pf, pout = (guarded.put(t) for t in (img, offs, ref))
    assert lib.fami_warp_translate(pi, pf, pout, code, n, c, h, w, 26.0,
                                   None) == 0
    guarded.sync()
    assert torch.equal(guarded.get(pout, ref), ref)
    zeros = torch.zeros(n, 2, device="cuda")
    pg, pdi, pdo = (guarded.put(t) for t in (gout, img, zeros))
    assert lib.fami_warp_translate_bwd(pi, pf, pg, pdi, pdo, code, n, c, h,
                                       w, 26.0, None) == 0
    guarded.sync()
    assert torch.equal(guarded.get(pdi, img), d_img)
    # the blocks' partial sums are added with atomics: last bits vary
    scale = max(1.0, float(d_offs.abs().max()))
    assert float((guarded.get(pdo, zeros) - d_offs.float()).abs().max()
                 ) <= 1e-3 * scale


def test_probe_kernels_stay_inside_their_buffers(guarded, gen):
    probes, (x, idx) = _probe_on_card("gather_lane", seed=1)
    lib = _kernel_library()
    for variant in (0, 1):
        px, pi, po = guarded.put(x), guarded.put(idx), guarded.put(x)
        assert lib.fami_probe_gather_lane(px, pi, po, 1, *x.shape, variant,
                                          None) == 0
        guarded.sync()
        assert torch.equal(guarded.get(po, x),
                           probes.gather_lane_plain(x, idx))
    _, (x, idx) = _probe_on_card("gather_3d", seed=2)
    px, pi, po = guarded.put(x), guarded.put(idx), guarded.put(x)
    assert lib.fami_probe_gather_3d(px, pi, po, *x.shape, None) == 0
    guarded.sync()
    assert torch.equal(guarded.get(po, x), probes.gather_3d_plain(x, idx))
    _, (x, idx) = _probe_on_card("gather_rows", seed=3)
    px, pi, po = guarded.put(x), guarded.put(idx), guarded.put(x)
    assert lib.fami_probe_gather_rows(px, pi, po, *x.shape, None) == 0
    guarded.sync()
    assert torch.equal(guarded.get(po, x), probes.gather_rows_plain(x, idx))
    for shift in (0, 5, 127, 128, -3, -1000003):
        _, (x, s) = _probe_on_card("dynamic_roll", seed=4, shift=shift)
        px, ps, po = guarded.put(x), guarded.put(s), guarded.put(x)
        assert lib.fami_probe_dynamic_roll(px, ps, po, *x.shape, None) == 0
        guarded.sync()
        assert torch.equal(guarded.get(po, x), probes.dynamic_roll_plain(x, s))
