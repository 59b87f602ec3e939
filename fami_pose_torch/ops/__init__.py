"""Tensor ops: affine geometry, warps, the DCN, decode, flips."""


def kernel_wrappers():
    """The wrappers that count their hand-written kernel's launches, by
    kernel name: the four of the float paths, then the int8 conv's two.
    Each adds one to its ``launches`` where it launches its kernel; on a
    CPU tensor it runs the plain version and counts nothing."""
    from .deform_conv import deform_conv2d_backward, deform_conv2d_windowed
    from .int8_conv import implicit_gemm, quant_nhwc
    from .warp import warp_translate, warp_translate_backward

    return {"dcn_fwd": deform_conv2d_windowed,
            "dcn_bwd": deform_conv2d_backward,
            "warp_translate": warp_translate,
            "warp_bwd": warp_translate_backward,
            "int8_quant_nhwc": quant_nhwc,
            "int8_implicit_gemm": implicit_gemm}


def launch_counts():
    """Every kernel's launch count so far, by name (``kernel_wrappers``)."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def launches_since(before):
    """The launches of each kernel since ``before`` (a ``launch_counts``)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}
