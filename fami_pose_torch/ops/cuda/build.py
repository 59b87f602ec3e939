"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper) at
first use, one ``nvcc`` process per source, all started together, then linked
into one shared library with a plain C interface that ``ctypes`` loads.
Nothing here includes PyTorch's headers, so a build takes seconds.

The library lands in ``_build/`` beside this file (listed in ``.gitignore``)
under a name derived from the hash of the sources and flags: an edited source
gets a fresh build, an unchanged one is reused. The build writes to a private
temporary directory and renames the result into place, so processes that
build at the same time do not see each other's half-written files.

Importing this module builds nothing; only :func:`load_library` does, and
only the wrappers' CUDA branches call it.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
SOURCES = ("dcn_fwd.cu", "dcn_bwd.cu", "warp.cu", "warp_bwd.cu", "probes.cu",
           "int8_conv.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float

# argtypes of each C entry point (csrc/*.cu); every entry returns the
# cudaError_t of its launch as an int
SIGNATURES = {
    # x, x_grouped (scratch of x's size), offset, mask, weight, out, work
    # (scratch of fami_dcn_fwd_workspace bytes), dtype, B, C, H, W, Cout, Ho,
    # Wo, kh, kw, pad, dil, groups, max_offset, stream
    "fami_dcn_fwd": [c_ptr] * 7 + [c_int] * 13 + [c_float, c_ptr],
    # x, x_grouped, offset, mask, weight, gout, dx, doffset, dmask, dweight,
    # dx_acc (f32 of x's size in the exact mode, its scatter; else null), work
    # (f32 scratch of fami_dcn_bwd_workspace elements), dtype, B, C, H, W,
    # Cout, Ho, Wo, kh, kw, pad, dil, groups, max_offset, stream
    "fami_dcn_bwd": [c_ptr] * 12 + [c_int] * 13 + [c_float, c_ptr],
    # images, offsets, out, dtype, blend, N, C, H, W, max_shift, stream
    "fami_warp_translate": [c_ptr] * 3 + [c_int] * 6 + [c_float, c_ptr],
    # images, offsets, gout, d_images, d_offsets, partials (scratch), dtype,
    # N, C, H, W, max_shift, stream
    "fami_warp_translate_bwd": [c_ptr] * 6 + [c_int] * 5 + [c_float, c_ptr],
    # x, idx, out, dtype, rows, cols, variant, stream
    "fami_probe_gather_lane": [c_ptr] * 3 + [c_int] * 4 + [c_ptr],
    # x, idx, out, batch, rows, cols, stream
    "fami_probe_gather_3d": [c_ptr] * 3 + [c_int] * 3 + [c_ptr],
    # x, idx, out, rows, cols, stream
    "fami_probe_gather_rows": [c_ptr] * 3 + [c_int] * 2 + [c_ptr],
    # x, shift, out, rows, cols, stream
    "fami_probe_dynamic_roll": [c_ptr] * 3 + [c_int] * 2 + [c_ptr],
    # stream (an empty kernel: the floor of a launch)
    "fami_empty_launch": [c_ptr],
    # x, act_scale, out, dtype, B, C, H, W, Cp, stream
    "fami_int8_quant_nhwc": [c_ptr] * 3 + [c_int] * 6 + [c_ptr],
    # xq, wp, w_scale, act_scale, bias (or null), out, dtype, B, H, W, Cp,
    # kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo, N, Np, Kp, stream
    "fami_int8_implicit_gemm": [c_ptr] * 6 + [c_int] * 18 + [c_ptr],
}

DTYPE_CODES = {"float32": 0, "bfloat16": 1}

def find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "fami_pose_torch are built from source at first use"
        )
    return nvcc


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose=False, out_logs=None):
    """Compile the sources (in parallel) and link them; returns the path of
    the shared library. Raises ``RuntimeError`` with nvcc's output on
    failure. ``verbose`` adds ``-Xptxas -v`` and prints nvcc's output;
    ``out_logs``, a list, receives it (one string a source) when the
    library is built here."""
    so_path = os.path.join(BUILD_DIR, f"libfami_kernels_{_source_hash()}.so")
    if os.path.exists(so_path):
        return so_path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp")
    try:
        procs, objs = [], []
        extra = ("-Xptxas", "-v") if verbose else ()
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", os.path.join(CSRC, src),
                   "-o", obj]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        logs = []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"--- {src} ---\n{out}")
            if p.returncode != 0:
                for _, other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS, *objs, "-o", tmp_so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so_path)
        if verbose:
            print("\n".join(logs), flush=True)
        if out_logs is not None:
            out_logs.extend(logs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so_path


@functools.lru_cache(maxsize=None)
def load_library():
    """Build if needed, load once per process, declare every entry's types."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_int
    lib.fami_cuda_error_string.argtypes = [c_int]
    lib.fami_cuda_error_string.restype = ctypes.c_char_p
    # dtype, C, H, W -> blocks a warp_bwd launch gives each image
    lib.fami_warp_translate_bwd_blocks.argtypes = [c_int] * 4
    lib.fami_warp_translate_bwd_blocks.restype = ctypes.c_longlong
    # dtype, C, Cout, kh, kw -> bytes of the DCN forward's workspace
    lib.fami_dcn_fwd_workspace.argtypes = [c_int] * 5
    lib.fami_dcn_fwd_workspace.restype = ctypes.c_longlong
    # B, C, Cout, Ho, Wo, kh, kw, groups, max_offset -> float32 elements
    # of the DCN backward's workspace on the current device (in windowed
    # mode it holds the dx gather's m * dcol)
    lib.fami_dcn_bwd_workspace.argtypes = [c_int] * 8 + [c_float]
    lib.fami_dcn_bwd_workspace.restype = ctypes.c_longlong
    return lib


def check(lib, err, name):
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.fami_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")


def stream_ptr(tensor):
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
