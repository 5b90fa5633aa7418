"""Build the CUDA kernels in ``csrc/*.cu`` into one shared library and load
it with ``ctypes``.

One ``nvcc`` process per source, all started together, compiles the
sources for Hopper (``sm_90a``); one more links the objects into
``affnet_tpu_torch/_build/libaffnet_kernels-<hash>.so``, at first use.  The
sources export plain C functions on raw pointers (no PyTorch header), which
keeps the build to seconds.  The hash covers the sources and the flags, so a
stale library is never loaded.  Each exported ``launch_*`` function returns
``cudaGetLastError()`` after its launches; :func:`launch` raises on nonzero.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import List

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
NVCC_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# argtypes of every exported function (pointers and the stream as void*).
SIGNATURES = {
    # in, in_pitch, out, out_pitch, down (or null), down_pitch, in_pad (or
    # null), h, w, pad_to, taps (device), taps (host), n_taps, stream
    "launch_blur": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _I,
                    _P],
    # levels, level_stride, pitch, h, w, L, sigma^4 (host), th, border,
    # resp (L-2, h, w), counters (2^(L-2) - 1), stream
    "launch_detect_stencil": [_P, _I, _I, _I, _I, _I, _P, _F, _I, _P, _P,
                              _P],
    # resp, counters (n_oct, 2^n_centers - 1), resp offsets (host int64),
    # h * w (host int64), n_oct, n_centers, stream
    "launch_detect_dedup": [_P, _P, _P, _P, _I, _I, _P],
    # buf, pitch, idx (n,), n, det_off, ext_level, n_det, row_off, heights,
    # widths, sigma, sigma^4, th, out (n, 3), stream
    "launch_detect_refine": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                             _F, _P, _P],
    # x (n,), n, vals (rows, m), cols (rows, m), leftover (rows,), rows,
    # m, stream
    "launch_row_topm": [_P, _I, _P, _P, _P, _I, _I, _P],
    # buf, buf_rows, pitch, lafs (n, 2, 3), level (n,), row_off, heights,
    # widths, n_levels, lin (device, ps), out (n, ps, ps), n, ps,
    # align_corners, bf16, stream
    "launch_sample_patches": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                              _I, _I, _I, _I, _P],
    # buf, buf_rows, pitch, lafs, level, row_off, heights, widths, n_levels,
    # lin (device, ps), g (n, ps, ps), grad_buf (or null), grad_lafs (or
    # null), n, ps, align_corners, stream
    "launch_sample_patches_bwd": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                                  _P, _P, _P, _I, _I, _I, _P],
    # x (c, n * h * w), w (packed), bias (o,), out (o, n * ho * wo), c, o,
    # n, h, w, k, stride, pad, act, bf16, stream
    "launch_conv_flat": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P],
}


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libaffnet_kernels-{source_hash()}.so")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def compile_command(nvcc: str, src: str, obj: str) -> List[str]:
    return [nvcc, *COMPILE_FLAGS, "-c", src, "-o", obj]


def link_command(nvcc: str, objs: List[str], out: str) -> List[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", out, *objs]


def _run_all(commands: List[List[str]], deadline: float) -> List[str]:
    """Start every command at once and wait for all; returns the failures'
    messages.  Every process started is ended before this returns."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in commands]
    errors = []
    try:
        for cmd, proc in zip(commands, procs):
            try:
                _, err = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                errors.append(f"{cmd[-3]}: timed out")
                continue
            if proc.returncode != 0:
                errors.append(f"{cmd[-3]}: exit {proc.returncode}\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return errors


def build() -> str:
    """Build the library unless the current sources' one exists; returns
    its path.  Raises with nvcc's stderr on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = f"{path}.{tag}"
    srcs = sources()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in srcs]
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    try:
        errors = _run_all([compile_command(nvcc, src, obj)
                           for src, obj in zip(srcs, objs)], deadline)
        if not errors:
            errors = _run_all([link_command(nvcc, objs, tmp)], deadline)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    return path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.affnet_error_string.argtypes = [ctypes.c_int]
    lib.affnet_error_string.restype = ctypes.c_char_p
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call ``launch_*`` and raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.affnet_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")


def host_floats(values) -> ctypes.Array:
    """A host float array for a kernel's small by-value tables (taps,
    sigmas, grid coordinates): the launch function copies it into the
    kernel's parameters, so it needs no device copy."""
    vals = [float(v) for v in values]
    return (ctypes.c_float * len(vals))(*vals)


def check_rows(t: torch.Tensor, name: str, shape=None) -> None:
    """Raise unless ``t`` is a float32 (H, W) CUDA tensor with unit column
    stride and any row pitch (a level of the row-padded buffer), of
    ``shape`` when given."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or t.dim() != 2:
        raise ValueError(f"{name}: expected float32 (H, W), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.stride(1) != 1 and t.shape[1] > 1:
        raise ValueError(f"{name}: expected unit column stride")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 dim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``dim``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
