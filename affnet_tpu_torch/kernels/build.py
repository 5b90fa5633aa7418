"""Build the CUDA kernels in ``csrc/*.cu`` into one shared library and load
it with ``ctypes``.

One ``nvcc`` call compiles every source for Hopper (``sm_90a``) into
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
from typing import List

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
NVCC_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# argtypes of every exported function (pointers and the stream as void*).
SIGNATURES = {
    # in, tmp, out, h, w, taps (host), n_taps, stream
    "launch_blur": [_P, _P, _P, _I, _I, _P, _I, _P],
    # levels (L, h, w), out (L-2, 4, h, w), h, w, L, sigma (host),
    # sigma^4 (host), th, stream
    "launch_detect_octave": [_P, _P, _I, _I, _I, _P, _P, _F, _P],
    # x (rows, s), vals (rows, m), cols (rows, m), leftover (rows,), rows,
    # s, m, stream
    "launch_row_topm": [_P, _P, _P, _P, _I, _I, _I, _P],
    # buf, buf_rows, pitch, lafs (n, 2, 3), level (n,), row_off, heights,
    # widths, n_levels, lin (host, ps), out (n, ps, ps), n, ps,
    # align_corners, stream
    "launch_sample_patches": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                              _I, _I, _I, _P],
    # buf, buf_rows, pitch, lafs, level, row_off, heights, widths, n_levels,
    # lin (host, ps), g (n, ps, ps), grad_buf (or null), grad_lafs (or
    # null), n, ps, align_corners, stream
    "launch_sample_patches_bwd": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                                  _P, _P, _P, _I, _I, _I, _P],
}


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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


def nvcc_command(nvcc: str, out: str) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out, *sources()]


def build() -> str:
    """Build the library unless the current sources' one exists; returns
    its path.  Raises with nvcc's stderr on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True,
                          text=True, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
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
