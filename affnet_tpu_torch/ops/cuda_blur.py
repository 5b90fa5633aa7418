"""Kernel B1: separable Gaussian blur of one pyramid level, written into its
rows of the row-padded level buffer.

Replaces ``affnet_tpu/ops/pallas_blur.py:_blur_kernel`` (entry
``gaussian_blur_pallas``).  CUDA source: ``csrc/blur.cu``.

Same taps as ``scalespace.gauss_kernel_1d``, horizontal pass then vertical
pass, taps accumulated in order, replicate edges as clamped indices.  The
JAX entry falls back to its XLA blur when the radius exceeds the image; edge
padding and clamped indices agree for any radius, so here the same kernel
(and the same plain version) serves every level size and any odd tap count.

One launch (:func:`blur_level`) reads a level and writes the next one
where it lives: a view with unit column stride and any row pitch.  It also
zeroes the buffer's padding right of the level (``pad_to``) and, with
``down``, writes the level's stride-2 point samples (the next octave's
first level).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from ..kernels.build import check_rows, host_floats, launch, stream_of

Tensor = torch.Tensor

launches = 0


def blur_plain(img: Tensor, taps: Sequence[float]) -> Tensor:
    """Plain PyTorch version: the XLA shifted-slice formulation, with the
    replicate padding taken by clamped column/row indices."""
    taps = [float(t) for t in taps]
    pad = len(taps) // 2
    h, w = img.shape
    cols = torch.arange(-pad, w + pad, device=img.device).clamp(0, w - 1)
    xp = img[:, cols]
    x = taps[0] * xp[:, 0:w]
    for i in range(1, len(taps)):
        x = x + taps[i] * xp[:, i:i + w]
    rows = torch.arange(-pad, h + pad, device=img.device).clamp(0, h - 1)
    yp = x[rows]
    y = taps[0] * yp[0:h]
    for i in range(1, len(taps)):
        y = y + taps[i] * yp[i:i + h]
    return y


def _padding(t: Tensor, pad_to: int) -> Tensor:
    """Columns [w, pad_to) of ``t``'s rows, which lie in its storage past
    the view (the row-padded buffer's padding)."""
    h, w = t.shape
    return t.as_strided((h, pad_to - w), t.stride(), t.storage_offset() + w)


def blur_level_plain(src: Tensor, dst: Tensor, taps: Sequence[float],
                     pad_to: Optional[int] = None,
                     down: Optional[Tensor] = None,
                     zero_src_pad: bool = False) -> None:
    """Plain version of one B1 launch: ``dst = blur_plain(src, taps)``;
    zeros in columns [w, pad_to) of dst's rows (and of src's with
    ``zero_src_pad``); ``down = dst[::2, ::2]``."""
    out = blur_plain(src, taps)
    dst.copy_(out)
    if down is not None:
        down.copy_(out[::2, ::2])
    if pad_to is not None and pad_to > dst.shape[1]:
        _padding(dst, pad_to).zero_()
        if zero_src_pad:
            _padding(src, pad_to).zero_()


@functools.lru_cache(maxsize=64)
def _device_taps(taps: tuple, device: torch.device) -> Tensor:
    """The taps as a float32 tensor on ``device``: copied once per distinct
    tap set, so a pyramid's launches read them without a copy."""
    return torch.tensor(taps, dtype=torch.float32).to(device)


def _check_padding(t: Tensor, name: str, pad_to: int) -> None:
    h, w = t.shape
    end = t.storage_offset() + (h - 1) * t.stride(0) + pad_to
    if t.stride(0) < pad_to or end > t.untyped_storage().nbytes() // 4:
        raise ValueError(f"{name}: rows of {t.stride(0)} elements cannot "
                         f"hold padding to {pad_to}")


def blur_level_cuda(src: Tensor, dst: Tensor, taps: Sequence[float],
                    pad_to: Optional[int] = None,
                    down: Optional[Tensor] = None,
                    zero_src_pad: bool = False) -> None:
    """Launch B1 on float32 CUDA views (see :func:`blur_level_plain`)."""
    global launches
    check_rows(src, "src")
    h, w = src.shape
    check_rows(dst, "dst", (h, w))
    if h == 0 or w == 0:
        raise ValueError("blur: empty image")
    n = len(taps)
    if n % 2 == 0:
        raise ValueError(f"blur: need an odd tap count, got {n}")
    pad_to = w if pad_to is None else int(pad_to)
    if pad_to < w:
        raise ValueError(f"blur: pad_to {pad_to} below the width {w}")
    if pad_to > w:
        _check_padding(dst, "dst", pad_to)
        if zero_src_pad:
            _check_padding(src, "src", pad_to)
    if down is not None:
        check_rows(down, "down", ((h + 1) // 2, (w + 1) // 2))
    if src.device != dst.device or (down is not None
                                    and down.device != dst.device):
        raise ValueError("blur: tensors on different devices")
    dev_taps = _device_taps(tuple(float(t) for t in taps), dst.device)
    launch("launch_blur", src.data_ptr(), src.stride(0), dst.data_ptr(),
           dst.stride(0), None if down is None else down.data_ptr(),
           0 if down is None else down.stride(0),
           src.data_ptr() if zero_src_pad and pad_to > w else None,
           h, w, pad_to, dev_taps.data_ptr(), host_floats(taps), n,
           stream_of(dst))
    launches += 1


def blur_level(src: Tensor, dst: Tensor, taps: Sequence[float],
               pad_to: Optional[int] = None, down: Optional[Tensor] = None,
               zero_src_pad: bool = False, use_kernel: bool = True) -> None:
    """One pyramid level: B1 for CUDA tensors, the plain version for CPU
    tensors or when ``use_kernel`` is False."""
    fn = (blur_level_plain if dst.device.type == "cpu" or not use_kernel
          else blur_level_cuda)
    fn(src, dst, taps, pad_to=pad_to, down=down, zero_src_pad=zero_src_pad)


def blur_cuda(img: Tensor, taps: Sequence[float]) -> Tensor:
    """Launch B1 on an (H, W) float32 CUDA tensor into a new one."""
    check_rows(img, "img")
    out = torch.empty(img.shape, dtype=img.dtype, device=img.device)
    blur_level_cuda(img, out, taps)
    return out


def blur(img: Tensor, taps: Sequence[float],
         use_kernel: bool = True) -> Tensor:
    """Blur an (H, W) image with ``taps`` into a new tensor: B1 for a CUDA
    tensor, the plain version for a CPU tensor or when ``use_kernel`` is
    False."""
    if img.device.type == "cpu" or not use_kernel:
        return blur_plain(img, taps)
    return blur_cuda(img, taps)
