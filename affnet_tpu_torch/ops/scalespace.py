"""Gaussian scale pyramid with a static plan, and the row-padded buffer that
holds every level.

Counterpart of ``affnet_tpu/ops/scalespace.py``: the octave count, level
shapes and blur sigmas are computed on the host from (H, W) into a
:class:`PyramidPlan`; the pyramid is then written level by level into the
row-padded buffer by the B1 blur (:mod:`.cuda_blur`).  Numerics follow the
reference exactly:

  - initial blur sigma = sqrt(init_sigma^2 - 0.5^2)
  - per-level blur sigma = curSigma * sqrt(step^2 - 1), step = 2^(1/nLevels)
  - octave downsample = stride-2 point sampling
  - stop when the next octave side <= 2 * border + 3
  - Gaussian taps: CircularGaussKernel with the ``py2`` integer half size or
    the python-3 ``kernlen / 2`` float half size, replicate edges.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .cuda_blur import blur, blur_level

Tensor = torch.Tensor


def gauss_kernel_1d(sigma: float, py2: bool = False) -> np.ndarray:
    """1-D Gaussian taps: kernlen = int(6 sigma + 1) made odd, taps at
    linspace(-half, half, kernlen), normalized.  ``py2`` takes the integer
    half size (kernlen // 2), else the float kernlen / 2."""
    kernlen = int(2.0 * 3.0 * sigma + 1.0)
    if kernlen % 2 == 0:
        kernlen += 1
    half = kernlen // 2 if py2 else kernlen / 2.0
    x = np.linspace(-half, half, kernlen)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: Tensor, sigma: float, py2: bool = False,
                  use_kernel: bool = True) -> Tensor:
    """Separable Gaussian blur with replicate edges on an (H, W) image
    (kernel B1, or its plain version: see :func:`.cuda_blur.blur`)."""
    return blur(img, gauss_kernel_1d(sigma, py2=py2), use_kernel=use_kernel)


def downsample2(img: Tensor) -> Tensor:
    """Stride-2 point sampling (== avg_pool2d(kernel_size=1, stride=2))."""
    return img[::2, ::2].contiguous()


@dataclasses.dataclass(frozen=True)
class PyramidPlan:
    """Static description of the pyramid for an (H, W) input; flat level
    index ``o * levels_per_octave + l``."""
    height: int
    width: int
    n_levels: int
    init_sigma: float
    border: int
    octave_shapes: Tuple[Tuple[int, int], ...]
    sigmas: Tuple[Tuple[float, ...], ...]
    pix_dists: Tuple[Tuple[float, ...], ...]

    @property
    def n_octaves(self) -> int:
        return len(self.octave_shapes)

    @property
    def levels_per_octave(self) -> int:
        return self.n_levels + 2

    def flat_index(self, octave: int, level: int) -> int:
        return octave * self.levels_per_octave + level

    def level_shapes(self) -> List[Tuple[int, int]]:
        return [s for s in self.octave_shapes
                for _ in range(self.levels_per_octave)]

    def row_offsets(self) -> np.ndarray:
        """Starting row of each level in the row-padded buffer."""
        hs = [h for h, _ in self.level_shapes()]
        return np.concatenate([[0], np.cumsum(hs)[:-1]]).astype(np.int32)

    def padded_buffer_shape(self) -> Tuple[int, int]:
        shapes = self.level_shapes()
        return (int(sum(h for h, _ in shapes)),
                int(max(w for _, w in shapes)))

    def level_dims_padded(self):
        """(row_offsets, heights, widths) int32 tables of the buffer."""
        shapes = self.level_shapes()
        hs = np.array([h for h, _ in shapes], np.int32)
        ws = np.array([w for _, w in shapes], np.int32)
        return self.row_offsets(), hs, ws

    def sigma_pixdist_table(self) -> np.ndarray:
        """sigma * pix_dist per flat level: the level's blur in original
        image pixels (descriptor level selection)."""
        return np.array([self.sigmas[o][l] * self.pix_dists[o][l]
                         for o in range(self.n_octaves)
                         for l in range(self.levels_per_octave)], np.float32)


def make_plan(height: int, width: int, n_levels: int = 3,
              init_sigma: float = 1.6, border: int = 5) -> PyramidPlan:
    """The full static pyramid plan for an (H, W) image."""
    min_size = 2 * border + 2 + 1
    step = 2.0 ** (1.0 / n_levels)
    octave_shapes = [(height, width)]
    sigmas, pix_dists = [], []
    pix = 1.0
    while True:
        sigmas.append(tuple(init_sigma * step ** i
                            for i in range(n_levels + 2)))
        pix_dists.append(tuple([pix] * (n_levels + 2)))
        h, w = octave_shapes[-1]
        nh, nw = (h + 1) // 2, (w + 1) // 2
        pix *= 2.0
        if nh <= min_size or nw <= min_size:
            break
        octave_shapes.append((nh, nw))
    return PyramidPlan(height=height, width=width, n_levels=n_levels,
                       init_sigma=init_sigma, border=border,
                       octave_shapes=tuple(octave_shapes),
                       sigmas=tuple(sigmas), pix_dists=tuple(pix_dists))


def pyramid_views(buf: Tensor, plan: PyramidPlan) -> List[Tensor]:
    """Each octave's levels as a ``(levels_per_octave, h, w)`` view of the
    row-padded buffer (row pitch: the buffer's width)."""
    wmax = buf.shape[1]
    offs = plan.row_offsets()
    n = plan.levels_per_octave
    views = []
    for o, (h, w) in enumerate(plan.octave_shapes):
        r0 = int(offs[plan.flat_index(o, 0)])
        views.append(buf[r0:r0 + n * h].view(n, h, wmax)[:, :, :w])
    return views


@dataclasses.dataclass(frozen=True)
class BlurStep:
    """One B1 launch of the pyramid: blur level ``src`` ((octave, level), or
    None for the image) with ``taps`` into level ``dst``; with ``down``, also
    write the stride-2 samples there; with ``zero_src_pad``, zero the
    source's padding too."""
    src: Optional[Tuple[int, int]]
    dst: Tuple[int, int]
    taps: np.ndarray
    down: Optional[Tuple[int, int]] = None
    zero_src_pad: bool = False


def pyramid_steps(plan: PyramidPlan, py2: bool = False) -> List[BlurStep]:
    """The pyramid's B1 launches in order: the initial blur, then per
    octave each level from the one before it, the launch of level
    ``n_levels`` writing the next octave's first level (:func:`downsample2`)
    and the first launch of an octave zeroing that level's padding."""
    step = 2.0 ** (1.0 / plan.n_levels)
    cur_sigma = 0.5
    if plan.init_sigma > cur_sigma:
        taps0 = gauss_kernel_1d(
            math.sqrt(plan.init_sigma ** 2 - cur_sigma ** 2), py2=py2)
    else:
        taps0 = np.ones(1, np.float32)      # the image itself: 1.0 * x == x
    steps = [BlurStep(None, (0, 0), taps0)]
    for o in range(plan.n_octaves):
        cs = plan.init_sigma
        for i in range(1, plan.levels_per_octave):
            sigma = cs * math.sqrt(step * step - 1.0)
            down = ((o + 1, 0) if i == plan.n_levels
                    and o + 1 < plan.n_octaves else None)
            steps.append(BlurStep((o, i - 1), (o, i),
                                  gauss_kernel_1d(sigma, py2=py2), down,
                                  zero_src_pad=i == 1))
            cs *= step
    return steps


def build_flat_pyramid(img: Tensor, plan: PyramidPlan, py2: bool = False,
                       use_kernel: bool = True):
    """The pyramid, written level by level into a row-padded (sum of
    heights, max width) buffer, zeros right of narrower levels.  Returns
    (pyr, buf): ``pyr[o]`` is octave o's ``(levels_per_octave, h, w)`` view
    of ``buf``.  One B1 launch per level (:func:`pyramid_steps`,
    :func:`.cuda_blur.blur_level`) writes the level into its rows and zeroes
    its padding.  ``use_kernel=False`` runs the plain versions on any
    device."""
    rows, wmax = plan.padded_buffer_shape()
    buf = torch.empty((rows, wmax), dtype=img.dtype, device=img.device)
    pyr = pyramid_views(buf, plan)

    def level(ol):
        return None if ol is None else pyr[ol[0]][ol[1]]

    for st in pyramid_steps(plan, py2=py2):
        blur_level(img if st.src is None else level(st.src), level(st.dst),
                   st.taps, pad_to=wmax, down=level(st.down),
                   zero_src_pad=st.zero_src_pad, use_kernel=use_kernel)
    return pyr, buf
