"""Direct LAF-shape optimization by gradient descent on descriptor distance.

Counterpart of ``affnet_tpu/shape_opt.py`` (reference:
examples/direct_shape_optimization/optimization_script.py,
``LAFDiscrOptimDetach.optimize``): the 2x2 shape parts of matching LAFs in
two views are optimized with Adam to minimize a descriptor loss over the
patches re-extracted from each view's pyramid.  Centers stay fixed.

One step: for each view, the flat pyramid level of every LAF from its
current scale, its patches through kernel B6
(:func:`.ops.pyramid_sampler.make_pyramid_sampler_diff`: 1 forward launch
per view, 1 backward launch per view for the LAF cotangent), the
descriptor, the loss, backward, and ``torch.optim.Adam(lr, betas=(0.9,
0.999), eps=1e-8)`` where the JAX package uses ``optax.adam``: the same
update, rounded in another order.  Each view's pyramid is built once, with
``n_levels=1`` (kernel B1; its largest blur, sigma 5.5, has 35 taps, inside
B1's 63).  Histories (LAFs, loss, shape difference, SNN
ratios) are kept per step as in the JAX package, and saved in its npz
layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from . import resolve_device
from .laf import laf_to_boundary_pts, normalize_lafs
from .losses import get_snn
from .ops.patches import select_levels_for_lafs
from .ops.pyramid_sampler import make_pyramid_sampler_diff
from .ops.scalespace import build_flat_pyramid, make_plan
from .utils import float32_math

Tensor = torch.Tensor


def frob_shape_diff(A1: Tensor, A2: Tensor) -> Tensor:
    """Mean Frobenius distance between two (N, 2, 2) shape sets."""
    return torch.sqrt(((A1 - A2) ** 2).sum(dim=(1, 2)) + 1e-12).mean()


@dataclasses.dataclass
class _View:
    """One image's pyramid (buffer and level tables), its sampler and the
    fixed LAF centers."""
    flat: Tensor
    tables: Tuple[Tensor, Tensor, Tensor]   # row_offsets, heights, widths
    sample: Callable[[Tensor, Tensor, Tensor], Tensor]
    sigma_pixdist: Tensor
    centers: Tensor          # (N, 2, 1), pixels
    hw: Tuple[int, int]


@dataclasses.dataclass
class ShapeOptState:
    """The optimization variables (the two views' (N, 2, 2) shapes, leaf
    tensors), their Adam, the views and the histories."""
    shapes: List[Tensor]
    optimizer: torch.optim.Adam
    views: List[_View]
    hist: Dict[str, List]


class LAFShapeOptimizer:
    """Optimize the 2x2 parts of paired LAFs against a descriptor loss.

    descriptor: (patches (N, PS, PS)) -> (N, D), differentiable
    loss_fn:    (desc1, desc2) -> scalar (e.g. losses.loss_hardnegc)

    ``use_kernels=False`` runs the plain versions of B1 and B6 on any
    device (the yardstick the kernels are held against).
    """

    def __init__(self, descriptor: Callable, loss_fn: Callable,
                 lr: float = 0.01, patch_size: int = 32,
                 n_levels: int = 1, init_sigma: float = 1.6,
                 border: int = 32, align_corners: bool = False,
                 device: Any = "cuda", use_kernels: bool = True):
        self.descriptor = descriptor
        self.loss_fn = loss_fn
        self.lr = lr
        self.ps = patch_size
        self.n_levels = n_levels
        self.init_sigma = init_sigma
        self.border = border
        self.align_corners = align_corners
        self.device = resolve_device(device)
        self.use_kernels = use_kernels

    def _view(self, img, lafs) -> _View:
        img = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        h, w = img.shape
        plan = make_plan(h, w, self.n_levels, self.init_sigma, self.border)
        _, flat = build_flat_pyramid(img.contiguous(), plan,
                                     use_kernel=self.use_kernels)
        tables = tuple(torch.as_tensor(np.asarray(t), dtype=torch.int32,
                                       device=self.device)
                       for t in plan.level_dims_padded())
        sample = make_pyramid_sampler_diff(*tables, self.ps,
                                           self.align_corners,
                                           use_kernel=self.use_kernels)
        sigma_pixdist = torch.as_tensor(plan.sigma_pixdist_table(),
                                        dtype=torch.float32,
                                        device=self.device)
        return _View(flat, tables, sample, sigma_pixdist,
                     lafs[:, :, 2:].clone(), (h, w))

    @float32_math()
    def prepare(self, lafs1: np.ndarray, lafs2: np.ndarray, img1,
                img2) -> ShapeOptState:
        """Both pyramids, the shapes as leaf tensors and a fresh Adam;
        ``lafs`` are (N, 2, 3) in pixel coordinates."""
        l1, l2 = (torch.as_tensor(np.asarray(l, np.float32),
                                  device=self.device)
                  for l in (lafs1, lafs2))
        views = [self._view(img1, l1), self._view(img2, l2)]
        shapes = [l[:, :, :2].clone().requires_grad_(True) for l in (l1, l2)]
        opt = torch.optim.Adam(shapes, lr=self.lr, betas=(0.9, 0.999),
                               eps=1e-8)
        st = ShapeOptState(shapes, opt, views, {
            "lafs1": [], "lafs2": [], "loss": [], "shape_diff": [],
            "snn": []})
        self._record_shapes(st)
        return st

    def sampler_inputs(self, view: _View,
                       A: Tensor) -> Tuple[Tensor, Tensor]:
        """(normalized LAFs, flat level index) of ``view``'s patches under
        shapes ``A``: the level each LAF's current scale selects."""
        dlafs = torch.cat([A, view.centers], dim=2)
        with torch.no_grad():
            lvl = select_levels_for_lafs(dlafs, view.sigma_pixdist, self.ps)
        return normalize_lafs(dlafs, view.hw[1], view.hw[0]), lvl

    def patches(self, view: _View, A: Tensor) -> Tensor:
        """The (N, PS, PS) patches of ``view`` under shapes ``A``."""
        return view.sample(view.flat, *self.sampler_inputs(view, A))

    def loss(self, st: ShapeOptState) -> Tuple[Tensor, Tensor, Tensor]:
        """(loss, desc1, desc2) at the current shapes."""
        d1, d2 = (self.descriptor(self.patches(v, A))
                  for v, A in zip(st.views, st.shapes))
        return self.loss_fn(d1, d2), d1, d2

    @float32_math()
    def step(self, st: ShapeOptState) -> None:
        """One Adam step on both shape sets; appends to the histories."""
        st.optimizer.zero_grad(set_to_none=True)
        loss, d1, d2 = self.loss(st)
        loss.backward()
        st.optimizer.step()
        with torch.no_grad():
            snn = get_snn(d1, d2)
        st.hist["loss"].append(float(loss.detach()))
        st.hist["snn"].append(snn.cpu().numpy())
        self._record_shapes(st)

    @staticmethod
    def _record_shapes(st: ShapeOptState) -> None:
        with torch.no_grad():
            for key, A, v in zip(("lafs1", "lafs2"), st.shapes, st.views):
                st.hist[key].append(
                    torch.cat([A, v.centers], dim=2).cpu().numpy())
            st.hist["shape_diff"].append(
                float(frob_shape_diff(st.shapes[0], st.shapes[1])))

    def optimize(self, lafs1: np.ndarray, lafs2: np.ndarray, img1, img2,
                 n_iters: int = 10) -> Dict[str, List]:
        """LAFs in pixel coordinates (N, 2, 3).  Returns the histories:
        ``lafs1``/``lafs2`` (n_iters + 1 arrays), ``loss`` and ``snn`` (one
        per step), ``shape_diff`` (n_iters + 1)."""
        st = self.prepare(lafs1, lafs2, img1, img2)
        for _ in range(n_iters):
            self.step(st)
        return st.hist


def save_history(hist: Dict[str, List], fname: str) -> None:
    """Persist an optimize() history as npz, the JAX package's layout."""
    np.savez(fname, lafs1=np.stack(hist["lafs1"]),
             lafs2=np.stack(hist["lafs2"]),
             loss=np.asarray(hist["loss"]),
             shape_diff=np.asarray(hist["shape_diff"]),
             snn=np.stack(hist["snn"]) if hist["snn"] else np.zeros(0))


def load_history(fname: str) -> Dict[str, List]:
    with np.load(fname) as d:
        return {"lafs1": list(d["lafs1"]), "lafs2": list(d["lafs2"]),
                "loss": list(d["loss"]), "shape_diff": list(d["shape_diff"]),
                "snn": list(d["snn"])}


def render_history(hist: Dict[str, List], img, fname: str, fps: int = 24,
                   dpi: int = 72) -> str:
    """Animate the optimization: both views' ellipses (red/blue) over the
    inverted image, one frame per step.  Writes mp4 when an ffmpeg writer
    is available, else an animated GIF; returns the path written.  Needs
    matplotlib (imported here, not with the module)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter, writers

    img = np.asarray(img).squeeze()
    fig, ax = plt.subplots()
    fig.set_tight_layout(True)
    ax.imshow(255 - img, cmap="gray")
    lines = {"1": [], "2": []}
    for key, color in (("1", "r"), ("2", "b")):
        for laf in np.asarray(hist[f"lafs{key}"][0]):
            ell = laf_to_boundary_pts(laf)
            lines[key].append(ax.plot(ell[:, 0], ell[:, 1], color)[0])
    ax.legend([lines["1"][0], lines["2"][0]], ["img1", "img2"])

    def update(i):
        for key in ("1", "2"):
            for line, laf in zip(lines[key],
                                 np.asarray(hist[f"lafs{key}"][i])):
                ell = laf_to_boundary_pts(laf)
                line.set_data(ell[:, 0], ell[:, 1])
        return lines["1"] + lines["2"]

    anim = FuncAnimation(fig, update, frames=np.arange(len(hist["lafs1"])),
                         interval=int(1000 / fps))
    if fname.endswith(".mp4") and not writers.is_available("ffmpeg"):
        fname = fname[:-4] + ".gif"
    if fname.endswith(".mp4"):
        anim.save(fname, dpi=dpi, writer=writers["ffmpeg"](fps=fps))
    else:
        anim.save(fname, dpi=dpi, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return fname
