"""The scale-space Hessian-affine extraction pipeline, in PyTorch.

Counterpart of ``affnet_tpu/detector.py`` for the extraction path: image ->
Gaussian pyramid (B1) -> per-octave det-Hessian + 3x3x3 NMS + soft-argmax
(B2) -> exact global top-k (B3; threshold mode: every survivor) -> AffNet
shape iterations at the "shape" patch site (B4) -> eig-ratio/boundary gate
and re-top-k -> orientation at the "ori" site (B4) -> extent sort and
scale-aware level selection -> descriptor patches at the "desc" site (B4)
-> descriptor CNN.

The stages keep the JAX package's fixed-size arrays plus validity mask, so
the two packages can be compared stage by stage.

Two modes, as in JAX.  Top-k mode (``th=None``) keeps the
``num_features`` strongest keypoints, in descending response order.
Threshold mode (``th`` set; the HesAffNet program's ``th=-1``) subtracts
``th`` from the responses before NMS (kernel B2) and keeps every NMS
survivor that passes the shape gate, in scan order.  JAX sizes its arrays
to a static cap and, when the survivors exceed it, compiles again with the
next power of two, so its output always holds every survivor; the port is
eager and takes the survivors' indices with ``torch.nonzero`` (scan order,
one host read of their count per image), which gives the same output
without padding and without a top-k.  ``max_keypoints`` and the counts of
``DetectorConfig`` therefore bind only top-k mode here, unless a call asks
for ``capped``: then threshold mode keeps what JAX's built program keeps
before any retry (its bulk mode, ``parallel.make_sharded_image_pipeline``,
runs that program as it is), the ``max_keypoints`` strongest survivors
(the lowest index first among equal responses), in descending response
order.

``do_ori`` runs the orientation stage at the "ori" patch site (B4, or
B4-bf16 in fast mode): the orientation net's rotation composes with each
shape on the right.  Without a shape net the shape stage runs the
handcrafted Baumberg step, and without an orientation net the orientation
stage the handcrafted dominant gradient orientation, both at PS 19
(``models/handcrafted.py``), as the JAX extractor does; they stay float32
in fast mode, where B4-bf16 still samples their patches.

``fast=True`` is the JAX package's fast mode, which its flagship runs: the
shape and descriptor nets run their activation chains in bf16
(``PatchNet.with_dtype``) and both patch sites sample through kernel
B4-bf16 (bf16 corner values and column weights, float32 accumulation);
detection, top-k and selection stay float32.  ``desc_dtype`` (e.g.
"float16") casts the returned descriptors.  Float32 tensors mean float32
math: ``run`` (and so ``__call__``) runs with TF32 off
(:func:`.utils.float32_math`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .laf import (check_touch_boundary, denormalize_lafs, eig2x2_vals,
                  sc_y_x_to_lafs)
from .models.handcrafted import AffineShapeEstimator, OrientationDetector
from .ops.cuda_detect import (RefineTables, dedup, detect_stencil,
                               n_counters, refine)
from .ops.cuda_patches import extract_patches_pyramid
from .ops.nms import border_mask, masked_topk
from .ops.patches import sample_extents, select_levels_for_lafs
from .ops.scalespace import PyramidPlan, build_flat_pyramid, make_plan
from .utils import check_finite, float32_math

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """The JAX ``DetectorConfig`` fields the port supports."""
    num_features: int = 500
    border: int = 16
    patch_size: int = 32           # descriptor patch size
    mr_size: float = 3.0
    n_levels: int = 3
    num_baum_iters: int = 0
    init_sigma: float = 1.6
    th: Optional[float] = None     # not None: threshold mode
    max_keypoints: int = 8192      # cap on the top-k counts
    align_corners: bool = False
    py2: bool = False
    fast: bool = False             # bf16 patch sampling and nets
    desc_dtype: Optional[str] = None   # dtype of the returned descriptors

    @property
    def threshold_mode(self) -> bool:
        return self.th is not None

    @property
    def effective_th(self) -> float:
        return float(self.th) if self.th is not None else 0.0

    def prefilter_count(self) -> int:
        """Top-k mode's candidates kept after detection (before the shape
        stage).  Threshold mode keeps every survivor (module docstring)."""
        if self.num_baum_iters > 0:
            return min(int(1.5 * self.num_features), self.max_keypoints)
        return min(self.num_features, self.max_keypoints)

    def final_count(self) -> int:
        """Top-k mode's keypoints kept after the shape gate."""
        return min(self.num_features, self.max_keypoints)


def _detection_tables(plan: PyramidPlan):
    """Per detection level (octave o, center level l): start offset in the
    concatenated response vector, flat extraction level (l - 1, the
    reference's "prevBlur"), octave id and stored level id (l - 1)."""
    offsets, ext_levels, oct_ids, level_ids = [], [], [], []
    pos = 0
    for o in range(plan.n_octaves):
        h, w = plan.octave_shapes[o]
        for l in range(1, plan.levels_per_octave - 1):
            offsets.append(pos)
            ext_levels.append(plan.flat_index(o, l - 1))
            oct_ids.append(o)
            level_ids.append(l - 1)
            pos += h * w
    return offsets, ext_levels, oct_ids, level_ids, pos


class _Plan:
    """A pyramid plan and its tables on the device."""

    def __init__(self, plan: PyramidPlan, device: torch.device,
                 border: int):
        self.plan = plan
        offs, hs, ws = plan.level_dims_padded()

        def dev(a, dtype=torch.int32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.row_offsets, self.heights, self.widths = dev(offs), dev(hs), \
            dev(ws)
        self.sigma_pixdist = dev(plan.sigma_pixdist_table(), torch.float32)
        det_offsets, ext, octs, lvls, self.total = _detection_tables(plan)
        self.det_offsets = dev(det_offsets, torch.int64)
        self.ext_levels = dev(ext, torch.int64)
        self.oct_ids = dev(octs, torch.int64)
        self.level_ids = dev(lvls, torch.int64)
        self.refine_tables = RefineTables(
            self.det_offsets, self.ext_levels, self.row_offsets,
            self.heights, self.widths,
            *RefineTables.level_tables(plan, device))
        # Per octave: its first entry in the response vector and h * w.
        n_centers = plan.levels_per_octave - 2
        self.octaves = [(det_offsets[o * n_centers], h * w)
                        for o, (h, w) in enumerate(plan.octave_shapes)]
        # Per octave: its first pixel among all octaves' pixels (the
        # OnePassSIR shape fields).
        sizes = [h * w for h, w in plan.octave_shapes]
        self.field_offsets = dev(np.cumsum([0] + sizes[:-1]), torch.int64)
        self.border = border
        self._device = device
        self._border_masks = None

    @property
    def border_masks(self) -> list:
        """Each octave's border mask (the plain stencil's), made once."""
        if self._border_masks is None:
            self._border_masks = [
                border_mask(h, w, self.border, device=self._device)
                for h, w in self.plan.octave_shapes]
        return self._border_masks

    @property
    def tables(self):
        return self.row_offsets, self.heights, self.widths


class ScaleSpaceAffinePatchExtractor:
    """Image -> (LAFs, responses[, patches, descriptors]).

    ``shape_net``, ``ori_net`` and ``desc_net`` are ``nn.Module``s on
    (N, PS, PS) patches (models/zoo.py), moved to ``device``; with
    ``config.fast`` the extractor keeps bf16 copies of the nets that have
    ``with_dtype``.  ``shape_net`` and ``ori_net`` default to the
    handcrafted estimators at PS 19.  ``use_kernels=False`` runs every
    stage through the kernels' plain versions, on any device (the nets
    too, under the flat layout): it is the yardstick the kernels are held
    against.
    """

    def __init__(self, config: DetectorConfig = DetectorConfig(),
                 shape_net: Optional[nn.Module] = None,
                 desc_net: Optional[nn.Module] = None,
                 device="cuda", use_kernels: bool = True,
                 ori_net: Optional[nn.Module] = None):
        self.cfg = config
        self.device = resolve_device(device)

        def prepare(net):
            if net is None:
                return None
            if config.fast and hasattr(net, "with_dtype"):
                net = net.with_dtype(torch.bfloat16)
            return net.to(self.device).eval()

        self.shape_net = prepare(shape_net if shape_net is not None
                                 else AffineShapeEstimator(19))
        self.ori_net = prepare(ori_net if ori_net is not None
                               else OrientationDetector(19))
        self.desc_net = prepare(desc_net)
        self.use_kernels = use_kernels
        self._plans: Dict[Tuple[int, int], _Plan] = {}

    def _plan(self, h: int, w: int) -> _Plan:
        if (h, w) not in self._plans:
            self._plans[(h, w)] = _Plan(
                make_plan(h, w, self.cfg.n_levels, self.cfg.init_sigma,
                          self.cfg.border), self.device,
                int(self.cfg.mr_size))
        return self._plans[(h, w)]

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def _responses(self, img: Tensor, p: _Plan):
        """Pyramid and detection: the row-padded level buffer and the flat
        vector of border-masked, deduplicated NMS responses (B1 per level,
        B2's stencil per octave, its dedup once)."""
        cfg, plan, uk = self.cfg, p.plan, self.use_kernels
        pyr, flat = build_flat_pyramid(img, plan, py2=cfg.py2,
                                       use_kernel=uk)
        n_centers = plan.levels_per_octave - 2
        resp = torch.empty(p.total, dtype=img.dtype, device=img.device)
        counters = torch.zeros((plan.n_octaves,
                                n_counters(plan.levels_per_octave)),
                               dtype=torch.int32, device=img.device)
        plain = not (uk and img.is_cuda)
        for o, (off, hw) in enumerate(p.octaves):
            h, w = plan.octave_shapes[o]
            resp_o = resp[off:off + n_centers * hw].view(n_centers, h, w)
            detect_stencil(pyr[o], plan.sigmas[o], cfg.effective_th,
                           p.border, resp_o, counters[o],
                           bmask=p.border_masks[o] if plain else None,
                           use_kernel=uk)
        dedup(resp, counters, p.octaves, use_kernel=uk)
        return flat, resp

    def _multiscale_detect(self, img: Tensor, p: _Plan,
                           capped: bool = False) -> Dict[str, Tensor]:
        """Pyramid + per-octave detection + global top-k; threshold mode
        keeps every survivor in scan order instead (none: one invalid
        candidate, so the stages keep their shapes), or with ``capped``
        the ``max_keypoints`` strongest in top-k order.  (sigma, y, x) are
        computed at the kept indices only (B2's refine)."""
        cfg = self.cfg
        flat, resp_all = self._responses(img, p)
        survivor = resp_all > 0
        n_detected = survivor.sum()
        if cfg.threshold_mode and capped:
            # JAX's program top-k's max_keypoints entries, zero responses
            # (invalid) past the survivors: the same valid set and order.
            k = max(1, min(cfg.max_keypoints, int(n_detected)))
            vals, idxs, valid = masked_topk(resp_all, k,
                                            use_kernel=self.use_kernels)
        elif cfg.threshold_mode:
            idxs = torch.nonzero(survivor)[:, 0]
            if idxs.numel() == 0:
                idxs = torch.zeros(1, dtype=idxs.dtype, device=idxs.device)
            vals, valid = resp_all[idxs], survivor[idxs]
        else:
            vals, idxs, valid = masked_topk(
                resp_all, min(cfg.prefilter_count(), p.total),
                use_kernel=self.use_kernels)
        sc_y_x = refine(flat, idxs, p.refine_tables, cfg.effective_th,
                        use_kernel=self.use_kernels)
        det_lvl = torch.searchsorted(p.det_offsets, idxs, right=True) - 1
        return {
            "flat": flat,
            "resp": vals,
            "lafs": sc_y_x_to_lafs(sc_y_x),       # normalized coords
            "valid": valid,
            "orig_idx": idxs,
            "ext_level": p.ext_levels[det_lvl],
            "oct_idx": p.oct_ids[det_lvl],
            "level_idx": p.level_ids[det_lvl],
            "n_detected": n_detected,
        }

    def _affine_shape(self, cand: Dict[str, Tensor],
                      p: _Plan) -> Dict[str, Tensor]:
        """num_baum_iters shape-CNN compositions, the eig-ratio/boundary
        gate and the final top-k."""
        cfg = self.cfg
        lafs0 = cand["lafs"]
        lafs_cur = lafs0
        n = lafs0.shape[0]
        base_A = torch.eye(2, dtype=lafs0.dtype,
                           device=lafs0.device).expand(n, 2, 2)
        overflow = 0
        for _ in range(cfg.num_baum_iters):
            patches, ovf = extract_patches_pyramid(
                cand["flat"], lafs_cur, cand["ext_level"], *p.tables,
                ps=self.shape_net.ps, align_corners=cfg.align_corners,
                use_kernel=self.use_kernels, bf16=cfg.fast)
            overflow += ovf
            A = self.shape_net(patches, use_kernels=self.use_kernels)
            base_A = A @ base_A
            lafs_cur = torch.cat([base_A @ lafs0[:, :, 0:2],
                                  lafs0[:, :, 2:]], dim=2)
        l1, l2 = eig2x2_vals(base_A)
        ratio = torch.abs(l1 / (l2 + 1e-8))
        gate = ((ratio < 6.0) & (ratio > 1.0 / 6.0)
                & check_touch_boundary(lafs_cur) & cand["valid"])
        resp_masked = cand["resp"] * gate.to(cand["resp"].dtype)
        if cfg.threshold_mode:
            # Keep every survivor that passes the gate; no re-top-k.
            sel = torch.arange(n, device=lafs0.device)
            resp_out, valid_out = resp_masked, gate & (cand["resp"] > 0)
        else:
            resp_out, sel, valid_out = masked_topk(
                resp_masked, min(cfg.final_count(), n),
                use_kernel=self.use_kernels)
        # Gate-failed LAFs can be arbitrarily elongated; zero them.
        lafs_cur = torch.where(gate[:, None, None], lafs_cur,
                               torch.zeros_like(lafs_cur))
        out = {k: cand[k][sel] for k in
               ("orig_idx", "ext_level", "oct_idx", "level_idx")}
        return {**cand, **out, "resp": resp_out, "lafs": lafs_cur[sel],
                "valid": valid_out, "n_overflow": overflow}

    def _orientation(self, cand: Dict[str, Tensor],
                     p: _Plan) -> Dict[str, Tensor]:
        """Orientation-net patches at the extraction level (the "ori"
        site), and the net's rotation composed on the right of each
        shape."""
        cfg = self.cfg
        patches, ovf = extract_patches_pyramid(
            cand["flat"], cand["lafs"], cand["ext_level"], *p.tables,
            ps=self.ori_net.ps, align_corners=cfg.align_corners,
            use_kernel=self.use_kernels, bf16=cfg.fast)
        rot = self.ori_net(patches, use_kernels=self.use_kernels)
        lafs = torch.cat([cand["lafs"][:, :, :2] @ rot,
                          cand["lafs"][:, :, 2:]], dim=2)
        return {**cand, "lafs": lafs,
                "n_overflow": cand.get("n_overflow", 0) + ovf}

    def _sort_for_describe(self, cand: Dict[str, Tensor], p: _Plan,
                           h: int, w: int) -> Dict[str, Tensor]:
        """Order the candidates by ascending descriptor-sample extent (the
        TPU sampler's bucket order, kept for stage-by-stage parity) and
        carry ``restore``, the inverse permutation."""
        cfg = self.cfg
        dlafs = denormalize_lafs(cand["lafs"], w, h)
        lvl = select_levels_for_lafs(dlafs, p.sigma_pixdist, cfg.patch_size)
        eu, ev = sample_extents(cand["lafs"], lvl, p.heights, p.widths,
                                cfg.patch_size, cfg.align_corners)
        order = torch.argsort(torch.maximum(eu, ev), stable=True)
        perm = {k: cand[k][order] for k in
                ("lafs", "resp", "valid", "orig_idx", "ext_level",
                 "oct_idx", "level_idx")}
        return {**cand, **perm, "desc_level": lvl[order],
                "restore": torch.argsort(order)}

    def _describe(self, cand: Dict[str, Tensor], p: _Plan):
        """Descriptor patches at the selected levels + descriptor CNN."""
        patches, ovf = extract_patches_pyramid(
            cand["flat"], cand["lafs"], cand["desc_level"], *p.tables,
            ps=self.cfg.patch_size, align_corners=self.cfg.align_corners,
            use_kernel=self.use_kernels, bf16=self.cfg.fast)
        descs = self.desc_net(patches, use_kernels=self.use_kernels)
        if self.cfg.desc_dtype is not None:
            descs = descs.to(getattr(torch, self.cfg.desc_dtype))
        return patches, descs, ovf

    # ------------------------------------------------------------------
    # Host API
    # ------------------------------------------------------------------

    @float32_math()
    def run(self, img: Tensor, describe: bool = False,
            do_ori: bool = False, capped: bool = False) -> Dict[str, Tensor]:
        """The whole pipeline on an (H, W) float32 tensor on ``device``:
        fixed-size outputs plus ``valid`` and ``restore``, on the device.
        ``capped``: threshold mode keeps the ``max_keypoints`` strongest
        survivors (module docstring)."""
        cfg = self.cfg
        h, w = img.shape
        p = self._plan(h, w)
        cand = self._multiscale_detect(img, p, capped)
        # LAF A *= mrSize (the measurement region).
        cand["lafs"] = torch.cat([cfg.mr_size * cand["lafs"][:, :, 0:2],
                                  cand["lafs"][:, :, 2:]], dim=2)
        if cfg.num_baum_iters > 0:
            cand = self._affine_shape(cand, p)
        if do_ori:
            cand = self._orientation(cand, p)
        if describe:
            cand = self._sort_for_describe(cand, p, h, w)
        out = {k: cand[k] for k in ("resp", "valid", "orig_idx", "oct_idx",
                                    "level_idx", "n_detected")}
        out["lafs"] = denormalize_lafs(cand["lafs"], w, h)
        out["n_overflow"] = cand.get("n_overflow", 0)
        if describe:
            out["patches"], out["descs"], ovf = self._describe(cand, p)
            out["n_overflow"] += ovf
            out["restore"] = cand["restore"]
        return out

    @torch.inference_mode()
    def __call__(self, img, describe: bool = False, do_ori: bool = False,
                 capped: bool = False) -> Dict[str, np.ndarray]:
        """Run the pipeline on an (H, W) grayscale image (numpy or tensor).
        Returns host arrays of the VALID keypoints in reference order (top-k
        order; scan order in threshold mode, top-k order with ``capped``),
        plus ``n_detected``, like the JAX extractor."""
        img = torch.as_tensor(np.asarray(img, np.float32)
                              if not torch.is_tensor(img) else img,
                              dtype=torch.float32).to(self.device)
        out = self.run(img.contiguous(), describe=describe, do_ori=do_ori,
                       capped=capped)
        n_detected = int(out.pop("n_detected"))
        n_overflow = out.pop("n_overflow")
        if n_overflow:
            warnings.warn(f"patch gather: {n_overflow} overflowed patches")
        restore = out.pop("restore", None)
        if restore is not None:
            out = {k: v[restore] for k, v in out.items()}
        valid = out.pop("valid")
        res = {k: v[valid].cpu().numpy() for k, v in out.items()}
        for k in ("orig_idx", "oct_idx", "level_idx"):
            res[k] = res[k].astype(np.int32)
        res["n_detected"] = n_detected
        return check_finite(res, "the extractor's output")


# The JAX package's other name for the extractor.
HessAffNetPipeline = ScaleSpaceAffinePatchExtractor
