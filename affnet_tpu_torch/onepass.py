"""OnePassSIR: the one-pass extractor whose affine shapes come from a dense
AffNet.

Counterpart of ``affnet_tpu/onepass.py``.  The detector skeleton is the
base extractor's, but each octave's shape field is the dense AffNet
(``models/dense.py``) run once on the octave's level 0, and a keypoint's
shape is read from that field at its pixel: there is no Baumberg loop.
Before the selection, a survivor whose LAF at 3x its extent leaves the
image is dropped (``_dense_boundary_ok``).

The keypoints are those of JAX's per-level chain (responses, NMS, border
mask, ``update_octave_map``, the gate, one global top-k), computed by the
port's kernels:

1. B1 builds the pyramid and B2's stencil and dedup give the response
   vector, as in the base extractor (``_responses``).
2. B2's refine computes (sigma, y, x) at every survivor (``torch.nonzero``
   of the vector), where the gate needs them, and the gate zeroes the
   responses of the survivors it drops.
3. Top-k mode writes the gated responses back into the whole vector and
   runs ``masked_topk`` on it (B3 at the sizes where JAX's two-stage top-k
   runs, so ties fall to the lowest index as there); (sigma, y, x) at the
   kept indices come from a second refine there, the same kernel on the
   same entries.  Threshold mode keeps every gated survivor in scan order,
   as JAX's output does after its cap retry.

``n_detected`` counts the gated survivors, as JAX's does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .detector import DetectorConfig, ScaleSpaceAffinePatchExtractor, _Plan
from .laf import sc_y_x_and_A_to_lafs
from .models.dense import AffNetFastFullConv
from .ops.cuda_detect import refine
from .ops.nms import masked_topk
from .ops.scalespace import pyramid_views

Tensor = torch.Tensor


def _dense_boundary_ok(sc: Tensor, yy: Tensor, xx: Tensor, A: Tensor,
                       factor: float) -> Tensor:
    """Whether the LAF [factor * sc * A | (x, y)] (normalized coordinates)
    keeps the four corners of its unit square inside [0, 1]^2; sc, yy, xx
    of any shape S, A of shape S + (2, 2)."""
    a = factor * sc[..., None, None] * A
    ok = torch.ones(sc.shape, dtype=torch.bool, device=sc.device)
    for cx in (-1.0, 1.0):
        for cy in (-1.0, 1.0):
            px = a[..., 0, 0] * cx + a[..., 0, 1] * cy + xx
            py = a[..., 1, 0] * cx + a[..., 1, 1] * cy + yy
            ok &= (px >= 0.0) & (px <= 1.0) & (py >= 0.0) & (py <= 1.0)
    return ok


class OnePassSIR(ScaleSpaceAffinePatchExtractor):
    """The extractor with a dense shape field.  ``shape_net`` is a dense
    AffNet ((N, h, w) image -> (N, h, w, 4)), by default
    :class:`AffNetFastFullConv` with the shipped AffNetFast weights;
    ``ori_net`` and ``desc_net`` as in the base extractor.  ``use_kernels``
    and ``device`` as there."""

    def __init__(self, config: DetectorConfig = DetectorConfig(),
                 shape_net: Optional[nn.Module] = None,
                 desc_net: Optional[nn.Module] = None,
                 device="cuda", use_kernels: bool = True,
                 ori_net: Optional[nn.Module] = None):
        super().__init__(
            config, shape_net=(shape_net if shape_net is not None
                               else AffNetFastFullConv.pretrained()),
            desc_net=desc_net, device=device, use_kernels=use_kernels,
            ori_net=ori_net)

    def shape_fields(self, p: _Plan, flat: Tensor) -> Tensor:
        """Every octave's dense shape field on its level 0, flattened and
        concatenated: row ``p.field_offsets[o] + y * w + x`` holds octave
        o's (a11, a12, a21, a22) at pixel (y, x)."""
        fields = []
        for levels in pyramid_views(flat, p.plan):
            h, w = levels.shape[1:]
            fields.append(self.shape_net(
                levels[0].contiguous(),
                use_kernels=self.use_kernels).reshape(h * w, 4))
        return torch.cat(fields)

    def _shapes_at(self, p: _Plan, fields: Tensor, idxs: Tensor) -> Tensor:
        """(N, 4) shapes at entries ``idxs`` of the response vector."""
        d = torch.searchsorted(p.det_offsets, idxs, right=True) - 1
        pix = idxs - p.det_offsets[d]
        return fields[p.field_offsets[p.oct_ids[d]] + pix]

    def _multiscale_detect(self, img: Tensor, p: _Plan,
                           capped: bool = False) -> Dict[str, Tensor]:
        """Pyramid, detection, the dense shape fields and the 3x boundary
        gate, then the selection (module docstring); ``capped`` as in the
        base extractor."""
        cfg, uk = self.cfg, self.use_kernels
        flat, resp_all = self._responses(img, p)
        fields = self.shape_fields(p, flat)
        surv = torch.nonzero(resp_all > 0)[:, 0]
        sc_y_x = refine(flat, surv, p.refine_tables, cfg.effective_th,
                        use_kernel=uk)
        ok = _dense_boundary_ok(
            sc_y_x[:, 0], sc_y_x[:, 1], sc_y_x[:, 2],
            self._shapes_at(p, fields, surv).reshape(-1, 2, 2), 3.0)
        resp_all[surv] = resp_all[surv] * ok.to(resp_all.dtype)
        n_detected = ok.sum()
        if cfg.threshold_mode and not capped:
            idxs = surv[ok]
            sc_y_x = sc_y_x[ok]
            if idxs.numel() == 0:
                idxs = torch.zeros(1, dtype=surv.dtype, device=surv.device)
                sc_y_x = torch.zeros((1, 3), dtype=flat.dtype,
                                     device=flat.device)
            vals = resp_all[idxs]
            valid = vals > 0
        else:
            k = (max(1, min(cfg.max_keypoints, int(n_detected)))
                 if cfg.threshold_mode
                 else min(cfg.prefilter_count(), p.total))
            vals, idxs, valid = masked_topk(resp_all, k, use_kernel=uk)
            sc_y_x = refine(flat, idxs, p.refine_tables, cfg.effective_th,
                            use_kernel=uk)
        lafs = sc_y_x_and_A_to_lafs(sc_y_x, self._shapes_at(p, fields, idxs))
        det_lvl = torch.searchsorted(p.det_offsets, idxs, right=True) - 1
        return {
            "flat": flat,
            "resp": vals,
            "lafs": lafs,
            "valid": valid,
            "orig_idx": idxs,
            "ext_level": p.ext_levels[det_lvl],
            "oct_idx": p.oct_ids[det_lvl],
            "level_idx": p.level_ids[det_lvl],
            "n_detected": n_detected,
        }

    def _affine_shape(self, cand: Dict[str, Tensor],
                      p: _Plan) -> Dict[str, Tensor]:
        """No Baumberg loop: the shapes are the dense field's."""
        return cand
