"""Two-view matching evaluation on the Oxford graffiti sequence.

Counterpart of ``affnet_tpu/cli/eval_graf.py``, with its flags and printed
lines.  It repeats the reference's per-epoch test(): detect -> describe ->
SNN-0.8 match -> ground-truth check under the homography (centre distance
<= 6 px) -> tentatives, true matches and inlier ratio
(train_AffNet_test_on_graffity.py:262-339).  :func:`evaluate_pair` does
the work on two images and a homography; ``main`` reads the files
(``img1.png``, ``img{i}.png``, ``H1to{i}p`` in ``--graf-dir``, by default
``test-graf`` as the reference's script reads it) and prints.  Runs on the
card unless ``--device cpu`` asks for the CPU.

The reference uses HardNet++ weights, which are not shipped; the default
descriptor is the weight-free differentiable SIFT.  ``--descriptor HardNet``
needs ``--desc-weights X.npz`` and falls back to the shipped HardTFeat
weights without them, with a note.  ``--shape-arch`` takes the AffNet nets
of the port's zoo (AffNetFast); JAX's ablation heads are not ported.

Usage: python -m affnet_tpu_torch.cli.eval_graf [--img2-idx 6]
       [--nfeats 3000] [--graf-dir DIR] [--all] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
from torch import nn

from .. import load_params_npz
from ..detector import DetectorConfig, ScaleSpaceAffinePatchExtractor
from ..match import snn_match_host
from ..models import (AffineShapeEstimator, AffNetFast, HardNet,
                      HardTFeatNet, OriNetFast32, SIFTNet, params_from_jax)
from ..models.cnn import l2norm
from ..reproj import get_gt_correspondence_indexes
from . import pretrained
from .hesaffnet import load_gray

DEFAULT_GRAF = "test-graf"
SHAPE_ARCHS = {"AffNetFast": AffNetFast}


class PixelDescriptor(nn.Module):
    """The raw patch, mean-subtracted and L2-normalized (``--descriptor
    pixels``)."""

    def forward(self, patches, use_kernels: bool = True):
        flat = patches.reshape(patches.shape[0], -1)
        return l2norm(flat - flat.mean(dim=1, keepdim=True))


def _weights(net, npz: Optional[str], name: str):
    """``net`` with the npz ``npz`` (the JAX package's layout), else the
    shipped ``weights/<name>.npz``."""
    if npz:
        net.load_state_dict(params_from_jax(load_params_npz(npz)))
        return net
    return pretrained(net, name)


def evaluate_pair(det: ScaleSpaceAffinePatchExtractor, img1: np.ndarray,
                  img2: np.ndarray, H: np.ndarray, snn: float = 0.8,
                  dist_th: float = 6.0, do_ori: bool = False,
                  save_vis: Optional[str] = None):
    """Detect and describe both images, SNN-match on the extractor's
    device, and count the tentatives whose centres fall within
    ``dist_th`` px of their match under ``H`` (image 1 -> 2).  Returns
    (tentatives, true matches, inlier ratio, t1, t2, in1): the counts, the
    tentatives' indices into each image's keypoints and the true ones'
    indices into the tentatives.  ``do_ori``: run the orientation stage.
    ``save_vis``: a directory for the true matches' LAF images
    (``inliers1.png``, ``inliers2.png``)."""
    out1 = det(img1, do_ori=do_ori, describe=True)
    out2 = det(img2, do_ori=do_ori, describe=True)
    t1, t2 = snn_match_host(out1["descs"], out2["descs"], snn,
                            device=det.device)
    if len(t1) == 0:
        return 0, 0, 0.0, t1, t2, np.zeros(0, np.int64)
    lafs1_t, lafs2_t = out1["lafs"][t1], out2["lafs"][t2]
    _, in1, _ = get_gt_correspondence_indexes(lafs1_t, lafs2_t, H,
                                              dist_threshold=dist_th)
    if save_vis:
        from ..laf import visualize_lafs
        os.makedirs(save_vis, exist_ok=True)
        visualize_lafs(img1, lafs1_t[in1], "g",
                       save_to=os.path.join(save_vis, "inliers1.png"))
        visualize_lafs(img2, lafs2_t[in1], "g",
                       save_to=os.path.join(save_vis, "inliers2.png"))
    return len(t1), len(in1), float(len(in1)) / float(len(t1)), t1, t2, in1


def make_extractor(nfeats: int = 3000, descriptor: str = "SIFT",
                   desc_weights: Optional[str] = None,
                   shape: str = "AffNetFast", shape_arch: Optional[str] = None,
                   shape_weights: Optional[str] = None, do_ori: bool = False,
                   ori_weights: Optional[str] = None, fast: bool = False,
                   device="cuda", use_kernels: bool = True
                   ) -> ScaleSpaceAffinePatchExtractor:
    """The evaluation's extractor, from the program's flags; HardNet needs
    ``desc_weights`` (no HardNet weights are shipped)."""
    if descriptor == "SIFT":
        desc_net = SIFTNet(patch_size=32)
    elif descriptor == "HardNet":
        if not desc_weights:
            raise ValueError("descriptor HardNet needs desc_weights")
        desc_net = _weights(HardNet(), desc_weights, "HardNet")
    elif descriptor == "TFeat":
        desc_net = _weights(HardTFeatNet(), desc_weights, "HardTFeatNet")
    else:
        desc_net = PixelDescriptor()
    shape_net, baum_iters = None, 0
    if shape_arch is not None:
        if shape_arch not in SHAPE_ARCHS:
            raise SystemExit(
                f"--shape-arch {shape_arch!r}: the port's zoo has "
                f"{sorted(SHAPE_ARCHS)} (JAX's ablation heads are not "
                "ported)")
        shape_net = _weights(SHAPE_ARCHS[shape_arch](), shape_weights,
                             shape_arch)
        baum_iters = 1
    elif shape == "AffNetFast":
        shape_net = _weights(AffNetFast(), shape_weights, "AffNetFast")
        baum_iters = 1
    elif shape == "Baumberg":
        shape_net = AffineShapeEstimator(19)
        baum_iters = 16
    ori_net = (_weights(OriNetFast32(), ori_weights, "OriNetFast")
               if do_ori else None)
    cfg = DetectorConfig(num_features=nfeats, border=5, mr_size=5.192,
                         num_baum_iters=baum_iters, th=None, patch_size=32,
                         fast=fast)
    return ScaleSpaceAffinePatchExtractor(cfg, shape_net=shape_net,
                                          ori_net=ori_net, desc_net=desc_net,
                                          device=device,
                                          use_kernels=use_kernels)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--graf-dir", default=DEFAULT_GRAF)
    parser.add_argument("--img2-idx", type=int, default=6)
    parser.add_argument("--all", action="store_true",
                        help="evaluate every pair 1-2 .. 1-6 and summarize")
    parser.add_argument("--nfeats", type=int, default=3000)
    parser.add_argument("--fast", action="store_true",
                        help="bf16 patch sampling and nets (float32 "
                             "detection)")
    parser.add_argument("--descriptor", default="SIFT",
                        choices=["SIFT", "HardNet", "TFeat", "pixels"])
    parser.add_argument("--desc-weights", default=None)
    parser.add_argument("--shape", default="AffNetFast",
                        choices=["AffNetFast", "Baumberg", "none"])
    parser.add_argument("--shape-arch", default=None,
                        help="an AffNet net of the port's zoo (with "
                             "--shape-weights; overrides --shape)")
    parser.add_argument("--shape-weights", default=None,
                        help=".npz weights for the shape net (e.g. a "
                             "training checkpoint)")
    parser.add_argument("--do-ori", action="store_true")
    parser.add_argument("--ori-weights", default=None,
                        help="npz checkpoint for OriNetFast32 (default: the "
                             "shipped OriNetFast weights)")
    parser.add_argument("--snn", type=float, default=0.8)
    parser.add_argument("--dist-th", type=float, default=6.0)
    parser.add_argument("--save-vis", default=None,
                        help="directory for LAF visualization PNGs")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    if args.all:
        import sys
        base = [a for a in (argv if argv is not None else sys.argv[1:])
                if a != "--all" and not a.startswith("--img2-idx")]
        rows = []
        for i in range(2, 7):
            rows.append((i, *main(base + ["--img2-idx", str(i)])))
        print("\npair  tentatives  true  inl.ratio")
        for i, t, m, r in rows:
            print(f"1-{i}   {t:9d}  {m:4d}  {r:.4f}")
        return rows

    img1 = load_gray(os.path.join(args.graf_dir, "img1.png"))
    img2 = load_gray(os.path.join(args.graf_dir, f"img{args.img2_idx}.png"))
    H = np.loadtxt(os.path.join(args.graf_dir,
                                f"H1to{args.img2_idx}p")).astype(np.float32)
    if args.descriptor == "HardNet" and not args.desc_weights:
        # HardNet++ weights are not shipped; never run random weights
        # silently: use the shipped HardTFeat weights instead.
        print("note: no --desc-weights for HardNet (HardNet++ weights are "
              "not shipped); using shipped HardTFeat weights instead")
        args.descriptor = "TFeat"
    det = make_extractor(args.nfeats, args.descriptor, args.desc_weights,
                         args.shape, args.shape_arch, args.shape_weights,
                         args.do_ori, args.ori_weights, args.fast,
                         args.device)
    n_tent, n_true, inl_ratio, _, _, _ = evaluate_pair(
        det, img1, img2, H, args.snn, args.dist_th, args.do_ori,
        args.save_vis)
    if n_tent == 0:
        print("0 tentatives 0 true matches 0.0 inl.ratio")
        return 0, 0, 0.0
    print(f"Test on graf1-{args.img2_idx}, {n_tent} tentatives "
          f"{n_true} true matches {inl_ratio:.4f} inl.ratio")
    return n_tent, n_true, inl_ratio


if __name__ == "__main__":
    main()
