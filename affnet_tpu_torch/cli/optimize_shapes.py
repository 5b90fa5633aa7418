"""Direct LAF-shape optimization demo (paper Fig. 2-3), on the card.

Counterpart of ``affnet_tpu/cli/optimize_shapes.py`` with the same
arguments and defaults (reference:
examples/direct_shape_optimization/optimization_script.py:119-348): detect
LAFs on an image pair, pick GT-corresponding pairs under a known
homography, then optimize the 2x2 shape parts with Adam against a
descriptor loss, writing the loss/shape-difference histories (npz, readable
by the JAX package) and an animation of the converging ellipses (mp4 when
ffmpeg is available, else gif).

Two ways to get the second LAF set (the reference script uses `shear`):
  --mode shear        LAFs2 = LAFs1 with a21 := 0.3 * a11 (the reference's
                      synthetic corruption)
  --mode detect-both  detect independently in both images, keep GT pairs

Usage:
  python -m affnet_tpu_torch.cli.optimize_shapes \\
      [img1 img2 H] [--descriptor TFeat] [--loss HardNegC] \\
      [--steps 100] [--lr 2.0] [--out runs/shape_opt] [--device cuda]

Sizes: the patch size is 32 (the sampler kernels take any PS >= 2) and the
pyramid has one level per octave; ``--nfeats`` is any count the detector's
top-k takes.  Reading images needs PIL, the animation matplotlib.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

# The graf pair of the reference repository (img1.png, img2.png, H1to2p),
# the default input; AFFNET_GRAF_DIR points at it.
DEFAULT_GRAF = os.environ.get("AFFNET_GRAF_DIR", "test-graf")

PS = 32


def detector_config(nfeats: int):
    """The reference script's detector (optimization_script.py:291-292):
    mrSize 5.12, border 32, no shape iteration."""
    from ..detector import DetectorConfig
    return DetectorConfig(num_features=nfeats, border=32, mr_size=5.12,
                          num_baum_iters=0)


def gt_pairs(det, img1: np.ndarray, img2: np.ndarray, H: np.ndarray,
             mode: str, dist_th: float) -> Tuple[np.ndarray, np.ndarray, int]:
    """Detect, form the second LAF set (``mode``), and keep the pairs
    whose centers correspond under H.  Returns (lafs1, lafs2, number of
    detections), LAFs in pixels."""
    from ..reproj import get_gt_correspondence_indexes
    lafs1 = det(img1)["lafs"]
    if mode == "shear":
        lafs2 = lafs1.copy()
        lafs2[:, 1, 0] = 0.3 * lafs2[:, 0, 0]
    else:
        lafs2 = det(img2)["lafs"]
    # The reference's names: the second array enumerates rows of lafs1,
    # the third indexes lafs2; its script reads them crossed.
    _, idx2rows, idx1 = get_gt_correspondence_indexes(
        lafs1, lafs2, H, dist_threshold=dist_th)
    return lafs1[idx1], lafs2[idx2rows], len(lafs1)


def make_descriptor(name: str, weights: Optional[str] = None,
                    device: Any = "cuda") -> Callable[[torch.Tensor],
                                                      torch.Tensor]:
    """(N, 32, 32) patches -> (N, D) descriptors, differentiable in the
    patches: SIFT, TFeat (HardTFeatNet, pretrained unless ``weights``),
    HardNet (needs ``weights``) or pixels."""
    from .. import load_params_npz, load_pretrained, resolve_device
    from ..models import HardNet, HardTFeatNet, params_from_jax
    from ..models.cnn import l2norm
    if name == "SIFT":
        from ..models.sift import sift_describe
        return lambda p: sift_describe(p, PS)
    if name in ("TFeat", "HardNet"):
        if name == "HardNet" and not weights:
            raise SystemExit("--descriptor HardNet needs --desc-weights "
                             "(HardNet++ weights are not in the repo)")
        net = HardTFeatNet() if name == "TFeat" else HardNet()
        tree = (load_params_npz(weights) if weights
                else load_pretrained("HardTFeatNet"))
        net.load_state_dict(params_from_jax(tree))
        return net.to(resolve_device(device)).eval().requires_grad_(False)
    if name == "pixels":
        def pixels(p: torch.Tensor) -> torch.Tensor:
            flat = p.reshape(p.shape[0], -1)
            return l2norm(flat - flat.mean(dim=1, keepdim=True))
        return pixels
    raise ValueError(f"unknown descriptor {name!r}")


def loss_fn(name: str) -> Callable:
    from ..losses import descriptor_dist, loss_hardnegc, loss_hardnet
    return {"HardNegC": loss_hardnegc, "HardNet": loss_hardnet,
            "PosDist": descriptor_dist}[name]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("img1", nargs="?",
                        default=os.path.join(DEFAULT_GRAF, "img1.png"))
    parser.add_argument("img2", nargs="?", default=None,
                        help="default: img1 for --mode shear, graf img2 for "
                             "detect-both")
    parser.add_argument("H", nargs="?", default=None,
                        help="homography file; default: identity for "
                             "--mode shear, H1to2p for detect-both")
    parser.add_argument("--mode", default="shear",
                        choices=["shear", "detect-both"])
    parser.add_argument("--nfeats", type=int, default=200,
                        help="detected features (reference: 200)")
    parser.add_argument("--descriptor", default="SIFT",
                        choices=["SIFT", "TFeat", "HardNet", "pixels"])
    parser.add_argument("--desc-weights", default=None,
                        help=".npz weights (JAX layout) for TFeat or "
                             "HardNet")
    parser.add_argument("--loss", default="HardNegC",
                        choices=["HardNegC", "HardNet", "PosDist"])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=2.0,
                        help="Adam lr (reference: 2.0)")
    parser.add_argument("--dist-th", type=float, default=1.0,
                        help="GT center-distance gate (reference: 1)")
    parser.add_argument("--out", default="runs/shape_opt",
                        help="output prefix: <out>.npz, <out>.mp4|gif")
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    args = parser.parse_args(argv)

    from ..detector import ScaleSpaceAffinePatchExtractor
    from ..shape_opt import LAFShapeOptimizer, render_history, save_history
    from .hesaffnet import load_gray

    if args.img2 is None:
        args.img2 = (args.img1 if args.mode == "shear"
                     else os.path.join(DEFAULT_GRAF, "img2.png"))
    img1 = load_gray(args.img1)
    img2 = load_gray(args.img2)
    if args.H is not None:
        H = np.loadtxt(args.H).astype(np.float32)
    elif args.mode == "shear":
        H = np.eye(3, dtype=np.float32)
    else:
        H = np.loadtxt(os.path.join(DEFAULT_GRAF, "H1to2p")).astype(
            np.float32)

    det = ScaleSpaceAffinePatchExtractor(detector_config(args.nfeats),
                                         device=args.device)
    lafs1_m, lafs2_m, n_det = gt_pairs(det, img1, img2, H, args.mode,
                                       args.dist_th)
    print(f"{n_det} detections -> {len(lafs1_m)} GT pairs "
          f"(dist <= {args.dist_th})")
    if len(lafs1_m) < 2:
        raise SystemExit("not enough GT pairs to optimize; raise --dist-th "
                         "or use --mode shear")

    opt = LAFShapeOptimizer(
        descriptor=make_descriptor(args.descriptor, args.desc_weights,
                                   args.device),
        loss_fn=loss_fn(args.loss), lr=args.lr, patch_size=PS,
        device=args.device)
    hist = opt.optimize(lafs1_m, lafs2_m, img1, img2, n_iters=args.steps)
    print(f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}, "
          f"shape diff {hist['shape_diff'][0]:.4f} -> "
          f"{hist['shape_diff'][-1]:.4f} over {args.steps} steps")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_history(hist, args.out + ".npz")
    anim = render_history(hist, img1, args.out + ".mp4", fps=args.fps)
    print(f"history -> {args.out}.npz, animation -> {anim}")
    return hist


if __name__ == "__main__":
    main()
