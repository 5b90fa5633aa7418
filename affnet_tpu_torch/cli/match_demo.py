"""Two-image wide-baseline matching demo: detect -> describe -> SNN match
-> draw the correspondences.

Counterpart of ``affnet_tpu/cli/match_demo.py`` (reference:
examples/hesaffnet/'WBS demo.ipynb': detect, describe, SNN-0.8 brute-force
match, visualization), with its flags and settings: 2000 features (top-k),
mrSize 5.192, border 5, one AffNetFast shape iteration (the shipped
weights), PS 32, SIFT or HardNet descriptors, ``--do-ori`` adds
OriNetFast32 (the shipped OriNetFast weights).  Runs on the card unless
``--device cpu`` asks for the CPU.

HardNet without ``--desc-weights`` is initialized from the port's own
seeded init (``models.cnn.init_params``, seed 0), as in ``extract_geom``:
its weights are not the ones JAX's ``PRNGKey(0)`` gives.

:func:`match_images` does the work; :func:`draw_matches` writes the side by
side image with matplotlib, imported in the call.  Images are read as the
RGB mean in [0, 255] with PIL; a ``.npy`` file is read with numpy.

Usage: python -m affnet_tpu_torch.cli.match_demo img1.png img2.png out.png
       [--nfeats 2000] [--snn 0.8] [--do-ori] [--descriptor SIFT|HardNet]
       [--desc-weights x.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np

from ..detector import DetectorConfig, ScaleSpaceAffinePatchExtractor
from ..match import snn_match_host
from ..models import AffNetFast, OriNetFast32
from . import pretrained
from .extract_geom import make_descriptor
from .hesaffnet import load_gray


def make_extractor(nfeats: int = 2000, do_ori: bool = False,
                   descriptor: str = "SIFT",
                   desc_weights: Optional[str] = None, device="cuda",
                   use_kernels: bool = True
                   ) -> ScaleSpaceAffinePatchExtractor:
    """The demo's extractor."""
    cfg = DetectorConfig(num_features=nfeats, border=5, mr_size=5.192,
                         num_baum_iters=1, th=None, patch_size=32)
    return ScaleSpaceAffinePatchExtractor(
        cfg, shape_net=pretrained(AffNetFast(), "AffNetFast"),
        ori_net=pretrained(OriNetFast32(), "OriNetFast") if do_ori else None,
        desc_net=make_descriptor(descriptor, desc_weights), device=device,
        use_kernels=use_kernels)


def match_images(det: ScaleSpaceAffinePatchExtractor, img1: np.ndarray,
                 img2: np.ndarray, snn: float = 0.8, do_ori: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Detect and describe both images, SNN-match on the extractor's
    device: (t1, t2, pts1, pts2), the tentative matches' indices into each
    image's keypoints and their centres in pixels."""
    out1 = det(img1, do_ori=do_ori, describe=True)
    out2 = det(img2, do_ori=do_ori, describe=True)
    t1, t2 = snn_match_host(out1["descs"], out2["descs"], snn,
                            device=det.device)
    return t1, t2, out1["lafs"][t1][:, :, 2], out2["lafs"][t2][:, :, 2]


def draw_matches(img1, img2, pts1, pts2, out_path) -> None:
    """Both images side by side with a line per match, saved as
    ``out_path`` (matplotlib, imported here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h1, w1 = img1.shape
    h2, w2 = img2.shape
    canvas = np.zeros((max(h1, h2), w1 + w2), np.float32)
    canvas[:h1, :w1] = img1
    canvas[:h2, w1:] = img2
    plt.figure(figsize=(14, 7))
    plt.imshow(canvas, cmap="gray")
    for (x1, y1), (x2, y2) in zip(pts1, pts2):
        plt.plot([x1, x2 + w1], [y1, y2], "-", linewidth=0.5)
    plt.plot(pts1[:, 0], pts1[:, 1], "r.", markersize=2)
    plt.plot(pts2[:, 0] + w1, pts2[:, 1], "r.", markersize=2)
    plt.axis("off")
    plt.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("image1")
    parser.add_argument("image2")
    parser.add_argument("output_image")
    parser.add_argument("--nfeats", type=int, default=2000)
    parser.add_argument("--snn", type=float, default=0.8)
    parser.add_argument("--do-ori", action="store_true")
    parser.add_argument("--descriptor", default="SIFT",
                        choices=["SIFT", "HardNet"])
    parser.add_argument("--desc-weights", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    det = make_extractor(args.nfeats, args.do_ori, args.descriptor,
                         args.desc_weights, args.device)
    img1 = load_gray(args.image1)
    img2 = load_gray(args.image2)
    t1, _, pts1, pts2 = match_images(det, img1, img2, args.snn, args.do_ori)
    print(f"{len(t1)} tentative matches")
    draw_matches(img1, img2, pts1, pts2, args.output_image)
    print(f"match visualization -> {args.output_image}")


if __name__ == "__main__":
    main()
