"""Train AffNet on Brown/PhotoTour patch pairs (with a per-epoch graf eval).

Counterpart of ``affnet_tpu/cli/train_affnet.py`` with its flags
(reference: train_AffNet_test_on_graffity.py, flags :49-97, run_me.sh:9):
--dataroot --log-dir --epochs --batch-size --n-pairs --lr --wd
--descriptor {pixels,SIFT,HardNet,TFeat} --loss
{HardNet,HardNegC,PosDist,random_sampling} --arch --resume --seed, and
--synthetic, which trains on offline synthetic patch classes when no
dataset exists.  Runs on the card unless ``--device cpu`` asks for the
CPU.

``--mesh N`` (N >= 1) shards each batch over N ranks, one card each,
under NCCL (``parallel.spawn``; ``--device cpu``: N CPU ranks over gloo),
with the one-device step's semantics on the global batch (hardest
negatives over the global batch, global BatchNorm statistics); rank 0
writes the logs and checkpoints.  N = 1 runs in this process, in a group
of one.  N above the cards present is refused.  ``--arch`` takes every
AffNet of the zoo, as JAX's: AffNetFast and the ten ablation variants;
a name with "Rot" draws each positive's rotation apart from its
anchor's.

Usage: python -m affnet_tpu_torch.cli.train_affnet --dataroot dataset/6Brown \\
          --lr 0.005 --n-pairs 10000000 --batch-size 1024 \\
          --descriptor HardNet --desc-weights hardnet.npz --arch AffNetFast \\
          --loss HardNegC --epochs 20
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import data as D
from .. import load_params_npz, load_pretrained, parallel
from ..models import REGISTRY, AffNet
from ..train import TrainConfig, load_checkpoint, save_checkpoint, train_loop
from . import eval_graf


MESH_HELP = ("shard each batch over N ranks, one card each (NCCL; gloo "
             "CPU ranks with --device cpu); 0: no process group")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataroot", type=str, default="datasets/")
    p.add_argument("--log-dir", default="./logs")
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--total-epochs", type=int, default=0,
                   help="epochs spanned by the LR decay when a run is "
                        "split into resumed chunks (0 = --epochs)")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--n-pairs", type=int, default=500000)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--wd", default=1e-4, type=float)
    p.add_argument("--expname", default="", type=str)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--descriptor", type=str, default="pixels",
                   choices=["pixels", "SIFT", "HardNet", "TFeat"])
    p.add_argument("--desc-weights", default=None)
    p.add_argument("--loss", type=str, default="HardNet",
                   choices=["HardNet", "HardNegC", "PosDist",
                            "random_sampling"])
    p.add_argument("--arch", type=str, default="AffNetFast")
    p.add_argument("--mesh", type=int, default=0, help=MESH_HELP)
    p.add_argument("--synthetic", action="store_true",
                   help="train on offline synthetic pairs (no dataset needed)")
    p.add_argument("--gen-tilt", type=float, default=3.0,
                   help="synthetic generator: max anisotropic view tilt")
    p.add_argument("--gen-mesh", type=float, default=0.0,
                   help="synthetic generator: non-planar mesh-warp "
                        "amplitude in px (curved-surface parallax)")
    p.add_argument("--gen-blur", type=float, default=0.0,
                   help="synthetic generator: max per-view Gaussian blur "
                        "sigma (cross-view defocus mismatch)")
    p.add_argument("--gen-classes", type=int, default=8192,
                   help="synthetic generator: number of patch classes "
                        "(distinct anchor locations across source images)")
    p.add_argument("--gen-views", type=int, default=6,
                   help="synthetic generator: views per class (more views "
                        "= more distinct correspondences per anchor)")
    p.add_argument("--conv-vjp", choices=["xla", "explicit"], default="xla",
                   help="accepted for the JAX command line's sake; no "
                        "effect: autograd computes the conv backward")
    p.add_argument("--host-data", action="store_true",
                   help="build batches on the host and upload each one "
                        "instead of the device-resident patch store")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--no-vis", action="store_true",
                   help="skip the per-epoch LAF overlay PNGs in the log dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    return p


def run_ranks(args, rank_main, argv):
    """``--mesh N`` >= 1: ``rank_main(rank, device, group, argv)`` on N
    ranks (``parallel.spawn``), one card each, or CPU ranks under
    ``--device cpu``; returns rank 0's training state.  N above the cards
    present is refused."""
    if torch.device(args.device).type == "cuda":
        count = torch.cuda.device_count()
        if args.mesh > count:
            raise SystemExit(
                f"--mesh {args.mesh}: one card per rank, but {count} CUDA "
                "cards are present (pass --device cpu for CPU ranks)")
    argv = sys.argv[1:] if argv is None else list(argv)
    return parallel.spawn(rank_main, args.mesh, args.device, args=(argv,))


def rank_args(parser, argv, device):
    """A rank's arguments: ``argv`` parsed, on the rank's ``device``."""
    args = parser.parse_args(argv)
    args.device = str(device)
    return args


def net_for(arch: str, kind: type, trainer: str):
    """A fresh ``REGISTRY[arch]`` net, refused unless it is a ``kind``."""
    names = sorted(n for n, c in REGISTRY.items() if issubclass(c, kind))
    if arch not in names:
        raise SystemExit(f"--arch {arch!r}: the port's {trainer} trains "
                         f"{names}")
    return REGISTRY[arch]()


def make_dataset(args):
    if args.synthetic:
        imgs = D.load_train_images()
        if imgs:
            # Multi-image, tilt-diverse, photometrically-jittered classes
            # from the reference's images other than the test scene.
            patches, labels = D.synthetic_pairs_from_images(
                imgs, n_classes=getattr(args, "gen_classes", 8192),
                views_per_class=getattr(args, "gen_views", 6),
                seed=args.seed,
                max_tilt=getattr(args, "gen_tilt", 3.0),
                mesh_warp=getattr(args, "gen_mesh", 0.0),
                blur_jitter=getattr(args, "gen_blur", 0.0))
        else:
            from PIL import Image
            img = np.mean(np.asarray(Image.open(os.path.join(
                eval_graf.DEFAULT_GRAF, "img1.png")).convert("RGB")), axis=2)
            patches, labels = D.synthetic_pairs_from_image(
                img, n_classes=2048, views_per_class=4, seed=args.seed)
    else:
        patches, labels = D.load_total_datasets(args.dataroot)
    # The random-sampling loss needs explicit negatives: triplet batches.
    cls = (D.TripletDataset if args.loss == "random_sampling"
           else D.PairDataset)
    ds = cls(patches, labels, args.n_pairs,
             batch_size=args.batch_size, seed=args.seed)
    if cls is D.PairDataset and not getattr(args, "host_data", False):
        # Device-resident batches: one upload of the uint8 store, then
        # only the pair indices per step.
        ds = D.DevicePairDataset(ds, device=args.device)
    return ds


def descriptor_params(args):
    """The frozen descriptor's weights: ``--desc-weights``, else the shipped
    HardTFeat weights for TFeat; HardNet has none shipped."""
    if args.descriptor not in ("HardNet", "TFeat"):
        return None
    if args.desc_weights:
        return load_params_npz(args.desc_weights)
    if args.descriptor == "TFeat":
        return load_pretrained("HardTFeatNet")
    raise SystemExit("HardNet descriptor training needs --desc-weights "
                     "(no HardNet weights are shipped)")


def make_eval_fn(args, log_dir: str, eval_argv):
    """The per-epoch graf eval: the epoch's net saved as the epoch's
    checkpoint, then eval_graf on ``eval_argv(ckpt)`` on the same device;
    None under ``--no-eval``."""
    if args.no_eval:
        return None

    def eval_fn(model, epoch):
        ckpt = os.path.join(log_dir, f"checkpoint_{epoch}.npz")
        # epoch + 1 = the resume start, as the loop's checkpoint it
        # overwrites.
        save_checkpoint(ckpt, model, epoch + 1)
        print(f"[graf eval epoch {epoch}]")
        argv = ["--nfeats", "1000", "--img2-idx", "3"] + eval_argv(ckpt)
        if not args.no_vis:
            argv += ["--save-vis", os.path.join(log_dir,
                                                f"vis_epoch_{epoch}")]
        eval_graf.main(argv + ["--device", args.device])

    return eval_fn


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh:
        return run_ranks(args, _rank_main, argv)
    return train(args)


def _rank_main(rank, device, group, argv):
    return train(rank_args(build_parser(), argv, device), mesh=group)


def train(args, mesh=None):
    """The program on ``args``; ``mesh``: this rank's process group."""
    model = net_for(args.arch, AffNet, "AffNet trainer")
    cfg = TrainConfig(arch=args.arch, descriptor=args.descriptor,
                      loss=args.loss, lr=args.lr, wd=args.wd,
                      batch_size=args.batch_size, n_pairs=args.n_pairs,
                      epochs=args.epochs, log_interval=args.log_interval,
                      seed=args.seed,
                      total_epochs=args.total_epochs or None)
    suffix = (f"{args.expname}_{args.arch}_6Brown_{args.descriptor}_"
              f"{args.lr}_{args.n_pairs}_{args.loss}")
    log_dir = os.path.join(args.log_dir, suffix)
    os.makedirs(log_dir, exist_ok=True)
    desc_params = descriptor_params(args)

    start_params, start_epoch = None, args.start_epoch
    if args.resume:
        start_params, start_epoch = load_checkpoint(args.resume)

    # The trained AffNet as the extractor's shape net (the reference's
    # test(), :262-339).
    eval_fn = make_eval_fn(args, log_dir, lambda ckpt: [
        "--descriptor", "SIFT", "--shape-arch", args.arch,
        "--shape-weights", ckpt])
    dataset = make_dataset(args)
    return train_loop(model, dataset, cfg, log_dir=log_dir,
                      desc_params=desc_params, start_params=start_params,
                      start_epoch=start_epoch, device=args.device,
                      eval_fn=eval_fn, mesh=mesh)


if __name__ == "__main__":
    main()
