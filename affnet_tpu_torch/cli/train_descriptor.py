"""Train a descriptor CNN (HardNet from scratch) on patch pairs.

Counterpart of ``affnet_tpu/cli/train_descriptor.py`` with its flags: the
HardNet architecture (reference HardNet.py:61-101), HardTFeatNet, or
HardNetNarELU (HardNet.py:30-71, which JAX's ``--arch`` does not list), with
the HardNet loss (Losses.py:113-180) on the pair data of the other
trainers, a pair-shared transpose and flip, the reference's SGD and
linear LR decay.  The per-epoch eval runs the graf pipeline with the
trained descriptor and the shipped AffNet.  Runs on the card unless
``--device cpu`` asks for the CPU; ``--mesh N`` shards each batch over N
ranks as in train_affnet.

Usage:
  python -m affnet_tpu_torch.cli.train_descriptor --synthetic --epochs 4 \\
      --n-pairs 500000 --batch-size 1024 [--arch HardNet] [--lr 0.1]
"""

from __future__ import annotations

import argparse
import os

from ..models import REGISTRY
from ..train import TrainConfig, load_checkpoint, train_loop
from .train_affnet import (MESH_HELP, make_dataset, make_eval_fn, rank_args,
                           run_ranks)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataroot", type=str, default="datasets/")
    p.add_argument("--log-dir", default="./logs")
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--total-epochs", type=int, default=0,
                   help="epochs spanned by the LR schedule (chunked runs)")
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--n-pairs", type=int, default=500000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--wd", default=1e-4, type=float)
    p.add_argument("--expname", default="", type=str)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--loss", type=str, default="HardNet",
                   choices=["HardNet", "HardNegC", "PosDist"])
    p.add_argument("--arch", type=str, default="HardNet",
                   choices=["HardNet", "HardTFeatNet", "HardNetNarELU"])
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
    p.add_argument("--conv-vjp", choices=["xla", "explicit"], default="xla",
                   help="accepted for the JAX command line's sake; no "
                        "effect: autograd computes the conv backward")
    p.add_argument("--host-data", action="store_true",
                   help="build batches on the host and upload each one "
                        "instead of the device-resident patch store")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--no-vis", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh:
        return run_ranks(args, _rank_main, argv)
    return train(args)


def _rank_main(rank, device, group, argv):
    return train(rank_args(build_parser(), argv, device), mesh=group)


def train(args, mesh=None):
    """The program on ``args``; ``mesh``: this rank's process group."""
    model = REGISTRY[args.arch]()
    cfg = TrainConfig(arch=args.arch, descriptor="pixels", loss=args.loss,
                      lr=args.lr, wd=args.wd, batch_size=args.batch_size,
                      n_pairs=args.n_pairs, epochs=args.epochs,
                      log_interval=args.log_interval, seed=args.seed,
                      total_epochs=args.total_epochs or None)
    suffix = (f"{args.expname}_{args.arch}_desc_{args.lr}_{args.n_pairs}_"
              f"{args.loss}")
    log_dir = os.path.join(args.log_dir, suffix)
    os.makedirs(log_dir, exist_ok=True)

    dataset = make_dataset(args)

    start_params, start_epoch = None, args.start_epoch
    if args.resume:
        start_params, start_epoch = load_checkpoint(args.resume)

    # The graf pipeline with the trained descriptor and the shipped AffNet,
    # the descriptor's counterpart of the reference's per-epoch test().
    desc_flag = {"HardTFeatNet": "TFeat"}.get(args.arch, args.arch)
    eval_fn = make_eval_fn(args, log_dir, lambda ckpt: [
        "--descriptor", desc_flag, "--desc-weights", ckpt])
    return train_loop(model, dataset, cfg, log_dir=log_dir,
                      start_params=start_params, start_epoch=start_epoch,
                      device=args.device, mode="descriptor",
                      eval_fn=eval_fn, mesh=mesh)


if __name__ == "__main__":
    main()
