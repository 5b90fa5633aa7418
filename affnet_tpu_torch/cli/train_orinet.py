"""Train OriNet on Brown/PhotoTour patch pairs.

Counterpart of ``affnet_tpu/cli/train_orinet.py`` (reference:
train_OriNet_test_on_graffity.py): a random rotation x scale 0.9-1.2 warp
with center shifts of the anchors, the descriptor loss on the patches
rewarped by the predicted rotations (or ``Geom``).  The flags are
train_affnet's (``--mesh N`` included), with the defaults ``--arch
OriNetFast32 --loss HardNet``; ``--arch`` takes the OriNet nets of the
port's zoo.

Usage: python -m affnet_tpu_torch.cli.train_orinet --dataroot dataset/6Brown \\
          --descriptor HardNet --desc-weights hardnet.npz --batch-size 1024
"""

from __future__ import annotations

import os

from ..models import OriNet
from ..train import TrainConfig, load_checkpoint, train_loop
from .train_affnet import (build_parser, descriptor_params, make_dataset,
                           make_eval_fn, net_for, rank_args, run_ranks)


def orinet_parser():
    parser = build_parser()
    parser.set_defaults(arch="OriNetFast32", loss="HardNet")
    return parser


def main(argv=None):
    args = orinet_parser().parse_args(argv)
    if args.mesh:
        return run_ranks(args, _rank_main, argv)
    return train(args)


def _rank_main(rank, device, group, argv):
    return train(rank_args(orinet_parser(), argv, device), mesh=group)


def train(args, mesh=None):
    """The program on ``args``; ``mesh``: this rank's process group."""
    model = net_for(args.arch, OriNet, "OriNet trainer")
    cfg = TrainConfig(arch=args.arch, descriptor=args.descriptor,
                      loss=args.loss, lr=args.lr, wd=args.wd,
                      batch_size=args.batch_size, n_pairs=args.n_pairs,
                      epochs=args.epochs, log_interval=args.log_interval,
                      seed=args.seed)
    suffix = (f"{args.expname}_OriNet_6Brown_{args.descriptor}_"
              f"{args.lr}_{args.n_pairs}_{args.loss}")
    log_dir = os.path.join(args.log_dir, suffix)
    os.makedirs(log_dir, exist_ok=True)
    desc_params = descriptor_params(args)

    start_params, start_epoch = None, args.start_epoch
    if args.resume:
        start_params, start_epoch = load_checkpoint(args.resume)

    # The shipped AffNet with the trained OriNet (the reference's test(),
    # train_OriNet_test_on_graffity.py:304-312).
    eval_fn = make_eval_fn(args, log_dir, lambda ckpt: [
        "--descriptor", "SIFT", "--do-ori", "--ori-weights", ckpt])
    dataset = make_dataset(args)
    return train_loop(model, dataset, cfg, log_dir=log_dir,
                      desc_params=desc_params, start_params=start_params,
                      start_epoch=start_epoch, device=args.device, ori=True,
                      eval_fn=eval_fn, mesh=mesh)


if __name__ == "__main__":
    main()
