"""The trainers: AffNet, OriNet and a descriptor from scratch, with the SGD
schedule, checkpoints and the loop.

Counterpart of ``affnet_tpu/train.py``; ``train_loop(mesh=)`` shards the
batch over ranks through :mod:`.parallel`.  The AffNet step
(:func:`make_affnet_train_step`):

1. a random rotation x det-1 tilt warp of each 64x64 anchor and positive
   patch (kernel B5 forward), then a 32x32 center crop; 'Rot'-free archs
   share the anchor's rotation with the positive.  Triplet batches add the
   negative's warp, with its own rotation;
2. the net (any AffNet of the zoo) in train mode on the crops: BatchNorm
   on batch statistics, its running statistics updated in place (anchor
   pass, then positive, then negative), dropout from the step's generator;
3. the full patches re-warped by the predicted shapes at PS 32, all of
   them in one B5 forward launch (its LAF cotangent is one B5 backward
   launch): 3 forward and 1 backward launches per pair step, 4 and 1 per
   triplet step;
4. the frozen descriptor, the loss, backward, and ``torch.optim.SGD`` with
   the reference's momentum 0.9, dampening 0.9 and weight decay — the
   semantics the JAX package's ``sgd_update`` emulates, undamped first
   momentum buffer included — at the linear-decay LR of ``lr_at_step``.

The OriNet step (:func:`make_orinet_train_step`) warps the anchors by a
random rotation x scale 0.9-1.2 with a center shift (one B5 forward at PS
64), runs OriNet in train mode on the anchors' and the positives' center
crops, rewarps both by the predicted rotations (one B5 forward at PS 32
over 2N, one backward) and takes the descriptor loss or ``Geom``, the
distance of the two rotations.  The descriptor step
(:func:`make_descriptor_train_step`) trains the descriptor itself: a
pair-shared transpose and flip, the center crop, the net in train mode,
L2-normalized features and the loss; it runs no sampler kernel.

Each step splits into a random draw from a ``torch.Generator``
(:func:`draw_affnet_lafs`, :func:`draw_orinet`, ``augmentation.draw_fliprot``)
and a deterministic core that takes the draws; ``jax.random`` streams
cannot be reproduced, so parity with the JAX package goes through the
cores.  Inside ``parallel.shard_train_step`` the draws are made over the
global batch and sliced (``parallel.local``), and the descriptors (and
OriNet's per-sample rotation distances) are all-gathered before the loss
(``parallel.gather``), so every rank takes the global loss; the gradients
are averaged over the ranks before SGD.  Outside it those calls change
nothing.  Checkpoints are the JAX package's npz layout (``layer{i}/w``
HWIO, ``__epoch__``), readable by either package.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import losses, parallel, resolve_device
from .augmentation import (draw_fliprot, fliprot_core,
                           get_random_rotation_lafs, get_random_shifts,
                           random_warp_lafs, warp_and_crop,
                           warp_by_predicted_transform)
from .models import HardNet, HardTFeatNet, params_from_jax, params_to_jax
from .models.cnn import l2norm
from .models.sift import sift_describe
from .ops.batched_sampler import sample_batched
from .utils import MetricsLogger, check_finite, float32_math

Tensor = torch.Tensor

TILT_SCHEDULE = {0: 3.0, 1: 4.0, 3: 4.5, 5: 4.8, 6: 5.2, 8: 5.8}


def tilt_for_epoch(epoch: int) -> float:
    """The tilt curriculum, filled backward from the last listed epoch."""
    e = epoch
    while e not in TILT_SCHEDULE and e >= 0:
        e -= 1
    return TILT_SCHEDULE.get(max(e, 0), 3.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's training flags (the JAX package's ``TrainConfig``)."""
    arch: str = "AffNetFast"
    descriptor: str = "pixels"        # pixels | SIFT | HardNet | TFeat
    loss: str = "HardNegC"            # HardNet | HardNegC | PosDist |
    #                                   random_sampling | Geom
    lr: float = 0.005
    wd: float = 1e-4
    momentum: float = 0.9
    dampening: float = 0.9
    batch_size: int = 128
    n_pairs: int = 500000
    epochs: int = 10
    log_interval: int = 10
    seed: int = 0
    patch_size: int = 32
    # Epochs spanned by the linear LR decay; defaults to ``epochs``.  Set
    # when a long run is split into resumed chunks, so the global schedule
    # holds across them.
    total_epochs: Optional[int] = None


def lr_at_step(step: int, cfg: TrainConfig) -> float:
    """Linear decay lr0 * max(0, 1 - step * bs / (n_pairs * epochs)), in
    float32 like the JAX package's; the clamp keeps a resume past the
    schedule's end from turning SGD into ascent."""
    span = float(cfg.total_epochs or cfg.epochs)
    # The divisor is rounded to float32 once, from the exact product, as
    # JAX rounds the Python-float operand of a float32 division.
    frac = (np.float32(step) * np.float32(cfg.batch_size)
            / np.float32(cfg.n_pairs * span))
    return float(np.float32(cfg.lr)
                 * np.maximum(np.float32(0.0), np.float32(1.0) - frac))


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.SGD
    step: int        # global step: 0 on the first update of a fresh run


def init_state(model: nn.Module, cfg: TrainConfig,
               start_step: int = 0) -> TrainState:
    """SGD over the net's parameters (BatchNorm statistics are buffers, so
    SGD leaves them alone).  A resumed run (``start_step`` > 0) starts from
    zero momentum buffers, as the JAX package's resumed state does: its
    update is damped from the first step on."""
    opt = torch.optim.SGD(model.parameters(), lr=cfg.lr,
                          momentum=cfg.momentum, dampening=cfg.dampening,
                          weight_decay=cfg.wd)
    if start_step > 0:
        for p in model.parameters():
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
    return TrainState(model, opt, start_step)


# ---------------------------------------------------------------------------
# Descriptor and loss
# ---------------------------------------------------------------------------

def make_descriptor(name: str, desc_params: Optional[Dict[str, Any]] = None,
                    device: Any = "cuda") -> Callable[[Tensor], Tensor]:
    """patches (N, PS, PS) -> (N, D) descriptors whose gradient flows on to
    the patches: ``pixels`` (mean-subtracted, L2-normalized), ``SIFT``
    (the differentiable SIFT at PS), or the frozen eval-mode net ``HardNet``
    or ``TFeat`` from ``desc_params``, a JAX-layout parameter tree (a
    trained checkpoint, or ``load_pretrained("HardTFeatNet")``)."""
    if name == "pixels":
        def desc(patches: Tensor) -> Tensor:
            flat = patches.reshape(patches.shape[0], -1)
            return l2norm(flat - flat.mean(dim=1, keepdim=True).detach())
        return desc
    if name == "SIFT":
        return lambda patches: sift_describe(patches, patches.shape[-1])
    nets = {"HardNet": HardNet, "TFeat": HardTFeatNet}
    if name in nets:
        if desc_params is None:
            raise ValueError(f"the {name} descriptor needs its weights")
        net = nets[name]()
        net.load_state_dict(params_from_jax(desc_params))
        return net.to(resolve_device(device)).eval().requires_grad_(False)
    raise ValueError(f"Unknown descriptor {name}")


def apply_loss(name: str, desc_a: Tensor, desc_p: Tensor,
               geom_dist: Optional[Tensor] = None,
               desc_n: Optional[Tensor] = None) -> Tensor:
    if name == "HardNet":
        return losses.loss_hardnet(desc_a, desc_p)
    if name == "HardNegC":
        return losses.loss_hardnegc(desc_a, desc_p)
    if name == "PosDist":
        return losses.descriptor_dist(desc_a, desc_p)
    if name == "random_sampling":
        if desc_n is None:
            raise ValueError("random_sampling needs triplet batches "
                             "(TripletDataset)")
        return losses.loss_random_sampling(desc_a, desc_p, desc_n)
    if name == "Geom":
        if geom_dist is None:
            raise ValueError("the Geom loss is the OriNet step's own")
        return geom_dist
    raise ValueError(f"Unknown loss {name}")


def _sgd_step(state: TrainState, cfg: TrainConfig, loss_fn
              ) -> Dict[str, Any]:
    """Gradients of ``loss_fn() -> (loss, descr_dist)`` (averaged over the
    ranks of a sharded step), then SGD at ``lr_at_step(state.step)``."""
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss, descr_dist = loss_fn()
    check_finite(loss, "the training loss")
    loss.backward()
    parallel.average_gradients(state.model.parameters())
    lr = lr_at_step(state.step, cfg)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    state.step += 1
    return {"loss": loss.detach(), "descr_dist": descr_dist.detach(),
            "lr": lr}


# ---------------------------------------------------------------------------
# The AffNet step
# ---------------------------------------------------------------------------

def draw_affnet_lafs(n: int, max_tilt: float, generator: torch.Generator,
                     shared_rot: bool, negative: bool = False
                     ) -> Tuple[Tensor, ...]:
    """The step's random warps (anchor, positive[, negative]), each
    (N, 2, 3); the negative, another 3D point, has its own rotation."""
    lafs_a, rot_a, _ = random_warp_lafs(n, math.pi, max_tilt, generator)
    lafs_p, _, _ = random_warp_lafs(n, rot_a if shared_rot else math.pi,
                                    max_tilt, generator)
    if not negative:
        return lafs_a, lafs_p
    lafs_n, _, _ = random_warp_lafs(n, math.pi, max_tilt, generator)
    return lafs_a, lafs_p, lafs_n


def affnet_loss(model: nn.Module, descriptor_fn, cfg: TrainConfig,
                batch: Tuple[Tensor, ...], lafs: Tuple[Tensor, ...],
                generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> Tuple[Tensor, Tensor]:
    """(loss, mean positive distance) of one pair or triplet batch under
    the given warps.  ``model`` must be in train mode; its BatchNorm
    statistics advance, anchor pass first, negative last.  The rewarps
    share one sampler launch, and the descriptor one pass: both act on
    each patch alone."""
    ps = cfg.patch_size
    fulls, shapes = [], []
    for data, laf in zip(batch, lafs):
        crop, full = warp_and_crop(data, laf, ps, use_kernel=use_kernels)
        fulls.append(full)
        shapes.append(model(crop, generator))
    patches = warp_by_predicted_transform(torch.cat(fulls), torch.cat(shapes),
                                          ps, use_kernel=use_kernels)
    desc = descriptor_fn(patches)
    descs = parallel.gather(desc.reshape(len(batch), -1, desc.shape[1]), 1)
    desc_n = descs[2] if len(descs) > 2 else None
    return (apply_loss(cfg.loss, descs[0], descs[1], desc_n=desc_n),
            losses.descriptor_dist(descs[0], descs[1]))


@float32_math()
def affnet_step_core(state: TrainState, descriptor_fn, cfg: TrainConfig,
                     batch: Tuple[Tensor, ...], lafs: Tuple[Tensor, ...],
                     generator: Optional[torch.Generator] = None,
                     use_kernels: bool = True) -> Dict[str, Any]:
    """The deterministic step: loss and gradients under the given warps,
    then SGD at ``lr_at_step(state.step)``.  Without a generator dropout is
    off."""
    return _sgd_step(state, cfg, lambda: affnet_loss(
        state.model, descriptor_fn, cfg, batch, lafs, generator,
        use_kernels))


def make_affnet_train_step(descriptor_fn, cfg: TrainConfig,
                           use_kernels: bool = True):
    """Returns step(state, batch, generator, max_tilt) -> metrics; batch =
    (anchor, positive) or (anchor, positive, negative), each (N, 64, 64)
    in [0, 1] on the net's device.  ``use_kernels=False`` runs the plain
    sampler on a card (for checks)."""
    shared_rot = "Rot" not in cfg.arch

    def step_fn(state: TrainState, batch, generator: torch.Generator,
                max_tilt: float) -> Dict[str, Any]:
        n = parallel.global_count(batch[0].shape[0])
        lafs = parallel.local(draw_affnet_lafs(
            n, max_tilt, generator, shared_rot, negative=len(batch) > 2))
        return affnet_step_core(state, descriptor_fn, cfg, batch, lafs,
                                generator, use_kernels)

    return step_fn


# ---------------------------------------------------------------------------
# The descriptor step (HardNet from scratch)
# ---------------------------------------------------------------------------

def descriptor_loss(model: nn.Module, cfg: TrainConfig,
                    batch: Tuple[Tensor, Tensor], flips,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Tensor, Tensor]:
    """(loss, mean positive distance) of the descriptor ``model`` (train
    mode) on one pair batch: the pair-shared transpose and flip ``flips``
    = (do_rot, do_flip), the center crop at PS, the net on the anchors,
    then the positives (BatchNorm statistics chain), L2-normalized."""
    a, p = fliprot_core(batch[0], batch[1], *flips)
    ps = cfg.patch_size
    st = (a.shape[1] - ps) // 2
    desc_a, desc_p = (parallel.gather(l2norm(model.feature_vectors(
        x[:, st:st + ps, st:st + ps], generator))) for x in (a, p))
    return (apply_loss(cfg.loss, desc_a, desc_p),
            losses.descriptor_dist(desc_a, desc_p))


@float32_math()
def descriptor_step_core(state: TrainState, cfg: TrainConfig,
                         batch: Tuple[Tensor, Tensor], flips,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, Any]:
    """The deterministic descriptor step under the given flips."""
    return _sgd_step(state, cfg, lambda: descriptor_loss(
        state.model, cfg, batch, flips, generator))


def make_descriptor_train_step(descriptor_fn, cfg: TrainConfig,
                               use_kernels: bool = True):
    """Returns step(state, batch, generator, max_tilt) -> metrics for the
    descriptor under training (``state.model``); ``descriptor_fn``, the
    frozen descriptor of the other trainers, and ``max_tilt`` are unused,
    and no sampler runs, so ``use_kernels`` changes nothing."""
    del descriptor_fn, use_kernels

    def step_fn(state: TrainState, batch, generator: torch.Generator,
                max_tilt: Optional[float] = None) -> Dict[str, Any]:
        return descriptor_step_core(state, cfg, batch,
                                    draw_fliprot(generator), generator)

    return step_fn


# ---------------------------------------------------------------------------
# The OriNet step
# ---------------------------------------------------------------------------

def draw_orinet(n: int, generator: torch.Generator) -> Tuple[Tensor, ...]:
    """The OriNet step's random draw: (rotation LAFs (N, 2, 3), their
    inverse rotations (N, 2, 2), scales 0.9-1.2 (N,), shifts in x and y
    (N,) each, in pixels)."""
    rot_lafs, inv_rotmat = get_random_rotation_lafs(n, math.pi, generator)
    scale = 0.9 + 0.3 * torch.rand(n, generator=generator,
                                   device=generator.device)
    shift_w, shift_h = get_random_shifts(n, 2, generator)
    return rot_lafs, inv_rotmat, scale, shift_w, shift_h


def orinet_lafs(draw: Tuple[Tensor, ...], h: int, w: int) -> Tensor:
    """The anchors' warp LAFs from :func:`draw_orinet`'s draw: the rotation
    times the scale, the center shifted by the shifts over the patch
    size."""
    rot_lafs, _, scale, shift_w, shift_h = draw
    A = rot_lafs[:, :, 0:2] * scale[:, None, None]
    t = torch.stack([rot_lafs[:, 0, 2] + shift_w / w,
                     rot_lafs[:, 1, 2] + shift_h / h], -1)[..., None]
    return torch.cat([A, t], dim=2)


def orinet_loss(model: nn.Module, descriptor_fn, cfg: TrainConfig,
                batch: Tuple[Tensor, Tensor], draw: Tuple[Tensor, ...],
                generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> Tuple[Tensor, Tensor]:
    """(loss, mean positive distance) of the OriNet ``model`` (train mode)
    on one pair batch under :func:`draw_orinet`'s draw: the anchors warped
    at PS = H, both center crops through the net (anchors first) to its
    rotation matrices R_a and R_p, both full patches rewarped by them in
    one sampler launch, the descriptor, and ``geom_dist``, the mean
    Frobenius distance of R_a and inv_rot @ R_p."""
    data_a, data_p = batch
    n, h, w = data_a.shape
    ps = cfg.patch_size
    data_a_rot = sample_batched(data_a, orinet_lafs(draw, h, w), ps=h,
                                use_kernel=use_kernels)
    st = (h - ps) // 2
    R_a = model(data_a_rot[:, st:st + ps, st:st + ps], generator)
    R_p = model(data_p[:, st:st + ps, st:st + ps], generator)
    patches = warp_by_predicted_transform(
        torch.cat([data_a_rot, data_p]), torch.cat([R_a, R_p]), ps,
        use_kernel=use_kernels)
    desc = descriptor_fn(patches)
    desc_a, desc_p = parallel.gather(desc.reshape(2, n, desc.shape[1]), 1)
    geom_dist = parallel.gather(torch.sqrt(
        ((R_a - draw[1] @ R_p) ** 2).sum(dim=(1, 2)) + 1e-8)).mean()
    return (apply_loss(cfg.loss, desc_a, desc_p, geom_dist),
            losses.descriptor_dist(desc_a, desc_p))


@float32_math()
def orinet_step_core(state: TrainState, descriptor_fn, cfg: TrainConfig,
                     batch: Tuple[Tensor, Tensor], draw: Tuple[Tensor, ...],
                     generator: Optional[torch.Generator] = None,
                     use_kernels: bool = True) -> Dict[str, Any]:
    """The deterministic OriNet step under the given draw."""
    return _sgd_step(state, cfg, lambda: orinet_loss(
        state.model, descriptor_fn, cfg, batch, draw, generator,
        use_kernels))


def make_orinet_train_step(descriptor_fn, cfg: TrainConfig,
                           use_kernels: bool = True):
    """Returns step(state, batch, generator, max_tilt) -> metrics; batch =
    (anchor, positive), each (N, 64, 64) in [0, 1]; ``max_tilt`` is
    unused.  Per step: B5 forward at PS 64 (N patches) and at PS 32 (2N),
    and one B5 backward."""

    def step_fn(state: TrainState, batch, generator: torch.Generator,
                max_tilt: Optional[float] = None) -> Dict[str, Any]:
        draw = parallel.local(draw_orinet(
            parallel.global_count(batch[0].shape[0]), generator))
        return orinet_step_core(state, descriptor_fn, cfg, batch, draw,
                                generator, use_kernels)

    return step_fn


# ---------------------------------------------------------------------------
# Checkpoints (the JAX package's npz layout)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, model: nn.Module, epoch: int) -> None:
    flat = {f"{layer}/{field}": arr
            for layer, fields in params_to_jax(model.state_dict()).items()
            for field, arr in fields.items()}
    flat["__epoch__"] = np.asarray(epoch)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path: str) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                                        int]:
    """(JAX-layout parameter tree, epoch); load it into a net with
    ``net.load_state_dict(params_from_jax(tree))``."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    epoch = 0
    with np.load(path) as data:
        for key in data.files:
            if key == "__epoch__":
                epoch = int(data[key])
                continue
            layer, field = key.split("/")
            tree.setdefault(layer, {})[field] = np.asarray(data[key])
    return tree, epoch


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

STEP_MAKERS = {"affnet": make_affnet_train_step,
               "orinet": make_orinet_train_step,
               "descriptor": make_descriptor_train_step}


@float32_math()
def train_loop(model: nn.Module, dataset, cfg: TrainConfig,
               log_dir: str = "./logs",
               desc_params: Optional[Dict[str, Any]] = None,
               start_params: Optional[Dict[str, Any]] = None,
               start_epoch: int = 0, device: Any = "cuda",
               ori: bool = False, mode: Optional[str] = None,
               eval_fn: Optional[Callable[[nn.Module, int], None]] = None,
               mesh=None) -> TrainState:
    """Train ``model`` (an ``nn.Module``, moved to ``device``) on
    ``dataset.batches()`` for ``cfg.epochs`` epochs, with a checkpoint per
    epoch and a metrics line every ``cfg.log_interval`` steps
    (``log_dir/metrics.jsonl``).  ``mode``: ``affnet`` (the default),
    ``orinet`` (also ``ori=True``) or ``descriptor`` (the model is the
    descriptor under training; no frozen descriptor).  The net starts from
    ``start_params`` (a JAX-layout tree) or from the net's seeded init
    (``PatchNet.init``: the orthogonal init seeded by ``cfg.seed`` at the
    net's ``init_gain``, its ``last_gain`` and ``last_bias``).  A resume at
    ``start_epoch`` continues the global step (and so the LR), and seeds
    the step generator with ``cfg.seed + 7919 * start_epoch``.  After each
    epoch's checkpoint, ``eval_fn(model, epoch)`` runs with the net in
    eval mode; training goes on in train mode.

    ``mesh``: a ``torch.distributed`` process group (``parallel.spawn``)
    whose ranks each call ``train_loop`` alike, on their own ``device``.
    Each rank reads the same global batch from ``dataset`` and steps on its
    slice under ``parallel.shard_train_step``; only rank 0 prints the step
    lines (the global loss), writes ``metrics.jsonl`` and the checkpoints,
    and calls ``eval_fn``.  The global batch (``cfg.batch_size``) must
    split evenly over the ranks."""
    if cfg.total_epochs is not None \
            and start_epoch + cfg.epochs > cfg.total_epochs:
        raise ValueError(
            f"chunked resume past the LR schedule end: start_epoch "
            f"{start_epoch} + epochs {cfg.epochs} > total_epochs "
            f"{cfg.total_epochs} (the linear decay would clamp to lr=0)")
    if mode is None:
        mode = "orinet" if ori else "affnet"
    dev = resolve_device(device)
    model.to(dev)
    if start_params is None:
        model.init(torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(params_from_jax(start_params))
    model.train()
    descriptor_fn = (None if mode == "descriptor"
                     else make_descriptor(cfg.descriptor, desc_params, dev))
    step_fn = STEP_MAKERS[mode](descriptor_fn, cfg)
    rank, world = 0, 1
    if mesh is not None:
        rank, world = dist.get_rank(mesh), dist.get_world_size(mesh)
        if cfg.batch_size % world:
            raise ValueError(f"batch size {cfg.batch_size} does not split "
                             f"over {world} ranks")
        step_fn = parallel.shard_train_step(step_fn, mesh)
    state = init_state(model, cfg,
                       start_epoch * (cfg.n_pairs // cfg.batch_size))
    generator = torch.Generator(device=dev).manual_seed(
        cfg.seed + 7919 * start_epoch)

    logger = (MetricsLogger(os.path.join(log_dir, "metrics.jsonl"))
              if rank == 0 else None)
    global_step = 0
    try:
        for epoch in range(start_epoch, start_epoch + cfg.epochs):
            max_tilt = tilt_for_epoch(epoch)
            for i, batch in enumerate(dataset.batches()):
                batch = tuple(torch.as_tensor(
                    x[rank * (len(x) // world):(rank + 1) * (len(x) // world)],
                    device=dev) for x in batch)
                metrics = step_fn(state, batch, generator, max_tilt)
                if rank == 0 and i % cfg.log_interval == 0:
                    print(f"epoch {epoch} step {i} "
                          f"loss {float(metrics['loss']):.4f} "
                          f"descr_dist {float(metrics['descr_dist']):.4f} "
                          f"lr {metrics['lr']:.5f}")
                    logger.log(global_step, epoch=epoch, **metrics)
                global_step += 1
            if rank > 0:
                continue
            save_checkpoint(os.path.join(log_dir, f"checkpoint_{epoch}.npz"),
                            model, epoch + 1)
            if eval_fn is not None:
                model.eval()
                try:
                    eval_fn(model, epoch)
                finally:
                    model.train()
    finally:
        if logger is not None:
            logger.close()
    if mesh is not None:
        dist.barrier(mesh)
    return state
