"""AffNet training: one step, the SGD schedule, checkpoints and the loop.

Counterpart of the AffNet parts of ``affnet_tpu/train.py``.  One step
(``make_affnet_train_step``):

1. a random rotation x det-1 tilt warp of each 64x64 anchor and positive
   patch (kernel B5 forward), then a 32x32 center crop; 'Rot'-free archs
   share the anchor's rotation with the positive;
2. the net (AffNetFast) in train mode on both crops: BatchNorm on batch
   statistics, its running statistics updated in place (anchor pass, then
   positive pass), dropout from the step's generator;
3. the full patches re-warped by the predicted shapes at PS 32, anchors
   and positives in one B5 forward launch (its LAF cotangent is one B5
   backward launch): 3 forward and 1 backward launches per step;
4. the frozen descriptor, the loss, backward, and ``torch.optim.SGD`` with
   the reference's momentum 0.9, dampening 0.9 and weight decay — the
   semantics the JAX package's ``sgd_update`` emulates, undamped first
   momentum buffer included — at the linear-decay LR of ``lr_at_step``.

The step splits into a random draw (:func:`draw_affnet_lafs`, from a
``torch.Generator``) and a deterministic core (:func:`affnet_step_core`)
that takes the drawn LAFs; ``jax.random`` streams cannot be reproduced, so
parity with the JAX package goes through the core.  Checkpoints are the
JAX package's npz layout (``layer{i}/w`` HWIO, ``__epoch__``), readable by
either package.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import losses, resolve_device
from .augmentation import (random_warp_lafs, warp_and_crop,
                           warp_by_predicted_transform)
from .models import HardTFeatNet, params_from_jax, params_to_jax
from .models.cnn import init_params, l2norm
from .utils import MetricsLogger, float32_math

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
    descriptor: str = "pixels"        # pixels | TFeat
    loss: str = "HardNegC"            # HardNet | HardNegC | PosDist
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
    """patches (N, PS, PS) -> (N, D) descriptors from a frozen, eval-mode
    net whose gradient flows on to the patches.  ``desc_params`` is the
    JAX-layout parameter tree of the ``TFeat`` net (``load_pretrained(
    "HardTFeatNet")``)."""
    if name == "pixels":
        def desc(patches: Tensor) -> Tensor:
            flat = patches.reshape(patches.shape[0], -1)
            return l2norm(flat - flat.mean(dim=1, keepdim=True).detach())
        return desc
    if name == "TFeat":
        if desc_params is None:
            raise ValueError("the TFeat descriptor needs its weights")
        net = HardTFeatNet()
        net.load_state_dict(params_from_jax(desc_params))
        return net.to(resolve_device(device)).eval().requires_grad_(False)
    raise ValueError(f"descriptor {name!r} is not ported (pixels, TFeat)")


def apply_loss(name: str, desc_a: Tensor, desc_p: Tensor) -> Tensor:
    if name == "HardNet":
        return losses.loss_hardnet(desc_a, desc_p)
    if name == "HardNegC":
        return losses.loss_hardnegc(desc_a, desc_p)
    if name == "PosDist":
        return losses.descriptor_dist(desc_a, desc_p)
    raise ValueError(f"loss {name!r} is not ported (HardNet, HardNegC, "
                     "PosDist)")


# ---------------------------------------------------------------------------
# The AffNet step
# ---------------------------------------------------------------------------

def draw_affnet_lafs(n: int, max_tilt: float, generator: torch.Generator,
                     shared_rot: bool) -> Tuple[Tensor, Tensor]:
    """The step's random warps (anchor, positive), each (N, 2, 3)."""
    lafs_a, rot_a, _ = random_warp_lafs(n, math.pi, max_tilt, generator)
    lafs_p, _, _ = random_warp_lafs(n, rot_a if shared_rot else math.pi,
                                    max_tilt, generator)
    return lafs_a, lafs_p


def affnet_loss(model: nn.Module, descriptor_fn, cfg: TrainConfig,
                batch: Tuple[Tensor, Tensor], lafs: Tuple[Tensor, Tensor],
                generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> Tuple[Tensor, Tensor]:
    """(loss, mean positive distance) of one batch under the given warps.
    ``model`` must be in train mode; its BatchNorm statistics advance, the
    anchor pass first.  The two rewarps share one sampler launch, and the
    descriptor one pass: both act on each patch alone."""
    ps = cfg.patch_size
    fulls, shapes = [], []
    for data, laf in zip(batch, lafs):
        crop, full = warp_and_crop(data, laf, ps, use_kernel=use_kernels)
        fulls.append(full)
        shapes.append(model(crop, generator))
    patches = warp_by_predicted_transform(torch.cat(fulls), torch.cat(shapes),
                                          ps, use_kernel=use_kernels)
    desc_a, desc_p = descriptor_fn(patches).chunk(2)
    return (apply_loss(cfg.loss, desc_a, desc_p),
            losses.descriptor_dist(desc_a, desc_p))


@float32_math()
def affnet_step_core(state: TrainState, descriptor_fn, cfg: TrainConfig,
                     batch: Tuple[Tensor, Tensor],
                     lafs: Tuple[Tensor, Tensor],
                     generator: Optional[torch.Generator] = None,
                     use_kernels: bool = True) -> Dict[str, Any]:
    """The deterministic step: loss and gradients under the given warps,
    then SGD at ``lr_at_step(state.step)``.  Without a generator dropout is
    off."""
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss, descr_dist = affnet_loss(state.model, descriptor_fn, cfg, batch,
                                   lafs, generator, use_kernels)
    loss.backward()
    lr = lr_at_step(state.step, cfg)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    state.step += 1
    return {"loss": loss.detach(), "descr_dist": descr_dist.detach(),
            "lr": lr}


def make_affnet_train_step(descriptor_fn, cfg: TrainConfig,
                           use_kernels: bool = True):
    """Returns step(state, batch, generator, max_tilt) -> metrics; batch =
    (anchor, positive), each (N, 64, 64) in [0, 1] on the net's device.
    ``use_kernels=False`` runs the plain sampler on a card (for checks)."""
    shared_rot = "Rot" not in cfg.arch

    def step_fn(state: TrainState, batch, generator: torch.Generator,
                max_tilt: float) -> Dict[str, Any]:
        lafs = draw_affnet_lafs(batch[0].shape[0], max_tilt, generator,
                                shared_rot)
        return affnet_step_core(state, descriptor_fn, cfg, batch, lafs,
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

@float32_math()
def train_loop(model: nn.Module, dataset, cfg: TrainConfig,
               log_dir: str = "./logs",
               desc_params: Optional[Dict[str, Any]] = None,
               start_params: Optional[Dict[str, Any]] = None,
               start_epoch: int = 0, device: Any = "cuda") -> TrainState:
    """Train the AffNet ``model`` (an ``nn.Module``, moved to ``device``)
    on ``dataset.batches()`` for ``cfg.epochs`` epochs, with a checkpoint
    per epoch and a metrics line every ``cfg.log_interval`` steps
    (``log_dir/metrics.jsonl``).  The net starts from ``start_params`` (a
    JAX-layout tree) or from the orthogonal init seeded by ``cfg.seed``.
    A resume at ``start_epoch`` continues the global step (and so the LR),
    and seeds the step generator with ``cfg.seed + 7919 * start_epoch``."""
    if cfg.total_epochs is not None \
            and start_epoch + cfg.epochs > cfg.total_epochs:
        raise ValueError(
            f"chunked resume past the LR schedule end: start_epoch "
            f"{start_epoch} + epochs {cfg.epochs} > total_epochs "
            f"{cfg.total_epochs} (the linear decay would clamp to lr=0)")
    dev = resolve_device(device)
    model.to(dev)
    if start_params is None:
        init_params(model, torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(params_from_jax(start_params))
    model.train()
    descriptor_fn = make_descriptor(cfg.descriptor, desc_params, dev)
    step_fn = make_affnet_train_step(descriptor_fn, cfg)
    state = init_state(model, cfg,
                       start_epoch * (cfg.n_pairs // cfg.batch_size))
    generator = torch.Generator(device=dev).manual_seed(
        cfg.seed + 7919 * start_epoch)

    logger = MetricsLogger(os.path.join(log_dir, "metrics.jsonl"))
    global_step = 0
    try:
        for epoch in range(start_epoch, start_epoch + cfg.epochs):
            max_tilt = tilt_for_epoch(epoch)
            for i, batch in enumerate(dataset.batches()):
                batch = tuple(torch.as_tensor(x, device=dev) for x in batch)
                metrics = step_fn(state, batch, generator, max_tilt)
                if i % cfg.log_interval == 0:
                    print(f"epoch {epoch} step {i} "
                          f"loss {float(metrics['loss']):.4f} "
                          f"descr_dist {float(metrics['descr_dist']):.4f} "
                          f"lr {metrics['lr']:.5f}")
                    logger.log(global_step, epoch=epoch, **metrics)
                global_step += 1
            save_checkpoint(os.path.join(log_dir, f"checkpoint_{epoch}.npz"),
                            model, epoch + 1)
    finally:
        logger.close()
    return state
