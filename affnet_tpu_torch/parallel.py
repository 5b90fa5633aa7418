"""Data parallelism over ``torch.distributed``: device lists, rank
processes, the sharded training step and sharded inference.

Counterpart of ``affnet_tpu/parallel.py``.  For 32x32-patch CNNs the axis
worth splitting is the batch, so this is pure data parallelism, and its
semantics are the one-device step's on the global batch, as JAX's GSPMD
step promises ("IDENTICAL to single-chip"): the hard-negative mining still
sees the whole global batch.

- Training: one process per rank (:func:`spawn`), each holding a replica of
  the net and its optimizer and stepping on its slice of the global batch
  under :func:`shard_train_step`.  Inside that step (:func:`sharded`) the
  step's random draws are made over the global batch and sliced, train-mode
  BatchNorm normalizes with the global batch's statistics
  (:func:`batch_norm_global`), the descriptors are all-gathered before the
  loss, so every rank computes the global loss, and the gradients are
  averaged over the ranks before SGD.  Every collective on that path has
  an autograd rule that is its adjoint over the ranks (an all-reduce's
  gradient is the all-reduce of the gradients, an all-gather's the local
  slice of their all-reduce), so the gradient each rank holds is that of
  the sum of the ranks' losses: ``world`` times the global loss, whose
  average over the ranks is the one-device gradient.  ``torch.optim.SGD``
  then makes the same update on every rank; no broadcast is needed.
- Bulk patch inference: :func:`shard_apply` splits the patches over the
  devices.
- Bulk image extraction: :func:`make_sharded_image_pipeline` deals the
  images over one extractor replica per device.

Backends: NCCL for one card per rank; gloo on the CPU, and for ranks that
share one card (NCCL refuses two ranks on one device).  Gloo runs the
all-reduce and the all-gather used here on CUDA tensors itself, through
host memory.

Unlike JAX's ``make_mesh``, :func:`make_mesh` never moves to other devices
when fewer cards are present than asked for: it refuses.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import resolve_device

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Devices and rank processes
# ---------------------------------------------------------------------------

def make_mesh(n_devices: Optional[int] = None,
              device: Any = "cuda") -> List[torch.device]:
    """The devices of an ``n_devices``-way data-parallel run: ``cuda:0`` ..
    ``cuda:n-1`` (every card when ``n_devices`` is None), or ``n`` CPU
    entries for ``device="cpu"`` (the tests).  Refuses more cards than
    ``torch.cuda.device_count()``: JAX's move to its virtual CPU devices
    when the default backend has too few would hide the device, and is not
    carried over."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * (n_devices or 1)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n < 1 or n > count:
        raise ValueError(f"make_mesh: {n} CUDA devices asked for, {count} "
                         "present (no fallback to the CPU; pass device='cpu' "
                         "to run CPU replicas)")
    resolve_device(dev)
    return [torch.device("cuda", i) for i in range(n)]


def init_group(rank: int, world: int, backend: str, init_method: str,
               device: Optional[torch.device] = None) -> dist.ProcessGroup:
    """Join the default process group as ``rank`` of ``world`` and return
    it; ``init_method`` is a rendezvous address (``file://...`` or
    ``tcp://localhost:<port>``); ``device``: this rank's card under
    NCCL."""
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        device_id=device if backend == "nccl" else None)
    return dist.group.WORLD


def _rank_devices(n: int, device: Any) -> tuple:
    """(the device of each rank, the backend) for :func:`spawn`."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n, "gloo"
    if dev.index is None:
        return make_mesh(n, dev), "nccl"
    resolve_device(dev)
    # Every rank on the one named card: NCCL refuses that, gloo runs it.
    return [dev] * n, "nccl" if n == 1 else "gloo"


def _rank_main(rank: int, fn: Callable, devices: list, backend: str,
               init_method: str, args: tuple, result_path: str) -> None:
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = init_group(rank, len(devices), backend, init_method, device)
    try:
        out = fn(rank, device, group, *args)
        if rank == 0 and result_path:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, device: Any = "cuda", args: tuple = ()):
    """Run ``fn(rank, device, group, *args)`` on ``n`` ranks and return rank
    0's result, passed back through ``torch.save`` (a tensor on a card
    loads back onto it).  ``device``: ``"cuda"`` puts rank
    ``r`` on ``cuda:r`` over NCCL (refused beyond the cards present);
    ``"cpu"`` runs CPU ranks over gloo; a card by index (``"cuda:0"``)
    puts every rank on it, over gloo.  ``n == 1`` runs in this process,
    in a group of one; more ranks run in processes started by
    ``torch.multiprocessing.spawn`` (``fn`` must be importable by name).
    The rendezvous is a file in a temporary directory."""
    devices, backend = _rank_devices(n, device)
    tmp = tempfile.mkdtemp(prefix="affnet_group_")
    try:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        result = os.path.join(tmp, "result.pt")
        if n == 1:
            _rank_main(0, fn, devices, backend, init_method, args, result)
        else:
            mp.spawn(_rank_main, args=(fn, devices, backend, init_method,
                                       args, result), nprocs=n, join=True)
        return (torch.load(result, weights_only=False)
                if os.path.exists(result) else None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Collectives with autograd (each rule the adjoint over the ranks)
# ---------------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group, dim: int) -> Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place in a sharded step: rows ``rank * n`` to
    ``(rank + 1) * n`` of every global batch of ``world * n`` rows."""
    group: Any
    rank: int
    world: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar("affnet_shard",
                                                        default=None)


def current() -> Optional[Shard]:
    """The shard of the sharded step running in this thread, or None."""
    return _SHARD.get()


@contextlib.contextmanager
def sharded(group):
    """Run the block as this rank's part of a sharded step over
    ``group``."""
    token = _SHARD.set(Shard(group, dist.get_rank(group),
                             dist.get_world_size(group)))
    try:
        yield
    finally:
        _SHARD.reset(token)


def global_count(n: int) -> int:
    """The global batch's rows for ``n`` local ones."""
    shard = current()
    return n if shard is None else n * shard.world


def local(x):
    """This rank's rows (dim 0) of a global draw, a tensor or a tuple of
    them; unchanged outside a sharded step."""
    shard = current()
    if shard is None:
        return x
    if isinstance(x, tuple):
        return tuple(local(t) for t in x)
    n = x.shape[0] // shard.world
    return x[shard.rank * n:(shard.rank + 1) * n]


def gather(x: Tensor, dim: int = 0) -> Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    global batch's rows); unchanged outside a sharded step."""
    shard = current()
    return x if shard is None else _AllGather.apply(x, shard.group, dim)


def average_gradients(params) -> None:
    """Replace each gradient by its mean over the ranks (one all-reduce of
    them all); nothing outside a sharded step."""
    shard = current()
    if shard is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=shard.group)
    flat /= shard.world
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def batch_norm_global(bn: torch.nn.BatchNorm2d, x: Tensor) -> Tensor:
    """Train-mode BatchNorm of this rank's rows with the statistics of the
    global batch: the per-channel sums and sums of squares (float64) are
    all-reduced with autograd, so the gradient flows through the global
    mean and variance as in the one-device step.  The running statistics
    advance with the global mean and the unbiased variance over the global
    count, by ``bn.momentum``."""
    shard = current()
    count = x.numel() // x.shape[1] * shard.world
    dims = (0, 2, 3)
    stats = torch.stack([x.sum(dims, dtype=torch.float64),
                         (x * x).sum(dims, dtype=torch.float64)])
    stats = _AllReduce.apply(stats, shard.group)
    mean = stats[0] / count
    var = stats[1] / count - mean * mean
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.float(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(
            (var * (count / (count - 1))).float(), alpha=m)
        bn.num_batches_tracked.add_(1)
    shape = (1, -1, 1, 1)
    return ((x - mean.float().view(shape))
            * torch.rsqrt(var.float() + bn.eps).view(shape))


def shard_train_step(step_fn: Callable, group) -> Callable:
    """Wrap a training step ``step(state, batch, generator, max_tilt) ->
    metrics`` (``train.STEP_MAKERS``) so that each rank of ``group``, given
    its slice of the global batch (pairs or triplets), computes what
    ``step_fn`` computes on the global batch (module docstring): every rank
    seeds its generator alike, and ends with the same parameters and
    BatchNorm statistics and the global loss in its metrics."""

    def step(state, batch, generator, max_tilt=None):
        with sharded(group):
            return step_fn(state, batch, generator, max_tilt)

    return step


# ---------------------------------------------------------------------------
# Sharded inference
# ---------------------------------------------------------------------------

def _on_devices(devices: Sequence[torch.device], work: Callable,
                jobs: Sequence[Any]) -> list:
    """``work(k, job)`` for each job k on a thread of its own with
    ``devices[k]`` current (CUDA launches go to the current device), the
    results in order."""

    def run(k):
        dev = devices[k]
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            return work(k, jobs[k])

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(run, k) for k in range(len(jobs))]
        return [f.result() for f in futures]


def shard_apply(net: torch.nn.Module,
                devices: Sequence[torch.device]) -> Callable[[Tensor], Tensor]:
    """Data-parallel patch-net inference: ``apply(patches (N, PS, PS))``
    splits the patches into ``len(devices)`` contiguous parts, runs a
    replica of ``net`` (eval mode, no autograd) on each device and returns
    the outputs concatenated, on the patches' device."""
    replicas = [copy.deepcopy(net).to(d).eval() for d in devices]

    def apply(patches: Tensor) -> Tensor:
        parts = patches.tensor_split(len(devices))

        def work(k, part):
            with torch.no_grad():
                return replicas[k](part.to(devices[k]))

        outs = _on_devices(devices, work, parts)
        return torch.cat([o.to(patches.device) for o in outs])

    return apply


def _replica(detector, device: torch.device):
    """A copy of the extractor ``detector`` on ``device``: its nets copied
    there, its plans rebuilt there at first use."""
    rep = copy.copy(detector)
    rep.device = device
    for name in ("shape_net", "ori_net", "desc_net"):
        net = getattr(detector, name)
        if net is not None:
            setattr(rep, name, copy.deepcopy(net).to(device))
    rep._plans = {}
    return rep


def make_sharded_image_pipeline(detector, h: int, w: int,
                                devices: Sequence[torch.device],
                                do_ori: bool = False,
                                describe: bool = True) -> Callable:
    """Bulk extraction: ``fn(imgs)`` deals a list (or (B, H, W) array) of
    ``h`` x ``w`` images over one replica of the extractor per device,
    image i to replica ``i % len(devices)``, each running the whole
    single-image program as JAX's sharded pipeline does (its raw program:
    threshold mode at the cap, no retry, ``capped=True``), and returns the
    per-image outputs (the extractor's host dicts) in input order."""
    replicas = [_replica(detector, d) for d in devices]

    def run(imgs) -> List[Dict[str, np.ndarray]]:
        imgs = list(imgs)
        for img in imgs:
            if tuple(np.shape(img)) != (h, w):
                raise ValueError(f"sharded pipeline built for {h}x{w}, got "
                                 f"an image of {tuple(np.shape(img))}")
        k = min(len(replicas), len(imgs))
        dealt = [list(range(j, len(imgs), len(replicas))) for j in range(k)]

        def work(j, idxs):
            return [replicas[j](imgs[i], describe=describe, do_ori=do_ori,
                                capped=True) for i in idxs]

        outs: List[Optional[Dict[str, np.ndarray]]] = [None] * len(imgs)
        for idxs, res in zip(dealt, _on_devices(devices[:k], work, dealt)):
            for i, r in zip(idxs, res):
                outs[i] = r
        return outs

    return run


# ---------------------------------------------------------------------------
# A rank worker: steps against the one-device step
# ---------------------------------------------------------------------------

def run_steps(rank: int, device: torch.device, group,
              cases: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """A :func:`spawn` worker that runs training steps for each case, a
    dict: ``len(batches)`` steps of ``train.STEP_MAKERS[mode]`` on a
    ``REGISTRY[arch]`` net that starts from the JAX-layout tree ``start``
    (with ``desc_params`` for a frozen net descriptor, ``cfg`` a
    ``TrainConfig``), its generator seeded with ``cfg.seed`` and
    ``max_tilt`` at epoch 0's, on this rank's rows of each global batch (a
    tuple of numpy arrays) under :func:`shard_train_step` over ``group``,
    or on the whole batch in one process when ``group`` is None.  With
    ``draws`` (AffNet mode: per step, the global warp LAFs as numpy
    arrays) the steps run ``train.affnet_step_core`` on those warps,
    dropout off.  Returns per case the losses, each step's ms on the host
    clock (the loss read back ends it), the final parameters and BatchNorm
    statistics (numpy), this rank's kernel launch counts and, sharded, the
    largest difference of any of them between the ranks."""
    return [_run_case(rank, device, group, **case) for case in cases]


def _run_case(rank, device, group, mode: str, arch: str, cfg,
              batches: Sequence[tuple], start: Dict[str, Any],
              desc_params: Optional[Dict[str, Any]] = None,
              draws: Optional[Sequence[tuple]] = None) -> Dict[str, Any]:
    from . import ops, train
    from .models import REGISTRY, params_from_jax
    model = REGISTRY[arch]()
    model.load_state_dict(params_from_jax(start))
    model.to(device).train()
    desc_fn = (None if mode == "descriptor"
               else train.make_descriptor(cfg.descriptor, desc_params,
                                          device))
    step = train.STEP_MAKERS[mode](desc_fn, cfg)
    world = 1
    if group is not None:
        world = dist.get_world_size(group)
        step = shard_train_step(step, group)
    state = train.init_state(model, cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    ops.reset_launch_counts()
    step_losses, step_ms = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        n = len(batch[0]) // world

        def mine(arrays):
            return tuple(torch.as_tensor(x[rank * n:(rank + 1) * n]).to(
                device) for x in arrays)

        if draws is None:
            metrics = step(state, mine(batch), gen, train.tilt_for_epoch(0))
        else:
            with (sharded(group) if group is not None
                  else contextlib.nullcontext()):
                metrics = train.affnet_step_core(state, desc_fn, cfg,
                                                 mine(batch), mine(draws[i]))
        step_losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    sd = {k: v for k, v in model.state_dict().items()
          if v.is_floating_point()}
    spread = 0.0
    if group is not None:
        flat = torch.cat([v.reshape(-1) for v in sd.values()])
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat, group=group)
        spread = max(float((q - parts[0]).abs().max()) for q in parts)
    return dict(losses=step_losses, step_ms=step_ms, counts=counts,
                rank_spread=spread,
                state={k: v.cpu().numpy() for k, v in sd.items()})
