#!/usr/bin/env python3
"""Kernel B7 (and B7-bf16) at the flat stack's seven layer shapes on one
CUDA card: each launch held against its plain version (the layer's own
work, ``conv_layer_plain``), then timed between CUDA events beside cuDNN
(``F.conv2d``, TF32 off) on the same layer and the layer's bound.

    python3 scripts/bench_conv_layers.py [--patches 3000 34274] [--reps 20]

AffNetFast's six trunk layers (1->16, 16->16, 16->32 stride 2 on 32x32
maps; 32->32, 32->64 stride 2 on 16x16; 64->64 on 8x8) and HardTFeatNet's
7x7 VALID 1->32 layer, on random inputs made from ``--seed``.  Prints one
line per layer and dtype and the card's name and power limit; exits
nonzero if a kernel disagrees with its plain version or there is no card.
``chip_smoke.py`` measures the same kernels on the paths' own inputs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from affnet_tpu_torch.ops import cuda_conv  # noqa: E402
from affnet_tpu_torch.ops.conv_flat import (conv_layer_plain,  # noqa: E402
                                            out_extent)
from affnet_tpu_torch.utils import float32_math  # noqa: E402

# name: (C, O, k, pad, stride, H, act)
LAYERS = {
    "aff1": (1, 16, 3, 1, 1, 32, "relu"),
    "aff2": (16, 16, 3, 1, 1, 32, "relu"),
    "aff3": (16, 32, 3, 1, 2, 32, "relu"),
    "aff4": (32, 32, 3, 1, 1, 16, "relu"),
    "aff5": (32, 64, 3, 1, 2, 16, "relu"),
    "aff6": (64, 64, 3, 1, 1, 8, "relu"),
    "tfeat1": (1, 32, 7, 0, 1, 32, "tanh"),
}
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
ACTS = {"relu": torch.relu, "tanh": torch.tanh}


def event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench(name, n, dtype, reps, gen) -> bool:
    c, o, k, pad, stride, h, act = LAYERS[name]
    dev = torch.device("cuda")
    x = torch.randn((c, n * h * h), generator=gen).to(dev, dtype)
    w = (torch.randn((k, k, c, o), generator=gen) / (k * k * c) ** 0.5).to(
        dev)
    b = (0.1 * torch.randn((o,), generator=gen)).to(dev)
    with float32_math():
        got = cuda_conv.conv_flat_cuda(x, w, b, (h, h), pad, act, stride)
        ref = conv_layer_plain(x, w, b, (h, h), pad, act, stride)
        bf16 = dtype == torch.bfloat16
        diff = (got.float() - ref.float()).abs()
        tol = 1e-5 * float(ref.float().abs().max()) + (
            ref.float().abs() * 2.0 ** -7 if bf16 else 0.0)
        ok = bool(torch.all(diff <= tol))
        del got, ref, diff, tol
        x4 = x.reshape(c, n, h, h).transpose(0, 1).contiguous()
        w4 = w.permute(3, 2, 0, 1).to(dtype).contiguous()
        bb = b.to(dtype)
        ms = event_ms(lambda: cuda_conv.conv_flat_cuda(
            x, w, b, (h, h), pad, act, stride), reps)
        lib = event_ms(lambda: ACTS[act](F.conv2d(
            x4, w4, bb, stride=stride, padding=pad)), reps)
    ho, wo = out_extent((h, h), k, pad, stride)
    es = x.element_size()
    t_bytes = ((c * n * h * h + o * n * ho * wo) * es
               + (k * k * c * o + o) * 4) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * k * k * c * o * n * ho * wo / PEAK_FLOP_PER_S[dtype] * 1e3
    bound = max(t_bytes, t_ops)
    print(f"{name} {str(dtype)[6:]} N={n}: ok={ok} ms {ms:.4f} cudnn_ms "
          f"{lib:.4f} bound_ms {bound:.4f} "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
          f"x{ms / bound:.2f} of bound, x{ms / lib:.2f} of cuDNN",
          flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--patches", type=int, nargs="+", default=[3000])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", nargs="+", default=list(LAYERS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_conv_layers: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(args.seed)
    ok = True
    for n in args.patches:
        for dtype in (torch.float32, torch.bfloat16):
            for name in args.layers:
                ok &= bench(name, n, dtype, args.reps, gen)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
