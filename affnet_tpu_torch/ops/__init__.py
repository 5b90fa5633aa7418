"""Plain tensor ops of the extraction, training and shape-optimization
paths, the flat-layout convolution of the eval nets, and the wrappers of
their CUDA kernels (``cuda_*.py``,
``batched_sampler.py``, ``pyramid_sampler.py``).  Each wrapper keeps a plain
integer count: one per kernel launch, nowhere else."""

from . import cuda_blur, cuda_conv, cuda_detect, cuda_patches, cuda_topk

# Kernel name -> (module, counter attribute).
COUNTERS = {
    "blur": (cuda_blur, "launches"),
    "detect": (cuda_detect, "launches"),
    "dedup": (cuda_detect, "launches_dedup"),
    "refine": (cuda_detect, "launches_refine"),
    "topk": (cuda_topk, "launches"),
    "patches": (cuda_patches, "launches"),
    "patches_bf16": (cuda_patches, "launches_bf16"),
    "batched_fwd": (cuda_patches, "launches_batched"),
    "batched_bwd": (cuda_patches, "launches_bwd"),
    "pyramid_fwd": (cuda_patches, "launches_pyramid"),
    "pyramid_bwd": (cuda_patches, "launches_pyramid_bwd"),
    "conv": (cuda_conv, "launches"),
    "conv_bf16": (cuda_conv, "launches_bf16"),
}

# The kernels the extraction path must launch, in float32 and in fast mode.
EXTRACTION_KERNELS = ("blur", "detect", "dedup", "refine", "topk", "patches")
FAST_EXTRACTION_KERNELS = ("blur", "detect", "dedup", "refine", "topk",
                           "patches_bf16")


def launch_counts() -> dict:
    """The counts of COUNTERS, and B5 forward's by patch size
    (``batched_fwd_ps64``: the augment warps; ``batched_fwd_ps32``: the
    rewarp)."""
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in COUNTERS.items()}
    counts.update({f"batched_fwd_ps{ps}": n for ps, n
                   in sorted(cuda_patches.launches_batched_ps.items())})
    return counts


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    cuda_patches.launches_batched_ps.clear()
