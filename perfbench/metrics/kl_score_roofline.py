"""The ``betae_kl`` kernel's share of its roofline: the mean least time of
its calls in the traced window (from their shapes) over the mean time of its
launches on the card.

A call scores B query states [B, 2d] against N entity vectors [N, d]: it
reads both once and writes [B, N] fp32 scores, and its KL's query-entity
terms are 4 FLOPs an element of a pair (``query_flops`` counts the KL so;
the terms of one side alone are not counted per pair). They run on the CUDA
cores in fp32, so the route's peak is fp32's outside the tensor cores.

A program without the ``betae_kl`` entry (the commits before the kernel)
records no calls and launches no such kernel, so the metric is not read."""
import sys

from perfbench import counts

# One H100 SXM's fp32 rate outside the tensor cores, dense (NVIDIA's data
# sheet, at its 700 W limit).
FP32_FLOPS_PER_S = 67e12

_ops = sys.modules.get("repro_torch.kernels.ops")
HOOK = "betae_kl" if hasattr(_ops, "betae_kl") else None


def _least(args):
    ((B, _), _), ((N, d), _) = args[0], args[1]
    if B == 0 or N == 0:    # no launch
        return None
    flops = 4 * d * B * N
    nbytes = (B * 2 * d + N * d) * 4 + B * N * 4
    return counts.least_seconds(flops, nbytes, FP32_FLOPS_PER_S)


def read(run):
    return counts.roofline_pct(run, HOOK, lambda name: "betae_kl_kernel" in name, _least)
