"""Cardinality-class attention intersection (Eq. 8/9).

Replaces the TPU kernel ``src/repro/kernels/intersect.py::intersect_pallas``
(body ``_intersect_kernel``, wrapper ``src/repro/kernels/ops.py::intersect``)
with the hand-written CUDA kernels of ``csrc/intersect.cu`` for Hopper.

What bounds it on the H100: BetaE's attention MLP is 800→800→1, so each pool
row costs k·d·hd = k·640,000 multiply-adds while its bytes are a few KB plus
W1 (2.56 MB fp32): the work is bound by operations at pool sizes of a few
hundred rows, and by reading W1 at the smallest pools. The design runs the
x·W1 product as a tiled fp32 GEMM over (row tile, hidden-unit tile) blocks —
splitting the hidden units is what fills the card's SMs at serving pool
sizes — with relu, the w2 head and the reduction over hidden units fused into
its epilogue, so h never reaches device memory; a second launch sums each
row's partial logits in a fixed order, takes the softmax over k and writes the
weighted combine. No atomics: results do not depend on the pool's size or
composition. ``k`` is a runtime argument (1..8) dispatched to a kernel
instantiated per k. The TPU wrapper pads the logit head to 128 lanes; this one
does not need to.

``intersect`` dispatches on where its inputs lie: CPU tensors take the plain
version ``intersect_ref``; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 8


def intersect_ref(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version: x [n, k, d] -> [n, d] in x's dtype, computed in
    fp32. Attention logits from a 2-layer MLP, softmax over k, weighted
    combine (BetaE/Q2B-style intersection)."""
    xf = x.float()
    h = torch.relu(xf @ w1.float() + b1.float())        # [n, k, hd]
    logits = h @ w2.float() + b2.float()                 # [n, k, 1]
    att = torch.softmax(logits, dim=1)
    return (att * xf).sum(dim=1).to(x.dtype)


def intersect(x, w1, b1, w2, b2) -> torch.Tensor:
    """x [n, k, d], MLP (w1 [d, hd], b1 [hd], w2 [hd, 1], b2 [1]) -> [n, d].
    Counts each launch of the kernel pair in ``intersect.launches``."""
    if x.dim() != 3:
        raise ValueError(f"intersect: need x [n, k, d], got {tuple(x.shape)}")
    n, k, d = x.shape
    hd = w1.shape[-1]
    if (tuple(w1.shape) != (d, hd) or b1.numel() != hd or w2.numel() != hd
            or b2.numel() != 1):
        raise ValueError(
            f"intersect: MLP shapes w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
            f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} do not fit d={d}")
    params = (w1, b1, w2, b2)
    if x.device.type == "cpu" and all(p.device.type == "cpu" for p in params):
        return intersect_ref(x, w1, b1, w2, b2)
    if x.device.type != "cuda" or any(p.device != x.device for p in params):
        raise ValueError(f"intersect: inputs must all lie on the CPU or on "
                         f"one CUDA device, got x on {x.device}")
    if x.dtype not in DTYPES or any(p.dtype != torch.float32 for p in params):
        raise TypeError(f"intersect: x must be one of {list(DTYPES)} and the "
                        f"MLP float32, got {x.dtype}")
    if not (x.is_contiguous() and all(p.is_contiguous() for p in params)):
        raise ValueError("intersect: inputs must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"intersect: cardinality k={k} outside 1..{MAX_K}")
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lib = build.load_library()
    # Scratch: one partial logit per (hidden-unit tile, input row).
    partial = torch.empty((lib.repro_intersect_tiles(hd), n * k),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_intersect(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                  w2.data_ptr(), b2.data_ptr(),
                                  partial.data_ptr(), out.data_ptr(),
                                  n, k, d, hd, DTYPES[x.dtype],
                                  build.stream_handle(x))
    build.check(lib, err, "intersect")
    intersect.launches += 1
    return out


intersect.launches = 0
