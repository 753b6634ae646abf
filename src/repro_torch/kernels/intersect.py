"""Cardinality-class attention intersection (Eq. 8/9).

Replaces the TPU kernel ``src/repro/kernels/intersect.py::intersect_pallas``
(body ``_intersect_kernel``, wrapper ``src/repro/kernels/ops.py::intersect``)
with the hand-written CUDA kernel of ``csrc/intersect.cu`` for Hopper.

What bounds it on the H100: BetaE's attention MLP is 800→800→1, so each pool
row costs k·d·hd = k·640,000 multiply-adds against W1's 2.56 MB (fp32). At
serving pools (n·k of a few dozen rows) the call is bound by reading W1
once, which only the whole card reads fast; at training pools (n·k in the
thousands) by the fp32 CUDA cores. The kernel is one launch: W1 is cut into
64-unit hidden blocks × 8 depth chunks, and a thread block cluster of 8
blocks takes one hidden block for one row group, each block one chunk, with
register-tiled FMA chains; the cluster folds its chunks through distributed
shared memory into one partial logit per (32-unit tile, row), and the
cluster that arrives last for a row group takes the softmax over k and
writes the weighted combine from the x it holds. h and the logits never
leave the launch except as those partial logits. A thread holds 4 rows × 8
hidden units of the chunk's product in registers, at every pool size.

Every sum runs in an order fixed by d and hd alone (8 depth chunks of
``chunk_len(d)``, each one FMA chain, added in order; 32-unit hidden tiles
summed by a fixed tree; the tiles the same way), so a row's bits do not
depend on the pool's size or the row's place in it. Any
k >= 1. The TPU wrapper pads the logit head to 128 lanes; this one does not
need to.

``intersect`` dispatches on where its inputs lie: CPU tensors take the plain
version ``intersect_ref``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_counters: dict[tuple[int, int], torch.Tensor] = {}


def intersect_ref(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version: x [n, k, d] -> [n, d] in x's dtype, computed in
    fp32. Attention logits from a 2-layer MLP, softmax over k, weighted
    combine (BetaE/Q2B-style intersection)."""
    xf = x.float()
    h = torch.relu(xf @ w1.float() + b1.float())        # [n, k, hd]
    logits = h @ w2.float() + b2.float()                 # [n, k, 1]
    att = torch.softmax(logits, dim=1)
    return (att * xf).sum(dim=1).to(x.dtype)


def _check_shapes(x, w1, b1, w2, b2):
    """The shapes both paths take: x [n, k, d] with k, d >= 1 and an MLP
    d -> hd -> 1 with hd >= 1. Returns (n, k, d, hd)."""
    if x.dim() != 3:
        raise ValueError(f"intersect: need x [n, k, d], got {tuple(x.shape)}")
    n, k, d = x.shape
    hd = w1.shape[-1]
    if (w1.dim() != 2 or tuple(w1.shape) != (d, hd) or b1.numel() != hd
            or w2.numel() != hd or b2.numel() != 1):
        raise ValueError(
            f"intersect: MLP shapes w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
            f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} do not fit d={d}")
    if k < 1 or d < 1 or hd < 1:
        raise ValueError(f"intersect: need k, d and hd >= 1, got k={k}, d={d}, hd={hd}")
    return n, k, d, hd


def _arrival_counters(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The kernel's per-row-group arrival counters for PyTorch's current
    stream on x's device: zero between launches (the last arrival resets
    its counter), so one buffer serves every launch on that stream, and
    launches on two streams never share one."""
    key = (x.device.index, build.stream_handle(x))
    with _lock:
        buf = _counters.get(key)
        if buf is None or buf.numel() < groups:
            size = 1 << max(groups - 1, 0).bit_length()
            buf = _counters[key] = torch.zeros(size, dtype=torch.int32, device=x.device)
        return buf


def intersect(x, w1, b1, w2, b2) -> torch.Tensor:
    """x [n, k, d], MLP (w1 [d, hd], b1 [hd], w2 [hd, 1], b2 [1]) -> [n, d].
    Counts each launch of the kernel in ``intersect.launches``."""
    n, k, d, hd = _check_shapes(x, w1, b1, w2, b2)
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
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lib = build.load_library()
    # Scratch: one partial logit per (hidden tile, input row).
    partial = torch.empty((lib.repro_intersect_tiles(hd), n * k),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        counters = _arrival_counters(x, lib.repro_intersect_groups(n, k))
        err = lib.repro_intersect_fused(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                        w2.data_ptr(), b2.data_ptr(), partial.data_ptr(),
                                        counters.data_ptr(), out.data_ptr(), n, k, d, hd,
                                        DTYPES[x.dtype], build.stream_handle(x))
    build.check(lib, err, "intersect")
    intersect.launches += 1
    return out


intersect.launches = 0
