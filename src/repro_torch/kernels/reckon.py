"""The kernels on the meta device: what a wrapper does when its inputs are
meta tensors (the dry run, ``launch/dryrun.py``). It launches nothing and
computes nothing: it returns empty meta tensors of the kernel's output (and,
for a backward, each gradient's) shape and dtype, and hands the kernel's
reckoned FLOPs and bytes to ``HOOK`` when one is set.

The counts are the ones behind ``PERF.md`` §6's bound column
(``chip_smoke.py``'s): each input read once and each output written once,
and the kernel's multiply-adds as two FLOPs (its plain arithmetic, whatever
route the kernel takes for it).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

# Set by the dry run: called as HOOK(kernel name, flops, bytes) a meta call.
HOOK: Optional[Callable[[str, float, float], None]] = None


def on_meta(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether every tensor lies on the meta device (a mix of devices is
    the wrappers' error, as it is without meta tensors)."""
    return all(t.device.type == "meta" for t in tensors)


def _record(name: str, flops: float, nbytes: float) -> None:
    if HOOK is not None:
        HOOK(name, float(flops), float(nbytes))


def scoring(q, e, mode: str) -> torch.Tensor:
    B, d = q.shape
    N = e.shape[0]
    _record("scoring", (2 if mode == "dot" else 3) * B * N * d,
            (B * d + N * d) * q.element_size() + B * N * 4)
    return torch.empty((B, N), dtype=torch.float32, device="meta")


def betae_kl(q, ev) -> torch.Tensor:
    B, N, d = q.shape[0], ev.shape[0], ev.shape[1]
    # The KL's query-entity terms: 4 FLOPs an element of a pair, as the
    # benchmark's query_flops counts them (the terms of one side alone, such
    # as digamma of the entity's, are not counted per pair).
    _record("betae_kl", 4 * B * N * d, (B * 2 * d + N * d) * 4 + B * N * 4)
    return torch.empty((B, N), dtype=torch.float32, device="meta")


def intersect(x, w1) -> torch.Tensor:
    n, k, d = x.shape
    hd = w1.shape[1]
    elt = x.element_size()
    _record("intersect", n * k * (2 * d * hd + 4 * hd + 2 * d),
            (n * k * d + n * d) * elt + (d * hd + 2 * hd + 1) * 4)
    return torch.empty((n, d), dtype=x.dtype, device="meta")


def intersect_backward(x, w1, b1, w2, b2):
    n, k, d = x.shape
    hd = w1.shape[1]
    _record("intersect_backward", 3 * 2 * n * k * d * hd,
            (2 * n * k * d + n * d + 2 * d * hd) * 4)
    return tuple(torch.empty_like(t, device="meta") for t in (x, w1, b1, w2, b2))


def gather_fuse(ids, h_str, h_sem, wp, sem_ids, zp: bool) -> torch.Tensor:
    n, d, dl, dp = ids.shape[0], h_str.shape[1], h_sem.shape[1], wp.shape[-1]
    nbytes = (2 * n * d * h_str.element_size() + n * dl * h_sem.element_size()
              + n * 8 * (1 if sem_ids is None else 2) + (dl * dp + dp + (d + dp) * d + d) * 4
              + (n * dp * 4 if zp else 0))
    _record("gather_fuse", n * (2 * dl * dp + dp + 2 * (d + dp) * d + d + 4 * d), nbytes)
    return torch.empty((n, d), dtype=h_str.dtype, device="meta")


def gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, unsorted_rows: int):
    n, d, dl, dp = ids.shape[0], h_str.shape[1], h_sem.shape[1], wp.shape[-1]
    E = h_str.shape[0]
    weights = 2 * (dl * dp + dp + (d + dp) * d + d) * 4
    index_bytes = n * 8 * (4 if n > unsorted_rows else 2)
    _record("gather_fuse_backward", n * (2 * dl * dp + 4 * d * (d + dp) + 3 * d + d + dp),
            index_bytes + n * (3 * d + dl + dp) * 4 + E * d * 4 + weights)
    return tuple(torch.empty_like(t, device="meta") for t in (h_str, wp, bp, wf, bf))
