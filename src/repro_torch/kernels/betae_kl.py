"""BetaE's all-entity score: gamma - KL(Beta(ae, be) || Beta(aq, bq)) summed
over d, over sqrt(d), for query states q [B, 2d] against entity vectors
ev [N, d] -> fp32 [B, N].

Replaces no TPU kernel: the JAX package computes this KL in jnp
(``src/repro/models/betae.py:71``). On the card the port ran it eagerly, as
~30 launches over the [B, N, d] broadcast; ``csrc/betae_kl.cu`` is one
launch with no [B, N, d] tensor in memory, forward only.

What bounds it on the H100: not the 23.9 MB entity table at the serving
shape (B = 16, N = 14,951, d = 400) but the transcendental evaluations each
(entity row, element) needs (softplus twice, digamma and lgamma three times
each). The kernel makes them once per (row, element) a launch and reuses
them for every query; the query terms are staged once per block in shared
memory. Each element keeps ``distance``'s five terms in their order, and the
sum over d runs in 8 interleaved k-groups added in a fixed tree, in an order
fixed by d alone: a chunk of rows scores bitwise as those columns of the
all-entity launch, and a query alone as its row in a batch.

``betae_kl`` dispatches on where its inputs lie: CPU tensors take the plain
version ``betae_kl_ref`` (``models/betae.py``'s expression, bit for bit);
CUDA tensors launch the kernel or raise; meta tensors launch nothing
(``kernels/reckon.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, reckon

_EPS = 0.05
_MAXP = 40.0
_LO = torch.tensor(_EPS, dtype=torch.float32)
_HI = torch.tensor(_MAXP, dtype=torch.float32)


def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, _LO), _HI)


def _betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def betae_kl_ref(q: torch.Tensor, ev: torch.Tensor, gamma: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: ``gamma - BetaE.distance(params, q[:, None, :],
    ev[None])``, op for op. q [B, 2d], ev [N, d] -> [B, N]."""
    d = ev.shape[-1]
    ent = ev[None, :, :]
    ae = _clip(F.softplus(ent * 2.0) + _EPS)
    be = _clip(F.softplus(-ent * 2.0) + _EPS)
    aq, bq = _clip(q[:, None, :d]), _clip(q[:, None, d:])
    kl = (
        _betaln(aq, bq)
        - _betaln(ae, be)
        + (ae - aq) * torch.digamma(ae)
        + (be - bq) * torch.digamma(be)
        + (aq - ae + bq - be) * torch.digamma(ae + be)
    )
    return gamma - kl.sum(dim=-1) / math.sqrt(d)


def betae_kl(q: torch.Tensor, ev: torch.Tensor, gamma: float = 0.0) -> torch.Tensor:
    """BetaE's scores q [B, 2d] against ev [N, d] -> fp32 [B, N], forward
    only. Counts each kernel launch in ``betae_kl.launches``; B = 0 or N = 0
    launches nothing."""
    if q.dim() != 2 or ev.dim() != 2 or ev.shape[1] == 0 or q.shape[1] != 2 * ev.shape[1]:
        raise ValueError(f"betae_kl: need q [B, 2d] and ev [N, d], got "
                         f"{tuple(q.shape)} and {tuple(ev.shape)}")
    if reckon.on_meta((q, ev)):
        return reckon.betae_kl(q, ev)
    if q.device.type == "cpu" and ev.device.type == "cpu":
        return betae_kl_ref(q, ev, gamma)
    if q.device.type != "cuda" or ev.device != q.device:
        raise ValueError(f"betae_kl: q and ev must both lie on the CPU or on one "
                         f"CUDA device, got {q.device} and {ev.device}")
    if q.dtype != torch.float32 or ev.dtype != torch.float32:
        raise TypeError(f"betae_kl: q and ev must be float32, got {q.dtype} and {ev.dtype}")
    if not (q.is_contiguous() and ev.is_contiguous()):
        raise ValueError("betae_kl: q and ev must be contiguous")
    B, N, d = q.shape[0], ev.shape[0], ev.shape[1]
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    if B == 0 or N == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.repro_betae_kl(q.data_ptr(), ev.data_ptr(), out.data_ptr(), B, N, d,
                                 float(gamma), build.stream_handle(q))
    build.check(lib, err, "betae_kl")
    betae_kl.launches += 1
    return out


betae_kl.launches = 0
