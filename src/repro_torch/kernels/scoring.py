"""All-entity scoring logits (Eq. 6): S = gamma ± <Q, E>.

Replaces the TPU kernel ``src/repro/kernels/scoring.py::scoring_pallas``
(body ``_scoring_kernel``, wrapper ``src/repro/kernels/ops.py::scoring``) with
the hand-written CUDA kernel ``csrc/scoring.cu`` for Hopper.

What bounds it on the H100: at the serving shapes (B ≤ 16 pow2-padded
queries, N = 14,951 entities, d = 400, fp32) the entity table is 23.9 MB and
each of its elements feeds at most B multiply-adds, far below the card's
balance point, so the kernel is bound by reading ``e`` from device memory.
Its design reads ``e`` once per launch (one 16-row query tile covers the
whole batch), stages q and e slices in shared memory with coalesced loads,
and accumulates in fp32 registers on CUDA cores — the dot product is the
kernel's own FMA loop, never ``torch.matmul``. The TPU kernel's 128-lane
padding is replaced by masks inside the kernel.

``scoring`` dispatches on where its inputs lie: CPU tensors take the plain
version ``scoring_ref``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MODES = {"dot": 0, "l1": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def scoring_ref(q: torch.Tensor, e: torch.Tensor, gamma: float = 0.0,
                mode: str = "dot") -> torch.Tensor:
    """Plain PyTorch version. q [B, d], e [N, d] -> fp32 [B, N].

    mode=dot : gamma + q @ e.T      (inner-product geometries)
    mode=l1  : gamma - sum |q - e|  (translational geometries)
    """
    q, e = q.float(), e.float()
    if mode == "dot":
        return gamma + q @ e.T
    if mode == "l1":
        return gamma - (q[:, None, :] - e[None, :, :]).abs().sum(-1)
    raise ValueError(f"unknown scoring mode {mode!r}")


def scoring(q: torch.Tensor, e: torch.Tensor, gamma: float = 0.0,
            mode: str = "dot") -> torch.Tensor:
    """Scoring logits q [B, d] × e [N, d] -> fp32 [B, N]. Counts each kernel
    launch in ``scoring.launches``."""
    if mode not in MODES:
        raise ValueError(f"unknown scoring mode {mode!r}")
    if q.dim() != 2 or e.dim() != 2 or q.shape[1] != e.shape[1]:
        raise ValueError(f"scoring: need q [B, d] and e [N, d], got "
                         f"{tuple(q.shape)} and {tuple(e.shape)}")
    if q.device.type == "cpu" and e.device.type == "cpu":
        return scoring_ref(q, e, gamma, mode)
    if q.device.type != "cuda" or e.device != q.device:
        raise ValueError(f"scoring: q and e must both lie on the CPU or on "
                         f"one CUDA device, got {q.device} and {e.device}")
    if q.dtype not in DTYPES or e.dtype != q.dtype:
        raise TypeError(f"scoring: q and e must share a dtype in "
                        f"{list(DTYPES)}, got {q.dtype} and {e.dtype}")
    if not (q.is_contiguous() and e.is_contiguous()):
        raise ValueError("scoring: q and e must be contiguous")
    B, d = q.shape
    N = e.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    if B == 0 or N == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.repro_scoring(q.data_ptr(), e.data_ptr(), out.data_ptr(),
                                B, N, d, float(gamma), MODES[mode],
                                DTYPES[q.dtype], build.stream_handle(q))
    build.check(lib, err, "scoring")
    scoring.launches += 1
    return out


scoring.launches = 0
