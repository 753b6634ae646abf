"""All-entity scoring logits (Eq. 6): S = gamma ± <Q, E>.

Replaces the TPU kernel ``src/repro/kernels/scoring.py::scoring_pallas``
(body ``_scoring_kernel``, wrapper ``src/repro/kernels/ops.py::scoring``) with
the hand-written CUDA kernel ``csrc/scoring.cu`` for Hopper.

What bounds it on the H100: at the serving shapes (B ≤ 16 pow2-padded
queries, N = 14,951 entities, d = 400, fp32) the entity table is 23.9 MB and
each of its elements feeds at most B multiply-adds, so the kernel is bound by
reading ``e`` from device memory (7.4 µs at 3.35 TB/s). The design keeps
that stream going while the arithmetic runs: a persistent grid of one block
per SM, each owning ~N/132 contiguous rows; a producer warpgroup streams
64-element slices of those rows into a 4-stage shared-memory ring with
16-byte ``cp.async`` and mbarriers, while 8 consumer warps hold 8 queries ×
several entities per lane over one of 8 interleaved k-groups of d and add
the k-groups' partials in a fixed tree. q is staged once per block. The
kernel picks its tiling from N: 16 entity rows a warp when a block owns more
than 64 rows (the all-entity launch), else 4, so that a 4,096-row store
chunk (~31 rows a block) keeps all 8 warps busy; ``scoring_tile`` says
which. Which elements of d each k-group sums, and in what order, depends
only on d and the dtype, not on the tiling or the variant, so a chunk of
rows scores bitwise as those columns of the all-entity launch, and a query
alone as its row in a batch. A table that is not 16-byte aligned, or whose
rows are not a multiple of 16 bytes, takes the kernel's element-load variant
(``scoring_aligned`` says which one a table takes). ``csrc/scoring.cu``
gives the registers and shared memory per block.

``scoring`` dispatches on where its inputs lie: CPU tensors take the plain
version ``scoring_ref``; CUDA tensors launch the kernel or raise. Its
tiling is the autotuner's knob for it (``kernels/autotune.py``): given no
``tile``, a launch takes the process tuner's for its shape bucket, which is
the kernel's own choice unless a sweep found a faster one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune, build, reckon

MODES = {"dot": 0, "l1": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILES = (16, 4)  # entity rows per consumer warp of the kernel's two tilings


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
            mode: str = "dot", *, tile: int | None = None) -> torch.Tensor:
    """Scoring logits q [B, d] × e [N, d] -> fp32 [B, N]. Counts each kernel
    launch in ``scoring.launches``. ``tile`` forces one of the kernel's
    tilings (``TILES``), or 0 the kernel's own choice from N; None takes the
    process tuner's config for the shape (``autotune.tuned_config``). The
    scores are bitwise the same either way. The plain version on CPU
    tensors takes no tiling, but ``tile`` is checked all the same; meta
    tensors launch nothing (``kernels/reckon.py``)."""
    if mode not in MODES:
        raise ValueError(f"unknown scoring mode {mode!r}")
    if tile is not None and tile not in (0, *TILES):
        raise ValueError(f"scoring: tile must be 0, one of {TILES} or None, got {tile!r}")
    if q.dim() != 2 or e.dim() != 2 or q.shape[1] != e.shape[1]:
        raise ValueError(f"scoring: need q [B, d] and e [N, d], got "
                         f"{tuple(q.shape)} and {tuple(e.shape)}")
    if reckon.on_meta((q, e)):
        return reckon.scoring(q, e, mode)
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
    if tile is None:
        tile = autotune.tuned_config("scoring", (B, N, d), q)["tile"]
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.repro_scoring_tiled(q.data_ptr(), e.data_ptr(), out.data_ptr(),
                                      B, N, d, float(gamma), MODES[mode],
                                      DTYPES[q.dtype], tile, build.stream_handle(q))
    build.check(lib, err, "scoring")
    scoring.launches += 1
    return out


scoring.launches = 0


def scoring_aligned(e: torch.Tensor) -> bool:
    """Whether the CUDA kernel streams ``e`` [N, d] (on the card) with its
    16-byte copies, or takes the element-load variant: the rule the kernel
    itself applies, read from the library."""
    lib = build.load_library()
    return bool(lib.repro_scoring_aligned(e.data_ptr(), e.shape[1], DTYPES[e.dtype]))


def scoring_tile(e: torch.Tensor) -> int:
    """The entity rows per consumer warp (one of ``TILES``) the CUDA kernel
    takes for ``e`` [N, d] on its card: the rule the kernel itself applies,
    read from the library."""
    lib = build.load_library()
    with torch.cuda.device(e.device):
        tile = lib.repro_scoring_tile(e.shape[0])
    build.check(lib, max(0, -tile), "scoring_tile")
    return tile
