"""The input-shape cells of the LM dry run and their meta-tensor inputs, as
the JAX package's ``lm/shapes.py`` has them.

Every (arch × shape) cell is fully described here; the dry run
(``launch/dryrun.py``) runs train_step / prefill_step / decode_step on these
inputs on the meta device, without allocating a buffer. Token ids are
``int64`` (the port's index dtype) where the reference's are ``int32``;
embeddings and frames are ``COMPUTE_DTYPE``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.lm.config import LMConfig
from repro_torch.lm.steps import cache_struct


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: LMConfig, shape: str) -> Optional[str]:
    """None if runnable; else a human-readable skip reason."""
    if shape == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 524k decode requires sub-quadratic "
                "attention (see DESIGN.md shape/skip notes)")
    return None


def input_specs(cfg: LMConfig, shape) -> Dict:
    """Meta-tensor stand-ins for every model input of this cell (the global
    batch). A decode cell's ``cache_len`` is an int, as the port's decode
    step takes it: the cache's last slot (the reference's is an abstract
    int32 scalar). ``shape`` is a cell's name or a ``ShapeCell``."""
    from repro_torch.lm.model import COMPUTE_DTYPE

    cell = shape if isinstance(shape, ShapeCell) else SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if cell.kind in ("train", "prefill"):
        batch: Dict = {"labels": meta((b, s), torch.int64)} if cell.kind == "train" else {}
        if cfg.frontend == "vision":
            # anyres patch+text embeddings are precomputed by the stub frontend
            batch["embeddings"] = meta((b, s, cfg.d_model), COMPUTE_DTYPE)
        else:
            batch["tokens"] = meta((b, s), torch.int64)
        if cfg.is_encdec:
            batch["encoder_frames"] = meta((b, cfg.encoder_seq, cfg.d_model), COMPUTE_DTYPE)
        return {"batch": batch}

    # decode: one new token against an s-long cache
    return {
        "caches": cache_struct(cfg, b, s, abstract=True),
        "tokens": meta((b, 1), torch.int64),
        "cache_len": s - 1,
    }
