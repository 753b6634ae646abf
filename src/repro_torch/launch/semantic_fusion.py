"""Decoupled semantic integration (paper §4.4) end to end: offline PTE
precompute, unload, then device-resident gather-fused training — the port's
twin of ``examples/semantic_fusion.py``.

    PYTHONPATH=src python -m repro_torch.launch.semantic_fusion [--device cpu]

Last, the ``gather_fuse`` wrapper (its CUDA kernel on the card, its plain
version on the CPU) fuses 32 entities on the trained parameters and is
held to ``model.fused_entity_vec`` and to the plain version within atol
1e-5; the driver exits non-zero if either differs. Runs on ``cuda`` unless
``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.data import generate_synthetic_kg
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import ModelConfig, make_model
from repro_torch.semantic import PTEConfig, StubPTE, precompute_semantic_table
from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig

ATOL = 1e-5


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, bool]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    kg = generate_synthetic_kg(500, 10, 6000, seed=0)

    # offline phase: encode every entity once, then UNLOAD the PTE
    pte = StubPTE(PTEConfig(d_l=128, n_layers=2, d_model=64), device=device)
    t0 = time.time()
    h_sem = precompute_semantic_table(kg, pte)
    print(f"H_sem: {h_sem.shape} precomputed in {time.time() - t0:.1f}s; "
          f"PTE unloaded={pte.unloaded}")

    # training is now inference-free: semantics = one gather (Eq. 11)
    model = make_model("q2b", ModelConfig(dim=32, semantic_dim=128), device=device)
    cfg = TrainConfig(batch_size=48, n_negatives=16, patterns=("1p", "2p", "2i"),
                      adam=AdamConfig(lr=3e-3), prefetch=0)
    trainer = NGDBTrainer(model, kg, cfg, semantic_table=h_sem)
    trainer.train_step()  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    for _ in range(8):
        trainer.train_step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"decoupled: {8 * cfg.batch_size / (time.time() - t0):.0f} queries/s")

    # the gather_fuse kernel computes the same fusion as the model
    p = trainer.params
    ids = torch.arange(32, dtype=torch.int32, device=device)
    args_ = (ids, p["entity"], p["sem_table"], p["sem_proj_w"], p["sem_proj_b"],
             p["fuse_w"], p["fuse_b"])
    fused_kernel = kops.gather_fuse(*args_)
    fused_model = model.fused_entity_vec(p, ids)
    fused_plain = kops.gather_fuse_ref(*args_)
    same = {"model": bool(torch.allclose(fused_kernel, fused_model, rtol=0, atol=ATOL)),
            "plain": bool(torch.allclose(fused_kernel, fused_plain, rtol=0, atol=ATOL))}
    print("kernel == model fusion:", same["model"])
    print("kernel == plain fusion:", same["plain"])
    if not all(same.values()):
        raise SystemExit(f"gather_fuse disagrees with the fusion it replaces: {same}")
    return same


if __name__ == "__main__":
    main()
