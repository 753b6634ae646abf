"""The assigned-architecture zoo: pick any ``--arch``, show its summary and
dry-run cells, then run a reduced-config train step, prefill and decode —
the port's twin of ``examples/lm_arch_zoo.py``.

    PYTHONPATH=src python -m repro_torch.launch.lm_zoo --arch mixtral-8x22b [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.device import resolve_device
from repro_torch.lm.model import init_params
from repro_torch.lm.shapes import SHAPES, cell_supported
from repro_torch.lm.steps import (lm_adam_init, make_decode_step, make_prefill_step,
                                  make_train_step)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(ARCHS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    full = ARCHS[args.arch]
    print(f"== {full.name} [{full.family}] ==")
    print(f"  {full.n_layers}L d_model={full.d_model} heads={full.n_heads}/"
          f"{full.n_kv_heads} d_ff={full.d_ff} vocab={full.vocab_size} "
          f"experts={full.n_experts} ssm_state={full.ssm_state}")
    print(f"  params: {full.param_count()/1e9:.1f}B total, "
          f"{full.active_param_count()/1e9:.1f}B active")
    for shape in SHAPES:
        skip = cell_supported(full, shape)
        note = f"SKIP ({skip.split(':')[0]})" if skip else "ok"
        print(f"  cell {shape:12s}: {note}")

    cfg = reduced_config(full)
    print(f"\nrunning reduced config on {device} ({cfg.n_layers}L d={cfg.d_model})...")
    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    B, S = 2, 32

    def put(a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype, device=device)

    batch = {"labels": put(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.frontend == "vision":
        batch["embeddings"] = torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16,
                                          device=device)
    else:
        batch["tokens"] = put(rng.integers(0, cfg.vocab_size, (B, S)))
    if cfg.is_encdec:
        batch["encoder_frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                              dtype=torch.bfloat16, device=device)
    _, _, loss = make_train_step(cfg)(params, lm_adam_init(params), batch)
    print(f"  train step: loss={float(loss):.3f}")
    caches, _ = make_prefill_step(cfg, cache_margin=1)(params, batch)
    logits, _ = make_decode_step(cfg)(params, caches, put(np.zeros((B, 1))), S)
    finite = bool(torch.isfinite(logits.float()).all())
    print(f"  prefill+decode: logits {tuple(logits.shape)}, finite={finite}")
    print("\n(dry-run at production scale: "
          f"PYTHONPATH=src python -m repro_torch.launch.dryrun --arch {args.arch} "
          "--shape train_4k --multi-pod)")
    if not (np.isfinite(float(loss)) and finite):
        raise SystemExit(f"{args.arch}: the reduced steps gave a non-finite value")
    return {"loss": float(loss), "finite": finite}


if __name__ == "__main__":
    main()
