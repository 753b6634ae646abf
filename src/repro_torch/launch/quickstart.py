"""Quickstart: train a BetaE NGDB with operator-level batching, then
evaluate it — the port's twin of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device (it raises on a
machine with no GPU rather than falling back to the CPU).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.data import generate_synthetic_kg, split_kg
from repro_torch.models import ModelConfig, make_model, model_names
from repro_torch.sampling import OnlineSampler
from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig, evaluate


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--model", default="betae", choices=model_names())
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--dim", type=int, default=32)
    args = ap.parse_args(argv)

    # 1. A knowledge graph (synthetic stand-in; swap in your own triples array).
    full_kg = generate_synthetic_kg(n_entities=400, n_relations=12, n_triples=5000, seed=0)
    train_kg, valid, test = split_kg(full_kg)
    print(f"KG: {train_kg.n_entities} entities / {len(train_kg)} train triples")

    # 2. A query-encoder backbone (gqe | q2b | betae | q2p | fuzzqe | complex).
    model = make_model(args.model, ModelConfig(dim=args.dim, gamma=12.0), device=args.device)

    # 3. The operator-level trainer: online sampling -> Max-Fillness scheduling
    #    -> cross-query pooled operators -> vectorized loss -> Adam.
    cfg = TrainConfig(batch_size=64, n_negatives=16,
                      patterns=("1p", "2p", "2i", "3i", "2u"),
                      adam=AdamConfig(lr=3e-3), prefetch=0)
    trainer = NGDBTrainer(model, train_kg, cfg)
    trainer.train(n_steps=args.steps, log_every=10)

    # 4. Filtered-MRR evaluation against the full graph (predictive answers).
    queries = [b.query for b in OnlineSampler(train_kg, patterns=("1p", "2i"),
                                              seed=1).sample_batch(32)]
    metrics = evaluate(model, trainer.params, trainer.executor, full_kg, queries,
                       train_kg=train_kg)
    print({k: round(float(v), 4) for k, v in metrics.items() if "/" not in k})
    return metrics


if __name__ == "__main__":
    main()
